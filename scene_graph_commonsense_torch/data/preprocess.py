"""Offline Visual Genome preprocessing (a copy of
scene_graph_commonsense_tpu/data/preprocess.py, kept so that the port imports
nothing of the JAX package).

Rebuilds the reference's raw-VG cleaning pipeline (reference
preprocess.py:26-239, itself derived from scene-graph-TF-release) and the
per-image annotation writer (reference dataset_utils.py:28-200) as pure
functions over plain dicts:

  1. sync objects referenced only by relationships into the object lists;
  2. normalize names through the alias dictionaries after punctuation/unicode
     cleanup;
  3. drop boxes below the 0.002 image-area fraction;
  4. merge duplicate boxes (same box / IoU>0.9 -> mean box; containment or
     IoU>0.6 with the same name -> extreme box);
  5. keep the top-150 objects (restricted to the curated object list) and
     top-50 predicates by frequency;
  6. assign super-categories from object_types.txt;
  7. emit COCO-style instances_vg_{train,test}.json, split locked to
     VG-SGG-with-attri.h5 (75651 train / 32422 test).

Documented deviation (the JAX package's too): the reference slices the flat
per-relationship `annotations` and per-object `instances` lists with
per-IMAGE split indices (reference preprocess.py:213-216), silently
dropping/misassigning entries; here instances/annotations follow their
image's split membership.

The per-image writer replaces MiDaS-on-torch-hub with an injectable
`depth_fn(image) -> (S, S) float` (zeros when absent — the pipeline treats
depth as an optional input channel, reference dataloader.py:113-114;
data/depth.make_midas_depth_fn wraps MiDaS where it is on disk).
"""

from __future__ import annotations

import os
import string
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from scene_graph_commonsense_torch.constants import VG_OBJECT_SUPER_CLASSES
from scene_graph_commonsense_torch.ops.boxes import resize_box

_REPLACEMENTS = {
    "½": "half", "—": "-", "™": "", "¢": "cent", "ç": "c", "û": "u",
    "é": "e", "°": " degree", "è": "e", "…": "",
}
_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def clean_phrase(phrase: str) -> str:
    """Lowercase, strip odd unicode, drop punctuation (reference
    dataset_utils.py:393-410)."""
    phrase = phrase.strip()
    for k, v in _REPLACEMENTS.items():
        phrase = phrase.replace(k, v)
    return phrase.lower().translate(_PUNCT_TABLE)


def read_alias(path: str) -> Dict[str, str]:
    """First term of each comma-separated line is the alias target
    (reference dataset_utils.py:451-461)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            names = line.strip("\n").strip("\r").split(",")
            target = out.get(names[0], names[0])
            for name in names:
                out[name] = target
    return out


def read_list(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip("\n").strip("\r") for ln in f]


def read_object_types(path: str, name2cid: Dict[str, int],
                      super_names: Sequence[str]) -> Dict[int, List[int]]:
    """object_types.txt lines: 'name,super1,super2,...' -> {class_id:
    [super_ids]} (reference dataset_utils.py:653-663)."""
    super_idx = {name: i for i, name in enumerate(super_names)}
    out: Dict[int, List[int]] = {}
    with open(path) as f:
        for line in f:
            # reference parity: strip('\n').strip('_')
            # (dataset_utils.py:657); also tolerate CRLF files
            parts = line.strip("\r\n").strip("_").split(",")
            if parts[0] not in name2cid:
                continue
            out[name2cid[parts[0]]] = [super_idx[p] for p in parts[1:]
                                       if p in super_idx]
    return out


# ---------------------------------------------------------------------------
# Raw-graph cleaning
# ---------------------------------------------------------------------------

def _xyxy(obj):
    return np.array([obj["x"], obj["y"], obj["x"] + obj["w"],
                     obj["y"] + obj["h"]], dtype=np.int64)


def _merge_iou(b1, b2) -> float:
    if (b1[2] <= b2[0] or b1[3] <= b2[1]
            or b1[0] >= b2[2] or b1[1] >= b2[3]):
        return 0.0
    lo = np.minimum(b1, b2)
    hi = np.maximum(b1, b2)
    inter = float((lo[2] - hi[0]) * (lo[3] - hi[1]))
    area1 = float((b1[2] - b1[0]) * (b1[3] - b1[1]))
    area2 = float((b2[2] - b2[0]) * (b2[3] - b2[1]))
    return inter / (area1 + area2 - inter)


def _inside(b1, b2) -> bool:
    return bool((b1[:2] >= b2[:2]).all() and (b1[2:] <= b2[2:]).all())


def sync_objects(obj_data, rel_data) -> None:
    """Objects referenced only by a relationship join the object list
    (reference dataset_utils.py:489-507)."""
    for objs_img, rels_img in zip(obj_data, rel_data):
        assert objs_img["image_id"] == rels_img["image_id"]
        ids = {o["object_id"] for o in objs_img["objects"]}
        for rel in rels_img["relationships"]:
            for side in ("subject", "object"):
                ent = rel[side]
                if ent["object_id"] not in ids:
                    ent = dict(ent)
                    ent["names"] = [ent["name"]] if "name" in ent \
                        else list(ent.get("names", []))
                    objs_img["objects"].append(ent)
                    ids.add(ent["object_id"])


def normalize_names(obj_data, rel_data, obj_alias, pred_alias) -> None:
    """Alias-normalizes object names and predicates in place (reference
    dataset_utils.py:413-448)."""
    for img in obj_data:
        for obj in img["objects"]:
            obj["names"] = [obj_alias.get(clean_phrase(n), clean_phrase(n))
                            for n in obj["names"]]
    for img in rel_data:
        for rel in img["relationships"]:
            pred = clean_phrase(rel["predicate"])
            rel["predicate"] = [pred_alias.get(pred, pred)]
            for side in ("subject", "object"):
                ent = rel[side]
                raw = ent.get("name", ent.get("names", [""])[0])
                name = clean_phrase(raw)
                ent["names"] = [obj_alias.get(name, name)]


def filter_small_boxes(obj_data, image_areas: Dict[int, float],
                       area_frac: float = 0.002) -> None:
    for img in obj_data:
        area = image_areas[img["image_id"]]
        img["objects"] = [o for o in img["objects"]
                          if float(o["h"] * o["w"]) > area * area_frac]


def merge_duplicate_boxes(obj_data) -> None:
    """Greedy duplicate merging (reference dataset_utils.py:295-390):
    type 1 = same box or IoU > 0.9 (merged box = mean);
    type 2 = containment with same first name (merged box = extremes);
    type 3 = IoU > 0.6 with same first name (extremes)."""
    for img in obj_data:
        objs = img["objects"]
        absorbed = [False] * len(objs)
        merged_into: Dict[int, List[int]] = {}
        types: Dict[int, int] = {}
        for i in range(len(objs)):
            if absorbed[i]:
                continue
            merged_into[i] = []
            types[i] = 1
            for j in range(i + 1, len(objs)):
                if absorbed[j]:
                    continue
                b1, b2 = _xyxy(objs[i]), _xyxy(objs[j])
                same_name = (objs[i]["names"][:1] == objs[j]["names"][:1])
                iou = _merge_iou(b1, b2)
                if (b1 == b2).all() or iou > 0.9:
                    mtype = 1
                elif (_inside(b1, b2) or _inside(b2, b1)) and same_name:
                    mtype = 2
                elif iou > 0.6 and same_name:
                    mtype = 3
                else:
                    continue
                absorbed[j] = True
                merged_into[i].append(j)
                types[i] = max(types[i], mtype)

        kept = []
        for i, members in merged_into.items():
            obj = objs[i]
            dims = [_xyxy(obj)] + [_xyxy(objs[j]) for j in members]
            names = list(obj["names"])
            ids = [obj["object_id"]] + [objs[j]["object_id"]
                                        for j in members]
            for j in members:
                names.extend(objs[j]["names"])
            dims = np.stack(dims)
            if types[i] > 1:     # extremes
                lo = dims[:, :2].min(axis=0)
                hi = dims[:, 2:].max(axis=0)
                box = np.concatenate([lo, hi])
            else:                # mean
                box = dims.mean(axis=0)
            obj["x"] = int(box[0])
            obj["y"] = int(box[1])
            obj["w"] = int(box[2] - box[0])
            obj["h"] = int(box[3] - box[1])
            obj["names"] = list(dict.fromkeys(names))
            obj["ids"] = ids
            kept.append(obj)
        img["objects"] = kept
        img["_id_remap"] = {objs[j]["object_id"]: objs[i]["object_id"]
                            for i, members in merged_into.items()
                            for j in members}


def remap_merged_relationships(obj_data, rel_data) -> None:
    """Points relationship endpoints at the surviving box of each merge
    group.  Without this every relationship referencing an absorbed
    object_id is silently dropped by the id lookup downstream
    (build_image_annotation's id_pos.get)."""
    for objs_img, rels_img in zip(obj_data, rel_data):
        remap = objs_img.pop("_id_remap", {})
        if not remap:
            continue
        for rel in rels_img["relationships"]:
            for side in ("subject", "object"):
                oid = rel[side]["object_id"]
                if oid in remap:
                    rel[side]["object_id"] = remap[oid]


# ---------------------------------------------------------------------------
# Dataset assembly
# ---------------------------------------------------------------------------

CORRUPTED_IMAGE_IDS = (1592, 1722, 4616, 4617)


def build_instances_dataset(raw_img_data, raw_obj_data, raw_relation_data,
                            obj_alias_path, pred_alias_path,
                            object_list_path, object_types_path,
                            split_train_idx, split_test_idx,
                            num_classes: int = 150, num_relations: int = 50,
                            area_frac: float = 0.002):
    """Full pipeline: cleaned raw data -> (train_json, test_json,
    sub2super dict)."""
    sync_objects(raw_obj_data, raw_relation_data)
    obj_alias = read_alias(obj_alias_path)
    pred_alias = read_alias(pred_alias_path)
    normalize_names(raw_obj_data, raw_relation_data, obj_alias, pred_alias)
    image_areas = {img["image_id"]: img["width"] * img["height"]
                   for img in raw_img_data}
    filter_small_boxes(raw_obj_data, image_areas, area_frac)
    merge_duplicate_boxes(raw_obj_data)
    remap_merged_relationships(raw_obj_data, raw_relation_data)

    obj_list = set(read_list(object_list_path))
    obj_counter = Counter(
        name for img in raw_obj_data for obj in img["objects"]
        for name in obj["names"] if name in obj_list)
    top_objects = [s for s, _ in obj_counter.most_common(num_classes)]
    rel_counter = Counter(
        s for img in raw_relation_data for rel in img["relationships"]
        for s in rel["predicate"])
    top_relations = [s for s, _ in rel_counter.most_common(num_relations)]

    categories = [{"id": i, "name": s} for i, s in enumerate(top_objects)]
    relationships = [{"id": i, "name": s}
                     for i, s in enumerate(top_relations)]
    name2cid = {c["name"]: c["id"] for c in categories}
    name2rid = {r["name"]: r["id"] for r in relationships}
    sub2super = read_object_types(object_types_path, name2cid,
                                  VG_OBJECT_SUPER_CLASSES)

    images = [{"id": img["image_id"], "width": img["width"],
               "height": img["height"],
               "file_name": img["url"].replace(
                   "https://cs.stanford.edu/people/rak248/", ""),
               "coco_id": img.get("coco_id")}
              for img in raw_img_data
              if img["image_id"] not in CORRUPTED_IMAGE_IDS]

    instances = []
    for img in raw_obj_data:
        if img["image_id"] in CORRUPTED_IMAGE_IDS:
            continue
        area = image_areas[img["image_id"]]
        for obj in img["objects"]:
            names = obj["names"]
            if len(names) != 1 or names[0] not in name2cid:
                continue
            if obj["w"] * obj["h"] <= area * area_frac:
                continue
            cid = name2cid[names[0]]
            instances.append({
                "id": obj["object_id"], "image_id": img["image_id"],
                "category_id": cid,
                "super_category_id": sub2super.get(cid, []),
                "bbox": [obj["x"], obj["y"], obj["x"] + obj["w"],
                         obj["y"] + obj["h"]],
                "area": obj["w"] * obj["h"]})

    annotations = []
    for img in raw_relation_data:
        for rel in img["relationships"]:
            pred = rel["predicate"]
            sub_names = rel["subject"]["names"]
            obj_names = rel["object"]["names"]
            if (len(pred) != 1 or len(sub_names) != 1
                    or len(obj_names) != 1):
                continue
            if (pred[0] not in name2rid or sub_names[0] not in name2cid
                    or obj_names[0] not in name2cid):
                continue
            cid1 = name2cid[sub_names[0]]
            cid2 = name2cid[obj_names[0]]
            annotations.append({
                "image_id": img["image_id"],
                "relation_id": name2rid[pred[0]],
                "subject_id": rel["subject"]["object_id"],
                "object_id": rel["object"]["object_id"],
                "category1": cid1, "category2": cid2,
                "super_category1": sub2super.get(cid1, []),
                "super_category2": sub2super.get(cid2, [])})

    images_train = [images[i] for i in split_train_idx]
    images_test = [images[i] for i in split_test_idx]
    train_ids = {img["id"] for img in images_train}
    test_ids = {img["id"] for img in images_test}

    def split(records, ids):
        return [r for r in records if r["image_id"] in ids]

    train = {"images": images_train, "categories": categories,
             "relationships": relationships,
             "instances": split(instances, train_ids),
             "annotations": split(annotations, train_ids)}
    test = {"images": images_test, "categories": categories,
            "relationships": relationships,
            "instances": split(instances, test_ids),
            "annotations": split(annotations, test_ids)}
    return train, test, sub2super


def load_h5_split(path: str):
    """VG-SGG-with-attri.h5 split array -> (train_idx, test_idx)
    (reference preprocess.py:33-37).  Needs the h5py package."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "load_h5_split needs the h5py package to read "
            f"{path}") from e
    with h5py.File(path, "r") as f:
        split = f["split"][:]
    return np.nonzero(split == 0)[0], np.nonzero(split == 2)[0]


# ---------------------------------------------------------------------------
# Per-image annotations (offline phase 2)
# ---------------------------------------------------------------------------

def build_image_annotation(image_record: Dict, instances: List[Dict],
                           relations: List[Dict], feature_size: int = 32,
                           depth: Optional[np.ndarray] = None) -> Optional[
                               Dict]:
    """One image's training record (reference dataset_utils.py:111-200):
    objects sorted by raw area descending; boxes rescaled to the feature
    grid in canonical (x_min, x_max, y_min, y_max); lower-triangular
    relation/direction rows (1 = current object is the subject)."""
    if not instances or not relations:
        return None
    h_img, w_img = image_record["height"], image_record["width"]
    order = np.argsort(-np.asarray([inst["area"] for inst in instances]),
                       kind="stable")
    insts = [instances[i] for i in order]

    boxes, cats, supers = [], [], []
    for inst in insts:
        bb = resize_box(inst["bbox"], (h_img, w_img),
                        (feature_size, feature_size))
        boxes.append([bb[0], bb[2], bb[1], bb[3]])   # canonical format
        cats.append(inst["category_id"])
        supers.append(np.asarray(inst["super_category_id"], np.int64))

    obj_ids = [inst["id"] for inst in insts]
    id_pos = {oid: i for i, oid in enumerate(obj_ids)}
    rel_pairs = {}
    for rel in relations:
        si = id_pos.get(rel["subject_id"])
        oi = id_pos.get(rel["object_id"])
        if si is None or oi is None or si == oi:
            continue
        key = (max(si, oi), min(si, oi))
        if key not in rel_pairs:      # one relation per pair in VG
            rel_pairs[key] = (rel["relation_id"], 1.0 if si > oi else 0.0)

    relationships, subj_or_obj = [], []
    for i in range(1, len(insts)):
        row_r = np.full(i, -1, np.int64)
        row_d = np.full(i, -1.0, np.float32)
        for j in range(i):
            if (i, j) in rel_pairs:
                row_r[j], row_d[j] = rel_pairs[(i, j)]
        relationships.append(row_r)
        subj_or_obj.append(row_d)

    if depth is None:
        depth = np.zeros((feature_size, feature_size), np.float32)
    return {
        "image_depth": depth.reshape(1, feature_size, feature_size),
        "categories": np.asarray(cats, np.int64),
        "super_categories": supers,
        "bbox": np.asarray(boxes, np.float32),
        "relationships": relationships,
        "subj_or_obj": subj_or_obj,
    }


def build_all_annotations(dataset_json: Dict, annot_dir: str,
                          feature_size: int = 32,
                          depth_fn: Optional[Callable] = None,
                          image_dir: Optional[str] = None,
                          verbose: bool = False) -> int:
    """Writes one .npz per image under annot_dir (the offline cache the
    training loader consumes, reference prepare_datasets.py:1-66)."""
    os.makedirs(annot_dir, exist_ok=True)
    by_image_inst: Dict[int, List] = {}
    for inst in dataset_json["instances"]:
        by_image_inst.setdefault(inst["image_id"], []).append(inst)
    by_image_rel: Dict[int, List] = {}
    for rel in dataset_json["annotations"]:
        by_image_rel.setdefault(rel["image_id"], []).append(rel)

    count = 0
    for img in dataset_json["images"]:
        insts = by_image_inst.get(img["id"], [])
        rels = by_image_rel.get(img["id"], [])
        depth = None
        if depth_fn is not None and image_dir is not None:
            path = os.path.join(image_dir, img["file_name"])
            if os.path.exists(path):
                from PIL import Image
                with Image.open(path) as im:
                    depth = depth_fn(np.asarray(im.convert("RGB")))
        rec = build_image_annotation(img, insts, rels, feature_size, depth)
        if rec is None:
            continue
        # keep the relative path (e.g. VG_100K/123) like the reference's
        # annotation cache (reference dataset_utils.py:198-200)
        name = os.path.splitext(img["file_name"])[0]
        out = os.path.join(annot_dir, name + "_annotations.npz")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        np.savez_compressed(
            out, image_depth=rec["image_depth"],
            categories=rec["categories"], bbox=rec["bbox"],
            relationships=np.array(rec["relationships"], dtype=object),
            subj_or_obj=np.array(rec["subj_or_obj"], dtype=object),
            super_categories=np.array(rec["super_categories"],
                                      dtype=object))
        count += 1
        if verbose and count % 1000 == 0:
            print(f"wrote {count} annotation files")
    return count
