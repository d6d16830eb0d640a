"""Fabricates a raw Visual Genome in the format of the files VG publishes
(image_data.json, objects.json, relationships.json), the four vocabulary
files the reference's cleaning reads (object_alias.txt, predicate_alias.txt,
object_list.txt, object_types.txt) and the JPEGs, so the offline pipeline
(tools/preprocess_vg.py: instances, annotations, triplets, sgrecords) can be
driven end to end without the real dataset.

Layout under <out>:
  raw/image_data.json, raw/objects.json, raw/relationships.json
  vocab/object_alias.txt, predicate_alias.txt, object_list.txt,
        object_types.txt
  images/VG_100K/<id>.jpg, images/VG_100K_2/<id>.jpg (every third image)

The data carries what the cleaning exists for: names in alias, upper-case
and punctuated forms, objects with two names or a name outside the object
list, duplicate boxes (the same box under another name; a box inside one of
the same name), boxes under the 0.002 area fraction, relationship endpoints
missing from the object list, and one image of a corrupted id (1592), which
the instances stage drops.  Predicate k of VG_RELATIONS_BY_FREQ occurs
50 - k times, so the frequency ranking is VG's and raw predicate 12
('wears') is present.

    python -m scene_graph_commonsense_torch.tools.make_raw_vg \\
        --out datasets/raw_vg --images 60 [--seed 0] \\
        [--sizes 600x800,800x600] [--max-objects 16]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from scene_graph_commonsense_torch.constants import (
    VG_OBJECT_SUPER_CLASSES, VG_OBJECTS, VG_RELATIONS_BY_FREQ)

CORRUPTED_ID = 1592
URL = "https://cs.stanford.edu/people/rak248/"


def write_vocab(vocab_dir: str, rng: np.random.Generator) -> None:
    """The four vocabulary files: every 10th object name and the ten most
    frequent predicates have an alias; each object takes one or two
    super-classes (some lines carry an unknown super-class or a trailing
    underscore)."""
    os.makedirs(vocab_dir, exist_ok=True)
    with open(os.path.join(vocab_dir, "object_alias.txt"), "w") as f:
        for name in VG_OBJECTS[::10]:
            f.write(f"{name},{name}z\n")
    with open(os.path.join(vocab_dir, "predicate_alias.txt"), "w") as f:
        for pred in VG_RELATIONS_BY_FREQ[:10]:
            f.write(f"{pred},{pred} a\n")
    with open(os.path.join(vocab_dir, "object_list.txt"), "w") as f:
        f.write("\n".join(VG_OBJECTS) + "\n")
    with open(os.path.join(vocab_dir, "object_types.txt"), "w") as f:
        for i, name in enumerate(VG_OBJECTS):
            k = int(rng.integers(1, 3))
            sups = list(rng.choice(VG_OBJECT_SUPER_CLASSES, k,
                                   replace=False))
            if i % 13 == 0:
                sups.append("stuff")
            f.write(",".join([name] + sups) + ("_" if i % 17 == 0 else "")
                    + "\n")


def _raw_name(rng, name: str) -> str:
    """A name as VG's annotators wrote it: its alias, upper case or
    punctuation now and then."""
    if VG_OBJECTS.index(name) % 10 == 0 and rng.random() < 0.3:
        name = name + "z"
    if rng.random() < 0.2:
        name = name.title()
    if rng.random() < 0.1:
        name = name + "!"
    return name


def _box(rng, h: int, w: int, lo: float = 0.1, hi: float = 0.5):
    bw = int(rng.integers(max(int(w * lo), 2), max(int(w * hi), 3)))
    bh = int(rng.integers(max(int(h * lo), 2), max(int(h * hi), 3)))
    return {"x": int(rng.integers(0, w - bw)),
            "y": int(rng.integers(0, h - bh)), "w": bw, "h": bh}


def _image_objects(rng, i: int, h: int, w: int, max_objects: int,
                   next_id, weights):
    objs = []
    for _ in range(int(rng.integers(4, max_objects + 1))):
        name = VG_OBJECTS[int(rng.choice(len(VG_OBJECTS), p=weights))]
        objs.append({"object_id": next_id(), **_box(rng, h, w),
                     "names": [_raw_name(rng, name)]})
    first = objs[0]
    box = {k: first[k] for k in ("x", "y", "w", "h")}
    if i % 4 == 0:       # the same box under another name: mean merge
        objs.append({"object_id": next_id(), **box, "names": ["rock"]})
    if i % 4 == 1:       # inside a box of the same name: extreme merge
        inner = {"x": box["x"] + 1, "y": box["y"] + 1,
                 "w": max(box["w"] - 2, 1), "h": max(box["h"] - 2, 1)}
        objs.append({"object_id": next_id(), **inner,
                     "names": list(first["names"])})
    if i % 4 == 2:       # under 0.002 of the image's area
        objs.append({"object_id": next_id(), "x": 1, "y": 1, "w": 2,
                     "h": 2, "names": ["tree"]})
    if i % 5 == 3:       # a name outside the object list
        objs.append({"object_id": next_id(), **_box(rng, h, w),
                     "names": ["xyzzy blob"]})
    if i % 7 == 0:       # two names
        objs.append({"object_id": next_id(), **_box(rng, h, w),
                     "names": ["man", "person"]})
    return objs


def _entity(rng, obj) -> Dict:
    ent = {k: obj[k] for k in ("object_id", "x", "y", "w", "h")}
    if rng.random() < 0.2:
        ent["names"] = list(obj["names"])
    else:
        ent["name"] = obj["names"][0]
    return ent


def render(rng, objs, h: int, w: int) -> np.ndarray:
    """Rectangles coloured by name on a noisy background."""
    img = rng.integers(90, 120, (h, w, 3)).astype(np.uint8)
    for obj in objs:
        c = sum(obj["names"][0].encode()) % 251
        img[obj["y"]:obj["y"] + obj["h"], obj["x"]:obj["x"] + obj["w"]] = \
            ((c * 53) % 200 + 55, (c * 101) % 200 + 55, (c * 29) % 200 + 55)
    return img


def make_raw_vg(out: str, images: int = 60, seed: int = 0,
                sizes: Optional[Sequence[Tuple[int, int]]] = None,
                max_objects: int = 16) -> Dict[str, str]:
    """Writes the raw dataset under `out`: `images` images of sizes (height,
    width) taken in turn (default VG's 600x800 and 800x600), then one of
    the corrupted id.  Returns the paths: raw_dir, vocab_dir, image_dir."""
    from PIL import Image

    sizes = list(sizes or ((600, 800), (800, 600)))
    rng = np.random.default_rng(seed)
    paths = {"raw_dir": os.path.join(out, "raw"),
             "vocab_dir": os.path.join(out, "vocab"),
             "image_dir": os.path.join(out, "images")}
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    write_vocab(paths["vocab_dir"], rng)
    weights = 1.0 / (np.arange(len(VG_OBJECTS)) + 5.0)
    weights /= weights.sum()
    counter = iter(range(1000, 10 ** 9))

    def next_id():
        return next(counter)

    ids = list(range(1, images + 1)) + [CORRUPTED_ID]
    preds = np.repeat(np.arange(len(VG_RELATIONS_BY_FREQ)),
                      np.arange(len(VG_RELATIONS_BY_FREQ), 0, -1))
    rng.shuffle(preds)
    image_data, objects, relationships = [], [], []
    for i, image_id in enumerate(ids):
        h, w = sizes[i % len(sizes)]
        folder = "VG_100K_2" if i % 3 == 2 else "VG_100K"
        image_data.append({"image_id": image_id, "width": w, "height": h,
                           "url": f"{URL}{folder}/{image_id}.jpg",
                           "coco_id": None if i % 2 else 100000 + i})
        objs = _image_objects(rng, i, h, w, max_objects, next_id, weights)
        rels = []
        for k in preds[i::len(ids)]:
            si, oi = rng.choice(len(objs), 2, replace=False)
            sub = objs[int(si)]
            if rng.random() < 0.1:      # missing from the object list
                sub = {"object_id": next_id(), **_box(rng, h, w),
                       "names": [VG_OBJECTS[int(rng.integers(0, 60))]]}
            pred = VG_RELATIONS_BY_FREQ[int(k)]
            if k < 10 and rng.random() < 0.3:
                pred = (pred + " a").upper()
            rels.append({"predicate": pred, "subject": _entity(rng, sub),
                         "object": _entity(rng, objs[int(oi)])})
        objects.append({"image_id": image_id, "objects": objs})
        relationships.append({"image_id": image_id,
                              "relationships": rels})
        os.makedirs(os.path.join(paths["image_dir"], folder), exist_ok=True)
        Image.fromarray(render(rng, objs, h, w)).save(
            os.path.join(paths["image_dir"], folder, f"{image_id}.jpg"),
            quality=90)
    for name, data in (("image_data", image_data), ("objects", objects),
                       ("relationships", relationships)):
        with open(os.path.join(paths["raw_dir"], name + ".json"), "w") as f:
            json.dump(data, f)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="datasets/raw_vg")
    ap.add_argument("--images", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sizes", default="",
                    help="comma-separated HxW image sizes taken in turn")
    ap.add_argument("--max-objects", type=int, default=16)
    a = ap.parse_args(argv)
    sizes = [tuple(int(v) for v in s.split("x"))
             for s in a.sizes.split(",") if s] or None
    paths = make_raw_vg(a.out, a.images, a.seed, sizes, a.max_objects)
    print(f"wrote a raw VG of {a.images} images (+1 corrupted) under "
          f"{a.out}: {paths}")


if __name__ == "__main__":
    main()
