"""Two-phase prepare_cs pipeline and triplet stores (torch port of
scene_graph_commonsense_tpu/commonsense/pipeline.py).

Phase 1 (reference main.py:112, evaluate.py:193-202, evaluator.py:375-462):
run PredCLS inference over the *training* set, pick <=10 top-confidence
predicted edges per image that touch a GT subject/object, ask the LLM/VLM
validator, and save one restartable pseudo-annotation file per image with the
approved/rejected edges.

Phase 2 (reference main.py:114, dataloader.py:168-244): fold the per-image
files plus all GT triplets into the commonsense-aligned dictionary and the
(LLM-rejected minus GT) commonsense-violated dictionary, saved as dense
npz tables consumed by train_cs / eval_cs.

The per-image files make the pipeline restartable across API interruptions,
the property the reference gets from its two-step design (reference
main.py:106-114).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from scene_graph_commonsense_torch.commonsense.cache import EdgeCache
from scene_graph_commonsense_torch.commonsense.client import (
    batch_query_edges_concurrent)
from scene_graph_commonsense_torch.constants import (
    VG_OBJECTS, VG_RELATIONS_BY_SUPER)
from scene_graph_commonsense_torch.eval.recall import Candidates, Targets


def edge_string(sub_cat: int, rel: int, obj_cat: int) -> str:
    return (f"{VG_OBJECTS[sub_cat]} {VG_RELATIONS_BY_SUPER[rel]} "
            f"{VG_OBJECTS[obj_cat]}")


def select_related_top_k(cand: Candidates, tgt: Targets, image: int,
                         top_k: int = 10) -> Tuple[List[str], List[Dict]]:
    """Selects <=10 unique top-confidence predicted edges touching a GT
    subject or object (exact category + identical box), replicating
    reference evaluator.py:390-415 including the 15-target / 10-edge caps."""
    cs = cand.img == image
    ts = tgt.img == image
    conf = cand.conf[cs]
    order = np.argsort(-conf, kind="stable")
    sub_cat = cand.sub_cat[cs]
    obj_cat = cand.obj_cat[cs]
    sub_box = cand.sub_box[cs]
    obj_box = cand.obj_box[cs]
    rel = cand.rel[cs]

    predictions: List[str] = []
    graph: List[Dict] = []
    for i in np.nonzero(ts)[0]:
        if tgt.rel[i] == -1:
            continue
        if len(graph) >= 15:        # efficiency cap, evaluator.py:393
            break
        for j in order[:min(top_k, len(order))]:
            sub_match = (tgt.sub_cat[i] == sub_cat[j]
                         and np.abs(tgt.sub_box[i] - sub_box[j]).sum() == 0)
            obj_match = (tgt.obj_cat[i] == obj_cat[j]
                         and np.abs(tgt.obj_box[i] - obj_box[j]).sum() == 0)
            if sub_match or obj_match:
                string = edge_string(int(sub_cat[j]), int(rel[j]),
                                     int(obj_cat[j]))
                if string not in predictions:
                    graph.append({
                        "sub_box": sub_box[j], "rel": int(rel[j]),
                        "obj_box": obj_box[j], "conf": float(conf[j]),
                        "rank": int(np.nonzero(order == j)[0][0]),
                        "sub_cat": int(sub_cat[j]),
                        "obj_cat": int(obj_cat[j]),
                    })
                    predictions.append(string)
            if len(graph) >= 10:    # efficiency cap, evaluator.py:414
                break
    return predictions, graph


def save_pseudo_annotations(out_dir: str, annot_name: str,
                            valid_edges: List[Dict],
                            invalid_edges: List[Dict]) -> str:
    """One restartable per-image artifact (reference evaluator.py:436-444)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, annot_name + "_pseudo_annotations.npz")

    def pack(edges):
        if not edges:
            return {"sub_box": np.zeros((0, 4)), "obj_box": np.zeros((0, 4)),
                    "rel": np.zeros(0, np.int32),
                    "sub_cat": np.zeros(0, np.int32),
                    "obj_cat": np.zeros(0, np.int32)}
        return {"sub_box": np.stack([e["sub_box"] for e in edges]),
                "obj_box": np.stack([e["obj_box"] for e in edges]),
                "rel": np.asarray([e["rel"] for e in edges], np.int32),
                "sub_cat": np.asarray([e["sub_cat"] for e in edges],
                                      np.int32),
                "obj_cat": np.asarray([e["obj_cat"] for e in edges],
                                      np.int32)}

    packed = {f"valid_{k}": v for k, v in pack(valid_edges).items()}
    packed.update({f"invalid_{k}": v for k, v in pack(invalid_edges).items()})
    np.savez_compressed(path, **packed)
    return path


def load_pseudo_annotations(out_dir: str, annot_name: str):
    """Inverse of save_pseudo_annotations; None when the per-image file
    doesn't exist yet.  Lets an interrupted prepare_cs resume without
    re-querying the LLM for already-validated images (the point of the
    reference's restartable per-image artifacts, reference
    evaluator.py:436-444 + its separate accumulation pass)."""
    path = os.path.join(out_dir, annot_name + "_pseudo_annotations.npz")
    if not os.path.exists(path):
        return None
    data = np.load(path)

    def unpack(prefix):
        n = len(data[f"{prefix}_rel"])
        return [{"rel": int(data[f"{prefix}_rel"][i]),
                 "sub_box": data[f"{prefix}_sub_box"][i],
                 "obj_box": data[f"{prefix}_obj_box"][i],
                 "sub_cat": int(data[f"{prefix}_sub_cat"][i]),
                 "obj_cat": int(data[f"{prefix}_obj_cat"][i])}
                for i in range(n)]

    return unpack("valid"), unpack("invalid")


class TripletStore:
    """Phase-2 accumulator (reference dataloader.py:168-244)."""

    def __init__(self):
        self.gt: Dict[Tuple[int, int, int], int] = {}
        self.aligned: Dict[Tuple[int, int, int], int] = {}
        self.violated: Dict[Tuple[int, int, int], int] = {}

    def add_gt_image(self, rel: np.ndarray, cats: np.ndarray):
        """rel: (N, N) directed GT matrix; cats: (N,)."""
        for i, j in zip(*np.nonzero(rel >= 0)):
            key = (int(cats[i]), int(rel[i, j]), int(cats[j]))
            self.gt[key] = self.gt.get(key, 0) + 1

    def _match_box(self, box, boxes, valid, eval_mode="pc"):
        """Index of the GT object whose box matches (exact for PredCLS,
        best-IoU otherwise; reference utils.py:217-228)."""
        diffs = np.abs(boxes - box).sum(axis=1)
        if eval_mode == "pc":
            hits = np.nonzero((diffs == 0) & valid)[0]
            return int(hits[0]) if len(hits) else None
        from scene_graph_commonsense_torch.eval.recall import np_mask_iou
        ious = np.where(valid, np_mask_iou(box[None], boxes), -1)
        return int(ious.argmax())

    def add_pseudo_image(self, pseudo: Dict, boxes: np.ndarray,
                         cats: np.ndarray, valid: np.ndarray,
                         eval_mode: str = "pc"):
        for prefix, store in [("valid", self.aligned),
                              ("invalid", self.violated)]:
            n = len(pseudo[f"{prefix}_rel"])
            for e in range(n):
                si = self._match_box(pseudo[f"{prefix}_sub_box"][e], boxes,
                                     valid, eval_mode)
                oi = self._match_box(pseudo[f"{prefix}_obj_box"][e], boxes,
                                     valid, eval_mode)
                if si is None or oi is None or si == oi:
                    continue
                key = (int(cats[si]), int(pseudo[f"{prefix}_rel"][e]),
                       int(cats[oi]))
                store[key] = store.get(key, 0) + 1

    def finalize(self) -> Tuple[Dict, Dict]:
        """GT triplets join the aligned set; GT keys leave the violated set
        (reference dataloader.py:221-233)."""
        aligned = dict(self.aligned)
        for k, v in self.gt.items():
            aligned[k] = aligned.get(k, 0) + v
        violated = {k: v for k, v in self.violated.items()
                    if k not in self.gt}
        return aligned, violated

    def save(self, out_path: str):
        aligned, violated = self.finalize()

        def unzip(d):
            keys = list(d.keys())
            return (np.asarray([k[0] for k in keys], np.int32),
                    np.asarray([k[1] for k in keys], np.int32),
                    np.asarray([k[2] for k in keys], np.int32),
                    np.asarray([d[k] for k in keys], np.int64))

        a = unzip(aligned)
        v = unzip(violated)
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        np.savez_compressed(
            out_path,
            cs_aligned_sub=a[0], cs_aligned_rel=a[1], cs_aligned_obj=a[2],
            cs_aligned_count=a[3],
            cs_violated_sub=v[0], cs_violated_rel=v[1],
            cs_violated_obj=v[2], cs_violated_count=v[3])
        return out_path


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_prepare_cs(cfg, model, batches, artifacts=None, transport=None,
                   top_k: int = 10, out_dir: Optional[str] = None,
                   max_batches: Optional[int] = None, device=None) -> str:
    """Both phases in one pass (each phase remains independently restartable
    through the per-image files).  `model` is the port's RelationClassifier
    (its weights those of the baseline to validate); its eval step runs on
    `device` (default cuda; make_eval_step), and each batch's outputs come
    to the host once.  The transport defaults to the OpenAI one of
    cfg.model.llm_model."""
    from scene_graph_commonsense_torch.eval.builders import (
        build_candidates, build_targets)
    from scene_graph_commonsense_torch.eval.engines import (
        _model_batch, to_numpy)
    from scene_graph_commonsense_torch.train import engine as engine_lib

    if transport is None:
        if cfg.model.llm_model == "gpt4v":
            from scene_graph_commonsense_torch.commonsense.client import (
                openai_vision_transport)
            transport = openai_vision_transport()
        else:
            from scene_graph_commonsense_torch.commonsense.client import (
                openai_completion_transport)
            transport = openai_completion_transport()
    out_dir_overridden = out_dir is not None
    out_dir = out_dir or os.path.join(cfg.data.annot_dir,
                                      f"cs_top{top_k}")
    cache = EdgeCache()
    image_cache = None
    if cfg.model.llm_model == "gpt4v":
        from scene_graph_commonsense_torch.commonsense.cache import (
            ImageCache)
        image_cache = ImageCache(cfg.model.image_size,
                                 cfg.model.feature_size)
    store = TripletStore()
    estep = engine_lib.make_eval_step(model, cfg, device=device)
    m = cfg.model

    for bi, batch in enumerate(batches):
        if max_batches is not None and bi >= max_batches:
            break
        annot_paths = batch.get("annot_path") or [
            f"batch{bi}_img{i}" for i in range(len(batch["cats"]))]
        names = [os.path.splitext(os.path.basename(str(p)))[0]
                 for p in annot_paths]
        rel_np = _host(batch["rel"])
        cats_np = _host(batch["cats"])
        boxes_np = _host(batch["boxes"])
        valid_np = _host(batch["valid"])

        # GT triplets accumulate for EVERY image of the pass (the
        # reference's step 2 walks the whole dataset,
        # dataloader.py:221-227), independent of query success
        for image in range(len(names)):
            store.add_gt_image(rel_np[image], cats_np[image])

        # resume: images whose per-image artifact exists skip inference
        # and querying entirely (the restartability the two-phase design
        # exists for); a fully-done batch never touches the device
        existing = {image: load_pseudo_annotations(out_dir, names[image])
                    for image in range(len(names))}
        done = [(image, ex[0], ex[1])
                for image, ex in existing.items() if ex is not None]
        todo = [image for image, ex in existing.items() if ex is None]

        per_image = []
        if todo:
            out = to_numpy(estep(_model_batch(batch)))
            cand = build_candidates(
                out["relation"], out["connectivity"],
                out["super_relation"], out["pair_img"], out["pair_sub"],
                out["pair_obj"], out["pair_mask"], out["iou_ok"],
                cats_np, boxes_np,
                hierarchical=m.hierarchical_pred,
                num_geometric=m.num_geometric,
                num_possessive=m.num_possessive)
            tgt = build_targets(rel_np, cats_np, boxes_np, valid_np)
            for image in todo:
                predictions, graph = select_related_top_k(cand, tgt,
                                                          image, top_k)
                if graph:
                    per_image.append((image, names[image], predictions,
                                      graph))

        # network fan-out across the batch's images (the reference's
        # ThreadPoolExecutor parallelism, reference evaluator.py:450-456,
        # without its shared-state race — cache mutation stays here)
        if cfg.model.llm_model == "gpt4v":
            from scene_graph_commonsense_torch.commonsense.client import (
                query_edges_vision_concurrent)
            results = query_edges_vision_concurrent(
                [(p, os.path.join(cfg.data.image_dir, name + ".jpg"),
                  [g["sub_box"] for g in graph],
                  [g["obj_box"] for g in graph])
                 for _, name, p, graph in per_image],
                image_cache, transport)
        else:
            results = [v for v, _ in batch_query_edges_concurrent(
                [p for _, _, p, _ in per_image], cache, transport)]
        for (image, name, _, graph), votes in zip(per_image, results):
            if votes is None:
                # missing image file: do NOT persist an artifact — an
                # all-negative vote would poison the tables and resume
                # would make it permanent
                print(f"WARNING: image for {name} not found under "
                      f"{cfg.data.image_dir}; skipping its edges")
                continue
            valid = [g for g, v in zip(graph, votes) if v == 1]
            invalid = [g for g, v in zip(graph, votes) if v != 1]
            save_pseudo_annotations(out_dir, name, valid, invalid)
            done.append((image, valid, invalid))
        for image, valid, invalid in done:
            # phase 2 accumulation of the LLM-validated pseudo edges
            pseudo = {}
            for prefix, edges in [("valid", valid), ("invalid", invalid)]:
                pseudo[f"{prefix}_rel"] = [e["rel"] for e in edges]
                pseudo[f"{prefix}_sub_box"] = [e["sub_box"] for e in edges]
                pseudo[f"{prefix}_obj_box"] = [e["obj_box"] for e in edges]
            store.add_pseudo_image(pseudo, boxes_np[image],
                                   cats_np[image], valid_np[image],
                                   cfg.training.eval_mode)
    # when the caller redirects the per-image files, the final table goes
    # with them — a test/smoke run must not clobber the converted artifact
    # in cfg.data.artifacts_dir
    table_dir = out_dir if out_dir_overridden else cfg.data.artifacts_dir
    path = store.save(os.path.join(table_dir, "commonsense_triplets.npz"))
    return path
