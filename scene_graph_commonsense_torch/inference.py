"""Serving-style scene-graph inference (torch port of
scene_graph_commonsense_tpu/inference.py): from images through the frozen
DETR featurizer, or from precomputed features; multi-GPU serving comes with
a later slice.

Usage:
    model = make_relation_classifier(cfg, state_dict=weights)
    detr = make_detr(cfg)                  # or load_detr_featurizer(cfg)[1]
    predictor = SceneGraphPredictor(cfg, model, detr_model=detr)
    graphs = predictor.predict(batch, top_k=50)
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from scene_graph_commonsense_torch.constants import (
    VG_OBJECTS, VG_RELATIONS_BY_SUPER)
from scene_graph_commonsense_torch.eval.builders import build_candidates
from scene_graph_commonsense_torch.eval.engines import to_numpy
from scene_graph_commonsense_torch.train import engine as engine_lib
from scene_graph_commonsense_torch.train.loop import make_detr_featurize_fn

# what the relation stage reads of a request (JAX inference.py:59-61)
BATCH_KEYS = ("features", "depth", "cats", "super_mh", "boxes", "rel",
              "valid")


class SceneGraphPredictor:
    """Batched scene-graph inference with the hierarchical relation head."""

    def __init__(self, cfg, model, detr_model=None, detr_params=None,
                 validator=None, device=None):
        """`model`: a RelationClassifier; it runs on `device` (default
        cuda, see train.engine.make_eval_step, which also turns TF32 off).
        `detr_model`: optional frozen models.detr.DETR (make_detr) on the
        same device; with it, requests may carry 'image' (B, S*32, S*32, 3)
        instead of 'features'.  `detr_params`: an optional state dict loaded
        into it.  `validator`: optional commonsense filter with a
        filter_scores(conf, sub, rel, obj) method."""
        self.cfg = cfg
        self.model = model
        self.validator = validator
        self.estep = engine_lib.make_eval_step(model, cfg, device=device)
        self.featurize = None
        if detr_model is not None:
            self.featurize = make_detr_featurize_fn(cfg, detr_model,
                                                    detr_params)

    def predict(self, batch: Dict, top_k: int = 50) -> List[List[Dict]]:
        """batch: engine batch contract ('features' or 'image' + objects).
        Returns, per image, the top_k ranked edges as dicts with names,
        ids, boxes, and confidence."""
        if self.featurize is not None:
            batch = self.featurize(batch)
        batch = {k: v for k, v in batch.items() if k in BATCH_KEYS}
        if "rel" not in batch:
            b, n = np.asarray(batch["cats"]).shape
            batch = {**batch, "rel": np.full((b, n, n), -1, np.int32)}
        out = to_numpy(self.estep(batch))
        m = self.cfg.model
        cats = np.asarray(batch["cats"])
        cand = build_candidates(
            out["relation"], out["connectivity"], out["super_relation"],
            out["pair_img"], out["pair_sub"], out["pair_obj"],
            out["pair_mask"], out["iou_ok"], cats,
            np.asarray(batch["boxes"]), hierarchical=m.hierarchical_pred,
            num_geometric=m.num_geometric, num_possessive=m.num_possessive)

        graphs: List[List[Dict]] = []
        for image in range(cats.shape[0]):
            sel = cand.img == image
            conf = cand.conf[sel]
            if self.validator is not None:
                conf = self.validator.filter_scores(
                    conf, cand.sub_cat[sel], cand.rel[sel],
                    cand.obj_cat[sel])
            order = np.argsort(-conf, kind="stable")[:min(top_k, len(conf))]
            edges = []
            for j in order:
                if not np.isfinite(conf[j]):
                    continue
                sid = int(cand.sub_cat[sel][j])
                rid = int(cand.rel[sel][j])
                oid = int(cand.obj_cat[sel][j])
                edges.append({
                    "subject": VG_OBJECTS[sid] if sid < len(VG_OBJECTS)
                    else str(sid),
                    "relation": VG_RELATIONS_BY_SUPER[rid]
                    if rid < len(VG_RELATIONS_BY_SUPER) else str(rid),
                    "object": VG_OBJECTS[oid] if oid < len(VG_OBJECTS)
                    else str(oid),
                    "subject_id": sid, "relation_id": rid, "object_id": oid,
                    "subject_box": cand.sub_box[sel][j].tolist(),
                    "object_box": cand.obj_box[sel][j].tolist(),
                    "confidence": float(conf[j]),
                })
            graphs.append(edges)
        return graphs
