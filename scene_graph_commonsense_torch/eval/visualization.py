"""Qualitative scene-graph dumps (torch port of
scene_graph_commonsense_tpu/eval/visualization.py; numpy only).

Replicates the reference's save_visualization_results (reference
evaluator.py:465-519): per image, the top-k most confident predicted edges
with names and image-space boxes, next to the target graph, serialized per
batch for offline inspection.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from scene_graph_commonsense_torch.constants import (
    VG_OBJECTS, VG_RELATIONS_BY_SUPER)
from scene_graph_commonsense_torch.eval.recall import Candidates, Targets


def _to_image_space(box, feature_size, height, width):
    """(x_min, x_max, y_min, y_max) grid box -> ceil'd image coords.

    Documented deviation: the reference scales slots 0-1 by height and
    2-3 by width (evaluator.py:487-492) even though its own bbox layout
    is x-first (dataset_utils.py:130) — distorting every dump on
    non-square images; here x scales by width and y by height."""
    b = np.asarray(box, np.float64) / feature_size
    return [int(np.ceil(b[0] * width)), int(np.ceil(b[1] * width)),
            int(np.ceil(b[2] * height)), int(np.ceil(b[3] * height))]


def visualization_record(cand: Candidates, tgt: Targets, image: int,
                         top_k: int = 20, feature_size: int = 32,
                         height: int = 1, width: int = 1,
                         image_path: Optional[str] = None) -> Dict:
    cs = cand.img == image
    conf = cand.conf[cs]
    order = np.argsort(-conf, kind="stable")[:min(top_k, len(conf))]
    edges = []
    for j in order:
        sid = int(cand.sub_cat[cs][j])
        rid = int(cand.rel[cs][j])
        oid = int(cand.obj_cat[cs][j])
        edges.append({
            "edge": f"{VG_OBJECTS[sid]} {VG_RELATIONS_BY_SUPER[rid]} "
                    f"{VG_OBJECTS[oid]}",
            "subject_id": sid, "relation_id": rid, "object_id": oid,
            "confidence": float(conf[j]),
            "bbox_sub": _to_image_space(cand.sub_box[cs][j], feature_size,
                                        height, width),
            "bbox_obj": _to_image_space(cand.obj_box[cs][j], feature_size,
                                        height, width)})
    ts = (tgt.img == image) & (tgt.rel >= 0)
    target_graph = [
        {"edge": f"{VG_OBJECTS[int(s)]} {VG_RELATIONS_BY_SUPER[int(r)]} "
                 f"{VG_OBJECTS[int(o)]}"}
        for s, r, o in zip(tgt.sub_cat[ts], tgt.rel[ts], tgt.obj_cat[ts])]
    return {"predicted_graph": edges, "target_graph": target_graph,
            "image_path": image_path, "height": height, "width": width}


def save_visualization_results(out_dir: str, batch_count: int,
                               cand: Candidates, tgt: Targets,
                               heights: Sequence[int],
                               widths: Sequence[int],
                               image_paths: Optional[Sequence[str]] = None,
                               top_k: int = 20,
                               feature_size: int = 32) -> str:
    os.makedirs(out_dir, exist_ok=True)
    records = []
    for image in np.unique(cand.img):
        records.append(visualization_record(
            cand, tgt, int(image), top_k, feature_size,
            height=int(heights[int(image)]), width=int(widths[int(image)]),
            image_path=None if image_paths is None
            else str(image_paths[int(image)])))
    path = os.path.join(out_dir, f"{batch_count}_vis_results.json")
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
    return path
