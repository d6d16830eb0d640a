"""PredCLS evaluation engine (torch port of the PredCLS half of
scene_graph_commonsense_tpu/eval/engines.py; SGCLS and SGDET come with the
detection slice).

The engine runs the eval step per batch, moves its outputs to numpy once,
turns them into flat Candidates/Targets and streams them into the numpy
evaluators (GT boxes + GT labels, overlap-filtered pair grid; reference
evaluate.py:29-227).
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from scene_graph_commonsense_torch.constants import OIV6_WMAP_WEIGHT
from scene_graph_commonsense_torch.eval.builders import (
    build_candidates, build_candidates_top3, build_targets,
    eval_column_keep)
from scene_graph_commonsense_torch.eval.recall import Evaluator, EvaluatorTop3
from scene_graph_commonsense_torch.train import engine as engine_lib


def to_numpy(out: Dict) -> Dict:
    """Eval-step outputs -> numpy (one device-to-host copy per entry)."""
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def check_pair_overflow(out, warned: list) -> bool:
    """Warns ONCE per run when the packed pair buffer truncated (silent
    pair-dropping changes recall).  `warned` is a single-element mutable
    flag owned by the calling run."""
    count = np.asarray(out["pair_count"])
    cap = np.asarray(out["pair_capacity"])
    over = bool((count > cap).any())
    if over and not warned[0]:
        warned[0] = True
        warnings.warn(
            f"pair buffer overflow: {int(count.max())} live pairs > "
            f"capacity {int(cap.min())} — excess pairs are DROPPED and "
            f"recall may shift; raise training.pair_capacity",
            RuntimeWarning, stacklevel=2)
    return over


def _accumulate_batch(evaluator, ev3, cfg, out, batch, artifacts,
                      use_cs: bool):
    m = cfg.model
    cats, boxes = np.asarray(batch["cats"]), np.asarray(batch["boxes"])
    cs_a = cs_v = None
    if use_cs and artifacts is not None:
        cs_a, cs_v = artifacts.cs_aligned, artifacts.cs_violated
    cand = build_candidates(
        out["relation"], out["connectivity"], out["super_relation"],
        out["pair_img"], out["pair_sub"], out["pair_obj"],
        out["pair_mask"], out["iou_ok"], cats, boxes,
        hierarchical=m.hierarchical_pred, num_geometric=m.num_geometric,
        num_possessive=m.num_possessive, predcls=True,
        cs_aligned=cs_a, cs_violated=cs_v, num_obj_classes=m.num_classes)
    keep = None
    if cfg.training.faithful_eval_targets:
        # deviation 4: drop targets of pair columns whose overlap filter
        # failed for every image in this batch (eval/builders docstring)
        keep = eval_column_keep(boxes, np.asarray(batch["valid"]),
                                cfg.model.feature_size)
    tgt = build_targets(np.asarray(batch["rel"]), cats, boxes,
                        np.asarray(batch["valid"]), keep=keep)
    evaluator.accumulate(cand, tgt)
    if cfg.data.dataset == "oiv6":
        evaluator.accumulate_precision(cand, tgt)
    if ev3 is not None:
        cand3 = build_candidates_top3(
            out["relation"], out["connectivity"], out["super_relation"],
            out["pair_img"], out["pair_sub"], out["pair_obj"],
            out["pair_mask"], out["iou_ok"], cats, boxes,
            num_geometric=m.num_geometric, num_possessive=m.num_possessive)
        ev3.accumulate(cand3, tgt)


def _make_evaluators(cfg, artifacts):
    zs = artifacts.zs_table if (artifacts is not None
                                and cfg.data.dataset == "vg") else None
    ev = Evaluator(num_classes=cfg.model.num_relations,
                   feature_size=cfg.model.feature_size, predcls=True,
                   zs_table=zs, num_obj_classes=cfg.model.num_classes,
                   oiv6_weights=OIV6_WMAP_WEIGHT
                   if cfg.data.dataset == "oiv6" else None)
    ev3 = None
    if cfg.model.hierarchical_pred and cfg.data.dataset == "vg":
        ev3 = EvaluatorTop3(num_classes=cfg.model.num_relations,
                            feature_size=cfg.model.feature_size,
                            num_geometric=cfg.model.num_geometric,
                            num_possessive=cfg.model.num_possessive)
    return ev, ev3


def _results(cfg, ev, ev3) -> Dict:
    res = ev.compute()
    if ev3 is not None:
        res["top3"] = ev3.compute()
    if cfg.data.dataset == "oiv6":
        res["wmap_rel"], res["wmap_phrase"] = ev.compute_precision()
    return res


def run_eval_pc(cfg, model, batches: Iterable[Dict],
                artifacts=None, use_cs: bool = False, estep=None,
                device=None, max_batches: Optional[int] = None) -> Dict:
    """PredCLS: GT boxes + labels, overlap-filtered pair grid.  `model` is a
    RelationClassifier; it runs on `device` (default cuda, see
    train.engine.make_eval_step, which also turns TF32 off).  Pass a
    prebuilt `estep` to reuse it across calls; `max_batches` truncates the
    pass (the training loop's per-epoch test)."""
    ev, ev3 = _make_evaluators(cfg, artifacts)
    if estep is None:
        estep = engine_lib.make_eval_step(model, cfg, device=device)
    warned = [False]
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        out = to_numpy(estep(batch))
        check_pair_overflow(out, warned)
        _accumulate_batch(ev, ev3, cfg, out, batch, artifacts, use_cs)
    return _results(cfg, ev, ev3)
