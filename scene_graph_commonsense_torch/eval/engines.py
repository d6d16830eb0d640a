"""Evaluation engines: PredCLS / SGCLS / SGDET (torch port of
scene_graph_commonsense_tpu/eval/engines.py), each on one device or over
a data-parallel mesh (parallel/mesh.py).

Mirrors reference evaluate.py's three modes:
  * run_eval_pc  (reference evaluate.py:29-227): GT boxes + GT labels;
  * run_eval_sgc (reference evaluate.py:464-703): GT boxes + predicted
    labels matched per GT box by best IoU;
  * run_eval_sgd (reference evaluate.py:230-461): fully predicted
    boxes/labels through the static detection postprocess.

Each engine runs the eval step per batch, moves its outputs to numpy once,
turns them into flat Candidates/Targets and streams them into the numpy
evaluators.  SGCLS and SGDET take a `detect_fn(batch)` returning the
detection dict of ops/detection.postprocess_detections;
make_detr_detect_fn builds it from the frozen DETR detector, on the device.

Over a mesh every rank iterates the same global batches: each rank detects
on its rows and gathers the global detections, builds the global step
batch from them on the host, steps on its rows through the sharded eval
step (train.engine.make_eval_step(mesh=)), which gathers the global
outputs; rank 0 alone runs the evaluators, and its results are broadcast.

Documented deviation (the JAX package's): the reference's SGCLS label
matcher duplicates a GT box when the two best-IoU predicted slots tie (the
top-2 class candidates of one predicted box, reference utils.py:404-415);
by default each GT box is conditioned on the single best-IoU predicted
slot's class (training.sgcls_top2_duplicates restores the duplication).
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from scene_graph_commonsense_torch.constants import (
    OBJ_ALP2FRE, OIV6_WMAP_WEIGHT)
from scene_graph_commonsense_torch.eval.builders import (
    build_candidates, build_candidates_top3, build_targets,
    eval_column_keep, sgd_target_keep)
from scene_graph_commonsense_torch.eval.recall import (
    Evaluator, EvaluatorTop3, np_mask_iou)
from scene_graph_commonsense_torch.ops.detection import (
    postprocess_detections)
from scene_graph_commonsense_torch.parallel.mesh import (
    all_gather_rows, broadcast_object, shard_batch)
from scene_graph_commonsense_torch.train import engine as engine_lib


def to_numpy(out: Dict) -> Dict:
    """Eval-step outputs -> numpy (one device-to-host copy per entry)."""
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def check_pair_overflow(out, warned: list) -> bool:
    """Warns ONCE per run when the packed pair buffer truncated (silent
    pair-dropping changes recall).  pair_count and pair_capacity hold one
    entry per shard (one without a mesh).  `warned` is a single-element
    mutable flag owned by the calling run."""
    count = np.asarray(out["pair_count"])
    cap = np.asarray(out["pair_capacity"])
    over = bool((count > cap).any())
    if over and not warned[0]:
        warned[0] = True
        warnings.warn(
            f"pair buffer overflow: {int(count.max())} live pairs > "
            f"capacity {int(cap.min())} per shard — excess pairs are "
            f"DROPPED and recall may shift; raise training.pair_capacity",
            RuntimeWarning, stacklevel=2)
    return over


def _model_batch(batch: Dict) -> Dict:
    """Keeps only the entries the eval step reads (drops annotation paths,
    raw images, pixel masks)."""
    return {k: batch[k] for k in engine_lib.MODEL_KEYS
            if batch.get(k) is not None}


# the global batch entries the evaluators read on the host
HOST_KEYS = ("cats", "boxes", "rel", "valid")
# the detection view that detect_fn reads
DETECT_KEYS = ("image_nonsq", "pixel_mask")


def shard_eval_batch(mesh, batch: Dict,
                     featurize: Optional[Callable[[Dict], Dict]] = None
                     ) -> Dict:
    """A global batch sharded ahead of run_eval_pc / run_eval_sgc /
    run_eval_sgd (mesh=): the entries the evaluators read stay global on
    the host, and this rank's rows, featurized when `featurize` is given
    (no rank encodes images it then drops), go under "shard" with the
    rows of the detection view, where the batch has one."""
    local = shard_batch(mesh, batch)
    if featurize is not None:
        local = featurize(local)
    return {**{k: np.asarray(batch[k]) for k in HOST_KEYS},
            "shard": {**_model_batch(local),
                      **{k: local[k] for k in DETECT_KEYS if k in local}}}


def _step_rows(mesh, batch: Dict, **overrides) -> Dict:
    """What the eval step takes of a batch: its model entries with
    `overrides` (global arrays: the entries built from the detections) in
    their place; under a mesh this rank's rows of them, the model entries
    from the batch's "shard" when it was sharded ahead."""
    if mesh is None:
        return {**_model_batch(batch), **overrides}
    local = batch["shard"] if "shard" in batch \
        else shard_batch(mesh, _model_batch(batch))
    return {**_model_batch(local), **shard_batch(mesh, overrides)}


def _accumulate_batch(evaluator, ev3, cfg, out, batch, artifacts,
                      use_cs: bool, predcls: bool, cats, boxes,
                      cat_conf=None, target_keep=None):
    m = cfg.model
    cs_a = cs_v = None
    if use_cs and artifacts is not None:
        cs_a, cs_v = artifacts.cs_aligned, artifacts.cs_violated
    cand = build_candidates(
        out["relation"], out["connectivity"], out["super_relation"],
        out["pair_img"], out["pair_sub"], out["pair_obj"],
        out["pair_mask"], out["iou_ok"], cats, boxes,
        hierarchical=m.hierarchical_pred, num_geometric=m.num_geometric,
        num_possessive=m.num_possessive, predcls=predcls,
        cat_conf=cat_conf, cs_aligned=cs_a, cs_violated=cs_v,
        num_obj_classes=m.num_classes)
    keep = target_keep
    if cfg.training.faithful_eval_targets:
        # deviation 4: drop targets of pair columns whose overlap filter
        # failed for every image in this batch (eval/builders docstring)
        col = eval_column_keep(np.asarray(batch["boxes"]),
                               np.asarray(batch["valid"]),
                               cfg.model.feature_size)
        keep = col if keep is None else (keep & col)
    tgt = build_targets(np.asarray(batch["rel"]), np.asarray(batch["cats"]),
                        np.asarray(batch["boxes"]),
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
    return cand, tgt


def _make_evaluators(cfg, artifacts, predcls: bool):
    zs = artifacts.zs_table if (artifacts is not None
                                and cfg.data.dataset == "vg") else None
    ev = Evaluator(num_classes=cfg.model.num_relations,
                   feature_size=cfg.model.feature_size, predcls=predcls,
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
                device=None, max_batches: Optional[int] = None,
                on_batch: Optional[Callable] = None, mesh=None) -> Dict:
    """PredCLS: GT boxes + labels, overlap-filtered pair grid.  `model` is a
    RelationClassifier; it runs on `device` (default cuda, see
    train.engine.make_eval_step, which also turns TF32 off).  Pass a
    prebuilt `estep` to reuse it across calls; `max_batches` truncates the
    pass (the training loop's per-epoch test).  `on_batch(i, out, cand,
    tgt)` is called after each batch with its index, the step's outputs
    (numpy) and the Candidates / Targets it added (the visualization dump,
    eval/visualization.py).

    With a mesh (parallel/mesh.py; every rank iterates the same global
    batches) each rank steps on its rows of each batch through the sharded
    eval step (make_eval_step(mesh=); a prebuilt `estep` must be one),
    which gathers the global outputs on every rank.  A batch may come
    sharded already (shard_eval_batch: its "shard" entry is stepped on);
    any other is sharded here.  Rank 0 alone runs the evaluators and calls
    `on_batch`; every rank returns its results."""
    ev, ev3 = _make_evaluators(cfg, artifacts, predcls=True)
    if estep is None:
        estep = engine_lib.make_eval_step(model, cfg, device=device,
                                          mesh=mesh)
    lead = mesh is None or mesh.rank == 0
    warned = [False]
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        out = estep(_step_rows(mesh, batch))
        if not lead:
            continue
        out = to_numpy(out)
        check_pair_overflow(out, warned)
        cand, tgt = _accumulate_batch(
            ev, ev3, cfg, out, batch, artifacts, use_cs, predcls=True,
            cats=np.asarray(batch["cats"]), boxes=np.asarray(batch["boxes"]))
        if on_batch is not None:
            on_batch(i, out, cand, tgt)
    res = _results(cfg, ev, ev3) if lead else None
    return res if mesh is None else broadcast_object(mesh, res)


def match_predicted_labels(det: Dict[str, np.ndarray],
                           gt_boxes: np.ndarray, gt_valid: np.ndarray,
                           feature_size: int = 32):
    """SGCLS label matching: each GT box takes the class/confidence of the
    best-IoU predicted slot, confidence scaled by that IoU (reference
    utils.py:376-422)."""
    b, n = gt_valid.shape
    cats = np.zeros((b, n), np.int32)
    conf = np.zeros((b, n), np.float32)
    pb, pc, pv = (np.asarray(det["boxes"]), np.asarray(det["cats"]),
                  np.asarray(det["valid"]))
    pconf = np.asarray(det["cat_conf"])
    for bi in range(b):
        if not pv[bi].any():
            continue
        ious = np_mask_iou(gt_boxes[bi][:, None], pb[bi][None],
                           feature_size)
        ious = np.where(pv[bi][None, :], ious, -1.0)
        best = ious.argmax(axis=1)
        cats[bi] = pc[bi][best]
        conf[bi] = pconf[bi][best] * np.maximum(ious[np.arange(n), best], 0)
    cats[~gt_valid] = 0
    conf[~gt_valid] = 0
    return cats, conf


def match_predicted_labels_top2(det: Dict[str, np.ndarray],
                                gt_boxes: np.ndarray, gt_valid: np.ndarray,
                                feature_size: int = 32):
    """Reference-faithful SGCLS matching incl. the top-2 tie duplication
    (reference utils.py:376-422): each GT box takes the best-IoU predicted
    slot's class with confidence pred_conf * best_iou; when the two best
    IoUs tie EXACTLY (the same detection box repeated for its two class
    candidates, reference evaluate.py:313-315), the GT box is duplicated
    with both candidates.  Returns slot-expanded (cats, conf, boxes, valid)
    of width 2N (slots 2k / 2k+1 belong to GT box k; the reference inserts
    the duplicate adjacently, which is order-equivalent for the
    confidence-ranked evaluator).  An image with fewer than two predicted
    slots is dropped entirely (reference utils.py:393-394 returns None and
    eval_sgc skips the batch)."""
    b, n = gt_valid.shape
    cats = np.zeros((b, 2 * n), np.int32)
    conf = np.zeros((b, 2 * n), np.float32)
    boxes = np.zeros((b, 2 * n, 4), np.float32)
    valid = np.zeros((b, 2 * n), bool)
    pb, pc, pv = (np.asarray(det["boxes"]), np.asarray(det["cats"]),
                  np.asarray(det["valid"]))
    pconf = np.asarray(det["cat_conf"])
    for bi in range(b):
        if pv[bi].sum() < 2:
            continue
        ious = np_mask_iou(gt_boxes[bi][:, None], pb[bi][None],
                           feature_size)
        ious = np.where(pv[bi][None, :], ious, -1.0)
        order = np.argsort(-ious, axis=1, kind="stable")
        top1, top2 = order[:, 0], order[:, 1]
        iou1 = ious[np.arange(n), top1]
        iou2 = ious[np.arange(n), top2]
        for k in range(n):
            if not gt_valid[bi, k]:
                continue
            boxes[bi, 2 * k] = gt_boxes[bi, k]
            valid[bi, 2 * k] = True
            cats[bi, 2 * k] = pc[bi][top1[k]]
            conf[bi, 2 * k] = pconf[bi][top1[k]] * max(iou1[k], 0)
            if iou1[k] == iou2[k]:
                boxes[bi, 2 * k + 1] = gt_boxes[bi, k]
                valid[bi, 2 * k + 1] = True
                cats[bi, 2 * k + 1] = pc[bi][top2[k]]
                conf[bi, 2 * k + 1] = pconf[bi][top2[k]] * max(iou2[k], 0)
    return cats, conf, boxes, valid


def run_eval_sgc(cfg, model, batches: Iterable[Dict],
                 detect_fn: Callable[[Dict], Dict],
                 artifacts=None, use_cs: bool = False,
                 max_batches: Optional[int] = None, device=None,
                 mesh=None) -> Dict:
    """SGCLS: GT boxes, predicted labels.  detect_fn(batch) returns the
    detection dict of ops/detection.postprocess_detections (numpy or
    tensors).  `model` runs on `device` (default cuda).  With a mesh (see
    the module docstring) detect_fn returns the global detections on every
    rank (make_detr_detect_fn(mesh=)); a batch may come sharded ahead
    (shard_eval_batch)."""
    ev, _ = _make_evaluators(cfg, artifacts, predcls=False)
    cap = 0
    if cfg.training.sgcls_top2_duplicates:
        # slot-expanded 2N grid needs its own worst-case capacity (a
        # mesh step takes its ceiling per shard)
        n2 = 2 * cfg.data.max_objects
        cap = cfg.training.batch_size * n2 * (n2 - 1)
    estep = engine_lib.make_eval_step(model, cfg, capacity=cap,
                                      device=device, mesh=mesh)
    sub2super = artifacts.sub2super if artifacts is not None else None
    lead = mesh is None or mesh.rank == 0
    warned = [False]
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        det = to_numpy(detect_fn(batch))
        gt_boxes = np.asarray(batch["boxes"])
        gt_valid = np.asarray(batch["valid"])
        if cfg.training.sgcls_top2_duplicates:
            # faithful slot-expanded grid (2N slots, GT boxes duplicated
            # on exact top-2 IoU ties)
            cats, conf, boxes, valid = match_predicted_labels_top2(
                det, gt_boxes, gt_valid, cfg.model.feature_size)
            n2 = cats.shape[1]
            over = dict(cats=cats, boxes=boxes, valid=valid,
                        rel=np.full((cats.shape[0], n2, n2), -1, np.int32))
        else:
            cats, conf = match_predicted_labels(
                det, gt_boxes, gt_valid, cfg.model.feature_size)
            boxes = gt_boxes
            over = dict(cats=cats)
        if sub2super is not None:
            over["super_mh"] = sub2super[cats].astype(np.float32)
        out = estep(_step_rows(mesh, batch, **over))
        if not lead:
            continue
        out = to_numpy(out)
        check_pair_overflow(out, warned)
        # targets keep GT cats; candidates use matched predicted cats.  The
        # reference adds the RAW class confidences (softmax prob x IoU) to
        # the log-space relation confidence (reference evaluator.py:164-166,
        # utils.py:410-418), replicated as it is.  The reference's SGCLS
        # targets also come from match_target_sgd (reference
        # evaluate.py:597), so the faithful last-object-row drop applies as
        # in run_eval_sgd.
        tk = (sgd_target_keep(gt_valid)
              if cfg.training.faithful_sgd_targets else None)
        _accumulate_batch(ev, None, cfg, out, batch, artifacts, use_cs,
                          predcls=False, cats=cats, boxes=boxes,
                          cat_conf=conf, target_keep=tk)
    # Top-3 is a PredCLS-only report
    res = _results(cfg, ev, None) if lead else None
    return res if mesh is None else broadcast_object(mesh, res)


def run_eval_sgd(cfg, model, batches: Iterable[Dict],
                 detect_fn: Callable[[Dict], Dict],
                 artifacts=None, use_cs: bool = False,
                 max_batches: Optional[int] = None, device=None,
                 mesh=None) -> Dict:
    """SGDET: predicted boxes + labels drive the pair grid; GT pairs are the
    unmatched target set (reference utils.py:294-352).  `model` runs on
    `device` (default cuda).  A mesh as in run_eval_sgc."""
    ev, _ = _make_evaluators(cfg, artifacts, predcls=False)
    estep = engine_lib.make_eval_step(model, cfg, device=device, mesh=mesh)
    sub2super = artifacts.sub2super if artifacts is not None else None
    lead = mesh is None or mesh.rank == 0
    warned = [False]
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        det = to_numpy(detect_fn(batch))
        over = dict(cats=det["cats"], boxes=det["boxes"],
                    valid=det["valid"])
        if sub2super is not None:
            over["super_mh"] = sub2super[det["cats"]].astype(np.float32)
        out = estep(_step_rows(mesh, batch, **over))
        if not lead:
            continue
        out = to_numpy(out)
        check_pair_overflow(out, warned)
        m = cfg.model
        cs_a = cs_v = None
        if use_cs and artifacts is not None:
            cs_a, cs_v = artifacts.cs_aligned, artifacts.cs_violated
        # confidence adds subject + object class confidence (reference
        # evaluator.py:164-166); the reference adds raw softmax
        # probabilities.  Candidates on the detections, targets on the GT
        # (no overlap-column drop: that is the PredCLS/SGCLS pair loop's).
        cand = build_candidates(
            out["relation"], out["connectivity"], out["super_relation"],
            out["pair_img"], out["pair_sub"], out["pair_obj"],
            out["pair_mask"], out["iou_ok"], det["cats"], det["boxes"],
            hierarchical=m.hierarchical_pred, num_geometric=m.num_geometric,
            num_possessive=m.num_possessive, predcls=False,
            cat_conf=det["cat_conf"], cs_aligned=cs_a, cs_violated=cs_v,
            num_obj_classes=m.num_classes)
        keep = (sgd_target_keep(np.asarray(batch["valid"]))
                if cfg.training.faithful_sgd_targets else None)
        tgt = build_targets(np.asarray(batch["rel"]),
                            np.asarray(batch["cats"]),
                            np.asarray(batch["boxes"]),
                            np.asarray(batch["valid"]), keep=keep)
        ev.accumulate(cand, tgt)
        if cfg.data.dataset == "oiv6":
            ev.accumulate_precision(cand, tgt)
    # Top-3 is a PredCLS-only report
    res = _results(cfg, ev, None) if lead else None
    return res if mesh is None else broadcast_object(mesh, res)


def check_detector_classes(cfg) -> None:
    """Raises ValueError unless the detector's classes (cfg.model.
    num_classes plus the no-object slot) are the ones OBJ_ALP2FRE remaps:
    the reference's remap (evaluate.py:318-322) is VG's permutation of
    151 classes and no dataset defines another, so an OIv6 detector (602
    logits) has no class order to map to.  The JAX package gathers past
    the table's end, which clamps every OIv6 class from 150 on to class
    150; torch's indexing would fail (an IndexError on the CPU, a device
    assert on the card)."""
    classes = cfg.model.num_classes + 1
    if classes != len(OBJ_ALP2FRE):
        raise ValueError(
            f"SGCLS / SGDET remap the detector's classes through VG's "
            f"{len(OBJ_ALP2FRE)}-entry OBJ_ALP2FRE (reference "
            f"evaluate.py:318-322), but the {cfg.data.dataset} detector has "
            f"{classes} classes: no class remap is defined for it")


def make_detr_detect_fn(cfg, detr_model, mesh=None):
    """Returns detect_fn(batch) -> the detection dict (numpy): the full DETR
    forward of the detection view batch["image_nonsq"] under
    batch["pixel_mask"] (all pixels real when absent), then the static
    postprocess (reference evaluate.py:309-368), both under
    torch.inference_mode on the model's device; one copy to the host at the
    end.  `detr_model` is a models.detr.DETR built with `detection`.

    With a mesh each rank runs the detector and the post-process on its
    rows of the batch (parallel.mesh.shard_batch, which raises where the
    data axis does not divide them; a batch sharded ahead by
    shard_eval_batch gives its "shard" rows) and gathers every field in
    rank order, in its dtype: every rank returns the global detections,
    as the JAX package's GSPMD-sharded detector does.

    Raises ValueError (check_detector_classes) for a detector whose
    classes OBJ_ALP2FRE does not remap, such as OIv6's."""
    check_detector_classes(cfg)
    dev = next(detr_model.parameters()).device
    alp2fre = torch.as_tensor(OBJ_ALP2FRE, device=dev)
    m = cfg.model

    def detect_fn(batch: Dict) -> Dict[str, np.ndarray]:
        if mesh is not None:
            batch = batch["shard"] if "shard" in batch else shard_batch(
                mesh, {k: batch[k] for k in DETECT_KEYS
                       if batch.get(k) is not None})
        with torch.inference_mode():
            images = torch.as_tensor(batch["image_nonsq"], device=dev)
            mask = batch.get("pixel_mask")
            mask = torch.ones(images.shape[:3], dtype=torch.bool,
                              device=dev) if mask is None \
                else torch.as_tensor(mask, device=dev)
            out = detr_model(images, mask)
            det = postprocess_detections(
                out["pred_logits"], out["pred_boxes"], alp2fre,
                num_classes=m.num_classes, topk_cat=m.topk_cat,
                feature_size=m.feature_size, nms_iou=m.nms_iou,
                max_objects=cfg.data.max_objects)
            if mesh is not None:
                det = all_gather_rows(mesh, det)
        return to_numpy(det)

    return detect_fn
