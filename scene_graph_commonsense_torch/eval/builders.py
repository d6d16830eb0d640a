"""Builders turning packed-pair model outputs into evaluator inputs.

A copy of scene_graph_commonsense_tpu/eval/builders.py, kept so that the
port imports nothing of the JAX package.

The reference interleaves evaluation bookkeeping into its pair loop
(reference train_utils.py:105-110, evaluate.py:162-183); here one vectorized
pass converts a whole batch's packed-pair outputs into flat Candidates /
Targets arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from scene_graph_commonsense_torch.eval.recall import Candidates, Targets


def log_sigmoid(x: np.ndarray) -> np.ndarray:
    return -np.log1p(np.exp(-np.abs(x))) + np.minimum(x, 0)


def build_candidates(relation: np.ndarray, connectivity: np.ndarray,
                     super_rel: Optional[np.ndarray],
                     pair_img: np.ndarray, pair_sub: np.ndarray,
                     pair_obj: np.ndarray, pair_mask: np.ndarray,
                     iou_ok: np.ndarray,
                     cats: np.ndarray, boxes: np.ndarray,
                     hierarchical: bool, num_geometric: int,
                     num_possessive: int,
                     predcls: bool = True,
                     cat_conf: Optional[np.ndarray] = None,
                     cs_aligned: Optional[np.ndarray] = None,
                     cs_violated: Optional[np.ndarray] = None,
                     num_obj_classes: int = 150) -> Candidates:
    """Builds ranked candidates from one batch of packed-pair outputs.

    relation: (P, R) log-probs (hierarchical) or logits (flat).
    connectivity: (P,) raw connectivity logits.
    pair_*: packed pair indexing (image / subject-slot / object-slot / mask).
    iou_ok: (P,) overlap filter per pair (True in training, mask-overlap in
      eval; False forces -inf confidence, reference evaluator.py:167-168).
    cats/boxes: (B, N) / (B, N, 4) per-slot labels and boxes (predicted ones
      for SGDET/SGCLS, ground truth for PredCLS).
    cat_conf: (B, N) per-slot class confidence, added for non-PredCLS
      (reference evaluator.py:164-166).
    cs_aligned / cs_violated: dense triplet-id bool tables for eval_cs
      filtering (reference evaluator.py:189-194).
    """
    relation = np.asarray(relation)
    connectivity = np.asarray(connectivity)
    pair_img = np.asarray(pair_img)
    live = np.asarray(pair_mask)
    b, n = cats.shape[:2]
    flat_cats = np.asarray(cats).reshape(b * n)
    flat_boxes = np.asarray(boxes).reshape(b * n, 4)
    fs = np.asarray(pair_sub) + pair_img * n
    fo = np.asarray(pair_obj) + pair_img * n
    sub_cat, obj_cat = flat_cats[fs], flat_cats[fo]
    sub_box, obj_box = flat_boxes[fs], flat_boxes[fo]
    num_relations = relation.shape[1]

    conn_logp = log_sigmoid(connectivity)
    pair_extra = np.zeros_like(conn_logp)
    if not predcls:
        flat_conf = np.asarray(cat_conf).reshape(b * n)
        pair_extra = flat_conf[fs] + flat_conf[fo]

    if hierarchical:
        ng, npos = num_geometric, num_possessive
        blocks = [(relation[:, :ng], 0),
                  (relation[:, ng:ng + npos], ng),
                  (relation[:, ng + npos:], ng + npos)]
        confs, rels = [], []
        for block, off in blocks:
            confs.append(block.max(axis=1))
            rels.append(block.argmax(axis=1) + off)
        conf = np.concatenate(confs)
        rel_pred = np.concatenate(rels)
        rep = 3
    else:
        conf = relation.max(axis=1)
        rel_pred = relation.argmax(axis=1)
        rep = 1

    conf = conf + np.tile(pair_extra, rep)
    ok = np.tile(np.asarray(iou_ok) & live, rep)
    conf = np.where(ok, conf, -np.inf)
    sub_cat_r = np.tile(sub_cat, rep)
    obj_cat_r = np.tile(obj_cat, rep)
    if cs_aligned is not None or cs_violated is not None:
        tid = (sub_cat_r.astype(np.int64) * num_relations + rel_pred) \
            * num_obj_classes + obj_cat_r
        bad = np.zeros(len(tid), bool)
        if cs_aligned is not None:
            bad |= ~cs_aligned[tid]
        if cs_violated is not None:
            bad |= cs_violated[tid]
        conf = np.where(bad, -np.inf, conf)
    conf = conf + np.tile(conn_logp, rep)

    keep = np.tile(live, rep)
    sel = np.nonzero(keep)[0]
    return Candidates(
        img=np.tile(pair_img, rep)[sel],
        conf=conf[sel], rel=rel_pred[sel],
        sub_cat=sub_cat_r[sel], obj_cat=obj_cat_r[sel],
        sub_box=np.tile(sub_box, (rep, 1))[sel],
        obj_box=np.tile(obj_box, (rep, 1))[sel])


def build_candidates_top3(relation: np.ndarray, connectivity: np.ndarray,
                          super_rel: np.ndarray, pair_img: np.ndarray,
                          pair_sub: np.ndarray, pair_obj: np.ndarray,
                          pair_mask: np.ndarray, iou_ok: np.ndarray,
                          cats: np.ndarray, boxes: np.ndarray,
                          num_geometric: int,
                          num_possessive: int) -> Candidates:
    """One candidate per pair for the Top-3 evaluator: confidence is the max
    over the three branch maxima plus log-sigmoid connectivity (reference
    evaluator.py:646-649, 702)."""
    relation = np.asarray(relation)
    pair_img = np.asarray(pair_img)
    live = np.asarray(pair_mask)
    b, n = cats.shape[:2]
    flat_cats = np.asarray(cats).reshape(b * n)
    flat_boxes = np.asarray(boxes).reshape(b * n, 4)
    fs = np.asarray(pair_sub) + pair_img * n
    fo = np.asarray(pair_obj) + pair_img * n
    ng, npos = num_geometric, num_possessive
    conf = np.max(np.stack([relation[:, :ng].max(axis=1),
                            relation[:, ng:ng + npos].max(axis=1),
                            relation[:, ng + npos:].max(axis=1)]), axis=0)
    conf = np.where(np.asarray(iou_ok) & live, conf, -np.inf)
    conf = conf + log_sigmoid(np.asarray(connectivity))
    sel = np.nonzero(live)[0]
    return Candidates(
        img=pair_img[sel], conf=conf[sel],
        rel=np.zeros(len(sel), np.int64),   # unused by Top3
        sub_cat=flat_cats[fs][sel], obj_cat=flat_cats[fo][sel],
        sub_box=flat_boxes[fs][sel], obj_box=flat_boxes[fo][sel],
        relation_full=relation[sel], super_rel=np.asarray(super_rel)[sel])


def build_targets(rel: np.ndarray, cats: np.ndarray, boxes: np.ndarray,
                  valid: np.ndarray,
                  keep: Optional[np.ndarray] = None) -> Targets:
    """Flattens the (B, N, N) directed GT relation grid into Targets: one row
    per connected directed pair (subject-slot i -> object-slot j).

    `keep` is an optional (B, N, N) bool mask of directed pairs allowed into
    the target set — the faithful-parity hooks (eval_column_keep /
    sgd_target_keep) thread the reference's target-dropping quirks through
    it.  Default None keeps every connected GT pair."""
    rel = np.asarray(rel)
    cats = np.asarray(cats)
    boxes = np.asarray(boxes)
    valid = np.asarray(valid).astype(bool)
    b, n, _ = rel.shape
    ok = (rel >= 0) & valid[:, :, None] & valid[:, None, :]
    if keep is not None:
        ok &= np.asarray(keep).astype(bool)
    img, i, j = np.nonzero(ok)
    return Targets(img=img, rel=rel[img, i, j],
                   sub_cat=cats[img, i], obj_cat=cats[img, j],
                   sub_box=boxes[img, i], obj_box=boxes[img, j])


def _int_rects(boxes: np.ndarray, size: int):
    """Reference mask rasterization: mask[int(y0):int(y1), int(x0):int(x1)]
    (reference evaluate.py:111-116), i.e. coordinates truncate toward zero.
    boxes: (..., 4) canonical (x0, x1, y0, y1).  Returns truncated
    (x0, x1, y0, y1) clipped to the grid."""
    b = np.trunc(np.asarray(boxes, np.float64))
    return np.clip(b, 0, size)


def eval_column_keep(boxes: np.ndarray, valid: np.ndarray,
                     feature_size: int) -> np.ndarray:
    """Deviation 4 (reference evaluate.py:152-157, train_test.py:402-409):
    the reference's ragged eval loop walks unordered pair columns
    (graph_iter, edge_iter) across the images still alive at that column;
    when NO alive image's masks overlap, it `continue`s past both
    directions, so every GT pair in that column — including connected pairs
    of images that merely shared a batch with non-overlapping ones — never
    reaches the evaluator's target set.

    Returns a (B, N, N) bool mask of directed target pairs the reference
    would keep for this batch.  Batch-composition dependent by construction:
    the same image can lose targets in one batch and keep them in another.
    """
    boxes = np.asarray(boxes)
    valid = np.asarray(valid).astype(bool)
    r = _int_rects(boxes, feature_size)                      # (B, N, 4)
    x0, x1, y0, y1 = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    iw = (np.minimum(x1[:, :, None], x1[:, None, :])
          - np.maximum(x0[:, :, None], x0[:, None, :]))
    ih = (np.minimum(y1[:, :, None], y1[:, None, :])
          - np.maximum(y0[:, :, None], y0[:, None, :]))
    overlap = (iw > 0) & (ih > 0) \
        & valid[:, :, None] & valid[:, None, :]              # (B, N, N)
    # a column (i, j) is alive iff ANY image overlaps there; the loop's
    # keep_in_batch restriction is subsumed: images without slot i or j
    # have valid=False there and cannot overlap
    col_alive = overlap.any(axis=0)
    col_alive = col_alive | col_alive.T                      # unordered
    return np.broadcast_to(col_alive, overlap.shape)


def sgd_target_keep(valid: np.ndarray) -> np.ndarray:
    """SGDET target parity (reference utils.py:305-313): match_target_sgd
    iterates `for graph_iter in range(len(relationships[i]))` over the n-1
    relation rows but indexes row `graph_iter - 1`, so the LAST object's
    relation row is never visited — every GT pair involving an image's
    final (smallest-area) object is silently dropped from the SGDET target
    set.  Returns the (B, N, N) keep mask replicating that drop."""
    valid = np.asarray(valid).astype(bool)
    b, n = valid.shape
    n_live = valid.sum(axis=1)                                # (B,)
    idx = np.arange(n)
    pair_max = np.maximum(idx[:, None], idx[None, :])         # (N, N)
    return pair_max[None] < (n_live[:, None, None] - 1)
