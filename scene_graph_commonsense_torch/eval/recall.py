"""Recall@k / mean-Recall@k / zero-shot-Recall@k evaluation (numpy).

A copy of scene_graph_commonsense_tpu/eval/recall.py, kept so that the port
imports nothing of the JAX package.

Replicates the matching semantics of the reference Evaluator
(reference evaluator.py:15-586) and Evaluator_Top3 (reference
evaluator.py:589-773) with vectorized, fixed-shape math:

  * a GT triplet matches a hypothesis iff subject & object labels match
    (exactly for PredCLS, by the equivalence groups for SGCLS/SGDET),
    both boxes have mask-IoU >= 0.5 with the GT boxes, and the predicate
    matches (reference evaluator.py:280-348);
  * each hierarchical pair contributes THREE ranked candidates — the argmax
    of each super-category branch, with confidence = that branch's max
    log-probability (reference evaluator.py:157-174);
  * candidate confidence adds log-sigmoid connectivity, subject+object class
    confidence when not PredCLS, and -inf for pairs failing the overlap
    filter or (eval_cs) the commonsense triplet filters (reference
    evaluator.py:160-194, 292);
  * hits at k are counted when the *first* fully-matching candidate index in
    the confidence-sorted order is < k; per-class tallies drive mR@k via a
    NaN-mean; zero-shot tallies are restricted to test-only triplets
    (reference evaluator.py:306-356).

The per-row Python dict probes of eval_cs become dense boolean triplet-id
tables; the per-pair 32x32 mask materialization becomes the closed-form
integer-rectangle IoU of ops.boxes.

Documented deviation: when a whole ragged pair-column of a batch fails the
overlap filter the reference silently drops those pairs' *targets* as well
(reference train_test.py:409-410) — a batch-composition-dependent artifact.
Here every connected GT pair always counts in the denominator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from scene_graph_commonsense_torch.constants import object_equivalence_matrix


def _np_int_rect(boxes, size):
    b = np.clip(boxes.astype(np.int64), 0, size)
    return b[..., 0], b[..., 1], b[..., 2], b[..., 3]


def np_mask_iou(boxes_a, boxes_b, size: int = 32):
    """Closed-form mask IoU, numpy (same semantics as ops.boxes.mask_iou)."""
    ax0, ax1, ay0, ay1 = _np_int_rect(boxes_a, size)
    bx0, bx1, by0, by1 = _np_int_rect(boxes_b, size)
    area_a = np.maximum(ax1 - ax0, 0) * np.maximum(ay1 - ay0, 0)
    area_b = np.maximum(bx1 - bx0, 0) * np.maximum(by1 - by0, 0)
    iw = np.maximum(np.minimum(ax1, bx1) - np.maximum(ax0, bx0), 0)
    ih = np.maximum(np.minimum(ay1, by1) - np.maximum(ay0, by0), 0)
    inter = iw * ih
    union = area_a + area_b - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def np_union_mask_iou(pa, pb, ta, tb, size: int = 32):
    """Union-mask IoU via inclusion-exclusion (see ops.boxes.union_mask_iou),
    numpy version for the host-side wmAP."""

    def rect(b):
        return np.stack(_np_int_rect(b, size), axis=-1)

    def inter_n(*rects):
        x0 = rects[0][..., 0]; x1 = rects[0][..., 1]
        y0 = rects[0][..., 2]; y1 = rects[0][..., 3]
        for r in rects[1:]:
            x0 = np.maximum(x0, r[..., 0]); x1 = np.minimum(x1, r[..., 1])
            y0 = np.maximum(y0, r[..., 2]); y1 = np.minimum(y1, r[..., 3])
        return np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)

    A, B, C, D = rect(pa), rect(pb), rect(ta), rect(tb)
    union_p = inter_n(A) + inter_n(B) - inter_n(A, B)
    union_t = inter_n(C) + inter_n(D) - inter_n(C, D)
    inter = (inter_n(A, C) + inter_n(A, D) + inter_n(B, C) + inter_n(B, D)
             - inter_n(A, B, C) - inter_n(A, B, D) - inter_n(A, C, D)
             - inter_n(B, C, D) + inter_n(A, B, C, D))
    union = union_p + union_t - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


@dataclasses.dataclass
class Candidates:
    """Flat ranked-candidate arrays for a batch (host-side numpy)."""
    img: np.ndarray        # (C,) image id
    conf: np.ndarray       # (C,) float confidence (may be -inf)
    rel: np.ndarray        # (C,) predicted relation id
    sub_cat: np.ndarray    # (C,)
    obj_cat: np.ndarray    # (C,)
    sub_box: np.ndarray    # (C, 4)
    obj_box: np.ndarray    # (C, 4)
    # Only needed by the Top-3 evaluator:
    relation_full: Optional[np.ndarray] = None   # (C, R) branch log-probs
    super_rel: Optional[np.ndarray] = None       # (C, 3)


@dataclasses.dataclass
class Targets:
    """Flat ground-truth directed triplets for a batch."""
    img: np.ndarray        # (T,)
    rel: np.ndarray        # (T,)
    sub_cat: np.ndarray
    obj_cat: np.ndarray
    sub_box: np.ndarray    # (T, 4)
    obj_box: np.ndarray    # (T, 4)


class Evaluator:
    """Streaming Recall@k evaluator (counts persist across batches, matching
    the reference's cumulative moving-average reporting, reference
    evaluator.py:286-300)."""

    def __init__(self, num_classes: int = 50, iou_thresh: float = 0.5,
                 top_k: Sequence[int] = (20, 50, 100),
                 feature_size: int = 32, predcls: bool = True,
                 zs_table: Optional[np.ndarray] = None,
                 equiv: Optional[np.ndarray] = None,
                 num_obj_classes: int = 150,
                 oiv6_weights: Optional[np.ndarray] = None):
        self.num_classes = num_classes
        self.iou_thresh = iou_thresh
        self.top_k = tuple(top_k)
        self.feature_size = feature_size
        self.predcls = predcls
        self.zs_table = zs_table            # dense (Cobj*R*Cobj,) bool or None
        self.num_obj_classes = num_obj_classes
        if not predcls and equiv is None:
            equiv = object_equivalence_matrix(num_obj_classes)
        self.equiv = equiv
        self.oiv6_weights = oiv6_weights
        self.reset()

    # ------------- state -------------

    def reset(self):
        k = self.top_k
        self.hits = {kk: 0.0 for kk in k}
        self.hits_per_class = {kk: np.zeros(self.num_classes) for kk in k}
        self.num_targets = 0.0
        self.targets_per_class = np.zeros(self.num_classes)
        self.hits_zs = {kk: 0.0 for kk in k}
        self.hits_per_class_zs = {kk: np.zeros(self.num_classes) for kk in k}
        self.num_targets_zs = 0.0
        self.targets_per_class_zs = np.zeros(self.num_classes)
        # OIv6 wmAP tallies
        self.ap_hits = np.zeros(self.num_classes)
        self.ap_hits_union = np.zeros(self.num_classes)
        self.ap_counts = np.zeros(self.num_classes)

    # ------------- accumulation -------------

    def accumulate(self, cand: Candidates, tgt: Targets):
        """Matches one batch's candidates against its targets and folds the
        tallies into the streaming counters."""
        for image in np.unique(tgt.img):
            c_sel = cand.img == image
            t_sel = tgt.img == image
            self._match_image(
                conf=cand.conf[c_sel], rel=cand.rel[c_sel],
                sub_cat=cand.sub_cat[c_sel], obj_cat=cand.obj_cat[c_sel],
                sub_box=cand.sub_box[c_sel], obj_box=cand.obj_box[c_sel],
                t_rel=tgt.rel[t_sel], t_sub_cat=tgt.sub_cat[t_sel],
                t_obj_cat=tgt.obj_cat[t_sel], t_sub_box=tgt.sub_box[t_sel],
                t_obj_box=tgt.obj_box[t_sel])

    def _label_match(self, t_cat, c_cat):
        if self.predcls:
            return t_cat[:, None] == c_cat[None, :]
        return self.equiv[c_cat[None, :], t_cat[:, None]]

    def _match_image(self, conf, rel, sub_cat, obj_cat, sub_box, obj_box,
                     t_rel, t_sub_cat, t_obj_cat, t_sub_box, t_obj_box):
        keep_t = t_rel >= 0
        if not keep_t.any():
            return
        t_rel = t_rel[keep_t]
        t_sub_cat, t_obj_cat = t_sub_cat[keep_t], t_obj_cat[keep_t]
        t_sub_box, t_obj_box = t_sub_box[keep_t], t_obj_box[keep_t]

        this_k = min(self.top_k[-1], len(conf))
        order = np.argsort(-conf, kind="stable")[:this_k]

        lab = self._label_match(t_sub_cat, sub_cat[order]) \
            & self._label_match(t_obj_cat, obj_cat[order])
        iou_s = np_mask_iou(t_sub_box[:, None], sub_box[order][None],
                            self.feature_size) >= self.iou_thresh
        iou_o = np_mask_iou(t_obj_box[:, None], obj_box[order][None],
                            self.feature_size) >= self.iou_thresh
        rel_m = t_rel[:, None] == rel[order][None]
        full = lab & iou_s & iou_o & rel_m
        has = full.any(axis=1)
        if full.shape[1]:
            jstar = np.where(has, full.argmax(axis=1),
                             np.iinfo(np.int64).max)
        else:
            # zero candidates for this image (e.g. every detection pair
            # failed the overlap filter): no hits, targets still counted —
            # same as the reference's empty per-image candidate list
            jstar = np.full(len(t_rel), np.iinfo(np.int64).max)

        if self.zs_table is not None:
            tid = (t_sub_cat.astype(np.int64) * self.num_classes + t_rel) \
                * self.num_obj_classes + t_obj_cat
            is_zs = self.zs_table[tid]
        else:
            is_zs = np.zeros(len(t_rel), bool)

        for k in self.top_k:
            hit = jstar < k
            self.hits[k] += float(hit.sum())
            np.add.at(self.hits_per_class[k], t_rel[hit], 1.0)
            zs_hit = hit & is_zs
            self.hits_zs[k] += float(zs_hit.sum())
            np.add.at(self.hits_per_class_zs[k], t_rel[zs_hit], 1.0)
        self.num_targets += float(len(t_rel))
        np.add.at(self.targets_per_class, t_rel, 1.0)
        self.num_targets_zs += float(is_zs.sum())
        np.add.at(self.targets_per_class_zs, t_rel[is_zs], 1.0)

    # ------------- OIv6 weighted mAP -------------

    def accumulate_precision(self, cand: Candidates, tgt: Targets,
                             top_k: int = 20):
        """Precision-side tallies for the OIv6 weighted mAP (reference
        evaluator.py:522-557): for each of the top-20 candidates per image,
        a relation hit needs exact labels + both IoUs (wmap_rel) or the
        union-mask IoU (wmap_phrase)."""
        for image in np.unique(cand.img):
            c_sel = cand.img == image
            t_sel = (tgt.img == image) & (tgt.rel >= 0)
            conf = cand.conf[c_sel]
            order = np.argsort(-conf, kind="stable")[:min(top_k, len(conf))]
            rel = cand.rel[c_sel][order]
            sub_cat = cand.sub_cat[c_sel][order]
            obj_cat = cand.obj_cat[c_sel][order]
            sub_box = cand.sub_box[c_sel][order]
            obj_box = cand.obj_box[c_sel][order]
            np.add.at(self.ap_counts, rel, 1.0)
            if not t_sel.any():
                continue
            t_rel = tgt.rel[t_sel]
            lab = (sub_cat[:, None] == tgt.sub_cat[t_sel][None]) \
                & (obj_cat[:, None] == tgt.obj_cat[t_sel][None])
            rel_m = rel[:, None] == t_rel[None]
            iou_s = np_mask_iou(sub_box[:, None], tgt.sub_box[t_sel][None],
                                self.feature_size) >= self.iou_thresh
            iou_o = np_mask_iou(obj_box[:, None], tgt.obj_box[t_sel][None],
                                self.feature_size) >= self.iou_thresh
            iou_u = np_union_mask_iou(
                sub_box[:, None], obj_box[:, None],
                tgt.sub_box[t_sel][None], tgt.obj_box[t_sel][None],
                self.feature_size) >= self.iou_thresh
            hit = (lab & rel_m & iou_s & iou_o).any(axis=1)
            hit_union = (lab & rel_m & iou_u).any(axis=1)
            np.add.at(self.ap_hits, rel[hit], 1.0)
            np.add.at(self.ap_hits_union, rel[hit_union], 1.0)

    def compute_precision(self) -> Tuple[float, float]:
        """Weighted mean precision (wmap_rel, wmap_phrase), reference
        evaluator.py:559-566."""
        w = self.oiv6_weights.astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            prec = self.ap_hits / self.ap_counts
            prec_u = self.ap_hits_union / self.ap_counts
        not_nan = ~np.isnan(prec)
        denom = w[not_nan].sum()
        wmap_rel = np.nansum(prec * w) / denom if denom > 0 else 0.0
        wmap_phrase = np.nansum(prec_u * w) / denom if denom > 0 else 0.0
        return float(wmap_rel), float(wmap_phrase)

    # ------------- results -------------

    def compute(self) -> Dict[str, object]:
        def _safe(n, d):
            return n / max(d, 1e-3)

        import warnings
        with np.errstate(invalid="ignore", divide="ignore"), \
                warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Mean of empty slice")
            recall = [_safe(self.hits[k], self.num_targets)
                      for k in self.top_k]
            per_class = [self.hits_per_class[k] / self.targets_per_class
                         for k in self.top_k]
            mean_recall = [float(np.nanmean(pc)) for pc in per_class]
            recall_zs = [_safe(self.hits_zs[k], self.num_targets_zs)
                         for k in self.top_k]
            per_class_zs = [self.hits_per_class_zs[k]
                            / self.targets_per_class_zs for k in self.top_k]
            mean_recall_zs = [float(np.nanmean(pc)) for pc in per_class_zs]
        return {"recall": recall, "recall_per_class": per_class,
                "mean_recall": mean_recall, "recall_zs": recall_zs,
                "mean_recall_zs": mean_recall_zs,
                "num_targets": self.num_targets}


class EvaluatorTop3:
    """Recall@k* evaluator: a hit when *any* of the three per-branch argmax
    predicates matches (reference evaluator.py:589-773), plus the top-1-by-
    predicted-super-category variant.  Replicates the reference's
    `j >= max(k, num_target)` counting quirk exactly (reference
    evaluator.py:739, 755)."""

    def __init__(self, num_classes: int = 50, iou_thresh: float = 0.5,
                 top_k: Sequence[int] = (20, 50, 100),
                 feature_size: int = 32, num_geometric: int = 15,
                 num_possessive: int = 11):
        self.num_classes = num_classes
        self.iou_thresh = iou_thresh
        self.top_k = tuple(top_k)
        self.feature_size = feature_size
        self.ng = num_geometric
        self.np_ = num_possessive
        self.reset()

    def reset(self):
        k = self.top_k
        self.hits = {kk: 0.0 for kk in k}
        self.hits_top1 = {kk: 0.0 for kk in k}
        self.hits_per_class = {kk: np.zeros(self.num_classes) for kk in k}
        self.hits_per_class_top1 = {kk: np.zeros(self.num_classes)
                                    for kk in k}
        self.num_targets = 0.0
        self.targets_per_class = np.zeros(self.num_classes)

    def accumulate(self, cand: Candidates, tgt: Targets):
        assert cand.relation_full is not None and cand.super_rel is not None
        for image in np.unique(tgt.img):
            c_sel = cand.img == image
            t_sel = tgt.img == image
            self._match_image(cand, tgt, c_sel, t_sel)

    def _branch_argmaxes(self, relation_full):
        ng, npos = self.ng, self.np_
        p1 = relation_full[:, :ng].argmax(axis=1)
        p2 = relation_full[:, ng:ng + npos].argmax(axis=1) + ng
        p3 = relation_full[:, ng + npos:].argmax(axis=1) + ng + npos
        return np.stack([p1, p2, p3], axis=1)     # (C, 3)

    def _match_image(self, cand: Candidates, tgt: Targets, c_sel, t_sel):
        t_rel = tgt.rel[t_sel]
        keep_t = t_rel >= 0
        if not keep_t.any():
            return
        t_rel = t_rel[keep_t]
        t_sub_cat = tgt.sub_cat[t_sel][keep_t]
        t_obj_cat = tgt.obj_cat[t_sel][keep_t]
        t_sub_box = tgt.sub_box[t_sel][keep_t]
        t_obj_box = tgt.obj_box[t_sel][keep_t]
        num_target = len(t_rel)

        conf = cand.conf[c_sel]
        this_k = min(self.top_k[-1], len(conf))
        order = np.argsort(-conf, kind="stable")[:this_k]
        preds3 = self._branch_argmaxes(cand.relation_full[c_sel][order])
        sup_arg = cand.super_rel[c_sel][order].argmax(axis=1)
        pred_top1 = preds3[np.arange(len(order)), sup_arg]

        lab = (t_sub_cat[:, None] == cand.sub_cat[c_sel][order][None]) \
            & (t_obj_cat[:, None] == cand.obj_cat[c_sel][order][None])
        iou_s = np_mask_iou(t_sub_box[:, None],
                            cand.sub_box[c_sel][order][None],
                            self.feature_size) >= self.iou_thresh
        iou_o = np_mask_iou(t_obj_box[:, None],
                            cand.obj_box[c_sel][order][None],
                            self.feature_size) >= self.iou_thresh
        base = lab & iou_s & iou_o
        any3 = (t_rel[:, None, None] == preds3[None]).any(axis=2)
        full = base & any3
        full_top1 = base & (t_rel[:, None] == pred_top1[None])

        big = np.iinfo(np.int64).max
        jstar = np.where(full.any(1), full.argmax(1), big)
        jstar1 = np.where(full_top1.any(1), full_top1.argmax(1), big)
        for k in self.top_k:
            kk = max(k, num_target)      # reference quirk evaluator.py:739
            hit = jstar < kk
            self.hits[k] += float(hit.sum())
            np.add.at(self.hits_per_class[k], t_rel[hit], 1.0)
            hit1 = jstar1 < kk
            self.hits_top1[k] += float(hit1.sum())
            np.add.at(self.hits_per_class_top1[k], t_rel[hit1], 1.0)
        self.num_targets += float(num_target)
        np.add.at(self.targets_per_class, t_rel, 1.0)

    def compute(self) -> Dict[str, object]:
        with np.errstate(invalid="ignore", divide="ignore"):
            recall = [self.hits[k] / max(self.num_targets, 1e-3)
                      for k in self.top_k]
            per_class = [self.hits_per_class[k] / self.targets_per_class
                         for k in self.top_k]
            mean_recall = [float(np.nanmean(pc)) for pc in per_class]
            recall_top1 = [self.hits_top1[k] / max(self.num_targets, 1e-3)
                           for k in self.top_k]
        return {"recall": recall, "mean_recall": mean_recall,
                "recall_top1": recall_top1}
