"""Static-shape non-maximum suppression (torch port of
scene_graph_commonsense_tpu/ops/nms.py).

Replaces `torchvision.ops.nms` in the SGDET/SGCLS detection post-process
(reference evaluate.py:348-365).  The reference suppresses per class by
looping `torch.unique(categories)` in Python; here one fixed-shape greedy
pass handles all classes at once (cross-class pairs are never suppressed)
and every image of the batch at once, on the tensors' device: M steps over
(B, M) masks, with no data-dependent shape and no host round trip.
"""

from __future__ import annotations

import torch


def box_iou_xyxy(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                 ) -> torch.Tensor:
    """Standard continuous IoU for (x1, y1, x2, y2) boxes (the convention
    torchvision.ops.nms consumes), broadcast over leading dims."""
    ax1, ay1, ax2, ay2 = boxes_a.unbind(-1)
    bx1, by1, bx2, by2 = boxes_b.unbind(-1)
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp_min(0.0) * (ay2 - ay1).clamp_min(0.0)
    area_b = (bx2 - bx1).clamp_min(0.0) * (by2 - by1).clamp_min(0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12),
                       torch.zeros_like(union))


def class_aware_nms(boxes: torch.Tensor, scores: torch.Tensor,
                    classes: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """Greedy per-class NMS with a static box count, batched.

    Args:
      boxes:   (B, M, 4) float (x1, y1, x2, y2).
      scores:  (B, M) float.
      classes: (B, M) int — suppression only happens within a class.
      valid:   (B, M) bool — padding slots are never kept nor suppress
        others.
      iou_threshold: suppress when IoU > threshold (strict, matching
        torchvision's `iou <= threshold` keep rule).

    Returns:
      (B, M) bool keep mask in the original ordering.  Boxes are visited in
      descending score order, ties in index order (a stable sort, as
      jnp.argsort(descending=True, stable=True) orders them).
    """
    m = boxes.shape[-2]
    neg_inf = torch.finfo(scores.dtype).min
    order = torch.sort(torch.where(valid, scores,
                                   torch.full_like(scores, neg_inf)),
                       dim=-1, descending=True, stable=True).indices
    sboxes = boxes.gather(-2, order[..., None].expand_as(boxes))
    sclasses = classes.gather(-1, order)
    svalid = valid.gather(-1, order)

    iou = box_iou_xyxy(sboxes[..., :, None, :], sboxes[..., None, :, :])
    later = torch.ones((m, m), dtype=torch.bool,
                       device=boxes.device).triu_(diagonal=1)
    # row i suppresses column j: a valid box i, a later box j of its class
    # overlapping it by more than the threshold
    suppresses = (iou > iou_threshold) \
        & (sclasses[..., :, None] == sclasses[..., None, :]) \
        & later & svalid[..., :, None]
    alive = torch.ones_like(svalid)
    for i in range(m):
        alive &= ~(alive[..., i, None] & suppresses[..., i, :])
    keep_sorted = alive & svalid
    # scatter back to the original ordering
    return torch.zeros_like(valid).scatter_(-1, order, keep_sorted)
