"""Box geometry on the feature grid (torch port of
scene_graph_commonsense_tpu/ops/boxes.py).

Boxes are ``(x_min, x_max, y_min, y_max)`` in feature-grid coordinates; an
object's occupancy mask is ``mask[y_min:y_max, x_min:x_max] = 1`` with
integer-truncated coordinates (reference train_test.py:164-169).  IoU and
intersection are computed in closed form on the integer rectangles.
"""

from __future__ import annotations

import numpy as np
import torch


def resize_box(box, original_size, new_size):
    """Rescales one (x_min, y_min, x_max, y_max) box between image sizes
    ((height, width) each) and truncates to int (reference utils.py:38-55).
    Plain Python on the host: the loaders call it per annotation."""
    ratio_h = new_size[0] / original_size[0]
    ratio_w = new_size[1] / original_size[1]
    xmin, ymin, xmax, ymax = box
    return [int(xmin * ratio_w), int(ymin * ratio_h),
            int(xmax * ratio_w), int(ymax * ratio_h)]


def _int_rect(boxes: torch.Tensor, size: int):
    """Integer-truncated, grid-clipped (x0, x1, y0, y1) rectangle, replicating
    the reference's `mask[int(b2):int(b3), int(b0):int(b1)] = 1` on an SxS
    grid (coordinates are non-negative by construction)."""
    r = torch.clamp(boxes.to(torch.int32), 0, size)
    return r[..., 0], r[..., 1], r[..., 2], r[..., 3]


def box_area(boxes: torch.Tensor, size: int = 32) -> torch.Tensor:
    """Number of grid cells the box mask covers."""
    x0, x1, y0, y1 = _int_rect(boxes, size)
    return (x1 - x0).clamp_min(0) * (y1 - y0).clamp_min(0)


def mask_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
             size: int = 32) -> torch.Tensor:
    """Mask-IoU between broadcastable batches of boxes: |A & B| / |A | B|,
    and 0 when the union is empty."""
    ax0, ax1, ay0, ay1 = _int_rect(boxes_a, size)
    bx0, bx1, by0, by1 = _int_rect(boxes_b, size)
    area_a = (ax1 - ax0).clamp_min(0) * (ay1 - ay0).clamp_min(0)
    area_b = (bx1 - bx0).clamp_min(0) * (by1 - by0).clamp_min(0)
    inter = mask_intersection(boxes_a, boxes_b, size)
    union = area_a + area_b - inter
    iou = inter / union.clamp_min(1)
    return torch.where(union > 0, iou, torch.zeros_like(iou))


def mask_intersection(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                      size: int = 32) -> torch.Tensor:
    """Grid-cell count of the mask intersection (the eval-time pair filter
    `sum(A & B) > 0`, reference train_test.py:404-408)."""
    ax0, ax1, ay0, ay1 = _int_rect(boxes_a, size)
    bx0, bx1, by0, by1 = _int_rect(boxes_b, size)
    iw = (torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0)).clamp_min(0)
    ih = (torch.minimum(ay1, by1) - torch.maximum(ay0, by0)).clamp_min(0)
    return iw * ih


def union_mask_iou(pred_a: torch.Tensor, pred_b: torch.Tensor,
                   tgt_a: torch.Tensor, tgt_b: torch.Tensor,
                   size: int = 32) -> torch.Tensor:
    """IoU between the union masks of two box pairs (reference
    evaluator.py:97-115; the OIv6 phrase wmAP).  The union of two
    rectangles is not a rectangle, so the intersection of the unions comes
    from inclusion-exclusion over rectangle intersections on the integer
    grid:
      |(A|B) & (C|D)| = |AC| + |AD| + |BC| + |BD| - |ABC| - |ABD| - |ACD|
                        - |BCD| + |ABCD|."""

    def rect(b):
        return torch.stack(_int_rect(b, size), dim=-1)

    def inter_n(*rects):
        x0, x1 = rects[0][..., 0], rects[0][..., 1]
        y0, y1 = rects[0][..., 2], rects[0][..., 3]
        for r in rects[1:]:
            x0 = torch.maximum(x0, r[..., 0])
            x1 = torch.minimum(x1, r[..., 1])
            y0 = torch.maximum(y0, r[..., 2])
            y1 = torch.minimum(y1, r[..., 3])
        return (x1 - x0).clamp_min(0) * (y1 - y0).clamp_min(0)

    a, b, c, d = rect(pred_a), rect(pred_b), rect(tgt_a), rect(tgt_b)
    union_p = inter_n(a) + inter_n(b) - inter_n(a, b)
    union_t = inter_n(c) + inter_n(d) - inter_n(c, d)
    inter = (inter_n(a, c) + inter_n(a, d) + inter_n(b, c) + inter_n(b, d)
             - inter_n(a, b, c) - inter_n(a, b, d) - inter_n(a, c, d)
             - inter_n(b, c, d) + inter_n(a, b, c, d))
    union = union_p + union_t - inter
    iou = inter / union.clamp_min(1)
    return torch.where(union > 0, iou, torch.zeros_like(iou))


def union_box(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Smallest (x_min, x_max, y_min, y_max) box containing both inputs
    (reference utils.py:77-85)."""
    return torch.stack([torch.minimum(box_a[..., 0], box_b[..., 0]),
                        torch.maximum(box_a[..., 1], box_b[..., 1]),
                        torch.minimum(box_a[..., 2], box_b[..., 2]),
                        torch.maximum(box_a[..., 3], box_b[..., 3])], dim=-1)


def boxes_to_masks(boxes: torch.Tensor, size: int = 32,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., 4) boxes -> (..., S, S) occupancy masks by broadcast compare."""
    x0, x1, y0, y1 = _int_rect(boxes, size)
    grid = torch.arange(size, device=boxes.device)
    ys = grid.view(size, 1)
    xs = grid.view(1, size)
    inside_y = (ys >= y0[..., None, None]) & (ys < y1[..., None, None])
    inside_x = (xs >= x0[..., None, None]) & (xs < x1[..., None, None])
    return (inside_y & inside_x).to(dtype)


def reference_mask_iou_numpy(box_a, box_b, size: int = 32) -> float:
    """Literal mask-materializing IoU (numpy), kept as the test oracle for
    mask_iou's closed form."""
    ma = np.zeros((size, size), dtype=bool)
    mb = np.zeros((size, size), dtype=bool)
    ma[int(box_a[2]):int(box_a[3]), int(box_a[0]):int(box_a[1])] = True
    mb[int(box_b[2]):int(box_b[3]), int(box_b[0]):int(box_b[1])] = True
    union = np.logical_or(ma, mb).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(ma, mb).sum()) / float(union)
