"""Box geometry on the feature grid (torch port of
scene_graph_commonsense_tpu/ops/boxes.py).

Boxes are ``(x_min, x_max, y_min, y_max)`` in feature-grid coordinates; an
object's occupancy mask is ``mask[y_min:y_max, x_min:x_max] = 1`` with
integer-truncated coordinates (reference train_test.py:164-169).  IoU and
intersection are computed in closed form on the integer rectangles.
"""

from __future__ import annotations

import torch


def _int_rect(boxes: torch.Tensor, size: int):
    """Integer-truncated, grid-clipped (x0, x1, y0, y1) rectangle, replicating
    the reference's `mask[int(b2):int(b3), int(b0):int(b1)] = 1` on an SxS
    grid (coordinates are non-negative by construction)."""
    r = torch.clamp(boxes.to(torch.int32), 0, size)
    return r[..., 0], r[..., 1], r[..., 2], r[..., 3]


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
