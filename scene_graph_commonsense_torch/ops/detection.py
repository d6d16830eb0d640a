"""Static-shape detection post-processing for SGDET/SGCLS (torch port of
scene_graph_commonsense_tpu/ops/detection.py).

Replicates reference evaluate.py:311-368 without any data-dependent shapes,
on the logits' device:

  1. softmax over 151 logits; a query is an object iff its argmax is a real
     class (not the no-object slot);
  2. top-2 classes per query expand into 2 candidate slots each
     (`topk_cat`, reference evaluate.py:313-315);
  3. DETR's alphabetical class ids remap to the pipeline's frequency order
     (reference dataset_utils.py:606-614); slots remapped to the no-object
     id are dropped (reference evaluate.py:322-323);
  4. cxcywh -> xyxy, clamp to [0, 1], scale to the feature grid
     (reference evaluate.py:326-332);
  5. greedy per-class NMS (ops.nms) at iou 0.5 (reference
     evaluate.py:348-365);
  6. survivors compact into a fixed (B, max_objects) slot array, highest
     class confidence first (the reference keeps every survivor; capping at
     max_objects matches the dataset's own object cap, reference
     dataloader.py:119).

Every ranking is a stable descending sort, so ties go to the lower index as
in the JAX package (jax.lax.top_k and jnp.argsort(stable=True)); torch.topk
promises no tie order on the card.
"""

from __future__ import annotations

from typing import Dict

import torch

from scene_graph_commonsense_torch.ops.nms import class_aware_nms


def postprocess_detections(pred_logits: torch.Tensor,
                           pred_boxes: torch.Tensor,
                           alp2fre,
                           num_classes: int = 150,
                           topk_cat: int = 2,
                           feature_size: int = 32,
                           nms_iou: float = 0.5,
                           max_objects: int = 20
                           ) -> Dict[str, torch.Tensor]:
    """pred_logits: (B, Q, C+1); pred_boxes: (B, Q, 4) normalized cxcywh;
    alp2fre: the (C+1,) class remap (numpy or torch, any device).

    Returns fixed-shape per-image object slots on the logits' device:
      cats (B, N) int32, cat_conf (B, N), boxes (B, N, 4) canonical
      (x_min, x_max, y_min, y_max) on the feature grid, valid (B, N) bool.
    """
    b, q, _ = pred_logits.shape
    dev = pred_logits.device
    probs = torch.softmax(pred_logits, dim=-1)
    ranked, ranked_idx = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    has_object = ranked_idx[..., 0] < num_classes              # the argmax
    top_vals, top_idx = ranked[..., :topk_cat], ranked_idx[..., :topk_cat]

    cats = torch.as_tensor(alp2fre, device=dev)[top_idx]       # (B, Q, K)
    conf = top_vals
    valid = has_object[:, :, None] & (cats != num_classes)

    # cxcywh -> xyxy, clamp, scale (reference evaluate.py:326-332)
    cx, cy, w, h = pred_boxes.unbind(-1)
    x1 = torch.clamp(cx - w / 2, 0, 1) * feature_size
    y1 = torch.clamp(cy - h / 2, 0, 1) * feature_size
    x2 = torch.clamp(cx + w / 2, 0, 1) * feature_size
    y2 = torch.clamp(cy + h / 2, 0, 1) * feature_size
    boxes_xyxy = torch.stack([x1, y1, x2, y2], dim=-1)         # (B, Q, 4)
    boxes_xyxy = boxes_xyxy[:, :, None, :].expand(b, q, topk_cat, 4)

    m = q * topk_cat
    cats = cats.reshape(b, m)
    conf = conf.reshape(b, m)
    valid = valid.reshape(b, m)
    boxes_xyxy = boxes_xyxy.reshape(b, m, 4)

    keep = class_aware_nms(boxes_xyxy, conf, cats, valid, nms_iou)

    # compact survivors into max_objects slots, highest confidence first
    neg_inf = torch.finfo(conf.dtype).min
    score = torch.where(keep, conf, torch.full_like(conf, neg_inf))
    order = torch.sort(score, dim=1, descending=True, stable=True).indices
    slots = order[:, :max_objects]
    out_valid = keep.gather(1, slots)
    out_cats = cats.gather(1, slots).masked_fill(~out_valid, 0)
    out_conf = conf.gather(1, slots).masked_fill(~out_valid, 0.0)
    bx = boxes_xyxy.gather(1, slots[..., None].expand(-1, -1, 4))
    # canonical box format (x_min, x_max, y_min, y_max)
    out_boxes = torch.stack([bx[..., 0], bx[..., 2], bx[..., 1], bx[..., 3]],
                            dim=-1)
    out_boxes = out_boxes.masked_fill(~out_valid[..., None], 0.0)
    return {"cats": out_cats.to(torch.int32), "cat_conf": out_conf,
            "boxes": out_boxes, "valid": out_valid}
