"""Evaluation step over the packed pair grid (torch port of the eval half
of scene_graph_commonsense_tpu/train/engine.py; the train step is the next
slice of the port).

Batch dict (fixed shapes; B images, N = max_objects, S = feature_size):
  features: (B, S, S, C)   frozen detector features
  depth:    (B, S, S, 1)   estimated depth map
  cats:     (B, N) int32   object classes (padding slots hold 0)
  super_mh: (B, N, K) f32  super-class multi-hots (optional)
  boxes:    (B, N, 4) f32  (x_min, x_max, y_min, y_max) on the grid
  rel:      (B, N, N) int32 directed GT relations (-1 = none)
  valid:    (B, N) bool
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from scene_graph_commonsense_torch.device import disable_tf32, resolve_device
from scene_graph_commonsense_torch.models.relation_head import (
    RelationClassifier)
from scene_graph_commonsense_torch.ops import boxes as box_ops
from scene_graph_commonsense_torch.ops import pairs as pair_ops
from scene_graph_commonsense_torch.ops.pair_pool import pair_pool

# the batch entries the eval step reads
MODEL_KEYS = ("features", "depth", "cats", "super_mh", "boxes", "rel",
              "valid")


def forward_pairs(model: RelationClassifier, batch: Dict[str, torch.Tensor],
                  capacity: int
                  ) -> Tuple[Dict[str, torch.Tensor], pair_ops.PackedPairs]:
    """Full pair-grid forward for one batch: masks -> object streams ->
    all valid pairs packed at `capacity` -> fused pair assembly
    (ops/pair_pool.py: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors) -> trunk -> label-conditioned head."""
    b, n = batch["cats"].shape
    s = batch["features"].shape[1]
    masks = box_ops.boxes_to_masks(batch["boxes"], s,
                                   batch["features"].dtype)
    masks = masks * batch["valid"][:, :, None, None].to(masks.dtype)
    packed = pair_ops.pack_pairs(pair_ops.pair_validity(batch["valid"]),
                                 capacity)
    a, bb = model.object_streams_from_image(batch["features"],
                                            batch["depth"], masks)
    pooled = pair_pool(a, bb, packed.flat_sub, packed.flat_obj)
    h = model.pair_trunk_from_pooled(pooled)
    flat_cats = batch["cats"].reshape(b * n)
    c1 = flat_cats.index_select(0, packed.flat_sub)
    c2 = flat_cats.index_select(0, packed.flat_obj)
    s1 = s2 = None
    if batch.get("super_mh") is not None:
        flat_super = batch["super_mh"].reshape(b * n, -1)
        s1 = flat_super.index_select(0, packed.flat_sub)
        s2 = flat_super.index_select(0, packed.flat_obj)
    out = model.pair_head(h, c1, c2, s1, s2)
    out["sub_cat"] = c1
    out["obj_cat"] = c2
    return out, packed


def _grid_at(grid: torch.Tensor, packed: pair_ops.PackedPairs,
             n: int) -> torch.Tensor:
    """(B, N, N) grid -> (P,) values at each packed pair."""
    flat = grid.reshape(grid.shape[0], n * n)
    return flat[packed.img.long(), (packed.sub * n + packed.obj).long()]


def pair_targets(batch: Dict[str, torch.Tensor],
                 packed: pair_ops.PackedPairs) -> torch.Tensor:
    """(P,) GT relation per packed directed pair; -1 where unrelated."""
    rel = _grid_at(batch["rel"], packed, batch["cats"].shape[1])
    return torch.where(packed.mask, rel, torch.full_like(rel, -1))


def make_eval_step(model: RelationClassifier, cfg, capacity: int = 0,
                   device=None):
    """Deterministic forward returning everything the evaluator needs
    (relations, connectivity, packed indexing, overlap filter), under
    torch.inference_mode.  The model is moved to `device` (default cuda;
    raises where CUDA is absent unless device="cpu").  TF32 is turned off
    (device.disable_tf32) so float32 runs in full float32.  The step takes
    a batch dict of numpy arrays or tensors and returns tensors on the
    device."""
    dev = resolve_device(device)
    disable_tf32()
    model.to(dev).eval()
    cap = capacity or cfg.pair_capacity

    @torch.inference_mode()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        batch = {k: torch.as_tensor(batch[k], device=dev)
                 for k in MODEL_KEYS if batch.get(k) is not None}
        out, packed = forward_pairs(model, batch, cap)
        s = batch["features"].shape[1]
        n = batch["cats"].shape[1]
        iou_ok = _grid_at(pair_ops.eval_pair_filter(batch["boxes"], s),
                          packed, n) & packed.mask
        return {
            "relation": out["relation"],
            "super_relation": out["super_relation"],
            "connectivity": out["connectivity"],
            "targets": pair_targets(batch, packed),
            "pair_img": packed.img, "pair_sub": packed.sub,
            "pair_obj": packed.obj, "pair_mask": packed.mask,
            "iou_ok": iou_ok,
            # truncation telemetry; engines warn when count > capacity
            "pair_count": packed.count[None],
            "pair_capacity": torch.full((1,), cap, dtype=torch.int32,
                                        device=dev),
        }

    return step
