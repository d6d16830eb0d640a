"""Static-shape directed pair grid (torch port of
scene_graph_commonsense_tpu/ops/pairs.py).

Images are padded to N = max_objects with a validity mask; every valid
directed pair (i, j), i != j, of a batch is packed into one fixed-capacity
buffer so the pair trunk runs as one large batch.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from scene_graph_commonsense_torch.ops import boxes as box_ops


class PackedPairs(NamedTuple):
    """A fixed-capacity buffer of directed pairs compacted across the batch.

    img / sub / obj: (P,) int32 image, subject slot and object slot.
    flat_sub / flat_obj: (P,) int32 indices into the flattened (B*N,) axis.
    mask: (P,) bool, False on padding slots.
    count: () int32 number of valid pairs; may exceed P, in which case the
      excess pairs are dropped.
    flat_id: (P,) int32 position in the flattened (B, N, N) grid, -1 on
      padding; strictly increasing over live slots.
    """
    img: torch.Tensor
    sub: torch.Tensor
    obj: torch.Tensor
    flat_sub: torch.Tensor
    flat_obj: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor
    flat_id: torch.Tensor


def pair_validity(valid: torch.Tensor) -> torch.Tensor:
    """(B, N) object validity -> (B, N, N) directed-pair validity
    (both endpoints valid, no self-pairs)."""
    v = valid.to(torch.bool)
    n = v.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=v.device)
    return v[:, :, None] & v[:, None, :] & ~eye


def pack_pairs(pair_ok: torch.Tensor, capacity: int) -> PackedPairs:
    """Compacts True entries of a (B, N, N) pair-validity grid into a
    fixed-capacity index buffer.

    A stable argsort on the negated mask keeps valid pairs first, in their
    (image-major, subject-major) enumeration order; padding slots park on
    pair (0, 0, 1) of image 0 and are masked out.
    """
    _, n, _ = pair_ok.shape
    flat_ok = pair_ok.reshape(-1)
    order = torch.argsort((~flat_ok).to(torch.int8), stable=True)
    slots = order[:capacity]
    mask = flat_ok[slots]
    slots = slots.to(torch.int32)
    img = slots // (n * n)
    rem = slots % (n * n)
    zero = torch.zeros_like(slots)
    img = torch.where(mask, img, zero)
    sub = torch.where(mask, rem // n, zero)
    obj = torch.where(mask, rem % n, zero + 1)
    return PackedPairs(
        img=img, sub=sub, obj=obj,
        flat_sub=img * n + sub, flat_obj=img * n + obj,
        mask=mask, count=flat_ok.sum().to(torch.int32),
        flat_id=torch.where(mask, slots, zero - 1))


def align_packings(base: PackedPairs, subset: PackedPairs):
    """For each live slot of `subset`, its slot in `base` (both packings of
    one (B, N, N) grid keep the enumeration order, so live flat_ids ascend).
    Returns (int32 indices, found mask)."""
    p = base.flat_id.shape[0]
    big = 2 ** 30
    base_ids = torch.where(base.mask, base.flat_id, big)
    sub_ids = torch.where(subset.mask, subset.flat_id, big - 1)
    pos = torch.searchsorted(base_ids, sub_ids).clamp(0, p - 1)
    found = subset.mask & (base_ids[pos] == sub_ids)
    return pos.to(torch.int32), found


def gather_pair(values: torch.Tensor, pairs: PackedPairs,
                which: str) -> torch.Tensor:
    """Gathers per-object values (B, N, ...) for each packed pair endpoint
    ("sub" or "obj")."""
    b, n = values.shape[:2]
    flat = values.reshape((b * n,) + tuple(values.shape[2:]))
    idx = pairs.flat_sub if which == "sub" else pairs.flat_obj
    return flat[idx.long()]


def eval_pair_filter(boxes: torch.Tensor, size: int = 32) -> torch.Tensor:
    """(B, N, 4) boxes -> (B, N, N) bool: a pair is kept iff the two object
    masks overlap in at least one grid cell (reference
    train_test.py:404-408)."""
    inter = box_ops.mask_intersection(
        boxes[:, :, None, :], boxes[:, None, :, :], size)
    return inter > 0


# ---------------------------------------------------------------------------
# Data-side (numpy) target construction.
# ---------------------------------------------------------------------------

def directed_rel_from_lower(relationships: Sequence[np.ndarray],
                            subj_or_obj: Sequence[np.ndarray],
                            num_objects: int,
                            max_objects: int) -> np.ndarray:
    """Converts the reference's lower-triangular annotation into the directed
    (N, N) relation matrix.

    The annotation stores, for every object i >= 1, a length-i row where
    entry j holds the relation between objects i and j, with direction flag
    1 = "i is the subject", 0 = "j is the subject", -1 = unrelated
    (reference dataset_utils.py:156-184).  Output: rel[i, j] = relation id of
    the directed edge subject=i -> object=j, or -1.
    """
    rel = np.full((max_objects, max_objects), -1, dtype=np.int32)
    for i in range(1, num_objects):
        row_r = np.asarray(relationships[i - 1])
        row_d = np.asarray(subj_or_obj[i - 1])
        for j in range(i):
            if row_d[j] == 1:
                rel[i, j] = row_r[j]
            elif row_d[j] == 0:
                rel[j, i] = row_r[j]
    return rel


def lower_from_directed(rel: np.ndarray, num_objects: int):
    """Inverse of directed_rel_from_lower (for round-tripping with
    reference-format annotations)."""
    relationships, subj_or_obj = [], []
    for i in range(1, num_objects):
        row_r = np.full(i, -1, dtype=np.int64)
        row_d = np.full(i, -1.0, dtype=np.float32)
        for j in range(i):
            if rel[i, j] >= 0:
                row_r[j], row_d[j] = rel[i, j], 1.0
            elif rel[j, i] >= 0:
                row_r[j], row_d[j] = rel[j, i], 0.0
        relationships.append(row_r)
        subj_or_obj.append(row_d)
    return relationships, subj_or_obj
