"""Seeded random weights, drawn on the card.

One torch.Generator on the device, seeded from the run's seed and a salt,
draws one uniform buffer for all of a model's values; each leaf takes its
slice and maps it to its law by name:

  running_var            U(0.8, 1.25)
  running_mean           N(0, 0.05)
  a batch-norm weight    U(0.5, 1.0)
  a LayerNorm weight     N(1, 0.05)
  any other 1-D leaf     N(0, 0.02)     (biases)
  emb_* / query_embed    N(0, 1 / width)
  every other leaf       lecun normal truncated at 2 std

The same seed and salt give the same values on the same device, so the
reference draws the weights again after the window instead of keeping a
copy.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

# the two models' salts, so one seed gives them unrelated streams
HEAD_SALT = 1
DETR_SALT = 2

_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))    # Phi(-2)


def _normal_(u: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    return u.clamp_(1e-7, 1 - 1e-7).mul_(2).sub_(1).erfinv_() \
        .mul_(std * math.sqrt(2.0)).add_(mean)


def _init_(name: str, u: torch.Tensor) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 2)[-2] if name.count(".") else ""
    if leaf == "running_var":
        return u.mul_(0.45).add_(0.8)
    if leaf == "running_mean":
        return _normal_(u, 0.0, 0.05)
    if u.dim() == 1 and leaf == "weight" and "bn" in owner:
        return u.mul_(0.5).add_(0.5)
    if u.dim() == 1 and leaf == "weight" and "norm" in owner:
        return _normal_(u, 1.0, 0.05)
    if u.dim() == 1:
        return _normal_(u, 0.0, 0.02)
    if name.startswith(("emb_", "query_embed")):
        return _normal_(u, 0.0, 1.0 / math.sqrt(u.shape[1]))
    std = math.sqrt(1.0 / math.prod(u.shape[1:])) / .87962566103423978
    return u.mul_(2 * (1 - 2 * _LO)).add_(2 * _LO - 1).erfinv_() \
        .mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


def draw(shapes: Dict[str, tuple], seed: int, salt: int,
         device) -> Dict[str, torch.Tensor]:
    """float32 values of `shapes` (name -> shape) from (seed, salt) on
    `device`."""
    key = np.random.SeedSequence([seed, salt]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device).manual_seed(int(key[0]) >> 1)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.empty(total, device=device).uniform_(generator=gen)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = _init_(name, flat[off:off + n].view(shape))
        off += n
    return out
