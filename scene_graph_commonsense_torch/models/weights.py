"""Relation-head weights: the flax tree <-> the port's state dict, the
reference checkpoint -> the port, and a seeded initialisation.

Layouts: flax conv kernels are HWIO and torch's OIHW; flax dense kernels are
(in, out) and torch's (out, in); embedding tables are the same in both.  The
fc1 rows are in NHWC flatten order (y, x, c) in both packages.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from scene_graph_commonsense_torch.models.relation_head import (
    module_from_cfg)


def _np(v) -> np.ndarray:
    """A numpy copy: never a view of a live (trained in place) tensor."""
    return v.detach().cpu().numpy().copy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax param tree ({"params": {...}} or the inner dict) -> state dict."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for name, leaf in tree.items():
        if "embedding" in leaf:
            sd[f"{name}.weight"] = torch.from_numpy(
                np.array(leaf["embedding"]))
            continue
        k = np.asarray(leaf["kernel"])
        k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        sd[f"{name}.weight"] = torch.from_numpy(np.array(k))
        if "bias" in leaf:
            sd[f"{name}.bias"] = torch.from_numpy(np.array(leaf["bias"]))
    return sd


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """State dict -> flax param tree {"params": {...}} of numpy arrays."""
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for key, v in state_dict.items():
        name, kind = key.rsplit(".", 1)
        a = _np(v)
        leaf = tree.setdefault(name, {})
        if kind == "bias":
            leaf["bias"] = a
        elif name.startswith("emb_"):
            leaf["embedding"] = a
        else:
            leaf["kernel"] = np.ascontiguousarray(
                a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T)
    return {"params": tree}


def from_reference_state_dict(state: Mapping, hierarchical: bool = True,
                              use_super: bool = True,
                              num_classes: int = 150,
                              num_super_classes: int = 17,
                              hidden_dim: int = 128,
                              feature_size: int = 32
                              ) -> Dict[str, torch.Tensor]:
    """Reference BayesianRelationClassifier / FlatRelationClassifier
    checkpoint (reference model.py:105-186) -> the port's state dict; the
    same mapping as scene_graph_commonsense_tpu's
    convert_relation_state_dict, in torch layout:

      * conv1_1 / conv1_2 -> conv1_sub / conv1_obj;
      * conv2_1 splits along its input channels into conv2_sub (subject
        half, no bias) and conv2_obj (object half, carries the bias);
      * fc1 columns permute from the NCHW flatten order (c, y, x) to the
        NHWC order (y, x, c);
      * fc2 columns split into fc2_h, the emb_c1 / emb_c2 tables (one-hot
        blocks) and fc2_s1 / fc2_s2 (super multi-hots);
      * fc3*, fc4, fc5 carry over.
    """
    st = {k.removeprefix("module."): torch.as_tensor(_np(v))
          for k, v in state.items()}
    h = hidden_dim
    sd: Dict[str, torch.Tensor] = {
        "conv1_sub.weight": st["conv1_1.weight"],
        "conv1_sub.bias": st["conv1_1.bias"],
        "conv1_obj.weight": st["conv1_2.weight"],
        "conv1_obj.bias": st["conv1_2.bias"],
        "conv2_sub.weight": st["conv2_1.weight"][:, :h].contiguous(),
        "conv2_obj.weight": st["conv2_1.weight"][:, h:].contiguous(),
        "conv2_obj.bias": st["conv2_1.bias"],
        "conv3.weight": st["conv3_1.weight"],
        "conv3.bias": st["conv3_1.bias"],
    }
    w1 = st["fc1.weight"]                         # (4096, 8h*(S/4)^2)
    c8, sp = 8 * h, feature_size // 4
    sd["fc1.weight"] = w1.reshape(-1, c8, sp, sp).permute(0, 2, 3, 1) \
        .reshape(w1.shape[0], -1).contiguous()
    sd["fc1.bias"] = st["fc1.bias"]

    # fc2 columns: [hidden(4096) | onehot c1 | onehot c2 | super1 | super2]
    w2 = st["fc2.weight"]
    off = 4096
    sd["fc2_h.weight"] = w2[:, :off].contiguous()
    sd["fc2_h.bias"] = st["fc2.bias"]
    sd["emb_c1.weight"] = w2[:, off:off + num_classes].T.contiguous()
    off += num_classes
    sd["emb_c2.weight"] = w2[:, off:off + num_classes].T.contiguous()
    off += num_classes
    if use_super:
        sd["fc2_s1.weight"] = w2[:, off:off + num_super_classes].contiguous()
        off += num_super_classes
        sd["fc2_s2.weight"] = w2[:, off:off + num_super_classes].contiguous()
        off += num_super_classes
    if off != w2.shape[1]:
        raise ValueError(f"fc2 has {w2.shape[1]} input columns, the config "
                         f"accounts for {off}")
    heads = ["fc4"] + (["fc3_1", "fc3_2", "fc3_3", "fc5"] if hierarchical
                       else ["fc3"])
    for name in heads:
        sd[f"{name}.weight"] = st[f"{name}.weight"]
        sd[f"{name}.bias"] = st[f"{name}.bias"]
    return sd


def _trunc_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """Normal(0, std) truncated to +-2 std, by inverse-CDF sampling."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 1.0 - lo
    t = torch.empty(shape).uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    return t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


def init_params(cfg, generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
    """Fresh float32 weights with flax's default distributions: lecun-normal
    kernels (truncated normal, variance 1/fan_in), zero biases, embeddings
    normal with variance 1/features.  Same distributions as the JAX
    package's model.init, not the same numbers.  `generator` defaults to
    one seeded with cfg.training.seed."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.training.seed)
    with torch.device("meta"):        # shapes only: allocates nothing
        shapes = {k: v.shape
                  for k, v in module_from_cfg(cfg).state_dict().items()}
    sd: Dict[str, torch.Tensor] = {}
    for key, shape in shapes.items():
        if key.endswith(".bias"):
            sd[key] = torch.zeros(shape)
        elif key.startswith("emb_"):
            sd[key] = torch.empty(shape).normal_(
                0.0, 1.0 / math.sqrt(shape[1]), generator=generator)
        else:
            fan_in = math.prod(shape[1:])
            # 0.8796... = std of the unit normal truncated to +-2
            sd[key] = _trunc_normal(
                shape, math.sqrt(1.0 / fan_in) / .87962566103423978,
                generator)
    return sd

