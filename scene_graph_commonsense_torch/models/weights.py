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

# ---------------------------------------------------------------------------
# DETR (encode half): flax tree <-> port, torch-hub names -> port, seeded init
# ---------------------------------------------------------------------------

# top-level entries of the JAX DETR tree that the encode half uses; the
# decoder, query embedding and heads come with the detection slice
_DETR_ENCODE_PREFIXES = ("backbone", "input_proj", "encoder_")
# torch-hub DETR keys of the detection half, kept aside by
# detr_from_hub_state_dict
_HUB_DETECTION_PREFIXES = ("transformer.decoder.", "query_embed.",
                           "class_embed.", "bbox_embed.")


def _flat(tree: Mapping, prefix: str = ""):
    for name, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", v


def detr_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's DETR param tree ({"params": {...}} or the inner
    dict) of numpy arrays -> the state dict of models.detr.DETR: conv
    kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in), LayerNorm
    scale -> weight, frozen-BN statistics by name.  Keys outside the encode
    half (decoder, query embedding, heads) are left out."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for key, leaf in _flat({k: v for k, v in tree.items()
                            if k.startswith(_DETR_ENCODE_PREFIXES)}):
        path, name = key.rsplit(".", 1)
        a = np.array(leaf)
        if name == "kernel":
            name = "weight"
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        elif name == "scale":
            name = "weight"
        sd[f"{path}.{name}"] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def detr_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """State dict of models.detr.DETR -> the JAX package's param tree
    {"params": {...}} of numpy copies (never views of live tensors)."""
    tree: Dict = {}
    for key, v in state_dict.items():
        path, name = key.rsplit(".", 1)
        a = _np(v)
        if name == "weight" and a.ndim == 4:
            name, a = "kernel", np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        elif name == "weight" and a.ndim == 2:
            name, a = "kernel", np.ascontiguousarray(a.T)
        elif name == "weight" and path.rsplit(".", 1)[-1].startswith("norm"):
            name = "scale"
        node = tree
        for part in path.split("."):
            node = node.setdefault(part, {})
        node[name] = a
    return {"params": tree}


def _hub_key_map(num_encoder_layers: int, blocks) -> Dict[str, str]:
    """Port key -> torch-hub key for every tensor of the encode half (the
    in_proj rows are split by the caller)."""
    m: Dict[str, str] = {}

    def bn(port, hub):
        for stat in ("weight", "bias", "running_mean", "running_var"):
            m[f"{port}.{stat}"] = f"{hub}.{stat}"

    body = "backbone.0.body"
    m["backbone.conv1.weight"] = f"{body}.conv1.weight"
    bn("backbone.bn1", f"{body}.bn1")
    for stage, n in enumerate(blocks, start=1):
        for i in range(n):
            port, hub = f"backbone.layer{stage}_{i}", f"{body}.layer{stage}.{i}"
            for c in range(1, 4):
                m[f"{port}.conv{c}.weight"] = f"{hub}.conv{c}.weight"
                bn(f"{port}.bn{c}", f"{hub}.bn{c}")
            if i == 0:
                m[f"{port}.downsample_conv.weight"] = \
                    f"{hub}.downsample.0.weight"
                bn(f"{port}.downsample_bn", f"{hub}.downsample.1")
    m["input_proj.weight"] = "input_proj.weight"
    m["input_proj.bias"] = "input_proj.bias"
    for i in range(num_encoder_layers):
        port, hub = f"encoder_{i}", f"transformer.encoder.layers.{i}"
        for name in ("self_attn.out_proj", "linear1", "linear2", "norm1",
                     "norm2"):
            for kind in ("weight", "bias"):
                m[f"{port}.{name}.{kind}"] = f"{hub}.{name}.{kind}"
    return m


def detr_from_hub_state_dict(state: Mapping, num_encoder_layers: int = 6,
                             blocks=(3, 4, 23, 3)):
    """facebookresearch/detr `detr_resnet101` state dict (the names that
    scene_graph_commonsense_tpu's convert_detr_state_dict reads) -> (the
    port's encode-half state dict, the detection-half tensors by their hub
    names, kept for the detection slice).  The fused in_proj of each
    encoder self-attention splits into q/k/v rows.  Raises KeyError on a
    missing key and ValueError on a key that belongs to neither half
    (BatchNorm's num_batches_tracked counters are dropped)."""
    st = {k.removeprefix("module."): v for k, v in state.items()}
    used = set()

    def take(hub):
        if hub not in st:
            raise KeyError(f"DETR state dict lacks {hub!r}")
        used.add(hub)
        return torch.as_tensor(_np(st[hub]))

    sd = {port: take(hub) for port, hub in
          _hub_key_map(num_encoder_layers, blocks).items()}
    for i in range(num_encoder_layers):
        hub = f"transformer.encoder.layers.{i}.self_attn"
        w, b = take(f"{hub}.in_proj_weight"), take(f"{hub}.in_proj_bias")
        d = w.shape[1]
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            sd[f"encoder_{i}.self_attn.{name}.weight"] = \
                w[j * d:(j + 1) * d].contiguous()
            sd[f"encoder_{i}.self_attn.{name}.bias"] = \
                b[j * d:(j + 1) * d].contiguous()
    detection = {k: torch.as_tensor(_np(v)) for k, v in st.items()
                 if k.startswith(_HUB_DETECTION_PREFIXES)}
    stray = sorted(k for k in st if k not in used and k not in detection
                   and not k.endswith(".num_batches_tracked"))
    if stray:
        raise ValueError(f"DETR state dict keys of neither the encode nor "
                         f"the detection half: {stray[:8]}")
    return sd, detection


def init_detr_params(cfg, generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
    """Fresh float32 DETR encode-half weights with flax's default
    distributions: lecun-normal conv and dense kernels, zero biases,
    LayerNorm scale 1, frozen BN as the identity (weight 1, bias 0, mean 0,
    variance 1).  The distributions of the JAX package's detr.init, not its
    numbers.  `generator` defaults to one seeded with cfg.training.seed."""
    from scene_graph_commonsense_torch.models.detr import (
        module_from_cfg as detr_module)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.training.seed)
    with torch.device("meta"):        # shapes only: allocates nothing
        shapes = {k: v.shape
                  for k, v in detr_module(cfg).state_dict().items()}
    sd: Dict[str, torch.Tensor] = {}
    for key, shape in shapes.items():
        name = key.rsplit(".", 1)[1]
        if name in ("bias", "running_mean"):
            sd[key] = torch.zeros(shape)
        elif name == "running_var" or len(shape) == 1:
            sd[key] = torch.ones(shape)
        else:
            fan_in = math.prod(shape[1:])
            sd[key] = _trunc_normal(
                shape, math.sqrt(1.0 / fan_in) / .87962566103423978,
                generator)
    return sd
