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

from scene_graph_commonsense_torch.models import flax_msgpack
from scene_graph_commonsense_torch.models.relation_head import (
    module_from_cfg)
from scene_graph_commonsense_torch.parallel import tp as tp_lib


def _np(v) -> np.ndarray:
    """A numpy copy: never a view of a live (trained in place) tensor."""
    return v.detach().cpu().numpy().copy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def from_flax(params: Mapping, mesh=None) -> Dict[str, torch.Tensor]:
    """Flax param tree ({"params": {...}} or the inner dict) -> state dict;
    with a mesh of model axis > 1, this rank's TP shards of it
    (parallel/tp.shard_params), the state dict of a sharded module."""
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
    return sd if mesh is None else tp_lib.shard_params(sd, mesh)


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


def apply_key_remap(state: Mapping, before_path: str,
                    after_path: str) -> Dict:
    """Renames the keys listed in `before` to the parallel entry in `after`
    (reference utils.py:96-112: the detectron2 names of the reference's
    DETR-101 checkpoint -> torch-hub names); other keys stay."""
    with open(before_path) as f:
        before = [ln.rstrip("\n") for ln in f if ln.strip()]
    with open(after_path) as f:
        after = [ln.rstrip("\n") for ln in f if ln.strip()]
    remap = dict(zip(before, after))
    return {remap.get(k, k): v for k, v in state.items()}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a reference torch checkpoint (.pth) on the CPU:
    the file's dict, or its "model" entry.  Read with weights_only, so a
    file that pickles anything but tensors, containers and the training
    script's argparse.Namespace is refused, not run."""
    import argparse
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model", ckpt)
    return {k: torch.as_tensor(v) for k, v in state.items()}


def strip_ddp_prefix(state: Mapping) -> Dict:
    """Removes DDP's 'module.' prefixes (reference utils.py:207-214)."""
    return {k.removeprefix("module."): v for k, v in state.items()}


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
    st = {k: torch.as_tensor(_np(v))
          for k, v in strip_ddp_prefix(state).items()}
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
# DETR: flax tree <-> port, torch-hub names -> port, seeded init
# ---------------------------------------------------------------------------

# top-level entries of the DETR tree that the encode half (the featurizer)
# holds; the rest (decoder_<i>, decoder_norm, query_embed, class_embed,
# bbox_embed_<i>) is the detection half
_DETR_ENCODE_PREFIXES = ("backbone.", "input_proj.", "encoder_")
# torch-hub DETR keys of the detection half
_HUB_DETECTION_PREFIXES = ("transformer.decoder.", "query_embed.",
                           "class_embed.", "bbox_embed.")


def _flat(tree: Mapping, prefix: str = ""):
    for name, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", v


def detr_encode_half(state_dict: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """The entries of a DETR state dict (the port's names) that the encode
    half holds: what a featurizer built without `detection` loads."""
    return {k: v for k, v in state_dict.items()
            if k.startswith(_DETR_ENCODE_PREFIXES)}


def detr_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's DETR param tree ({"params": {...}} or the inner
    dict) of numpy arrays or torch tensors -> the state dict of
    models.detr.DETR, every key of the tree: conv kernels HWIO -> OIHW,
    dense kernels (in, out) -> (out, in), LayerNorm scale -> weight, the
    query embedding table as it is, frozen-BN statistics by name.  A tree
    of the encode half alone gives the encode half."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for key, leaf in _flat(tree):
        path, name = key.rsplit(".", 1)
        a = leaf.clone() if isinstance(leaf, torch.Tensor) \
            else torch.from_numpy(np.array(leaf))
        if name == "kernel":
            name = "weight"
            a = a.permute(3, 2, 0, 1) if a.dim() == 4 else a.T
        elif name in ("scale", "embedding"):
            name = "weight"
        sd[f"{path}.{name}"] = a.contiguous()
    return sd


def detr_from_flax_bytes(data: bytes) -> Dict[str, torch.Tensor]:
    """detr_from_flax of a file that flax.serialization.to_bytes wrote (the
    JAX package's converted DETR checkpoint), read without flax."""
    return detr_from_flax(flax_msgpack.unpack(data))


def detr_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """State dict of models.detr.DETR -> the JAX package's param tree
    {"params": {...}} of numpy copies (never views of live tensors)."""
    tree: Dict = {}
    for key, v in state_dict.items():
        path, name = key.rsplit(".", 1)
        a = _np(v)
        if path == "query_embed":
            name = "embedding"
        elif name == "weight" and a.ndim == 4:
            name, a = "kernel", np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        elif name == "weight" and a.ndim == 2:
            name, a = "kernel", np.ascontiguousarray(a.T)
        elif name == "weight" and "norm" in path.rsplit(".", 1)[-1]:
            name = "scale"          # norm1-3, decoder_norm (not the BNs)
        node = tree
        for part in path.split("."):
            node = node.setdefault(part, {})
        node[name] = a
    return {"params": tree}


def _hub_key_map(num_encoder_layers: int, blocks,
                 num_decoder_layers: Optional[int]) -> Dict[str, str]:
    """Port key -> torch-hub key for every tensor of the encode half and,
    unless num_decoder_layers is None, of the detection half (the in_proj
    rows of each attention are split by the caller)."""
    m: Dict[str, str] = {}

    def bn(port, hub):
        for stat in ("weight", "bias", "running_mean", "running_var"):
            m[f"{port}.{stat}"] = f"{hub}.{stat}"

    def same(port, hub, names):
        for name in names:
            for kind in ("weight", "bias"):
                m[f"{port}.{name}.{kind}"] = f"{hub}.{name}.{kind}"

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
        same(f"encoder_{i}", f"transformer.encoder.layers.{i}",
             ("self_attn.out_proj", "linear1", "linear2", "norm1", "norm2"))
    if num_decoder_layers is None:
        return m
    for i in range(num_decoder_layers):
        port, hub = f"decoder_{i}", f"transformer.decoder.layers.{i}"
        same(port, hub, ("self_attn.out_proj", "linear1", "linear2",
                         "norm1", "norm2", "norm3"))
        for kind in ("weight", "bias"):
            m[f"{port}.cross_attn.out_proj.{kind}"] = \
                f"{hub}.multihead_attn.out_proj.{kind}"
    for kind in ("weight", "bias"):
        m[f"decoder_norm.{kind}"] = f"transformer.decoder.norm.{kind}"
        m[f"class_embed.{kind}"] = f"class_embed.{kind}"
        for j in range(3):
            m[f"bbox_embed_{j}.{kind}"] = f"bbox_embed.layers.{j}.{kind}"
    m["query_embed.weight"] = "query_embed.weight"
    return m


def detr_from_hub_state_dict(state: Mapping, num_encoder_layers: int = 6,
                             blocks=(3, 4, 23, 3),
                             num_decoder_layers: Optional[int] = 6
                             ) -> Dict[str, torch.Tensor]:
    """facebookresearch/detr `detr_resnet101` state dict (the names that
    scene_graph_commonsense_tpu's convert_detr_state_dict reads) -> the
    port's state dict of the whole detector (models.detr.DETR with
    `detection`).  The fused in_proj of each attention splits into q/k/v
    rows (the decoder's multihead_attn becomes cross_attn), the box MLP's
    layers.<j> become bbox_embed_<j>.  With num_decoder_layers None only the
    encode half is converted and the detection half's keys are passed over
    unread (the featurizer's load, whatever the checkpoint's decoder
    depth).  Raises KeyError on a missing key and ValueError on a key that
    belongs to neither half (BatchNorm's num_batches_tracked counters are
    dropped)."""
    st = {k.removeprefix("module."): v for k, v in state.items()}
    used = set()

    def take(hub):
        if hub not in st:
            raise KeyError(f"DETR state dict lacks {hub!r}")
        used.add(hub)
        return torch.as_tensor(_np(st[hub]))

    sd = {port: take(hub) for port, hub in _hub_key_map(
        num_encoder_layers, blocks, num_decoder_layers).items()}
    attns = [(f"encoder_{i}.self_attn",
              f"transformer.encoder.layers.{i}.self_attn")
             for i in range(num_encoder_layers)]
    for i in range(num_decoder_layers or 0):
        hub = f"transformer.decoder.layers.{i}"
        attns += [(f"decoder_{i}.self_attn", f"{hub}.self_attn"),
                  (f"decoder_{i}.cross_attn", f"{hub}.multihead_attn")]
    for port, hub in attns:
        w, b = take(f"{hub}.in_proj_weight"), take(f"{hub}.in_proj_bias")
        d = w.shape[1]
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            sd[f"{port}.{name}.weight"] = w[j * d:(j + 1) * d].contiguous()
            sd[f"{port}.{name}.bias"] = b[j * d:(j + 1) * d].contiguous()
    unread = set() if num_decoder_layers is not None \
        else {k for k in st if k.startswith(_HUB_DETECTION_PREFIXES)}
    stray = sorted(k for k in st if k not in used and k not in unread
                   and not k.endswith(".num_batches_tracked"))
    if stray:
        raise ValueError(f"DETR state dict keys of neither the encode nor "
                         f"the detection half: {stray[:8]}")
    return sd


def init_detr_params(cfg, generator: Optional[torch.Generator] = None,
                     detection: bool = False) -> Dict[str, torch.Tensor]:
    """Fresh float32 DETR weights (the encode half, or with `detection` the
    whole detector) with flax's default distributions: lecun-normal conv
    and dense kernels, zero biases, LayerNorm scale 1, frozen BN as the
    identity (weight 1, bias 0, mean 0, variance 1), the query embedding
    normal with variance 1/features.  The distributions of the JAX
    package's detr.init, not its numbers.  The encode half draws first, so
    one seed gives the same encode half in both.  `generator` defaults to
    one seeded with cfg.training.seed."""
    from scene_graph_commonsense_torch.models.detr import (
        module_from_cfg as detr_module)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.training.seed)
    with torch.device("meta"):        # shapes only: allocates nothing
        shapes = {k: v.shape for k, v in detr_module(
            cfg, detection=detection).state_dict().items()}
    sd: Dict[str, torch.Tensor] = {}
    for key, shape in shapes.items():
        name = key.rsplit(".", 1)[1]
        if name in ("bias", "running_mean"):
            sd[key] = torch.zeros(shape)
        elif name == "running_var" or len(shape) == 1:
            sd[key] = torch.ones(shape)
        elif key == "query_embed.weight":
            sd[key] = torch.empty(shape).normal_(
                0.0, 1.0 / math.sqrt(shape[1]), generator=generator)
        else:
            fan_in = math.prod(shape[1:])
            sd[key] = _trunc_normal(
                shape, math.sqrt(1.0 / fan_in) / .87962566103423978,
                generator)
    return sd


# ---------------------------------------------------------------------------
# Plug-and-play predictors (models/predictors.py)
# ---------------------------------------------------------------------------

# flax OptimizedLSTMCell's gate kernels, in the order the port stacks them
_LSTM_GATES = ("i", "f", "g", "o")


def predictor_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's HierarchicalPredictor param tree ({"params": ...}
    or the inner dict, numpy arrays) -> the port's state dict:

      * dense kernels (in, out) -> Linear weights (out, in);
      * an LSTM cell's ii/if/ig/io kernels -> `cell.i.weight` and its
        hi/hf/hg/ho kernels and biases -> `cell.h.weight` / `cell.h.bias`,
        the four gates stacked in that order;
      * attention query/key/value kernels (D, heads, head_dim) and biases
        (heads, head_dim) -> Linear layers on the flattened heads; `out`
        (heads, head_dim, D) likewise;
      * LayerNorm scale -> weight; embedding tables as they are."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, a):
        sd[key] = torch.from_numpy(np.array(a))

    def walk(tree, prefix):
        if "embedding" in tree:
            put(prefix + "weight", tree["embedding"])
        elif "scale" in tree:
            put(prefix + "weight", tree["scale"])
            put(prefix + "bias", tree["bias"])
        elif "ii" in tree:
            put(prefix + "i.weight", np.concatenate(
                [np.asarray(tree["i" + g]["kernel"]) for g in _LSTM_GATES],
                axis=1).T)
            put(prefix + "h.weight", np.concatenate(
                [np.asarray(tree["h" + g]["kernel"]) for g in _LSTM_GATES],
                axis=1).T)
            put(prefix + "h.bias", np.concatenate(
                [np.asarray(tree["h" + g]["bias"]) for g in _LSTM_GATES]))
        elif "kernel" in tree:
            k = np.asarray(tree["kernel"])
            if k.ndim == 3:
                k = k.reshape(-1, k.shape[2]) if prefix.endswith("out.") \
                    else k.reshape(k.shape[0], -1)
            put(prefix + "weight", k.T)
            if "bias" in tree:
                put(prefix + "bias", np.asarray(tree["bias"]).reshape(-1))
        else:
            for name, sub in tree.items():
                walk(sub, f"{prefix}{name}.")

    walk(params.get("params", params), "")
    return sd


def predictor_to_flax(state_dict: Mapping[str, torch.Tensor],
                      num_heads: int = 4) -> Dict:
    """The inverse of predictor_from_flax: the port's state dict -> the
    JAX package's param tree {"params": {...}} of numpy arrays.
    `num_heads` is the Transformer context's (its attention kernels are
    (D, heads, head_dim) in flax)."""
    tree: Dict = {}

    def leaf(path):
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        return node

    for key, v in state_dict.items():
        a = _np(v)
        path, kind = key.split(".")[:-1], key.rsplit(".", 1)[1]
        name = path[-1]
        if path[-2:-1] == ["cell"]:
            # i.weight / h.weight / h.bias: four gates stacked
            for g, part in zip(_LSTM_GATES, np.split(a, 4, axis=0)):
                node = leaf(path[:-2] + ["cell", name + g])
                node["kernel" if kind == "weight" else "bias"] = \
                    np.ascontiguousarray(part.T if part.ndim == 2 else part)
            continue
        node = leaf(path)
        if name in ("label_embed", "table"):
            node["embedding"] = a
        elif name.startswith(("ln_", "pair_norm")):
            node["scale" if kind == "weight" else "bias"] = a
        elif len(path) > 1 and path[-2].startswith("attn"):
            d = a.shape[0] if name == "out" else a.shape[-1]
            if kind == "bias":
                node["bias"] = a if name == "out" else a.reshape(
                    num_heads, -1)
            elif name == "out":
                node["kernel"] = np.ascontiguousarray(
                    a.T.reshape(num_heads, -1, d))
            else:
                node["kernel"] = np.ascontiguousarray(
                    a.T.reshape(d, num_heads, -1))
        elif kind == "weight":
            node["kernel"] = np.ascontiguousarray(a.T)
        else:
            node["bias"] = a
    return {"params": tree}


def init_predictor_state(module: torch.nn.Module,
                         generator: torch.Generator
                         ) -> Dict[str, torch.Tensor]:
    """Fresh float32 weights of a HierarchicalPredictor with flax's default
    distributions: lecun-normal dense kernels (attention kernels by their
    flax fan-in), orthogonal recurrent LSTM kernels, zero biases, LayerNorm
    scale 1, embeddings normal with variance 1/features, the frequency
    table 0.  The distributions of the JAX package's init, not its
    numbers."""
    sd: Dict[str, torch.Tensor] = {}
    for key, v in module.state_dict().items():
        shape = tuple(v.shape)
        parts = key.split(".")
        if parts[-1] == "bias":
            sd[key] = torch.zeros(shape)
        elif parts[-2].startswith(("ln_", "pair_norm")):
            sd[key] = torch.ones(shape)
        elif parts[-2] == "table":
            sd[key] = torch.zeros(shape)
        elif parts[-2] == "label_embed":
            sd[key] = torch.empty(shape).normal_(
                0.0, 1.0 / math.sqrt(shape[1]), generator=generator)
        elif parts[-3:-1] == ["cell", "h"]:
            # one orthogonal (H, H) kernel per gate
            h = shape[1]
            sd[key] = torch.cat([torch.nn.init.orthogonal_(
                torch.empty(h, h), generator=generator)
                for _ in _LSTM_GATES])
        else:
            # fan-in = the input width (for attention's `out`, heads *
            # head_dim, as flax's DenseGeneral over two axes counts it)
            fan_in = shape[1]
            rows = shape[0] // 4 if parts[-3:-1] == ["cell", "i"] else \
                shape[0]
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            sd[key] = torch.cat([_trunc_normal((rows, shape[1]), std,
                                               generator)
                                 for _ in range(shape[0] // rows)])
    return sd
