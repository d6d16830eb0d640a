"""Plain PyTorch reference of the frozen DETR-R101 featurizer
(facebookresearch/detr: ResNet-101 with frozen batch norm, the sine
position embedding, input_proj and the post-norm transformer encoder) that
turns a batch of images into the relation head's (B, S, S, 256) feature map
(scene_graph_commonsense train_utils.py), written from the published model
and nothing of the port.

ResNet-101 v1.5: a 7x7/2 stem conv, frozen BN, ReLU and a 3x3/2 max pool,
then stages of (3, 4, 23, 3) bottlenecks of widths (64, 128, 256, 512) x 4,
the stride on the 3x3 conv and a strided 1x1 projection on each stage's
first block.  Frozen BN is x * w / sqrt(var + 1e-5) + (b - mean * w /
sqrt(var + 1e-5)).  Parameters are named as torchvision names them, with
blocks `layer<stage>_<i>` and the projection `downsample_conv` /
`downsample_bn`; the encoder layers `encoder_<i>` with q, k, v and out
projections apart.  Images are NHWC; square and unpadded, so every position
is a real pixel.  float32, TF32 off; `q` rounds the operands of every
convolution and matrix product (the lower-precision control).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import full_float32

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _q(q: Quant, x: torch.Tensor) -> torch.Tensor:
    return x if q is None else q(x)


def _bn_shapes(prefix: str, c: int) -> Dict[str, tuple]:
    return {f"{prefix}.{k}": (c,)
            for k in ("weight", "bias", "running_mean", "running_var")}


def param_shapes(conf: Dict) -> Dict[str, tuple]:
    """Name -> shape of every parameter and frozen statistic of the encode
    half the configuration describes."""
    m = conf["model"]
    d, f = m["detr_d_model"], m["detr_ffn"]
    shapes = {"backbone.conv1.weight": (64, 3, 7, 7),
              **_bn_shapes("backbone.bn1", 64)}
    inplanes = 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                            m["detr_blocks"])):
        for i in range(n):
            pre = f"backbone.layer{stage + 1}_{i}"
            shapes[pre + ".conv1.weight"] = (planes, inplanes, 1, 1)
            shapes.update(_bn_shapes(pre + ".bn1", planes))
            shapes[pre + ".conv2.weight"] = (planes, planes, 3, 3)
            shapes.update(_bn_shapes(pre + ".bn2", planes))
            shapes[pre + ".conv3.weight"] = (planes * 4, planes, 1, 1)
            shapes.update(_bn_shapes(pre + ".bn3", planes * 4))
            if i == 0:
                shapes[pre + ".downsample_conv.weight"] = (
                    planes * 4, inplanes, 1, 1)
                shapes.update(_bn_shapes(pre + ".downsample_bn", planes * 4))
            inplanes = planes * 4
    shapes["input_proj.weight"] = (d, 2048, 1, 1)
    shapes["input_proj.bias"] = (d,)
    for i in range(m["detr_enc_layers"]):
        pre = f"encoder_{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{pre}.self_attn.{proj}.weight"] = (d, d)
            shapes[f"{pre}.self_attn.{proj}.bias"] = (d,)
        shapes[pre + ".linear1.weight"] = (f, d)
        shapes[pre + ".linear1.bias"] = (f,)
        shapes[pre + ".linear2.weight"] = (d, f)
        shapes[pre + ".linear2.bias"] = (d,)
        for norm in ("norm1", "norm2"):
            shapes[f"{pre}.{norm}.weight"] = (d,)
            shapes[f"{pre}.{norm}.bias"] = (d,)
    return shapes


def _bn(p, pre: str, x: torch.Tensor) -> torch.Tensor:
    scale = p[pre + ".weight"] / torch.sqrt(p[pre + ".running_var"] + 1e-5)
    shift = p[pre + ".bias"] - p[pre + ".running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def _conv(p, name: str, x, q: Quant, stride: int = 1, padding: int = 0):
    return F.conv2d(_q(q, x), _q(q, p[name + ".weight"]),
                    p.get(name + ".bias"), stride=stride, padding=padding)


def trunk(p, conf: Dict, images: torch.Tensor, q: Quant = None):
    """(B, H, W, 3) -> C5 (B, 2048, H/32, W/32)."""
    x = images.permute(0, 3, 1, 2)
    x = torch.relu(_bn(p, "backbone.bn1",
                       _conv(p, "backbone.conv1", x, q, 2, 3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for stage, n in enumerate(conf["model"]["detr_blocks"]):
        for i in range(n):
            pre = f"backbone.layer{stage + 1}_{i}"
            s = 2 if i == 0 and stage > 0 else 1
            y = torch.relu(_bn(p, pre + ".bn1",
                               _conv(p, pre + ".conv1", x, q)))
            y = torch.relu(_bn(p, pre + ".bn2",
                               _conv(p, pre + ".conv2", y, q, s, 1)))
            y = _bn(p, pre + ".bn3", _conv(p, pre + ".conv3", y, q))
            if i == 0:
                x = _bn(p, pre + ".downsample_bn",
                        _conv(p, pre + ".downsample_conv", x, q, s))
            x = torch.relu(y + x)
    return x


def sine_position(b: int, h: int, w: int, d: int, device) -> torch.Tensor:
    """DETR's normalised sine embedding of an unpadded (h, w) grid:
    (B, h * w, d), the y half then the x half, sin and cos interleaved."""
    half = d // 2
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)
    y = y / (h + 1e-6) * 2 * math.pi
    x = x / (w + 1e-6) * 2 * math.pi
    dim_t = 10000.0 ** (2 * (torch.arange(half, device=device) // 2) / half)

    def embed(v):
        e = v[:, None] / dim_t
        return torch.stack([e[:, 0::2].sin(), e[:, 1::2].cos()],
                           dim=2).reshape(len(v), half)

    pos = torch.cat([embed(y)[:, None, :].expand(h, w, half),
                     embed(x)[None, :, :].expand(h, w, half)], dim=-1)
    return pos.reshape(1, h * w, d).expand(b, h * w, d)


def _linear(p, name: str, x, q: Quant):
    return F.linear(_q(q, x), _q(q, p[name + ".weight"]), p[name + ".bias"])


def _layer_norm(p, name: str, x):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], 1e-5)


def encoder_layer(p, pre: str, src, pos, heads: int, q: Quant = None):
    """Post-norm encoder layer: self-attention on src + pos (values from
    src), residual, LayerNorm; ReLU FFN, residual, LayerNorm."""
    b, l, d = src.shape
    dh = d // heads
    qk = src + pos
    att = pre + ".self_attn."
    qh = _linear(p, att + "q_proj", qk, q).reshape(b, l, heads, dh)
    kh = _linear(p, att + "k_proj", qk, q).reshape(b, l, heads, dh)
    vh = _linear(p, att + "v_proj", src, q).reshape(b, l, heads, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", _q(q, qh), _q(q, kh)) \
        / math.sqrt(dh)
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", _q(q, attn), _q(q, vh))
    out = _linear(p, att + "out_proj", out.reshape(b, l, d), q)
    src = _layer_norm(p, pre + ".norm1", src + out)
    ffn = _linear(p, pre + ".linear2",
                  torch.relu(_linear(p, pre + ".linear1", src, q)), q)
    return _layer_norm(p, pre + ".norm2", src + ffn)


@torch.no_grad()
def features(p, conf: Dict, images: torch.Tensor, q: Quant = None,
             block: int = 4):
    """(B, H, W, 3) float32 images -> ((B, H/32, W/32, d) encoder output,
    (B, H/32, W/32, 2048) trunk output C5), `block` images at a time."""
    full_float32()
    m = conf["model"]
    outs, trunks = [], []
    for lo in range(0, images.shape[0], block):
        c5 = trunk(p, conf, images[lo:lo + block].float(), q)
        trunks.append(c5.permute(0, 2, 3, 1))
        b, _, h, w = c5.shape
        src = _conv(p, "input_proj", c5, q)
        src = src.permute(0, 2, 3, 1).reshape(b, h * w, -1)
        pos = sine_position(b, h, w, src.shape[-1], src.device)
        for i in range(m["detr_enc_layers"]):
            src = encoder_layer(p, f"encoder_{i}", src, pos,
                                m["detr_heads"], q)
        outs.append(src.reshape(b, h, w, -1))
    return torch.cat(outs), torch.cat(trunks)
