"""DETR-ResNet101, encode half (torch port of
scene_graph_commonsense_tpu/models/detr.py): the frozen featurizer that turns
images into the (B, S, S, 256) feature map of the relation stage
(reference train_utils.py:9-18).

  * ResNet-101 v1.5 trunk to C5 (stride on conv2, a strided 1x1 projection
    on the first block of each stage), frozen batch norm with its four
    statistics as buffers; with `fused_backbone` the trunk runs the fused
    stem and bottleneck kernels of models/resnet_fused.py where the JAX
    package runs its Pallas ones;
  * normalised sine position embeddings;
  * input_proj (1x1 conv with bias) and the post-norm encoder (6 layers),
    whose self-attention and FFN + LayerNorm run the fused kernels of
    ops/attention.py and ops/ffn.py where the JAX package runs its Pallas
    ones (`flash_encoder`).

The decoder, the query embedding and the class and box heads (`__call__` of
the JAX module) belong to the detection slice and are not here.

Same rounding points as the flax modules: every layer casts its input and
weights to the compute dtype; the frozen-BN scale and shift are computed in
the parameters' dtype and cast; the position embedding is computed in at
least float32; LayerNorm promotes to its float32 parameters, so under bf16
compute the residual stream after the first norm is float32.  The public
functions take and return NHWC tensors as the JAX package does; the trunk's
convolutions run on the NCHW view of that memory (channels-last).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from scene_graph_commonsense_torch.models.resnet_fused import (
    resnet_forward_fused)
from scene_graph_commonsense_torch.ops.attention import fused_attention
from scene_graph_commonsense_torch.ops.ffn import fused_ffn_ln

RESNET101_BLOCKS = (3, 4, 23, 3)


def _conv(layer: nn.Conv2d, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """The conv of `layer` in `dtype` on an NCHW (channels-last) tensor."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias,
                    stride=layer.stride, padding=layer.padding)


def _dense(layer: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Dense(dtype): input, kernel and bias cast to `dtype`."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """flax nn.LayerNorm: statistics in at least float32 with the fast
    variance E[x^2] - E[x]^2 (clipped at 0), the result in the promotion of
    x and the parameters (float32 for bf16 x)."""
    dt = torch.promote_types(torch.promote_types(x.dtype, norm.weight.dtype),
                             torch.float32)
    x = x.to(dt)
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * norm.weight.to(dt)
    return (x - mean) * mul + norm.bias.to(dt)


class FrozenBatchNorm(nn.Module):
    """Batch norm with all four statistics frozen (the detector is never
    trained).  Scale and shift are computed in the statistics' dtype, then
    cast to the compute dtype and applied in it; nothing is folded into the
    convolution."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x: (B, C, H, W) in `dtype`."""
        root = torch.sqrt(self.running_var + self.eps)
        scale = (self.weight / root).to(dtype)
        shift = (self.bias - self.running_mean * self.weight / root).to(dtype)
        return x * scale[:, None, None] + shift[:, None, None]


class Bottleneck(nn.Module):
    """torchvision Bottleneck v1.5 (the stride on conv2); the first block of
    a stage projects the identity with a strided 1x1 conv (a subsample
    followed by a dot over the channels)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.has_downsample = downsample
        if downsample:
            self.downsample_conv = nn.Conv2d(inplanes, planes * 4, 1,
                                             stride=stride, bias=False)
            self.downsample_bn = FrozenBatchNorm(planes * 4)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x: (B, C, H, W) channels-last."""
        out = torch.relu(self.bn1(_conv(self.conv1, x, dtype), dtype))
        out = torch.relu(self.bn2(_conv(self.conv2, out, dtype), dtype))
        out = self.bn3(_conv(self.conv3, out, dtype), dtype)
        if self.has_downsample:
            idn = self.downsample_bn(_conv(self.downsample_conv, x, dtype),
                                     dtype)
        else:
            idn = x
        return torch.relu(out + idn)


def _drop_fused(module, incompatible_keys) -> None:
    module.drop_fused()


class ResNet101(nn.Module):
    """torchvision-style ResNet-101 trunk up to C5 (stride 32, 2048
    channels); `blocks` shrinks the per-stage depth for tests.  Blocks are
    named layer<stage>_<i> as in the flax tree.

    `forward` is the unfused trunk (cuDNN convolutions with frozen-BN, ReLU
    and residual passes); models/resnet_fused.resnet_forward_fused runs the
    same parameters through the fused kernels.  It keeps their folded,
    kernel-layout copies in `fused_cache`, which load_state_dict empties
    (a post-load hook); call drop_fused() after changing the parameters in
    place by other means."""

    def __init__(self, blocks: Tuple[int, ...] = RESNET101_BLOCKS):
        super().__init__()
        self.blocks = tuple(blocks)
        self.fused_cache = {}
        self.register_load_state_dict_post_hook(_drop_fused)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        inplanes = 64
        for stage, (planes, n, stride) in enumerate(
                zip((64, 128, 256, 512), self.blocks, (1, 2, 2, 2))):
            for i in range(n):
                self.add_module(f"layer{stage + 1}_{i}", Bottleneck(
                    inplanes, planes, stride if i == 0 else 1,
                    downsample=(i == 0)))
                inplanes = planes * 4

    def drop_fused(self) -> None:
        """Forgets the fused path's prepared weights."""
        self.fused_cache.clear()

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x: (B, H, W, 3) NHWC -> (B, H/32, W/32, 2048) NHWC in `dtype`.
        The stem is the plain 7x7/2 conv (the JAX package's space-to-depth
        form of it is the same function, arranged for the TPU's matrix
        unit), frozen BN, ReLU and a 3x3/2 max pool over a -inf pad."""
        x = x.to(dtype).permute(0, 3, 1, 2)         # NCHW view of NHWC
        x = torch.relu(self.bn1(_conv(self.conv1, x, dtype), dtype))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        for stage, n in enumerate(self.blocks):
            for i in range(n):
                x = getattr(self, f"layer{stage + 1}_{i}")(x, dtype)
        return x.permute(0, 2, 3, 1)


def sine_position_embedding(mask: torch.Tensor, num_pos_feats: int = 128,
                            temperature: float = 10000.0,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """DETR PositionEmbeddingSine (normalised, scale 2 pi).  mask: (B, H, W)
    bool, True where the canvas holds real pixels.  Returns
    (B, H, W, 2 * num_pos_feats) in `dtype`, computed in at least float32
    (float64 under float64)."""
    cd = torch.promote_types(dtype, torch.float32)
    not_mask = mask.to(cd)
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    eps, scale = 1e-6, 2 * math.pi
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=cd, device=mask.device)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)

    def interleave(pos):
        # sin of the even features and cos of the odd ones, interleaved by
        # stack + reshape (not concatenated)
        return torch.stack([torch.sin(pos[..., 0::2]),
                            torch.cos(pos[..., 1::2])],
                           dim=-1).reshape(pos.shape[:-1] + (-1,))

    pos_x = interleave(x_embed[..., None] / dim_t)
    pos_y = interleave(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1).to(dtype)


def downsample_mask(pixel_mask: torch.Tensor, h: int, w: int
                    ) -> torch.Tensor:
    """The (B, H, W) pixel mask on the (h, w) feature grid by index, like
    DETR's nearest F.interpolate of the boolean mask (reference
    utils.py:185-204)."""
    ys = (torch.arange(h, device=pixel_mask.device)
          * pixel_mask.shape[1]) // h
    xs = (torch.arange(w, device=pixel_mask.device)
          * pixel_mask.shape[2]) // w
    return pixel_mask[:, ys][:, :, xs]


class MHA(nn.Module):
    """Multi-head attention with separate q/k/v projections and a key
    padding mask (torch nn.MultiheadAttention semantics, in_proj split as in
    the flax tree).  With `flash`, self-attention with L % 512 == 0 outside
    float64 runs the fused kernel (ops/attention.py), exactly where the JAX
    module routes to its Pallas kernel; otherwise the naive path with the
    JAX package's rounding points."""

    def __init__(self, d_model: int, nhead: int,
                 dtype: torch.dtype = torch.float32, flash: bool = False):
        super().__init__()
        self.d_model, self.nhead, self.dtype = d_model, nhead, dtype
        self.flash = flash
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def uses_kernel(self, lq: int, lk: int) -> bool:
        return (self.flash and lq == lk and lq % 512 == 0
                and self.dtype != torch.float64)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """q: (B, Lq, D), k and v: (B, Lk, D); key_padding_mask: (B, Lk)
        bool, True = a real key.  Returns (B, Lq, D) in the compute
        dtype."""
        dt, d_head = self.dtype, self.d_model // self.nhead
        qh = _dense(self.q_proj, q, dt).reshape(
            q.shape[:-1] + (self.nhead, d_head))
        kh = _dense(self.k_proj, k, dt).reshape(
            k.shape[:-1] + (self.nhead, d_head))
        vh = _dense(self.v_proj, v, dt).reshape(
            v.shape[:-1] + (self.nhead, d_head))
        if self.uses_kernel(q.shape[1], k.shape[1]):
            out = fused_attention(qh, kh, vh, key_valid=key_padding_mask,
                                  scale=1.0 / math.sqrt(d_head))
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) \
                / math.sqrt(d_head)
            if key_padding_mask is not None:
                bias = torch.where(
                    key_padding_mask[:, None, None, :],
                    torch.zeros((), dtype=torch.float32, device=q.device),
                    torch.tensor(torch.finfo(torch.float32).min,
                                 device=q.device))
                logits = logits + bias
            # softmax in at least float32, no downcast under float64
            attn = torch.softmax(
                logits.to(torch.promote_types(logits.dtype, torch.float32)),
                dim=-1).to(vh.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, vh)
        out = out.reshape(q.shape[:-1] + (self.d_model,))
        return _dense(self.out_proj, out, dt)


class EncoderLayer(nn.Module):
    """Post-norm transformer encoder layer.  With `flash`, the FFN +
    residual + LayerNorm runs the fused kernel (ops/ffn.py) when
    (B * L) % 512 == 0 outside float64, as in the JAX module."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_ff: int = 2048, dtype: torch.dtype = torch.float32,
                 flash: bool = False):
        super().__init__()
        self.dtype, self.flash = dtype, flash
        self.self_attn = MHA(d_model, nhead, dtype, flash=flash)
        self.linear1 = nn.Linear(d_model, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def uses_kernel(self, tokens: int) -> bool:
        return (self.flash and tokens % 512 == 0
                and self.dtype != torch.float64)

    def forward(self, src: torch.Tensor, pos: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
        q = k = src + pos
        src2 = self.self_attn(q, k, src, key_padding_mask)
        src = _layer_norm(self.norm1, src + src2)
        b, l, d = src.shape
        if self.uses_kernel(b * l):
            out = fused_ffn_ln(
                src.reshape(b * l, d), self.linear1.weight.t(),
                self.linear1.bias, self.linear2.weight.t(),
                self.linear2.bias, self.norm2.weight, self.norm2.bias,
                compute_dtype=self.dtype)
            return out.reshape(b, l, d)
        src2 = _dense(self.linear2,
                      torch.relu(_dense(self.linear1, src, self.dtype)),
                      self.dtype)
        return _layer_norm(self.norm2, src + src2)


class DETR(nn.Module):
    """The encode half of DETR-ResNet101: trunk, input_proj and the encoder
    layers (named encoder_<i> as in the flax tree).  `fused_backbone` routes
    the trunk through the fused kernels (models/resnet_fused.py), same
    parameters, forward only; `flash_encoder` the encoder through K7/K8."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 num_encoder_layers: int = 6,
                 backbone_blocks: Tuple[int, ...] = RESNET101_BLOCKS,
                 dim_ff: int = 2048, dtype: torch.dtype = torch.float32,
                 fused_backbone: bool = False, flash_encoder: bool = False):
        super().__init__()
        self.d_model, self.dtype = d_model, dtype
        self.fused_backbone = fused_backbone
        self.flash_encoder = flash_encoder
        self.num_encoder_layers = num_encoder_layers
        self.backbone = ResNet101(backbone_blocks)
        self.input_proj = nn.Conv2d(2048, d_model, 1)
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_{i}", EncoderLayer(
                d_model, nhead, dim_ff, dtype, flash=flash_encoder))

    def encoder_layers(self):
        return [getattr(self, f"encoder_{i}")
                for i in range(self.num_encoder_layers)]

    def _encode(self, images: torch.Tensor,
                pixel_mask: Optional[torch.Tensor]):
        """images: (B, H, W, 3); pixel_mask: (B, H, W) bool, True = a real
        pixel.  Returns (src (B, S*S, D), pos, key mask (B, S*S), (h, w))."""
        dt = self.dtype
        if self.fused_backbone:
            feat = resnet_forward_fused(self.backbone, images, dt)
        else:
            feat = self.backbone(images, dt)              # (B, h, w, 2048)
        b, h, w, _ = feat.shape
        if pixel_mask is None:
            fmask = torch.ones((b, h, w), dtype=torch.bool,
                               device=feat.device)
        else:
            fmask = downsample_mask(pixel_mask.bool(), h, w)
        pos = sine_position_embedding(fmask, self.d_model // 2, dtype=dt)
        src = _conv(self.input_proj, feat.permute(0, 3, 1, 2), dt)
        src = src.permute(0, 2, 3, 1).reshape(b, h * w, self.d_model)
        pos = pos.reshape(b, h * w, self.d_model)
        kmask = fmask.reshape(b, h * w).contiguous()
        for layer in self.encoder_layers():
            src = layer(src, pos, kmask)
        return src, pos, kmask, (h, w)

    def encode_features(self, images: torch.Tensor,
                        pixel_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """Encoder-only feature path of the relation stage: (B, S, S, D)
        (reference train_utils.py:9-18)."""
        src, _, _, (h, w) = self._encode(images, pixel_mask)
        return src.reshape(src.shape[0], h, w, self.d_model)


def resolve_detr_modes(cfg, device: torch.device) -> Tuple[bool, bool]:
    """(fused_backbone, flash_encoder) of a config on `device`.

    flash_encoder: "on", or "auto" on a CUDA device outside float64 (the
    JAX package's "on the accelerator" rule).  fused_backbone: "on", or
    "auto" on a CUDA device outside float64, and in both cases only for the
    ResNet-101 layout (other detr_blocks run unfused, as in JAX).  The JAX
    rule also asks for a single device, because its GSPMD mesh shards the
    batch; the port has no mesh yet, and that guard comes with it.  float64
    stays unfused under auto because the kernels take float32 and bfloat16
    (the JAX package never runs float64 on the TPU)."""
    m = cfg.model
    for knob in ("fused_backbone", "flash_encoder"):
        if getattr(m, knob) not in ("auto", "on", "off"):
            raise ValueError(f"model.{knob} must be auto, on or off, got "
                             f"{getattr(m, knob)!r}")
    dtype = getattr(torch, m.compute_dtype)
    accel = device.type == "cuda" and dtype != torch.float64
    fused = (m.fused_backbone == "on"
             or (m.fused_backbone == "auto" and accel)) \
        and tuple(m.detr_blocks) == RESNET101_BLOCKS
    flash = m.flash_encoder == "on" or (m.flash_encoder == "auto" and accel)
    return fused, flash


def module_from_cfg(cfg, fused_backbone: bool = False,
                    flash_encoder: bool = False) -> DETR:
    m = cfg.model
    return DETR(num_encoder_layers=m.detr_enc_layers,
                backbone_blocks=tuple(m.detr_blocks),
                dtype=getattr(torch, m.compute_dtype),
                fused_backbone=fused_backbone, flash_encoder=flash_encoder)


def make_detr(cfg, device=None, state_dict=None,
              generator: Optional[torch.Generator] = None) -> DETR:
    """The frozen encode half of DETR on `device` (default cuda), in eval
    mode with no gradients.  Weights come from `state_dict` (the port's
    names, see models/weights.py) if given, else from
    weights.init_detr_params(cfg, generator).  Parameters are float32, or
    float64 under float64 compute (the parity runs).  TF32 is turned off
    (device.disable_tf32), so float32 convolutions run in full float32."""
    from scene_graph_commonsense_torch.device import (
        disable_tf32, resolve_device)
    from scene_graph_commonsense_torch.models.weights import (
        init_detr_params)
    dev = resolve_device(device)
    disable_tf32()
    fused, flash = resolve_detr_modes(cfg, dev)
    with torch.device("meta"):        # allocated once, on the device, below
        model = module_from_cfg(cfg, fused_backbone=fused,
                                flash_encoder=flash)
    model = model.to_empty(device=dev)
    if model.dtype == torch.float64:
        model = model.to(torch.float64)
    if state_dict is None:
        state_dict = init_detr_params(cfg, generator)
    model.load_state_dict(state_dict)
    return model.eval().requires_grad_(False)
