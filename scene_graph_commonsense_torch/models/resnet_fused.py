"""Fused-forward ResNet-101 trunk (torch port of
scene_graph_commonsense_tpu/models/resnet_fused.py).

The port's `ResNet101` module (models/detr.py) holds the parameters; this
module runs the same trunk through the fused kernels:
  * the stem through `stem_conv_pool` (ops/stem.py, K5) when H and W are
    divisible by 8; otherwise the plain 7x7/2 conv, then `stem_pool` (K6)
    when the conv output is even, or BN, ReLU and a -inf-padded max pool in
    plain torch when it is odd;
  * the 30 stride-1 blocks through `fused_bottleneck` (ops/bottleneck.py,
    K3);
  * the three stride-2 stage transitions through `fused_bottleneck_s2`
    (K4) at even sizes, through the plain `_xla_bottleneck` at odd ones.
This is the routing of the JAX module's code (`resnet_forward_fused`); its
docstring's remark that the stem and the transitions stay on XLA predates
the code that fuses them.

The detector is frozen (reference train_test.py:80-81): forward only.  The
folded BNs and the weights in the kernels' layout and dtype are prepared
once per model, compute dtype and device (`prepared`) and kept on the
module; loading a state dict into the module drops them (a post-load
hook of `ResNet101`).  Editing the parameters in place by other means does
not: call `ResNet101.drop_fused()` after it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn.functional as F

from scene_graph_commonsense_torch.ops.bottleneck import (
    fold_bn, fused_bottleneck, fused_bottleneck_s2)
from scene_graph_commonsense_torch.ops.stem import (
    stem_conv_pool, stem_kernel_weights, stem_pool)

STAGES = ("layer1", "layer2", "layer3", "layer4")
STAGE_STRIDES = (1, 2, 2, 2)


def _conv(x: torch.Tensor, weight: torch.Tensor, stride: int, padding: int,
          dtype: torch.dtype) -> torch.Tensor:
    """NHWC conv by a torch (O, I, kh, kw) weight in `dtype`; NHWC out."""
    out = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight.to(dtype),
                   stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1)


def _bn(x: torch.Tensor, fold: torch.Tensor) -> torch.Tensor:
    """The fold cast to x's dtype and applied in it."""
    return x * fold[0].to(x.dtype) + fold[1].to(x.dtype)


def _matrix(conv: torch.nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """A 1x1 conv's weight as the (in, out) matrix of the flax layout."""
    return conv.weight[:, :, 0, 0].t().to(dtype).contiguous()


@dataclass
class Block:
    """One bottleneck's weights in the kernels' layout: w1 (C, M), w2
    (3, 3, M, M), w3 (M, CO), wd (C, CO) in the compute dtype; float32
    folds.  `module` is the port's Bottleneck, for the plain fallback."""
    module: torch.nn.Module
    stride: int
    w1: torch.Tensor
    s1: torch.Tensor
    w2: torch.Tensor
    s2: torch.Tensor
    w3: torch.Tensor
    s3: torch.Tensor
    wd: Optional[torch.Tensor]
    sd: Optional[torch.Tensor]

    def args(self):
        return (self.w1, self.s1, self.w2, self.s2, self.w3, self.s3,
                self.wd, self.sd)


@dataclass
class Prepared:
    """The trunk's weights for the fused path in one compute dtype."""
    stem_w7: torch.Tensor           # (7, 7, 3, 64), compute dtype
    stem_fold: torch.Tensor         # (2, 64) float32
    stages: List[List[Block]]
    # the bf16 stem kernel's weight matrix (ops/stem.stem_kernel_weights);
    # None in float32
    stem_wk: Optional[torch.Tensor] = None


def prepare_block(blk, stride: int, dtype: torch.dtype) -> Block:
    """The kernels' arguments of one port Bottleneck in `dtype`."""
    has_d = blk.has_downsample
    return Block(
        module=blk, stride=stride,
        w1=_matrix(blk.conv1, dtype), s1=fold_bn(blk.bn1),
        w2=blk.conv2.weight.permute(2, 3, 1, 0).to(dtype).contiguous(),
        s2=fold_bn(blk.bn2),
        w3=_matrix(blk.conv3, dtype), s3=fold_bn(blk.bn3),
        wd=_matrix(blk.downsample_conv, dtype) if has_d else None,
        sd=fold_bn(blk.downsample_bn) if has_d else None)


def prepared(backbone, dtype: torch.dtype) -> Prepared:
    """The folds and kernel-layout weights of `backbone` (the port's
    ResNet101) in `dtype` on its device, built at the first call and kept
    on the module until its next load_state_dict."""
    key = (dtype, backbone.conv1.weight.device)
    prep = backbone.fused_cache.get(key)
    if prep is None:
        with torch.no_grad():
            stages = [[prepare_block(
                getattr(backbone, f"{name}_{i}"),
                stride if i == 0 else 1, dtype)
                for i in range(n)]
                for name, n, stride in zip(STAGES, backbone.blocks,
                                           STAGE_STRIDES)]
            w7 = backbone.conv1.weight.permute(2, 3, 1, 0).to(
                dtype).contiguous()
            prep = Prepared(
                stem_w7=w7, stem_fold=fold_bn(backbone.bn1), stages=stages,
                stem_wk=stem_kernel_weights(w7)
                if dtype == torch.bfloat16 else None)
        backbone.fused_cache[key] = prep
    return prep


def _xla_bottleneck(blk: Block, x: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """The block through plain convolutions with the fused path's folds
    (the odd-size stride-2 fallback; JAX's `_xla_bottleneck`)."""
    m, s = blk.module, blk.stride
    out = torch.relu(_bn(_conv(x, m.conv1.weight, 1, 0, dtype), blk.s1))
    out = torch.relu(_bn(_conv(out, m.conv2.weight, s, 1, dtype), blk.s2))
    out = _bn(_conv(out, m.conv3.weight, 1, 0, dtype), blk.s3)
    if blk.wd is not None:
        idn = _bn(_conv(x[:, ::s, ::s], m.downsample_conv.weight, 1, 0,
                        dtype), blk.sd)
    else:
        idn = x
    return torch.relu(out + idn)


def _stem(backbone, prep: Prepared, images: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    h, w = images.shape[1:3]
    if h % 8 == 0 and w % 8 == 0:
        # the whole stem in one kernel (conv + BN + ReLU + pool)
        return stem_conv_pool(images, prep.stem_w7, prep.stem_fold,
                              compute_dtype=dtype, wk=prep.stem_wk)
    x = _conv(images, backbone.conv1.weight, 2, 3, dtype)
    if x.shape[1] % 2 or x.shape[2] % 2:
        x = torch.relu(_bn(x, prep.stem_fold)).permute(0, 3, 1, 2)
        return F.max_pool2d(x, 3, stride=2, padding=1).permute(0, 2, 3, 1)
    return stem_pool(x, prep.stem_fold)


def resnet_forward_fused(backbone, images: torch.Tensor, dtype: torch.dtype,
                         upto: Optional[str] = None) -> torch.Tensor:
    """ResNet-101 trunk forward of `backbone` (the port's ResNet101) through
    the fused kernels.

    images: (B, H, W, 3) NHWC; returns C5 (B, H/32, W/32, 2048) NHWC in
    `dtype`: the function `ResNet101.forward` computes, up to the
    compute-dtype roundings of the folded BN (folded in float32 here).

    upto: stop after a named stage ("stem", "layer1".."layer4") and return
    that stage's activation (the per-stage split of chip_smoke.py's
    featurize phase); None runs the whole trunk.
    """
    prep = prepared(backbone, dtype)
    x = _stem(backbone, prep, images, dtype)
    if upto == "stem":
        return x
    for name, blocks in zip(STAGES, prep.stages):
        for blk in blocks:
            if blk.stride == 2:
                if x.shape[1] % 2 or x.shape[2] % 2:
                    x = _xla_bottleneck(blk, x, dtype)
                else:
                    x = fused_bottleneck_s2(x.contiguous(), *blk.args())
            else:
                x = fused_bottleneck(x.contiguous(), *blk.args())
        if upto == name:
            return x
    return x
