"""Fused frozen ResNet bottleneck blocks of the DETR-101 trunk, and the
frozen-BN fold they take.

  fold_bn
      a copy of `fold_bn` of scene_graph_commonsense_tpu/ops/pallas/
      bottleneck.py: FrozenBatchNorm statistics -> a float32 (2, C)
      [scale, shift] with scale = weight * rsqrt(var + eps), whatever the
      compute dtype.
  bottleneck_kernel / fused_bottleneck_plain  (`launches`)
      csrc/bottleneck.cu at stride 1, the port of the TPU kernel `_kernel`
      (through `fused_bottleneck`): one whole stride-1 block, the identity
      plain or projected (layer1_0).
  bottleneck_s2_kernel / fused_bottleneck_s2_plain  (`s2_launches`)
      the same source at stride 2, the port of `_kernel_s2` (through
      `fused_bottleneck_s2`): the three stage transitions.

The plain versions keep the TPU kernels' rounding points: x and the
weights in the compute dtype, each product a float32 matmul (or conv) of
the rounded operands; BN as a float32 multiply then add on those sums;
a = cd(relu(.)) and b = cd(relu(.)) rounded; c and the identity (f32(x) or
the projection) in float32; y = cd(relu(c + idn)).  conv2's padding is
zero a, not zero x.

`fused_bottleneck` and `fused_bottleneck_s2` are what callers use: the
kernel for CUDA tensors, the plain version for CPU tensors, an error
anywhere else; never a fallback.

Layout (the JAX functions'): x (B, H, W, C) NHWC in the compute dtype
(float32 or bfloat16); w1 (C, M), w2 (3, 3, M, M) as (dy, dx, in, out), w3
(M, CO) and the optional wd (C, CO) in x's dtype; s1, s2 (2, M), s3, sd
(2, CO) float32 folds.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from scene_graph_commonsense_torch.ops import _build

launches = 0          # stride-1 kernel launches since the last reset
s2_launches = 0       # stride-2 kernel launches since the last reset

CHANNEL_MULTIPLE = 64     # the kernel walks channels in chunks of 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fold_bn(bn, eps: float = 1e-5) -> torch.Tensor:
    """FrozenBatchNorm {weight, bias, running_mean, running_var} (a module
    or a mapping) -> (2, C) float32 [scale, shift], so that BN is one
    multiply and one add."""
    def get(k):
        return bn[k] if isinstance(bn, Mapping) else getattr(bn, k)
    w, b, mean, var = (torch.as_tensor(get(k)).to(torch.float32) for k in (
        "weight", "bias", "running_mean", "running_var"))
    scale = w * torch.rsqrt(var + eps)
    return torch.stack([scale, b - mean * scale])


def _affine(v: torch.Tensor, fold: torch.Tensor) -> torch.Tensor:
    return v * fold[0] + fold[1]


def _round(v: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    return v.to(cd).to(v.dtype)


def _conv2(a: torch.Tensor, w2: torch.Tensor, stride: int) -> torch.Tensor:
    """The 3x3 conv (pad 1, zero a) of NHWC a by (3, 3, M, M), in a's
    dtype."""
    out = F.conv2d(a.permute(0, 3, 1, 2), w2.to(a.dtype).permute(3, 2, 0, 1),
                   stride=stride, padding=1)
    return out.permute(0, 2, 3, 1)


def _block_plain(x, w1, s1, w2, s2, w3, s3, wd, sd, stride):
    cd = x.dtype
    f32 = torch.promote_types(cd, torch.float32)     # float64 stays float64
    xf = x.to(f32)
    a = _round(torch.relu(_affine(xf @ w1.to(f32), s1)), cd)
    b = _round(torch.relu(_affine(_conv2(a, w2, stride), s2)), cd)
    c = _affine(b @ w3.to(f32), s3)
    if wd is None:
        idn = xf
    else:
        idn = _affine(xf[:, ::stride, ::stride] @ wd.to(f32), sd)
    return torch.relu(c + idn).to(cd)


def fused_bottleneck_plain(x, w1, s1, w2, s2, w3, s3, wd=None, sd=None):
    """Plain PyTorch version of the stride-1 kernel's math."""
    return _block_plain(x, w1, s1, w2, s2, w3, s3, wd, sd, 1)


def fused_bottleneck_s2_plain(x, w1, s1, w2, s2, w3, s3, wd, sd):
    """Plain PyTorch version of the stride-2 kernel's math."""
    return _block_plain(x, w1, s1, w2, s2, w3, s3, wd, sd, 2)


def check_kernel_inputs(x, w1, s1, w2, s2, w3, s3, wd, sd,
                        stride: int) -> None:
    """Raises on anything the kernel does not take."""
    weights = [w1, w2, w3] + ([] if wd is None else [wd])
    folds = [s1, s2, s3] + ([] if sd is None else [sd])
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype
                                          for t in weights):
        raise TypeError(f"the bottleneck kernel takes float32 or bfloat16 x "
                        f"and weights of x's dtype, got {x.dtype}, "
                        f"{[t.dtype for t in weights]}")
    if any(t.dtype != torch.float32 for t in folds):
        raise TypeError("the bottleneck kernel takes float32 BN folds")
    if (wd is None) != (sd is None) or (stride == 2 and wd is None):
        raise ValueError("wd and sd come together; stride 2 needs both")
    if x.dim() != 4 or min(x.shape) < 1:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    m, co = w1.shape[-1], w3.shape[-1]
    if stride == 2 and (h % 2 or w % 2):
        raise ValueError(f"the stride-2 kernel takes even H and W, got "
                         f"{h}x{w}")
    if w1.shape != (c, m) or w2.shape != (3, 3, m, m) or w3.shape != (m, co) \
            or s1.shape != (2, m) or s2.shape != (2, m) \
            or s3.shape != (2, co) or (wd is not None and (
                wd.shape != (c, co) or sd.shape != (2, co))):
        raise ValueError(f"bottleneck shapes: x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}, w3 "
                         f"{tuple(w3.shape)}")
    if wd is None and c != co:
        raise ValueError(f"the identity needs C == CO, got {c} and {co}")
    if any(n % CHANNEL_MULTIPLE for n in (c, m, co)):
        raise ValueError(f"the bottleneck kernel takes C, M and CO that are "
                         f"multiples of {CHANNEL_MULTIPLE}, got {c}, {m}, "
                         f"{co}")
    tensors = [x] + weights + folds
    if len({t.device for t in tensors}) != 1:
        raise ValueError("bottleneck inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the bottleneck kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in [x] + weights):
        raise ValueError("the bottleneck kernel reads x and the weights in "
                         "16-byte vectors: their storage must be 16-byte "
                         "aligned")


def _library():
    fn = _build.load("bottleneck").sgc_bottleneck
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
    return fn


def _launch(x, w1, s1, w2, s2, w3, s3, wd, sd, stride: int) -> torch.Tensor:
    _build.need_cuda("bottleneck kernel", x)
    check_kernel_inputs(x, w1, s1, w2, s2, w3, s3, wd, sd, stride)
    b, h, w, c = x.shape
    m, co = w1.shape[1], w3.shape[1]
    y = torch.empty((b, h // stride, w // stride, co), dtype=x.dtype,
                    device=x.device)
    opt = (lambda t: None if t is None else t.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check_launch("bottleneck", _library()(
        x.data_ptr(), w1.data_ptr(), s1.data_ptr(), w2.data_ptr(),
        s2.data_ptr(), w3.data_ptr(), s3.data_ptr(), opt(wd), opt(sd),
        y.data_ptr(), b, h, w, c, m, co, stride, _DTYPE_CODES[x.dtype],
        x.device.index, stream))
    return y


def bottleneck_kernel(x, w1, s1, w2, s2, w3, s3, wd=None, sd=None):
    """Launches csrc/bottleneck.cu at stride 1 on the current stream of x's
    device and counts the launch."""
    global launches
    y = _launch(x, w1, s1, w2, s2, w3, s3, wd, sd, 1)
    launches += 1
    return y


def bottleneck_s2_kernel(x, w1, s1, w2, s2, w3, s3, wd, sd):
    """Launches csrc/bottleneck.cu at stride 2 and counts the launch."""
    global s2_launches
    y = _launch(x, w1, s1, w2, s2, w3, s3, wd, sd, 2)
    s2_launches += 1
    return y


def fused_bottleneck(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                     w2: torch.Tensor, s2: torch.Tensor, w3: torch.Tensor,
                     s3: torch.Tensor, wd: Optional[torch.Tensor] = None,
                     sd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One frozen stride-1 bottleneck block on x's device: (B, H, W, C) ->
    (B, H, W, CO) in x's dtype."""
    return _build.route("fused_bottleneck", x, bottleneck_kernel,
                        fused_bottleneck_plain)(x, w1, s1, w2, s2, w3, s3,
                                                wd, sd)


def fused_bottleneck_s2(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                        w2: torch.Tensor, s2: torch.Tensor, w3: torch.Tensor,
                        s3: torch.Tensor, wd: torch.Tensor,
                        sd: torch.Tensor) -> torch.Tensor:
    """A stride-2 stage transition on x's device: (B, H, W, C) ->
    (B, H/2, W/2, CO), H and W even."""
    return _build.route("fused_bottleneck_s2", x, bottleneck_s2_kernel,
                        fused_bottleneck_s2_plain)(x, w1, s1, w2, s2, w3,
                                                   s3, wd, sd)
