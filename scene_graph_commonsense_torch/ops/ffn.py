"""Fused transformer FFN + residual + LayerNorm of the DETR encoder:
LayerNorm(x + relu(x W1 + b1) W2 + b2) over flattened tokens.

  ffn_ln_kernel / ffn_ln_plain  (`launches`)
      csrc/ffn.cu, the port of `_ffn_kernel` of
      scene_graph_commonsense_tpu/ops/pallas/ffn.py, and a plain PyTorch
      version with the same rounding points: x rounded to the compute dtype
      for the first product (float32 accumulation); b1 and ReLU in float32,
      h rounded to the compute dtype; the second product in float32 plus b2
      plus the unrounded float32 x; LayerNorm with two-pass statistics, eps,
      gamma and beta in float32; float32 out.

`fused_ffn_ln` is what callers use: it casts the weights as the JAX function
does, then runs the kernel for CUDA tensors and the plain version for CPU
tensors, an error anywhere else; never a fallback.

Layout: x (N, D) float32; w1 (D, F) and w2 (F, D), the flax (in, out)
layout; b1 (F,); b2, gamma, beta (D,).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scene_graph_commonsense_torch.ops import _build

launches = 0          # ffn_ln_kernel launches since the last reset

MODEL_DIM = 256       # the kernel's width (DETR d_model)
FF_CHUNK = 64         # the kernels walk F in chunks of this many columns
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def ffn_ln_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, *, compute_dtype: torch.dtype,
                 eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel's math; compute-dtype
    operands are widened to float32 before each product (the MXU's float32
    accumulation of exact products)."""
    f32 = torch.float32
    xc = x.to(compute_dtype).to(f32)
    h = xc @ w1.to(compute_dtype).to(f32)
    h = torch.relu(h + b1.to(f32))
    h = h.to(compute_dtype).to(f32)
    y = h @ w2.to(compute_dtype).to(f32)
    y = y + b2.to(f32) + x.to(f32)
    mu = y.mean(dim=-1, keepdim=True)
    d = y - mu
    var = (d * d).mean(dim=-1, keepdim=True)
    out = d * torch.rsqrt(var + eps)
    return out * gamma.to(f32) + beta.to(f32)


def check_kernel_inputs(x, w1, b1, w2, b2, gamma, beta) -> None:
    """Raises on anything the kernel does not take."""
    if x.dtype != torch.float32 or w1.dtype not in _DTYPE_CODES \
            or w2.dtype != w1.dtype:
        raise TypeError(f"ffn_ln takes float32 x and float32 or bfloat16 "
                        f"weights of one dtype, got {x.dtype}, {w1.dtype}, "
                        f"{w2.dtype}")
    if any(t.dtype != torch.float32 for t in (b1, b2, gamma, beta)):
        raise TypeError("ffn_ln takes float32 biases and LayerNorm affine")
    if x.dim() != 2 or x.shape[1] != MODEL_DIM or x.shape[0] < 1:
        raise ValueError(f"the ffn_ln kernel takes x of shape (N, "
                         f"{MODEL_DIM}), got {tuple(x.shape)}")
    f = w1.shape[-1]
    if w1.shape != (MODEL_DIM, f) or w2.shape != (f, MODEL_DIM) \
            or f < 1 or f % FF_CHUNK or b1.shape != (f,) \
            or any(t.shape != (MODEL_DIM,) for t in (b2, gamma, beta)):
        raise ValueError(f"ffn_ln takes w1 (D, F), w2 (F, D), b1 (F,) and "
                         f"(D,) b2/gamma/beta with F a multiple of "
                         f"{FF_CHUNK}, got {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}, {tuple(b1.shape)}")
    tensors = (x, w1, b1, w2, b2, gamma, beta)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ffn_ln inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ffn_ln takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("ffn_ln reads x, w1 and w2 in 16-byte vectors: "
                         "their storage must be 16-byte aligned")


def _library():
    fn = _build.load("ffn").sgc_ffn_ln
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def ffn_ln_kernel(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """Launches csrc/ffn.cu on the current stream of x's device and counts
    the launch; the compute dtype is the weights' dtype."""
    global launches
    _build.need_cuda("ffn_ln_kernel", x)
    check_kernel_inputs(x, w1, b1, w2, b2, gamma, beta)
    n, f = x.shape[0], w1.shape[1]
    out = torch.empty_like(x)
    fn = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check_launch("ffn_ln", fn(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        n, f, float(eps), _DTYPE_CODES[w1.dtype], x.device.index, stream))
    launches += 1
    return out


def fused_ffn_ln(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, *, compute_dtype: torch.dtype,
                 eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm(x + relu(x w1 + b1) w2 + b2) on x's device, float32 out.
    The weights are cast to the compute dtype and the vectors to float32
    first, as the JAX function casts them."""
    w1 = w1.to(compute_dtype).contiguous()
    w2 = w2.to(compute_dtype).contiguous()
    b1, b2, gamma, beta = (t.to(torch.float32).contiguous()
                           for t in (b1, b2, gamma, beta))
    plain = functools.partial(ffn_ln_plain, compute_dtype=compute_dtype)
    return _build.route("fused_ffn_ln", x, ffn_ln_kernel, plain)(
        x.contiguous(), w1, b1, w2, b2, gamma, beta, eps=eps)
