"""Fused DETR-encoder self-attention: softmax(q k^T * scale) v with key-only
padding masks.

  attention_kernel / attention_plain  (`launches`)
      csrc/attention.cu, the port of `_attn_kernel` of
      scene_graph_commonsense_tpu/ops/pallas/attention.py, and a plain
      PyTorch version with the same rounding points: s = (q.k) in float32,
      then times `scale`; masked keys filled with -3e38 (so a row whose keys
      are all masked gets the uniform softmax); exp(s - rowmax) / rowsum in
      float32; p rounded to v's dtype before the float32 p.v product; the
      output in q's dtype.

`fused_attention` is what callers use: the kernel for CUDA tensors, the plain
version for CPU tensors, an error anywhere else; never a fallback.

Layout: q, k, v and the output are (B, L, H, dh), the layout the q/k/v
projections produce (the JAX function takes (B, H, L, dh)); key_valid is
(B, L) bool, True = a real key (the torch key_padding_mask inverted).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from scene_graph_commonsense_torch.ops import _build

launches = 0          # attention_kernel launches since the last reset

MASK_FILL = -3.0e38
HEAD_DIM = 32         # the kernel's head width (DETR: 256 / 8)
BF16_CHUNK = 64       # the bf16 kernel's key chunk: L % 64 == 0
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: Optional[torch.Tensor] = None, *,
                    scale: float) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel's math.  bf16 operands are
    widened to float32 before each product (the MXU's float32 accumulation
    of exact products); float64 stays float64."""
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if key_valid is not None:
        s = torch.where(key_valid[:, None, None, :].bool(), s,
                        torch.tensor(MASK_FILL, dtype=acc, device=s.device))
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(acc), v.to(acc))
    return out.to(q.dtype)


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_valid: Optional[torch.Tensor]) -> None:
    """Raises on anything the kernel does not take."""
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"attention takes float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention takes q, k, v of one (B, L, H, dh) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, l, h, dh = q.shape
    if dh != HEAD_DIM or min(b, l, h) < 1:
        raise ValueError(f"the attention kernel takes dh = {HEAD_DIM} and "
                         f"non-empty B, L, H, got {tuple(q.shape)}")
    tensors = [q, k, v]
    if key_valid is not None:
        if key_valid.dtype != torch.bool or key_valid.shape != (b, l):
            raise ValueError(f"key_valid must be a (B, L) bool tensor, got "
                             f"{key_valid.dtype} {tuple(key_valid.shape)}")
        tensors.append(key_valid)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("attention inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("attention takes contiguous tensors")
    if q.dtype == torch.bfloat16 and l % BF16_CHUNK:
        raise ValueError(f"the bfloat16 attention kernel takes L a multiple "
                         f"of {BF16_CHUNK}, got {l}")
    if any(t.data_ptr() % 32 for t in (q, k, v)):
        raise ValueError("the attention kernels take q, k, v whose storage "
                         "is 32-byte aligned")


def _library():
    fn = _build.load("attention").sgc_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_valid: Optional[torch.Tensor] = None, *,
                     scale: float) -> torch.Tensor:
    """Launches csrc/attention.cu on the current stream of the inputs'
    device and counts the launch."""
    global launches
    _build.need_cuda("attention_kernel", q)
    check_kernel_inputs(q, k, v, key_valid)
    b, l, h, _ = q.shape
    out = torch.empty_like(q)
    # a bool tensor is one byte per element: the kernel reads it as uint8
    valid = None if key_valid is None else key_valid.view(torch.uint8)
    fn = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check_launch("attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if valid is None else valid.data_ptr(), out.data_ptr(),
        b, l, h, float(scale), _DTYPE_CODES[q.dtype], q.device.index,
        stream))
    launches += 1
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: Optional[torch.Tensor] = None, *,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v on q's device: (B, L, H, dh) in q's
    dtype."""
    return _build.route("fused_attention", q, attention_kernel,
                        attention_plain)(q, k, v, key_valid, scale=scale)
