"""Fused pair assembly: gather + add + 2x2 maxpool + ReLU.

out[p] = relu(maxpool2(a[si[p]] + b[oj[p]])) for NHWC streams a, b of shape
(M, S, S, C) and (P,) int32 object indices; the result is (P, S/2, S/2, C).

On a CUDA tensor `pair_pool` launches the hand-written kernel of
csrc/pair_pool.cu (the port of the TPU kernel `_kernel` in
scene_graph_commonsense_tpu/ops/pallas/pair_pool.py) or raises; on a CPU
tensor it runs `pair_pool_plain`, the same function in plain PyTorch.  The
kernel never materializes the two gathered (P, S, S, C) tensors that the
plain version does.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from scene_graph_commonsense_torch.ops import _build

# kernel launches since the last reset (main-path accounting)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_BYTES = 16


def pair_pool_plain(a: torch.Tensor, b: torch.Tensor, si: torch.Tensor,
                    oj: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather, add, 2x2 max pool, relu (NHWC)."""
    s = a[si.long()] + b[oj.long()]                  # (P, S, S, C)
    pooled = F.max_pool2d(s.permute(0, 3, 1, 2), 2)  # NCHW view of NHWC
    return torch.relu(pooled).permute(0, 2, 3, 1)


def check_kernel_inputs(a: torch.Tensor, b: torch.Tensor, si: torch.Tensor,
                        oj: torch.Tensor) -> None:
    """Raises on anything the kernel does not take."""
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"pair_pool takes float32 or bfloat16 streams of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if si.dtype != torch.int32 or oj.dtype != torch.int32:
        raise TypeError(f"pair_pool takes int32 indices, got {si.dtype} "
                        f"and {oj.dtype}")
    if len({t.device for t in (a, b, si, oj)}) != 1:
        raise ValueError("pair_pool inputs lie on different devices")
    if a.dim() != 4 or a.shape != b.shape or a.shape[1] != a.shape[2]:
        raise ValueError(f"pair_pool takes two (M, S, S, C) streams of one "
                         f"shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    if si.dim() != 1 or si.shape != oj.shape:
        raise ValueError("pair_pool takes two (P,) index vectors")
    _, s, _, c = a.shape
    lanes = _VEC_BYTES // a.element_size()
    if s % 2 or c % lanes:
        raise ValueError(f"pair_pool needs an even S and C a multiple of "
                         f"{lanes} for {a.dtype}, got S={s}, C={c}")
    for t in (a, b, si, oj):
        if not t.is_contiguous():
            raise ValueError("pair_pool takes contiguous tensors")


def _library():
    lib = _build.load("pair_pool")
    fn = lib.sgc_pair_pool
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
    return fn


def pair_pool_kernel(a: torch.Tensor, b: torch.Tensor, si: torch.Tensor,
                     oj: torch.Tensor) -> torch.Tensor:
    """Launches csrc/pair_pool.cu on the current stream of the inputs'
    device and counts the launch."""
    global launches
    check_kernel_inputs(a, b, si, oj)
    if a.device.type != "cuda":
        raise ValueError(f"pair_pool_kernel needs CUDA tensors, got "
                         f"{a.device}")
    m, s, _, c = a.shape
    p = si.shape[0]
    out = torch.empty((p, s // 2, s // 2, c), dtype=a.dtype,
                      device=a.device)
    if p == 0:
        return out
    fn = _library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), si.data_ptr(), oj.data_ptr(),
             out.data_ptr(), m, s, c, p, _DTYPE_CODES[a.dtype],
             a.device.index, stream)
    if err != 0:
        raise RuntimeError(f"pair_pool kernel launch failed: cudaError {err}")
    launches += 1
    return out


def pair_pool(a: torch.Tensor, b: torch.Tensor, si: torch.Tensor,
              oj: torch.Tensor) -> torch.Tensor:
    """relu(maxpool2(a[si] + b[oj])): the kernel on CUDA tensors, the plain
    version on CPU tensors, an error anywhere else."""
    if a.device.type == "cuda":
        return pair_pool_kernel(a, b, si, oj)
    if a.device.type == "cpu":
        return pair_pool_plain(a, b, si, oj)
    raise ValueError(f"pair_pool has no path for device {a.device}")
