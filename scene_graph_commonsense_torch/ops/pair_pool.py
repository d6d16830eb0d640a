"""Fused pair assembly: gather + add + 2x2 maxpool + ReLU, and its gradient.

out[p] = relu(maxpool2(a[si[p]] + b[oj[p]])) for NHWC streams a, b of shape
(M, S, S, C) and (P,) int32 object indices; the result is (P, S/2, S/2, C).

Three kernels of csrc/pair_pool.cu, each with a plain PyTorch version of the
same function beside it and its own launch count:

  pair_pool_kernel      / pair_pool_plain      (`launches`)
      the forward; ports `_kernel` of
      scene_graph_commonsense_tpu/ops/pallas/pair_pool.py;
  pair_pool_idx_kernel  / pair_pool_idx_plain  (`idx_launches`)
      the forward that also returns the int8 winning window slot; ports
      `_kernel_idx`;
  pair_pool_bwd_kernel  / pair_pool_bwd_plain  (`bwd_launches`)
      the backward; ports `_pair_pool_bwd`.

`pair_pool` is what callers use.  It is differentiable in a and b: with a
gradient in flight it runs the forward with index and, in the backward, the
backward kernel (the custom VJP of the JAX package); otherwise it runs the
index-free forward.  Each wrapper launches its kernel on CUDA tensors or
raises, and runs the plain version on CPU tensors; it never falls back.  The
kernels never materialize the gathered (P, S, S, C) tensors that the plain
versions do.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from scene_graph_commonsense_torch.ops import _build

# kernel launches since the last reset (main-path accounting), one count
# per kernel
launches = 0          # pair_pool_kernel
idx_launches = 0      # pair_pool_idx_kernel
bwd_launches = 0      # pair_pool_bwd_kernel

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


def _library(name: str = "sgc_pair_pool", pointers: int = 5,
             ints: int = 6):
    """The ctypes function `name` of csrc/pair_pool.cu: `pointers` buffer
    pointers, `ints` ints, then the stream."""
    fn = getattr(_build.load("pair_pool"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints \
            + [ctypes.c_void_p]
    return fn


def pair_pool_kernel(a: torch.Tensor, b: torch.Tensor, si: torch.Tensor,
                     oj: torch.Tensor) -> torch.Tensor:
    """Launches csrc/pair_pool.cu on the current stream of the inputs'
    device and counts the launch."""
    global launches
    check_kernel_inputs(a, b, si, oj)
    _build.need_cuda("pair_pool_kernel", a)
    m, s, _, c = a.shape
    p = si.shape[0]
    out = torch.empty((p, s // 2, s // 2, c), dtype=a.dtype,
                      device=a.device)
    if p == 0:
        return out
    fn = _library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.check_launch("pair_pool", fn(
        a.data_ptr(), b.data_ptr(), si.data_ptr(), oj.data_ptr(),
        out.data_ptr(), m, s, c, p, _DTYPE_CODES[a.dtype], a.device.index,
        stream))
    launches += 1
    return out


# ---------------------------------------------------------------------------
# Training: the forward with winner index and the backward
# ---------------------------------------------------------------------------

def _windows(x: torch.Tensor) -> torch.Tensor:
    """(P, S, S, C) -> (P, S/2, S/2, C, 4), window slot 2*dy + dx last."""
    p, s, _, c = x.shape
    h = s // 2
    return x.reshape(p, h, 2, h, 2, c).permute(0, 1, 3, 5, 2, 4) \
        .reshape(p, h, h, c, 4)


def pair_pool_idx_plain(a: torch.Tensor, b: torch.Tensor, si: torch.Tensor,
                        oj: torch.Tensor):
    """Plain PyTorch version of the forward with index: (out, idx), out as
    pair_pool_plain, idx the int8 (P, S/2, S/2, C) slot 2*dy + dx of each
    window's maximum, the first one on ties, -1 where the maximum is <= 0.
    The sums are taken in the stream dtype before they are compared."""
    s = _windows(a[si.long()] + b[oj.long()])
    best = s[..., 0]
    win = torch.zeros(best.shape, dtype=torch.int8, device=a.device)
    for w in range(1, 4):
        better = s[..., w] > best
        best = torch.where(better, s[..., w], best)
        win = torch.where(better, torch.tensor(w, dtype=torch.int8,
                                               device=a.device), win)
    live = best > 0
    return (torch.where(live, best, torch.zeros((), dtype=best.dtype,
                                                device=a.device)),
            torch.where(live, win, torch.tensor(-1, dtype=torch.int8,
                                                device=a.device)))


def pair_pool_bwd_plain(g: torch.Tensor, idx: torch.Tensor,
                        si: torch.Tensor, oj: torch.Tensor, m: int):
    """Plain PyTorch version of the backward: g (P, S/2, S/2, C) goes to the
    winning window position of each output element (none where idx is -1),
    then pairs -> objects: ga (M, S, S, C) sums the routed g over the pairs
    of each subject, gb over the pairs of each object.  The sums are taken
    in float32 (or float64 for float64 g) and rounded once to g's dtype, as
    the JAX backward's float32 contraction does."""
    p, h, _, c = g.shape
    acc = torch.promote_types(g.dtype, torch.float32)
    ga = torch.zeros((m, 2 * h, 2 * h, c), dtype=acc, device=g.device)
    gb = torch.zeros_like(ga)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for slot in range(4):
        dy, dx = divmod(slot, 2)
        part = torch.where(idx == slot, g, zero).to(acc)
        ga[:, dy::2, dx::2].index_add_(0, si.long(), part)
        gb[:, dy::2, dx::2].index_add_(0, oj.long(), part)
    return ga.to(g.dtype), gb.to(g.dtype)


def pair_pool_idx_kernel(a: torch.Tensor, b: torch.Tensor, si: torch.Tensor,
                         oj: torch.Tensor):
    """Launches sgc_pair_pool_idx; returns (out, idx) and counts the
    launch."""
    global idx_launches
    check_kernel_inputs(a, b, si, oj)
    _build.need_cuda("pair_pool_idx_kernel", a)
    m, s, _, c = a.shape
    p = si.shape[0]
    out = torch.empty((p, s // 2, s // 2, c), dtype=a.dtype,
                      device=a.device)
    idx = torch.empty(out.shape, dtype=torch.int8, device=a.device)
    if p == 0:
        return out, idx
    fn = _library("sgc_pair_pool_idx", 6, 6)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.check_launch("pair_pool_idx", fn(
        a.data_ptr(), b.data_ptr(), si.data_ptr(), oj.data_ptr(),
        out.data_ptr(), idx.data_ptr(), m, s, c, p, _DTYPE_CODES[a.dtype],
        a.device.index, stream))
    idx_launches += 1
    return out, idx


def pair_lists(si: torch.Tensor, oj: torch.Tensor, m: int):
    """The backward kernel's (object -> pairs) incidence, built with index
    ops on the device: `lists` (2P,) int32 holds the pair numbers grouped by
    object, subjects [0, M) first, then objects [M, 2M) (key oj + M),
    ascending within each object (a stable sort); `offsets` (2M + 1,) int32
    bounds each object's run.  No host synchronisation."""
    p = si.shape[0]
    keys = torch.cat([si, oj + m])
    order = torch.argsort(keys, stable=True)
    bounds = torch.arange(2 * m + 1, dtype=keys.dtype, device=keys.device)
    offsets = torch.searchsorted(keys[order].contiguous(), bounds)
    return offsets.to(torch.int32), (order % p).to(torch.int32)


def pair_pool_bwd_kernel(g: torch.Tensor, idx: torch.Tensor,
                         si: torch.Tensor, oj: torch.Tensor, m: int):
    """Launches sgc_pair_pool_bwd; returns (ga, gb) and counts the
    launch."""
    global bwd_launches
    if g.dtype not in _DTYPE_CODES or idx.dtype != torch.int8:
        raise TypeError(f"pair_pool_bwd takes float32 or bfloat16 g and "
                        f"int8 idx, got {g.dtype} and {idx.dtype}")
    if si.dtype != torch.int32 or oj.dtype != torch.int32:
        raise TypeError("pair_pool_bwd takes int32 indices")
    if len({t.device for t in (g, idx, si, oj)}) != 1:
        raise ValueError("pair_pool_bwd inputs lie on different devices")
    if g.dim() != 4 or idx.shape != g.shape or g.shape[1] != g.shape[2] \
            or si.shape != (g.shape[0],) or oj.shape != si.shape:
        raise ValueError(f"pair_pool_bwd takes g and idx of one (P, h, h, C) "
                         f"shape and (P,) indices, got {tuple(g.shape)}, "
                         f"{tuple(idx.shape)}, {tuple(si.shape)}")
    p, h, _, c = g.shape
    if c % (_VEC_BYTES // g.element_size()) or m < 1:
        raise ValueError(f"pair_pool_bwd needs C a multiple of "
                         f"{_VEC_BYTES // g.element_size()} and M >= 1")
    for t in (g, idx, si, oj):
        if not t.is_contiguous():
            raise ValueError("pair_pool_bwd takes contiguous tensors")
    _build.need_cuda("pair_pool_bwd_kernel", g)
    s = 2 * h
    ga = torch.empty((m, s, s, c), dtype=g.dtype, device=g.device)
    gb = torch.empty_like(ga)
    if p == 0:
        return ga.zero_(), gb.zero_()
    offsets, lists = pair_lists(si, oj, m)
    fn = _library("sgc_pair_pool_bwd", 8, 6)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    _build.check_launch("pair_pool_bwd", fn(
        g.data_ptr(), idx.data_ptr(), si.data_ptr(), oj.data_ptr(),
        offsets.data_ptr(), lists.data_ptr(), ga.data_ptr(), gb.data_ptr(),
        m, s, c, p, _DTYPE_CODES[g.dtype], g.device.index, stream))
    bwd_launches += 1
    return ga, gb


def pair_pool_idx(a, b, si, oj):
    """(out, idx) of the forward with index on a's device."""
    return _build.route("pair_pool_idx", a, pair_pool_idx_kernel,
                        pair_pool_idx_plain)(a, b, si, oj)


def pair_pool_bwd(g, idx, si, oj, m: int):
    """(ga, gb) of the backward on g's device."""
    return _build.route("pair_pool_bwd", g, pair_pool_bwd_kernel,
                        pair_pool_bwd_plain)(g, idx, si, oj, m)


class _PairPool(torch.autograd.Function):
    """The custom VJP of the JAX package's `pair_pool`: the forward keeps
    the winner index, the backward routes g through it."""

    @staticmethod
    def forward(ctx, a, b, si, oj):
        out, idx = pair_pool_idx(a, b, si, oj)
        ctx.save_for_backward(idx, si, oj)
        ctx.m = a.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        idx, si, oj = ctx.saved_tensors
        ga, gb = pair_pool_bwd(g.contiguous(), idx, si, oj, ctx.m)
        return ga, gb, None, None


def pair_pool(a: torch.Tensor, b: torch.Tensor, si: torch.Tensor,
              oj: torch.Tensor) -> torch.Tensor:
    """relu(maxpool2(a[si] + b[oj])), differentiable in a and b.  With a
    gradient in flight (grad mode on and a or b requiring it) the forward
    with index and the backward run; otherwise the index-free forward, so
    that evaluation and serving write no index.  Kernels on CUDA tensors,
    plain versions on CPU tensors, an error anywhere else."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _PairPool.apply(a, b, si, oj)
    return _build.route("pair_pool", a, pair_pool_kernel,
                        pair_pool_plain)(a, b, si, oj)
