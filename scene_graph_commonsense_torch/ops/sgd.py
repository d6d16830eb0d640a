"""The optimizer update of the train step as one multi-tensor pass.

    g  <- g / norm * clip     if clip > 0 and the global norm >= clip
    g  <- g + weight_decay * p
    t' <- g + momentum * t    (t in the trace's dtype)
    p  <- p + (-lr) * t' [* scale]

for every parameter at once: optax.chain(clip_by_global_norm,
add_decayed_weights, sgd(momentum)) as engine.SGD defines it.  Two kernels
of csrc/sgd.cu, with a plain PyTorch version of the same update beside them
and a launch count each:

  sgc_sgd_norm   (`norm_launches`)    the clip's per-tensor sums of squares
                                      and, unsharded, the global norm; only
                                      where the clip is on
  sgc_sgd_update (`update_launches`)  the update, element by element

Each takes up to `max_tensors()` tensors a launch; a longer list takes
several.  `sgd_update` is what callers use: the kernels on CUDA tensors (or
an error), `sgd_plain` on CPU tensors; it never falls back.  The kernels
replace no TPU kernel (XLA fused optax's update into the jitted step); they
exist because the plain version, one PyTorch operation at a time, makes ~10
launches and a host synchronisation a parameter and moves ~80 bytes an
element, where the update needs 24 (csrc/sgd.cu says how they get there).
Given the same norm the two are bit-equal; the kernels' norm sums in another
order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional

import torch

from scene_graph_commonsense_torch.ops import _build
from scene_graph_commonsense_torch.utils import profiling

# kernel launches since the last reset (main-path accounting), one count
# per kernel
norm_launches = 0      # sgd_norm_kernel
update_launches = 0    # sgd_update_kernel

_TRACE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the sum of squares over the unsharded model from each parameter's own
# (tp.global_sum_squares with its mesh and parameters bound)
SumSquares = Callable[[Dict[str, torch.Tensor]], torch.Tensor]


def sgd_plain(grads: Dict[str, Optional[torch.Tensor]],
              params: Dict[str, torch.Tensor],
              traces: Dict[str, torch.Tensor], lr: float, momentum: float,
              weight_decay: float, grad_clip_norm: float, trace_dtype,
              scale: Optional[torch.Tensor] = None,
              sum_squares: Optional[SumSquares] = None):
    """Plain PyTorch version, one parameter at a time.  Consumes `grads`
    (the new float32 trace is the gradient's buffer), updates `params` in
    place and leaves `traces` as they were.  Returns (the new traces, the
    clip's global norm or None)."""
    names = list(params)
    g = [grads[k] if grads.get(k) is not None
         else torch.zeros_like(params[k]) for k in names]
    norm = None
    if grad_clip_norm > 0:
        # optax.global_norm: the square root of the sum of squares of
        # all leaves; the select keeps g bit-exact below the threshold,
        # without a host synchronisation
        squares = [torch.dot(x.reshape(-1), x.reshape(-1)) for x in g]
        if sum_squares is None:
            norm = torch.stack(squares).sum().sqrt()
        else:
            norm = sum_squares(dict(zip(names, squares))).sqrt()
        keep = norm < grad_clip_norm
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        div = torch.where(keep, one, norm)
        mul = torch.where(keep, one, one * grad_clip_norm)
        for x in g:
            x.div_(div.to(x.dtype)).mul_(mul.to(x.dtype))
    step = -lr
    trace = {}
    for k, x in zip(names, g):
        p, old = params[k], traces[k]
        x.add_(weight_decay * p)
        # the momentum constant in the trace's dtype, as JAX types a
        # Python scalar against an array (bf16 0.9 is 0.8984375)
        t = x.add_(torch.tensor(momentum, dtype=old.dtype,
                                device=old.device) * old)
        trace[k] = t.to(trace_dtype)
        u = step * t
        if scale is not None:
            u = u * scale.to(u.dtype)
        p.add_(u)
    return trace, norm


def check_kernel_inputs(grads, params, traces, trace_dtype, scale) -> None:
    """Raises on anything the kernels do not take: float32 parameters and
    gradients (the master weights), traces in `trace_dtype` (float32 or
    bfloat16), each of its parameter's shape, contiguous, on one device."""
    if trace_dtype not in _TRACE_CODES:
        raise TypeError(f"sgd kernels keep a float32 or bfloat16 trace, "
                        f"got {trace_dtype}")
    device = next(iter(params.values())).device
    for k, p in params.items():
        g, t = grads.get(k), traces[k]
        if p.dtype != torch.float32 or (g is not None
                                        and g.dtype != torch.float32):
            raise TypeError(f"sgd kernels take float32 master weights and "
                            f"gradients, got {p.dtype} and "
                            f"{None if g is None else g.dtype} for {k}")
        if t.dtype != trace_dtype:
            raise TypeError(f"sgd kernels: trace {k} is {t.dtype}, the "
                            f"optimizer's is {trace_dtype}")
        for x in (p, g, t):
            if x is None:
                continue
            if x.shape != p.shape or x.device != device:
                raise ValueError(f"sgd kernels: {k}'s gradient or trace "
                                 f"differs from its parameter in shape or "
                                 f"device")
            if not x.is_contiguous():
                raise ValueError(f"sgd kernels take contiguous tensors, "
                                 f"{k} is not")
    if scale is not None and (scale.numel() != 1 or scale.device != device):
        raise ValueError("sgd kernels take a one-element scale on the "
                         "parameters' device")


class Scratch:
    """The norm pass's device buffer, allocated at its first use and kept
    while large enough: one float32 partial sum a tile, one square a
    tensor, the norm, and the integer ticket that elects the block which
    finishes the sums (0 between launches).  One per optimizer: two updates
    in flight on two streams must not share it."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None

    def take(self, floats: int, device) -> torch.Tensor:
        if self.buf is None or self.buf.device != device \
                or self.buf.numel() < floats:
            self.buf = torch.zeros(floats, dtype=torch.float32,
                                   device=device)
        return self.buf


def _library():
    lib = _build.load("sgd")
    if lib.sgc_sgd_update.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        arr = ctypes.POINTER(ctypes.c_void_p)
        sizes = ctypes.POINTER(ctypes.c_longlong)
        for fn in (lib.sgc_sgd_tile, lib.sgc_sgd_max_tensors):
            fn.restype, fn.argtypes = i32, []
        lib.sgc_sgd_norm.restype = i32
        lib.sgc_sgd_norm.argtypes = [arr, sizes, i32, ptr, ptr, ptr, ptr,
                                     i32, ptr]
        lib.sgc_sgd_update.restype = i32
        lib.sgc_sgd_update.argtypes = [arr, arr, arr, arr, sizes, i32, i32,
                                       ptr, f32, ptr, f32, f32, f32, i32,
                                       ptr]
    return lib


def max_tensors() -> int:
    """Tensors a launch of either kernel takes."""
    return _library().sgc_sgd_max_tensors()


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(
        *[None if x is None else x.data_ptr() for x in tensors])


def sgd_kernel(grads: Dict[str, Optional[torch.Tensor]],
               params: Dict[str, torch.Tensor],
               traces: Dict[str, torch.Tensor], lr: float, momentum: float,
               weight_decay: float, grad_clip_norm: float, trace_dtype,
               scale: Optional[torch.Tensor] = None,
               sum_squares: Optional[SumSquares] = None,
               scratch: Optional[Scratch] = None):
    """Launches csrc/sgd.cu on the current stream of the parameters'
    device: the norm pass where grad_clip_norm > 0 (its per-tensor squares
    handed to `sum_squares` where given), then the update.  The same
    contract and result as sgd_plain; the norm returned is a view of
    `scratch` where `sum_squares` is None, valid until the next update
    through it.  Counts the launches and one `sgd_fused`."""
    global norm_launches, update_launches
    check_kernel_inputs(grads, params, traces, trace_dtype, scale)
    names = list(params)
    ps = [params[k] for k in names]
    _build.need_cuda("sgd_kernel", ps[0])
    dev = ps[0].device
    gs = [grads.get(k) for k in names]
    # the new trace: the gradient's buffer where it is float32, as the
    # plain version's in-place adds leave it
    new = [g if g is not None and trace_dtype == torch.float32
           else torch.empty_like(p, dtype=trace_dtype)
           for g, p in zip(gs, ps)]
    lib = _library()
    count = len(names)
    launches = -(-count // lib.sgc_sgd_max_tensors())
    sizes = (ctypes.c_longlong * count)(*[p.numel() for p in ps])
    g_ptrs = _pointers(gs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    norm = None
    if grad_clip_norm > 0:
        tile = lib.sgc_sgd_tile()
        tiles = sum(-(-p.numel() // tile) for p in ps)
        buf = (scratch or Scratch()).take(tiles + count + 2, dev)
        squares = buf[tiles:tiles + count]
        norm_slot = buf[tiles + count:tiles + count + 1]
        ticket = buf[tiles + count + 1:tiles + count + 2]
        _build.check_launch("sgd_norm", lib.sgc_sgd_norm(
            g_ptrs, sizes, count, buf.data_ptr(), squares.data_ptr(),
            ticket.data_ptr(),
            norm_slot.data_ptr() if sum_squares is None else None,
            dev.index, stream))
        norm_launches += launches
        if sum_squares is None:
            norm = norm_slot[0]
        else:
            norm = sum_squares(dict(zip(names, squares.unbind()))).sqrt() \
                .to(torch.float32)
    if scale is not None:
        scale = scale.to(torch.float32).reshape(())
    # the constants as float32, the momentum rounded to the trace's dtype
    # first, as the plain version's constant tensor is
    m = torch.tensor(momentum, dtype=trace_dtype).item()
    _build.check_launch("sgd_update", lib.sgc_sgd_update(
        g_ptrs, _pointers(ps), _pointers([traces[k] for k in names]),
        _pointers(new), sizes, count, _TRACE_CODES[trace_dtype],
        None if norm is None else norm.data_ptr(), grad_clip_norm,
        None if scale is None else scale.data_ptr(), weight_decay, m, -lr,
        dev.index, stream))
    update_launches += launches
    profiling.count("sgd_fused")
    return dict(zip(names, new)), norm


def sgd_update(grads: Dict[str, Optional[torch.Tensor]],
               params: Dict[str, torch.Tensor],
               traces: Dict[str, torch.Tensor], lr: float, momentum: float,
               weight_decay: float, grad_clip_norm: float, trace_dtype,
               scale: Optional[torch.Tensor] = None,
               sum_squares: Optional[SumSquares] = None,
               scratch: Optional[Scratch] = None):
    """(new traces, the clip's norm or None) of one update on the
    parameters' device: the kernels on CUDA, sgd_plain on the CPU."""
    fn = _build.route("sgd", next(iter(params.values())),
                      functools.partial(sgd_kernel, scratch=scratch),
                      sgd_plain)
    return fn(grads, params, traces, lr, momentum, weight_decay,
              grad_clip_norm, trace_dtype, scale, sum_squares)
