"""ops/sgd on the CPU: the plain version against the optimizer loop it came
from, the route to it, the update's contract, and the kernels' input
checks.  The kernels themselves run only on a card
(tests/test_torch_sgd_cuda.py); the optax comparison is
tests/test_torch_train.py::test_torch_sgd_matches_optax."""

import numpy as np
import pytest
import torch

from scene_graph_commonsense_torch.ops import sgd as sgd_ops
from scene_graph_commonsense_torch.train import engine
from scene_graph_commonsense_torch.utils import profiling

SHAPES = {"w": (7, 5), "b": (5,), "one": (1,), "e": (3, 4, 2)}


def _loop_update(grads, params, traces, lr, momentum, weight_decay, clip,
                 trace_dtype, scale=None):
    """engine.SGD.update's per-parameter loop as it stood before ops/sgd:
    the reference the plain version must equal bit for bit."""
    names = list(params)
    g = [grads[k] if grads.get(k) is not None
         else torch.zeros_like(params[k]) for k in names]
    if clip > 0:
        squares = [torch.dot(x.reshape(-1), x.reshape(-1)) for x in g]
        norm = torch.stack(squares).sum().sqrt()
        keep = norm < clip
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        div = torch.where(keep, one, norm)
        mul = torch.where(keep, one, one * clip)
        for x in g:
            x.div_(div.to(x.dtype)).mul_(mul.to(x.dtype))
    step = -lr
    trace = {}
    for k, x in zip(names, g):
        p, old = params[k], traces[k]
        x.add_(weight_decay * p)
        t = x.add_(torch.tensor(momentum, dtype=old.dtype,
                                device=old.device) * old)
        trace[k] = t.to(trace_dtype)
        u = step * t
        if scale is not None:
            u = u * scale.to(u.dtype)
        p.add_(u)
    return trace


def _problem(seed, trace_dtype, missing=()):
    rng = np.random.default_rng(seed)

    def draw():
        return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for k, s in SHAPES.items()}
    params, grads = draw(), draw()
    traces = {k: v.to(trace_dtype) for k, v in draw().items()}
    for k in missing:
        grads[k] = None
    return grads, params, traces


def _copy(tree):
    return {k: None if v is None else v.clone() for k, v in tree.items()}


@pytest.mark.parametrize("trace_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [0.0, 1e3, 1.0])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("missing", [(), ("b",)])
def test_torch_sgd_plain_equals_the_loop(trace_dtype, clip, scaled, missing):
    """Clip off, under its threshold and firing; with and without the
    faithful scale; a missing gradient read as zeros."""
    grads, params, traces = _problem(0, trace_dtype, missing)
    scale = torch.tensor(0.37) if scaled else None
    want_p, want_g = _copy(params), _copy(grads)
    want = _loop_update(want_g, want_p, _copy(traces), 1e-2, 0.9, 1e-4, clip,
                        trace_dtype, scale)
    got, norm = sgd_ops.sgd_plain(grads, params, traces, 1e-2, 0.9, 1e-4,
                                  clip, trace_dtype, scale)
    assert (norm is None) == (clip == 0)
    for k in SHAPES:
        assert torch.equal(params[k], want_p[k]), k
        assert got[k].dtype == trace_dtype
        assert torch.equal(got[k], want[k]), k


def test_torch_sgd_plain_sum_squares_hook():
    """The norm hook (TP's global_sum_squares) gets each parameter's square
    and its sum stands for the unsharded one."""
    grads, params, traces = _problem(1, torch.float32)
    seen = {}

    def hook(squares):
        seen.update(squares)
        return torch.stack(list(squares.values())).sum()
    want_p = _copy(params)
    want, want_norm = sgd_ops.sgd_plain(_copy(grads), want_p, traces, 1e-2,
                                        0.9, 1e-4, 1.0, torch.float32)
    got, norm = sgd_ops.sgd_plain(grads, params, traces, 1e-2, 0.9, 1e-4, 1.0,
                                  torch.float32, sum_squares=hook)
    assert sorted(seen) == sorted(SHAPES)
    assert torch.equal(norm, want_norm)
    for k in SHAPES:
        assert torch.equal(params[k], want_p[k]) and torch.equal(got[k],
                                                                 want[k])


@pytest.mark.parametrize("momentum_dtype", ["float32", "bfloat16"])
def test_torch_sgd_update_on_cpu_takes_the_plain_path(momentum_dtype):
    """SGD.update on CPU tensors: no kernel launch, no sgd_fused count, the
    plain version's result; the grads consumed (a float32 trace is the
    gradient's buffer), the old state's trace left as it was."""
    dtype = getattr(torch, momentum_dtype)
    grads, params, traces = _problem(2, dtype, missing=("e",))
    opt = engine.make_optimizer(1e-2, grad_clip_norm=1.0,
                                momentum_dtype=momentum_dtype)
    state = engine.SGDState(traces, 3)
    old = _copy(traces)
    want_p = _copy(params)
    want, _ = sgd_ops.sgd_plain(_copy(grads), want_p, _copy(traces),
                                opt.lr(3), 0.9, 1e-4, 1.0, dtype)
    launches = (sgd_ops.norm_launches, sgd_ops.update_launches)
    profiling.enable()
    try:
        with profiling.span("train.step"):
            new = opt.update(grads, state, params)
        spans = profiling.collect()
    finally:
        profiling.disable()
    assert (sgd_ops.norm_launches, sgd_ops.update_launches) == launches
    assert all("sgd_fused" not in s.counts for s in spans)
    assert new.count == 4
    for k in SHAPES:
        assert torch.equal(state.trace[k], old[k]), k
        assert torch.equal(params[k], want_p[k]) and torch.equal(
            new.trace[k], want[k]), k
        if dtype == torch.float32 and grads[k] is not None:
            assert new.trace[k].data_ptr() == grads[k].data_ptr(), k


def _bad(case):
    grads, params, traces = _problem(3, torch.float32)
    if case == "float64 weights":
        params = {k: v.double() for k, v in params.items()}
    elif case == "bf16 grad":
        grads["w"] = grads["w"].bfloat16()
    elif case == "trace dtype":
        traces["b"] = traces["b"].bfloat16()
    elif case == "shape":
        grads["w"] = grads["w"].reshape(5, 7)
    elif case == "strided":
        grads["w"] = grads["w"].t().contiguous().t()
    return grads, params, traces


@pytest.mark.parametrize("case,error", [
    ("float64 weights", TypeError), ("bf16 grad", TypeError),
    ("trace dtype", TypeError), ("shape", ValueError),
    ("strided", ValueError)])
def test_torch_sgd_kernel_rejects(case, error):
    """What the kernels do not take raises before any launch: a CUDA path
    never reaches the plain loop."""
    grads, params, traces = _bad(case)
    with pytest.raises(error):
        sgd_ops.check_kernel_inputs(grads, params, traces, torch.float32,
                                    None)
    with pytest.raises(error):
        sgd_ops.sgd_kernel(grads, params, traces, 1e-2, 0.9, 1e-4, 1.0,
                           torch.float32)


def test_torch_sgd_kernel_needs_cuda():
    grads, params, traces = _problem(4, torch.float32)
    sgd_ops.check_kernel_inputs(grads, params, traces, torch.float32, None)
    with pytest.raises(ValueError, match="CUDA"):
        sgd_ops.sgd_kernel(grads, params, traces, 1e-2, 0.9, 1e-4, 1.0,
                           torch.float32)
