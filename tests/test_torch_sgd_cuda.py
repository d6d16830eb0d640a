"""The CUDA optimizer update (csrc/sgd.cu) against its plain PyTorch version,
on the card.

Imports neither JAX nor the repo's conftest, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_sgd_cuda.py

Where there is no card each test skips.  Given the plain version's norm
(handed to the kernels through the norm hook that TP uses) the update is
bit-equal: the kernels round each step as the plain version's operations
do.  The kernels' own norm sums in another order than torch.dot and
torch.sum: relative to the plain norm within NORM_RTOL, the float32
rounding of a sum of up to 268 M squares taken in two different orders
(each ~1e-7 relative per partial sum, a few hundred partial sums deep)."""

import pytest
import torch

from scene_graph_commonsense_torch.ops import sgd as sgd_ops
from scene_graph_commonsense_torch.train import engine
from scene_graph_commonsense_torch.utils import profiling

NORM_RTOL = 1e-5
SIZES = ((1,), (3,), (11,), (15,), (4097,), (64, 129))
LR, MOMENTUM, DECAY = 1e-2, 0.9, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _problem(device, shapes, trace_dtype, seed, missing=()):
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(scale=1.0):
        return {f"t{i}": scale * torch.randn(s, device=device, generator=gen)
                for i, s in enumerate(shapes)}
    params, grads = draw(), draw(0.01)
    traces = {k: v.to(trace_dtype) for k, v in draw(0.1).items()}
    for k in missing:
        grads[k] = None
    return grads, params, traces


def _copy(tree):
    return {k: None if v is None else v.clone() for k, v in tree.items()}


def _squares(grads, params):
    return {k: torch.dot(g.reshape(-1), g.reshape(-1)) if g is not None
            else torch.zeros((), device=params[k].device)
            for k, g in ((k, grads.get(k)) for k in params)}


def _clip_for(mode, grads, params):
    norm = float(torch.stack(list(_squares(grads, params).values()))
                 .sum().sqrt())
    return {"off": 0.0, "under": 2.0 * norm, "firing": 0.5 * norm}[mode]


def _flat_views(grads):
    """Copies of the gradients as views of one flat buffer, end to end, as
    a mesh's all-reduced gradients are."""
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    out, off = {}, 0
    for k, g in grads.items():
        out[k] = flat[off:off + g.numel()].view_as(g)
        off += g.numel()
    return out


def _plain_and_kernel(grads, params, traces, clip, trace_dtype, scale,
                      copy=_copy):
    """Both versions on copies of one problem (`copy` copies the
    gradients), the kernels given the plain version's norm.  Returns (plain
    (params, traces, norm), kernel's, the per-tensor squares the kernels
    handed to the hook, the plain version's)."""
    want_sq = _squares(grads, params)
    total = torch.stack(list(want_sq.values())).sum()
    seen = {}

    def hook(squares):
        seen.update(squares)
        return total
    pp, kp = _copy(params), _copy(params)
    pt, pn = sgd_ops.sgd_plain(copy(grads), pp, traces, LR, MOMENTUM, DECAY,
                               clip, trace_dtype, scale)
    kt, kn = sgd_ops.sgd_kernel(copy(grads), kp, traces, LR, MOMENTUM, DECAY,
                                clip, trace_dtype, scale, sum_squares=hook)
    torch.cuda.synchronize()
    return (pp, pt, pn), (kp, kt, kn), seen, want_sq


@pytest.mark.cuda
@pytest.mark.parametrize("trace_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip_mode", ["off", "under", "firing"])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("missing", [(), ("t2",)])
def test_torch_sgd_kernel_bit_equal_given_the_norm(cuda_device, trace_dtype,
                                                   clip_mode, scaled,
                                                   missing):
    grads, params, traces = _problem(cuda_device, SIZES, trace_dtype, 0,
                                     missing)
    clip = _clip_for(clip_mode, grads, params)
    scale = torch.tensor(0.37, device=cuda_device) if scaled else None
    old = _copy(traces)
    (pp, pt, pn), (kp, kt, kn), seen, want_sq = _plain_and_kernel(
        grads, params, traces, clip, trace_dtype, scale)
    for k in params:
        assert torch.equal(kp[k], pp[k]), k
        assert kt[k].dtype == trace_dtype
        assert torch.equal(kt[k], pt[k]), k
        assert torch.equal(traces[k], old[k]), k      # the old state stays
    if clip_mode == "off":
        assert kn is None and pn is None and not seen
    else:
        assert torch.equal(kn, pn)
        for k in params:
            torch.testing.assert_close(seen[k], want_sq[k], rtol=NORM_RTOL,
                                       atol=0)


@pytest.mark.cuda
def test_torch_sgd_kernel_norm_and_determinism(cuda_device):
    """The kernels' own norm (no hook) against the plain version's, and the
    same bits from run to run."""
    grads, params, traces = _problem(cuda_device, SIZES, torch.float32, 1)
    clip = _clip_for("firing", grads, params)
    _, want = sgd_ops.sgd_plain(_copy(grads), _copy(params), traces, LR,
                                MOMENTUM, DECAY, clip, torch.float32)
    norms = []
    for _ in range(2):
        _, norm = sgd_ops.sgd_kernel(_copy(grads), _copy(params), traces, LR,
                                     MOMENTUM, DECAY, clip, torch.float32)
        norms.append(norm.clone())
    torch.cuda.synchronize()
    torch.testing.assert_close(norms[0], want, rtol=NORM_RTOL, atol=0)
    assert torch.equal(norms[0], norms[1])


@pytest.mark.cuda
def test_torch_sgd_kernel_fc1(cuda_device):
    """fc1.weight's 4096 x 65536 beside fc3_2.bias's 11, clip firing: the
    update bit-equal given the norm, the squares and the kernels' own norm
    within NORM_RTOL."""
    shapes = ((4096, 65536), (11,))
    grads, params, traces = _problem(cuda_device, shapes, torch.float32, 2)
    clip = _clip_for("firing", grads, params)
    (pp, pt, pn), (kp, kt, kn), seen, want_sq = _plain_and_kernel(
        grads, params, traces, clip, torch.float32, None)
    for k in params:
        assert torch.equal(kp[k], pp[k]) and torch.equal(kt[k], pt[k]), k
        torch.testing.assert_close(seen[k], want_sq[k], rtol=NORM_RTOL,
                                   atol=0)
    del pp, pt, kp, kt
    _, own = sgd_ops.sgd_kernel(_copy(grads), _copy(params), traces, LR,
                                MOMENTUM, DECAY, clip, torch.float32)
    torch.testing.assert_close(own, pn, rtol=NORM_RTOL, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("trace_dtype", [torch.float32, torch.bfloat16])
def test_torch_sgd_kernel_splits_long_lists(cuda_device, trace_dtype):
    """More tensors than a launch takes: one launch of each kernel per
    table, the norm summed over every table."""
    per = sgd_ops.max_tensors()
    shapes = [(1 + (7 * i) % 300,) for i in range(2 * per + 3)]
    grads, params, traces = _problem(cuda_device, shapes, trace_dtype, 3)
    clip = _clip_for("firing", grads, params)
    before = (sgd_ops.norm_launches, sgd_ops.update_launches)
    (pp, pt, pn), (kp, kt, kn), seen, want_sq = _plain_and_kernel(
        grads, params, traces, clip, trace_dtype, None)
    assert (sgd_ops.norm_launches - before[0],
            sgd_ops.update_launches - before[1]) == (3, 3)
    for k in params:
        assert torch.equal(kp[k], pp[k]) and torch.equal(kt[k], pt[k]), k
        torch.testing.assert_close(seen[k], want_sq[k], rtol=NORM_RTOL,
                                   atol=0)
    _, own = sgd_ops.sgd_kernel(_copy(grads), _copy(params), traces, LR,
                                MOMENTUM, DECAY, clip, trace_dtype)
    torch.testing.assert_close(own, pn, rtol=NORM_RTOL, atol=0)


@pytest.mark.cuda
def test_torch_sgd_kernel_unaligned_views(cuda_device):
    """Gradients as views of one flat buffer at offsets that are not
    16-byte aligned (a mesh's all-reduced gradients): the scalar path,
    bit-equal given the norm, and the same norm as aligned gradients."""
    grads, params, traces = _problem(cuda_device, SIZES, torch.float32, 4)
    views = _flat_views(grads)
    assert any(g.data_ptr() % 16 for g in views.values())
    clip = _clip_for("firing", grads, params)
    (pp, pt, _), (kp, kt, _), _, _ = _plain_and_kernel(
        grads, params, traces, clip, torch.float32, None, copy=_flat_views)
    for k in params:
        assert torch.equal(kp[k], pp[k]) and torch.equal(kt[k], pt[k]), k
    # the kernels' own norm: the same bits wherever the gradients lie
    norms = [sgd_ops.sgd_kernel(copy(grads), _copy(params), traces, LR,
                                MOMENTUM, DECAY, clip, torch.float32)[1]
             .clone() for copy in (_copy, _flat_views)]
    assert torch.equal(norms[0], norms[1])


@pytest.mark.cuda
@pytest.mark.parametrize("momentum_dtype", ["float32", "bfloat16"])
def test_torch_sgd_update_on_the_card(cuda_device, momentum_dtype):
    """engine.SGD.update on the card: two launches, one sgd_fused and no
    host synchronisation inside train.optimizer with the recorder on; the
    grads consumed (a float32 trace is the gradient's buffer)."""
    grads, params, traces = _problem(cuda_device, SIZES,
                                     getattr(torch, momentum_dtype), 5)
    opt = engine.make_optimizer(LR, grad_clip_norm=1e-3,
                                momentum_dtype=momentum_dtype)
    state = engine.SGDState(traces, 0)
    state = opt.update(_copy(grads), state, params)     # builds, allocates
    torch.cuda.synchronize()
    before = (sgd_ops.norm_launches, sgd_ops.update_launches)
    profiling.enable()
    try:
        profiling.reset()
        new = opt.update(grads, state, params)
        torch.cuda.synchronize()
        spans = profiling.collect()
    finally:
        profiling.disable()
    assert (sgd_ops.norm_launches - before[0],
            sgd_ops.update_launches - before[1]) == (1, 1)
    opt_spans = [s for s in spans if s.name == "train.optimizer"]
    assert len(opt_spans) == 1
    assert opt_spans[0].counts == {"sgd_fused": 1}
    assert new.count == 2
    if momentum_dtype == "float32":
        for k, g in grads.items():
            assert new.trace[k].data_ptr() == g.data_ptr(), k


@pytest.mark.cuda
def test_torch_sgd_kernel_rejects_float64(cuda_device):
    grads, params, traces = _problem(cuda_device, SIZES, torch.float32, 6)
    params = {k: v.double() for k, v in params.items()}
    with pytest.raises(TypeError):
        sgd_ops.sgd_update(grads, params, traces, LR, MOMENTUM, DECAY, 1.0,
                           torch.float32)
