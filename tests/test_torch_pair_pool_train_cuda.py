"""The pair pool's training kernels (forward with winner index, backward)
against their plain PyTorch versions, on the card.

Imports neither JAX nor the repo's conftest, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_pair_pool_train_cuda.py

Where there is no card each test skips.  out and idx must equal the plain
version exactly; the gradients must lie within float32 rounding of the
plain version's float32 sums (which the card takes with atomics, in another
order): 1e-6 times the sums of |g|, plus one bfloat16 ulp in bfloat16.  The
backward kernel itself sums in a fixed order, so two runs agree bit for
bit."""

import numpy as np
import pytest
import torch

from scene_graph_commonsense_torch.ops import pair_pool as tpp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, dtype, m, s, c, p, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, s, s, c), np.float32))
    b = torch.from_numpy(rng.standard_normal((m, s, s, c), np.float32))
    si = torch.from_numpy(rng.integers(0, m, p).astype(np.int32))
    oj = torch.from_numpy(rng.integers(0, m, p).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((p, s // 2, s // 2, c),
                                             np.float32))
    return [a.to(device, dtype), b.to(device, dtype), si.to(device),
            oj.to(device), g.to(device, dtype)]


def _ulp_bf16(x):
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


SHAPES = [(20, 32, 64, 300), (3, 6, 8, 5), (6, 4, 16, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_torch_pair_pool_idx_kernel_matches_plain(cuda_device, dtype, shape):
    a, b, si, oj, _ = _inputs(cuda_device, getattr(torch, dtype), *shape)
    before = tpp.idx_launches
    out, idx = tpp.pair_pool_idx(a, b, si, oj)
    torch.cuda.synchronize()
    assert tpp.idx_launches == before + 1
    want_out, want_idx = tpp.pair_pool_idx_plain(a, b, si, oj)
    assert torch.equal(out, want_out) and torch.equal(idx, want_idx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_torch_pair_pool_bwd_kernel_matches_plain(cuda_device, dtype, shape):
    a, b, si, oj, g = _inputs(cuda_device, getattr(torch, dtype), *shape)
    m = shape[0]
    _, idx = tpp.pair_pool_idx_plain(a, b, si, oj)
    before = tpp.bwd_launches
    got = tpp.pair_pool_bwd(g, idx, si, oj, m)
    again = tpp.pair_pool_bwd(g, idx, si, oj, m)
    torch.cuda.synchronize()
    assert tpp.bwd_launches == before + 2
    want = tpp.pair_pool_bwd_plain(g, idx, si, oj, m)
    mags = tpp.pair_pool_bwd_plain(g.float().abs(), idx, si, oj, m)
    for x, y, w, mag in zip(got, again, want, mags):
        assert torch.equal(x, y)                       # deterministic
        err = (x.float() - w.float()).abs()
        tol = 1e-6 * mag
        if x.dtype == torch.bfloat16:
            tol = tol + _ulp_bf16(torch.maximum(x.float().abs(),
                                                w.float().abs()))
        assert bool((err <= tol).all())


@pytest.mark.cuda
def test_torch_pair_pool_autograd_launches_training_kernels(cuda_device):
    a, b, si, oj, g = _inputs(cuda_device, torch.bfloat16, 8, 8, 16, 12)
    a.requires_grad_()
    b.requires_grad_()
    counts = (tpp.launches, tpp.idx_launches, tpp.bwd_launches)
    out = tpp.pair_pool(a, b, si, oj)
    (out.float() * g.float()).sum().backward()
    with torch.no_grad():
        tpp.pair_pool(a, b, si, oj)
    torch.cuda.synchronize()
    assert (tpp.launches, tpp.idx_launches, tpp.bwd_launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1)
    assert a.grad.dtype == torch.bfloat16 and b.grad.shape == b.shape


@pytest.mark.cuda
def test_torch_pair_pool_training_kernels_reject_float64(cuda_device):
    a, b, si, oj, g = _inputs(cuda_device, torch.float64, 3, 4, 8, 2)
    with pytest.raises(TypeError):
        tpp.pair_pool_idx(a, b, si, oj)
    with pytest.raises(TypeError):
        tpp.pair_pool_bwd(g, torch.zeros(g.shape, dtype=torch.int8,
                                         device=g.device), si, oj, 3)
