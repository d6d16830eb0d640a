"""The CUDA pair-pool kernel against its plain PyTorch version, on the card.

Imports neither JAX nor the repo's conftest, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_pair_pool_cuda.py

Where there is no card each test skips.  Equality is exact: the kernel adds
and maxes in float32 and rounds once, which equals the plain version's
rounding of each sum (rounding is monotone)."""

import numpy as np
import pytest
import torch

from scene_graph_commonsense_torch.ops import pair_pool as tpp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(device, dtype, m, s, c, p, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, s, s, c), np.float32))
    b = torch.from_numpy(rng.standard_normal((m, s, s, c), np.float32))
    si = torch.from_numpy(rng.integers(0, m, p).astype(np.int32))
    oj = torch.from_numpy(rng.integers(0, m, p).astype(np.int32))
    return [a.to(device, dtype), b.to(device, dtype), si.to(device),
            oj.to(device)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(20, 32, 64, 300), (3, 6, 8, 5)])
def test_torch_pair_pool_kernel_matches_plain(cuda_device, dtype, shape):
    args = _inputs(cuda_device, getattr(torch, dtype), *shape)
    before = tpp.launches
    got = tpp.pair_pool(*args)
    torch.cuda.synchronize()
    assert tpp.launches == before + 1
    assert got.shape == (shape[3], shape[1] // 2, shape[1] // 2, shape[2])
    assert torch.equal(got, tpp.pair_pool_plain(*args))


@pytest.mark.cuda
def test_torch_pair_pool_kernel_rejects_float64(cuda_device):
    args = _inputs(cuda_device, torch.float64, 3, 4, 8, 2)
    with pytest.raises(TypeError):
        tpp.pair_pool(*args)
