"""The CUDA FFN + residual + LayerNorm kernel (csrc/ffn.cu) against its
plain PyTorch version, on the card, at a small shape and at the DETR
encoder's (N = 12 * 1024 tokens, D = 256, F = 2048).

Imports neither JAX nor the repo's conftest, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_ffn_cuda.py

Where there is no card each test skips.  Tolerances: float32 within 5e-5
(absolute and relative) of the plain version (sums of 256 and 2048 products
in another order, then the LayerNorm's division by the row's deviation);
bfloat16 compute: the kernel's largest error against a float64 truth (same
bf16 weights and roundings of x and h, exact sums) is at most 2x the plain
version's."""

import numpy as np
import pytest
import torch

from scene_graph_commonsense_torch.ops import ffn as tffn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(device, n, f, seed=0):
    rng = np.random.default_rng(seed)
    d = 256
    arrays = (rng.standard_normal((n, d)),
              rng.standard_normal((d, f)) / np.sqrt(d), rng.standard_normal(f),
              rng.standard_normal((f, d)) / np.sqrt(f), rng.standard_normal(d),
              1 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


def _truth(x, w1, b1, w2, b2, g, beta, cd):
    f64 = torch.float64
    xc = x.to(cd).to(f64)
    h = torch.relu(xc @ w1.to(cd).to(f64) + b1.to(f64)).to(cd).to(f64)
    y = h @ w2.to(cd).to(f64) + b2.to(f64) + x.to(f64)
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    return (y - mu) / torch.sqrt(var + 1e-5) * g.to(f64) + beta.to(f64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,f", [(80, 128), (12288, 2048)])
def test_torch_ffn_kernel_matches_plain(cuda_device, n, f, dtype):
    cd = getattr(torch, dtype)
    args = _args(cuda_device, n, f)
    before = tffn.launches
    got = tffn.fused_ffn_ln(*args, compute_dtype=cd)
    torch.cuda.synchronize()
    assert tffn.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (n, 256)
    x, w1, b1, w2, b2, g, beta = args
    want = tffn.ffn_ln_plain(x, w1.to(cd), b1, w2.to(cd), b2, g, beta,
                             compute_dtype=cd)
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-5)
    else:
        truth = _truth(*args, cd)
        err = (got.double() - truth).abs().max().item()
        plain_err = (want.double() - truth).abs().max().item()
        assert err <= 2 * plain_err + 1e-6, (err, plain_err)


@pytest.mark.cuda
def test_torch_ffn_kernel_rejects_what_it_does_not_take(cuda_device):
    x, w1, b1, w2, b2, g, beta = _args(cuda_device, 64, 64)
    with pytest.raises(TypeError):
        tffn.ffn_ln_kernel(x.double(), w1, b1, w2, b2, g, beta)
    with pytest.raises(ValueError, match="contiguous"):
        tffn.ffn_ln_kernel(x, w2.t(), b1, w1.t(), b2, g, beta)
