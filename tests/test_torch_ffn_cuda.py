"""The CUDA FFN + residual + LayerNorm kernels (csrc/ffn.cu) against their
plain PyTorch version, on the card: N below one 128-token tile (1, 80), not
a multiple of it (129, 12288 + 64 + 7), the parity phase's 512 tokens per
image and the DETR encoder's 12 and 24 images of 1024 tokens; F of one
64-column chunk, of an odd number of chunks (192, 320) and 2048.

Imports neither JAX nor the repo's conftest, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_ffn_cuda.py

Where there is no card each test skips.  Tolerances: float32 within 5e-5
(absolute and relative) of the plain version (sums of 256 and 2048 products
in another order, then the LayerNorm's division by the row's deviation).
bfloat16 compute, against a float64 truth with the same bf16 weights and
roundings of x and h and exact sums:
  * at F = 2048 (the encoder's), the kernel's largest error is at most 2x
    the plain version's.  Not less: the kernel sums on the tensor cores,
    whose float32 accumulation is not rounded to nearest at each addition,
    so some h land on the other side of a bf16 rounding midpoint than the
    plain version's float32 sums put them; the largest error is set by
    which values round the other way (0.52x to 1.62x of the plain
    version's at these shapes on an H100);
  * at every shape, F = 64, 128, 192 and 320 too, where the plain version
    rounds so few h the other way that the ratio measures nothing (the
    kernel's largest error was 41x the plain version's at F = 64, 1.6e-3
    against 3.8e-5), each output within a rounding allowance: what rounding
    h the other way can move it wherever the exact sum lies within 2^-16
    of its terms' magnitude of a bf16 midpoint, plus the same share of y's
    terms (float32 sums in any order), through the LayerNorm.  It is a
    worst case (~0.005-0.04, 10-40x the errors seen) that holds the plain
    version too; a lost chunk, bias slice or row moves outputs by O(1);
  * a partial tile's rows equal bit for bit the same rows of a launch over
    whole tiles (the kernel computes each row on its own).
The kernel on prepared weights (ops/ffn.kernel_weights, as EncoderLayer
keeps them) gives the same bits as with the layout built per call."""

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


# the rounding allowance's share of a sum's terms (see the docstring)
REL = 2.0 ** -16


def _ulp_bf16(v):
    _, e = torch.frexp(v)
    return torch.ldexp(torch.ones_like(v), e - 8)


def _allowance(x, w1, b1, w2, b2, g, cd):
    """Per output: how far rounding h (and summing in float32) can move it
    from the float64 truth."""
    f64 = torch.float64
    xc, w1c, w2c = (t.to(cd).to(f64) for t in (x, w1, w2))
    pre = xc @ w1c + b1.to(f64)
    slack = REL * (xc.abs() @ w1c.abs() + b1.to(f64).abs())
    r = pre.clamp_min(0)
    ulp = _ulp_bf16(r + slack)
    frac = r / ulp
    near = ((frac - frac.floor() - 0.5).abs() * ulp <= slack) \
        | (pre.abs() <= slack)
    h = r.to(cd).to(f64)
    dy = torch.where(near, ulp + slack, torch.zeros_like(ulp)) @ w2c.abs() \
        + REL * (h @ w2c.abs() + b2.to(f64).abs() + x.to(f64).abs())
    y = h @ w2c + b2.to(f64) + x.to(f64)
    std = y.std(-1, unbiased=False, keepdim=True)
    return 2 * g.to(f64).abs() * (dy + dy.max(-1, keepdim=True)[0]) / std \
        + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,f", [(80, 128), (512, 2048), (12288, 2048),
                                 (12288 + 64 + 7, 2048), (24576, 2048)])
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
@pytest.mark.parametrize("n,f", [(1, 2048), (80, 128), (129, 192),
                                 (200, 64), (300, 320), (2048, 64),
                                 (4096, 192), (12288, 2048)])
def test_torch_ffn_kernel_bf16_within_rounding_allowance(cuda_device, n, f):
    args = _args(cuda_device, n, f)
    got = tffn.fused_ffn_ln(*args, compute_dtype=torch.bfloat16)
    x, w1, b1, w2, b2, g, beta = args
    want = tffn.ffn_ln_plain(x, w1.to(torch.bfloat16), b1,
                             w2.to(torch.bfloat16), b2, g, beta,
                             compute_dtype=torch.bfloat16)
    truth = _truth(*args, torch.bfloat16)
    allow = _allowance(x, w1, b1, w2, b2, g, torch.bfloat16)
    # the allowance holds the plain version too
    assert ((want.double() - truth).abs() <= allow).all()
    over = (got.double() - truth).abs() / allow
    assert over.max().item() <= 1, over.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,f", [(1, 2048), (129, 192), (200, 64),
                                 (300, 320)])
def test_torch_ffn_kernel_partial_tile_rows_as_in_whole_tiles(
        cuda_device, n, f, dtype):
    cd = getattr(torch, dtype)
    args = _args(cuda_device, -(-n // 256) * 256 + 256, f, seed=3)
    full = tffn.fused_ffn_ln(*args, compute_dtype=cd)
    part = tffn.fused_ffn_ln(args[0][:n].contiguous(), *args[1:],
                             compute_dtype=cd)
    torch.cuda.synchronize()
    assert part.shape == (n, 256)
    assert torch.equal(part, full[:n])


@pytest.mark.cuda
def test_torch_ffn_kernel_rejects_what_it_does_not_take(cuda_device):
    x, w1, b1, w2, b2, g, beta = _args(cuda_device, 64, 64)
    with pytest.raises(TypeError):
        tffn.ffn_ln_kernel(x.double(), w1, b1, w2, b2, g, beta)
    with pytest.raises(ValueError, match="contiguous"):
        tffn.ffn_ln_kernel(x, w2.t(), b1, w1.t(), b2, g, beta)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,f", [(80, 192), (12288, 2048)])
def test_torch_ffn_kernel_prepared_weights_same_bits(cuda_device, n, f,
                                                     dtype):
    cd = getattr(torch, dtype)
    x, w1, b1, w2, b2, g, beta = _args(cuda_device, n, f, seed=1)
    w1c, w2c = w1.to(cd), w2.to(cd)
    prep = tffn.kernel_weights(w1c, w2c)
    got = tffn.fused_ffn_ln(x, w1.t().contiguous().t(), b1, w2, b2, g, beta,
                            compute_dtype=cd, prepared=prep)
    want = tffn.fused_ffn_ln(x, w1, b1, w2, b2, g, beta, compute_dtype=cd)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
