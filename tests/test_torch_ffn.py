"""The plain version of the port's fused FFN + residual + LayerNorm kernel
(ops/ffn.ffn_ln_plain, what the CUDA kernel is held against on the card)
against the JAX package's Pallas kernel `fused_ffn_ln` in interpret mode, on
the CPU.

Tolerances: float32 atol and rtol 2e-6; bfloat16 compute: the port's largest
error against a float64 truth (no intermediate rounding, the same rounded
weights) is at most 2x the JAX kernel's.

The kernel's weight layout (`kernel_weights`, which EncoderLayer builds once
per compute dtype) holds the JAX weights' values bit for bit, and the bf16
CUDA kernel's arrangement (128-token tiles of two 64-row warpgroups, F in
chunks of 64, its K-major operands, the LayerNorm statistics over each
row's quad of lanes) is emulated in float64 against the plain version
within 1e-8 (sums of 256 and F products in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_graph_commonsense_torch.models.detr import EncoderLayer

from scene_graph_commonsense_tpu.ops.pallas.ffn import (
    fused_ffn_ln as jax_fused_ffn_ln)
from scene_graph_commonsense_torch.ops import ffn as tffn


def _args(seed, n, d, f):
    """x, w1, b1, w2, b2, gamma, beta as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.standard_normal((n, d)),
        rng.standard_normal((d, f)) / np.sqrt(d), rng.standard_normal(f),
        rng.standard_normal((f, d)) / np.sqrt(f), rng.standard_normal(d),
        1 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d))]


def _jax(args, cd):
    out = jax_fused_ffn_ln(*map(jnp.asarray, args), compute_dtype=cd,
                           block_t=128, interpret=True)
    assert out.dtype == jnp.float32
    return np.asarray(out)


def _port(args, cd):
    out = tffn.fused_ffn_ln(*map(torch.from_numpy, args), compute_dtype=cd)
    assert out.dtype == torch.float32
    return out.numpy()


def _truth(args, cd):
    x, w1, b1, w2, b2, g, beta = (a.astype(np.float64) for a in args)
    w1, w2 = (w.astype(cd).astype(np.float64) for w in (w1, w2))
    y = x + np.maximum(x @ w1 + b1, 0) @ w2 + b2
    mu = y.mean(-1, keepdims=True)
    var = ((y - mu) ** 2).mean(-1, keepdims=True)
    return (y - mu) / np.sqrt(var + 1e-5) * g + beta


def test_torch_ffn_plain_matches_pallas_f32():
    args = _args(0, 256, 128, 512)
    np.testing.assert_allclose(_port(args, torch.float32),
                               _jax(args, jnp.float32), atol=2e-6, rtol=2e-6)


def test_torch_ffn_plain_bf16_error_within_2x_pallas():
    args = _args(1, 256, 64, 256)
    truth = _truth(args, jnp.bfloat16)
    jax_err = np.abs(_jax(args, jnp.bfloat16) - truth).max()
    port_err = np.abs(_port(args, torch.bfloat16) - truth).max()
    assert 0 < jax_err < 0.1
    assert port_err <= 2 * jax_err, (port_err, jax_err)


def test_torch_ffn_routes_by_device():
    args = [torch.from_numpy(a) for a in _args(2, 32, 256, 64)]
    with pytest.raises(ValueError, match="needs CUDA"):
        tffn.ffn_ln_kernel(*args)
    with pytest.raises(ValueError, match="no path"):
        tffn.fused_ffn_ln(*[a.to("meta") for a in args],
                          compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        tffn.check_kernel_inputs(args[0], args[1][:, :48].contiguous(),
                                 args[2][:48], args[3][:48].contiguous(),
                                 *args[4:])
    with pytest.raises(ValueError, match=r"\(N, 256\)"):
        tffn.check_kernel_inputs(args[0][:, :128].contiguous(), *args[1:])
    before = tffn.launches
    tffn.fused_ffn_ln(*args, compute_dtype=torch.bfloat16)
    assert tffn.launches == before           # the plain version counts none


def _bits(a):
    """The raw bits of a torch tensor or an array (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy().view(np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_ffn_kernel_weights_hold_jax_values(dtype):
    """kernel_weights of the compute-dtype weights, and EncoderLayer's
    cached copy of them, hold the JAX package's cast weights bit for bit:
    bf16 as W1^T and W2^T, float32 in the flax layout."""
    _, w1, _, w2, *_ = _args(3, 8, 256, 128)
    cd = getattr(torch, dtype)
    jw1, jw2 = (jnp.asarray(w).astype(jnp.dtype(dtype)) for w in (w1, w2))
    want = (jw1.T, jw2.T) if dtype == "bfloat16" else (jw1, jw2)
    got = tffn.kernel_weights(torch.from_numpy(w1).to(cd),
                              torch.from_numpy(w2).to(cd))
    layer = EncoderLayer(256, 8, 128, dtype=cd, flash=True)
    with torch.no_grad():
        layer.linear1.weight.copy_(torch.from_numpy(w1.T.copy()))
        layer.linear2.weight.copy_(torch.from_numpy(w2.T.copy()))
    for prep in (got, layer.ffn_weights()):
        for g, w in zip(prep, want):
            assert g.dtype == cd and g.is_contiguous()
            assert tuple(g.shape) == w.shape
            np.testing.assert_array_equal(_bits(g), _bits(w))


def test_torch_encoder_layer_ffn_weights_cached_until_load():
    layer = EncoderLayer(256, 8, 128, dtype=torch.bfloat16, flash=True)
    first = layer.ffn_weights()
    assert layer.ffn_weights() is first
    sd = {k: torch.randn_like(v) for k, v in layer.state_dict().items()}
    layer.load_state_dict(sd)
    again = layer.ffn_weights()
    assert again is not first
    assert torch.equal(again[0], sd["linear1.weight"].to(torch.bfloat16))
    assert torch.equal(again[1], sd["linear2.weight"].to(torch.bfloat16))


def test_torch_ffn_prepared_weights_checked_and_plain_unchanged():
    args = [torch.from_numpy(a) for a in _args(4, 48, 256, 192)]
    x, w1, b1, w2, b2, g, beta = args
    w1c, w2c = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    prep = tffn.kernel_weights(w1c, w2c)
    tffn.check_kernel_inputs(x, w1c, b1, w2c, b2, g, beta, prep)
    with pytest.raises(ValueError, match="kernel_weights"):
        tffn.check_kernel_inputs(x, w1c, b1, w2c, b2, g, beta, (w1c, w2c))
    with pytest.raises(ValueError, match="contiguous"):
        tffn.check_kernel_inputs(x, w1c, b1, w2c, b2, g, beta,
                                 (prep[0], w2c.t()))
    # on the CPU the plain version reads w1 and w2 either way
    want = tffn.fused_ffn_ln(*args, compute_dtype=torch.bfloat16)
    got = tffn.fused_ffn_ln(x, w1.t().contiguous().t(), b1, w2, b2, g, beta,
                            compute_dtype=torch.bfloat16, prepared=prep)
    assert torch.equal(got, want)


def _emulate_hopper(x, w1, b1, w2, b2, g, beta, eps=1e-5):
    """ffn_ln_hopper's arrangement in float64: blocks of HOPPER_ROWS
    tokens, each warpgroup's 64 rows (zero past N) through F in chunks of
    FF_CHUNK, h = x (W1^T rows of the chunk)^T with b1 and ReLU, y += h
    (W2^T columns of the chunk)^T; then (y + b2) + x and the row
    statistics from the partial sums of the 4 lanes holding a row (lane q:
    columns 8 j + 2 q and 8 j + 2 q + 1)."""
    w1t, w2t = w1.t(), w2.t()               # the kernel's K-major operands
    n, d = x.shape
    f = w1t.shape[0]
    per = tffn.HOPPER_ROWS // tffn.HOPPER_WARPGROUPS
    tiles = -(-n // tffn.HOPPER_ROWS)
    out = torch.full((n, d), float("nan"), dtype=torch.float64)
    for r0 in range(0, tiles * tffn.HOPPER_ROWS, per):
        live = max(0, min(per, n - r0))
        xt = torch.zeros((per, d), dtype=torch.float64)
        xt[:live] = x[r0:r0 + live]
        y = torch.zeros((per, d), dtype=torch.float64)
        for f0 in range(0, f, tffn.FF_CHUNK):
            h = torch.relu(xt @ w1t[f0:f0 + tffn.FF_CHUNK].t()
                           + b1[f0:f0 + tffn.FF_CHUNK])
            y = y + h @ w2t[:, f0:f0 + tffn.FF_CHUNK].t()
        y = (y + b2) + xt
        quads = y.reshape(per, d // 8, 4, 2)    # (row, block j, lane q, pair)
        mu = quads.sum(dim=(1, 3)).sum(1, keepdim=True) / d
        dev = (y - mu).reshape(per, d // 8, 4, 2)
        var = (dev * dev).sum(dim=(1, 3)).sum(1, keepdim=True) / d
        res = (y - mu) * (1.0 / torch.sqrt(var + eps)) * g + beta
        out[r0:r0 + live] = res[:live]
    return out


@pytest.mark.parametrize("n,f", [(1, 64), (150, 192), (300, 320),
                                 (256, 128)])
def test_torch_ffn_hopper_arrangement_matches_plain(n, f):
    """N below one tile, past one tile with a partial warpgroup, two tiles
    and a partial one, and whole tiles; F of one chunk and of odd chunk
    counts."""
    args = [torch.from_numpy(a.astype(np.float64))
            for a in _args(5, n, 256, f)]
    got = _emulate_hopper(*args)
    want = tffn.ffn_ln_plain(*args, compute_dtype=torch.float64)
    assert got.shape == want.shape
    assert not torch.isnan(got).any()
    assert (got - want).abs().max().item() <= 1e-8
