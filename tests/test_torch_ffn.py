"""The plain version of the port's fused FFN + residual + LayerNorm kernel
(ops/ffn.ffn_ln_plain, what the CUDA kernel is held against on the card)
against the JAX package's Pallas kernel `fused_ffn_ln` in interpret mode, on
the CPU.

Tolerances: float32 atol and rtol 2e-6; bfloat16 compute: the port's largest
error against a float64 truth (no intermediate rounding, the same rounded
weights) is at most 2x the JAX kernel's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
