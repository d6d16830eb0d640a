"""The plain version of the port's fused attention kernel
(ops/attention.attention_plain, what the CUDA kernel is held against on the
card) against the JAX package's Pallas kernel `fused_attention` in interpret
mode, on the CPU.

Tolerances: float32 atol and rtol 2e-6 (the JAX tests' own bar for the
kernel against the naive math); bfloat16: the port's largest error against
a float64 truth on the same bf16 inputs is at most 2x the JAX kernel's."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_graph_commonsense_tpu.ops.pallas.attention import (
    fused_attention as jax_fused_attention)
from scene_graph_commonsense_torch.ops import attention as tattn

DH = 32
SCALE = 1.0 / math.sqrt(DH)


def _inputs(seed, b, l, h, masked, dtype):
    """q, k, v (B, L, H, dh) float32 numpy arrays rounded to `dtype`, and
    the key mask (B, L) or None."""
    rng = np.random.default_rng(seed)
    qkv = [np.array(jnp.asarray(rng.standard_normal((b, l, h, DH)),
                                dtype).astype(jnp.float32))
           for _ in range(3)]
    valid = None
    if masked:
        valid = rng.random((b, l)) < 0.7
        valid[:, 0] = True
    return qkv, valid


def _jax(qkv, valid, dtype):
    q, k, v = (jnp.asarray(a, dtype).transpose(0, 2, 1, 3) for a in qkv)
    out = jax_fused_attention(
        q, k, v, key_valid=None if valid is None else jnp.asarray(valid),
        scale=SCALE, interpret=True)
    return np.asarray(out.astype(jnp.float32)).transpose(0, 2, 1, 3)


def _port(qkv, valid, dtype):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in qkv)
    out = tattn.fused_attention(
        q, k, v, None if valid is None else torch.from_numpy(valid),
        scale=SCALE)
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


def _truth(qkv, valid):
    """float64 softmax attention of the same (rounded) inputs."""
    q, k, v = (a.astype(np.float64) for a in qkv)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * SCALE
    if valid is not None:
        s = np.where(valid[:, None, None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("masked", [False, True])
def test_torch_attention_plain_matches_pallas_f32(masked):
    qkv, valid = _inputs(0, 2, 256, 3, masked, jnp.float32)
    want = _jax(qkv, valid, jnp.float32)
    got = _port(qkv, valid, torch.float32)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_torch_attention_plain_bf16_error_within_2x_pallas(masked):
    qkv, valid = _inputs(1, 2, 256, 2, masked, jnp.bfloat16)
    truth = _truth(qkv, valid)
    jax_err = np.abs(_jax(qkv, valid, jnp.bfloat16) - truth).max()
    port_err = np.abs(_port(qkv, valid, torch.bfloat16) - truth).max()
    assert 0 < jax_err < 0.05
    assert port_err <= 2 * jax_err, (port_err, jax_err)


def test_torch_attention_fully_masked_row_is_uniform():
    """Masked keys are filled with -3e38, not -inf: an image whose keys are
    all masked attends uniformly (in both packages), and masked keys
    otherwise take no weight."""
    qkv, _ = _inputs(2, 2, 128, 2, False, jnp.float32)
    valid = np.ones((2, 128), bool)
    valid[0] = False
    valid[1, 17] = False
    want = _jax(qkv, valid, jnp.float32)
    got = _port(qkv, valid, torch.float32)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)
    uniform = qkv[2][0].mean(axis=0)                      # (H, dh)
    np.testing.assert_allclose(got[0], np.broadcast_to(uniform, got[0].shape),
                               atol=1e-6)
    qkv[2][1, 17] += 1e6
    np.testing.assert_array_equal(_port(qkv, valid, torch.float32)[1],
                                  got[1])


def test_torch_attention_routes_by_device():
    qkv, valid = _inputs(3, 1, 64, 1, True, jnp.float32)
    q, k, v = (torch.from_numpy(a) for a in qkv)
    kv = torch.from_numpy(valid)
    with pytest.raises(ValueError, match="needs CUDA"):
        tattn.attention_kernel(q, k, v, kv, scale=SCALE)
    with pytest.raises(ValueError, match="no path"):
        tattn.fused_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                              kv.to("meta"), scale=SCALE)
    with pytest.raises(TypeError):
        tattn.check_kernel_inputs(q.double(), k.double(), v.double(), kv)
    with pytest.raises(ValueError, match="dh = 32"):
        tattn.check_kernel_inputs(q[..., :16].contiguous(),
                                  k[..., :16].contiguous(),
                                  v[..., :16].contiguous(), kv)
    before = tattn.launches
    tattn.fused_attention(q, k, v, kv, scale=SCALE)
    assert tattn.launches == before          # the plain version counts none
