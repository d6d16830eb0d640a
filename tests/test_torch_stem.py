"""The port's ResNet stem (ops/stem.py: the plain versions of the
stem_conv_pool and stem_pool kernels, which the wrappers run for CPU
tensors) against the JAX package's Pallas kernels in interpret mode, on the
same numpy inputs.

Tolerances: float32 within 1e-5 of the output's scale (max |JAX|): conv
sums of 147 products in another order (stem_pool, which sums nothing,
within 1e-6); bfloat16 compute: the port's largest error against the JAX
kernel's float32 result on the same float32 inputs is at most 2x the JAX
bf16 kernel's own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_graph_commonsense_tpu.ops.pallas import stem as js
from scene_graph_commonsense_torch.ops import stem as ts


def _fold(rng, c):
    return np.stack([rng.uniform(0.5, 1.5, c),
                     rng.normal(0, 0.2, c)]).astype(np.float32)


def _check(got, want, truth, dtype, f32_tol):
    assert got.shape == want.shape
    if dtype == "float32":
        assert np.abs(got - want).max() <= f32_tol * np.abs(want).max()
    else:
        err = np.abs(got - truth).max()
        jax_err = np.abs(want - truth).max()
        assert err <= 2 * jax_err, (err, jax_err)


def _jax_conv_pool(images, w7, fold, dtype):
    fn = jax.jit(lambda x, w, s: js.stem_conv_pool(
        x.astype(jnp.dtype(dtype)), w, s, interpret=True))
    out = fn(jnp.asarray(images), jnp.asarray(w7), jnp.asarray(fold))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_stem_conv_pool_matches_jax(dtype):
    """(2, 32, 48, 3): 8 x 12 pool outputs, so the first and last rows and
    columns (conv zero padding, pool -inf padding) are a large share."""
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    w7 = (rng.standard_normal((7, 7, 3, 64)) / np.sqrt(147)).astype(
        np.float32)
    fold = _fold(rng, 64)
    want = _jax_conv_pool(images, w7, fold, dtype)
    truth = _jax_conv_pool(images, w7, fold, "float32")
    got = ts.stem_conv_pool(torch.from_numpy(images), torch.from_numpy(w7),
                            torch.from_numpy(fold),
                            compute_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, 8, 12, 64)
    _check(got.float().numpy(), want, truth, dtype, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 10, 14, 64), (1, 18, 6, 64)])
def test_torch_stem_pool_matches_jax(shape, dtype):
    """Conv outputs of images that are even but not divisible by 8 (the
    route that takes stem_pool): H/2 and W/2 odd, so the last pool window
    of a row or column reaches the bottom/right edge."""
    rng = np.random.default_rng(1)
    conv = rng.standard_normal(shape).astype(np.float32)
    fold = _fold(rng, shape[-1])
    fn = jax.jit(lambda x, s: js.stem_pool(x, s, interpret=True))

    def run_jax(dt):
        x = jnp.asarray(conv).astype(jnp.dtype(dt))
        return np.asarray(fn(x, jnp.asarray(fold)).astype(jnp.float32))

    want = run_jax(dtype)
    got = ts.stem_pool(torch.from_numpy(conv).to(getattr(torch, dtype)),
                       torch.from_numpy(fold))
    assert got.dtype == getattr(torch, dtype)
    _check(got.float().numpy(), want, run_jax("float32"), dtype, 1e-6)


def test_torch_stem_routes_by_device():
    """CPU tensors run the plain versions without touching the launch
    counters; the kernel entry points refuse CPU tensors."""
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.standard_normal((1, 16, 8, 3)).astype(
        np.float32))
    w7 = torch.zeros((7, 7, 3, 64))
    fold = torch.from_numpy(_fold(rng, 64))
    before = (ts.conv_pool_launches, ts.pool_launches)
    out = ts.stem_conv_pool(images, w7, fold, compute_dtype=torch.bfloat16)
    assert out.shape == (1, 4, 2, 64) and out.dtype == torch.bfloat16
    # a zero kernel: every output is relu(shift) rounded once
    want = torch.relu(fold[1]).to(torch.bfloat16)
    assert torch.equal(out, want.expand_as(out))
    assert (ts.conv_pool_launches, ts.pool_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        ts.stem_conv_pool_kernel(images, w7, fold)
    with pytest.raises(ValueError, match="CUDA"):
        ts.stem_pool_kernel(torch.zeros((1, 4, 4, 64)), fold)
