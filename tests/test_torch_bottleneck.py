"""The port's fused bottleneck blocks (ops/bottleneck.py: fold_bn and the
plain versions of the stride-1 and stride-2 kernels, which the wrappers
run for CPU tensors) against the JAX package's Pallas kernels in interpret
mode, on the same numpy inputs.

Tolerances: fold_bn within 2 float32 ulps (rsqrt may differ by one ulp);
float32 within 1e-5 of the output's scale (max |JAX|): sums of up to
9 * 128 float32 products in another order; bfloat16 compute: the port's
largest error against the JAX kernel's float32 result on the same float32
inputs is at most 2x the JAX bf16 kernel's own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_graph_commonsense_tpu.ops.pallas import bottleneck as jb
from scene_graph_commonsense_torch.ops import bottleneck as tb


def _bn_stats(rng, c):
    return {"weight": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0, 0.2, c),
            "running_mean": rng.normal(0, 0.5, c),
            "running_var": rng.uniform(0.5, 2.0, c)}


def _fold(rng, c):
    return np.stack([rng.uniform(0.5, 1.5, c),
                     rng.normal(0, 0.2, c)]).astype(np.float32)


def _inputs(seed, h, w, cin, m, co, proj):
    """x, w1, s1, w2, s2, w3, s3, wd, sd as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((2, h, w, cin)).astype(f)
    args = [x, (rng.standard_normal((cin, m)) / np.sqrt(cin)).astype(f),
            _fold(rng, m),
            (rng.standard_normal((3, 3, m, m)) / np.sqrt(9 * m)).astype(f),
            _fold(rng, m),
            (rng.standard_normal((m, co)) / np.sqrt(m)).astype(f),
            _fold(rng, co)]
    if proj:
        args += [(rng.standard_normal((cin, co)) / np.sqrt(cin)).astype(f),
                 _fold(rng, co)]
    else:
        args += [None, None]
    return args


def _jax(fn, args, dtype):
    """fn on the args with x and the weights in `dtype`, the folds (at
    positions 2, 4, 6, 8) float32; float32 out."""
    jd = jnp.dtype(dtype)
    conv = [None if a is None else
            (jnp.asarray(a) if i in (2, 4, 6, 8) else jnp.asarray(a, jd))
            for i, a in enumerate(args)]
    out = jax.jit(lambda *a: fn(*a, interpret=True))(*conv)
    return np.asarray(out.astype(jnp.float32))


def _torch(fn, args, dtype):
    td = getattr(torch, dtype)
    conv = [None if a is None else
            (torch.from_numpy(a) if i in (2, 4, 6, 8)
             else torch.from_numpy(a).to(td))
            for i, a in enumerate(args)]
    return fn(*conv).float().numpy()


def _compare(jfn, tfn, args, dtype):
    want = _jax(jfn, args, dtype)
    got = _torch(tfn, args, dtype)
    assert got.shape == want.shape
    if dtype == "float32":
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-5 * scale
    else:
        truth = _jax(jfn, args, "float32")
        err = np.abs(got - truth).max()
        jax_err = np.abs(want - truth).max()
        assert err <= 2 * jax_err, (err, jax_err)


def test_torch_fold_bn_matches_jax():
    rng = np.random.default_rng(0)
    stats = {k: v.astype(np.float32) for k, v in _bn_stats(rng, 96).items()}
    want = np.asarray(jb.fold_bn({k: jnp.asarray(v)
                                  for k, v in stats.items()}))
    got = tb.fold_bn({k: torch.from_numpy(v) for k, v in stats.items()})
    assert got.dtype == torch.float32 and got.shape == (2, 96)
    np.testing.assert_allclose(got.numpy(), want, rtol=2.4e-7, atol=1e-7)
    # a FrozenBatchNorm module (float64 buffers) folds to float32 too
    from scene_graph_commonsense_torch.models.detr import FrozenBatchNorm
    bn = FrozenBatchNorm(96).double()
    bn.load_state_dict({k: torch.from_numpy(v).double()
                        for k, v in stats.items()})
    assert tb.fold_bn(bn).dtype == torch.float32
    np.testing.assert_allclose(tb.fold_bn(bn).numpy(), want, rtol=2.4e-7,
                               atol=1e-7)


# (H, W, C_in, M, C_out, projection): M < 128 takes the JAX kernel's single
# K = 9M dot, M >= 128 its nine tap dots; H = 6 makes three row blocks, so
# the halo rows between them and both image borders are in play
STRIDE1 = {"m16": (6, 10, 64, 16, 64, False),
           "m16_proj": (6, 10, 32, 16, 64, True),
           "m128": (4, 6, 128, 128, 128, False),
           "m128_proj": (4, 6, 64, 128, 128, True)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(STRIDE1))
def test_torch_fused_bottleneck_matches_jax(case, dtype):
    args = _inputs(1, *STRIDE1[case])
    _compare(jb.fused_bottleneck, tb.fused_bottleneck, args, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [16, 128])
def test_torch_fused_bottleneck_s2_matches_jax(m, dtype):
    args = _inputs(2, 8, 12, 64, m, 128, True)
    _compare(jb.fused_bottleneck_s2, tb.fused_bottleneck_s2, args, dtype)


def test_torch_bottleneck_routes_by_device():
    """CPU tensors run the plain version without touching the launch
    counters; the kernel entry points refuse CPU tensors."""
    args = _inputs(3, 4, 4, 64, 16, 64, False)
    t = [None if a is None else torch.from_numpy(a) for a in args]
    before = (tb.launches, tb.s2_launches)
    out = tb.fused_bottleneck(*t)
    assert out.shape == (2, 4, 4, 64) and out.dtype == torch.float32
    assert (tb.launches, tb.s2_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tb.bottleneck_kernel(*t)
    with pytest.raises(ValueError, match="CUDA"):
        tb.bottleneck_s2_kernel(*t)
