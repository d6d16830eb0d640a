"""The port's fused ResNet-101 trunk (models/resnet_fused.py) against the
JAX package's `resnet_forward_fused` (Pallas kernels in interpret mode), and
DETR.encode_features with fused_backbone on, on the CPU, where the port's
wrappers run the kernels' plain versions.

One flax tree gives both packages' fused trunks: the JAX init of a reduced
ResNet-101 (blocks (1, 1, 1, 1), full widths) with random frozen-BN
statistics, converted for the port by models/weights.detr_from_flax.

The three stem routes of the JAX code: 32x32 (H, W divisible by 8: the
stem kernel, every transition fused), 36x44 (even: the plain conv, then the
stem-pool kernel; the odd stage sizes that follow take the plain
stride-2 fallback) and 33x35 (odd: the plain conv and a plain pool).

Tolerances: float32 within 1e-5 of the output's scale (max |JAX|): conv
sums in another order, carried through up to 5 blocks (7e-7 measured);
bfloat16 compute: the port's largest error against JAX's float32 result is
at most 2x JAX's bf16 error."""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from test_torch_detr import _randomize_bn  # noqa: E402

from scene_graph_commonsense_tpu.models import detr as jdetr  # noqa: E402
from scene_graph_commonsense_tpu.models import resnet_fused as jrf  # noqa
from scene_graph_commonsense_torch.models import detr as tdetr  # noqa: E402
from scene_graph_commonsense_torch.models import resnet_fused as trf  # noqa
from scene_graph_commonsense_torch.models import weights  # noqa: E402
from scene_graph_commonsense_torch.ops import bottleneck as tb  # noqa: E402
from scene_graph_commonsense_torch.ops import stem as ts  # noqa: E402

BLOCKS = (1, 1, 1, 1)
F32_TOL = 1e-5


def _flax_resnet(blocks, seed=0):
    jm = jdetr.ResNet101(dtype=jnp.float32, blocks=blocks)
    init = jax.jit(lambda key: jm.init(key, jnp.zeros((1, 32, 32, 3))))
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed))["params"])
    return _randomize_bn(tree, np.random.default_rng(seed))


def _port_resnet(tree, blocks):
    sd = weights.detr_from_flax({"backbone": tree})
    tm = tdetr.ResNet101(blocks)
    tm.load_state_dict({k.removeprefix("backbone."): v
                        for k, v in sd.items()})
    return tm.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def trunk():
    tree = _flax_resnet(BLOCKS)
    f32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    return f32, _port_resnet(tree, BLOCKS)


def _jax_fused(params, images, dtype, blocks=BLOCKS, upto=None):
    fn = jax.jit(functools.partial(
        jrf.resnet_forward_fused, blocks=blocks, dtype=jnp.dtype(dtype),
        interpret=True, upto=upto))
    return np.asarray(fn(params, jnp.asarray(images)).astype(jnp.float32))


def _count_routes(monkeypatch):
    """Counts the port's calls of each route (kernels' plain versions on
    the CPU, and the plain stride-2 fallback)."""
    counts = {"conv_pool": 0, "pool": 0, "s1": 0, "s2": 0, "xla": 0}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    wrap(ts, "stem_conv_pool_plain", "conv_pool")
    wrap(ts, "stem_pool_plain", "pool")
    wrap(tb, "fused_bottleneck_plain", "s1")
    wrap(tb, "fused_bottleneck_s2_plain", "s2")
    wrap(trf, "_xla_bottleneck", "xla")
    return counts


def _check(got, want, truth, dtype):
    assert got.shape == want.shape
    if dtype == "float32":
        assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()
    else:
        err = np.abs(got - truth).max()
        jax_err = np.abs(want - truth).max()
        assert err <= 2 * jax_err, (err, jax_err)


ROUTES = {
    (32, 32): dict(conv_pool=1, pool=0, s1=1, s2=3, xla=0),
    (36, 44): dict(conv_pool=0, pool=1, s1=1, s2=0, xla=3),
    (33, 35): dict(conv_pool=0, pool=0, s1=1, s2=0, xla=3),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", list(ROUTES))
def test_torch_resnet_fused_matches_jax(trunk, monkeypatch, size, dtype):
    params, port = trunk
    rng = np.random.default_rng(sum(size))
    images = rng.standard_normal((2, *size, 3)).astype(np.float32)
    want = _jax_fused(params, images, dtype)
    truth = want if dtype == "float32" else _jax_fused(params, images,
                                                       "float32")
    counts = _count_routes(monkeypatch)
    got = trf.resnet_forward_fused(port, torch.from_numpy(images),
                                   getattr(torch, dtype))
    assert counts == ROUTES[size]
    assert got.dtype == getattr(torch, dtype)
    _check(got.float().numpy(), want, truth, dtype)


@pytest.mark.parametrize("upto", ["stem", "layer1", "layer2", "layer3",
                                  "layer4"])
def test_torch_resnet_fused_upto_matches_jax(trunk, upto):
    params, port = trunk
    images = np.random.default_rng(3).standard_normal(
        (1, 64, 32, 3)).astype(np.float32)
    want = _jax_fused(params, images, "float32", upto=upto)
    got = trf.resnet_forward_fused(port, torch.from_numpy(images),
                                   torch.float32, upto=upto).numpy()
    channels = {"stem": 64, "layer1": 256, "layer2": 512, "layer3": 1024,
                "layer4": 2048}[upto]
    assert got.shape[-1] == channels
    _check(got, want, want, "float32")


def test_torch_resnet_fused_prepares_once_and_on_load(trunk):
    """The folds and kernel-layout weights are built once per compute
    dtype; a load_state_dict drops them, so new weights change the
    output."""
    tree = _flax_resnet(BLOCKS, seed=5)
    port = _port_resnet(tree, BLOCKS)
    images = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 32, 32, 3)).astype(np.float32))
    first = trf.resnet_forward_fused(port, images, torch.float32)
    prep = trf.prepared(port, torch.float32)
    assert trf.prepared(port, torch.float32) is prep
    assert trf.prepared(port, torch.bfloat16) is not prep
    assert prep.stages[2][0].w2.shape == (3, 3, 256, 256)

    other = trunk[1].state_dict()
    port.load_state_dict(other)
    assert not port.fused_cache
    again = trf.resnet_forward_fused(port, images, torch.float32)
    assert not torch.equal(again, first)
    assert torch.equal(again, trf.resnet_forward_fused(trunk[1], images,
                                                       torch.float32))


WIDTH = dict(d_model=64, nhead=2, dim_ff=128)


@pytest.mark.parametrize("shape,feats", [((2, 64, 96), (2, 2, 3, 64)),
                                         ((2, 68, 100), (2, 3, 4, 64))],
                         ids=["div8", "stem_pool"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_encode_features_fused_matches_jax(dtype, shape, feats):
    """DETR.encode_features with fused_backbone on, against JAX's
    DETR(fused_backbone=True) on one flax tree (float32 parameters in both
    packages, the compute dtype `dtype`).  (2, 68, 100): sides even but not
    divisible by 8, so the stem is the plain conv then stem_pool (JAX's
    Pallas kernel in interpret mode, the port's plain version), and the
    odd stride-2 inputs take the plain blocks."""
    def jax_detr(dt, **extra):
        return jdetr.DETR(**WIDTH, num_encoder_layers=1,
                          num_decoder_layers=1, backbone_blocks=BLOCKS,
                          dtype=jnp.dtype(dt), **extra)

    init = jax.jit(lambda key: jax_detr("float32").init(
        key, jnp.zeros((1, 64, 64, 3)), None,
        method=jdetr.DETR.encode_features))
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(1))["params"])
    tree = _randomize_bn(tree, np.random.default_rng(1))
    images = np.random.default_rng(6).standard_normal(
        (*shape, 3)).astype(np.float32)
    params = {"params": jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                                     tree)}

    def run_jax(dt):
        jm = jax_detr(dt, fused_backbone=True)
        out = jax.jit(lambda p, x: jm.apply(
            p, x, None, method=jdetr.DETR.encode_features))(
                params, jnp.asarray(images))
        return np.asarray(out.astype(jnp.float32))

    want = run_jax(dtype)
    truth = want if dtype == "float32" else run_jax("float32")
    port = tdetr.DETR(**WIDTH, num_encoder_layers=1, backbone_blocks=BLOCKS,
                      dtype=getattr(torch, dtype), fused_backbone=True)
    port.load_state_dict(weights.detr_from_flax({"params": tree}))
    port = port.eval().requires_grad_(False)
    got = port.encode_features(torch.from_numpy(images)).float().numpy()
    assert got.shape == want.shape == feats
    _check(got, want, truth, dtype)


@pytest.mark.slow
def test_torch_resnet_fused_full_trunk_matches_jax():
    """Blocks (2, 1, 2, 1) at 64x64, as the JAX package's own slow test."""
    blocks = (2, 1, 2, 1)
    tree = _flax_resnet(blocks, seed=2)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    images = np.random.default_rng(7).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    want = _jax_fused(params, images, "float32", blocks=blocks)
    got = trf.resnet_forward_fused(_port_resnet(tree, blocks),
                                   torch.from_numpy(images),
                                   torch.float32).numpy()
    _check(got, want, want, "float32")
