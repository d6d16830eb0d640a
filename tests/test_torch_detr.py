"""The modules of the port's DETR encode half (models/detr.py) against the
JAX package's flax modules, on the same weights and numpy inputs, on the
CPU; the routing to the fused kernels; make_detr's modes.  The trunk and
encode_features as a whole are in test_torch_detr_encode.py.

Weights come from the JAX init (with random frozen-BN statistics, so the BN
scale and shift are exercised) through models/weights.detr_from_flax.
Tolerances: float64 (JAX with x64 on; flash never routes there, as in JAX)
atol 1e-8; the embedding in float32 1e-6 and in bfloat16 exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_graph_commonsense_tpu.models import detr as jdetr
from scene_graph_commonsense_torch import config as torch_config
from scene_graph_commonsense_torch.models import detr as tdetr
from scene_graph_commonsense_torch.models import weights
from scene_graph_commonsense_torch.ops import attention as tattn
from scene_graph_commonsense_torch.ops import ffn as tffn

F64 = dict(atol=1e-8, rtol=0)


@pytest.fixture
def x64():
    with jax.enable_x64():
        yield


def _randomize_bn(tree, rng):
    """Random frozen-BN statistics in a flax tree; every leaf float64 with
    float32 values (the JAX package's x64 parity runs hold float64
    parameters, as the port does under float64 compute)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "running_var" in v:
            c = v["running_var"].shape[0]
            out[k] = {"weight": rng.uniform(0.5, 1.5, c),
                      "bias": rng.normal(0, 0.2, c),
                      "running_mean": rng.normal(0, 0.5, c),
                      "running_var": rng.uniform(0.5, 2.0, c)}
            out[k] = {n: a.astype(np.float32).astype(np.float64)
                      for n, a in out[k].items()}
        elif isinstance(v, dict):
            out[k] = _randomize_bn(v, rng)
        else:
            out[k] = np.asarray(v, np.float32).astype(np.float64)
    return out


def _init(module, *args, seed=0, dtype=np.float64):
    params = module.init(jax.random.PRNGKey(seed), *args)
    tree = _randomize_bn(jax.tree.map(np.asarray, params["params"]),
                         np.random.default_rng(seed))
    return {"params": jax.tree.map(lambda a: a.astype(dtype), tree)}


def _sub_sd(params, prefix):
    """The port state dict of a flax sub-tree, placed under a top-level
    name of the DETR tree (`prefix`) for the bridge and stripped again."""
    sd = weights.detr_from_flax({prefix: params["params"]})
    return {k.removeprefix(prefix + "."): v for k, v in sd.items()}


def _load(module, params, prefix):
    """Loads a flax sub-tree into a port module, in float64."""
    module.load_state_dict(_sub_sd(params, prefix))
    return module.double().eval().requires_grad_(False)


def _j(x):
    return jnp.asarray(x)


def test_torch_frozen_bn_matches_jax(x64):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 6, 8))
    jm = jdetr.FrozenBatchNorm(8, dtype=jnp.float64)
    params = {"params": _randomize_bn(
        {"bn": {"weight": np.ones(8), "bias": np.ones(8),
                "running_mean": np.ones(8), "running_var": np.ones(8)}},
        rng)["bn"]}
    want = np.asarray(jm.apply(params, _j(x)))
    tm = tdetr.FrozenBatchNorm(8)
    tm.load_state_dict({k: torch.from_numpy(v)
                        for k, v in params["params"].items()})
    tm = tm.double()
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float64)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **F64)


@pytest.mark.parametrize("stride,downsample", [(1, False), (1, True),
                                               (2, True)])
def test_torch_bottleneck_matches_jax(x64, stride, downsample):
    rng = np.random.default_rng(1)
    cin = 16 if downsample else 32
    x = rng.standard_normal((2, 8, 8, cin))
    jm = jdetr.Bottleneck(8, stride=stride, downsample=downsample,
                          dtype=jnp.float64)
    params = _init(jm, _j(x))
    want = np.asarray(jm.apply(params, _j(x)))
    tm = _load(tdetr.Bottleneck(cin, 8, stride, downsample), params,
               "backbone")
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float64)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **F64)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_torch_sine_position_embedding_matches_jax(dtype):
    mask = np.ones((3, 7, 9), bool)
    mask[1, :, 5:] = False
    mask[2, 4:, :] = False
    mask[2, :, 0] = False
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jdetr.sine_position_embedding(
            _j(mask), 16, dtype=jnp.dtype(dtype))).astype(np.float64)
    got = tdetr.sine_position_embedding(
        torch.from_numpy(mask), 16, dtype=getattr(torch, dtype)).double()
    assert got.shape == (3, 7, 9, 32)
    tol = {"float64": F64, "float32": dict(atol=1e-6, rtol=0),
           "bfloat16": dict(atol=0, rtol=0)}[dtype]
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("shape", [(64, 48), (37, 53)])
def test_torch_mask_downsample_matches_jax(shape):
    rng = np.random.default_rng(4)
    pixel_mask = rng.random((2, 5 * 32, 7 * 32)) < 0.6
    h, w = shape[0] // 8, shape[1] // 8
    ys = (np.arange(h) * pixel_mask.shape[1]) // h
    xs = (np.arange(w) * pixel_mask.shape[2]) // w
    want = np.asarray(_j(pixel_mask)[:, ys][:, :, xs])
    got = tdetr.downsample_mask(torch.from_numpy(pixel_mask), h, w)
    np.testing.assert_array_equal(got.numpy(), want)


def _count_calls(monkeypatch):
    """Counts the fused-kernel calls of both packages on the CPU: JAX's
    Pallas functions (imported at call time by models/detr.py) and the
    port's plain versions (looked up at call time by the route)."""
    from scene_graph_commonsense_tpu.ops.pallas import attention as ja
    from scene_graph_commonsense_tpu.ops.pallas import ffn as jf
    counts = {"jax_attn": 0, "jax_ffn": 0, "torch_attn": 0, "torch_ffn": 0}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    wrap(ja, "fused_attention", "jax_attn")
    wrap(jf, "fused_ffn_ln", "jax_ffn")
    wrap(tattn, "attention_plain", "torch_attn")
    wrap(tffn, "ffn_ln_plain", "torch_ffn")
    return counts


@pytest.mark.parametrize("l,dtype", [(512, "float32"), (256, "float32"),
                                     (512, "float64")])
def test_torch_encoder_routes_like_jax(monkeypatch, l, dtype):
    """MHA and EncoderLayer take the kernel path exactly when the JAX
    modules do: self-attention with L % 512 == 0, (B*L) % 512 == 0 for the
    FFN, never under float64."""
    counts = _count_calls(monkeypatch)
    rng = np.random.default_rng(5)
    d = 64
    src = rng.standard_normal((1, l, d)).astype(dtype)
    pos = rng.standard_normal((1, l, d)).astype(dtype)
    mask = np.ones((1, l), bool)
    with jax.enable_x64(dtype == "float64"):
        jm = jdetr.EncoderLayer(d, 2, 128, dtype=jnp.dtype(dtype),
                                flash=True)
        params = jax.tree.map(np.asarray, jax.jit(jm.init)(
            jax.random.PRNGKey(0), _j(src), _j(pos), _j(mask)))
        counts.update(jax_attn=0, jax_ffn=0)          # init traced them
        # traced once: one count per routed call
        jax.jit(jm.apply)(params, _j(src), _j(pos), _j(mask))
    tm = tdetr.EncoderLayer(d, 2, 128, dtype=getattr(torch, dtype),
                            flash=True)
    tm.load_state_dict(_sub_sd(params, "encoder_0"))
    tm(torch.from_numpy(src), torch.from_numpy(pos), torch.from_numpy(mask))
    on = l % 512 == 0 and dtype != "float64"
    assert counts == {"jax_attn": int(on), "jax_ffn": int(on),
                      "torch_attn": int(on), "torch_ffn": int(on)}


@pytest.mark.parametrize("masked", [False, True])
def test_torch_naive_encoder_layer_matches_jax_f64(x64, masked):
    """The naive MHA and FFN paths (flash on but L = 256 does not route,
    and float64 never does) against JAX's naive path."""
    rng = np.random.default_rng(6)
    b, l, d = 2, 256, 64
    src = rng.standard_normal((b, l, d))
    pos = rng.standard_normal((b, l, d))
    mask = rng.random((b, l)) < 0.7 if masked else np.ones((b, l), bool)
    mask[:, 0] = True
    jm = jdetr.EncoderLayer(d, 2, 128, dtype=jnp.float64, flash=True)
    params = _init(jm, _j(src), _j(pos), _j(mask))
    want = np.asarray(jm.apply(params, _j(src), _j(pos), _j(mask)))
    tm = _load(tdetr.EncoderLayer(d, 2, 128, dtype=torch.float64,
                                  flash=True), params, "encoder_0")
    got = tm(torch.from_numpy(src), torch.from_numpy(pos),
             torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **F64)

    # the MHA alone, cross-attention shape (Lq != Lk)
    jmha = jdetr.MHA(d, 2, jnp.float64, flash=True)
    q = rng.standard_normal((b, 7, d))
    mp = _init(jmha, _j(q), _j(src), _j(src), _j(mask))
    want = np.asarray(jmha.apply(mp, _j(q), _j(src), _j(src), _j(mask)))
    tmha = _load(tdetr.MHA(d, 2, torch.float64, flash=True), mp,
                 "encoder_0")
    got = tmha(torch.from_numpy(q), torch.from_numpy(src),
               torch.from_numpy(src), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **F64)


def test_torch_make_detr_resolves_modes():
    base = {"detr_blocks": (1, 1, 1, 1), "detr_enc_layers": 1}

    def cfg(**model):
        return torch_config.derive("vg", model={**base, **model})

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tdetr.resolve_detr_modes(cfg(), cpu) == (False, False)
    assert tdetr.resolve_detr_modes(cfg(), cuda) == (False, True)
    assert tdetr.resolve_detr_modes(
        cfg(compute_dtype="float64"), cuda) == (False, False)
    assert tdetr.resolve_detr_modes(cfg(flash_encoder="on"), cpu) \
        == (False, True)
    assert tdetr.resolve_detr_modes(cfg(flash_encoder="off"), cuda) \
        == (False, False)
    # fused_backbone: only the ResNet-101 layout fuses (others run
    # unfused, as in JAX); auto fuses on a CUDA device outside float64
    assert tdetr.resolve_detr_modes(cfg(fused_backbone="on"), cuda) \
        == (False, True)
    r101 = {"detr_blocks": (3, 4, 23, 3)}
    assert tdetr.resolve_detr_modes(cfg(fused_backbone="on", **r101),
                                    cuda) == (True, True)
    assert tdetr.resolve_detr_modes(cfg(fused_backbone="on", **r101),
                                    cpu) == (True, False)
    assert tdetr.resolve_detr_modes(cfg(**r101), cuda) == (True, True)
    assert tdetr.resolve_detr_modes(cfg(**r101), cpu) == (False, False)
    assert tdetr.resolve_detr_modes(
        cfg(compute_dtype="float64", **r101), cuda) == (False, False)
    assert tdetr.resolve_detr_modes(cfg(fused_backbone="off", **r101),
                                    cuda) == (False, True)
    with pytest.raises(ValueError):
        tdetr.resolve_detr_modes(cfg(fused_backbone="yes"), cpu)
    with pytest.raises(ValueError):
        tdetr.resolve_detr_modes(cfg(flash_encoder="yes"), cpu)
    model = tdetr.make_detr(cfg(), device="cpu")
    assert not model.encoder_0.flash and not model.fused_backbone
    assert not tdetr.make_detr(cfg(fused_backbone="on"),
                               device="cpu").fused_backbone
    assert not any(p.requires_grad for p in model.parameters())
    model = tdetr.make_detr(cfg(flash_encoder="on", compute_dtype="float64"),
                            device="cpu")
    assert model.encoder_0.flash
    assert all(p.dtype == torch.float64 for p in model.parameters())
