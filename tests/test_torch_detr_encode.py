"""The port's DETR encode half as a whole (the ResNet trunk,
encode_features) against the JAX package's, and the DETR weight bridge
(models/weights.py), on the CPU.

Weights come from the JAX init of a reduced DETR (blocks (1,1,1,1), 2
encoder layers, d_model 64) with random frozen-BN statistics, through
detr_from_flax.  Tolerances: float64 (JAX with x64 on; flash off on both
sides, as in JAX) atol 1e-8, on the trunk's C5 rtol 1e-8 as well (its
magnitudes grow with depth); encode_features with the fused kernels in
float32 (JAX's Pallas kernels in interpret mode, the port's plain versions)
within 2e-5, the bar of the JAX package's own flash-vs-naive encoder test;
the bridge exact."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from test_torch_detr import _count_calls, _randomize_bn  # noqa: E402
from torch_detr import TorchDETR, randomize_bn_stats  # noqa: E402

from scene_graph_commonsense_tpu.models import detr as jdetr  # noqa: E402
from scene_graph_commonsense_tpu.models.weights import (  # noqa: E402
    convert_detr_state_dict)
from scene_graph_commonsense_torch import config as torch_config  # noqa
from scene_graph_commonsense_torch.models import detr as tdetr  # noqa: E402
from scene_graph_commonsense_torch.models import weights  # noqa: E402

BLOCKS = (1, 1, 1, 1)
WIDTH = dict(d_model=64, nhead=2, dim_ff=128)


def _jax_detr(dtype, flash=False):
    return jdetr.DETR(**WIDTH, num_encoder_layers=2, num_decoder_layers=1,
                      backbone_blocks=BLOCKS, dtype=jnp.dtype(dtype),
                      flash_encoder=flash)


@pytest.fixture(scope="module")
def flax_params():
    """The encode half's flax tree (float64 leaves of float32 values)."""
    jm = _jax_detr("float32")
    init = jax.jit(lambda key: jm.init(
        key, jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 64, 64), bool),
        method=jdetr.DETR.encode_features))
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0))["params"])
    return {"params": _randomize_bn(tree, np.random.default_rng(0))}


def _port_detr(params, dtype, flash=False):
    tm = tdetr.DETR(**WIDTH, num_encoder_layers=2, backbone_blocks=BLOCKS,
                    dtype=getattr(torch, dtype), flash_encoder=flash)
    tm.load_state_dict(weights.detr_from_flax(params))
    if dtype == "float64":
        tm = tm.double()
    return tm.eval().requires_grad_(False)


def _jax_encode(params, dtype, images, mask, flash=False):
    jm = _jax_detr(dtype, flash)
    if dtype != "float64":
        params = jax.tree.map(lambda a: a.astype(dtype), params)
    if mask is None:
        fn = jax.jit(lambda p, i: jm.apply(
            p, i, None, method=jdetr.DETR.encode_features))
        return np.asarray(fn(params, jnp.asarray(images)))
    fn = jax.jit(lambda p, i, m: jm.apply(
        p, i, m, method=jdetr.DETR.encode_features))
    return np.asarray(fn(params, jnp.asarray(images), jnp.asarray(mask)))


def test_torch_resnet_matches_jax(flax_params):
    """Even and odd image sides (JAX takes its space-to-depth stem on the
    even one, the plain conv on the odd; the port the plain conv on
    both)."""
    rng = np.random.default_rng(2)
    jm = jdetr.ResNet101(dtype=jnp.float64, blocks=BLOCKS)
    bb = {"params": flax_params["params"]["backbone"]}
    tm = tdetr.ResNet101(BLOCKS)
    tm.load_state_dict({k.removeprefix("backbone."): v for k, v in
                        weights.detr_from_flax(flax_params).items()
                        if k.startswith("backbone.")})
    tm = tm.double().requires_grad_(False)
    with jax.enable_x64():
        fn = jax.jit(jm.apply)
        for side in (64, 65):
            x = rng.standard_normal((2, side, side, 3))
            want = np.asarray(fn(bb, jnp.asarray(x)))
            got = tm(torch.from_numpy(x), torch.float64).numpy()
            assert got.shape == want.shape == (2, 2 + side % 2,
                                               2 + side % 2, 2048)
            np.testing.assert_allclose(got, want, atol=1e-8, rtol=1e-8)


@pytest.mark.parametrize("with_mask", [False, True])
def test_torch_encode_features_matches_jax_f64(flax_params, with_mask):
    rng = np.random.default_rng(7)
    images = rng.standard_normal((2, 128, 96, 3))
    mask = None
    if with_mask:
        mask = np.ones((2, 128, 96), bool)
        mask[1, :, 50:] = False
        mask[1, 90:, :] = False
    with jax.enable_x64():
        want = _jax_encode(flax_params, "float64", images, mask)
    got = _port_detr(flax_params, "float64").encode_features(
        torch.from_numpy(images),
        None if mask is None else torch.from_numpy(mask))
    assert got.shape == want.shape == (2, 4, 3, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=0)


def test_torch_encode_features_flash_matches_jax_f32(flax_params,
                                                     monkeypatch):
    """A 1024x512 image: L = 32 * 16 = 512 tokens, so both packages route
    every encoder layer through the fused kernels (JAX: Pallas interpret;
    the port on the CPU: the plain versions)."""
    counts = _count_calls(monkeypatch)
    rng = np.random.default_rng(8)
    images = rng.standard_normal((1, 1024, 512, 3)).astype(np.float32)
    mask = np.ones((1, 1024, 512), bool)
    mask[0, :, 400:] = False
    want = _jax_encode(flax_params, "float32", images, mask, flash=True)
    got = _port_detr(flax_params, "float32", flash=True).encode_features(
        torch.from_numpy(images), torch.from_numpy(mask)).numpy()
    # JAX traced each layer's kernels once; the port ran them once
    assert counts == {"jax_attn": 2, "jax_ffn": 2, "torch_attn": 2,
                      "torch_ffn": 2}
    assert got.dtype == np.float32 and got.shape == (1, 32, 16, 64)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_torch_detr_weights_round_trip(flax_params):
    sd = weights.detr_from_flax(flax_params)
    back = weights.detr_to_flax(sd)
    jax.tree.map(np.testing.assert_array_equal, back, flax_params)
    # copies, not views of the state dict's tensors
    sd["backbone.conv1.weight"].add_(1.0)
    sd["encoder_0.norm1.weight"].add_(1.0)
    again = weights.detr_to_flax(sd)
    assert not np.array_equal(again["params"]["backbone"]["conv1"]["kernel"],
                              back["params"]["backbone"]["conv1"]["kernel"])
    np.testing.assert_array_equal(
        back["params"]["encoder_0"]["norm1"]["scale"],
        flax_params["params"]["encoder_0"]["norm1"]["scale"])
    # the port's modules hold exactly these keys
    assert set(sd) == set(_port_detr(flax_params, "float32").state_dict())


def test_torch_detr_from_hub_state_dict_matches_converter():
    """torch-hub names -> the port equals the JAX converter followed by
    detr_from_flax, both halves; the port's encode half then computes the
    hub replica's features."""
    torch.manual_seed(0)
    hub = TorchDETR(blocks=BLOCKS, n_enc=2, n_dec=1)
    randomize_bn_stats(hub)
    hub = hub.double().eval()
    state = hub.state_dict()
    got = weights.detr_from_hub_state_dict(state, 2, BLOCKS, 1)
    want = weights.detr_from_flax(convert_detr_state_dict(
        {k: v.numpy() for k, v in state.items()}, num_encoder_layers=2,
        num_decoder_layers=1, blocks=BLOCKS))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    detection = set(got) - set(weights.detr_encode_half(got))
    assert detection and all(k.startswith(
        ("decoder_0.", "decoder_norm.", "query_embed.", "class_embed.",
         "bbox_embed_")) for k in detection)
    assert "query_embed.weight" in detection
    encode = weights.detr_from_hub_state_dict(state, 2, BLOCKS, None)
    assert encode.keys() == weights.detr_encode_half(got).keys()

    cfg = torch_config.derive("vg", model={
        "detr_blocks": BLOCKS, "detr_enc_layers": 2,
        "compute_dtype": "float64"})
    port = tdetr.make_detr(cfg, device="cpu", state_dict=encode)
    rng = np.random.default_rng(9)
    images = rng.standard_normal((2, 64, 96, 3))
    valid = np.ones((2, 64, 96), bool)
    valid[1, :, 48:] = False
    with torch.no_grad():
        want_feat = hub.encode_features(
            torch.from_numpy(images.transpose(0, 3, 1, 2)),
            torch.from_numpy(valid)).permute(0, 2, 3, 1)
    got_feat = port.encode_features(torch.from_numpy(images),
                                    torch.from_numpy(valid))
    np.testing.assert_allclose(got_feat.numpy(), want_feat.numpy(),
                               atol=1e-8, rtol=0)

    missing = dict(state)
    del missing["transformer.encoder.layers.1.norm2.bias"]
    with pytest.raises(KeyError, match="layers.1.norm2.bias"):
        weights.detr_from_hub_state_dict(missing, 2, BLOCKS, 1)
    with pytest.raises(ValueError, match="neither"):
        weights.detr_from_hub_state_dict(state, 1, BLOCKS, 1)
    with pytest.raises(KeyError, match="decoder.layers.1"):
        weights.detr_from_hub_state_dict(state, 2, BLOCKS, 2)


def test_torch_init_detr_params_is_seeded():
    cfg = torch_config.derive("vg", model={"detr_blocks": BLOCKS,
                                           "detr_enc_layers": 1})
    a = weights.init_detr_params(cfg, torch.Generator().manual_seed(3))
    b = weights.init_detr_params(cfg, torch.Generator().manual_seed(3))
    c = weights.init_detr_params(cfg, torch.Generator().manual_seed(4))
    assert a.keys() == set(tdetr.make_detr(cfg, device="cpu").state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["backbone.layer3_0.conv2.weight"]              # (256, 256, 3, 3)
    assert not torch.equal(w, c["backbone.layer3_0.conv2.weight"])
    assert abs(float(w.std()) - (1 / (256 * 9)) ** 0.5) < 2e-3
    assert torch.equal(a["backbone.bn1.running_var"], torch.ones(64))
    assert torch.equal(a["encoder_0.norm2.weight"], torch.ones(256))
    assert not a["input_proj.bias"].any()
