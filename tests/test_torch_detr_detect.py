"""The port's DETR detection forward (models/detr.DETR with detection) and
make_detr_detect_fn against the JAX package's, on the CPU, at full width
(d_model 256, 8 heads, dim_ff 2048, 100 queries, 151 classes) and reduced
depth: ResNet blocks (1, 1, 1, 1), 1 encoder and 2 decoder layers, on 64^2
images with half of one canvas padded (the 2x2 feature grid then has masked
keys in the decoder's cross-attention).

Weights come from tests/torch_detr.py's hub-named replica (random frozen-BN
statistics) through the JAX converter and detr_from_flax, and through
detr_from_hub_state_dict; both give the same state dict.  Tolerances:
float64 (JAX with x64 on) atol 1e-8 on pred_logits and pred_boxes, as the
JAX package holds itself against the replica; float32 1e-5 of the logits'
scale; bfloat16 compute: the port's error against the float64 forward at
most 2x JAX's.  The detect_fn's integer outputs are exact in float64."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from torch_detr import TorchDETR, randomize_bn_stats  # noqa: E402

from scene_graph_commonsense_tpu import config as jax_config  # noqa: E402
from scene_graph_commonsense_tpu.eval import engines as jax_engines  # noqa
from scene_graph_commonsense_tpu.models import detr as jdetr  # noqa: E402
from scene_graph_commonsense_tpu.models.weights import (  # noqa: E402
    convert_detr_state_dict)
from scene_graph_commonsense_torch import config as torch_config  # noqa
from scene_graph_commonsense_torch.eval import engines  # noqa: E402
from scene_graph_commonsense_torch.models import detr as tdetr  # noqa: E402
from scene_graph_commonsense_torch.models import weights  # noqa: E402

BLOCKS = (1, 1, 1, 1)
N_ENC, N_DEC = 1, 2


@pytest.fixture(scope="module")
def hub():
    torch.manual_seed(0)
    tm = TorchDETR(blocks=BLOCKS, n_enc=N_ENC, n_dec=N_DEC)
    randomize_bn_stats(tm)
    return tm.double().eval().requires_grad_(False)


@pytest.fixture(scope="module")
def flax_params(hub):
    return convert_detr_state_dict(
        {k: v.numpy() for k, v in hub.state_dict().items()},
        num_encoder_layers=N_ENC, num_decoder_layers=N_DEC, blocks=BLOCKS)


def _inputs(seed, b=2, size=64):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, size, size, 3))
    valid = np.ones((b, size, size), bool)
    valid[1, :, size // 2:] = False
    valid[1, size // 2:, :] = False
    return images, valid


@pytest.fixture(scope="module")
def jax_f64(flax_params):
    """The JAX detector's float64 outputs on _inputs(3), shared by the
    float64 and bfloat16 tests."""
    images, valid = _inputs(3)
    with jax.enable_x64():
        return _jax_forward(flax_params, "float64", images, valid)


def _cfgs(dtype):
    model = {"detr_blocks": BLOCKS, "detr_enc_layers": N_ENC,
             "detr_dec_layers": N_DEC, "compute_dtype": dtype,
             "fused_backbone": "off", "flash_encoder": "off"}
    return (jax_config.derive("vg", model=model),
            torch_config.derive("vg", model=model))


def _jax_forward(params, dtype, images, valid):
    jm = jdetr.DETR(num_encoder_layers=N_ENC, num_decoder_layers=N_DEC,
                    backbone_blocks=BLOCKS, dtype=jnp.dtype(dtype))
    if dtype != "float64":
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    out = jax.jit(jm.apply)(params, jnp.asarray(images), jnp.asarray(valid))
    return jax.tree.map(np.asarray, out)


def _port(cfg, state_dict):
    return tdetr.make_detr(cfg, device="cpu", state_dict=state_dict,
                           detection=True)


def test_torch_detr_weights_from_flax_and_hub_agree(hub, flax_params):
    from_flax = weights.detr_from_flax(flax_params)
    from_hub = weights.detr_from_hub_state_dict(hub.state_dict(), N_ENC,
                                                BLOCKS, N_DEC)
    assert from_flax.keys() == from_hub.keys()
    for k in from_flax:
        assert torch.equal(from_flax[k], from_hub[k]), k
    _, tc = _cfgs("float64")
    with torch.device("meta"):
        want = set(tdetr.module_from_cfg(tc, detection=True).state_dict())
    assert set(from_flax) == want
    for key in ("decoder_1.cross_attn.v_proj.weight", "decoder_norm.weight",
                "query_embed.weight", "class_embed.bias",
                "bbox_embed_2.weight"):
        assert key in want
    assert from_flax["class_embed.weight"].shape == (151, 256)
    assert from_flax["bbox_embed_2.weight"].shape == (4, 256)
    # the encode half alone is what a featurizer loads
    enc = weights.detr_encode_half(from_flax)
    with torch.device("meta"):
        assert set(enc) == set(tdetr.module_from_cfg(tc).state_dict())
    # a hub checkpoint of any decoder depth gives the encode half
    assert weights.detr_from_hub_state_dict(
        hub.state_dict(), N_ENC, BLOCKS, None).keys() == enc.keys()


def test_torch_detr_to_flax_round_trips(flax_params):
    sd = weights.detr_from_flax(flax_params)
    back = weights.detr_to_flax(sd)
    jax.tree.map(np.testing.assert_array_equal, back, flax_params)
    assert back["params"]["query_embed"].keys() == {"embedding"}
    assert back["params"]["decoder_norm"].keys() == {"scale", "bias"}
    assert back["params"]["decoder_0"]["norm3"].keys() == {"scale", "bias"}


@pytest.mark.parametrize("source", ["flax", "hub"])
def test_torch_detr_detection_matches_jax_f64(hub, flax_params, jax_f64,
                                              source):
    images, valid = _inputs(3)
    want = jax_f64
    _, tc = _cfgs("float64")
    sd = weights.detr_from_flax(flax_params) if source == "flax" else \
        weights.detr_from_hub_state_dict(hub.state_dict(), N_ENC, BLOCKS,
                                         N_DEC)
    port = _port(tc, sd)
    got = port(torch.from_numpy(images), torch.from_numpy(valid))
    assert got["pred_logits"].shape == (2, 100, 151)
    assert got["pred_boxes"].shape == (2, 100, 4)
    for k in ("pred_logits", "pred_boxes"):
        assert got[k].dtype == torch.float64
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-8,
                                   rtol=0, err_msg=k)
    # the hub replica itself (key-padding mask in torch's convention)
    ref = hub(torch.from_numpy(images.transpose(0, 3, 1, 2)),
              torch.from_numpy(valid))
    for k in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   atol=1e-8, rtol=0, err_msg=k)
    # the masked image's memory keys matter: its outputs differ from the
    # unmasked forward of the same pixels
    free = port(torch.from_numpy(images), None)
    assert not torch.allclose(free["pred_logits"][1], got["pred_logits"][1])
    torch.testing.assert_close(free["pred_logits"][0], got["pred_logits"][0],
                               atol=1e-12, rtol=0)
    # encode_features of the detector is the encode half's
    enc = tdetr.make_detr(tc, device="cpu",
                          state_dict=weights.detr_encode_half(sd))
    torch.testing.assert_close(
        port.encode_features(torch.from_numpy(images),
                             torch.from_numpy(valid)),
        enc.encode_features(torch.from_numpy(images),
                            torch.from_numpy(valid)), atol=0, rtol=0)


def test_torch_detr_detection_matches_jax_f32(flax_params):
    images, valid = _inputs(4)
    want = _jax_forward(flax_params, "float32", images.astype(np.float32),
                        valid)
    _, tc = _cfgs("float32")
    port = _port(tc, {k: v.float() for k, v in
                      weights.detr_from_flax(flax_params).items()})
    got = port(torch.from_numpy(images.astype(np.float32)),
               torch.from_numpy(valid))
    for k in ("pred_logits", "pred_boxes"):
        assert got[k].dtype == torch.float32
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k].numpy(), want[k],
                                   atol=1e-5 * scale, rtol=0, err_msg=k)


def test_torch_detr_detection_bf16_error_within_2x_jax(flax_params,
                                                      jax_f64):
    """bf16 compute on both sides: the float32 logits and boxes after the
    flax promotions (LayerNorm to float32, the heads rounded to bf16, then
    promoted), each side's error against the float64 forward."""
    images, valid = _inputs(3)
    truth = jax_f64
    want = _jax_forward(flax_params, "bfloat16", images.astype(np.float32),
                        valid)
    _, tc = _cfgs("bfloat16")
    port = _port(tc, {k: v.float() for k, v in
                      weights.detr_from_flax(flax_params).items()})
    got = port(torch.from_numpy(images.astype(np.float32)),
               torch.from_numpy(valid))
    for k in ("pred_logits", "pred_boxes"):
        assert got[k].dtype == torch.float32 and want[k].dtype == np.float32
        err = np.abs(got[k].double().numpy() - truth[k]).max()
        jax_err = np.abs(want[k].astype(np.float64) - truth[k]).max()
        assert 0 < err <= 2 * jax_err, (k, err, jax_err)


def test_torch_detr_detect_fn_matches_jax(hub, flax_params):
    """make_detr_detect_fn end to end (forward, postprocess, numpy out) in
    float64, with a pixel mask and without one (all pixels real)."""
    jc, tc = _cfgs("float64")
    images, valid = _inputs(6, b=3)
    port = _port(tc, weights.detr_from_flax(flax_params))
    jm = jdetr.make_detr(jc)
    for batch in ({"image_nonsq": images, "pixel_mask": valid},
                  {"image_nonsq": images}):
        with jax.enable_x64():
            want = jax.tree.map(np.asarray, jax_engines.make_detr_detect_fn(
                jc, jm, flax_params)(batch))
        got = engines.make_detr_detect_fn(tc, port)(batch)
        assert got.keys() == want.keys()
        for k in want:
            assert isinstance(got[k], np.ndarray)
            assert got[k].dtype == want[k].dtype, k
            if k in ("cats", "valid"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                np.testing.assert_allclose(got[k], want[k], atol=1e-8,
                                           rtol=0, err_msg=k)
        assert got["valid"].any() and got["cats"].shape == (3, 20)


def test_torch_detr_without_detection_refuses_to_detect():
    _, tc = _cfgs("float32")
    enc = tdetr.make_detr(tc, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    assert not enc.detection and not enc.decoder_layers()
    with pytest.raises(RuntimeError, match="detection=True"):
        enc(torch.zeros((1, 64, 64, 3)))
    det = tdetr.make_detr(tc, device="cpu", detection=True,
                          generator=torch.Generator().manual_seed(0))
    assert len(det.decoder_layers()) == N_DEC and det.num_classes == 151
    # one seed, the same encode half in both
    for k, v in enc.state_dict().items():
        assert torch.equal(v, det.state_dict()[k]), k
    oiv6 = torch_config.derive("oiv6", model={"detr_blocks": BLOCKS})
    with torch.device("meta"):
        assert tdetr.module_from_cfg(oiv6, detection=True).num_classes == 602
