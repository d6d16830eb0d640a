"""The port's featurize slice end to end against the JAX package's, on the
CPU: SceneGraphPredictor.predict from images through the frozen DETR, the
featurize function's single 2B dispatch, fit(featurize=) on the prefetch
thread, and load_detr_featurizer.

Sizes are reduced (DETR trunk blocks (1,1,1,1), one encoder layer of width
16, 256x256 images -> an 8x8 feature map for a tiny relation head).
Tolerances: float64 (JAX with x64 on) equal ranked edge ids and
confidences within 1e-8; the 2B dispatch equals two B dispatches within
1e-12 (float64, only the summation blocking may differ)."""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from test_engine import init_params  # noqa: E402
from torch_detr import TorchDETR  # noqa: E402

from scene_graph_commonsense_tpu import config as jax_config  # noqa: E402
from scene_graph_commonsense_tpu.inference import (  # noqa: E402
    SceneGraphPredictor as JaxPredictor)
from scene_graph_commonsense_tpu.models import detr as jdetr  # noqa: E402
from scene_graph_commonsense_tpu.models.relation_head import (  # noqa: E402
    make_relation_classifier)
from scene_graph_commonsense_torch import config as torch_config  # noqa
from scene_graph_commonsense_torch.data.artifacts import (  # noqa: E402
    load_vg_artifacts)
from scene_graph_commonsense_torch.data.pipeline import (  # noqa: E402
    prefetch_iterator)
from scene_graph_commonsense_torch.data.synthetic import (  # noqa: E402
    synthetic_batch, synthetic_images)
from scene_graph_commonsense_torch.inference import (  # noqa: E402
    SceneGraphPredictor)
from scene_graph_commonsense_torch.models import detr as tdetr  # noqa: E402
from scene_graph_commonsense_torch.models import weights  # noqa: E402
from scene_graph_commonsense_torch.models.relation_head import (  # noqa
    make_relation_classifier as make_torch_classifier)
from scene_graph_commonsense_torch.train import loop  # noqa: E402

BLOCKS = (1, 1, 1, 1)
WIDTH = dict(d_model=16, nhead=2, dim_ff=32)
FS, IMG = 8, 256                   # feature map side, image side (FS * 32)


def _model_cfg(dtype):
    return {"feature_size": FS, "hidden_dim": 8, "num_img_feature": 16,
            "compute_dtype": dtype, "dropout_rate": 0.0,
            "detr_blocks": BLOCKS, "detr_enc_layers": 1}


def _cfgs(dtype="float64", **training):
    kw = dict(model=_model_cfg(dtype), data={"max_objects": 6},
              training={"batch_size": 2, **training})
    return jax_config.derive("vg", **kw), torch_config.derive("vg", **kw)


def _objects(rng, n_img):
    """An image batch's object annotations (no features, no relations)."""
    b = synthetic_batch(rng, batch_size=n_img, max_objects=6,
                        feature_size=FS, num_channels=16, with_aug=False)
    return {k: v for k, v in b.items() if k not in ("features", "rel")}


def _port_detr(dtype, params=None):
    tm = tdetr.DETR(**WIDTH, num_encoder_layers=1, backbone_blocks=BLOCKS,
                    dtype=getattr(torch, dtype))
    if params is not None:
        tm.load_state_dict(weights.detr_from_flax(params))
    else:
        torch.manual_seed(0)
    return tm.to(getattr(torch, dtype)).eval().requires_grad_(False)


@pytest.fixture(scope="module")
def jax_weights():
    """float32 flax weights of the tiny relation head and DETR."""
    jc, _ = _cfgs("float32")
    rel = jax.tree.map(np.asarray, jax.jit(lambda: init_params(
        jc, make_relation_classifier(jc), None))())
    jm = jdetr.DETR(**WIDTH, num_encoder_layers=1, num_decoder_layers=1,
                    backbone_blocks=BLOCKS)
    init = jax.jit(lambda key: jm.init(
        key, jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 64, 64), bool),
        method=jdetr.DETR.encode_features))
    detr = jax.tree.map(np.asarray, init(jax.random.PRNGKey(1)))
    return rel, detr


def test_torch_predictor_from_images_matches_jax(jax_weights):
    rel, detr = jax_weights
    jc, tc = _cfgs("float64")
    rng = np.random.default_rng(11)
    batch = {**_objects(rng, 2),
             **synthetic_images(rng, 2, IMG, with_aug=False)}
    batch["image"] = batch["image"].astype(np.float64)
    with jax.enable_x64():
        jm = jdetr.DETR(**WIDTH, num_encoder_layers=1, num_decoder_layers=1,
                        backbone_blocks=BLOCKS, dtype=jnp.float64)
        detr64 = jax.tree.map(lambda a: a.astype(np.float64), detr)
        want = JaxPredictor(jc, rel, detr_model=jm, detr_params=detr64,
                            use_pallas_pool=False).predict(
            {k: jnp.asarray(v) for k, v in batch.items()}, top_k=10)
    model = make_torch_classifier(tc, device="cpu",
                                  state_dict=weights.from_flax(rel))
    got = SceneGraphPredictor(tc, model, detr_model=_port_detr("float64"),
                              detr_params=weights.detr_from_flax(detr),
                              device="cpu").predict(batch, top_k=10)
    assert len(got) == len(want) == 2
    assert sum(len(edges) for edges in got) > 0
    for g_edges, w_edges in zip(got, want):
        assert len(g_edges) == len(w_edges)
        for g, w in zip(g_edges, w_edges):
            assert g.keys() == w.keys()
            for k in w:
                if k == "confidence":
                    assert abs(g[k] - w[k]) <= 1e-8
                else:
                    assert g[k] == w[k], k


def test_torch_featurize_one_dispatch_for_both_views(jax_weights):
    _, detr = jax_weights
    _, tc = _cfgs("float64")
    tm = _port_detr("float64", detr)
    calls = []
    encode = tm.encode_features

    def counted(images, *a):
        calls.append(images.shape[0])
        return encode(images, *a)
    tm.encode_features = counted
    featurize = loop.make_detr_featurize_fn(tc, tm)
    rng = np.random.default_rng(12)
    images = {k: v.astype(np.float64)
              for k, v in synthetic_images(rng, 2, IMG).items()}
    out = featurize({**images, "cats": np.zeros((2, 6), np.int32)})
    assert calls == [4]                            # one 2B dispatch
    assert "image" not in out and "image_aug" not in out
    assert out["features"].shape == out["features_aug"].shape \
        == (2, FS, FS, 16)
    assert not out["features"].is_inference()
    solo = featurize({"image": images["image"]})["features"]
    solo_aug = featurize({"image_aug": images["image_aug"]})["features_aug"]
    assert calls == [4, 2, 2]
    np.testing.assert_allclose(out["features"].numpy(), solo.numpy(),
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(out["features_aug"].numpy(),
                               solo_aug.numpy(), atol=1e-12, rtol=0)
    # cached features are kept; no model is needed then
    cached = {"features": np.ones(3), "image": images["image"]}
    kept = loop.make_detr_featurize_fn(tc, None)(cached)
    assert kept.keys() == {"features"} and kept["features"] is \
        cached["features"]


def test_torch_prefetch_runs_the_transform_on_the_producer_thread():
    main = threading.get_ident()
    seen = []

    def transform(b):
        seen.append(threading.get_ident())
        return {**b, "t": True}

    got = list(prefetch_iterator([{"i": i} for i in range(3)], 2, transform))
    assert [b["i"] for b in got] == [0, 1, 2] and all(b["t"] for b in got)
    assert len(seen) == 3 and main not in seen


def test_torch_fit_featurizes_image_batches(tmp_path):
    _, tc = _cfgs("float32", num_epoch=1, print_freq=1, eval_freq=1,
                  grad_clip_norm=1.0,
                  checkpoint_path=str(tmp_path / "ck"),
                  result_path=str(tmp_path / "res"))
    model = make_torch_classifier(tc, device="cpu")
    featurize = loop.make_detr_featurize_fn(tc, _port_detr("float32"))
    threads, dispatches = [], []

    def counted(batch):
        threads.append(threading.get_ident())
        dispatches.append(sorted(k for k in batch if k.startswith("image")))
        return featurize(batch)

    def batches(n, seed, with_aug):
        rng = np.random.default_rng(seed)
        for _ in range(n):
            b = synthetic_batch(rng, batch_size=2, max_objects=6,
                                feature_size=FS, num_channels=16,
                                with_aug=False)
            del b["features"]
            yield {**b, **synthetic_images(rng, 2, IMG, with_aug=with_aug),
                   "annot_path": "x"}

    before = model.fc1.weight.detach().clone()
    lines = []
    state = loop.fit(tc, model, lambda e: batches(2, e, True),
                     lambda e: batches(1, 100 + e, False), steps_per_epoch=2,
                     artifacts=load_vg_artifacts("datasets/artifacts"),
                     device="cpu", featurize=counted, log_fn=lines.append)
    assert state.step == 2
    assert not torch.equal(before, model.fc1.weight)
    assert dispatches == [["image", "image_aug"]] * 2 + [["image"]]
    assert threading.get_ident() not in threads
    assert sum(ln.startswith("TRAIN") for ln in lines) == 2
    assert sum(ln.startswith("TEST") for ln in lines) == 1


def test_torch_load_detr_featurizer(tmp_path):
    def cfg(path):
        return torch_config.derive("vg", model={
            "detr_blocks": BLOCKS, "detr_enc_layers": 1,
            "compute_dtype": "float32", "detr_pretrained": str(path)})

    lines = []
    featurize, detr = loop.load_detr_featurizer(
        cfg(tmp_path / "absent.msgpack"), device="cpu",
        generator=torch.Generator().manual_seed(5), log_fn=lines.append)
    assert len(lines) == 1 and lines[0].startswith("WARNING")
    _, again = loop.load_detr_featurizer(
        cfg(tmp_path / "absent.pth"), device="cpu",
        generator=torch.Generator().manual_seed(5), log_fn=lines.append)
    sd = detr.state_dict()
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())
    assert not detr.encoder_0.flash           # auto: off on the CPU

    # an empty flax checkpoint (a msgpack map of nothing) lacks every key
    (tmp_path / "detr.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="keys missing"):
        loop.load_detr_featurizer(cfg(tmp_path / "detr.msgpack"),
                                  device="cpu")

    torch.manual_seed(0)
    hub = TorchDETR(blocks=BLOCKS, n_enc=1, n_dec=1)
    torch.save({"model": hub.state_dict()}, tmp_path / "detr.pth")
    featurize, detr = loop.load_detr_featurizer(
        cfg(tmp_path / "detr.pth"), device="cpu", log_fn=lines.append)
    want = weights.detr_from_hub_state_dict(hub.state_dict(), 1, BLOCKS,
                                            None)
    assert all(torch.equal(detr.state_dict()[k], v) for k, v in want.items())
    out = featurize({"image": np.zeros((1, 64, 64, 3), np.float32)})
    assert out["features"].shape == (1, 2, 2, 256)
