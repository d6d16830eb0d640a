"""The port on real data from disk, on the CPU: PredCLS over the Python
loader's batches against the JAX package's, the feature cache that the
port's tools/precompute_features.py writes, the detector's encode half
against the featurizer, and the CLI without --synthetic
(python -m scene_graph_commonsense_torch ... --device cpu): train from the
Python loader and from SGRC v2 records, eval pc from v1 records and a
cache, eval sgc and sgd through a tiny DETR (ResNet (1, 1, 1, 1), one
encoder and one decoder layer; feature grid 8 at 256x256 images).  The data
is the repo's tools/make_mini_vg.py mini-VG (for PredCLS against JAX with
the edge cases of tests/test_torch_dataset.py).

Tolerances: the recall dict (R@k, mR@k, zsR@k, Top-3) equal to JAX's in
float64 on the same flax weights; cached features equal in both loaders;
the detector's features equal the featurizer's (same seed, exact)."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from test_engine import init_params  # noqa: E402
from test_torch_dataset import N_MAX, make_vg  # noqa: E402
from test_torch_eval import (  # noqa: E402
    ARTIFACTS_DIR, _assert_results_equal, _torch_model)

from scene_graph_commonsense_tpu.config import derive as jax_derive  # noqa
from scene_graph_commonsense_tpu.data import dataset as jax_dataset  # noqa
from scene_graph_commonsense_tpu.data.artifacts import (  # noqa: E402
    load_vg_artifacts as jax_load_artifacts)
from scene_graph_commonsense_tpu.eval import engines as jax_engines  # noqa
from scene_graph_commonsense_tpu.models.relation_head import (  # noqa: E402
    make_relation_classifier)
from scene_graph_commonsense_torch.config import derive  # noqa: E402
from scene_graph_commonsense_torch.data import dataset  # noqa: E402
from scene_graph_commonsense_torch.data.artifacts import (  # noqa: E402
    load_vg_artifacts)
from scene_graph_commonsense_torch.eval import engines  # noqa: E402
from scene_graph_commonsense_torch.train import loop  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_engine.py::tiny_cfg's relation head; the DETR of the CLI runs
TINY = {"feature_size": 16, "hidden_dim": 8, "num_img_feature": 16,
        "dropout_rate": 0.1}
DETR_MODEL = {"feature_size": 8, "image_size": 256, "hidden_dim": 8,
              "num_img_feature": 256, "compute_dtype": "float32",
              "detr_blocks": (1, 1, 1, 1), "detr_enc_layers": 1,
              "detr_dec_layers": 1}


def _load_split(data, split):
    with open(data[f"annotation_{split}"]) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def vg16(tmp_path_factory):
    """A mini-VG on the 16-cell grid of tiny_cfg, and a random feature
    cache of its test split."""
    root = tmp_path_factory.mktemp("mini_vg16")
    data = make_vg(root, feature_size=16)
    feat = root / "features"
    feat.mkdir()
    rng = np.random.default_rng(12)
    for img in _load_split(data, "test")["images"]:
        name = os.path.splitext(img["file_name"])[0]
        np.savez_compressed(feat / f"{name}_features.npz",
                            features=rng.standard_normal(
                                (16, 16, 16)).astype(np.float16))
    return {**data, "features_dir": str(feat)}


def test_torch_run_eval_pc_over_real_batches_matches_jax(vg16):
    data = {**vg16, "max_objects": N_MAX}
    training = {"batch_size": 3, "eval_mode": "pc"}
    model = {**TINY, "compute_dtype": "float64"}
    jc = jax_derive("vg", model=model, data=data, training=training)
    tc = derive("vg", model=model, data=data, training=training)
    ann = _load_split(vg16, "test")
    want_b = list(jax_dataset.batches_from_dataset(
        jax_dataset.VGDataset(jc, ann, training=False), 3, shuffle=False))
    got_b = list(dataset.batches_from_dataset(
        dataset.VGDataset(tc, ann, training=False), 3, shuffle=False))
    assert len(got_b) == len(want_b) == 2
    assert "features" in got_b[0] and "image" not in got_b[0]
    with jax.enable_x64():
        jm = make_relation_classifier(jc)
        params = init_params(jc, jm, None)
        want = jax_engines.run_eval_pc(
            jc, jm, params, want_b,
            artifacts=jax_load_artifacts(ARTIFACTS_DIR))
    got = engines.run_eval_pc(tc, _torch_model(tc, params), got_b,
                              artifacts=load_vg_artifacts(ARTIFACTS_DIR),
                              device="cpu")
    assert want["num_targets"] > 0
    _assert_results_equal(got, want)


@pytest.fixture(scope="module")
def vg8(tmp_path_factory):
    """A mini-VG on the 8-cell grid of the tiny DETR, its SGRC records
    (train v2, test v1), a feature cache of its test split written by the
    port's precompute_features, and the YAML files of the CLI runs."""
    from scene_graph_commonsense_torch.tools.precompute_features import (
        precompute_features)
    from scene_graph_commonsense_torch.tools.sgrecords import (
        write_sgrecords)
    root = tmp_path_factory.mktemp("mini_vg8")
    # no edge cases: the cache covers every image of the split (a partial
    # cache is rejected as a whole, tests/test_torch_dataset.py)
    data = {**make_vg(root, edge_cases=False), "max_objects": N_MAX,
            "nonsq_min_side": 128,
            "nonsq_canvas": 256}
    cfg = derive("vg", model=DETR_MODEL, data=data,
                 training={"batch_size": 2})
    quiet = dict(log_fn=lambda *a: None)
    assert write_sgrecords(cfg, "train", str(root / "sgrc_train"),
                           embed_images=True, **quiet) > 0
    assert write_sgrecords(cfg, "test", str(root / "sgrc_test"),
                           **quiet) > 0
    written = precompute_features(cfg, "test", str(root / "features"), 2,
                                  device="cpu")
    assert written > 0
    training = {"batch_size": 2, "num_epoch": 1, "print_freq": 1,
                "eval_freq": 0, "grad_clip_norm": 1.0, "test_epoch": 0,
                "checkpoint_path": str(root / "ck"),
                "result_path": str(root / "res")}
    yamls = {}
    for name, extra in (("python", {}),
                        ("sgrc", {"sgrc_dir": str(root / "sgrc_train")}),
                        ("cache", {"sgrc_dir": str(root / "sgrc_test"),
                                   "features_dir": str(root / "features")})):
        path = root / f"{name}.yaml"
        path.write_text(json.dumps({"model": {**DETR_MODEL, "detr_blocks":
                                              [1, 1, 1, 1]},
                                    "data": {**data, **extra},
                                    "training": training}))
        yamls[name] = str(path)
    return {"root": root, "data": data, "yamls": yamls, "written": written,
            "cfg": cfg}


def _cli(yaml_path, *args):
    return subprocess.run(
        [sys.executable, "-m", "scene_graph_commonsense_torch", "--hierar",
         "--config", yaml_path, "--device", "cpu", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=600)


def test_torch_precompute_features_cache_read_by_both_loaders(vg8):
    cfg = vg8["cfg"]
    feat = vg8["root"] / "features"
    names = sorted(p.name for p in feat.iterdir())
    assert len(names) == vg8["written"]
    f = np.load(feat / names[0])
    assert list(f.files) == ["features"]
    assert f["features"].dtype == np.float16
    assert f["features"].shape == (8, 8, 256)
    # the featurizer's own output at float16 (the same seeded weights)
    featurize, _ = loop.load_detr_featurizer(cfg, "cpu",
                                             log_fn=lambda *a: None)
    ann = _load_split(vg8["data"], "test")
    batch = next(dataset.batches_from_dataset(
        dataset.VGDataset(cfg, ann, training=False), 2, shuffle=False))
    want = featurize(batch)["features"].numpy().astype(np.float16)
    name = os.path.basename(batch["annot_path"][0]).replace(
        "_annotations.pkl", "_features.npz")
    assert np.array_equal(np.load(feat / name)["features"], want[0])
    # both packages' loaders read the cache alike
    data = {**vg8["data"], "features_dir": str(feat)}
    jc = jax_derive("vg", model={"feature_size": 8}, data=data)
    tc = derive("vg", model={"feature_size": 8}, data=data)
    got = next(dataset.batches_from_dataset(
        dataset.VGDataset(tc, ann, training=False), 2, shuffle=False))
    want = next(jax_dataset.batches_from_dataset(
        jax_dataset.VGDataset(jc, ann, training=False), 2, shuffle=False))
    assert got["features"].dtype == want["features"].dtype == np.float32
    assert np.array_equal(got["features"], want["features"])


def test_torch_detector_encode_half_equals_featurizer(vg8):
    """One detector gives SGCLS/SGDET their features and detections: its
    encode half, from the same seed, equals load_detr_featurizer's."""
    cfg = vg8["cfg"]
    quiet = dict(log_fn=lambda *a: None)
    featurize, _ = loop.load_detr_featurizer(cfg, "cpu", **quiet)
    detr = loop.load_detr(cfg, "cpu", detection=True, **quiet)
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal((2, 256, 256, 3)).astype(
        np.float32)}
    want = featurize(batch)["features"]
    got = loop.make_detr_featurize_fn(cfg, detr)(batch)["features"]
    assert got.shape == (2, 8, 8, 256)
    assert torch.equal(got, want)


@pytest.mark.parametrize("source", ["python", "sgrc"])
def test_torch_cli_trains_on_real_data(vg8, source):
    res = _cli(vg8["yamls"][source], "--run_mode", "train", "--eval_mode",
               "pc")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "TRAIN, epoch 0, batch 0" in res.stdout
    assert "TEST, epoch 0, R@k" in res.stdout
    ck = vg8["root"] / "ck" / "HierRelationModel_Baseline_motif0.pt"
    assert ck.exists()
    with open(vg8["root"] / "res" / "test_results.json") as f:
        rec = json.load(f)[-1]
    assert rec["epoch"] == 0 and len(rec["recall"]) == 3


@pytest.mark.parametrize("mode,yaml_name", [("pc", "cache"),
                                            ("sgc", "python"),
                                            ("sgd", "python")])
def test_torch_cli_evaluates_real_data(vg8, mode, yaml_name):
    res = _cli(vg8["yamls"][yaml_name], "--run_mode", "eval", "--eval_mode",
               mode)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(out["recall"]) == 3
    assert all(0 <= r <= 1 for r in out["recall"])
    assert out["num_targets"] > 0
    assert ("top3" in out) == (mode == "pc")
