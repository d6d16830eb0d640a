"""The port's OIv6 path (data/oiv6.py, ops/boxes.resize_box /
union_mask_iou, the CLI's --dataset oiv6) against the JAX package's on the
CPU.

Tolerances: examples and batches equal key by key (np.array_equal, same
dtype); resize_box and union_mask_iou exact (the IoU compared in float32,
the JAX package's dtype without x64); the PredCLS result dict (recall,
mR, zsR, weighted mAP) equal in float64 (JAX with x64 on)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_engine import init_params
from test_oiv6_vis import make_oiv6_fixture

from scene_graph_commonsense_tpu.config import derive as jax_derive
from scene_graph_commonsense_tpu.data.oiv6 import (
    OIV6Dataset as JaxOIV6Dataset, oiv6_batches as jax_oiv6_batches)
from scene_graph_commonsense_tpu.eval.engines import (
    run_eval_pc as jax_run_eval_pc)
from scene_graph_commonsense_tpu.models.relation_head import (
    make_relation_classifier as make_jax_classifier)
from scene_graph_commonsense_tpu.ops import boxes as jax_boxes
from scene_graph_commonsense_torch import config as torch_config
from scene_graph_commonsense_torch.constants import (
    OIV6_RELATIONS, OIV6_REORDER_BY_SUPER)
from scene_graph_commonsense_torch.data.oiv6 import (
    OIV6Dataset, oiv6_batches)
from scene_graph_commonsense_torch.eval.engines import run_eval_pc
from scene_graph_commonsense_torch.models import weights
from scene_graph_commonsense_torch.models.relation_head import (
    make_relation_classifier)
from scene_graph_commonsense_torch.ops import boxes
from scene_graph_commonsense_torch.tools.make_mini_oiv6 import (
    data_config, make_mini_oiv6)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS, N_MAX, C_FEAT = 8, 6, 16
MODEL = {"feature_size": FS, "hidden_dim": 8, "num_img_feature": C_FEAT,
         "image_size": 64, "compute_dtype": "float64", "dropout_rate": 0.0}


def cfgs(data=None):
    jc = jax_derive("oiv6", model=dict(MODEL),
                    data={"max_objects": N_MAX, **(data or {})},
                    training={"batch_size": 4})
    tc = torch_config.derive("oiv6", model=dict(MODEL),
                             data={"max_objects": N_MAX, **(data or {})},
                             training={"batch_size": 4})
    return jc, tc


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """A mini-OIv6 of 10 JPEGs plus edge-case records (one object: dropped;
    seven objects: dropped at 6; a missing image; self and out-of-range
    triplets), with a full feature cache."""
    root = tmp_path_factory.mktemp("oiv6")
    make_mini_oiv6(str(root), images=10, max_objects=N_MAX, feature_size=FS,
                   sizes=((48, 64), (64, 40), (64, 64)))
    extra = [
        {"img_fn": "one", "img_size": [64, 48], "det_labels": [3],
         "bbox": [[0, 0, 10, 10]], "rel": []},
        {"img_fn": "seven", "img_size": [64, 48],
         "det_labels": list(range(7)), "bbox": [[0, 0, 10, 10]] * 7,
         "rel": [[0, 1, 2]]},
        {"img_fn": "noimage", "img_size": [64, 48], "det_labels": [1, 2],
         "bbox": [[0, 0, 30, 30], [5, 5, 40, 40]], "rel": [[0, 1, 3]]},
        {"img_fn": "oiv6_000000", "img_size": [64, 48],
         "det_labels": [4, 5, 6],
         "bbox": [[0, 0, 33, 21], [10, 5, 63, 47], [1, 2, 3, 4]],
         "rel": [[0, 0, 1], [0, 5, 2], [2, 1, 29], [1, 2, 13]]},
    ]
    for split in ("train", "test"):
        path = root / f"vrd-{split}-anno.json"
        recs = json.loads(path.read_text())
        for i, rec in enumerate(extra):
            recs.insert(2 * i + 1, rec)
        path.write_text(json.dumps(recs))
    feats = root / "features"
    feats.mkdir()
    rng = np.random.default_rng(7)
    names = {r["img_fn"] for split in ("train", "test") for r in json.loads(
        (root / f"vrd-{split}-anno.json").read_text())}
    for name in sorted(names):
        np.savez(feats / f"{name}_features.npz",
                 features=rng.standard_normal((FS, FS, C_FEAT)).astype(
                     np.float32))
    return {**data_config(str(root)), "features_dir": str(feats)}


def assert_same(got, want):
    """Examples or batches: the same keys, equal arrays of one dtype."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if w is None or isinstance(w, (str, list)):
            assert g == w, k
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), k


def test_torch_oiv6_constants_equal_jax():
    from scene_graph_commonsense_tpu import constants as jc
    assert OIV6_RELATIONS == jc.OIV6_RELATIONS
    np.testing.assert_array_equal(OIV6_REORDER_BY_SUPER,
                                  jc.OIV6_REORDER_BY_SUPER)
    assert OIV6_REORDER_BY_SUPER.dtype == jc.OIV6_REORDER_BY_SUPER.dtype


def test_torch_resize_box_and_union_mask_iou_exact():
    rng = np.random.default_rng(0)
    for _ in range(200):
        box = list(rng.uniform(0, 900, 4))
        size = tuple(rng.integers(50, 1000, 2))
        new = tuple(rng.integers(8, 64, 2))
        assert boxes.resize_box(box, size, new) == jax_boxes.resize_box(
            box, size, new)
    quads = [rng.uniform(-2, 36, (500, 4)) for _ in range(4)]
    for q in quads:                      # some empty and inverted boxes
        q[:50, 1] = q[:50, 0]
    want = np.asarray(jax_boxes.union_mask_iou(*map(jnp.asarray, quads)))
    got = boxes.union_mask_iou(*map(torch.as_tensor, quads)).numpy()
    assert got.dtype == np.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0 < (got > 0).mean() < 1


@pytest.mark.parametrize("images,cache", [(False, False), (True, False),
                                          (True, True)])
def test_torch_oiv6_examples_and_batches_equal_jax(mini, images, cache):
    data = dict(mini)
    if not cache:
        data["features_dir"] = ""
    jc, tc = cfgs(data)
    for split in ("train", "test"):
        path = data[f"annotation_{split}"]
        kw = dict(training=split == "train", image_dir=data["image_dir"],
                  depth_dir=data["depth_dir"], load_images=images)
        jds, tds = JaxOIV6Dataset(jc, path, **kw), OIV6Dataset(tc, path, **kw)
        assert len(jds) == len(tds) == 9
        dropped = 0
        for i in range(len(jds)):
            want, got = jds.get_example(i), tds.get_example(i)
            if want is None:
                assert got is None
                dropped += 1
                continue
            assert_same(got, want)
            assert ("image" in got) == (images and not cache)
            assert ("features" in got) == cache
            assert ("image_nonsq" in got) == images
        assert dropped == (3 if images else 2)
        for seed, shuffle in ((0, False), (3, True)):
            want = list(jax_oiv6_batches(jds, 4, seed=seed, shuffle=shuffle))
            got = list(oiv6_batches(tds, 4, seed=seed, shuffle=shuffle))
            kept = len(jds) - dropped
            assert len(got) == len(want) == -(-kept // 4)
            for g, w in zip(got, want):
                assert_same(g, w)
            # the last batch is padded with fillers holding no object
            assert kept % 4 and not got[-1]["valid"][kept % 4:].any()


def test_torch_oiv6_fixture_of_the_jax_tests_equal(tmp_path):
    """The JAX package's own OIv6 fixture (tests/test_oiv6_vis.py), no
    images: the same examples and batches."""
    path = make_oiv6_fixture(tmp_path)
    jc, tc = cfgs()
    jds, tds = JaxOIV6Dataset(jc, path, training=False), \
        OIV6Dataset(tc, path, training=False)
    for i in range(len(jds)):
        assert_same(tds.get_example(i), jds.get_example(i))
    got = list(oiv6_batches(tds, 2, shuffle=False))
    want = list(jax_oiv6_batches(jds, 2, shuffle=False))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_same(g, w)
    assert "super_mh" not in got[0]


def test_torch_oiv6_predcls_eval_equals_jax(mini):
    """PredCLS on OIv6 batches from the feature cache, the same flax
    weights in both packages: the same recall, mR and weighted-mAP dict."""
    jc, tc = cfgs(mini)
    jax_model = make_jax_classifier(jc)
    with jax.enable_x64():
        params = jax.tree.map(lambda x: np.asarray(x, np.float64),
                              init_params(jc, jax_model, None))
        jds = JaxOIV6Dataset(jc, mini["annotation_test"], training=False)
        batches = list(jax_oiv6_batches(jds, 4, shuffle=False))
        want = jax_run_eval_pc(jc, jax_model, params, batches)
    sd = {k: v.to(torch.float64) for k, v in
          weights.from_flax(params).items()}
    model = make_relation_classifier(tc, device="cpu", state_dict=sd) \
        .to(torch.float64)
    tds = OIV6Dataset(tc, mini["annotation_test"], training=False)
    got = run_eval_pc(tc, model, oiv6_batches(tds, 4, shuffle=False),
                      device="cpu")
    assert {"wmap_rel", "wmap_phrase"} <= set(got)
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "recall_per_class":
            continue
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                      err_msg=k)
    assert want["num_targets"] > 0


def _tiny_yaml(tmp_path, data):
    """The CLI's YAML: a tiny DETR and relation head, the mini-OIv6."""
    cfg = {
        "training": {"batch_size": 4, "num_epoch": 1, "print_freq": 1,
                     "eval_freq": 1, "test_epoch": 0, "grad_clip_norm": 1.0,
                     "checkpoint_path": str(tmp_path / "ckpt"),
                     "result_path": str(tmp_path / "results")},
        "model": {"feature_size": FS, "image_size": 256, "hidden_dim": 8,
                  "num_img_feature": 256, "compute_dtype": "float32",
                  "detr_blocks": [1, 1, 1, 1], "detr_enc_layers": 1,
                  "detr_dec_layers": 1},
        "data": {"nonsq_min_side": 128, "nonsq_canvas": 256,
                 "max_objects": N_MAX, **data},
    }
    path = tmp_path / "cfg.yaml"
    import yaml
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _cli(tmp_path, *args):
    return subprocess.run(
        [sys.executable, "-m", "scene_graph_commonsense_torch", "--hierar",
         "--dataset", "oiv6", "--eval_mode", "pc", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=600)


def test_torch_cli_oiv6_train_then_eval_on_cpu(mini, tmp_path):
    """--dataset oiv6 from images (the tiny DETR): train saves its
    checkpoint, eval loads it and prints recall with the weighted mAP."""
    data = {k: v for k, v in mini.items() if k != "features_dir"}
    yaml_path = _tiny_yaml(tmp_path, data)
    res = _cli(tmp_path, "--run_mode", "train", "--config", yaml_path,
               "--device", "cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "TEST, epoch 0" in res.stdout
    assert (tmp_path / "ckpt" / "HierRelationModel_Baseline_motif0.pt") \
        .exists()
    res = _cli(tmp_path, "--run_mode", "eval", "--config", yaml_path,
               "--device", "cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Loaded relation checkpoint" in res.stdout
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert {"recall", "mean_recall", "wmap_rel", "wmap_phrase"} <= set(out)
    assert out["num_targets"] > 0 and 0 <= out["wmap_rel"] <= 1
