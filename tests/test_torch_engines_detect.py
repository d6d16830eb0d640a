"""The port's SGCLS and SGDET engines (eval/engines.py: run_eval_sgc,
run_eval_sgd, match_predicted_labels(_top2)) and eval/builders.
sgd_target_keep against the JAX package's, on the CPU, on
tests/test_engine.py::tiny_cfg batches with one deterministic detection
dict per batch fed to both packages (detections near the GT boxes, each box
twice with its top-2 classes, as the post-process gives them).

Tolerances: float64 (JAX with x64 on) on the same flax weights; R@k, mR@k
and zsR@k equal; matched labels, slot grids and keep masks exact, matched
confidences within 1e-7 (float32).  Also the CLI's --eval_mode sgd
--synthetic exit, main.py's; and OIv6 SGCLS / SGDET, which the port refuses
(VG's 151-entry class remap has no OIv6 counterpart; JAX's gather clamps
every OIv6 class from 150 on to 150)."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from test_engine import init_params  # noqa: E402
from test_torch_eval import (  # noqa: E402
    ARTIFACTS_DIR, _assert_results_equal, _cfgs, _cli, _torch_model)

from scene_graph_commonsense_tpu.data.artifacts import (  # noqa: E402
    load_vg_artifacts as jax_load_artifacts)
from scene_graph_commonsense_tpu.data.synthetic import (  # noqa: E402
    synthetic_batch)
from scene_graph_commonsense_tpu.eval import builders as jax_builders  # noqa
from scene_graph_commonsense_tpu.eval import engines as jax_engines  # noqa
from scene_graph_commonsense_tpu.models.relation_head import (  # noqa: E402
    make_relation_classifier)
from scene_graph_commonsense_tpu.ops import detection as jax_detection  # noqa
from scene_graph_commonsense_torch import config as torch_config  # noqa
from scene_graph_commonsense_torch.constants import OBJ_ALP2FRE  # noqa: E402
from scene_graph_commonsense_torch.data.artifacts import (  # noqa: E402
    load_vg_artifacts)
from scene_graph_commonsense_torch.eval import builders  # noqa: E402
from scene_graph_commonsense_torch.eval import engines  # noqa: E402
from scene_graph_commonsense_torch.ops import detection  # noqa: E402


def _detections(rng, batch, num_classes):
    """A detection dict for one batch: for each of the first N/2 valid GT
    boxes, its box jittered by up to one cell, twice (slots 2k, 2k + 1)
    with two classes (the GT class or another, then another) and
    descending confidences; the last image gets a single valid slot (fewer
    than two: SGCLS's top-2 matching drops it)."""
    boxes = np.asarray(batch["boxes"])
    valid = np.asarray(batch["valid"])
    cats = np.asarray(batch["cats"])
    b, n = valid.shape
    d_boxes = np.zeros((b, n, 4), np.float32)
    d_cats = np.zeros((b, n), np.int32)
    d_conf = np.zeros((b, n), np.float32)
    d_valid = np.zeros((b, n), bool)
    for i in range(b):
        live = np.nonzero(valid[i])[0][:n // 2]
        for k, j in enumerate(live):
            box = boxes[i, j] + rng.integers(-1, 2, 4)
            box = np.clip(box, 0, None)
            c1 = cats[i, j] if rng.random() < 0.7 \
                else rng.integers(num_classes)
            p = rng.uniform(0.4, 0.9)
            for s, (c, conf) in enumerate(((c1, p), (
                    rng.integers(num_classes), p * rng.uniform(0.2, 0.9)))):
                d_boxes[i, 2 * k + s] = box
                d_cats[i, 2 * k + s] = c
                d_conf[i, 2 * k + s] = conf
                d_valid[i, 2 * k + s] = True
    d_valid[-1, 1:] = False
    d_conf[~d_valid] = 0
    return {"cats": d_cats, "cat_conf": d_conf, "boxes": d_boxes,
            "valid": d_valid}


@pytest.fixture(scope="module")
def setup():
    jc, _ = _cfgs("float32")
    params = init_params(jc, make_relation_classifier(jc), None)
    rng = np.random.default_rng(11)
    batches = [synthetic_batch(
        rng, batch_size=jc.training.batch_size,
        max_objects=jc.data.max_objects, feature_size=jc.model.feature_size,
        num_channels=jc.model.num_img_feature,
        num_classes=jc.model.num_classes, with_aug=False) for _ in range(3)]
    dets = [_detections(rng, b, jc.model.num_classes) for b in batches]
    return params, batches, dets


def _with_training(cfg, **training):
    return cfg.replace(training=dataclasses.replace(cfg.training,
                                                    **training))


def test_torch_match_predicted_labels_match_jax(setup):
    _, batches, dets = setup
    for batch, det in zip(batches, dets):
        gt_boxes, gt_valid = batch["boxes"], batch["valid"]
        got = engines.match_predicted_labels(det, gt_boxes, gt_valid, 16)
        want = jax_engines.match_predicted_labels(det, gt_boxes, gt_valid,
                                                  16)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=1e-7, rtol=0)
        got2 = engines.match_predicted_labels_top2(det, gt_boxes, gt_valid,
                                                   16)
        want2 = jax_engines.match_predicted_labels_top2(det, gt_boxes,
                                                        gt_valid, 16)
        for g, w in zip(got2, want2):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=1e-7, rtol=0)
        # duplicated GT boxes on exact top-2 ties, the short image dropped
        assert got2[3][:, 1::2].any() and not got2[3][-1].any()
        np.testing.assert_array_equal(
            builders.sgd_target_keep(gt_valid),
            jax_builders.sgd_target_keep(gt_valid))


def _run_both(setup, mode, **training):
    params, batches, dets = setup
    jc, tc = _cfgs("float64")
    jc, tc = _with_training(jc, **training), _with_training(tc, **training)
    jax_run = jax_engines.run_eval_sgc if mode == "sgc" \
        else jax_engines.run_eval_sgd
    port_run = engines.run_eval_sgc if mode == "sgc" \
        else engines.run_eval_sgd
    j_dets, t_dets = iter(dets), iter(dets)
    with jax.enable_x64():
        want = jax_run(
            jc, make_relation_classifier(jc), params,
            [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
            lambda batch: next(j_dets),
            artifacts=jax_load_artifacts(ARTIFACTS_DIR))
    got = port_run(tc, _torch_model(tc, params), batches,
                   lambda batch: next(t_dets),
                   artifacts=load_vg_artifacts(ARTIFACTS_DIR), device="cpu")
    assert want["num_targets"] > 0 and "top3" not in got
    assert all(0 <= r <= 1 for r in got["recall"])
    _assert_results_equal(got, want)
    return got


@pytest.mark.parametrize("top2,faithful_sgd,faithful_eval", [
    (False, False, False), (True, False, False), (False, True, False),
    (True, True, True)])
def test_torch_run_eval_sgc_matches_jax(setup, top2, faithful_sgd,
                                        faithful_eval):
    _run_both(setup, "sgc", sgcls_top2_duplicates=top2,
              faithful_sgd_targets=faithful_sgd,
              faithful_eval_targets=faithful_eval)


@pytest.mark.parametrize("faithful_sgd,faithful_eval", [
    (False, False), (True, False), (True, True)])
def test_torch_run_eval_sgd_matches_jax(setup, faithful_sgd, faithful_eval):
    _run_both(setup, "sgd", faithful_sgd_targets=faithful_sgd,
              faithful_eval_targets=faithful_eval)


def test_torch_cli_sgd_synthetic_exits_as_main(tmp_path):
    for mode in ("sgd", "sgc"):
        res = _cli(tmp_path, "--run_mode", "eval", "--eval_mode", mode,
                   "--synthetic", "2", "--device", "cpu")
        assert res.returncode != 0
        assert "sgc/sgd need detector outputs" in res.stderr


def test_torch_oiv6_detection_remap_is_refused():
    """An OIv6 detector has 602 logits, VG's class remap 151 entries: JAX's
    gather clamps the index, so every OIv6 class from 150 on becomes class
    150 (the classes below go through VG's permutation); torch's indexing
    raises.  The port refuses OIv6 SGCLS / SGDET before it detects:
    make_detr_detect_fn (which run_eval_sgc / run_eval_sgd take their
    detections from) raises the ValueError naming the remap and the
    detector's class count, and the CLI exits with it before it builds the
    detector."""
    oiv6 = torch_config.derive("oiv6")
    classes = oiv6.model.num_classes + 1
    assert classes == 602 and len(OBJ_ALP2FRE) == 151
    top = np.array([3, 149, 150, 151, 400, 601])
    logits = np.full((1, len(top), classes), -10.0, np.float32)
    logits[0, np.arange(len(top)), top] = 10.0
    logits[0, np.arange(len(top)), (top + 1) % classes] = 9.0
    # apart, so that the class-aware NMS keeps every query's classes
    boxes = np.array([[[0.1 + 0.15 * i, 0.5, 0.1, 0.1]
                       for i in range(len(top))]], np.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        jax_cats = jnp.asarray(OBJ_ALP2FRE)[jnp.asarray(top)]
        det = jax_detection.postprocess_detections(
            jnp.asarray(logits), jnp.asarray(boxes), OBJ_ALP2FRE,
            num_classes=classes - 1, max_objects=2 * len(top))
    np.testing.assert_array_equal(
        np.asarray(jax_cats), [OBJ_ALP2FRE[3], OBJ_ALP2FRE[149], 150, 150,
                               150, 150])
    got = np.asarray(det["cats"])[np.asarray(det["valid"])]
    assert set(got) <= set(OBJ_ALP2FRE.tolist())
    # the top-1 of the queries at 150, 151 and 400 (601 is no object)
    assert (got == 150).sum() >= 3
    with pytest.raises(IndexError):
        detection.postprocess_detections(
            torch.as_tensor(logits), torch.as_tensor(boxes), OBJ_ALP2FRE,
            num_classes=classes - 1, max_objects=2 * len(top))
    for cfg in (oiv6, oiv6.replace(training=dataclasses.replace(
            oiv6.training, eval_mode="sgc"))):
        with pytest.raises(ValueError, match="151-entry OBJ_ALP2FRE.*602"):
            engines.make_detr_detect_fn(cfg, None)
    engines.check_detector_classes(torch_config.derive("vg"))


@pytest.mark.parametrize("mode", ["sgd", "sgc"])
def test_torch_cli_oiv6_detection_exits(tmp_path, mode):
    res = _cli(tmp_path, "--dataset", "oiv6", "--run_mode", "eval",
               "--eval_mode", mode, "--device", "cpu")
    assert res.returncode != 0
    assert "no class remap is defined" in res.stderr
    assert "602 classes" in res.stderr
    assert "DETR" not in res.stdout
