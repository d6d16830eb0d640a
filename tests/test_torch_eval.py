"""The port's PredCLS slice (make_eval_step, run_eval_pc,
SceneGraphPredictor, the CLI) against the JAX package's, on the same float32
weights and numpy batches, on the CPU.

Tolerances: float64 (JAX with x64 on) atol 1e-8 on relation /
super_relation / connectivity; float32 atol and rtol 1e-5; integer and bool
outputs, R@k, mR@k, zsR@k and Top-3 equal."""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, "tests")
from test_engine import tiny_cfg, init_params  # noqa: E402

from scene_graph_commonsense_tpu import constants as jax_constants  # noqa
from scene_graph_commonsense_tpu.data import artifacts as jax_artifacts  # noqa
from scene_graph_commonsense_tpu.data.artifacts import (  # noqa: E402
    load_vg_artifacts as jax_load_artifacts)
from scene_graph_commonsense_tpu.data.synthetic import (  # noqa: E402
    synthetic_batch)
from scene_graph_commonsense_tpu.eval import engines as jax_engines  # noqa
from scene_graph_commonsense_tpu.inference import (  # noqa: E402
    SceneGraphPredictor as JaxPredictor)
from scene_graph_commonsense_tpu.models.relation_head import (  # noqa: E402
    make_relation_classifier)
from scene_graph_commonsense_tpu.train import engine as jax_engine  # noqa
from scene_graph_commonsense_torch import config as torch_config  # noqa
from scene_graph_commonsense_torch import constants  # noqa: E402
from scene_graph_commonsense_torch.data import artifacts  # noqa: E402
from scene_graph_commonsense_torch.__main__ import (  # noqa: E402
    _result_view, synthetic_batches)
from scene_graph_commonsense_torch.data.artifacts import (  # noqa: E402
    load_vg_artifacts)
from scene_graph_commonsense_torch.eval import engines  # noqa: E402
from scene_graph_commonsense_torch.inference import (  # noqa: E402
    SceneGraphPredictor)
from scene_graph_commonsense_torch.models import weights  # noqa: E402
from scene_graph_commonsense_torch.models.relation_head import (  # noqa: E402
    make_relation_classifier as make_torch_classifier)
from scene_graph_commonsense_torch.train import checkpoint  # noqa: E402
from scene_graph_commonsense_torch.train import engine  # noqa: E402

FLOAT_KEYS = ("relation", "super_relation", "connectivity")
EXACT_KEYS = ("targets", "pair_img", "pair_sub", "pair_obj", "pair_mask",
              "iou_ok", "pair_count", "pair_capacity")
ARTIFACTS_DIR = "datasets/artifacts"


def _cfgs(dtype):
    jc = tiny_cfg()
    jc = jc.replace(model=jc.model.__class__(
        **{**jc.model.__dict__, "compute_dtype": dtype}))
    tc = torch_config.derive("vg", model={**jc.model.__dict__},
                             data={"max_objects": 6},
                             training={"batch_size": jc.training.batch_size})
    return jc, tc


@pytest.fixture(scope="module")
def setup():
    """float32 flax weights and numpy batches shared by the module."""
    jc, _ = _cfgs("float32")
    params = init_params(jc, make_relation_classifier(jc), None)
    rng = np.random.default_rng(7)
    batches = [synthetic_batch(
        rng, batch_size=jc.training.batch_size,
        max_objects=jc.data.max_objects, feature_size=jc.model.feature_size,
        num_channels=jc.model.num_img_feature,
        num_classes=jc.model.num_classes, with_aug=False) for _ in range(3)]
    return params, batches


@pytest.fixture
def x64():
    with jax.enable_x64():
        yield


def _torch_model(tc, params):
    return make_torch_classifier(tc, device="cpu",
                                 state_dict=weights.from_flax(params))


@pytest.mark.parametrize("path,dtype", [("xla", "float64"),
                                        ("pallas_interpret", "float64"),
                                        ("xla", "float32")])
def test_torch_eval_step_matches_jax(setup, path, dtype):
    params, batches = setup
    jc, tc = _cfgs(dtype)
    batch = batches[0]
    with jax.enable_x64(dtype == "float64"):
        jstep = jax_engine.make_eval_step(
            make_relation_classifier(jc), jc,
            use_pallas_pool=path == "pallas_interpret",
            pallas_interpret=path == "pallas_interpret")
        want = jax.tree.map(np.asarray, jstep(
            params, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = engines.to_numpy(engine.make_eval_step(
        _torch_model(tc, params), tc, device="cpu")(batch))
    assert got.keys() == want.keys()
    tol = dict(atol=1e-8, rtol=0) if dtype == "float64" \
        else dict(atol=1e-5, rtol=1e-5)
    for k in FLOAT_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    for k in EXACT_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_results_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k == "top3":
            _assert_results_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def test_torch_run_eval_pc_matches_jax(setup, x64):
    params, batches = setup
    jc, tc = _cfgs("float64")
    want = jax_engines.run_eval_pc(
        jc, make_relation_classifier(jc), params,
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
        artifacts=jax_load_artifacts(ARTIFACTS_DIR))
    got = engines.run_eval_pc(tc, _torch_model(tc, params), batches,
                              artifacts=load_vg_artifacts(ARTIFACTS_DIR),
                              device="cpu")
    assert want["num_targets"] > 0
    _assert_results_equal(got, want)


def test_torch_predictor_matches_jax(setup, x64):
    params, batches = setup
    jc, tc = _cfgs("float64")
    batch = {k: v for k, v in batches[1].items() if k != "rel"}
    want = JaxPredictor(jc, params, use_pallas_pool=False).predict(
        {k: jnp.asarray(v) for k, v in batch.items()}, top_k=10)
    got = SceneGraphPredictor(tc, _torch_model(tc, params),
                              device="cpu").predict(batch, top_k=10)
    assert len(got) == len(want) == jc.training.batch_size
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


def _cli(tmp_path, *args):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        "model: {feature_size: 16, hidden_dim: 8, num_img_feature: 16,\n"
        "        compute_dtype: float32}\n"
        "data: {max_objects: 6}\n"
        f"training: {{batch_size: 2, checkpoint_path: {tmp_path / 'ck'}}}\n")
    return subprocess.run(
        [sys.executable, "-m", "scene_graph_commonsense_torch",
         "--config", str(cfg), *args], cwd=os.getcwd(),
        capture_output=True, text=True, timeout=300)


def test_torch_cli_eval_smoke(tmp_path):
    res = _cli(tmp_path, "--run_mode", "eval", "--eval_mode", "pc",
               "--hierar", "--synthetic", "2", "--device", "cpu")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert "not found" in res.stdout        # no checkpoint: seeded weights
    out = json.loads(lines[-1])
    assert len(out["recall"]) == 3
    assert all(0 <= r <= 1 for r in out["recall"])
    assert "top3" in out


def test_torch_cli_loads_checkpoint(tmp_path):
    tc = torch_config.load_config(
        None, model={"feature_size": 16, "hidden_dim": 8,
                     "num_img_feature": 16, "compute_dtype": "float32"},
        data={"max_objects": 6}, run_mode="eval",
        training={"batch_size": 2, "checkpoint_path": str(tmp_path / "ck")})
    model = make_torch_classifier(
        tc, device="cpu",
        state_dict=weights.init_params(tc, torch.Generator().manual_seed(9)))
    name = checkpoint.checkpoint_name(True, "train", "motif",
                                      tc.training.test_epoch)
    checkpoint.save(str(tmp_path / "ck" / f"{name}.pt"), model)
    res = _cli(tmp_path, "--run_mode", "eval", "--eval_mode", "pc",
               "--synthetic", "2", "--device", "cpu")
    assert res.returncode == 0, res.stderr
    assert "Loaded relation checkpoint" in res.stdout
    want = _result_view(engines.run_eval_pc(
        tc, model, synthetic_batches(tc, 1, seed=100), device="cpu",
        artifacts=load_vg_artifacts(ARTIFACTS_DIR)))
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got.keys() == want.keys()
    for k in want:
        if k != "top3":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_torch_cli_refuses_unported_modes(tmp_path):
    # OIv6 and sgc on real data that is not on disk exit as main.py does
    # (on data that is: tests/test_torch_oiv6.py and
    # tests/test_torch_cli_real.py; sgc with --synthetic, main.py's "need
    # detector outputs" exit: tests/test_torch_engines_detect.py).
    # prepare_cs runs: tests/test_torch_commonsense.py
    for args, msg in (
            (["--run_mode", "eval", "--dataset", "oiv6"],
             "vrd-test-anno.json not found"),
            (["--run_mode", "eval", "--eval_mode", "sgc"],
             "instances_vg_test.json not found")):
        res = _cli(tmp_path, *args, "--device", "cpu")
        assert res.returncode != 0
        assert msg in res.stderr


def test_torch_triplet_ids_and_label_spaces_match_jax():
    """constants.triplet_id and NUM_TRIPLET_IDS_VG, the GQA label space
    (GQA_OBJECTS, GQA_RELATIONS, GQA_LABEL2SUPER) and the 3DSSG CLIP
    clustering (REL_3DSSG_CLIP_INDEX) equal the JAX package's;
    triplet_id numbers the table triplet_table_from_ids fills."""
    rng = np.random.default_rng(5)
    sub, obj = rng.integers(0, 150, (2, 40))
    rel = rng.integers(0, 50, 40)
    got = constants.triplet_id(sub, rel, obj)
    np.testing.assert_array_equal(got, jax_constants.triplet_id(sub, rel,
                                                                obj))
    np.testing.assert_array_equal(
        constants.triplet_id(sub, rel, obj, 10, 7),
        jax_constants.triplet_id(sub, rel, obj, 10, 7))
    assert constants.NUM_TRIPLET_IDS_VG == jax_constants.NUM_TRIPLET_IDS_VG
    table = artifacts.triplet_table_from_ids(sub, rel, obj)
    assert table.shape == (constants.NUM_TRIPLET_IDS_VG,)
    assert set(np.flatnonzero(table)) == set(got.tolist())
    assert constants.GQA_OBJECTS == jax_constants.GQA_OBJECTS
    assert constants.GQA_RELATIONS == jax_constants.GQA_RELATIONS
    assert constants.GQA_LABEL2SUPER == jax_constants.GQA_LABEL2SUPER
    assert len(constants.GQA_OBJECTS) == len(constants.GQA_LABEL2SUPER)
    np.testing.assert_array_equal(constants.REL_3DSSG_CLIP_INDEX,
                                  jax_constants.REL_3DSSG_CLIP_INDEX)
    assert constants.REL_3DSSG_CLIP_INDEX.dtype == np.int32


def test_torch_triplet_strings_and_default_sub2super_match_jax():
    """data/artifacts.parse_triplet_strings (the reference's 'sub_rel_obj'
    keys) and default_sub2super equal the JAX package's."""
    keys = ["0_0_0", "149_49_149", "12_3_7", "5_10_5"]
    got = artifacts.parse_triplet_strings(keys)
    want = jax_artifacts.parse_triplet_strings(keys)
    assert got.keys() == want.keys() == {"sub", "rel", "obj"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for args in ((), (10, 4)):
        g = artifacts.default_sub2super(*args)
        w = jax_artifacts.default_sub2super(*args)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
