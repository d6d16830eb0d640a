"""The port's (data, model) mesh at (2, 2): the train and eval steps with
fc1 and fc2_h split over the model axis, SGDET, the plug-and-play step
(which holds no TP layer: its model axis repeats the data shard's work),
fit(mesh=) and the CLI with parallel.model_axis 2, against the JAX
package's runs on make_mesh(data=2, model=2), on the CPU.

World size 4 is one gloo group of four processes (tests/torch_mesh_worker.py
at model axis 2: ranks 0, 1 hold data index 0, ranks 2, 3 data index 1),
started once for the module; the JAX side runs here on 4 of conftest's 8
host devices, on the same weights and numpy batches (tiny_cfg widths,
dropout off).  The JAX package's mesh steps are shard_maps over 'data' with
replicated parameters, so their numbers are the data-only mesh's; the
port's TP steps must give them.

Tolerances: float64 (JAX with x64 on) atol 1e-8 on every gathered
parameter and float metric after each of 3 train steps, counts equal; the
eval step's float outputs 1e-8, integers equal; SGDET's result dict equal;
the pnp step's parameters 1e-8 and its losses 1e-8 (1e-6 where JAX computes
in float32, as tests/test_torch_mesh_pnp.py holds them); fit in float32
1e-6 (JAX's fit over a mesh does not run with x64 on); the replicas of all
four ranks bit-identical."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from test_torch_engines_detect import _detections  # noqa: E402
from test_torch_eval import _assert_results_equal  # noqa: E402
from test_torch_mesh_pnp import (  # noqa: E402
    _cs_tables, _jax_batch, _kw, _unequal)
from test_torch_pnp import F32_METRICS, _predictors  # noqa: E402
from test_torch_tiny import (  # noqa: E402
    assert_trees_close, batches, cfgs, flax_params)
from test_torch_tp import (  # noqa: E402
    _flax, _state_dict, check_replicas, check_trail, run_world)

from scene_graph_commonsense_tpu.constants import (  # noqa: E402
    class_weights as jax_class_weights)
from scene_graph_commonsense_tpu.data.artifacts import (  # noqa: E402
    load_vg_artifacts as jax_load_artifacts)
from scene_graph_commonsense_tpu.eval import engines as jax_engines  # noqa
from scene_graph_commonsense_tpu.models.relation_head import (  # noqa: E402
    make_relation_classifier as make_jax_classifier)
from scene_graph_commonsense_tpu.parallel import mesh as jax_mesh  # noqa
from scene_graph_commonsense_tpu.train import engine as jax_engine  # noqa
from scene_graph_commonsense_tpu.train import loop as jax_loop  # noqa: E402
from scene_graph_commonsense_tpu.train import pnp_engine as jax_pnp  # noqa
from scene_graph_commonsense_torch.models import weights  # noqa: E402
from scene_graph_commonsense_torch.models.relation_head import (  # noqa
    make_relation_classifier)

ARTIFACTS_DIR = "datasets/artifacts"
WORLD, DATA, MODEL = 4, 2, 2
CLIP = 0.05
PNP_LR = 1e-2
FIT_TRAIN = 2


def _jax_mesh():
    return jax_mesh.make_mesh(data=DATA, model=MODEL)


def _fit_cfgs(ckpt, result):
    return cfgs(dtype="float32", training={
        "num_epoch": 1, "print_freq": 1, "eval_freq": 1,
        "grad_clip_norm": 1.0, "checkpoint_path": str(ckpt),
        "result_path": str(result)})


def _cli_yaml(work):
    path = work / "cli.yaml"
    path.write_text(json.dumps({
        "model": {"feature_size": 16, "hidden_dim": 8, "num_img_feature": 16,
                  "compute_dtype": "float32"},
        "data": {"max_objects": 6},
        "parallel": {"model_axis": MODEL},
        "training": {"batch_size": 4, "num_epoch": 1, "print_freq": 1,
                     "eval_freq": 0, "grad_clip_norm": 1.0, "test_epoch": 0,
                     "checkpoint_path": str(work / "cli_ck"),
                     "result_path": str(work / "cli_res")}}))
    return str(path)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Every scenario of the (2, 2) mesh in one gloo group of four
    processes; the inputs and the results of each."""
    work = tmp_path_factory.mktemp("mesh_tp")
    params = flax_params()
    jc, tc = cfgs(training={"grad_clip_norm": CLIP})
    rng = np.random.default_rng(51)
    sg = batches(2, seed=52, with_aug=False)
    pjc, ptc = cfgs(training={"learning_rate": PNP_LR,
                              "grad_clip_norm": 0.0})
    pnp_models = _predictors(pjc, "motifs", "predcls")
    inputs = {
        "params": params, "jc": jc, "train": batches(3, seed=53),
        "eval": batches(2, seed=54, with_aug=False), "sg": sg,
        "dets": [_detections(rng, b, jc.model.num_classes) for b in sg],
        "pjc": pjc, "pnp_models": pnp_models, "cs": _cs_tables(pjc),
        "pnp": [_unequal(batches(1, seed=55, with_aug=False)[0])],
        "fit_train": batches(FIT_TRAIN, seed=56, float64=False),
        "fit_test": batches(1, seed=57, with_aug=False, float64=False),
        "work": work}
    _, tc_fit = _fit_cfgs(work / "fit_ck", work / "fit_res")
    scenarios = [
        ("train", {"kind": "tp_train", "cfg": tc, "state_dict": "sd64",
                   "dtype": torch.float64, "batches": inputs["train"],
                   "clip": CLIP, "faithful": False}),
        ("eval", {"kind": "tp_eval", "cfg": tc, "state_dict": "sd64",
                  "dtype": torch.float64, "batches": inputs["eval"]}),
        ("sgd", {"kind": "sg_eval", "cfg": tc, "state_dict": "sd64",
                 "dtype": torch.float64, "batches": sg,
                 "dets": inputs["dets"], "mode": "sgd"}),
        ("pnp", {"kind": "pnp_train", "cfg": ptc, "family": "motifs",
                 "kw": _kw(pjc, "predcls"), "dtype": torch.float64,
                 "state_dicts": {"motifs": pnp_models[2].state_dict()},
                 "batches": inputs["pnp"], "cs_tables": inputs["cs"],
                 "lr": PNP_LR, "clip": 0.0}),
        ("fit", {"kind": "tp_fit", "cfg": tc_fit, "state_dict": "sd32",
                 "dtype": torch.float32, "train": inputs["fit_train"],
                 "test": inputs["fit_test"]}),
        ("cli", {"kind": "cli", "argvs": [
            ["--run_mode", mode, "--eval_mode", "pc", "--hierar",
             "--synthetic", "2", "--config", _cli_yaml(work), "--device",
             "cpu"] for mode in ("train", "eval")]}),
    ]
    inputs["results"] = run_world(work, {
        "world": WORLD, "model": MODEL, "scenarios": scenarios,
        "tensors": {"sd64": _state_dict(params),
                    "sd32": _state_dict(params, torch.float32)}})
    return inputs


def test_torch_mesh_tp_train_steps_match_jax_f64(world4):
    """3 train steps at (2, 2) (augmented view, a clip that fires) against
    JAX's make_train_step(mesh=make_mesh(2, 2)): the gathered parameters and
    every metric within 1e-8, counts equal, all four ranks' replicas and
    both data indices' shards bit-identical."""
    jc = world4["jc"]
    trails = world4["results"]["train"]
    check_replicas(trails)
    with jax.enable_x64():
        mesh = _jax_mesh()
        jparams = jax.tree.map(jnp.asarray, world4["params"])
        opt = jax_engine.make_optimizer(1e-3, grad_clip_norm=CLIP)
        state = jax_engine.TrainState(
            jax_mesh.replicate_tree(mesh, jparams),
            jax_mesh.replicate_tree(mesh, opt.init(jparams)),
            jax_mesh.replicate_tree(mesh, jnp.int32(0)))
        step = jax_engine.make_train_step(make_jax_classifier(jc), jc, opt,
                                          jax_class_weights("vg"),
                                          mesh=mesh, donate=False)
        want = []
        for b in world4["train"]:
            state, met = step(state, jax_mesh.shard_batch(
                mesh, {k: jnp.asarray(v) for k, v in b.items()}),
                jax.random.PRNGKey(0))
            want.append((jax.tree.map(np.array, state.params)["params"],
                         {k: float(v) for k, v in met.items()}))
    check_trail(trails[0], want)
    assert all(m["loss_contrast"] > 0 for _, m, _ in trails[0])


def test_torch_mesh_tp_eval_step_matches_jax(world4):
    """The eval step at (2, 2): every output of JAX's
    make_eval_step(mesh=make_mesh(2, 2)), gathered over the data axis alone
    (one pair_count entry per data shard, pair_img in global indices), the
    same on all four ranks; run_eval_pc's results the same on every rank."""
    jc = world4["jc"]
    rs = world4["results"]["eval"]
    assert all(r["sharded"] for r in rs)
    with jax.enable_x64():
        estep = jax_engine.make_eval_step(make_jax_classifier(jc), jc,
                                          mesh=_jax_mesh())
        params = jax.tree.map(jnp.asarray, world4["params"])
        for i, b in enumerate(world4["eval"]):
            want = jax.tree.map(np.asarray, estep(
                params, jax_mesh.shard_batch(
                    _jax_mesh(), {k: jnp.asarray(v) for k, v in b.items()})))
            assert want["pair_count"].shape == (DATA,)
            for r in rs:
                got = r["outs"][i]
                assert got.keys() == want.keys()
                for k, w in want.items():
                    assert got[k].shape == w.shape, k
                    if np.issubdtype(w.dtype, np.floating):
                        np.testing.assert_allclose(got[k], w, atol=1e-8,
                                                   rtol=0, err_msg=k)
                    else:
                        np.testing.assert_array_equal(got[k], w, err_msg=k)
    for r in rs[1:]:
        _assert_results_equal(r["results"], rs[0]["results"])


def test_torch_mesh_tp_sgdet_matches_jax(world4):
    """run_eval_sgd(mesh=) at (2, 2) from given detections (the relation
    head sharded by its eval step) against JAX's run on make_mesh(2, 2):
    the result dicts equal on every rank."""
    jc = world4["jc"]
    dets = iter(world4["dets"])
    with jax.enable_x64():
        want = jax_engines.run_eval_sgd(
            jc, make_jax_classifier(jc),
            jax.tree.map(jnp.asarray, world4["params"]),
            [dict(b) for b in world4["sg"]], lambda b: next(dets),
            artifacts=jax_load_artifacts(ARTIFACTS_DIR), mesh=_jax_mesh())
    assert want["num_targets"] > 0
    for r in world4["results"]["sgd"]:
        _assert_results_equal(r, want)


def test_torch_mesh_tp_pnp_step_matches_jax(world4):
    """One Motifs step at (2, 2) on shards with unequal valid objects,
    with the commonsense penalty (its denominators in one all-reduce over
    the data group): the parameters within 1e-8 and the losses within
    1e-8 (1e-6 where JAX computes in float32) of JAX's step on
    make_mesh(2, 2), all four ranks bit-identical."""
    pjc = world4["pjc"]
    jm, params, _ = world4["pnp_models"]
    opt = jax_engine.make_optimizer(PNP_LR)
    with jax.enable_x64():
        step = jax_pnp.make_pnp_train_step(
            jm, pjc, opt, cs_tables=tuple(map(jnp.asarray, world4["cs"])),
            mesh=_jax_mesh())
        state = jax_engine.TrainState(jax.tree.map(jnp.asarray, params),
                                      opt.init(params), jnp.int32(0))
        state, met = step(state, _jax_batch(world4["pnp"][0]),
                          jax.random.PRNGKey(0))
        w_params = jax.tree.map(np.array, state.params)
        w_met = {k: float(v) for k, v in met.items()}
    trails = world4["results"]["pnp"]
    (sd, got, _), = trails[0]
    for (_, m, same), in trails:
        assert same and m == got
    assert got.keys() == w_met.keys() and got["loss_commonsense"] > 0
    for k, w in w_met.items():
        tol = 1e-6 if k in F32_METRICS else 1e-8
        np.testing.assert_allclose(got[k], w, atol=tol, rtol=0, err_msg=k)
    flat = weights.predictor_to_flax(sd)
    for a, w in zip(jax.tree.leaves(flat), jax.tree.leaves(w_params)):
        np.testing.assert_allclose(a, w, atol=1e-8, rtol=0)


def test_torch_mesh_tp_fit_matches_jax(world4):
    """fit(mesh=) at (2, 2) against JAX's fit(mesh=make_mesh(2, 2)) in
    float32 (train-time recall every step, the test pass): the gathered
    final parameters within 1e-6, the replicas bit-identical, every log
    line from rank 0; its one checkpoint holds the unsharded weights and
    loads into an unsharded model."""
    rs = world4["results"]["fit"]
    assert all(r["replicas_identical"] and r["sharded"] for r in rs)
    assert all(r["step"] == FIT_TRAIN for r in rs)
    assert all(r["lines"] == [] for r in rs[1:])
    lines = rs[0]["lines"]
    assert sum(ln.startswith("TRAIN") for ln in lines) == FIT_TRAIN
    assert sum(ln.startswith("TEST") for ln in lines) == 1
    work = world4["work"]
    assert os.listdir(work / "fit_ck") == [
        "HierRelationModel_Baseline_motif0.pt"]
    jc, tc = _fit_cfgs(work / "jax_ck", work / "jax_res")
    state = jax_loop.fit(
        jc, make_jax_classifier(jc),
        jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), world4["params"]),
        lambda e: iter(world4["fit_train"]),
        lambda e: iter(world4["fit_test"]), steps_per_epoch=FIT_TRAIN,
        artifacts=jax_load_artifacts(ARTIFACTS_DIR), mesh=_jax_mesh(),
        log_fn=lambda *a: None)
    want = jax.tree.map(np.array, state.params)["params"]
    got = rs[0]["state_dict"]
    assert_trees_close(_flax(got), want, 1e-6)
    saved = torch.load(work / "fit_ck" / os.listdir(work / "fit_ck")[0],
                       weights_only=True)
    model = make_relation_classifier(tc, device="cpu", state_dict=saved)
    for k, v in model.state_dict().items():
        assert torch.equal(v, got[k]), k


def test_torch_mesh_tp_cli(world4):
    """The CLI under four processes with parallel.model_axis 2 (the data
    axis 2 by the batch): it trains (rank 0 alone prints, one checkpoint)
    and evaluates that checkpoint, where it exited before TP was ported."""
    train, evals = zip(*world4["results"]["cli"])
    for r in train + evals:
        assert r["exit"] is None, r
    assert all(r["stdout"] == "" for r in train[1:] + evals[1:])
    assert sum(ln.startswith("TRAIN") for ln in
               train[0]["stdout"].splitlines()) == 2
    assert os.listdir(world4["work"] / "cli_ck") == [
        "HierRelationModel_Baseline_motif0.pt"]
    assert "Loaded relation checkpoint" in evals[0]["stdout"]
    res = json.loads(evals[0]["stdout"].strip().splitlines()[-1])
    assert 0 <= res["recall"][0] <= 1
