"""The port's data-parallel plug-and-play steps (train/pnp_engine.py
make_pnp_train_step(mesh=), make_pnp_eval_step(mesh=),
run_eval_pc_predictor(mesh=), the CLI's --predictor under two processes)
against the JAX package's GSPMD steps on a 2-device data mesh, on the CPU.

World size 2 is one gloo group of two processes (tests/torch_mesh_worker.py,
rendezvous through a file store under the test's temporary directory),
started once for the module; the JAX side runs here on 2 of conftest's 8
host devices (make_mesh(data=2)), on one set of seeded flax weights per
family (tests/test_torch_pnp.py's _predictors) and the same numpy batches.

The JAX step's losses are the global batch's: every term a ratio of sums
over both shards.  The train batches are cut so that the two shards hold
different numbers of valid objects and connected pairs (a mean of the
shards' local losses then differs from the global loss, and a test below
shows by how much), and the optimizer has no clip, which by the global
norm would scale away an error in the gradient's scale.

Tolerances, float64 (JAX with x64 on, which its mesh step runs under):
every parameter after each of 3 train steps within 1e-8; the losses within
1e-8, except those the JAX package computes in float32 (its casts of the
connectivity logit, VCTree's pair scores and the object logits, and in
sgcls mode everything downstream of the float32 soft labels), held at 1e-6
as in tests/test_torch_pnp.py; both ranks' parameters equal bit for bit;
the eval step's outputs within 1e-8, integers equal; recall dicts equal."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from test_torch_eval import _assert_results_equal  # noqa: E402
from test_torch_pnp import F32_METRICS, H, PD, _predictors  # noqa: E402
from test_torch_tiny import batches, cfgs  # noqa: E402

from scene_graph_commonsense_tpu.parallel import mesh as jax_mesh  # noqa
from scene_graph_commonsense_tpu.train import engine as jax_engine  # noqa
from scene_graph_commonsense_tpu.train import pnp_engine as jax_pnp  # noqa
from scene_graph_commonsense_torch.models import weights  # noqa: E402
from scene_graph_commonsense_torch.parallel.launch import (  # noqa: E402
    run_processes)
from scene_graph_commonsense_torch.train import (  # noqa: E402
    engine, pnp_engine)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
FAMILIES = ("motifs", "transformer", "vctree", "vtranse")
LR = 1e-2
# (family, mode) of the train scenarios, each with the commonsense penalty
TRAIN = (("motifs", "predcls"), ("vctree", "sgcls"))


def _unequal(b):
    """The batch with the second shard's images cut to 2 valid objects:
    the shards then hold different numbers of valid objects and of
    connected pairs."""
    b = dict(b)
    half = len(b["cats"]) // WORLD
    valid = b["valid"].copy()
    valid[half:, 2:] = False
    pair = valid[:, :, None] & valid[:, None, :]
    b.update(valid=valid, cats=np.where(valid, b["cats"], 0),
             rel=np.where(pair, b["rel"], -1))
    return b


def _cs_tables(jc):
    rng = np.random.RandomState(0)
    n_ids = jc.model.num_classes * jc.model.num_relations \
        * jc.model.num_classes
    return rng.rand(n_ids) < 0.3, rng.rand(n_ids) < 0.3


def _kw(jc, mode):
    m = jc.model
    d = m.num_img_feature
    return dict(feature_dim=d, union_dim=d, hidden_dim=H, pair_dim=PD,
                num_classes=m.num_classes, mode=mode,
                box_scale=float(m.feature_size), dtype=torch.float64)


def _yaml(work):
    """The CLI's config: tiny_cfg's widths, batch 4."""
    path = work / "cli.yaml"
    path.write_text(json.dumps({
        "model": {"feature_size": 16, "hidden_dim": 8, "num_img_feature": 16,
                  "compute_dtype": "float32"},
        "data": {"max_objects": 6},
        "training": {"batch_size": 4, "test_epoch": 0,
                     "checkpoint_path": str(work / "ck"),
                     "result_path": str(work / "res")}}))
    return str(path)


def _jax_batch(b):
    return {k: jnp.asarray(b[k]) for k in pnp_engine.MODEL_KEYS}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every world-size-2 scenario in one gloo group of two processes; the
    inputs and the results of each."""
    work = tmp_path_factory.mktemp("mesh_pnp")
    jc, tc = cfgs(training={"learning_rate": LR, "grad_clip_norm": 0.0})
    cs = _cs_tables(jc)
    eval_models = {f: _predictors(jc, f, "predcls", seed=2)
                   for f in FAMILIES}
    train_models = {ft: _predictors(jc, *ft) for ft in TRAIN}
    inputs = {
        "jc": jc, "tc": tc, "cs": cs, "eval_models": eval_models,
        "train_models": train_models,
        "eval": batches(1, seed=31, with_aug=False)[0],
        "eval_batches": batches(2, seed=32, with_aug=False),
        "train": [_unequal(b) for b in batches(3, seed=33, with_aug=False)],
        "work": work}
    scenarios = [("eval", {
        "kind": "pnp_eval", "cfg": tc, "families": FAMILIES,
        "kw": _kw(jc, "predcls"), "dtype": torch.float64,
        "state_dicts": {f: m[2].state_dict()
                        for f, m in eval_models.items()},
        "batch": inputs["eval"], "eval_batches": inputs["eval_batches"]})]
    for family, mode in TRAIN:
        scenarios.append((f"train_{family}_{mode}", {
            "kind": "pnp_train", "cfg": tc, "family": family,
            "kw": _kw(jc, mode), "dtype": torch.float64,
            "state_dicts": {family: train_models[family, mode][2]
                            .state_dict()},
            "batches": inputs["train"], "cs_tables": cs, "lr": LR,
            "clip": 0.0}))
    yaml_path = _yaml(work)
    scenarios.append(("cli", {"kind": "cli", "argvs": [[
        "--run_mode", "eval", "--eval_mode", "pc", "--predictor", "motifs",
        "--tde", "--hierar", "--synthetic", "2", "--config", yaml_path,
        "--device", "cpu"]]}))
    spec = {"world": WORLD, "tensors": {}, "scenarios": scenarios}
    torch.save(spec, work / "spec.pt")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
    logs = [work / f"rank{r}.log" for r in range(WORLD)]
    codes, _ = run_processes(
        [[sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
          str(work), str(rank)] for rank in range(WORLD)], ROOT, env, logs,
        timeout=600)
    errors = [(work / f"error_rank{r}.txt") for r in range(WORLD)]
    if any(codes):
        pytest.fail("world-2 run failed:\n" + "\n".join(
            e.read_text() for e in errors if e.exists()) + "\n".join(
            log.read_text()[-3000:] for log in logs))
    inputs["results"] = {
        name: [torch.load(work / f"{name}_rank{r}.pt", weights_only=False)
               for r in range(WORLD)]
        for name, _ in scenarios}
    return inputs


def _jax_eval_step(jc, jm, tde):
    return jax_pnp.make_pnp_eval_step(jm, jc, tde=tde,
                                      mesh=jax_mesh.make_mesh(data=WORLD))


@pytest.mark.parametrize("family", FAMILIES)
def test_torch_mesh_pnp_eval_step_matches_jax(world2, family):
    """make_pnp_eval_step(mesh=) over 2 ranks, without and with TDE (the
    counterfactual mean over both shards' rows), against JAX's GSPMD step:
    every output key, the dense global layout with pair_img in global
    image indices, on both ranks; TDE's scores away from those of a mean
    over this rank's rows alone."""
    jc = world2["jc"]
    jm, params, tm = world2["eval_models"][family]
    r0, r1 = world2["results"]["eval"]
    b = world2["eval"]
    for tde in (False, True):
        with jax.enable_x64():
            want = jax.tree.map(np.asarray, _jax_eval_step(jc, jm, tde)(
                jax.tree.map(jnp.asarray, params), _jax_batch(b)))
        for r in (r0, r1):
            got = r["outs"][family, tde]
            assert got.keys() == want.keys()
            for k, w in want.items():
                assert got[k].shape == w.shape, k
                if w.dtype.kind == "f":
                    np.testing.assert_allclose(got[k], w, atol=1e-8,
                                               rtol=0, err_msg=k)
                else:
                    np.testing.assert_array_equal(got[k], w, err_msg=k)
    # a per-rank counterfactual mean: the first shard's TDE scores alone
    half = len(b["cats"]) // WORLD
    local = pnp_engine.make_pnp_eval_step(tm, world2["tc"], tde=True,
                                          device="cpu")(
        {k: v[:half] for k, v in b.items()})
    p = local["relation"].shape[0]
    assert np.abs(local["relation"].numpy()
                  - r0["outs"][family, True]["relation"][:p]).max() > 1e-6


def test_torch_mesh_run_eval_pc_predictor_matches_jax(world2):
    """run_eval_pc_predictor(mesh=, tde=True) over 2 ranks: each rank
    featurizes only its rows of each batch, and both return the recall
    dict of JAX's mesh run."""
    jc = world2["jc"]
    jm, params, _ = world2["eval_models"][FAMILIES[0]]
    with jax.enable_x64():
        want = jax_pnp.run_eval_pc_predictor(
            jc, jm, jax.tree.map(jnp.asarray, params),
            [dict(b) for b in world2["eval_batches"]], tde=True,
            mesh=jax_mesh.make_mesh(data=WORLD))
    half = len(world2["eval"]["cats"]) // WORLD
    assert want["num_targets"] > 0
    for r in world2["results"]["eval"]:
        assert r["featurized_rows"] == [half] * len(world2["eval_batches"])
        _assert_results_equal(r["results"], want)


def _jax_train(world2, family, mode, bts):
    """JAX's make_pnp_train_step(mesh=make_mesh(data=2)) over the global
    batches: (params, metrics) after each step."""
    jc = world2["jc"]
    jm, params, _ = world2["train_models"][family, mode]
    opt = jax_engine.make_optimizer(LR)
    want = []
    with jax.enable_x64():
        step = jax_pnp.make_pnp_train_step(
            jm, jc, opt, cs_tables=tuple(map(jnp.asarray, world2["cs"])),
            mesh=jax_mesh.make_mesh(data=WORLD))
        state = jax_engine.TrainState(jax.tree.map(jnp.asarray, params),
                                      opt.init(params), jnp.int32(0))
        for b in bts:
            state, met = step(state, _jax_batch(b), jax.random.PRNGKey(0))
            want.append((jax.tree.map(np.array, state.params),
                         {k: float(v) for k, v in met.items()}))
    return want


@pytest.mark.parametrize("family,mode", TRAIN)
def test_torch_mesh_pnp_train_steps_match_jax(world2, family, mode):
    """3 make_pnp_train_step(mesh=) steps over 2 ranks on shards with
    unequal valid objects and connected pairs, with the commonsense
    penalty (VCTree in sgcls: its structure term and the object CE too),
    against JAX's global-loss GSPMD step: both ranks bit-identical, every
    parameter and loss within tolerance, and each update moves some weight
    by far more than that."""
    b = world2["train"][0]
    half = len(b["cats"]) // WORLD
    assert b["valid"][:half].sum() > b["valid"][half:].sum()
    assert (b["rel"][:half] >= 0).sum() != (b["rel"][half:] >= 0).sum()
    r0, r1 = world2["results"][f"train_{family}_{mode}"]
    want = _jax_train(world2, family, mode, world2["train"])
    soft = mode != "predcls" and family != "vctree"
    prev = world2["train_models"][family, mode][1]
    for (sd, got, same0), (_, m1, same1), (w_params, w_met) in zip(
            r0, r1, want):
        assert same0 and same1 and got == m1
        assert got.keys() == w_met.keys()
        assert ("loss_structure" in got) == (family == "vctree")
        for k, w in w_met.items():
            tol = 1e-6 if soft or k in F32_METRICS else 1e-8
            np.testing.assert_allclose(got[k], w, atol=tol, rtol=0,
                                       err_msg=k)
        flat = weights.predictor_to_flax(sd)
        for a, w in zip(jax.tree.leaves(flat), jax.tree.leaves(w_params)):
            np.testing.assert_allclose(a, w, atol=1e-8, rtol=0)
        assert max(np.abs(w - p).max() for w, p in zip(
            jax.tree.leaves(w_params), jax.tree.leaves(prev))) > 1e-6
        prev = w_params
    assert r0[0][1]["loss_commonsense"] > 0


def test_torch_mesh_pnp_mean_of_local_losses_fails(world2):
    """The batch bites: a data-parallel mean of the two shards' local-loss
    gradients (what a DDP step computes) takes a first update that JAX's
    global-loss step does not, by far more than the tolerance above."""
    family, mode = TRAIN[1]
    jc = world2["jc"]
    b = world2["train"][0]
    half = len(b["cats"]) // WORLD
    want = weights.predictor_from_flax(
        _jax_train(world2, family, mode, [b])[0][0])
    after = []
    for rows in (slice(0, half), slice(half, None)):
        _, _, tm = _predictors(jc, family, mode)
        opt = engine.make_optimizer(LR)
        step = pnp_engine.make_pnp_train_step(
            tm, world2["tc"], opt, cs_tables=world2["cs"], device="cpu")
        step(engine.init_train_state(tm, opt),
             {k: v[rows] for k, v in b.items()})
        after.append(tm.state_dict())
    # SGD's first step from a zero trace is linear in the gradient: the
    # mean of the two updates is the update of the mean gradient
    ddp = {k: (after[0][k] + after[1][k]) / 2 for k in after[0]}
    err = max(float((ddp[k] - want[k]).abs().max()) for k in want)
    assert err > 1e-5, err


def test_torch_mesh_pnp_cli_eval(world2):
    """--predictor motifs --tde eval under two processes: one result line,
    printed by rank 0; rank 1 prints nothing."""
    (r0,), (r1,) = world2["results"]["cli"]
    assert r0["exit"] is None and r1["exit"] is None, (r0, r1)
    assert r1["stdout"] == ""
    lines = r0["stdout"].strip().splitlines()
    res = json.loads(lines[-1])
    assert res["num_targets"] > 0 and len(res["recall"]) == 3
    assert sum(ln.startswith("{") for ln in lines) == 1
    assert "WARNING: predictor checkpoint" in r0["stdout"]
