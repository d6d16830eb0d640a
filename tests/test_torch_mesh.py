"""The port's data parallelism (parallel/mesh.py, the mesh branches of
train.engine.make_train_step and make_eval_step, train.loop.fit(mesh=) and
eval_mesh, eval.engines.run_eval_pc(mesh=), the CLI's --mesh_data and
--epochs) against the JAX package's on a 2-device data mesh, on the CPU.

World size 2 is one gloo group of two processes
(tests/torch_mesh_worker.py, rendezvous through a file store under the
test's temporary directory), started once for the module: it runs every
scenario and saves its results; the JAX side runs here on 2 of conftest's
8 host devices, on the same weights and numpy batches (tiny_cfg widths,
dropout off).

Tolerances: float64 (JAX with x64 on) atol 1e-8 on every parameter and
every float metric after each of 3 train steps, ordinary and faithful,
counts equal; the two ranks' parameters equal bit for bit; the bfloat16
all-reduce at float32 master weights (JAX with x64 off) atol 2e-6 on the
parameters (updates of lr 1e-3 times gradients that may differ by one
bfloat16 rounding) and 1e-5 relative on the metrics; the sharded eval step
float64 1e-8 and integer outputs equal; fit's final parameters in float32
1e-6 (sums of float32 products in another order)."""

import contextlib
import dataclasses
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, "tests")
from test_torch_tiny import (  # noqa: E402
    INT_METRICS, assert_trees_close, batches, cfgs, flax_params,
    one_thread, torch_model)

import main as jax_main  # noqa: E402
from scene_graph_commonsense_tpu.constants import (  # noqa: E402
    class_weights as jax_class_weights)
from scene_graph_commonsense_tpu.data.artifacts import (  # noqa: E402
    load_vg_artifacts as jax_load_artifacts)
from scene_graph_commonsense_tpu.models.relation_head import (  # noqa: E402
    make_relation_classifier as make_jax_classifier)
from scene_graph_commonsense_tpu.parallel import mesh as jax_mesh  # noqa
from scene_graph_commonsense_tpu.train import engine as jax_engine  # noqa
from scene_graph_commonsense_tpu.train import loop as jax_loop  # noqa: E402
from scene_graph_commonsense_torch import __main__ as cli  # noqa: E402
from scene_graph_commonsense_torch import config as torch_config  # noqa
from scene_graph_commonsense_torch.constants import (  # noqa: E402
    class_weights)
from scene_graph_commonsense_torch.data.synthetic import (  # noqa: E402
    synthetic_batch, synthetic_images)
from scene_graph_commonsense_torch.models import detr as tdetr  # noqa: E402
from scene_graph_commonsense_torch.models import weights  # noqa: E402
from scene_graph_commonsense_torch.parallel import mesh as mesh_lib  # noqa
from scene_graph_commonsense_torch.parallel.launch import (  # noqa: E402
    run_processes)
from scene_graph_commonsense_torch.tools.dryrun_multichip import (  # noqa
    dryrun_multichip)
from scene_graph_commonsense_torch.train import engine, loop  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS_DIR = "datasets/artifacts"
WORLD = 2
CLIP = 0.05
FIT_TRAIN, FIT_TEST = 2, 1


def _state_dict(params, dtype=torch.float64):
    return {k: v.to(dtype) for k, v in weights.from_flax(params).items()}


def _flax(state_dict):
    return weights.to_flax(state_dict)["params"]


def _f32(bs):
    return [{k: v.astype(np.float32) if v.dtype == np.float64 else v
             for k, v in b.items()} for b in bs]


def _yaml(path, result, ckpt, data=None, **training):
    path.write_text(json.dumps({
        "model": {"feature_size": 16, "hidden_dim": 8, "num_img_feature": 16,
                  "compute_dtype": "float32"},
        "data": {"max_objects": 6, **(data or {})},
        "training": {"batch_size": 4, "num_epoch": 1, "print_freq": 1,
                     "eval_freq": 0, "grad_clip_norm": 1.0, "test_epoch": 0,
                     "checkpoint_path": str(ckpt),
                     "result_path": str(result), **training}}))
    return str(path)


def _fit_cfgs(ckpt, result):
    return cfgs(dtype="float32", training={
        "num_epoch": 1, "print_freq": 1, "eval_freq": 1,
        "grad_clip_norm": 1.0, "checkpoint_path": str(ckpt),
        "result_path": str(result)})


def _cli_argvs(work):
    common = ["--hierar", "--synthetic", "2", "--device", "cpu"]
    train_yaml = _yaml(work / "cli.yaml", work / "cli_res", work / "cli_ck")
    vis_yaml = _yaml(work / "vis.yaml", work / "vis_res", work / "cli_ck",
                     save_vis_results=True)
    pnp_yaml = _yaml(work / "pnp.yaml", work / "pnp_res", work / "pnp_ck")
    # prepare_cs writes its table beside a copy of the artifacts
    (work / "cs_art").mkdir()
    shutil.copy(os.path.join(ARTIFACTS_DIR, "vg_artifacts.npz"),
                work / "cs_art")
    cs_yaml = _yaml(work / "cs.yaml", work / "cs_res", work / "cli_ck",
                    data={"artifacts_dir": str(work / "cs_art"),
                          "annot_dir": str(work / "cs_annot")})
    return {
        "train": ["--run_mode", "train", "--eval_mode", "pc", "--config",
                  train_yaml, "--mesh_data", "2", "--epochs", "1", *common],
        "eval_vis": ["--run_mode", "eval", "--eval_mode", "pc", "--config",
                     vis_yaml, *common],
        "sgd": ["--run_mode", "eval", "--eval_mode", "sgd", "--config",
                train_yaml, *common],
        "predictor": ["--run_mode", "train", "--eval_mode", "pc",
                      "--predictor", "motifs", "--config", pnp_yaml,
                      *common],
        "prepare_cs": ["--run_mode", "prepare_cs", "--eval_mode", "pc",
                       "--config", cs_yaml, "--mock-llm", *common],
        "odd_batch": ["--run_mode", "train", "--eval_mode", "pc",
                      "--config", train_yaml, "--batch_size", "3", *common],
    }


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every world-size-2 scenario in one gloo group of two processes; the
    inputs and the results of each."""
    work = tmp_path_factory.mktemp("mesh")
    params = flax_params()
    _, tc = cfgs(training={"grad_clip_norm": CLIP})
    _, tc_noclip = cfgs(training={"grad_clip_norm": 0.0})
    _, tc_faith = cfgs(training={"faithful_dynamics": True,
                                 "pair_capacity": 40,
                                 "grad_clip_norm": CLIP})
    _, tc_bf16 = cfgs(dtype="float32",
                      training={"grad_allreduce_dtype": "bfloat16",
                                "grad_clip_norm": CLIP})
    _, tc_fit = _fit_cfgs(work / "fit_ck", work / "fit_res")
    train = batches(3)
    inputs = {
        "params": params, "train": train, "faithful": batches(3, seed=5),
        "noclip": batches(3, seed=4),
        "bf16": _f32(batches(3, seed=7)),
        "eval": batches(2, seed=9, with_aug=False),
        "fit_train": _f32(batches(FIT_TRAIN, seed=11)),
        "fit_test": _f32(batches(FIT_TEST, seed=12, with_aug=False)),
        "work": work}
    argvs = _cli_argvs(work)
    inputs["argv_names"] = list(argvs)
    spec = {"world": WORLD, "tensors": {
        "sd64": _state_dict(params),
        "sd32": _state_dict(params, torch.float32)}, "scenarios": [
        ("train", {"kind": "train", "cfg": tc, "state_dict": "sd64",
                   "dtype": torch.float64, "batches": train, "clip": CLIP,
                   "faithful": False}),
        ("noclip", {"kind": "train", "cfg": tc_noclip, "state_dict": "sd64",
                    "dtype": torch.float64, "batches": inputs["noclip"],
                    "clip": 0.0, "faithful": False}),
        ("faithful", {"kind": "train", "cfg": tc_faith, "state_dict": "sd64",
                      "dtype": torch.float64, "batches": inputs["faithful"],
                      "clip": CLIP, "faithful": True}),
        ("bf16", {"kind": "train", "cfg": tc_bf16, "state_dict": "sd32",
                  "dtype": torch.float32, "batches": inputs["bf16"],
                  "clip": CLIP, "faithful": False}),
        ("eval", {"kind": "eval", "cfg": tc, "state_dict": "sd64",
                  "dtype": torch.float64, "batches": inputs["eval"]}),
        ("fit", {"kind": "fit", "cfg": tc_fit, "state_dict": "sd32",
                 "dtype": torch.float32, "train": inputs["fit_train"],
                 "test": inputs["fit_test"]}),
        ("cli", {"kind": "cli", "argvs": list(argvs.values())}),
    ]}
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
        for name, _ in spec["scenarios"]}
    return inputs


def _jax_mesh_steps(jc, params, bts, faithful=False, x64=True, clip=CLIP):
    """JAX make_train_step(mesh=make_mesh(data=2)) over the global
    batches: (params, metrics) after each step."""
    w = jax_class_weights("vg", faithful=faithful)
    with jax.enable_x64() if x64 else contextlib.nullcontext():
        mesh = jax_mesh.make_mesh(data=WORLD)
        jparams = jax.tree.map(jnp.asarray, params)
        opt = jax_engine.make_optimizer(1e-3, grad_clip_norm=clip)
        state = jax_engine.TrainState(
            jax_mesh.replicate_tree(mesh, jparams),
            jax_mesh.replicate_tree(mesh, opt.init(jparams)),
            jax_mesh.replicate_tree(mesh, jnp.int32(0)))
        step = jax_engine.make_train_step(make_jax_classifier(jc), jc, opt,
                                          w, mesh=mesh, donate=False)
        want = []
        for b in bts:
            state, met = step(state, jax_mesh.shard_batch(
                mesh, {k: jnp.asarray(v) for k, v in b.items()}),
                jax.random.PRNGKey(0))
            want.append((jax.tree.map(np.array, state.params)["params"],
                         {k: float(v) for k, v in met.items()}))
    return want


def _check_ranks_identical(trail0, trail1):
    """Rank 1 held rank 0's parameters to the bit after every step (the
    worker compares them) and the same metrics."""
    for (_, m0, same0), (_, m1, same1) in zip(trail0, trail1):
        assert same0 and same1
        assert m0 == m1


def _check_against_jax(trail, want, atol, rtol=0.0):
    for (sd, got, _), (w_params, w_met) in zip(trail, want):
        assert_trees_close(_flax(sd), w_params, atol)
        assert got.keys() == w_met.keys()
        for k, w in w_met.items():
            if k in INT_METRICS:
                assert got[k] == w, k
            else:
                np.testing.assert_allclose(got[k], w, atol=atol, rtol=rtol,
                                           err_msg=k)


@pytest.mark.parametrize("scenario", ["train", "faithful", "noclip"])
def test_torch_mesh_train_steps_match_jax_f64(world2, scenario):
    """3 data-parallel steps (augmented view, clipping that fires; faithful:
    the averaged lr_scale scales the update; noclip: no clip, which by the
    global norm would scale away an error in the scale of the averaged
    gradient, a sum without the division or a double division): both ranks
    bit-identical, and every parameter and metric within 1e-8 of JAX's
    2-way mesh step; each update moves some weight by over 10x that."""
    faithful = scenario == "faithful"
    clip = 0.0 if scenario == "noclip" else CLIP
    training = {"grad_clip_norm": clip}
    if faithful:
        training.update(faithful_dynamics=True, pair_capacity=40)
    jc, _ = cfgs(training=training)
    r0, r1 = world2["results"][scenario]
    _check_ranks_identical(r0, r1)
    want = _jax_mesh_steps(jc, world2["params"], world2[scenario],
                           faithful=faithful, clip=clip)
    _check_against_jax(r0, want, 1e-8)
    prev = world2["params"]["params"]
    for w_params, _ in want:
        assert max(np.abs(w - prev[k][kind]).max()
                   for k, leaf in w_params.items()
                   for kind, w in leaf.items()) > 1e-7
        prev = w_params
    mets = [m for _, m, _ in r0]
    assert all(m["loss_contrast"] > 0 for m in mets)
    if faithful:
        scales = [m["lr_scale"] for m in mets]
        assert all(0 < s <= 1 for s in scales) and min(scales) < 1


def test_torch_mesh_bf16_allreduce_matches_jax(world2):
    """training.grad_allreduce_dtype bfloat16 at float32 master weights:
    within 2e-6 of JAX's bf16 pmean step over 3 steps, ranks
    bit-identical, and away from the float32 all-reduce's result."""
    jc, _ = cfgs(dtype="float32",
                 training={"grad_allreduce_dtype": "bfloat16",
                           "grad_clip_norm": CLIP})
    r0, r1 = world2["results"]["bf16"]
    _check_ranks_identical(r0, r1)
    params32 = jax.tree.map(lambda x: np.asarray(x, np.float32),
                            world2["params"])
    want = _jax_mesh_steps(jc, params32, world2["bf16"], x64=False)
    _check_against_jax(r0, want, 2e-6, rtol=1e-5)
    jc32, _ = cfgs(dtype="float32", training={"grad_clip_norm": CLIP})
    f32 = _jax_mesh_steps(jc32, params32, world2["bf16"][:1], x64=False)
    got = _flax(r0[0][0])
    diff = max(np.abs(np.asarray(got[k][kind]) - w).max()
               for k, leaf in f32[0][0].items() for kind, w in leaf.items())
    assert diff > 0


def test_torch_mesh_eval_step_matches_jax(world2):
    """The sharded eval step: every output key of JAX's 2-way sharded step,
    pair_img in global indices, pair_count and pair_capacity one entry per
    shard; both ranks hold the same outputs; run_eval_pc(mesh=) calls
    on_batch on rank 0 alone, and every rank returns rank 0's results; on
    batches sharded ahead (shard_eval_batch) each rank featurizes only its
    rows and the results are the same."""
    jc, tc = cfgs()
    r0, r1 = world2["results"]["eval"]
    with jax.enable_x64():
        mesh = jax_mesh.make_mesh(data=WORLD)
        estep = jax_engine.make_eval_step(make_jax_classifier(jc), jc,
                                          mesh=mesh)
        params = jax.tree.map(jnp.asarray, world2["params"])
        for b, got0, got1 in zip(world2["eval"], r0["outs"], r1["outs"]):
            jb = jax_mesh.shard_batch(
                mesh, {k: jnp.asarray(v) for k, v in b.items()})
            want = jax.tree.map(np.asarray, estep(params, jb))
            assert got0.keys() == want.keys()
            for k, w in want.items():
                np.testing.assert_array_equal(got0[k], got1[k], err_msg=k)
                assert got0[k].shape == w.shape, k
                if np.issubdtype(w.dtype, np.floating):
                    np.testing.assert_allclose(got0[k], w, atol=1e-8,
                                               rtol=0, err_msg=k)
                else:
                    np.testing.assert_array_equal(got0[k], w, err_msg=k)
            assert got0["pair_count"].shape == (WORLD,)
            half = len(got0["pair_img"]) // WORLD
            assert got0["pair_img"][half:][got0["pair_mask"][half:]].min() \
                >= b["cats"].shape[0] // WORLD
    cap = -(-tc.pair_capacity // WORLD)
    assert list(r0["outs"][0]["pair_capacity"]) == [cap] * WORLD
    assert r0["calls"] == [0, 1] and r1["calls"] == []
    half = world2["eval"][0]["cats"].shape[0] // WORLD
    for r in (r0, r1):
        assert r["featurized_rows"] == [half] * len(world2["eval"])
        for res in (r["results"], r["presharded_results"]):
            assert res.keys() == r0["results"].keys()
            for k, v in r0["results"].items():
                np.testing.assert_equal(res[k], v, err_msg=k)


def test_torch_mesh_fit_matches_jax(world2):
    """fit(mesh=) over 2 ranks against JAX fit(mesh=make_mesh(data=2)) on
    the same batches (train-time recall every step, the test pass), in
    float32 (JAX's fit over a mesh does not run with x64 on: its step
    donates one buffer twice): final parameters within 1e-6, the ranks
    bit-identical; one checkpoint and one set of result files, and every
    log line from rank 0."""
    r0, r1 = world2["results"]["fit"]
    assert r0["same_as_rank0"] and r1["same_as_rank0"]
    assert r0["step"] == r1["step"] == FIT_TRAIN
    assert r1["lines"] == []
    assert sum(ln.startswith("TRAIN") for ln in r0["lines"]) == FIT_TRAIN
    assert sum(ln.startswith("TEST") for ln in r0["lines"]) == 1
    work = world2["work"]
    assert sorted(os.listdir(work / "fit_ck")) == [
        "HierRelationModel_Baseline_motif0.pt"]
    assert sorted(os.listdir(work / "fit_res")) == [
        "test_results.json", "train_results.json"]
    records = json.loads((work / "fit_res" / "train_results.json")
                         .read_text())
    assert len(records) == FIT_TRAIN
    jc, _ = _fit_cfgs(work / "jax_ck", work / "jax_res")
    state = jax_loop.fit(
        jc, make_jax_classifier(jc),
        jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), world2["params"]),
        lambda e: iter(world2["fit_train"]),
        lambda e: iter(world2["fit_test"]), steps_per_epoch=FIT_TRAIN,
        artifacts=jax_load_artifacts(ARTIFACTS_DIR),
        mesh=jax_mesh.make_mesh(data=WORLD), log_fn=lambda *a: None)
    want = jax.tree.map(np.array, state.params)["params"]
    assert_trees_close(_flax(r0["state_dict"]), want, 1e-6)
    init = world2["params"]["params"]
    assert max(np.abs(w - init[k][kind]).max() for k, leaf in want.items()
               for kind, w in leaf.items()) > 1e-5


def test_torch_mesh_cli(world2):
    """The CLI under two processes: --mesh_data 2 trains (rank 0 alone
    prints and writes one checkpoint), PredCLS eval with save_vis_results
    writes one file per test batch from rank 0; SGDET over the mesh is no
    longer refused (on synthetic batches it exits as main.py does, for want
    of detector outputs); --predictor training and prepare_cs run on rank 0
    alone, as main.py runs them on one device: one checkpoint, one triplet
    table, and rank 1 prints nothing; a batch of 3 exits naming it."""
    r0, r1 = world2["results"]["cli"]
    got = dict(zip(world2["argv_names"], zip(r0, r1)))
    work = world2["work"]
    train0, train1 = got["train"]
    assert train0["exit"] is None and train1["exit"] is None
    assert train1["stdout"] == ""
    assert sum(ln.startswith("TRAIN") for ln in
               train0["stdout"].splitlines()) == 2
    assert os.listdir(work / "cli_ck") == [
        "HierRelationModel_Baseline_motif0.pt"]
    ev0, ev1 = got["eval_vis"]
    assert ev0["exit"] is None and ev1["stdout"] == ""
    res = json.loads(ev0["stdout"].strip().splitlines()[-1])
    assert 0 <= res["recall"][0] <= 1
    assert "Loaded relation checkpoint" in ev0["stdout"]
    assert os.listdir(work / "vis_res" / "visualization") == [
        "0_vis_results.json"]
    vis = json.loads((work / "vis_res" / "visualization" /
                      "0_vis_results.json").read_text())
    assert len(vis) == 4 and all(v["predicted_graph"] for v in vis)
    for r in got["sgd"]:
        assert "sgc/sgd need detector outputs" in r["exit"], r
    for name in ("predictor", "prepare_cs"):
        r0, r1 = got[name]
        assert r0["exit"] is None and r1["exit"] is None, (name, r0, r1)
        assert r1["stdout"] == "", name
    assert "[pnp:motifs] TEST epoch 0" in got["predictor"][0]["stdout"]
    assert os.listdir(work / "pnp_ck") == ["PnpMotifsModel_motif0.pt"]
    cs0 = got["prepare_cs"][0]["stdout"]
    assert "Loaded relation checkpoint" in cs0
    assert "Wrote commonsense triplet tables" in cs0
    assert sorted(os.listdir(work / "cs_art")) == [
        "commonsense_triplets.npz", "vg_artifacts.npz"]
    for r in got["odd_batch"]:
        assert "batch size 3" in r["exit"], r


def test_torch_mesh_world1_step_equals_single_device(tmp_path, one_thread):
    """A mesh of one rank (gloo, this process): the train step and the eval
    step give the single-device step's parameters, metrics and outputs bit
    for bit (the all-reduce of one rank is the identity, rank 0 draws the
    single-device dropout streams; eval_mesh is None).  One CPU thread:
    with several, the CPU's own reductions may split differently between
    two runs of one step."""
    _, tc = cfgs(dtype="float32", training={"grad_clip_norm": CLIP},
                 model={"dropout_rate": 0.3})
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), flax_params())
    bts = _f32(batches(2, seed=13))
    runs = []
    for use_mesh in (False, True):
        mesh = None
        if use_mesh:
            mesh_lib.init_multihost(f"file://{tmp_path / 'store'}", 1, 0,
                                    device="cpu")
        try:
            if use_mesh:
                mesh = mesh_lib.make_mesh(device="cpu")
                assert mesh.shape == {"data": 1, "model": 1}
                assert loop.eval_mesh(tc, mesh) is None
            model = torch_model(tc, params, torch.float32)
            opt = engine.make_optimizer(1e-3, grad_clip_norm=CLIP)
            state = engine.init_train_state(model, opt)
            step = engine.make_train_step(model, tc, opt,
                                          class_weights("vg"), mesh=mesh,
                                          device=None if mesh else "cpu")
            mets = []
            for b in bts:
                state, met = step(state, b)
                mets.append({k: float(v) for k, v in met.items()})
            estep = engine.make_eval_step(model, tc, mesh=mesh,
                                          device=None if mesh else "cpu")
            out = {k: v.clone() for k, v in estep(bts[0]).items()}
            runs.append((dict(model.state_dict()), mets, out))
        finally:
            if use_mesh:
                dist.destroy_process_group()
    (sd0, m0, o0), (sd1, m1, o1) = runs
    assert m0 == m1
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    for k in o0:
        assert torch.equal(o0[k], o1[k]), k


def test_torch_mesh_capacities_follow_jax():
    """train_pair_capacity / aug_pair_capacity per shard, and the eval
    step's ceil, against the JAX package's formulas (JAX
    train/engine.py:267-284 and :474): floor division for training, an
    explicit augmented capacity divided across the shards, the default
    a quarter of the shard's, faithful mode's every valid pair of the
    shard's images."""
    def jax_rule(cfg, shards):
        cap = max(cfg.pair_capacity // shards, 1)
        if cfg.training.faithful_dynamics:
            n = cfg.data.max_objects
            cap = max(cfg.training.batch_size // shards, 1) * n * (n - 1)
        if cfg.training.aug_pair_capacity > 0:
            aug = cfg.training.aug_pair_capacity // shards
        else:
            aug = cap // 4
        return cap, min(max(aug, 1), cap)

    seen = set()
    for training in ({}, {"aug_pair_capacity": 17},
                     {"aug_pair_capacity": 3}, {"pair_capacity": 41},
                     {"faithful_dynamics": True, "pair_capacity": 40},
                     {"faithful_dynamics": True, "aug_pair_capacity": 50}):
        _, tc = cfgs(training=training)
        for shards in (1, 2, 4):
            want = jax_rule(tc, shards)
            got = (engine.train_pair_capacity(tc, shards),
                   engine.aug_pair_capacity(tc, shards))
            assert got == want, (training, shards)
            seen.add(want)
    assert len(seen) > 10
    assert engine.train_pair_capacity(cfgs()[1]) == cfgs()[1].pair_capacity


def test_torch_mesh_dropout_streams_per_rank():
    """Rank 0 draws the single-device step's streams; every rank draws its
    own, and each rank's streams change with the step."""
    def draws(step, rank=None):
        gens = (engine.dropout_generators(0, step, "cpu") if rank is None
                else engine.dropout_generators(0, step, "cpu", rank))
        return [tuple(torch.rand(4, generator=g).tolist()) for g in gens]

    assert draws(5, 0) == draws(5)
    per_rank = [draws(5, r) for r in range(4)]
    assert len({d for ds in per_rank for d in ds}) == 16
    assert draws(6, 1) != draws(5, 1)


def test_torch_shard_batch_matches_jax_placement():
    """shard_batch's rows are the rows JAX's P('data') sharding places on
    each device, for 2 and 4 shards; a batch the axis does not divide
    raises, as JAX's device_put does."""
    rng = np.random.default_rng(0)
    batch = synthetic_batch(rng, batch_size=4, max_objects=6,
                            feature_size=8, num_channels=4)
    for data in (2, 4):
        mesh = jax_mesh.make_mesh(data=data)
        placed = jax_mesh.shard_batch(
            mesh, {k: jnp.asarray(v) for k, v in batch.items()})
        devices = list(mesh.devices[:, 0])
        for k, arr in placed.items():
            for shard in arr.addressable_shards:
                rank = devices.index(shard.device)
                got = mesh_lib.shard_batch(
                    mesh_lib.Mesh(data, 1, rank, torch.device("cpu")),
                    {k: batch[k], "names": ["a", "b", "c", "d"]})
                np.testing.assert_array_equal(got[k], np.asarray(shard.data))
                assert got["names"] == ["a", "b", "c", "d"][
                    rank * 4 // data:(rank + 1) * 4 // data]
    with pytest.raises(ValueError):
        jax_mesh.shard_batch(jax_mesh.make_mesh(data=8),
                             {"cats": jnp.asarray(batch["cats"])})
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.shard_batch(mesh_lib.Mesh(8, 1, 0, torch.device("cpu")),
                             {"cats": batch["cats"]})


def test_torch_shard_then_featurize_equals_featurize_then_shard():
    """fit(mesh=) shards a batch of images before the encode: per rank, the
    same features (float64, within 1e-12: one image's encode does not
    depend on the others) as encoding the global batch and sharding it."""
    torch.manual_seed(0)
    detr = tdetr.DETR(d_model=16, nhead=2, dim_ff=32, num_encoder_layers=1,
                      backbone_blocks=(1, 1, 1, 1), dtype=torch.float64)
    detr = detr.double().eval().requires_grad_(False)
    featurize = loop.make_detr_featurize_fn(None, detr)
    rng = np.random.default_rng(1)
    b = synthetic_batch(rng, batch_size=4, max_objects=6, feature_size=8,
                        num_channels=16, with_aug=False)
    del b["features"]
    b.update({k: v.astype(np.float64) for k, v in synthetic_images(
        rng, 4, 256, with_aug=True).items()})
    whole = featurize(b)
    for rank in range(WORLD):
        mesh = mesh_lib.Mesh(WORLD, 1, rank, torch.device("cpu"))
        got = featurize(mesh_lib.shard_batch(mesh, b))
        want = mesh_lib.shard_batch(mesh, whole)
        assert "image" not in got and got.keys() == want.keys()
        for k in ("features", "features_aug"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=1e-12, rtol=0, err_msg=k)


def test_torch_eval_mesh_matches_jax():
    class FakeJaxMesh:
        def __init__(self, data):
            self.shape = {"data": data, "model": 1}

    for batch_size in (1, 2, 3, 4, 6):
        jc, tc = cfgs(training={"batch_size": batch_size})
        assert loop.eval_mesh(tc, None) is None
        for data in (1, 2, 3, 4):
            port = mesh_lib.Mesh(data, 1, 0, torch.device("cpu"))
            want = jax_loop.eval_mesh(jc, FakeJaxMesh(data)) is not None
            assert (loop.eval_mesh(tc, port) is port) == want, (
                batch_size, data)


def test_torch_fused_backbone_auto_is_single_process(monkeypatch):
    """fused_backbone auto takes the fused trunk on the card only in a
    single process (JAX models/detr.py:421-423: one device); "on" keeps it
    in any world; flash_encoder has no such rule."""
    cfg = torch_config.derive("vg")
    cuda = torch.device("cuda")
    assert tdetr.resolve_detr_modes(cfg, cuda) == (True, True)
    monkeypatch.setattr(tdetr, "world_size", lambda: 2)
    assert tdetr.resolve_detr_modes(cfg, cuda) == (False, True)
    on = cfg.replace(model=dataclasses.replace(cfg.model,
                                               fused_backbone="on"))
    assert tdetr.resolve_detr_modes(on, cuda) == (True, True)
    assert tdetr.resolve_detr_modes(cfg, torch.device("cpu")) == (False,
                                                                 False)


def test_torch_cli_epochs_and_mesh_flags_match_main(monkeypatch):
    """--epochs sets training.num_epoch and --batch_size the batch, as
    main.py's build_cfg does; --mesh_data parses as main.py's; in one
    process the CLI builds no mesh."""
    argv = ["x", "--run_mode", "train", "--epochs", "3", "--batch_size",
            "6", "--mesh_data", "2"]
    monkeypatch.setattr(sys, "argv", argv)
    want_args = jax_main.parse_args()
    want = jax_main.build_cfg(want_args)
    args = cli.parse_args()
    got = cli.build_cfg(args)
    assert got.training.num_epoch == want.training.num_epoch == 3
    assert got.training.batch_size == want.training.batch_size == 6
    assert args.mesh_data == want_args.mesh_data == 2
    assert cli.make_cli_mesh(args, got) is None


def test_torch_dryrun_multichip_two_processes(capfd):
    """The dryrun_multichip counterpart over 2 gloo processes: one
    data-parallel train step, one sharded eval step and the dp x tp leg's
    two train steps on a (1, 2) mesh (the shard_map step and the
    global-batch step), each finite."""
    assert dryrun_multichip(2, "cpu", timeout=240) == 0
    out = capfd.readouterr().out
    assert "dryrun_multichip(2) dp ok: loss=" in out
    assert "sharded eval ok" in out
    assert "dryrun_multichip(2) dp x tp (1x2) ok: loss=" in out
    assert "dryrun_multichip(2) dp x tp global batch (1x2) ok: loss=" in out
