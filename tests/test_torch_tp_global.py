"""The port's global-batch train step (make_train_step(mesh=,
global_batch=True)) against the JAX package's GSPMD step at (data, model)
meshes of (2, 2) and (2, 1), on the CPU: the JAX package's parallel/tp.py
recipe, shard_params on make_mesh(data, model) and the mesh-less step on a
P('data') batch, whose losses are the whole global batch's.

Both worlds start in one launch for the module: a gloo group of four
processes at mesh (2, 2) and one of two at (2, 1)
(tests/torch_mesh_worker.py), each running every scenario of its world; the
JAX side runs here on conftest's host devices with x64 on, on the same
weights and numpy batches (tiny_cfg widths).  The batches have 6, 6, 4 and 3
valid objects: the data index 0 holds 60 valid pairs and the data index 1
18, and the global capacities (70 valid pairs, 14 connected ones; the
second shard's images are fully related) cut inside the second shard's
rows, so each shard keeps a different part of its pairs.

Tolerances: float64 atol 1e-8 on every gathered parameter and float metric
after each of 3 steps (ordinary: the SupCon view and a clip that fires;
faithful), counts equal; with dropout on (rate 0.3; also with the chunked
trunk, at a chunk shorter than a rank's pair buffer and at one between it
and the global buffer) the (2, 2) step against the port's unsharded step of the same seed
1e-10 (the same masks, sums split over the ranks); every replica
bit-identical.  The shard_map step (global_batch=False) on the same shards
misses JAX's GSPMD step by more than a tenth of its largest update.
exclusive_prefix, gather_rows (with its gradient) and global_losses of
parallel/mesh.py on rank-dependent inputs, exact."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, "tests")
from test_torch_tiny import batches, cfgs, flax_params, torch_model  # noqa
from test_torch_tp import (  # noqa: E402
    ROOT, _flax, _state_dict, check_replicas, check_trail)

from scene_graph_commonsense_tpu.constants import (  # noqa: E402
    class_weights as jax_class_weights)
from scene_graph_commonsense_tpu.models.relation_head import (  # noqa: E402
    make_relation_classifier as make_jax_classifier)
from scene_graph_commonsense_tpu.parallel import mesh as jax_mesh  # noqa
from scene_graph_commonsense_tpu.parallel import tp as jax_tp  # noqa: E402
from scene_graph_commonsense_tpu.train import engine as jax_engine  # noqa
from scene_graph_commonsense_torch.constants import (  # noqa: E402
    class_weights)
from scene_graph_commonsense_torch.parallel.launch import (  # noqa: E402
    run_processes)
from scene_graph_commonsense_torch.train import engine  # noqa: E402

CLIP = 0.05
DROPOUT = 0.3
CHUNK = 16
# a chunk longer than a rank's 60-row buffer and shorter than the global
# 70: the rank runs its buffer at once, the masks still drawn by chunk
WIDE_CHUNK = 64
COUNTS = (6, 6, 4, 3)
CAPACITY, AUG_CAPACITY = 70, 14
SEED = 67
ORDINARY = {"grad_clip_norm": CLIP, "pair_capacity": CAPACITY,
            "aug_pair_capacity": AUG_CAPACITY}
FAITHFUL = {**ORDINARY, "faithful_dynamics": True}
MESHES = {"2x2": (2, 2), "2x1": (2, 1)}
# name -> (mesh, training overrides, model overrides, chunk, global batch)
SCENARIOS = {
    "2x2_ordinary": ("2x2", ORDINARY, {}, 0, True),
    "2x2_faithful": ("2x2", FAITHFUL, {}, 0, True),
    "2x2_dropout": ("2x2", ORDINARY, {"dropout_rate": DROPOUT}, 0, True),
    "2x2_chunked_dropout": ("2x2", ORDINARY, {"dropout_rate": DROPOUT},
                            CHUNK, True),
    "2x2_wide_chunk_dropout": ("2x2", ORDINARY, {"dropout_rate": DROPOUT},
                               WIDE_CHUNK, True),
    "2x1_ordinary": ("2x1", ORDINARY, {}, 0, True),
    "2x1_shard_map": ("2x1", ORDINARY, {}, 0, False),
}
JAX_CASES = ("2x2_ordinary", "2x2_faithful", "2x1_ordinary")
DROPOUT_CASES = ("2x2_dropout", "2x2_chunked_dropout",
                 "2x2_wide_chunk_dropout")


def shaped(b, rng):
    """The batch cut to COUNTS valid objects an image, every pair of the
    second shard's images related (one direction, a random predicate)."""
    b = dict(b)
    n = b["valid"].shape[1]
    valid = np.arange(n)[None, :] < np.asarray(COUNTS)[:, None]
    pair = valid[:, :, None] & valid[:, None, :]
    rel = np.where(pair, b["rel"], -1)
    for img in range(len(COUNTS) // 2, len(COUNTS)):
        for i in range(COUNTS[img]):
            for j in range(i):
                r = rng.integers(0, 50)
                rel[img, i, j], rel[img, j, i] = (r, -1) \
                    if rng.random() < 0.5 else (-1, r)
    b.update(valid=valid, cats=np.where(valid, b["cats"], 0), rel=rel)
    return b


def global_batches(seed):
    rng = np.random.default_rng(seed)
    return [shaped(b, rng) for b in batches(3, seed=seed)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both meshes' scenarios in one launch of six processes; the inputs and
    the results by scenario, one entry per rank."""
    params = flax_params()
    inputs = {"params": params, "batches": global_batches(SEED)}
    sd = {"sd64": _state_dict(params)}
    works, argvs, logs = {}, [], []
    for name, (data, model) in MESHES.items():
        work = tmp_path_factory.mktemp(f"tp_global_{name}")
        scenarios = [(f"{name}_collectives", {"kind": "collectives"})]
        for sc, (mesh, training, model_kw, chunk, glob) in SCENARIOS.items():
            if mesh == name:
                scenarios.append((sc, {
                    "kind": "tp_train",
                    "cfg": cfgs(training=training, model=model_kw)[1],
                    "state_dict": "sd64", "dtype": torch.float64,
                    "batches": inputs["batches"], "clip": CLIP,
                    "faithful": training.get("faithful_dynamics", False),
                    "chunk": chunk, "global_batch": glob}))
        torch.save({"world": data * model, "model": model, "tensors": sd,
                    "scenarios": scenarios}, work / "spec.pt")
        works[name] = (work, data * model, [s for s, _ in scenarios])
        for rank in range(data * model):
            argvs.append([sys.executable, os.path.join(
                ROOT, "tests", "torch_mesh_worker.py"), str(work),
                str(rank)])
            logs.append(work / f"rank{rank}.log")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    codes, _ = run_processes(argvs, ROOT, env, logs, timeout=600)
    if any(codes):
        pytest.fail("global-batch worlds failed:\n" + "\n".join(
            p.read_text() for work, world, _ in works.values()
            for p in work.glob("error_rank*.txt")) + "\n".join(
            log.read_text()[-3000:] for log in logs))
    inputs["results"] = {
        sc: [torch.load(work / f"{sc}_rank{r}.pt", weights_only=False)
             for r in range(world)]
        for work, world, names in works.values() for sc in names}
    return inputs


@functools.lru_cache(maxsize=None)
def _jax_gspmd_steps(name):
    """JAX's GSPMD step over the scenario's mesh: shard_params of the
    shared weights on make_mesh(data, model) and the mesh-less
    make_train_step on the global batches, placed on P('data'), x64.
    (params, metrics) after each step; computed once a scenario."""
    params, bts = flax_params(), global_batches(SEED)
    mesh_name, training, model_kw, chunk, _ = SCENARIOS[name]
    data, model = MESHES[mesh_name]
    jc, _ = cfgs(training=training, model=model_kw)
    faithful = training.get("faithful_dynamics", False)
    with jax.enable_x64():
        mesh = jax_mesh.make_mesh(data=data, model=model)
        opt = jax_engine.make_optimizer(1e-3, grad_clip_norm=CLIP)
        tparams = jax_tp.shard_params(jax.tree.map(jnp.asarray, params),
                                      mesh)
        state = jax_engine.TrainState(tparams, jax.jit(opt.init)(tparams),
                                      jnp.int32(0))
        step = jax_engine.make_train_step(
            make_jax_classifier(jc), jc, opt,
            jax_class_weights("vg", faithful=faithful), donate=False,
            chunk_size=chunk)
        sh = NamedSharding(mesh, P("data"))
        want = []
        for b in bts:
            state, met = step(state, {k: jax.device_put(jnp.asarray(v), sh)
                                      for k, v in b.items()},
                              jax.random.PRNGKey(0))
            want.append((jax.tree.map(np.array, state.params)["params"],
                         {k: float(v) for k, v in met.items()}))
    return want


def _unsharded_steps(name, params, bts):
    """The port's unsharded step on the CPU over the global batches, the
    scenario's configuration: (state dict, metrics) after each step."""
    _, training, model_kw, chunk, _ = SCENARIOS[name]
    _, tc = cfgs(training=training, model=model_kw)
    model = torch_model(tc, params)
    opt = engine.make_optimizer(1e-3, grad_clip_norm=CLIP)
    step = engine.make_train_step(model, tc, opt, class_weights("vg"),
                                  device="cpu", chunk_size=chunk)
    state = engine.init_train_state(model, opt)
    trail = []
    for b in bts:
        state, met = step(state, b)
        trail.append(({k: v.clone() for k, v in model.state_dict().items()},
                      {k: float(v) for k, v in met.items()}))
    return trail


def test_torch_tp_global_inputs_cut_inside_the_second_shard(worlds):
    """The scenario's premise: on every batch the shards hold unequal
    valid and connected pair counts, and both global capacities fall
    between the first shard's count and the total, so the second shard
    keeps only part of its pairs; the steps report the global overflow."""
    half = len(COUNTS) // 2
    for b in worlds["batches"]:
        pair = b["valid"][:, :, None] & b["valid"][:, None, :] \
            & ~np.eye(len(b["valid"][0]), dtype=bool)
        conn = pair & (b["rel"] >= 0)
        for grid, cap in ((pair, CAPACITY), (conn, AUG_CAPACITY)):
            first, second = grid[:half].sum(), grid[half:].sum()
            assert first != second and first < cap < first + second
    for _, met, _ in worlds["results"]["2x2_ordinary"][0]:
        assert met["pair_overflow"] > 0 and met["aug_pair_overflow"] > 0


@pytest.mark.parametrize("name", JAX_CASES)
def test_torch_tp_global_step_matches_jax_gspmd_f64(worlds, name):
    """3 global-batch steps (at (2, 2): fc1 and fc2_h split over the model
    axis; ordinary with the SupCon view and a clip that fires, faithful
    with its lr_scale over the global batch): the gathered parameters and
    every metric within 1e-8 of JAX's GSPMD step, the replicas
    bit-identical."""
    trails = worlds["results"][name]
    check_replicas(trails)
    want = _jax_gspmd_steps(name)
    check_trail(trails[0], want)
    mets = [m for _, m, _ in trails[0]]
    assert all(m["loss_contrast"] > 0 for m in mets)
    if SCENARIOS[name][1].get("faithful_dynamics"):
        assert min(m["lr_scale"] for m in mets) < 1


@pytest.mark.parametrize("name", DROPOUT_CASES)
def test_torch_tp_global_dropout_step_equals_unsharded_step(worlds, name):
    """With dropout on at both sites (and with the chunked trunk, whose
    masks are drawn a chunk of the global buffer at a time): every rank
    draws the unsharded step's masks and keeps its rows, so 3 steps at
    (2, 2) equal the port's unsharded step on the global batches within
    1e-10, the replicas bit-identical; the masks bite: the same step
    without dropout differs."""
    trails = worlds["results"][name]
    check_replicas(trails)
    want = _unsharded_steps(name, worlds["params"], worlds["batches"])
    for (sd, got, _), (w_sd, w_met) in zip(trails[0], want):
        for k, w in w_sd.items():
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-10,
                                       rtol=0, err_msg=k)
        assert got.keys() == w_met.keys()
        for k, w in w_met.items():
            np.testing.assert_allclose(got[k], w, atol=1e-10, rtol=0,
                                       err_msg=k)
    off = worlds["results"]["2x2_ordinary"][0][0][0]
    assert max(float((trails[0][0][0][k] - off[k]).abs().max())
               for k in off) > 1e-6


def test_torch_tp_shard_map_step_differs_from_gspmd(worlds):
    """The default step (global_batch=False, the JAX package's shard_map
    step: local losses averaged over 'data') on the same shards is not
    the GSPMD step: its first update misses JAX's by more than a tenth of
    the largest update, where the global-batch step is within 1e-8."""
    want = _jax_gspmd_steps("2x1_ordinary")[0][0]
    before = worlds["params"]["params"]
    update = max(np.abs(w - before[k][kind]).max()
                 for k, leaf in want.items() for kind, w in leaf.items())
    for name, lo, hi in (("2x1_shard_map", 0.1 * update, np.inf),
                         ("2x1_ordinary", 0.0, 1e-8)):
        got = _flax(worlds["results"][name][0][0][0])
        err = max(np.abs(got[k][kind] - w).max()
                  for k, leaf in want.items() for kind, w in leaf.items())
        assert lo < err <= hi, (name, err, update)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_torch_tp_global_collectives(worlds, mesh_name):
    """parallel.mesh's global-batch collectives on every rank:
    exclusive_prefix gives the earlier data indices' sums; gather_rows
    concatenates the data group's blocks in data-index order, and its
    backward (the reduce-scatter) hands each rank the sum of every rank's
    gradient of its block; global_losses divides by the group's
    denominator, the shares summing to the global ratio."""
    data, model = MESHES[mesh_name]
    res = worlds["results"][f"{mesh_name}_collectives"]
    block = np.arange(6, dtype=np.float64).reshape(2, 3)
    weights_ = np.arange(6 * data, dtype=np.float64).reshape(2 * data, 3)
    for rank, r in enumerate(res):
        i = rank // model
        assert r["offsets"] == [sum(range(1, i + 1)),
                                10 * sum(range(1, i + 1))]
        np.testing.assert_array_equal(r["gathered"].numpy(), np.concatenate(
            [block + 100 * j for j in range(data)]))
        np.testing.assert_array_equal(r["grad"].numpy(),
                                      data * weights_[2 * i:2 * i + 2])
        assert float(r["share"]) == 2.0 * (i + 1) / data
    assert sum(float(r["share"]) for r in res[::model]) \
        == sum(6.0 * (j + 1) for j in range(data)) / (3 * data)
