"""The port's tensor parallelism (parallel/tp.py, a mesh's model axis in
parallel/mesh.py, the sharded relation head of models/relation_head.py,
make_train_step / make_eval_step on a (1, 2) mesh) against the JAX
package's GSPMD tensor-parallel step (parallel/tp.py's shard_params on
make_mesh(data=1, model=2), the mesh-less step), on the CPU.

World size 2 is one gloo group of two processes at mesh (1, 2)
(tests/torch_mesh_worker.py, rendezvous through a file store under the
test's temporary directory), started once for the module; the JAX side
runs here on 2 of conftest's 8 host devices, on the same weights and numpy
batches (tiny_cfg widths, dropout off where JAX is the reference).

Tolerances: float64 (JAX with x64 on) atol 1e-8 on every gathered
parameter and every float metric after each of 3 train steps (ordinary
with the augmented view and a clip that fires, faithful, chunked), counts
equal; the eval step's float outputs 1e-8, integer outputs equal; with
dropout on, the sharded step against the port's unsharded step of the same
seed 1e-10 (the same masks; sums split over two ranks); the replicated
parameters of both ranks equal bit for bit."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, "tests")
from test_torch_tiny import (  # noqa: E402
    INT_METRICS, assert_trees_close, batches, cfgs, flax_params,
    torch_model)

from scene_graph_commonsense_tpu.constants import (  # noqa: E402
    class_weights as jax_class_weights)
from scene_graph_commonsense_tpu.models.relation_head import (  # noqa: E402
    make_relation_classifier as make_jax_classifier)
from scene_graph_commonsense_tpu.parallel import mesh as jax_mesh  # noqa
from scene_graph_commonsense_tpu.parallel import tp as jax_tp  # noqa: E402
from scene_graph_commonsense_tpu.train import engine as jax_engine  # noqa
from scene_graph_commonsense_torch.constants import (  # noqa: E402
    class_weights)
from scene_graph_commonsense_torch.models import weights  # noqa: E402
from scene_graph_commonsense_torch.parallel import mesh as mesh_lib  # noqa
from scene_graph_commonsense_torch.parallel import tp  # noqa: E402
from scene_graph_commonsense_torch.parallel.launch import (  # noqa: E402
    run_processes)
from scene_graph_commonsense_torch.train import engine  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, MODEL = 2, 2
CLIP = 0.05
CHUNK = 16
DROPOUT = 0.3
# name -> (port config overrides, clip, faithful, chunk)
TRAIN = {
    "train": ({"grad_clip_norm": CLIP}, CLIP, False, 0),
    "faithful": ({"faithful_dynamics": True, "pair_capacity": 40,
                  "grad_clip_norm": CLIP}, CLIP, True, 0),
    "chunked": ({"grad_clip_norm": CLIP}, CLIP, False, CHUNK),
}


def _state_dict(params, dtype=torch.float64):
    return {k: v.to(dtype) for k, v in weights.from_flax(params).items()}


def _flax(state_dict):
    return weights.to_flax(state_dict)["params"]


def run_world(work, spec):
    """Runs every scenario of `spec` in one gloo group of spec["world"]
    processes (tests/torch_mesh_worker.py); the results by scenario, one
    entry per rank."""
    torch.save(spec, work / "spec.pt")
    world = spec["world"]
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    logs = [work / f"rank{r}.log" for r in range(world)]
    codes, _ = run_processes(
        [[sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
          str(work), str(rank)] for rank in range(world)], ROOT, env, logs,
        timeout=600)
    errors = [(work / f"error_rank{r}.txt") for r in range(world)]
    if any(codes):
        pytest.fail(f"world-{world} run failed:\n" + "\n".join(
            e.read_text() for e in errors if e.exists()) + "\n".join(
            log.read_text()[-3000:] for log in logs))
    return {name: [torch.load(work / f"{name}_rank{r}.pt",
                              weights_only=False) for r in range(world)]
            for name, _ in spec["scenarios"]}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every scenario of the (1, 2) mesh in one gloo group of two
    processes; the inputs and the results of each."""
    work = tmp_path_factory.mktemp("tp")
    params = flax_params()
    inputs = {"params": params, "eval": batches(2, seed=9, with_aug=False),
              "dropout": batches(3, seed=21)}
    scenarios = [("layout", {"kind": "tp_layout", "cfg": cfgs()[1],
                             "state_dict": "sd64", "dtype": torch.float64,
                             "flax": params})]
    for i, (name, (training, clip, faithful, chunk)) in enumerate(
            TRAIN.items()):
        inputs[name] = batches(3, seed=40 + i)
        scenarios.append((name, {
            "kind": "tp_train", "cfg": cfgs(training=training)[1],
            "state_dict": "sd64", "dtype": torch.float64,
            "batches": inputs[name], "clip": clip, "faithful": faithful,
            "chunk": chunk}))
    scenarios.append(("dropout", {
        "kind": "tp_train", "cfg": cfgs(training={"grad_clip_norm": CLIP},
                                        model={"dropout_rate": DROPOUT})[1],
        "state_dict": "sd64", "dtype": torch.float64,
        "batches": inputs["dropout"], "clip": CLIP, "faithful": False}))
    scenarios.append(("eval", {"kind": "tp_eval", "cfg": cfgs()[1],
                               "state_dict": "sd64", "dtype": torch.float64,
                               "batches": inputs["eval"]}))
    inputs["results"] = run_world(work, {
        "world": WORLD, "model": MODEL,
        "tensors": {"sd64": _state_dict(params)}, "scenarios": scenarios})
    return inputs


def test_torch_tp_layout_matches_jax():
    """Every state-dict name's spec is the transpose of the JAX package's
    for its flax leaf (test_param_shardings_layout's rules: fc1 column-,
    fc2_h row-parallel, the rest and fc2_h's bias replicated), and
    shard_params gives each model index the block JAX's NamedSharding
    places on that device of make_mesh(data=1, model=2)."""
    params = flax_params()
    sd = _state_dict(params)
    jspecs = jax_tp.param_shardings(params, jax_mesh.make_mesh(
        data=1, model=MODEL))["params"]
    specs = tp.param_shardings(sd)
    assert specs["fc1.weight"] == ("model", None)
    assert specs["fc1.bias"] == ("model",)
    assert specs["fc2_h.weight"] == (None, "model")
    assert specs["fc2_h.bias"] == specs["conv3.weight"] == ()
    assert specs["emb_c1.weight"] == ()
    for k, spec in specs.items():
        name, kind = k.rsplit(".", 1)
        leaf = {"weight": "embedding" if name.startswith("emb_")
                else "kernel"}.get(kind, kind)
        want = tuple(jspecs[name][leaf].spec)
        if leaf == "kernel" and sd[k].ndim == 2:
            want = want[::-1]
        assert spec == want, k
    mesh = jax_mesh.make_mesh(data=1, model=MODEL)
    placed = jax_tp.shard_params(jax.tree.map(jnp.asarray, params), mesh)
    devices = list(mesh.devices[0])
    for name, kind, key in (("fc1", "kernel", "fc1.weight"),
                            ("fc1", "bias", "fc1.bias"),
                            ("fc2_h", "kernel", "fc2_h.weight"),
                            ("fc2_h", "bias", "fc2_h.bias")):
        for shard in placed["params"][name][kind].addressable_shards:
            index = devices.index(shard.device)
            got = tp.shard_params(sd, mesh_lib.Mesh(
                1, MODEL, index, torch.device("cpu")))[key].numpy()
            np.testing.assert_array_equal(
                got.T if kind == "kernel" else got, np.asarray(shard.data))


def test_torch_tp_shards_round_trip(world2):
    """On each rank: shard_params, from_flax(mesh=) and shard_module give
    the same shards (this rank's half of fc1's rows and bias, of fc2_h's
    columns; the rest whole), and gather_params of the shards is the full
    state dict."""
    sd = _state_dict(world2["params"])
    for rank, r in enumerate(world2["results"]["layout"]):
        assert r["round_trip"]
        for k, full in sd.items():
            dim = tp.shard_dim(k)
            want = full if dim is None else full.chunk(MODEL, dim)[rank]
            for got in (r["shards"][k], r["from_flax"][k], r["module"][k]):
                assert torch.equal(got, want), (rank, k)


def _jax_tp_steps(jc, params, bts, faithful, clip, chunk):
    """JAX's GSPMD tensor-parallel step: the mesh-less make_train_step on
    shard_params(params, make_mesh(data=1, model=2)), the batch on
    P('data'), x64.  (params, metrics) after each step."""
    w = jax_class_weights("vg", faithful=faithful)
    with jax.enable_x64():
        mesh = jax_mesh.make_mesh(data=1, model=MODEL)
        opt = jax_engine.make_optimizer(1e-3, grad_clip_norm=clip)
        tparams = jax_tp.shard_params(jax.tree.map(jnp.asarray, params),
                                      mesh)
        state = jax_engine.TrainState(tparams, jax.jit(opt.init)(tparams),
                                      jnp.int32(0))
        step = jax_engine.make_train_step(make_jax_classifier(jc), jc, opt,
                                          w, donate=False, chunk_size=chunk)
        sh = NamedSharding(mesh, P("data"))
        want = []
        for b in bts:
            state, met = step(state, {k: jax.device_put(jnp.asarray(v), sh)
                                      for k, v in b.items()},
                              jax.random.PRNGKey(0))
            assert "model" in str(
                state.params["params"]["fc1"]["kernel"].sharding.spec)
            want.append((jax.tree.map(np.array, state.params)["params"],
                         {k: float(v) for k, v in met.items()}))
    return want


def check_trail(trail, want, atol=1e-8):
    """Each step's gathered parameters and metrics against JAX's."""
    for (sd, got, _), (w_params, w_met) in zip(trail, want):
        assert_trees_close(_flax(sd), w_params, atol)
        assert got.keys() == w_met.keys()
        for k, w in w_met.items():
            if k in INT_METRICS:
                assert got[k] == w, k
            else:
                np.testing.assert_allclose(got[k], w, atol=atol, rtol=0,
                                           err_msg=k)


def check_replicas(trails):
    """Every rank's replicated parameters bit-identical after every step,
    and the same metrics."""
    for steps in zip(*trails):
        assert all(same for _, _, same in steps)
        assert all(m == steps[0][1] for _, m, _ in steps)


@pytest.mark.parametrize("scenario", list(TRAIN))
def test_torch_tp_train_steps_match_jax_gspmd_f64(world2, scenario):
    """3 train steps at mesh (1, 2), fc1 and fc2_h split over the two
    ranks (ordinary: augmented view and a clip that fires, whose global
    norm adds the shards' squares over the model group; faithful: the
    lr_scale; chunked: the chunked trunk's fc1 inside its checkpointed
    chunks): the gathered parameters and every metric within 1e-8 of JAX's
    GSPMD step, the replicas bit-identical; each update moves some weight
    by over 10x that."""
    training, clip, faithful, chunk = TRAIN[scenario]
    jc, _ = cfgs(training=training)
    trails = world2["results"][scenario]
    check_replicas(trails)
    want = _jax_tp_steps(jc, world2["params"], world2[scenario], faithful,
                         clip, chunk)
    check_trail(trails[0], want)
    prev = world2["params"]["params"]
    for w_params, _ in want:
        assert max(np.abs(w - prev[k][kind]).max()
                   for k, leaf in w_params.items()
                   for kind, w in leaf.items()) > 1e-7
        prev = w_params
    mets = [m for _, m, _ in trails[0]]
    assert all(m["loss_contrast"] > 0 for m in mets)
    if faithful:
        assert min(m["lr_scale"] for m in mets) < 1


def test_torch_tp_eval_step_matches_jax(world2):
    """The eval step at mesh (1, 2) (make_eval_step shards the model):
    every output key of JAX's eval step on its TP parameters within 1e-8,
    integers equal, both ranks the same; run_eval_pc's results the same on
    both ranks."""
    jc, _ = cfgs()
    r0, r1 = world2["results"]["eval"]
    assert r0["sharded"] and r1["sharded"]
    with jax.enable_x64():
        mesh = jax_mesh.make_mesh(data=1, model=MODEL)
        tparams = jax_tp.shard_params(
            jax.tree.map(jnp.asarray, world2["params"]), mesh)
        estep = jax_engine.make_eval_step(make_jax_classifier(jc), jc)
        for b, got0, got1 in zip(world2["eval"], r0["outs"], r1["outs"]):
            want = jax.tree.map(np.asarray, estep(
                tparams, {k: jnp.asarray(v) for k, v in b.items()}))
            assert got0.keys() == want.keys()
            for k, w in want.items():
                np.testing.assert_array_equal(got0[k], got1[k], err_msg=k)
                assert got0[k].shape == w.shape, k
                if np.issubdtype(w.dtype, np.floating):
                    np.testing.assert_allclose(got0[k], w, atol=1e-8,
                                               rtol=0, err_msg=k)
                else:
                    np.testing.assert_array_equal(got0[k], w, err_msg=k)
    for k, v in r0["results"].items():
        np.testing.assert_equal(r1["results"][k], v, err_msg=k)


def test_torch_tp_dropout_step_equals_unsharded_step(world2):
    """With dropout on (rate 0.3 at both sites): the (1, 2) step draws the
    unsharded step's masks (fc1's full-width mask, each rank keeping its
    columns; fc2's whole on both ranks), so 3 steps equal the port's
    unsharded step of the same seed within 1e-10, the replicas
    bit-identical; and the masks bite: the step without dropout differs."""
    jc, tc = cfgs(training={"grad_clip_norm": CLIP},
                  model={"dropout_rate": DROPOUT})
    trails = world2["results"]["dropout"]
    check_replicas(trails)
    runs = []
    for cfg in (tc, cfgs(training={"grad_clip_norm": CLIP})[1]):
        model = torch_model(cfg, world2["params"])
        opt = engine.make_optimizer(1e-3, grad_clip_norm=CLIP)
        step = engine.make_train_step(model, cfg, opt, class_weights("vg"),
                                      device="cpu")
        state = engine.init_train_state(model, opt)
        trail = []
        for b in world2["dropout"]:
            state, met = step(state, b)
            trail.append(({k: v.clone() for k, v in
                           model.state_dict().items()},
                          {k: float(v) for k, v in met.items()}))
        runs.append(trail)
    for (sd, got, _), (w_sd, w_met) in zip(trails[0], runs[0]):
        for k, w in w_sd.items():
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-10,
                                       rtol=0, err_msg=k)
        for k, w in w_met.items():
            np.testing.assert_allclose(got[k], w, atol=1e-10, rtol=0,
                                       err_msg=k)
    off = runs[1][0][0]
    assert max(float((trails[0][0][0][k] - off[k]).abs().max())
               for k in off) > 1e-6
