"""The port's PredCLS training slice (train/engine.make_train_step, the SGD
update, train/loop.fit, the CLI's train modes) against the JAX package's,
on the same weights and numpy batches, on the CPU.

Tolerances: float64 (JAX with x64 on) atol 1e-8 on every parameter after
each of 3 train steps and on the float metrics, integer metrics equal; the
optimizer alone 1e-12 in float64; tables, schedules and indices equal.
Dropout is off in the parity runs (the two packages draw different
masks)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

sys.path.insert(0, "tests")
from test_engine import tiny_cfg, init_params  # noqa: E402

from scene_graph_commonsense_tpu.constants import (  # noqa: E402
    class_weights as jax_class_weights)
from scene_graph_commonsense_tpu.data.synthetic import (  # noqa: E402
    synthetic_batch)
from scene_graph_commonsense_tpu.models.relation_head import (  # noqa: E402
    make_relation_classifier)
from scene_graph_commonsense_tpu.ops import pairs as jax_pairs  # noqa: E402
from scene_graph_commonsense_tpu.train import engine as jax_engine  # noqa
from scene_graph_commonsense_tpu.train import loop as jax_loop  # noqa: E402
from scene_graph_commonsense_torch import bench  # noqa: E402
from scene_graph_commonsense_torch import config as torch_config  # noqa
from scene_graph_commonsense_torch.__main__ import (  # noqa: E402
    synthetic_batches)
from scene_graph_commonsense_torch.constants import class_weights  # noqa
from scene_graph_commonsense_torch.data.artifacts import (  # noqa: E402
    load_vg_artifacts)
from scene_graph_commonsense_torch.data.pipeline import (  # noqa: E402
    prefetch_iterator, to_device)
from scene_graph_commonsense_torch.eval import engines  # noqa: E402
from scene_graph_commonsense_torch.models import weights  # noqa: E402
from scene_graph_commonsense_torch.models.relation_head import (  # noqa
    make_relation_classifier as make_torch_classifier)
from scene_graph_commonsense_torch.ops import pairs  # noqa: E402
from scene_graph_commonsense_torch.parallel import mesh as mesh_lib  # noqa
from scene_graph_commonsense_torch.train import engine  # noqa: E402
from scene_graph_commonsense_torch.train import loop  # noqa: E402

ARTIFACTS_DIR = "datasets/artifacts"
INT_METRICS = ("num_connected", "num_not_connected", "num_connected_pred",
               "connectivity_precision_hits", "connectivity_recall_hits",
               "num_pairs", "pair_overflow", "aug_pair_overflow")


def _replace(section, **kw):
    return dataclasses.replace(section, **kw)


def _cfgs(clip=0.05, dtype="float64", dropout=0.0):
    jc = tiny_cfg()
    jc = jc.replace(
        model=_replace(jc.model, compute_dtype=dtype, dropout_rate=dropout),
        training=_replace(jc.training, grad_clip_norm=clip))
    tc = torch_config.derive("vg", model=dict(jc.model.__dict__),
                             data={"max_objects": jc.data.max_objects},
                             training=dict(jc.training.__dict__))
    return jc, tc


def _batches(n, seed=3, with_aug=True):
    jc = tiny_cfg()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = synthetic_batch(
            rng, batch_size=jc.training.batch_size,
            max_objects=jc.data.max_objects,
            feature_size=jc.model.feature_size,
            num_channels=jc.model.num_img_feature,
            num_classes=jc.model.num_classes, with_aug=with_aug)
        out.append({k: v.astype(np.float64) if v.dtype == np.float32 else v
                    for k, v in b.items()})
    return out


@pytest.fixture(scope="module")
def flax_params():
    jc, _ = _cfgs(dtype="float32")
    params = init_params(jc, make_relation_classifier(jc), None)
    return jax.tree.map(lambda x: np.asarray(x, np.float64), params)


def _torch_model(tc, params, dtype=torch.float64):
    sd = {k: v.to(dtype) for k, v in weights.from_flax(params).items()}
    return make_torch_classifier(tc, device="cpu", state_dict=sd).to(dtype)


def _torch_steps(tc, params, batches, clip):
    model = _torch_model(tc, params)
    opt = engine.make_optimizer(1e-3, grad_clip_norm=clip)
    state = engine.init_train_state(model, opt)
    step = engine.make_train_step(model, tc, opt, class_weights("vg"),
                                  device="cpu")
    trail = []
    for b in batches:
        state, met = step(state, b)
        trail.append((weights.to_flax(model.state_dict())["params"],
                      {k: float(v) for k, v in met.items()}))
    return trail


def test_torch_train_steps_match_jax_f64(flax_params):
    """3 steps with the augmented view and clipping that fires: every
    parameter after each step within 1e-8 of the JAX step's."""
    clip = 0.05
    jc, tc = _cfgs(clip)
    batches = _batches(3)
    with jax.enable_x64():
        params = jax.tree.map(jnp.asarray, flax_params)
        opt = jax_engine.make_optimizer(1e-3, grad_clip_norm=clip)
        state = jax_engine.TrainState(params, opt.init(params), jnp.int32(0))
        step = jax_engine.make_train_step(
            make_relation_classifier(jc), jc, opt, jax_class_weights("vg"),
            donate=False)
        want = []
        for b in batches:
            state, met = step(state, {k: jnp.asarray(v)
                                      for k, v in b.items()},
                              jax.random.PRNGKey(0))
            want.append((jax.tree.map(np.array, state.params)["params"],
                         {k: float(v) for k, v in met.items()}))
    got = _torch_steps(tc, flax_params, batches, clip)
    for (g_params, g_met), (w_params, w_met) in zip(got, want):
        assert g_params.keys() == w_params.keys()
        for name, leaf in w_params.items():
            for kind, w in leaf.items():
                np.testing.assert_allclose(g_params[name][kind], w,
                                           atol=1e-8, rtol=0,
                                           err_msg=f"{name}.{kind}")
        assert g_met.keys() == w_met.keys()
        for k, w in w_met.items():
            if k in INT_METRICS:
                assert g_met[k] == w, k
            else:
                np.testing.assert_allclose(g_met[k], w, atol=1e-8, rtol=0,
                                           err_msg=k)
        assert g_met["loss_contrast"] > 0 and g_met["num_connected"] > 0
    # the clip changed the update: without it the parameters differ
    unclipped = _torch_steps(tc, flax_params, batches[:1], 0.0)[0][0]
    assert not np.allclose(unclipped["fc1"]["kernel"],
                           got[0][0]["fc1"]["kernel"], atol=1e-6)


@pytest.mark.parametrize("clip,momentum_dtype", [
    (0.0, "float32"), (1e-3, "float32"), (1e3, "float32"),
    (1e-3, "bfloat16")])
def test_torch_sgd_matches_optax(rng, clip, momentum_dtype):
    """make_optimizer against optax's chain on a float64 tree: 4 updates
    across a schedule boundary, clipping firing, not firing, or off, the
    momentum in float32 or bfloat16."""
    shapes = {"w": (7, 5), "b": (5,), "e": (3, 4, 2)}
    params = {k: rng.standard_normal(s) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s) for k, s in shapes.items()}
             for _ in range(4)]

    def sched(count):
        return 0.1 * (1.0 if count < 2 else 0.1)

    with jax.enable_x64():
        opt = jax_engine.make_optimizer(
            optax.piecewise_constant_schedule(0.1, {2: 0.1}),
            grad_clip_norm=clip, momentum_dtype=momentum_dtype)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        st = opt.init(jp)
        for g in grads:
            upd, st = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 st, jp)
            jp = optax.apply_updates(jp, upd)
        want = {k: np.asarray(v) for k, v in jp.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = engine.make_optimizer(sched, grad_clip_norm=clip,
                                 momentum_dtype=momentum_dtype)
    state = topt.init(tp)
    for g in grads:
        state = topt.update({k: torch.from_numpy(v.copy())
                             for k, v in g.items()}, state, tp)
    assert state.count == 4
    assert all(t.dtype == getattr(torch, momentum_dtype)
               for t in state.trace.values())
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), want[k], atol=1e-12,
                                   rtol=0, err_msg=k)


def test_torch_lr_schedule_matches_optax():
    jc = tiny_cfg()
    jc = jc.replace(training=_replace(jc.training, learning_rate=1e-5,
                                      scheduler_epochs=(2, 5)))
    _, tc = _cfgs()
    tc = tc.replace(training=_replace(tc.training, learning_rate=1e-5,
                                      scheduler_epochs=(2, 5)))
    steps = 7
    want = jax_loop.lr_schedule(jc, steps)
    got = loop.lr_schedule(tc, steps)
    for count in (0, 1, 13, 14, 15, 34, 35, 36, 1000):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-7, err_msg=str(count))
    assert got(13) == 1e-5 and got(14) < 1e-5 and got(35) < got(34)


def test_torch_align_packings_matches_jax(rng):
    b = synthetic_batch(rng, batch_size=3, max_objects=6, feature_size=8,
                        num_channels=4, with_aug=False)
    for cap, aug_cap in ((90, 20), (40, 8)):
        valid_j = jnp.asarray(b["valid"])
        conn_j = jax_pairs.pair_validity(valid_j) & (jnp.asarray(b["rel"])
                                                     >= 0)
        want = jax_pairs.align_packings(
            jax_pairs.pack_pairs(jax_pairs.pair_validity(valid_j), cap),
            jax_pairs.pack_pairs(conn_j, aug_cap))
        valid_t = torch.from_numpy(b["valid"])
        conn_t = pairs.pair_validity(valid_t) & (torch.from_numpy(b["rel"])
                                                 >= 0)
        got = pairs.align_packings(
            pairs.pack_pairs(pairs.pair_validity(valid_t), cap),
            pairs.pack_pairs(conn_t, aug_cap))
        assert got[0].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert bool(got[1].any())


@pytest.mark.parametrize("dataset", ["vg", "oiv6"])
def test_torch_class_weights_match_jax(dataset):
    for clustering in ("motif", "gpt2", "bert", "clip"):
        for faithful in (False, True):
            got = class_weights(dataset, clustering, faithful)
            want = jax_class_weights(dataset, clustering, faithful)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_torch_eval_step_after_train_step_is_deterministic(flax_params):
    """A train step (dropout on, module in train mode) followed by the eval
    step on the same module gives what a fresh eval-mode model with the
    updated weights gives."""
    _, tc = _cfgs(clip=1.0, dtype="float32", dropout=0.5)
    model = _torch_model(tc, flax_params, torch.float32)
    estep = engine.make_eval_step(model, tc, device="cpu")
    opt = engine.make_optimizer(1e-3, grad_clip_norm=1.0)
    step = engine.make_train_step(model, tc, opt, class_weights("vg"),
                                  device="cpu")
    state = engine.init_train_state(model, opt)
    batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v
             for k, v in _batches(1)[0].items()}
    for _ in range(2):
        state, _ = step(state, batch)
    assert model.training
    got = engines.to_numpy(estep(batch))
    fresh = make_torch_classifier(tc, device="cpu",
                                  state_dict=model.state_dict())
    want = engines.to_numpy(engine.make_eval_step(fresh, tc,
                                                  device="cpu")(batch))
    for k in ("relation", "super_relation", "connectivity"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and the two train steps did drop: the same step without dropout
    # moves the weights elsewhere
    _, tc0 = _cfgs(clip=1.0, dtype="float32", dropout=0.0)
    model0 = _torch_model(tc0, flax_params, torch.float32)
    opt0 = engine.make_optimizer(1e-3, grad_clip_norm=1.0)
    state0 = engine.init_train_state(model0, opt0)
    step0 = engine.make_train_step(model0, tc0, opt0, class_weights("vg"),
                                   device="cpu")
    for _ in range(2):
        state0, _ = step0(state0, batch)
    assert not torch.equal(model0.fc1.weight, model.fc1.weight)


def test_torch_dropout_streams_are_seeded_per_step():
    g1 = engine.dropout_generators(0, 5, "cpu")
    g2 = engine.dropout_generators(0, 5, "cpu")
    g3 = engine.dropout_generators(0, 6, "cpu")
    draws = [[torch.rand(4, generator=g).tolist() for g in gs]
             for gs in (g1, g2, g3)]
    assert draws[0] == draws[1] and draws[0] != draws[2]
    assert len({tuple(d) for d in draws[0]}) == 4    # independent streams


def _tiny_fit_cfg(tmp_path, **training):
    return torch_config.derive(
        "vg", model={"feature_size": 16, "hidden_dim": 8,
                     "num_img_feature": 16, "compute_dtype": "float32"},
        data={"max_objects": 6},
        training={"batch_size": 2, "num_epoch": 1, "print_freq": 1,
                  "eval_freq": 2, "grad_clip_norm": 1.0,
                  "checkpoint_path": str(tmp_path / "ck"),
                  "result_path": str(tmp_path / "res"), **training})


def test_torch_fit_writes_lines_and_checkpoint(tmp_path):
    cfg = _tiny_fit_cfg(tmp_path)
    model = make_torch_classifier(cfg, device="cpu")
    before = model.fc1.weight.detach().clone()
    lines = []
    state = loop.fit(
        cfg, model,
        lambda e: synthetic_batches(cfg, 3, seed=e, with_aug=True),
        lambda e: synthetic_batches(cfg, 2, seed=100 + e),
        steps_per_epoch=3, artifacts=load_vg_artifacts(ARTIFACTS_DIR),
        device="cpu", log_fn=lines.append)
    assert state.step == 3 and state.opt_state.count == 3
    train = [ln for ln in lines if ln.startswith("TRAIN")]
    assert len(train) == 3 and "loss: loss=" in train[0]
    assert "R@k" in train[0] and "R@k" not in train[1]   # eval_freq 2
    assert sum(ln.startswith("TEST, epoch 0, R@k") for ln in lines) == 1
    path = loop.checkpoint_file(cfg, 0)
    assert path.endswith("HierRelationModel_Baseline_motif0.pt")
    saved = torch.load(path, weights_only=True)
    assert torch.equal(saved["fc1.weight"], model.fc1.weight)
    assert not torch.equal(before, model.fc1.weight)
    records = json.loads((tmp_path / "res" / "train_results.json")
                         .read_text())
    assert len(records) == 3 and records[0]["lr"] == 1e-5

    # resume at epoch 1: the epoch-0 weights load, the schedule count is
    # seeded past the first scheduler boundary (epoch 1 of (1, 5))
    cfg2 = _tiny_fit_cfg(tmp_path, num_epoch=2, start_epoch=1,
                         continue_train=True, scheduler_epochs=(1, 5))
    model2 = make_torch_classifier(cfg2, device="cpu")
    lines2 = []
    state2 = loop.fit(
        cfg2, model2,
        lambda e: synthetic_batches(cfg2, 2, seed=e, with_aug=True),
        None, steps_per_epoch=3, device="cpu", log_fn=lines2.append)
    assert any(ln.startswith("Resumed relation weights") for ln in lines2)
    assert state2.step == 5 and state2.opt_state.count == 5
    assert "lr: 0.0000010" in [ln for ln in lines2
                               if ln.startswith("TRAIN")][0]


def test_torch_fit_train_cs_needs_tables(tmp_path):
    cfg = _tiny_fit_cfg(tmp_path, run_mode="train_cs")
    model = make_torch_classifier(cfg, device="cpu")
    with pytest.raises(ValueError, match="prepare_cs"):
        loop.fit(cfg, model, lambda e: [], device="cpu")


@pytest.mark.parametrize("knob", [{"tensorboard": True},
                                  {"profile_dir": "p",
                                   "profile_start_step": 2}])
def test_torch_unported_observability_raises(tmp_path, knob):
    """Both knobs are ported: fit no longer raises on either, and each
    writes its output (training.tensorboard the scalars under
    tensorboard_dir; profile_dir with profile_start_step a Chrome trace of
    steps [2, 2 + profile_num_steps) under profile_dir); with the knobs
    off neither directory appears."""
    knob = dict(knob)
    if "profile_dir" in knob:
        knob["profile_dir"] = str(tmp_path / knob["profile_dir"])
        out = knob["profile_dir"]
    else:
        out = str(tmp_path / "tb")
    for on in (False, True):
        cfg = _tiny_fit_cfg(tmp_path, tensorboard_dir=str(tmp_path / "tb"),
                            **(knob if on else {}))
        loop.fit(cfg, make_torch_classifier(cfg, device="cpu"),
                 lambda e: synthetic_batches(cfg, 3, seed=e, with_aug=True),
                 None, steps_per_epoch=3, device="cpu",
                 log_fn=lambda *a: None)
        assert os.path.isdir(out) == on
    written = os.listdir(out)
    if "profile_dir" in knob:
        assert written == ["trace_2_7.json"]       # closed at the end
        with open(os.path.join(out, written[0])) as f:
            assert json.load(f)["traceEvents"]
    else:
        assert written and os.path.getsize(os.path.join(out, written[0]))


def test_torch_mesh_unported_entry_points_raise():
    """Every data-parallel entry point takes a mesh
    (tests/test_torch_mesh*.py) and tensor parallelism is ported
    (tests/test_torch_*tp.py): make_mesh takes model=2, and what is left to
    raise is a call without a process group, or a mesh that does not fill
    the world."""
    with pytest.raises(RuntimeError, match="initialised process group"):
        mesh_lib.make_mesh(data=1, model=2, device="cpu")


def test_torch_prefetch_iterator_order_and_errors():
    dev = torch.device("cpu")
    batches = [{"x": np.full(3, i), "name": str(i)} for i in range(5)]
    got = list(prefetch_iterator(batches, 2, lambda b: to_device(b, dev)))
    assert [int(b["x"][0]) for b in got] == list(range(5))
    assert isinstance(got[0]["x"], torch.Tensor) and got[0]["name"] == "0"

    def broken():
        yield batches[0]
        raise RuntimeError("source failed")

    it = prefetch_iterator(broken(), 2)
    assert next(it) is batches[0]
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)


def _cli(tmp_path, *args):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        "model: {feature_size: 16, hidden_dim: 8, num_img_feature: 16,\n"
        "        compute_dtype: float32}\n"
        "data: {max_objects: 6}\n"
        "training: {batch_size: 2, num_epoch: 1, print_freq: 1,\n"
        "           grad_clip_norm: 1.0, test_epoch: 0,\n"
        f"           checkpoint_path: {tmp_path / 'ck'},\n"
        f"           result_path: {tmp_path / 'res'}}}\n")
    return subprocess.run(
        [sys.executable, "-m", "scene_graph_commonsense_torch",
         "--config", str(cfg), "--eval_mode", "pc", "--hierar",
         "--synthetic", "2", "--device", "cpu", *args], cwd=os.getcwd(),
        capture_output=True, text=True, timeout=300)


def test_torch_cli_train_then_eval(tmp_path):
    res = _cli(tmp_path, "--run_mode", "train")
    assert res.returncode == 0, res.stderr
    out = res.stdout.splitlines()
    assert sum(ln.startswith("TRAIN, epoch 0, batch") for ln in out) == 2
    assert any(ln.startswith("TEST, epoch 0, R@k") for ln in out)
    ckpt = tmp_path / "ck" / "HierRelationModel_Baseline_motif0.pt"
    assert ckpt.exists()
    res = _cli(tmp_path, "--run_mode", "eval")
    assert res.returncode == 0, res.stderr
    assert f"Loaded relation checkpoint {ckpt}" in res.stdout
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(result["recall"]) == 3


def test_torch_cli_train_cs_without_tables_exits(tmp_path):
    empty = tmp_path / "no_artifacts"
    empty.mkdir()
    yaml = tmp_path / "extra.yaml"
    res = _cli(tmp_path, "--run_mode", "train_cs")
    assert res.returncode == 0, res.stderr        # the repo's tables exist
    yaml.write_text(f"data: {{artifacts_dir: {empty}, max_objects: 6}}\n"
                    "model: {feature_size: 16, hidden_dim: 8,\n"
                    "        num_img_feature: 16}\n")
    res = subprocess.run(
        [sys.executable, "-m", "scene_graph_commonsense_torch", "--config",
         str(yaml), "--run_mode", "train_cs", "--eval_mode", "pc",
         "--synthetic", "2", "--batch_size", "2", "--device", "cpu"],
        cwd=os.getcwd(), capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "train_cs requires converted commonsense triplet tables" \
        in res.stderr


def test_torch_bench_counts_flops_and_needs_a_card(monkeypatch):
    """bench.py's configuration: conv3 and fc1 over 1024 + 256 pair slots
    and conv2 over 240 objects per view make the analytic count; the bench
    refuses to run on the CPU."""
    cfg = bench.bench_config()
    assert cfg.pair_capacity == 1024
    assert engine.aug_pair_capacity(cfg) == 256
    per_slot = 16 * 16 * 9 * 512 * 1024 * 2 + 65536 * 4096 * 2
    flops = bench.train_step_flops(cfg)
    conv2 = 2 * 240 * 32 * 32 * 9 * 128 * 512 * 2
    assert 3 * (1280 * per_slot + 2 * conv2) < flops
    assert flops == pytest.approx(14.8438e12, rel=1e-4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run(steps=1, warmup=0)
