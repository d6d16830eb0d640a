"""The port's observability (utils/profiling.py ScalarWriter, StepTimer,
StepProfiler, and the writer calls of train/loop.fit) on the CPU, held
against the JAX package's: the same scalar tags at the same steps from
fit at the same config, the same JSONL fallback, and a torch.profiler
window over the steps the JAX StepProfiler would trace, holding the port's
spans (utils/profiling.RECORDER) in fit's trace."""

import json
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

from test_torch_tiny import batches, cfgs, flax_params, torch_model

from scene_graph_commonsense_tpu.data.artifacts import (
    load_vg_artifacts as jax_load_artifacts)
from scene_graph_commonsense_tpu.models.relation_head import (
    make_relation_classifier)
from scene_graph_commonsense_tpu.train import loop as jax_loop
from scene_graph_commonsense_tpu.utils import profiling as jax_profiling
from scene_graph_commonsense_torch.data.artifacts import load_vg_artifacts
from scene_graph_commonsense_torch.train import loop
from scene_graph_commonsense_torch.utils.profiling import (
    RECORDER, ScalarWriter, StepProfiler, StepTimer)

ARTIFACTS_DIR = "datasets/artifacts"
TEST_TAGS = {f"test/{m}@{k}" for m in ("R", "mR") for k in (20, 50, 100)}


def _jsonl(logdir):
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture
def no_tensorboard(monkeypatch):
    """torch.utils.tensorboard made unimportable: the JSONL fallback."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_torch_scalar_writer_disabled_is_noop(tmp_path):
    for logdir, enabled in ((str(tmp_path / "tb"), False), ("", True)):
        w = ScalarWriter(logdir, enabled=enabled)
        w.scalar("x", 1.0, 0)
        w.scalars({"y": 2.0}, 1)
        w.close()
    assert not os.path.exists(tmp_path / "tb")


def test_torch_scalar_writer_tensorboard_events(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    logdir = str(tmp_path / "tb")
    w = ScalarWriter(logdir)
    w.scalars({"loss_relationship": 1.5, "loss_connectivity": 0.25}, 3,
              prefix="train/")
    w.scalar("test/R@20", np.float32(0.125), 0)
    w.close()
    assert not os.path.exists(os.path.join(logdir, "scalars.jsonl"))
    acc = EventAccumulator(logdir)
    acc.Reload()
    assert set(acc.Tags()["scalars"]) == {
        "train/loss_relationship", "train/loss_connectivity", "test/R@20"}
    (ev,) = acc.Scalars("train/loss_relationship")
    assert (ev.step, ev.value) == (3, 1.5)
    assert acc.Scalars("test/R@20")[0].value == 0.125


def test_torch_scalar_writer_jsonl_matches_jax(tmp_path, no_tensorboard):
    """Without tensorboard both packages write the same scalars.jsonl."""
    for name, cls in (("torch", ScalarWriter),
                      ("jax", jax_profiling.ScalarWriter)):
        w = cls(str(tmp_path / name))
        w.scalars({"loss": 2.5, "lr": 1e-5}, 7, prefix="train/")
        w.scalar("test/mR@50", 0.75, 1)
        w.close()
    got, want = _jsonl(tmp_path / "torch"), _jsonl(tmp_path / "jax")
    assert got == want and len(got) == 3
    assert got[0] == {"tag": "train/loss", "value": 2.5, "step": 7}


def test_torch_step_timer_matches_jax():
    for cls in (StepTimer, jax_profiling.StepTimer):
        t = cls(warmup=1)
        assert t.tick() is None and t.summary() == {}
        for _ in range(4):
            time.sleep(0.01)
            assert t.tick() >= 0.009
        s = t.summary(items_per_step=4)
        assert s["step_ms_mean"] >= 9.0 and s["step_ms_p90"] >= 9.0
        assert np.isclose(s["throughput"], 4 / (s["step_ms_mean"] / 1e3),
                          rtol=1e-6)


def _traced_ranges(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("name", "").startswith(
        "step_")}


def test_torch_step_profiler_window(tmp_path):
    """A window [1, 3) traces steps 1 and 2 and writes one Chrome trace
    when step 3 begins; close() ends an open window; disabled without a
    directory or with start < 0."""
    logdir = str(tmp_path / "trace")
    p = StepProfiler(logdir, start=1, num=2)
    for i in range(5):
        p.step(i)
        with torch.profiler.record_function(f"step_{i}"):
            torch.ones(8).add_(1)
        if i == 2:
            assert not os.listdir(logdir)        # still open
    assert p.trace_path == os.path.join(logdir, "trace_1_3.json")
    assert os.listdir(logdir) == ["trace_1_3.json"]
    assert _traced_ranges(p.trace_path) == {"step_1", "step_2"}
    p.close()                                    # already closed: no-op

    q = StepProfiler(str(tmp_path / "open"), start=0, num=10)
    for i in range(2):
        q.step(i)
        with torch.profiler.record_function(f"step_{i}"):
            torch.ones(8).add_(1)
    q.close()
    assert _traced_ranges(q.trace_path) == {"step_0", "step_1"}
    for off in (StepProfiler("", start=0, num=2),
                StepProfiler(str(tmp_path / "off"), start=-1)):
        for i in range(3):
            off.step(i)
        off.close()
        assert off.trace_path is None
    assert not os.path.exists(tmp_path / "off")


def test_torch_fit_trace_holds_the_spans(tmp_path):
    """training.profile_dir: fit's trace of steps [1, 3) holds the train
    step's spans beside torch's ops; the recorder is on only for the
    window and keeps nothing after it."""
    _, tc = cfgs(dtype="float32", training={
        "num_epoch": 1, "print_freq": 100, "eval_freq": 0,
        "grad_clip_norm": 1.0, "profile_dir": str(tmp_path / "trace"),
        "profile_start_step": 1, "profile_num_steps": 2,
        "checkpoint_path": str(tmp_path / "ck") + "/",
        "result_path": str(tmp_path / "res")})
    train = batches(4, seed=33, float64=False)
    loop.fit(tc, torch_model(tc, flax_params(dtype=np.float32),
                             torch.float32),
             lambda e: iter(train), None, steps_per_epoch=4,
             artifacts=load_vg_artifacts(ARTIFACTS_DIR), device="cpu",
             log_fn=lambda *a: None)
    (name,) = os.listdir(tmp_path / "trace")
    assert name == "trace_1_3.json"
    with open(tmp_path / "trace" / name) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    count = {n: sum(e["name"] == n for e in events)
             for n in ("train.update", "train.losses", "train.backward",
                       "train.optimizer", "feed.wait")}
    assert count["train.update"] == count["train.optimizer"] == 2
    assert count["train.losses"] == count["train.backward"] == 2
    assert count["feed.wait"] >= 1
    assert not RECORDER.on and RECORDER.collect() == []


def test_torch_fit_writes_the_jax_tag_set(tmp_path, no_tensorboard):
    """fit of both packages on the same config, weights and 4 batches
    (print_freq 1: StepTimer's perf/ scalars start at the 4th step) with
    training.tensorboard on: the same (tag, step) pairs, train/ and perf/
    every step, test/R@k and test/mR@k once."""
    n_steps = 4
    records = {}
    for pkg in ("jax", "torch"):
        jc, tc = cfgs(dtype="float32", training={
            "num_epoch": 1, "print_freq": 1, "eval_freq": 0,
            "grad_clip_norm": 1.0, "tensorboard": True,
            "tensorboard_dir": str(tmp_path / pkg / "tb"),
            "checkpoint_path": str(tmp_path / pkg / "ck") + "/",
            "result_path": str(tmp_path / pkg / "res")})
        train = batches(n_steps, seed=31, float64=False)
        test = batches(1, seed=32, with_aug=False, float64=False)
        params = flax_params(dtype=np.float32)
        if pkg == "jax":
            jax_loop.fit(jc, make_relation_classifier(jc),
                         jax.tree.map(np.asarray, params),
                         lambda e: iter(train), lambda e: iter(test),
                         steps_per_epoch=n_steps,
                         artifacts=jax_load_artifacts(ARTIFACTS_DIR),
                         log_fn=lambda *a: None)
        else:
            loop.fit(tc, torch_model(tc, params, torch.float32),
                     lambda e: iter(train), lambda e: iter(test),
                     steps_per_epoch=n_steps,
                     artifacts=load_vg_artifacts(ARTIFACTS_DIR),
                     device="cpu", log_fn=lambda *a: None)
        records[pkg] = _jsonl(tmp_path / pkg / "tb")
    got = sorted((r["tag"], r["step"]) for r in records["torch"])
    assert got == sorted((r["tag"], r["step"]) for r in records["jax"])
    tags = {t for t, _ in got}
    assert TEST_TAGS <= tags and {"train/loss", "train/lr",
                                  "train/loss_commonsense",
                                  "perf/step_ms_mean"} <= tags
    assert sorted(s for t, s in got if t == "train/lr") \
        == list(range(1, n_steps + 1))
    assert [s for t, s in got if t == "perf/throughput"] == [n_steps]
    assert all(np.isfinite(r["value"]) for r in records["torch"]
               if not r["tag"].startswith("test/mR"))
