"""The port's span recorder (utils/profiling.Recorder, RECORDER) on the CPU:
off it is a shared no-op that opens no profiler range and leaves torch's
sync debug mode alone; on it nests spans per thread with parent and root
ids, self time and counters summed per root; the train step, predict,
the featurizer, the prefetch feed and set-up open their spans inside a
torch.profiler trace; and the recorder changes no result."""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

from scene_graph_commonsense_torch import config as torch_config
from scene_graph_commonsense_torch.constants import class_weights
from scene_graph_commonsense_torch.data.pipeline import prefetch_iterator
from scene_graph_commonsense_torch.data.synthetic import synthetic_batch
from scene_graph_commonsense_torch.inference import SceneGraphPredictor
from scene_graph_commonsense_torch.models.relation_head import (
    make_relation_classifier)
from scene_graph_commonsense_torch.ops import _build
from scene_graph_commonsense_torch.train import engine
from scene_graph_commonsense_torch.train.loop import make_detr_featurize_fn
from scene_graph_commonsense_torch.utils import profiling
from scene_graph_commonsense_torch.utils.profiling import (
    RECORDER, SYNC_WARNING, Recorder, per_root)

TRAIN_TREE = {"train.update", "train.losses", "train.backward",
              "train.optimizer"}
SERVE_TREE = {"serve.request", "serve.eval_step", "serve.to_host",
              "serve.candidates", "serve.edges"}


@pytest.fixture
def recorder():
    """RECORDER on for the test, off and emptied after it."""
    RECORDER.reset()
    RECORDER.enable()
    yield RECORDER
    RECORDER.disable()
    RECORDER.collect()
    RECORDER.reset()


@pytest.fixture
def fake_sync_mode(monkeypatch):
    """torch.cuda's sync debug mode as a plain value, and CUDA reported
    available, so that the recorder's handling of the mode runs here."""
    mode = {"value": 0, "sets": []}

    def set_mode(m):
        mode["sets"].append(m)
        mode["value"] = {"default": 0, "warn": 1, "error": 2}.get(m, m)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["value"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    return mode


@pytest.fixture
def one_thread():
    """One CPU thread, so that two runs of one computation split their
    reductions alike."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(batch_size=2):
    return torch_config.derive(
        "vg", model={"feature_size": 8, "hidden_dim": 8, "num_img_feature": 8,
                     "compute_dtype": "float32", "dropout_rate": 0.0},
        data={"max_objects": 5},
        training={"batch_size": batch_size, "learning_rate": 1e-3,
                  "grad_clip_norm": 1.0})


def _batch(cfg, seed, with_aug=True):
    return synthetic_batch(
        np.random.default_rng(seed), batch_size=cfg.training.batch_size,
        max_objects=cfg.data.max_objects, feature_size=cfg.model.feature_size,
        num_channels=cfg.model.num_img_feature,
        num_classes=cfg.model.num_classes, mean_objects=3.0,
        with_aug=with_aug)


def _model(cfg):
    return make_relation_classifier(
        cfg, device="cpu", generator=torch.Generator().manual_seed(5))


def _train_step(cfg, model):
    opt = engine.make_optimizer(1e-3, grad_clip_norm=1.0)
    step = engine.make_train_step(
        model, cfg, opt, class_weights("vg", cfg.data.supcat_clustering),
        device="cpu")
    return step, engine.init_train_state(model, opt)


def _profiled_names(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def test_torch_recorder_off_is_a_noop(fake_sync_mode):
    assert not RECORDER.on
    a, b = profiling.span("x"), profiling.span("y", device=True)
    assert a is b
    with a as inner:
        assert inner is a
    profiling.count("c", 3)

    @profiling.traced("z")
    def f(v):
        return v + 1

    def work():
        with profiling.span("off.range"):
            assert f(1) == 2
    names = _profiled_names(work)
    assert "off.range" not in names and "z" not in names
    assert RECORDER.collect() == [] and RECORDER.loose == {}
    assert fake_sync_mode["sets"] == [] and fake_sync_mode["value"] == 0


def test_torch_recorder_sync_mode_and_host_syncs(fake_sync_mode):
    """On: torch's sync debug mode "warn" and each sync warning counted as
    host_syncs (its site kept), other warnings passed on to showwarning;
    off again: the mode, showwarning and the filters as they were."""
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda msg, *a, **k: seen.append(str(msg))
        shown, filters = warnings.showwarning, list(warnings.filters)
        rec = Recorder()
        rec.enable()
        try:
            assert fake_sync_mode["value"] == 1
            with rec.span("outer"):
                for _ in range(3):
                    warnings.warn(SYNC_WARNING + " (Triggered internally)",
                                  UserWarning)
            with rec.span("outer"):
                warnings.warn("other", RuntimeWarning)
        finally:
            rec.disable()
        assert warnings.showwarning is shown and warnings.filters == filters
    assert seen == ["other"]
    assert fake_sync_mode["value"] == 0 and fake_sync_mode["sets"][-1] == 0
    spans = rec.collect()
    assert [r["counts"] for r in per_root(spans, "outer")] \
        == [{"host_syncs": 3}, {}]
    assert sum(rec.sync_sites.values()) == 3
    assert all("test_torch_tracing.py" in k for k in rec.sync_sites)
    rec.reset()
    assert rec.sync_sites == {} and rec.collect() == []


def test_torch_recorder_nesting_roots_self_time_counts(recorder):
    @profiling.traced("leaf")
    def leaf():
        profiling.count("work", 2)
        time.sleep(0.004)

    for _ in range(2):
        with profiling.span("root"):
            with profiling.span("mid"):
                leaf()
                leaf()
                profiling.count("work")
            profiling.count("other", 5)
    profiling.count("loose")
    spans = recorder.collect()
    assert recorder.collect() == []          # collect drains
    assert recorder.loose == {"loose": 1}
    assert [s.name for s in spans] == ["leaf", "leaf", "mid", "root"] * 2
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert by_id[s.root].name == "root"
        assert s.device_ms is None           # no card: host spans only
        if s.name == "root":
            assert s.parent is None and s.root == s.id
        else:
            assert by_id[s.parent].name == {"leaf": "mid",
                                            "mid": "root"}[s.name]
        assert s.end_ns >= s.start_ns and 0 <= s.self_ns
    mid = next(s for s in spans if s.name == "mid")
    leaves = [s for s in spans if s.parent == mid.id]
    assert mid.self_ns == (mid.end_ns - mid.start_ns) - sum(
        s.end_ns - s.start_ns for s in leaves)
    assert mid.self_ns < 0.5 * (mid.end_ns - mid.start_ns)
    sums = per_root(spans, "root")
    assert [r["counts"] for r in sums] == [{"work": 5, "other": 5}] * 2
    for r in sums:
        assert r["host_ms"]["leaf"] >= 8.0
        assert r["host_ms"]["root"] >= r["host_ms"]["mid"] \
            >= r["host_ms"]["leaf"]
        assert r["self_ms"]["leaf"] == pytest.approx(r["host_ms"]["leaf"])
    assert per_root(spans, "mid") == []      # not a root


def test_torch_recorder_threads_and_the_prefetch_feed(recorder):
    """The producer thread's transform spans are roots of their own, the
    consumer's waits are in its thread, and a span on another thread does
    not nest under this one's."""
    def transform(b):
        profiling.count("made")
        return b * 2

    with profiling.span("consumer"):
        got = list(prefetch_iterator(iter(range(5)), 2, transform))
        th = threading.Thread(target=lambda: profiling.span("other")
                              .__enter__().__exit__(None, None, None))
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
    assert got == [0, 2, 4, 6, 8]
    spans = recorder.collect()
    me = threading.get_ident()
    produce = [s for s in spans if s.name == "feed.produce"]
    waits = [s for s in spans if s.name == "feed.wait"]
    consumer = next(s for s in spans if s.name == "consumer")
    other = next(s for s in spans if s.name == "other")
    assert len(produce) == 5 and len(waits) == 6   # 5 batches, then done
    assert all(s.thread != me and s.root == s.id for s in produce)
    assert [r["counts"] for r in per_root(spans, "feed.produce")] \
        == [{"made": 1}] * 5
    assert all(s.thread == me and s.parent == consumer.id for s in waits)
    assert other.thread != me and other.root == other.id


def test_torch_train_step_span_tree_in_a_profiler_trace(recorder):
    cfg = _cfg()
    model = _model(cfg)
    step, state = _train_step(cfg, model)
    batch = _batch(cfg, 1)
    names = _profiled_names(lambda: step(state, batch))
    assert TRAIN_TREE <= names
    spans = recorder.collect()
    (tree,) = per_root(spans, "train.update")
    assert set(tree["host_ms"]) == TRAIN_TREE
    assert tree["device_ms"] == {}           # device spans need a card
    assert per_root(spans, "setup.model") != []  # make_relation_classifier


def test_torch_predict_span_tree_and_pair_counters(recorder):
    cfg = _cfg(batch_size=3)
    predictor = SceneGraphPredictor(cfg, _model(cfg), device="cpu")
    batch = _batch(cfg, 2, with_aug=False)
    out = predictor.estep(batch)
    recorder.collect()
    names = _profiled_names(lambda: predictor.predict(batch, top_k=5))
    assert SERVE_TREE <= names
    (tree,) = per_root(recorder.collect(), "serve.request")
    assert set(tree["host_ms"]) == SERVE_TREE
    assert tree["counts"] == {
        "live_pairs": int(out["pair_count"].sum()),
        "pair_slots": int(out["pair_capacity"].sum())}
    assert 0 < tree["counts"]["live_pairs"] <= tree["counts"]["pair_slots"]


def test_torch_featurize_spans(recorder):
    """make_detr_featurize_fn: serve.features around the image copy and the
    encode, both views in one of each."""
    class Encoder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))

        def encode_features(self, x):
            return x[:, ::4, ::4, :2] * self.w

    featurize = make_detr_featurize_fn(None, Encoder())
    img = np.ones((2, 8, 8, 3), np.float32)
    out = featurize({"image": img, "image_aug": img * 2})
    assert out["features"].shape == (2, 2, 2, 2)
    spans = recorder.collect()
    (tree,) = per_root(spans, "serve.features")
    assert set(tree["host_ms"]) == {"serve.features", "serve.image_copy",
                                    "serve.encode"}
    assert [s.name for s in spans].count("serve.image_copy") == 1


def test_torch_kernel_load_span(recorder, monkeypatch):
    """ops/_build.load: the first load of a library in span setup.kernels,
    none for a loaded one."""
    monkeypatch.setattr(_build, "_start", lambda name: None)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_loaded", {})
    lib = _build.load("pair_pool")
    assert _build.load("pair_pool") is lib
    assert [s.name for s in recorder.collect()] == ["setup.kernels"]


@pytest.mark.parametrize("path", ["train", "predict"])
def test_torch_recorder_changes_no_result(path, one_thread):
    """The train step's new state and metrics, and predict's graphs, equal
    to the bit with the recorder off and on."""
    cfg = _cfg(batch_size=3)
    results = []
    for on in (False, True):
        if on:
            RECORDER.enable()
        try:
            model = _model(cfg)
            if path == "train":
                step, state = _train_step(cfg, model)
                for k in range(2):
                    state, metrics = step(state, _batch(cfg, 10 + k))
                results.append(
                    ({k: v.clone() for k, v in state.params.items()},
                     {k: v.clone() for k, v in state.opt_state.trace.items()},
                     {k: v.clone() for k, v in metrics.items()}))
            else:
                predictor = SceneGraphPredictor(cfg, model, device="cpu")
                results.append(predictor.predict(
                    _batch(cfg, 3, with_aug=False), top_k=7))
        finally:
            RECORDER.disable()
            RECORDER.reset()
    off, on = results
    if path == "train":
        for a, b in zip(off, on):
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), k
    else:
        assert off == on and sum(map(len, off)) > 0
