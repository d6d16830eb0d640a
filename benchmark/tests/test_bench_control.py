"""`correct` at a tiny size on the CPU: the bfloat16 program passes each
cell's limits; the lower-precision control fails them, and so does a run
whose timed path is broken underneath (a step that leaves its state
unchanged, half of the batch left out, an answer altered where it is
produced, a bottleneck of the featurizer's trunk skipped)."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests import tiny

TRAIN = ["vg-hiercom.train"]
SERVE = ["vg-hiercom.serve-max"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_program_passes(cell):
    numbers = tiny.run(cell)["numbers"]
    assert harness.judge(numbers, harness.limits(cell)), numbers


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_control_fails(cell):
    conf, traffic = tiny.cell(cell)
    read = control.readings(conf, traffic, 2 ** 31 + 5, torch.device("cpu"))
    assert not harness.judge(read["control"], harness.limits(cell)), read


def _wrap_train_step(monkeypatch, fault):
    from scene_graph_commonsense_torch.train import engine
    real = engine.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def broken(state, batch):
            return fault(step, state, batch)
        return broken
    monkeypatch.setattr(engine, "make_train_step", make)


def _unchanged(step, state, batch):
    keep = {k: v.detach().clone() for k, v in state.params.items()}
    _, metrics = step(state, batch)
    with torch.no_grad():
        for k, v in keep.items():
            state.params[k].copy_(v)
    return state, metrics


def _half(step, state, batch):
    b = len(batch["valid"]) // 2
    return step(state, {k: v[:b] for k, v in batch.items()})


@pytest.mark.parametrize("fault", [_unchanged, _half],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", TRAIN)
def test_train_faults_fail(monkeypatch, cell, fault):
    _wrap_train_step(monkeypatch, fault)
    numbers = tiny.run(cell)["numbers"]
    assert not harness.judge(numbers, harness.limits(cell)), numbers


@pytest.mark.parametrize("cell", SERVE)
def test_altered_answer_fails(monkeypatch, cell):
    from scene_graph_commonsense_torch.train import engine
    real = engine.make_eval_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def altered(batch):
            out = dict(step(batch))
            out["relation"] = out["relation"].flip(1)
            return out
        return altered
    monkeypatch.setattr(engine, "make_eval_step", make)
    numbers = tiny.run(cell)["numbers"]
    assert not harness.judge(numbers, harness.limits(cell)), numbers


@pytest.mark.parametrize("cell", SERVE)
def test_skipped_bottleneck_fails(monkeypatch, cell):
    from scene_graph_commonsense_torch.models import detr
    real = detr.make_detr

    def make(*args, **kwargs):
        model = real(*args, **kwargs)
        model.backbone.layer2_1.forward = lambda x, dtype: x
        return model
    monkeypatch.setattr(detr, "make_detr", make)
    numbers = tiny.run(cell)["numbers"]
    assert numbers["trunk"] > harness.limits(cell)["trunk"], numbers
    assert not harness.judge(numbers, harness.limits(cell)), numbers
