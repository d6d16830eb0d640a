"""trace._idle_gaps on hand-made host events that hold the program's own
spans (scene_graph_commonsense_torch.utils.profiling opens a
record_function range per span while its recorder is on): a gap that
begins where no op is open is put down to the innermost program span, one
that begins inside an op to that op, each under the driver's outermost
range."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import trace
from benchmark.tests import tiny


def _event(name, start, end):
    return SimpleNamespace(name=name,
                           time_range=SimpleNamespace(start=start, end=end))


def test_idle_gaps_name_the_program_span_open_at_a_gap():
    host = [_event("train.step", 0.0, 200.0),          # the driver's range
            _event("train.update", 1.0, 199.0),        # the program's spans
            _event("train.losses", 2.0, 60.0),
            _event("train.optimizer", 100.0, 198.0),
            _event("aten::add_", 120.0, 130.0),
            _event("cudaLaunchKernel", 125.0, 126.0)]
    device = np.asarray([[0.0, 40.0],     # gap 40-50: train.losses open
                         [50.0, 110.0],   # gap 110-122: train.optimizer
                         [122.0, 125.5],  # gap 125.5-150: the launch
                         [150.0, 190.0]])
    gaps = dict(trace._idle_gaps(device, host))
    assert gaps == {
        "train.step/train.losses": pytest.approx(10e-6),
        "train.step/train.optimizer": pytest.approx(12e-6),
        "train.step/cudaLaunchKernel": pytest.approx(24.5e-6)}


@pytest.mark.parametrize("cell", ["vg-hiercom.train",
                                  "vg-hiercom.serve-max"])
def test_program_spans_are_ranges_not_device_work(cell):
    """Every span the port opens on a cell's timed path carries a prefix
    that trace.py keeps out of the device's operations; only set-up's
    spans do not, and no profiled unit opens them."""
    from scene_graph_commonsense_torch.utils import profiling
    profiling.reset()
    profiling.enable()
    try:
        tiny.run(cell, seconds=0.3)
    finally:
        profiling.disable()
    names = {s.name for s in profiling.collect()}
    profiling.reset()
    timed = {n for n in names if not n.startswith("setup.")}
    assert "setup.model" in names
    assert {"train.update", "feed.wait"} <= timed if "train" in cell \
        else {"serve.request", "serve.features"} <= timed
    assert all(n.startswith(trace.RANGES) for n in timed)
