"""Step timing (a copy of StepTimer from
scene_graph_commonsense_tpu/utils/profiling.py).

ScalarWriter (TensorBoard scalars) and StepProfiler (a profiler trace
window) are not yet ported: both are off by default, and turning either on
in the config raises here rather than being ignored.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np


class StepTimer:
    """Per-step wall-clock ring buffer.

    ``tick()`` marks a step boundary and returns the seconds since the
    previous one (None on the first call).  ``summary(items_per_step)``
    reports mean / p50 / p90 latency and throughput over the retained
    window, skipping the first ``warmup`` steps."""

    def __init__(self, window: int = 512, warmup: int = 2):
        self.window = window
        self.warmup = warmup
        self._times = []
        self._seen = 0
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._seen += 1
            if self._seen > self.warmup:
                self._times.append(dt)
                if len(self._times) > self.window:
                    self._times.pop(0)
        self._last = now
        return dt

    def summary(self, items_per_step: float = 1.0) -> Dict[str, float]:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {
            "step_ms_mean": float(t.mean() * 1e3),
            "step_ms_p50": float(np.percentile(t, 50) * 1e3),
            "step_ms_p90": float(np.percentile(t, 90) * 1e3),
            "throughput": float(items_per_step / t.mean()),
        }


def check_observability(train_cfg) -> None:
    """Raises when the config turns on TensorBoard scalars or a profiler
    window, which the port does not have yet."""
    if train_cfg.tensorboard:
        raise NotImplementedError(
            "training.tensorboard (ScalarWriter) is not yet ported to "
            "PyTorch")
    if train_cfg.profile_dir and train_cfg.profile_start_step >= 0:
        raise NotImplementedError(
            "training.profile_dir / profile_start_step (StepProfiler) is "
            "not yet ported to PyTorch")
