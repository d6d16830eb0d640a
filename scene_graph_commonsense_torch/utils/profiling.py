"""Observability of the training loop (torch port of
scene_graph_commonsense_tpu/utils/profiling.py):

  * ScalarWriter: TensorBoard scalars (the reference's tag set,
    train_test.py:279-285, 446-450), with a JSONL fallback when TensorBoard
    cannot be imported;
  * StepTimer: per-step wall-clock ring buffer -> latency percentiles and
    img/s;
  * StepProfiler: a torch.profiler window over a configurable step range,
    written as a Chrome trace.

All three cost nothing when disabled.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class ScalarWriter:
    """TensorBoard scalar writer with a JSONL fallback.

    Mirrors the reference's SummaryWriter usage (train_test.py:279-285):
    one add_scalar per loss term per print_freq step and test R@k per
    epoch.  When the tensorboard package is unavailable the same scalars
    land in ``<logdir>/scalars.jsonl`` (one JSON object per line).
    """

    def __init__(self, logdir: Optional[str], enabled: bool = True):
        self._tb = None
        self._jsonl = None
        if not enabled or not logdir:
            return
        os.makedirs(logdir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=logdir)
        except Exception:
            self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def scalar(self, tag: str, value, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        elif self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step)})
                + "\n")
            self._jsonl.flush()

    def scalars(self, values: Dict[str, float], step: int,
                prefix: str = ""):
        for k, v in values.items():
            self.scalar(prefix + k, v, step)

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()


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


class StepProfiler:
    """torch.profiler over steps [start, start + num): CPU activity, and
    the card's kernels when `device` is CUDA.  The window is exported as a
    Chrome trace, ``<logdir>/trace_<start>_<stop>.json`` (chrome://tracing,
    Perfetto).  Disabled when logdir is empty or start < 0."""

    def __init__(self, logdir: str = "", start: int = -1, num: int = 5,
                 device=None):
        self.logdir = logdir
        self.start = start if logdir else -1
        self.stop = start + num
        self.device = device
        self.trace_path = None
        self._prof = None

    def step(self, step_idx: int):
        """Call once per train step, before it, with the global step
        index."""
        if self.start < 0:
            return
        if step_idx == self.start and self._prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.device(self.device or "cpu").type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self.logdir, exist_ok=True)
            self._prof = profile(activities=activities)
            self._prof.start()
        elif step_idx >= self.stop and self._prof is not None:
            self.close()

    def close(self):
        """Stops an open window and writes its trace."""
        if self._prof is None:
            return
        import torch
        if torch.device(self.device or "cpu").type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        self.trace_path = os.path.join(
            self.logdir, f"trace_{self.start}_{self.stop}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
