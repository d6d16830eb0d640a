"""Observability of the training loop (torch port of
scene_graph_commonsense_tpu/utils/profiling.py):

  * ScalarWriter: TensorBoard scalars (the reference's tag set,
    train_test.py:279-285, 446-450), with a JSONL fallback when TensorBoard
    cannot be imported;
  * StepTimer: per-step wall-clock ring buffer -> latency percentiles and
    img/s;
  * StepProfiler: a torch.profiler window over a configurable step range,
    written as a Chrome trace;
  * RECORDER (a Recorder) with span() and count(): the spans and counters
    the port records at its layer boundaries, off unless enable() turns it
    on.

All of them cost nothing when disabled.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

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
    Perfetto), holding the port's spans too: RECORDER is on for the window
    (and what it recorded there dropped at its end) unless it was on
    already.  Disabled when logdir is empty or start < 0."""

    def __init__(self, logdir: str = "", start: int = -1, num: int = 5,
                 device=None):
        self.logdir = logdir
        self.start = start if logdir else -1
        self.stop = start + num
        self.device = device
        self.trace_path = None
        self._prof = None
        self._spans = False

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
            self._spans = not RECORDER.on
            if self._spans:
                RECORDER.enable()
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
        if self._spans:
            RECORDER.disable()
            RECORDER.reset()
            self._spans = False
        self.trace_path = os.path.join(
            self.logdir, f"trace_{self.start}_{self.stop}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

# the start of the warning torch issues, in sync debug mode "warn", at each
# CUDA call that makes the host wait for the device
SYNC_WARNING = "called a synchronizing CUDA operation"


class _Off:
    """The span of a recorder that is off: one shared object that does
    nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


@dataclass
class SpanRecord:
    """A finished span.  Times are host perf_counter_ns readings; `self_ns`
    is the duration less what its children (same thread) cover;
    `device_ms` the time between its CUDA events (device spans on a card,
    else None); `counts` the counters added while it was the innermost
    open span of its thread; `root` the id of the outermost span open
    around it in its thread (its own id for a root)."""
    name: str
    id: int
    parent: Optional[int]
    root: int
    thread: int
    start_ns: int
    end_ns: int
    self_ns: int
    device_ms: Optional[float] = None
    counts: Dict[str, int] = field(default_factory=dict)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class _Span:
    """An open span of a recorder that is on."""
    __slots__ = ("rec", "name", "events", "id", "parent", "root", "t0",
                 "child_ns", "counts", "range")

    def __init__(self, rec: "Recorder", name: str, device: bool):
        self.rec, self.name = rec, name
        self.events = rec._take_events() if device and rec._cuda else None
        self.child_ns = 0
        self.counts: Dict[str, int] = {}

    def __enter__(self):
        stack = self.rec._stack()
        parent = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        self.parent = parent
        self.root = parent.root if parent is not None else self.id
        self.range = self.rec._record_function(self.name)
        self.range.__enter__()
        if self.events is not None:
            self.events[0].record()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self.range.__exit__(*exc)
        stack = self.rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += t1 - self.t0
        rec = SpanRecord(
            self.name, self.id, None if parent is None else parent.id,
            self.root, threading.get_ident(), self.t0, t1,
            t1 - self.t0 - self.child_ns, None, self.counts)
        with self.rec._lock:
            self.rec._done.append((rec, self.events))
        return False


class Recorder:
    """Spans and counters at the port's layer boundaries, kept in memory
    until collect().  Off by default: span() then returns one shared no-op
    context manager and count() returns at once.

    On (enable()), a span records its name, host perf_counter_ns start and
    end, its parent and its root (spans nest per thread: the prefetch
    producer's spans form trees of their own), and opens a
    torch.profiler record_function range of its name, so that a profiler
    trace holds the program's spans on the clock of the card's kernels.  A
    device span (span(name, device=True)) also records a pair of CUDA
    events from a reused pool on the current stream; their elapsed time is
    read only in collect(), after the caller has synchronised.  count()
    adds to the innermost open span of the calling thread.  While on, torch
    runs in sync debug mode "warn" and each CUDA call that synchronises the
    host counts as `host_syncs` (its Python file and line in `sync_sites`);
    disable() restores the previous mode.  Spans pile up until collect() or
    reset(), so whoever turns the recorder on collects it."""

    def __init__(self):
        self.on = False
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._done: list = []
        self._pool: list = []
        self._cuda = False
        self._record_function = None
        self._lock = threading.Lock()
        self.loose: Dict[str, int] = {}
        self.sync_sites: Dict[str, int] = {}
        self._sync_mode = None
        self._showwarning = None
        self._filter = None

    # -- the hot path ------------------------------------------------------

    def span(self, name: str, device: bool = False):
        """A context manager timing the block as span `name`; with
        `device`, also by CUDA events on the current stream."""
        if not self.on:
            return _OFF
        return _Span(self, name, device)

    def traced(self, name: str, device: bool = False):
        """A decorator running each call of the function in span `name`."""
        def wrap(fn):
            @functools.wraps(fn)
            def call(*args, **kwargs):
                with self.span(name, device):
                    return fn(*args, **kwargs)
            return call
        return wrap

    def count(self, name: str, n=1) -> None:
        """Adds n (the sum of its entries, where n is an array) to counter
        `name` of the innermost open span of this thread (to `loose` where
        none is open)."""
        if not self.on:
            return
        n = int(np.sum(n))
        stack = self._stack()
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n
        else:
            with self._lock:
                self.loose[name] = self.loose.get(name, 0) + n

    # -- switching it on and off ------------------------------------------

    def enable(self) -> None:
        """Turns the recorder on (a no-op when it is on), with torch's
        sync debug mode "warn" routed to the host_syncs counter where CUDA
        is available."""
        if self.on:
            return
        import torch
        from torch.autograd.profiler import record_function
        self._record_function = record_function
        self._cuda = torch.cuda.is_available()
        if self._cuda:
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            warnings.filterwarnings("always", message=SYNC_WARNING,
                                    category=UserWarning)
            self._filter = warnings.filters[0]
            self._showwarning = warnings.showwarning
            warnings.showwarning = self._on_warning
            torch.cuda.set_sync_debug_mode("warn")
        self.on = True

    def disable(self) -> None:
        """Turns the recorder off and restores torch's sync debug mode and
        the warnings machinery.  What was recorded stays for collect()."""
        if not self.on:
            return
        self.on = False
        if self._cuda:
            import torch
            torch.cuda.set_sync_debug_mode(self._sync_mode)
            if warnings.showwarning == self._on_warning:
                warnings.showwarning = self._showwarning
            if self._filter in warnings.filters:
                warnings.filters.remove(self._filter)
            self._showwarning = self._filter = None

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None):
        if issubclass(category, UserWarning) \
                and str(message).startswith(SYNC_WARNING):
            self.count("host_syncs")
            site = f"{filename}:{lineno}"
            with self._lock:
                self.sync_sites[site] = self.sync_sites.get(site, 0) + 1
            return
        self._showwarning(message, category, filename, lineno, file, line)

    # -- reading it --------------------------------------------------------

    def collect(self) -> List[SpanRecord]:
        """The spans finished since the last collect() or reset(), in the
        order they ended, with their device times; waits for each device
        span's end event, so synchronise first to keep it off the device's
        path.  Spans still open stay for the next collect()."""
        with self._lock:
            done, self._done = self._done, []
        out = []
        for rec, events in done:
            if events is not None:
                events[1].synchronize()
                rec.device_ms = events[0].elapsed_time(events[1])
                self._pool.append(events)
            out.append(rec)
        return out

    def reset(self) -> None:
        """Drops what was recorded: finished spans, loose counts and sync
        sites."""
        with self._lock:
            done, self._done = self._done, []
            self.loose.clear()
            self.sync_sites.clear()
        self._pool.extend(ev for _, ev in done if ev is not None)

    # -- internals ---------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _take_events(self):
        try:
            return self._pool.pop()
        except IndexError:
            import torch
            return (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))


def per_root(spans: List[SpanRecord], root: str) -> List[Dict[str, Dict]]:
    """One summary per root span named `root`, in the order they started:
    {"host_ms": {name: ms}, "self_ms": {name: ms}, "device_ms": {name: ms},
    "counts": {counter: n}}, each summed over the spans of its tree (device
    ms over the device spans that have them)."""
    roots = sorted((s for s in spans if s.name == root and s.id == s.root),
                   key=lambda s: s.start_ns)
    out = {s.id: {"host_ms": {}, "self_ms": {}, "device_ms": {},
                  "counts": {}} for s in roots}
    for s in spans:
        acc = out.get(s.root)
        if acc is None:
            continue
        for key, v in (("host_ms", s.host_ms), ("self_ms", s.self_ns * 1e-6),
                       ("device_ms", s.device_ms)):
            if v is not None:
                acc[key][s.name] = acc[key].get(s.name, 0.0) + v
        for k, n in s.counts.items():
            acc["counts"][k] = acc["counts"].get(k, 0) + n
    return [out[s.id] for s in roots]


# the port's recorder, and its methods as module functions
RECORDER = Recorder()
span = RECORDER.span
traced = RECORDER.traced
count = RECORDER.count
enable = RECORDER.enable
disable = RECORDER.disable
reset = RECORDER.reset
collect = RECORDER.collect
