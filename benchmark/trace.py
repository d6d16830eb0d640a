"""The traced window: torch.profiler over a run of units (train steps or
requests), reduced to what the per-layer metrics read.

`traced(run_unit, n)` profiles in two passes.  The first traces the device
alone, so that the profiler adds no host work between the launches: one
unit as a warm-up, a synchronisation, a marker kernel, then units 1..n; the
device operations that start after the marker are counted (busy_s, the
time by kernel name), and window_s is the host's time from the marker to
the device's end of unit n.  The second pass traces host and device over
a few more units and gives the idle gaps by what the host was doing: the
drivers' own ranges (torch.profiler.record_function: "train.step",
"serve.featurize", ...) and the innermost host operation open when a gap
began.  Tracing the host slows it, so that pass says where gaps arise,
not how long the first pass's are.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

# the prefixes of the drivers' host ranges; the profiler also lays each
# range out on the device's timeline, which is no device operation
RANGES = ("train.", "serve.", "feed.")
# the marker kernel (torch.cuda._sleep) that opens a counted range
MARKER = "spin_kernel"
# idle gaps shorter than this are not attributed (launch spacing)
MIN_GAP_US = 5.0
# units of the host-and-device pass
GAP_UNITS = 3
TOP = 10


def _merge(intervals: np.ndarray) -> np.ndarray:
    """Sorted (start, end) rows -> their union as disjoint rows."""
    if len(intervals) == 0:
        return intervals
    out = [list(intervals[0])]
    for s, e in intervals[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def _pass(run_unit: Callable[[int], None], first: int, n: int,
          host: bool):
    """Profiles units first..first+n after a warm-up unit and the marker.
    Returns (device events after the marker, host events after its launch,
    host seconds from the marker to the end of the last unit)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    with profile(activities=acts) as prof:
        run_unit(first)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(1000)
        for i in range(first + 1, first + n + 1):
            run_unit(i)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith(RANGES)
              and not getattr(e, "is_user_annotation", False)]
    marks = [e for e in device if MARKER in e.name]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} marker kernels")
    mark = marks[0].time_range
    device = [e for e in device if e.time_range.start >= mark.end]
    hosts = [e for e in events if e.device_type == DeviceType.CPU
             and e.time_range.start >= mark.start - 50]
    if not device:
        raise RuntimeError("the profiler recorded no device operation")
    return device, hosts, window_s


def traced(run_unit: Callable[[int], None], n: int) -> Dict:
    """Units 0..n for the device pass (0 its warm-up), n+1..n+1+GAP_UNITS
    for the host pass.  Returns busy_s (the union of the device operations'
    intervals), window_s, kernels (name -> device seconds), units (n), and
    the top device_ops and idle_gaps (name, seconds)."""
    device, _, window_s = _pass(run_unit, 0, n, host=False)
    kernels: Dict[str, float] = {}
    for e in device:
        kernels[e.name] = kernels.get(e.name, 0.0) \
            + e.time_range.elapsed_us() * 1e-6
    merged = _merge(np.asarray(sorted((e.time_range.start, e.time_range.end)
                                      for e in device), np.float64))
    busy_s = float((merged[:, 1] - merged[:, 0]).sum()) * 1e-6
    device2, hosts, _ = _pass(run_unit, n + 1, GAP_UNITS, host=True)
    merged2 = _merge(np.asarray(sorted(
        (e.time_range.start, e.time_range.end) for e in device2),
        np.float64))
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "window_s": window_s, "kernels": kernels,
            "units": n, "device_ops": [[k, v] for k, v in ops],
            "idle_gaps": _idle_gaps(merged2, hosts)}


def _idle_gaps(merged: np.ndarray, host) -> List[Tuple[str, float]]:
    """The device's idle gaps between its operations, summed by what the
    host was doing when each began: the benchmark's outermost range and
    the innermost host operation open at that moment."""
    if len(merged) < 2:
        return []
    starts = merged[1:, 0]
    ends = merged[:-1, 1]
    length = starts - ends
    order = np.argsort(-length)
    order = order[length[order] >= MIN_GAP_US][:400]
    hs = np.asarray([e.time_range.start for e in host], np.float64)
    he = np.asarray([e.time_range.end for e in host], np.float64)
    names = [e.name for e in host]
    ours = np.asarray([n.startswith(RANGES) for n in names])
    by_cause: Dict[str, float] = {}
    for g in order:
        t = ends[g]
        open_ = (hs <= t) & (he >= t)
        idx = np.nonzero(open_)[0]
        if len(idx) == 0:
            cause = "no host range"
        else:
            inner = idx[np.argmax(hs[idx])]
            outer = idx[ours[idx]]
            top = names[outer[np.argmin(hs[outer])]] if len(outer) else "-"
            cause = f"{top}/{names[inner]}"
        by_cause[cause] = by_cause.get(cause, 0.0) + length[g] * 1e-6
    return [[k, v] for k, v in sorted(by_cause.items(),
                                      key=lambda kv: -kv[1])[:TOP]]


def matches(kernel_name: str, names) -> bool:
    """Whether a device operation's (demangled) name is one of `names`:
    the identifier itself, not a longer one that contains it."""
    return any(re.search(r"(^|[^A-Za-z0-9_])" + re.escape(n)
                         + r"($|[^A-Za-z0-9_])", kernel_name)
               for n in names)
