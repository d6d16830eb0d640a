"""What every cell shares: the specification found by name, the per-layer
readers, the record of a run, the checks on the process, the result line.

BENCHMARK.json names the cells.  A cell's configuration is
benchmark/configs/<config>.json, its traffic benchmark/traffic/<traffic>.json,
whose "mode" names the driver module benchmark/<mode>.py (run(ctx), the
FLOPs of one unit of work unit_flops(unit), and the control's readings
control_readings(conf, traffic, seed, device)), its limits for `correct` benchmark/limits/<cell>.json; a per-layer metric's
reader is benchmark/metrics/<metric>.py (a function read(record) returning
a number, or None where the run holds nothing to read); a kernel stage is
benchmark/kernels/<stage>.json (its kernels' names) with
benchmark/kernels/<stage>.py (least_s(unit, peaks), its least time on a
unit of work).  Adding any of them adds files and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names the process must not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "scene_graph_commonsense_tpu")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def spec() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str, sp: Optional[Dict] = None) -> Dict:
    sp = sp or spec()
    for w in sp["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> Dict:
    return load_json(os.path.join(HERE, "configs", name + ".json"))


def traffic(name: str) -> Dict:
    return load_json(os.path.join(HERE, "traffic", name + ".json"))


def driver(mode: str):
    """The driver module of a traffic mode: benchmark/<mode>.py."""
    if not mode.replace("_", "").isalnum():
        raise SystemExit(f"no driver for traffic mode {mode!r}")
    mod = importlib.import_module("benchmark." + mode)
    if not callable(getattr(mod, "run", None)):
        raise SystemExit(f"benchmark/{mode}.py is no driver: it has no run")
    return mod


def limits(cell_name: str) -> Dict[str, float]:
    return load_json(os.path.join(HERE, "limits", cell_name + ".json"))


def _module(path: str, name: str):
    spec_ = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable:
    """benchmark/metrics/<metric>.py's read function."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    return _module(path, "benchmark_metric_" + metric.replace(".", "_")).read


def stages() -> Dict[str, Dict]:
    """Every kernel stage: name -> {"kernels": [...], "least_s": fn}."""
    out = {}
    kdir = os.path.join(HERE, "kernels")
    for fn in sorted(os.listdir(kdir)):
        if fn.endswith(".json"):
            name = fn[:-5]
            out[name] = {
                "kernels": load_json(os.path.join(kdir, fn))["kernels"],
                "least_s": _module(os.path.join(kdir, name + ".py"),
                                   "benchmark_stage_" + name).least_s}
    return out


def cell_metrics(sp: Dict, cell_name: str, trace: bool) -> List[Dict]:
    """The metrics a run of the cell prints: its end-to-end metrics, or
    with trace its per-layer ones."""
    if not trace:
        return [m for m in sp["end_to_end"]
                if cell_name in m.get("workloads", [cell_name])]
    reported = {m["name"] for m in cell_metrics(sp, cell_name, False)}
    return [m for m in sp["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            or ("workloads" not in m and m["moves"] in reported)]


@dataclass
class Record:
    """What a run measured, for the readers.  `spans` hold per-unit values
    (ms) by name over the measured window; `units` the work of every unit
    in the window (benchmark/work.py), `traced_units` those of the traced
    window; `profile` benchmark/trace.traced's summary (its kernels summed
    and its busy_s averaged over the ranks)."""
    mode: str
    chips: int
    window_s: float
    units: List[Dict]
    images: int = 0
    spans: Dict[str, List[float]] = field(default_factory=dict)
    profile: Optional[Dict] = None
    traced_units: List[Dict] = field(default_factory=list)
    latency_ms: List[float] = field(default_factory=list)
    setup_s: Optional[float] = None

    def mean(self, span: str) -> Optional[float]:
        v = self.spans.get(span)
        return sum(v) / len(v) if v else None

    def stage_roofline(self, stage: str) -> Optional[float]:
        """100 x the stage's least time on the traced units over its
        kernels' profiled device time; None where none of its kernels
        ran."""
        from benchmark import trace, work
        if self.profile is None:
            return None
        st = stages()[stage]
        busy = sum(t for name, t in self.profile["kernels"].items()
                   if trace.matches(name, st["kernels"]))
        if busy <= 0:
            return None
        pk = work.peaks()
        least = [st["least_s"](u, pk) for u in self.traced_units]
        if any(v is None for v in least):
            return None
        return 100.0 * sum(least) / busy

    def mfu(self) -> float:
        from benchmark import work
        flops = sum(driver(u["kind"]).unit_flops(u) for u in self.units)
        return 100.0 * flops / self.window_s / (
            self.chips * work.peaks()["bf16_tensor_flops"])

    def idle_pct(self) -> Optional[float]:
        if self.profile is None:
            return None
        return 100.0 * (1.0 - self.profile["busy_s"]
                        / self.profile["window_s"])


def port_config(conf: Dict, images: int, seed: int, **training):
    """The port's Config of a configuration file at `images` images a step
    or request, dropout seeded by `seed`; `training` overrides keys of its
    training section."""
    from scene_graph_commonsense_torch import config as config_lib
    m = conf["model"]
    model = {k: m[k] for k in (
        "image_size", "feature_size", "num_img_feature", "num_classes",
        "num_relations", "num_super_classes", "hidden_dim", "num_geometric",
        "num_possessive", "num_semantic", "T1", "T2", "T3", "dropout_rate",
        "compute_dtype", "detr_enc_layers")}
    model["detr_blocks"] = tuple(m["detr_blocks"])
    return config_lib.derive(
        conf["dataset"], hierarchical_pred=m["hierarchical_pred"],
        model=model, data=dict(conf["data"]),
        training={"batch_size": images, "seed": seed, **training})


def forbidden_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def judge(numbers: Dict[str, float], lim: Dict[str, float]) -> bool:
    """Every compared number within its limit (a number that is not finite
    fails)."""
    return all(k in numbers and numbers[k] == numbers[k]
               and numbers[k] <= lim[k] for k in lim)


def report_checks(numbers: Dict[str, float], lim: Dict[str, float]) -> Dict:
    """name -> {"value", "limit"}; a value that is not finite as a string
    ("inf", "nan")."""
    def num(v):
        return v if v == v and abs(v) != float("inf") else str(v)
    return {k: {"value": num(numbers.get(k, float("nan"))), "limit": lim[k]}
            for k in lim}
