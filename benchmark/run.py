"""The benchmark of scene_graph_commonsense_torch: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Builds the cell's program over the seeded weights and traffic, warms it
up, measures for --seconds, checks what the timed path produced against
the plain reference, and prints one JSON line as the last line of standard
output:

    {"correct": bool, "attempted": images, "failed": 0,
     "metrics": {name: {"value", "unit"}}, "device": {...},
     ["breakdown": {"device_ops", "idle_gaps"}], "checks": {...}}

With --trace 0 the metrics are the cell's end-to-end metrics, with
--trace 1 its per-layer ones (the run also opens CUDA-event spans and a
profiled window after the measured one).  The numbers compared for
`correct` are printed beside their limits under "checks" and as the last
lines of standard error.  A cell on several chips runs one process per
card: this process is rank 0 and starts the others.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The perf_counter reading of this process's start (from /proc), or
    of now where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
_HERE = os.path.dirname(os.path.abspath(__file__))
# the program's kernel caches live at fixed paths inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(_HERE, "_cache", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(_HERE, "_cache", "triton"))

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from benchmark import harness  # noqa: E402


class Ctx:
    """One rank's run of a cell: its inputs, its device and the few
    operations that differ between one card and several."""

    def __init__(self, conf, traffic, chips, seed, seconds, trace, device,
                 mesh=None, ctl=None):
        self.conf, self.traffic, self.chips = conf, traffic, chips
        self.seed, self.seconds, self.trace = seed, seconds, bool(trace)
        self.device, self.mesh, self.ctl = device, mesh, ctl
        self.t_start = T_START
        self.setup_s = None
        self.phases = []

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    def mark(self, phase: str):
        """Notes the end of a set-up phase (seconds since the start)."""
        self.phases.append((phase, time.perf_counter() - self.t_start))

    def open_window(self):
        """The end of set-up: every rank here, the device idle, set-up's
        garbage collected, the memory peak reset.  Threads and the
        collector stay as the program sets them."""
        self.barrier()
        self.sync()
        gc.collect()
        if self.cuda:
            import torch
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        if not self.cuda:
            return 0
        import torch
        return torch.cuda.max_memory_allocated(self.device)

    def events(self):
        import torch
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def free(self):
        gc.collect()
        if self.cuda:
            import torch
            torch.cuda.empty_cache()

    def agree(self, value):
        """Rank 0's value on every rank."""
        if self.ctl is None:
            return value
        import torch.distributed as dist
        box = [value]
        dist.broadcast_object_list(box, src=0, group=self.ctl)
        return box[0]

    def gather(self, obj) -> list:
        """Every rank's obj, in rank order, on every rank."""
        if self.ctl is None:
            return [obj]
        import torch.distributed as dist
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj, group=self.ctl)
        return out

    def barrier(self):
        if self.ctl is not None:
            import torch.distributed as dist
            dist.barrier(group=self.ctl)

    def window_over(self, t0: float) -> bool:
        return self.agree(time.perf_counter() - t0 >= self.seconds)

    def profile(self, run_unit, n: int):
        from benchmark import trace
        return trace.traced(run_unit, self.agree(n))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _merge(parts):
    """Rank 0's record with every rank's units, spans and profile."""
    rec = parts[0]["record"]
    if len(parts) == 1:
        return rec
    rec.units = [u for p in parts for u in p["record"].units]
    rec.traced_units = [u for p in parts for u in p["record"].traced_units]
    for name in rec.spans:
        rec.spans[name] = [v for p in parts for v in p["record"].spans[name]]
    if rec.profile is not None:
        profs = [p["record"].profile for p in parts]
        kernels = {}
        for pr in profs:
            for k, v in pr["kernels"].items():
                kernels[k] = kernels.get(k, 0.0) + v
        rec.profile = {**profs[0], "kernels": kernels,
                       "busy_s": sum(p["busy_s"] for p in profs) / len(profs)}
    return rec


def run_cell(args, sp, device, mesh=None, ctl=None) -> dict:
    """One rank's run; on rank 0 the result's dict, elsewhere None."""
    cell = harness.cell(args.workload, sp)
    ctx = Ctx(harness.config(cell["config"]), harness.traffic(cell["traffic"]),
              cell["chips"], args.seed, args.seconds, args.trace, device,
              mesh, ctl)
    out = harness.driver(ctx.traffic["mode"]).run(ctx)
    out["record"].setup_s = ctx.setup_s
    out["record"].images = out["attempted"]
    parts = ctx.gather({"record": out["record"], "peak": out["peak"]})
    if args.rank != 0:
        return None
    rec = _merge(parts)
    numbers = out["numbers"]
    lim = harness.limits(args.workload)
    correct = harness.judge(numbers, lim)
    metrics = {}
    for m in harness.cell_metrics(sp, args.workload, ctx.trace):
        v = harness.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": 0, "metrics": metrics,
              "device": device_record(ctx, max(p["peak"] for p in parts),
                                      rec)}
    if rec.profile is not None:
        result["breakdown"] = {"device_ops": rec.profile["device_ops"],
                               "idle_gaps": rec.profile["idle_gaps"]}
    result["checks"] = harness.report_checks(numbers, lim)
    print("setup phases (s from the start): " + ", ".join(
        f"{k} {v:.2f}" for k, v in ctx.phases), file=sys.stderr)
    return result


def device_record(ctx, peak: int, rec) -> dict:
    if not ctx.cuda:
        return {"platform": "cpu", "kind": "cpu", "count": ctx.chips,
                "memory_peak_bytes": peak}
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": ctx.chips, "memory_peak_bytes": int(peak)}
    if rec.profile is not None:
        out.update(busy_s=rec.profile["busy_s"],
                   window_s=rec.profile["window_s"])
    return out


def _launch_ranks(argv, ranks: int, port: int, work: str):
    procs = []
    for r in range(1, ranks):
        log = open(os.path.join(work, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "benchmark.run", *argv, "--rank", str(r),
             "--port", str(port)], stdout=log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(_HERE)), log, r))
    return procs


def _finish_ranks(procs, work: str) -> bool:
    ok = True
    for p, log, r in procs:
        try:
            rc = p.wait(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        log.close()
        if rc != 0:
            ok = False
            with open(os.path.join(work, f"rank{r}.log")) as f:
                sys.stderr.write(f"rank {r} exited {rc}:\n"
                                 + f.read()[-4000:])
    return ok


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    sp = harness.spec()
    cell = harness.cell(args.workload, sp)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ranks = harness.traffic(cell["traffic"]).get("ranks", 1)
    procs, work, mesh, ctl = [], None, None, None
    if ranks > 1:
        import torch.distributed as dist
        from scene_graph_commonsense_torch.parallel.mesh import (
            init_multihost, make_mesh)
        if args.rank == 0:
            args.port = _free_port()
            work = tempfile.mkdtemp(prefix="benchmark_ranks_")
            procs = _launch_ranks(argv, ranks, args.port, work)
        init_multihost(f"localhost:{args.port}", ranks, args.rank,
                       device="cuda")
        mesh = make_mesh(data=ranks, device="cuda")
        ctl = dist.new_group(backend="gloo")
        device = mesh.device
    else:
        device = torch.device("cuda", 0)
    try:
        result = run_cell(args, sp, device, mesh, ctl)
    finally:
        if ranks > 1:
            import torch.distributed as dist
            dist.destroy_process_group()
    if args.rank != 0:
        return 0
    if procs and not _finish_ranks(procs, work):
        return 4
    found = harness.forbidden_modules()
    if found:
        print(f"the process holds {found}; the benchmark may not load them",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    # the checks, last on standard error
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
