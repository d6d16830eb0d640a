"""Drives the PyTorch/CUDA port (scene_graph_commonsense_torch) on one NVIDIA
GPU and checks it, phase by phase; any failure raises and exits non-zero.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device:  requires CUDA; prints the card's name and power limit.
  2. build:   compiles every csrc/*.cu with nvcc (sm_90a), one process each.
  3. kernel:  the pair_pool kernel against its plain PyTorch version at the
              production shape (M=240 objects, S=32, C=512, P=4560 pair
              slots), in bfloat16 and float32, with random indices and with
              the indices pack_pairs gives a synthetic batch; equality must
              be exact.  Times the kernel and the plain version with CUDA
              events.
  4. slice:   PredCLS at full VG width (batch 12, 20 objects, 256 feature
              channels, hidden 128, bfloat16, worst-case pair capacity,
              seeded random weights): run_eval_pc over 3 synthetic batches,
              then SceneGraphPredictor.predict on one batch.  The launch
              counts are set to 0 just before and read just after; every
              kernel of the path must have launched once per batch.
  5. profile: torch.profiler over run_eval_pc: device busy share, kernels
              and operators by device time.
  6. parity:  the same weights and batch through make_eval_step on the card
              (kernel) and on the CPU (plain version) at a reduced size in
              float32 with TF32 off; outputs within 1e-4, integers equal.
Then a {"kernels": [...]} line, and as the last line
{"ok": true, "device": {...}}.  Uses no JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from scene_graph_commonsense_torch import config as config_lib
from scene_graph_commonsense_torch.data.artifacts import load_vg_artifacts
from scene_graph_commonsense_torch.data.synthetic import synthetic_batch
from scene_graph_commonsense_torch.eval import engines
from scene_graph_commonsense_torch.inference import SceneGraphPredictor
from scene_graph_commonsense_torch.models import weights
from scene_graph_commonsense_torch.models.relation_head import (
    make_relation_classifier)
from scene_graph_commonsense_torch.ops import _build, pair_pool, pairs
from scene_graph_commonsense_torch.train import engine

# published H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the port's kernels: counter module, source, the TPU kernel it replaces
KERNELS = {
    "pair_pool": (pair_pool,
                  "scene_graph_commonsense_torch/csrc/pair_pool.cu",
                  "scene_graph_commonsense_tpu/ops/pallas/pair_pool.py:42"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters):
    """Mean device time of fn() over `iters` calls, by CUDA events, after
    two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": card,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build():
    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in
                    _build.log_path(name).read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
             if _build.log_path(name).exists() else []
             for name in _build.sources()}
    emit({"phase": "build", "seconds": secs, "sources": _build.sources(),
          "ptxas": ptxas})


def pair_pool_bound(a, si, oj, out_elems):
    """Least time for relu(maxpool2(a[si] + b[oj])) on these inputs: one
    write of the output, one read of each stream row the pairs touch and
    of the indices, against 8 float32 operations per output element (4
    adds, 3 maxes, 1 relu)."""
    row = a[0].numel() * a.element_size()
    touched = torch.unique(si).numel() + torch.unique(oj).numel()
    nbytes = out_elems * a.element_size() + touched * row \
        + (si.numel() + oj.numel()) * si.element_size()
    ops = 8 * out_elems
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "touched_rows": touched}


def phase_kernel():
    """pair_pool kernel vs plain at the production shape."""
    m, s, c, p = 240, 32, 512, 4560
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    a32 = torch.randn((m, s, s, c), device=dev, generator=gen)
    b32 = torch.randn((m, s, s, c), device=dev, generator=gen)
    rand_idx = [torch.randint(0, m, (p,), device=dev, generator=gen,
                              dtype=torch.int32) for _ in range(2)]
    batch = synthetic_batch(np.random.default_rng(0), batch_size=12,
                            max_objects=20, with_aug=False)
    packed = pairs.pack_pairs(
        pairs.pair_validity(torch.as_tensor(batch["valid"], device=dev)), p)
    pack_idx = [packed.flat_sub, packed.flat_obj]
    results, max_err = [], 0.0
    for idx_name, (si, oj) in (("pack_pairs", pack_idx),
                               ("random", rand_idx)):
        for dtype in (torch.bfloat16, torch.float32):
            a, b = a32.to(dtype), b32.to(dtype)
            got = pair_pool.pair_pool(a, b, si, oj)
            want = pair_pool.pair_pool_plain(a, b, si, oj)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"pair_pool kernel != plain ({idx_name}, {dtype}): "
                    f"max abs err {err}")
            # plain, kernel, kernel, plain: both see the same clocks
            plain1 = cuda_ms(lambda: pair_pool.pair_pool_plain(a, b, si, oj),
                             5)
            kern = [cuda_ms(lambda: pair_pool.pair_pool(a, b, si, oj),
                            20) for _ in range(2)]
            plain2 = cuda_ms(lambda: pair_pool.pair_pool_plain(a, b, si, oj),
                             5)
            rec = {"indices": idx_name, "dtype": str(dtype).split(".")[1],
                   "m": m, "s": s, "c": c, "p": p,
                   "live_pairs": int(packed.count)
                   if idx_name == "pack_pairs" else None,
                   "max_abs_err": err,
                   "ms": min(kern), "ms_runs": kern,
                   "plain_ms": min(plain1, plain2),
                   "plain_ms_runs": [plain1, plain2],
                   **pair_pool_bound(a, si, oj, got.numel())}
            rec["no_reuse_bytes"] = (2 * 4 * p + p) * (s // 2) ** 2 * c \
                * a.element_size()
            results.append(rec)
            emit({"phase": "kernel", "name": "pair_pool", **rec})
    del a32, b32
    torch.cuda.empty_cache()
    # the main path's case: bf16 streams, pack_pairs indices
    main = results[0]
    return {"max_abs_err": max_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"]}


def _batches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [synthetic_batch(
        rng, batch_size=cfg.training.batch_size,
        max_objects=cfg.data.max_objects,
        feature_size=cfg.model.feature_size,
        num_channels=cfg.model.num_img_feature,
        num_classes=cfg.model.num_classes,
        num_relations=cfg.model.num_relations, with_aug=False)
        for _ in range(n)]


def phase_slice():
    """PredCLS eval + serving at full VG width through the port's entry
    points."""
    cfg = config_lib.derive("vg", hierarchical_pred=True, run_mode="eval",
                            training={"batch_size": 12})
    t0 = time.perf_counter()
    model = make_relation_classifier(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    init_s = time.perf_counter() - t0
    batches = _batches(cfg, 3, seed=100)
    estep = engine.make_eval_step(model, cfg, device="cuda")
    estep(batches[0])                             # warm-up (cuDNN plans)
    torch.cuda.synchronize()

    seen = []

    def checked_step(batch):
        out = estep(batch)
        seen.append({k: out[k] for k in ("relation", "super_relation",
                                         "connectivity", "pair_count")})
        return out

    artifacts = load_vg_artifacts("datasets/artifacts")
    torch.cuda.reset_peak_memory_stats()
    for mod, _, _ in KERNELS.values():
        mod.launches = 0
    t0 = time.perf_counter()
    res = engines.run_eval_pc(cfg, model, batches, artifacts=artifacts,
                              estep=checked_step, device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = {k: mod.launches for k, (mod, _, _) in KERNELS.items()}
    predictor = SceneGraphPredictor(cfg, model, device="cuda")
    request = {k: v for k, v in batches[0].items() if k != "rel"}
    t0 = time.perf_counter()
    graphs = predictor.predict(request, top_k=50)
    predict_s = time.perf_counter() - t0
    launches = {k: mod.launches for k, (mod, _, _) in KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    cap = cfg.pair_capacity
    for out in seen:
        for k in ("relation", "super_relation", "connectivity"):
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"non-finite {k} on the main path")
        assert out["relation"].shape == (cap, cfg.model.num_relations)
        assert out["super_relation"].shape == (cap, 3)
        assert out["connectivity"].shape == (cap,)
    for key in ("recall", "mean_recall"):
        assert all(0.0 <= r <= 1.0 for r in res[key]), (key, res[key])
        assert all(0.0 <= r <= 1.0 for r in res["top3"][key]), key
    assert len(graphs) == cfg.training.batch_size
    n_edges = sum(len(g) for g in graphs)
    assert n_edges > 0, "the predictor returned no edges"
    assert all(np.isfinite(e["confidence"]) for g in graphs for e in g)
    for name, count in eval_launches.items():
        if count != len(batches):
            raise AssertionError(f"{name} launched {count} times over "
                                 f"{len(batches)} eval batches")
    for name, count in launches.items():
        if count != len(batches) + 1:
            raise AssertionError(f"{name} launched {count} times on the "
                                 f"main path, expected {len(batches) + 1}")

    # device time of one eval step, after the warm-up above
    step_ms = [cuda_ms(lambda b=b: estep(b), 3) for b in batches]
    emit({"phase": "slice", "batch_size": cfg.training.batch_size,
          "max_objects": cfg.data.max_objects,
          "pair_capacity": cap, "compute_dtype": cfg.model.compute_dtype,
          "live_pairs": [int(o["pair_count"][0]) for o in seen],
          "recall": res["recall"], "mean_recall": res["mean_recall"],
          "recall_zs": res["recall_zs"], "top3": res["top3"],
          "num_targets": res["num_targets"], "predict_edges": n_edges,
          "launches": launches, "eval_step_ms": step_ms,
          "run_eval_pc_s": eval_s, "predict_s": predict_s,
          "init_s": init_s, "peak_mem_gb": peak_gb})
    return launches, (cfg, model, estep, batches, artifacts)


def phase_profile(cfg, model, estep, batches, artifacts):
    """Where the device time of run_eval_pc goes (torch.profiler): device
    busy share of the wall time, kernels by name, operators by input
    shape.  The profiler's own cost is in this wall time; phase `slice`
    has the unprofiled one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        engines.run_eval_pc(cfg, model, batches, artifacts=artifacts,
                            estep=estep)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n = len(batches)
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy_us = sum(kernels.values())
    if busy_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    top_kernels = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]

    def self_dev(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)

    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == DeviceType.CPU and self_dev(e) > 0]
    top_ops = sorted(ops, key=lambda e: -self_dev(e))[:12]
    emit({"phase": "profile", "batches": n,
          "wall_ms_per_batch": wall_us / 1e3 / n,
          "device_ms_per_batch": busy_us / 1e3 / n,
          "device_busy_share": busy_us / wall_us,
          "top_kernels": [{"name": k[:90], "ms_per_batch": v / 1e3 / n,
                           "share": v / busy_us} for k, v in top_kernels],
          "top_ops": [{"op": e.key, "shapes": str(e.input_shapes)[:120],
                       "calls_per_batch": e.count / n,
                       "ms_per_batch": self_dev(e) / 1e3 / n,
                       "share": self_dev(e) / busy_us} for e in top_ops]})


def phase_parity():
    """Card (kernel) vs CPU (plain version) on the same weights and batch,
    float32, reduced size."""
    cfg = config_lib.derive(
        "vg", hierarchical_pred=True, run_mode="eval",
        model={"feature_size": 16, "hidden_dim": 8, "num_img_feature": 16,
               "compute_dtype": "float32"},
        data={"max_objects": 6}, training={"batch_size": 4})
    sd = weights.init_params(cfg, torch.Generator().manual_seed(1))
    batch = _batches(cfg, 1, seed=5)[0]
    outs = {}
    for dev in ("cuda", "cpu"):
        model = make_relation_classifier(cfg, device=dev, state_dict=sd)
        outs[dev] = engines.to_numpy(
            engine.make_eval_step(model, cfg, device=dev)(batch))
    errs = {}
    for k, v in outs["cpu"].items():
        g = outs["cuda"][k]
        if k in ("relation", "super_relation", "connectivity"):
            errs[k] = float(np.abs(g - v).max())
            if errs[k] > 1e-4:
                raise AssertionError(f"card vs CPU {k}: {errs[k]} > 1e-4")
        elif not np.array_equal(g, v):
            raise AssertionError(f"card vs CPU {k} differ")
    emit({"phase": "parity", "max_abs_err": errs, "tolerance": 1e-4,
          "live_pairs": int(outs["cpu"]["pair_count"][0])})


def main():
    info = phase_device()
    phase_build()
    kernel = phase_kernel()
    launches, slice_state = phase_slice()
    phase_profile(*slice_state)
    phase_parity()
    rows = []
    for name, (_, source, replaces) in KERNELS.items():
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": kernel["max_abs_err"],
                     "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
                     "bound_ms": kernel["bound_ms"],
                     "bound_by": kernel["bound_by"], "library_ms": None})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    sys.exit(main())
