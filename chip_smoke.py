"""Drives the PyTorch/CUDA port (scene_graph_commonsense_torch) on one NVIDIA
GPU and checks it, phase by phase; any failure raises and exits non-zero.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. device:  requires CUDA; prints the card's name and power limit.
  2. build:   compiles every csrc/*.cu with nvcc (sm_90a), one process each.
  3. kernel:  each kernel against its plain PyTorch version at the
              production shape (M=240 objects, S=32, C=512), in bfloat16 and
              float32, with the indices pack_pairs gives a synthetic batch
              and with random indices.  pair_pool at P=4560 pair slots and
              pair_pool_idx must equal their plain versions exactly (out and
              idx); pair_pool_bwd at P=1024 and 4560 must lie within float32
              rounding of its plain version (see check_grad).  Times each
              kernel and plain version with CUDA events.
  4. slice:   PredCLS at full VG width (batch 12, 20 objects, 256 feature
              channels, hidden 128, bfloat16, worst-case pair capacity,
              seeded random weights): run_eval_pc over 3 synthetic batches,
              then SceneGraphPredictor.predict on one batch.  The launch
              counts are set to 0 just before and read just after: the
              forward kernel once per batch, the training kernels never.
  5. profile: torch.profiler over run_eval_pc: device busy share, kernels
              and operators by device time.
  6. train:   PredCLS training at bench.py's configuration (full VG width,
              batch 12, pair capacity 1024, augmented capacity 256, clip
              5.0, bf16): the train step of train.loop.fit, 2 warm-up steps
              then 6 timed by CUDA events, with the launch counts set to 0
              just before: exactly 2 launches of each training kernel per
              step (main and augmented view), none of the forward kernel;
              finite losses; parameters changed.  torch.profiler over 3
              steps.  Then one fit epoch of 3 steps with its test pass,
              which must launch the forward kernel once per test batch and
              per train-time recall pass, and write its checkpoint.
  7. parity:  the same weights and batch through make_eval_step, and one
              train step, on the card (kernels) and on the CPU (plain
              versions) at a reduced size in float32 with TF32 off: outputs
              and parameters after the step within 1e-4, integer outputs
              and metrics equal, the winner index equal on equal streams.
Then a {"kernels": [...]} line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Uses no JAX.

    python3 chip_smoke.py [--phases kernel,train,...]

runs the named phases only (device and build always run; the summary lines
need all phases).
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from scene_graph_commonsense_torch import bench
from scene_graph_commonsense_torch import config as config_lib
from scene_graph_commonsense_torch.__main__ import synthetic_batches
from scene_graph_commonsense_torch.constants import class_weights
from scene_graph_commonsense_torch.data.artifacts import load_vg_artifacts
from scene_graph_commonsense_torch.data.synthetic import synthetic_batch
from scene_graph_commonsense_torch.eval import engines
from scene_graph_commonsense_torch.inference import SceneGraphPredictor
from scene_graph_commonsense_torch.models import weights
from scene_graph_commonsense_torch.models.relation_head import (
    make_relation_classifier)
from scene_graph_commonsense_torch.ops import _build, pair_pool, pairs
from scene_graph_commonsense_torch.ops import boxes as box_ops
from scene_graph_commonsense_torch.train import engine
from scene_graph_commonsense_torch.train import loop

# published H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the port's kernels: launch counter (in ops/pair_pool.py), source, the TPU
# kernel it replaces
SOURCE = "scene_graph_commonsense_torch/csrc/pair_pool.cu"
KERNELS = {
    "pair_pool": ("launches", SOURCE,
                  "scene_graph_commonsense_tpu/ops/pallas/pair_pool.py:42"),
    "pair_pool_idx": ("idx_launches", SOURCE,
                      "scene_graph_commonsense_tpu/ops/pallas/pair_pool.py"
                      ":47"),
    "pair_pool_bwd": ("bwd_launches", SOURCE,
                      "scene_graph_commonsense_tpu/ops/pallas/pair_pool.py"
                      ":149"),
}


def reset_counts():
    for counter, _, _ in KERNELS.values():
        setattr(pair_pool, counter, 0)


def read_counts():
    return {name: getattr(pair_pool, counter)
            for name, (counter, _, _) in KERNELS.items()}


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
    card = bench.card_name()
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


def bound(nbytes, ops):
    """Least time for `nbytes` of device-memory traffic and `ops` float32
    operations at the card's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def pair_pool_bound(a, si, oj, out_elems, idx_bytes=0, ops_per_elem=8):
    """Least time for relu(maxpool2(a[si] + b[oj])) on these inputs: one
    write of the output (and of the int8 index, for the forward with
    index), one read of each stream row the pairs touch and of the indices,
    against `ops_per_elem` float32 operations per output element (8: 4
    adds, 3 maxes, 1 relu; the index adds 3 selects)."""
    row = a[0].numel() * a.element_size()
    touched = torch.unique(si).numel() + torch.unique(oj).numel()
    nbytes = out_elems * a.element_size() + idx_bytes + touched * row \
        + (si.numel() + oj.numel()) * si.element_size()
    return {**bound(nbytes, ops_per_elem * out_elems),
            "touched_rows": touched}


def pair_pool_bwd_bound(g, idx, si, oj, m):
    """Least time for the backward on these inputs: one read of g, idx and
    the indices, one write of ga and gb, against 2 float32 operations per g
    element for each of ga and gb (the winner test and the add)."""
    s = 2 * g.shape[1]
    out = 2 * m * s * s * g.shape[3] * g.element_size()
    nbytes = g.numel() * g.element_size() + idx.numel() + out \
        + (si.numel() + oj.numel()) * si.element_size()
    return bound(nbytes, 4 * g.numel())


def ulp_bf16(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def check_grad(got, want, mag, name):
    """got: the kernel's gradient, want: the plain version's on the same
    inputs (float32 sums in another order, by atomics, then rounded once),
    mag: the plain version's sums of |g| (float32).  float32: within
    1e-6 * mag, above any reordering error of these sums; bfloat16: within
    one bf16 ulp of the plain result plus the same float32 allowance.
    Returns (max abs err, max error in units of the tolerance)."""
    err = (got.float() - want.float()).abs()
    tol = 1e-6 * mag
    if got.dtype == torch.bfloat16:
        tol = tol + ulp_bf16(torch.maximum(got.float().abs(),
                                           want.float().abs()))
    ratio = float((err / tol.clamp_min(1e-30)).max())
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: kernel gradient differs from the "
                             f"plain version by {ratio:.3g} x the "
                             f"tolerance (max abs err {float(err.max())})")
    return float(err.max()), ratio


def timed(kernel_fn, plain_fn, plain_iters=5, kernel_iters=20):
    """plain, kernel, kernel, plain: both see the same clocks."""
    plain1 = cuda_ms(plain_fn, plain_iters)
    kern = [cuda_ms(kernel_fn, kernel_iters) for _ in range(2)]
    plain2 = cuda_ms(plain_fn, plain_iters)
    return {"ms": min(kern), "ms_runs": kern,
            "plain_ms": min(plain1, plain2), "plain_ms_runs": [plain1, plain2]}


def _pack_indices(p, dev):
    batch = synthetic_batch(np.random.default_rng(0), batch_size=12,
                            max_objects=20, with_aug=False)
    packed = pairs.pack_pairs(
        pairs.pair_validity(torch.as_tensor(batch["valid"], device=dev)), p)
    return packed.flat_sub, packed.flat_obj, int(packed.count)


def phase_kernel():
    """Each kernel vs its plain version at the production shape.  Returns,
    per kernel, the numbers of the main path's case (bf16, pack_pairs
    indices; P = 4560 for the eval forward, 1024 for training)."""
    m, s, c = 240, 32, 512
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    a32 = torch.randn((m, s, s, c), device=dev, generator=gen)
    b32 = torch.randn((m, s, s, c), device=dev, generator=gen)
    cases = [("pack_pairs", *_pack_indices(4560, dev)),
             ("pack_pairs", *_pack_indices(1024, dev))]
    cases.append(("random", *[torch.randint(
        0, m, (4560,), device=dev, generator=gen, dtype=torch.int32)
        for _ in range(2)], None))
    main = {}
    max_err = {name: 0.0 for name in KERNELS}
    for idx_name, si, oj, live in cases:
        p = si.shape[0]
        for dtype in (torch.bfloat16, torch.float32):
            a, b = a32.to(dtype), b32.to(dtype)
            common = {"indices": idx_name, "dtype": str(dtype).split(".")[1],
                      "m": m, "s": s, "c": c, "p": p, "live_pairs": live}
            is_main = idx_name == "pack_pairs" and dtype == torch.bfloat16
            recs = {}

            # forward (eval): exact
            if p == 4560:
                got = pair_pool.pair_pool_kernel(a, b, si, oj)
                want = pair_pool.pair_pool_plain(a, b, si, oj)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"pair_pool kernel != plain ({idx_name}, {dtype}): "
                        f"max abs err {err}")
                rec = {**common, "max_abs_err": err, **timed(
                    lambda: pair_pool.pair_pool_kernel(a, b, si, oj),
                    lambda: pair_pool.pair_pool_plain(a, b, si, oj)),
                    **pair_pool_bound(a, si, oj, got.numel())}
                rec["no_reuse_bytes"] = (2 * 4 * p + p) * (s // 2) ** 2 * c \
                    * a.element_size()
                recs["pair_pool"] = rec
                del got, want

            # forward with index (training): out and idx exact
            out, idx = pair_pool.pair_pool_idx_kernel(a, b, si, oj)
            w_out, w_idx = pair_pool.pair_pool_idx_plain(a, b, si, oj)
            torch.cuda.synchronize()
            err = (out.float() - w_out.float()).abs().max().item()
            if not (torch.equal(out, w_out) and torch.equal(idx, w_idx)):
                raise AssertionError(
                    f"pair_pool_idx kernel != plain ({idx_name}, {dtype}): "
                    f"out err {err}, idx differs at "
                    f"{int((idx != w_idx).sum())} elements")
            slots = torch.bincount(idx.flatten().long() + 1, minlength=5)
            recs["pair_pool_idx"] = {
                **common, "max_abs_err": err,
                "idx_counts_clip_0_1_2_3": slots.tolist(), **timed(
                    lambda: pair_pool.pair_pool_idx_kernel(a, b, si, oj),
                    lambda: pair_pool.pair_pool_idx_plain(a, b, si, oj)),
                **pair_pool_bound(a, si, oj, out.numel(),
                                  idx_bytes=idx.numel(), ops_per_elem=11)}
            del out, w_out, w_idx

            # backward: within float32 rounding of the plain version
            g = torch.randn(idx.shape, device=dev, generator=gen).to(dtype)
            ga, gb = pair_pool.pair_pool_bwd_kernel(g, idx, si, oj, m)
            ga2, gb2 = pair_pool.pair_pool_bwd_kernel(g, idx, si, oj, m)
            w_ga, w_gb = pair_pool.pair_pool_bwd_plain(g, idx, si, oj, m)
            mag_a, mag_b = pair_pool.pair_pool_bwd_plain(
                g.float().abs(), idx, si, oj, m)
            torch.cuda.synchronize()
            if not (torch.equal(ga, ga2) and torch.equal(gb, gb2)):
                raise AssertionError("pair_pool_bwd is not deterministic")
            tag = f"pair_pool_bwd ({idx_name}, P={p}, {dtype})"
            err_a, ratio_a = check_grad(ga, w_ga, mag_a, tag + " ga")
            err_b, ratio_b = check_grad(gb, w_gb, mag_b, tag + " gb")
            del ga, gb, ga2, gb2, w_ga, w_gb, mag_a, mag_b
            recs["pair_pool_bwd"] = {
                **common, "max_abs_err": max(err_a, err_b),
                "max_err_over_tol": max(ratio_a, ratio_b),
                "deterministic": True, **timed(
                    lambda: pair_pool.pair_pool_bwd_kernel(g, idx, si, oj,
                                                           m),
                    lambda: pair_pool.pair_pool_bwd_plain(g, idx, si, oj,
                                                          m)),
                **pair_pool_bwd_bound(g, idx, si, oj, m)}
            del g, idx
            torch.cuda.empty_cache()

            for name, rec in recs.items():
                max_err[name] = max(max_err[name], rec["max_abs_err"])
                emit({"phase": "kernel", "name": name, **rec})
                main_p = 4560 if name == "pair_pool" else 1024
                if is_main and p == main_p:
                    main[name] = rec
    del a32, b32
    torch.cuda.empty_cache()
    return {name: {"max_abs_err": max_err[name],
                   **{k: main[name][k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "bound_by")}}
            for name in KERNELS}


def phase_slice():
    """PredCLS eval + serving at full VG width through the port's entry
    points."""
    cfg = config_lib.derive("vg", hierarchical_pred=True, run_mode="eval",
                            training={"batch_size": 12})
    t0 = time.perf_counter()
    model = make_relation_classifier(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    init_s = time.perf_counter() - t0
    batches = list(synthetic_batches(cfg, 3, seed=100))
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
    reset_counts()
    t0 = time.perf_counter()
    res = engines.run_eval_pc(cfg, model, batches, artifacts=artifacts,
                              estep=checked_step, device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = read_counts()
    predictor = SceneGraphPredictor(cfg, model, device="cuda")
    request = {k: v for k, v in batches[0].items() if k != "rel"}
    t0 = time.perf_counter()
    graphs = predictor.predict(request, top_k=50)
    predict_s = time.perf_counter() - t0
    launches = read_counts()
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
    # eval and serving launch the forward kernel once per batch and never
    # the training kernels (no gradient in flight)
    expect = {"pair_pool": len(batches), "pair_pool_idx": 0,
              "pair_pool_bwd": 0}
    if eval_launches != expect:
        raise AssertionError(f"launches over {len(batches)} eval batches: "
                             f"{eval_launches}, expected {expect}")
    expect["pair_pool"] += 1
    if launches != expect:
        raise AssertionError(f"launches on the eval/serving path: "
                             f"{launches}, expected {expect}")

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


def device_profile(fn, n, top_ops=16):
    """torch.profiler over fn(): device busy share of the wall time, kernels
    by name, operators by input shape, per call of n."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy_us = sum(kernels.values())
    if busy_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    top_kernels = sorted(kernels.items(), key=lambda kv: -kv[1])[:14]

    def self_dev(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)

    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == DeviceType.CPU and self_dev(e) > 0]
    top = sorted(ops, key=lambda e: -self_dev(e))[:top_ops]
    return {"calls": n,
            "wall_ms_per_call": wall_us / 1e3 / n,
            "device_ms_per_call": busy_us / 1e3 / n,
            "device_busy_share": busy_us / wall_us,
            "top_kernels": [{"name": k[:90], "ms_per_call": v / 1e3 / n,
                             "share": v / busy_us}
                            for k, v in top_kernels],
            "top_ops": [{"op": e.key, "shapes": str(e.input_shapes)[:120],
                         "calls_per_call": e.count / n,
                         "ms_per_call": self_dev(e) / 1e3 / n,
                         "share": self_dev(e) / busy_us} for e in top]}


def phase_profile(cfg, model, estep, batches, artifacts):
    """Where the device time of run_eval_pc goes, per batch.  The
    profiler's own cost is in its wall time; phase `slice` has the
    unprofiled one."""
    emit({"phase": "profile", **device_profile(
        lambda: engines.run_eval_pc(cfg, model, batches,
                                    artifacts=artifacts, estep=estep),
        len(batches))})


def phase_train():
    """PredCLS training at bench.py's configuration through the train step
    of train.loop.fit, then one fit epoch.  Returns the training kernels'
    launches over the timed steps."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, step, state, batch = bench.setup(seed=0, device="cuda")
    init_s = time.perf_counter() - t0
    before = {k: v.detach().float().clone() for k, v in
              (("fc1", model.fc1.weight[:8]),
               ("conv2_sub", model.conv2_sub.weight),
               ("emb_c1", model.emb_c1.weight))}
    warmup, steps = 2, 6
    seen = []
    for _ in range(warmup):
        state, metrics = step(state, batch)
        seen.append(metrics)
    torch.cuda.synchronize()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        state, metrics = step(state, batch)
        seen.append(metrics)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    device_ms = start.elapsed_time(end) / steps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect = {"pair_pool": 0, "pair_pool_idx": 2 * steps,
              "pair_pool_bwd": 2 * steps}
    if launches != expect:
        raise AssertionError(f"train step launches over {steps} steps: "
                             f"{launches}, expected {expect}")
    metrics = [{k: float(v) for k, v in m.items()} for m in seen]
    for mt in metrics:
        bad = [k for k, v in mt.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite train metrics {bad}")
    moved = {k: float((getattr(model, k).weight[:8] if k == "fc1"
                       else getattr(model, k).weight).detach().float()
                      .sub(v).abs().max()) for k, v in before.items()}
    if not all(d > 0 for d in moved.values()):
        raise AssertionError(f"parameters did not change: {moved}")
    flops = bench.train_step_flops(cfg)
    emit({"phase": "train", "batch_size": cfg.training.batch_size,
          "pair_capacity": cfg.pair_capacity,
          "aug_capacity": engine.aug_pair_capacity(cfg),
          "compute_dtype": cfg.model.compute_dtype,
          "live_pairs": metrics[-1]["num_pairs"],
          "steps": steps, "warmup": warmup, "launches": launches,
          "step_device_ms": device_ms, "step_wall_ms": wall_s * 1e3 / steps,
          "img_per_s": cfg.training.batch_size * steps / wall_s,
          "train_step_tflop": flops / 1e12,
          "mfu_pct": 100 * flops / (wall_s / steps) / bench.PEAK_BF16_FLOPS,
          "peak_mem_gb": peak_gb, "init_s": init_s,
          "param_max_change": moved,
          "losses_first_last": [{k: v for k, v in mt.items()
                                 if k.startswith("loss")}
                                for mt in (metrics[0], metrics[-1])],
          "pair_overflow": metrics[-1]["pair_overflow"],
          "aug_pair_overflow": metrics[-1]["aug_pair_overflow"]})

    # where the step's device time goes
    def three_steps():
        nonlocal state
        for _ in range(3):
            state, _ = step(state, batch)
    emit({"phase": "train_profile",
          **device_profile(three_steps, 3, top_ops=48)})
    del state, batch, step
    torch.cuda.empty_cache()

    # one epoch of fit: its own step, train-time recall at batches 0 and 2,
    # the checkpoint, the truncated test pass
    with tempfile.TemporaryDirectory() as tmp:
        fcfg = bench.bench_config(
            num_epoch=1, print_freq=1, eval_freq=2,
            checkpoint_path=os.path.join(tmp, "ck"),
            result_path=os.path.join(tmp, "res"))
        n_train, n_test = 3, 2
        lines = []
        reset_counts()
        t0 = time.perf_counter()
        loop.fit(fcfg, model,
                 lambda e: synthetic_batches(fcfg, n_train, seed=e,
                                             with_aug=True),
                 lambda e: synthetic_batches(fcfg, n_test, seed=100 + e),
                 steps_per_epoch=n_train,
                 artifacts=load_vg_artifacts("datasets/artifacts"),
                 device="cuda", log_fn=lines.append)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = read_counts()
        ckpt = loop.checkpoint_file(fcfg, 0)
        ckpt_bytes = os.path.getsize(ckpt) if os.path.exists(ckpt) else 0
    expect = {"pair_pool": n_test + 2, "pair_pool_idx": 2 * n_train,
              "pair_pool_bwd": 2 * n_train}
    if fit_launches != expect:
        raise AssertionError(f"fit launches {fit_launches}, expected "
                             f"{expect}")
    if not ckpt_bytes:
        raise AssertionError(f"fit wrote no checkpoint {ckpt}")
    train_lines = [ln for ln in lines if ln.startswith("TRAIN")]
    test_lines = [ln for ln in lines if ln.startswith("TEST")]
    if len(train_lines) != n_train or len(test_lines) != 1:
        raise AssertionError(f"fit printed {lines}")
    emit({"phase": "fit", "train_batches": n_train, "test_batches": n_test,
          "launches": fit_launches, "seconds": fit_s,
          "checkpoint_bytes": ckpt_bytes, "lines": lines})
    return launches


def phase_parity():
    """Card (kernels) vs CPU (plain versions) on the same weights and batch,
    float32, reduced size: the eval step, one train step, and the forward
    with index on the same streams."""
    cfg = config_lib.derive(
        "vg", hierarchical_pred=True, run_mode="eval",
        model={"feature_size": 16, "hidden_dim": 8, "num_img_feature": 16,
               "compute_dtype": "float32", "dropout_rate": 0.0},
        data={"max_objects": 6},
        training={"batch_size": 4, "learning_rate": 1e-3,
                  "grad_clip_norm": 5.0})
    sd = weights.init_params(cfg, torch.Generator().manual_seed(1))
    batch = next(synthetic_batches(cfg, 1, seed=5))
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

    # one train step (forward with index, backward kernel, SGD update)
    train_batch = next(synthetic_batches(cfg, 1, seed=6, with_aug=True))
    params, metrics = {}, {}
    for dev in ("cuda", "cpu"):
        model = make_relation_classifier(cfg, device=dev, state_dict=sd)
        opt = engine.make_optimizer(cfg.training.learning_rate,
                                    grad_clip_norm=5.0)
        reset_counts()
        state, met = engine.make_train_step(
            model, cfg, opt, class_weights("vg"), device=dev)(engine.init_train_state(model, opt), train_batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
            if counts != {"pair_pool": 0, "pair_pool_idx": 2,
                          "pair_pool_bwd": 2}:
                raise AssertionError(f"card train step launched {counts}")
        params[dev] = {k: v.detach().cpu() for k, v in state.params.items()}
        metrics[dev] = {k: float(v) for k, v in met.items()}
    param_err = max(float((params["cuda"][k] - params["cpu"][k]).abs().max())
                    for k in params["cpu"])
    if param_err > 1e-4:
        raise AssertionError(f"card vs CPU parameters after a train step: "
                             f"{param_err} > 1e-4")
    metric_err = {}
    for k, v in metrics["cpu"].items():
        if k.startswith("loss"):
            metric_err[k] = abs(metrics["cuda"][k] - v)
            if metric_err[k] > 1e-4 * max(1.0, abs(v)):
                raise AssertionError(f"card vs CPU {k}: {metrics['cuda'][k]}"
                                     f" vs {v}")
        elif metrics["cuda"][k] != v:
            raise AssertionError(f"card vs CPU metric {k}: "
                                 f"{metrics['cuda'][k]} vs {v}")

    # the winner index on equal streams (the CPU's), with exact ties
    model = make_relation_classifier(cfg, device="cpu", state_dict=sd)
    with torch.no_grad():
        b = {k: torch.as_tensor(batch[k]) for k in engine.MODEL_KEYS}
        masks = box_ops.boxes_to_masks(b["boxes"], cfg.model.feature_size,
                                       b["features"].dtype)
        a_s, b_s = model.object_streams_from_image(b["features"],
                                                   b["depth"], masks)
    a_s = a_s.to(torch.bfloat16)
    b_s = b_s.to(torch.bfloat16)
    a_s[:, 0::2] = a_s[:, 1::2]                 # tie the window rows
    b_s[:, 0::2] = b_s[:, 1::2]
    packed = pairs.pack_pairs(pairs.pair_validity(b["valid"]),
                              cfg.pair_capacity)
    want = pair_pool.pair_pool_idx_plain(a_s, b_s, packed.flat_sub,
                                         packed.flat_obj)
    got = pair_pool.pair_pool_idx(a_s.cuda(), b_s.cuda(),
                                  packed.flat_sub.cuda(),
                                  packed.flat_obj.cuda())
    if not all(torch.equal(x.cpu(), y) for x, y in zip(got, want)):
        raise AssertionError("card vs CPU pair_pool_idx differ")
    emit({"phase": "parity", "max_abs_err": errs, "tolerance": 1e-4,
          "live_pairs": int(outs["cpu"]["pair_count"][0]),
          "train_param_max_abs_err": param_err,
          "train_loss_abs_err": metric_err,
          "train_int_metrics_equal": True, "idx_equal": True})


def main():
    ap = argparse.ArgumentParser(description="chip smoke of the port")
    ap.add_argument("--phases", default="kernel,slice,profile,train,parity")
    phases = set(ap.parse_args().phases.split(","))
    info = phase_device()
    phase_build()
    kernel = phase_kernel() if "kernel" in phases else None
    launches = {}
    if {"slice", "profile"} & phases:
        slice_launches, slice_state = phase_slice()
        launches["pair_pool"] = slice_launches["pair_pool"]
        if "profile" in phases:
            phase_profile(*slice_state)
        del slice_state
    if "train" in phases:
        train_launches = phase_train()
        launches["pair_pool_idx"] = train_launches["pair_pool_idx"]
        launches["pair_pool_bwd"] = train_launches["pair_pool_bwd"]
    if "parity" in phases:
        phase_parity()
    if kernel is None or len(launches) != len(KERNELS):
        return 0                                # a partial run: no summary
    rows = [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": kernel[name]["max_abs_err"],
             "ms": kernel[name]["ms"], "plain_ms": kernel[name]["plain_ms"],
             "bound_ms": kernel[name]["bound_ms"],
             "bound_by": kernel[name]["bound_by"], "library_ms": None}
            for name, (_, source, replaces) in KERNELS.items()]
    emit({"kernels": rows})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
