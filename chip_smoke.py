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
  7. featurize: the live DETR-101 featurizer at full width (ResNet-101
              trunk, 6 encoder layers, d_model 256, 8 heads, dim_ff 2048,
              bf16, seeded random weights; the default config, so the
              fused trunk and the encoder kernels run on the card) on
              seeded 1024x1024 images: encode_features of 12 and of 24
              images (CUDA events after a warm-up), with the fused trunk
              and beside it with fused_backbone off (the cuDNN trunk);
              SceneGraphPredictor.predict from 12 images, and
              fit(featurize=...) for 2 steps with both views in one 2B
              dispatch.  Per encode dispatch exactly 1 stem kernel, 30
              stride-1 and 3 stride-2 bottleneck kernels, no stem-pool
              kernel, 6 of each encoder kernel; the pair-pool kernels as on
              their own paths; peak memory; torch.profiler split of both
              trunks, the encoder, the kernels and the relation head, and
              the fused trunk's per-stage split (CUDA events over chained
              prefixes, `upto`).
  8. parity:  the same weights and batch through make_eval_step, and one
              train step, on the card (kernels) and on the CPU (plain
              versions) at a reduced size in float32 with TF32 off: outputs
              and parameters after the step within 1e-4, integer outputs
              and metrics equal, the winner index equal on equal streams;
              encode_features of a 1024x512 image at reduced depth in
              float32 (kernels on the card, plain versions on the CPU)
              within 1e-4; the fused trunk at depth (1, 1, 1, 1), float32,
              on a 1024x512 image (stem, stride-1 and stride-2 kernels) and
              a 1020x508 one (the stem-pool kernel and the odd-size
              fallback) within TRUNK_F32_TOL of the output's scale.
Phase `kernel` also holds the encoder kernels against their plain versions:
attention at (B, 1024, 8, 32) for B = 12 and 24, with all keys valid, 80%
of the keys masked, and one image's keys all masked; FFN + LayerNorm at
N = 12288 and 24576 tokens; each in bf16 (error against a float64 truth at
most 2x the plain version's) and float32 (within ATTN_F32_TOL / FFN_F32_TOL
of the plain version), with SDPA timed beside the attention kernel; and the
trunk kernels at the production shapes (batch 12, 1024^2 images): the stem
at (12, 1024, 1024, 3), the stem pool at (12, 510, 510, 64) (exact), the
stride-1 bottleneck at the five block shapes of the trunk and the stride-2
one at its three transitions, bf16 (2x rule) and float32 (TRUNK_F32_TOL of
the output's scale), each timed beside its plain version and the port's
unfused counterpart (`unfused_ms`: cuDNN convolutions and their passes).
Then a {"kernels": [...]} line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Uses no JAX.

    python3 chip_smoke.py [--phases kernel,train,...]

runs the named phases only (device and build always run; the summary lines
need all phases).
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from scene_graph_commonsense_torch import bench
from scene_graph_commonsense_torch import config as config_lib
from scene_graph_commonsense_torch.__main__ import synthetic_batches
from scene_graph_commonsense_torch.constants import class_weights
from scene_graph_commonsense_torch.data.artifacts import load_vg_artifacts
from scene_graph_commonsense_torch.data.synthetic import (
    synthetic_batch, synthetic_images)
from scene_graph_commonsense_torch.device import disable_tf32
from scene_graph_commonsense_torch.eval import engines
from scene_graph_commonsense_torch.inference import SceneGraphPredictor
from scene_graph_commonsense_torch.models import detr as detr_lib
from scene_graph_commonsense_torch.models import resnet_fused
from scene_graph_commonsense_torch.models import weights
from scene_graph_commonsense_torch.models.relation_head import (
    make_relation_classifier)
from scene_graph_commonsense_torch.ops import _build, pair_pool, pairs
from scene_graph_commonsense_torch.ops import attention, ffn
from scene_graph_commonsense_torch.ops import bottleneck, stem
from scene_graph_commonsense_torch.ops import boxes as box_ops
from scene_graph_commonsense_torch.train import engine
from scene_graph_commonsense_torch.train import loop

# published H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
# exponentials (ex2 on the special function units): 16 per clock per SM on
# compute capability 9.0 (CUDA C++ programming guide, arithmetic
# instruction throughput), times the 132 SMs and the card's maximum SM
# clock as nvidia-smi reports it in this run
EXP_PER_CLOCK_PER_SM = 16
H100_SMS = 132
# tolerances of the encoder kernels against their plain versions in float32
# (sums of 32 / 256 and 2048 products taken in another order; the FFN's
# LayerNorm divides by the row's deviation)
ATTN_F32_TOL = 1e-5
FFN_F32_TOL = 5e-5
# the trunk kernels in float32 against their plain versions, relative to
# the output's scale (max |plain|): sums of up to 9 * 512 products in
# another order, each rounded once in float32 (~1e-6 relative)
TRUNK_F32_TOL = 1e-5
# the port's kernels: the module holding the launch counter, the counter,
# source, the TPU kernel it replaces
SOURCE = "scene_graph_commonsense_torch/csrc/pair_pool.cu"
PALLAS = "scene_graph_commonsense_tpu/ops/pallas/"
KERNELS = {
    "pair_pool": (pair_pool, "launches", SOURCE, PALLAS + "pair_pool.py:42"),
    "pair_pool_idx": (pair_pool, "idx_launches", SOURCE,
                      PALLAS + "pair_pool.py:47"),
    "pair_pool_bwd": (pair_pool, "bwd_launches", SOURCE,
                      PALLAS + "pair_pool.py:149"),
    "ffn_ln": (ffn, "launches", "scene_graph_commonsense_torch/csrc/ffn.cu",
               PALLAS + "ffn.py:34"),
    "attention": (attention, "launches",
                  "scene_graph_commonsense_torch/csrc/attention.cu",
                  PALLAS + "attention.py:36"),
    "stem_conv_pool": (stem, "conv_pool_launches",
                       "scene_graph_commonsense_torch/csrc/stem.cu",
                       PALLAS + "stem.py:55"),
    "stem_pool": (stem, "pool_launches",
                  "scene_graph_commonsense_torch/csrc/stem.cu",
                  PALLAS + "stem.py:172"),
    "bottleneck": (bottleneck, "launches",
                   "scene_graph_commonsense_torch/csrc/bottleneck.cu",
                   PALLAS + "bottleneck.py:78"),
    "bottleneck_s2": (bottleneck, "s2_launches",
                      "scene_graph_commonsense_torch/csrc/bottleneck.cu",
                      PALLAS + "bottleneck.py:145"),
}
# launches of each trunk and encoder kernel per encode dispatch at 1024^2
# with the fused trunk: the stem, 30 stride-1 blocks, 3 transitions, and
# one attention and one FFN per encoder layer
PER_ENCODE = {"stem_conv_pool": 1, "bottleneck": 30, "bottleneck_s2": 3,
              "ffn_ln": 6, "attention": 6}


PAIR_POOL_KERNELS = ("pair_pool", "pair_pool_idx", "pair_pool_bwd")


def reset_counts():
    for module, counter, _, _ in KERNELS.values():
        setattr(module, counter, 0)


def read_counts():
    return {name: getattr(module, counter)
            for name, (module, counter, _, _) in KERNELS.items()}


def expected(**counts):
    """A full launch-count dict: the named counts, 0 for every other
    kernel."""
    return {name: counts.get(name, 0) for name in KERNELS}


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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    max_sm_mhz = float(smi.stdout.strip().splitlines()[0])
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": card,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "max_sm_clock_mhz": max_sm_mhz,
            "exp_per_s": EXP_PER_CLOCK_PER_SM * H100_SMS * max_sm_mhz * 1e6}
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
    max_err = {name: 0.0 for name in PAIR_POOL_KERNELS}
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
                                                 "bound_ms", "bound_by")},
                   "library_ms": None}
            for name in PAIR_POOL_KERNELS}


def bound_terms(nbytes, **op_seconds):
    """Least time for `nbytes` of device-memory traffic and operation
    counts already divided by their peak rates (name -> seconds): the
    larger of the two, and which one bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, max(op_seconds.values())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes,
            "op_ms": {k: v * 1e3 for k, v in op_seconds.items()}}


def product_rate(dtype):
    """Peak rate of the products a kernel does in `dtype`: the bf16 tensor
    cores, or float32 FMAs outside them (the port's float32 kernels)."""
    return BF16_TENSOR_OPS_PER_S if dtype == torch.bfloat16 \
        else FP32_OPS_PER_S


def attention_bound(q, valid, exp_per_s):
    """q, k, v read and out written once, the key mask read once; the two
    products (4 B H L^2 dh operations) at the peak rate of their dtype; one
    exponential per score."""
    b, l, h, dh = q.shape
    nbytes = 4 * q.numel() * q.element_size() + valid.numel()
    flops = 4 * b * h * l * l * dh
    exps = b * h * l * l
    return {**bound_terms(nbytes, products=flops / product_rate(q.dtype),
                          exponentials=exps / exp_per_s),
            "flops": flops, "exponentials": exps}


def ffn_bound(x, w1):
    """x read and y written once (float32), both weight matrices and the
    four vectors read once; 4 N D F operations of products at the peak rate
    of the weights' dtype."""
    n, d = x.shape
    f = w1.shape[1]
    nbytes = 2 * x.numel() * 4 + 2 * w1.numel() * w1.element_size() \
        + (f + 3 * d) * 4
    flops = 4 * n * d * f
    return {**bound_terms(nbytes, products=flops / product_rate(w1.dtype)),
            "flops": flops}


def close(got, want, tol):
    """max |got - want| / (tol (1 + |want|)): <= 1 means within atol and
    rtol `tol`."""
    return float(((got.float() - want.float()).abs()
                  / (tol * (1 + want.float().abs()))).max())


def attention_truth(q, k, v, valid, scale):
    """float64 attention of the same inputs with the kernel's -3e38 key
    fill (so an image whose keys are all masked is uniform)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(attention.MASK_FILL, dtype=torch.float64,
                                 device=s.device))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                        v.double())


def ffn_truth(x, w1, b1, w2, b2, g, beta):
    """float64 FFN + LayerNorm with the kernel's roundings of x and h to
    the weights' dtype, exact sums."""
    cd, f64 = w1.dtype, torch.float64
    h = torch.relu(x.to(cd).to(f64) @ w1.to(f64) + b1.to(f64))
    y = h.to(cd).to(f64) @ w2.to(f64) + b2.to(f64) + x.to(f64)
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    return (y - mu) / torch.sqrt(var + 1e-5) * g.to(f64) + beta.to(f64)


def check_bf16(name, got, want, truth):
    """The kernel's largest error against the float64 truth is at most 2x
    the plain version's."""
    err = (got.double() - truth).abs().max().item()
    plain_err = (want.double() - truth).abs().max().item()
    if not err <= 2 * plain_err + 1e-6:
        raise AssertionError(f"{name}: bf16 error against float64 {err} > "
                             f"2 x the plain version's {plain_err}")
    return {"err_vs_f64": err, "plain_err_vs_f64": plain_err}


def phase_kernel_encoder(exp_per_s):
    """The encoder kernels vs their plain versions at the DETR shapes, B =
    12 (the serving batch) and 24 (fit's two views in one dispatch).
    Returns, per kernel, the numbers of the main path's case (bf16, B = 12,
    all keys valid as the encoder passes them)."""
    dev = torch.device("cuda")
    disable_tf32()
    gen = torch.Generator(device=dev).manual_seed(1)
    scale = 1.0 / math.sqrt(32)
    main, max_err = {}, {"attention": 0.0, "ffn_ln": 0.0}
    for b in (12, 24):
        l = 1024
        qkv32 = [torch.randn((b, l, 8, 32), device=dev, generator=gen)
                 for _ in range(3)]
        masks = {"all_valid": torch.ones((b, l), dtype=torch.bool,
                                         device=dev),
                 "random_80pct_masked": torch.rand(
                     (b, l), device=dev, generator=gen) >= 0.8,
                 "one_image_masked": torch.ones((b, l), dtype=torch.bool,
                                                device=dev)}
        masks["random_80pct_masked"][:, 0] = True
        masks["one_image_masked"][0] = False
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in qkv32)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            for mask_name, valid in masks.items():
                got = attention.attention_kernel(q, k, v, valid, scale=scale)
                want = attention.attention_plain(q, k, v, valid, scale=scale)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                rec = {"b": b, "l": l, "h": 8, "dh": 32, "mask": mask_name,
                       "dtype": str(dtype).split(".")[1],
                       "max_abs_err": err}
                if dtype == torch.float32:
                    ratio = close(got, want, ATTN_F32_TOL)
                    if ratio > 1:
                        raise AssertionError(
                            f"attention kernel vs plain ({mask_name}, f32, "
                            f"B={b}): {ratio:.3g} x the tolerance")
                    rec["max_err_over_tol"] = ratio
                else:
                    rec.update(check_bf16(
                        f"attention ({mask_name}, B={b})", got, want,
                        attention_truth(q, k, v, valid, scale)))
                if mask_name == "one_image_masked":
                    uniform = v[0].float().mean(dim=0).expand_as(got[0])
                    uerr = (got[0].float() - uniform).abs().max().item()
                    if uerr > (2e-2 if dtype == torch.bfloat16 else 1e-5):
                        raise AssertionError(
                            f"attention: a fully masked image is not "
                            f"uniform ({uerr})")
                    rec["masked_image_uniform_err"] = uerr
                del got, want
                sdpa_mask = valid[:, None, None, :]
                rec.update(timed(
                    lambda: attention.attention_kernel(q, k, v, valid,
                                                       scale=scale),
                    lambda: attention.attention_plain(q, k, v, valid,
                                                      scale=scale)))
                rec["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=sdpa_mask, scale=scale), 10)
                rec["library"] = "F.scaled_dot_product_attention"
                rec.update(attention_bound(q, valid, exp_per_s))
                max_err["attention"] = max(max_err["attention"], err)
                emit({"phase": "kernel", "name": "attention", **rec})
                if b == 12 and dtype == torch.bfloat16 \
                        and mask_name == "all_valid":
                    main["attention"] = rec
                torch.cuda.empty_cache()
        del qkv32, masks

    for n in (12288, 24576):
        x = torch.randn((n, 256), device=dev, generator=gen)
        w1 = torch.randn((256, 2048), device=dev, generator=gen) / 16
        w2 = torch.randn((2048, 256), device=dev, generator=gen) \
            / math.sqrt(2048)
        b1 = torch.randn(2048, device=dev, generator=gen)
        b2 = torch.randn(256, device=dev, generator=gen)
        g = 1 + 0.1 * torch.randn(256, device=dev, generator=gen)
        beta = 0.1 * torch.randn(256, device=dev, generator=gen)
        for dtype in (torch.bfloat16, torch.float32):
            w1c, w2c = w1.to(dtype), w2.to(dtype)
            args = (x, w1c, b1, w2c, b2, g, beta)
            got = ffn.ffn_ln_kernel(*args)
            want = ffn.ffn_ln_plain(*args, compute_dtype=dtype)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rec = {"n": n, "d": 256, "f": 2048,
                   "dtype": str(dtype).split(".")[1], "max_abs_err": err}
            if dtype == torch.float32:
                ratio = close(got, want, FFN_F32_TOL)
                if ratio > 1:
                    raise AssertionError(f"ffn_ln kernel vs plain (f32, "
                                         f"N={n}): {ratio:.3g} x the "
                                         f"tolerance")
                rec["max_err_over_tol"] = ratio
            else:
                rec.update(check_bf16(f"ffn_ln (N={n})", got, want,
                                      ffn_truth(*args)))
            del got, want
            rec.update(timed(lambda: ffn.ffn_ln_kernel(*args),
                             lambda: ffn.ffn_ln_plain(*args,
                                                      compute_dtype=dtype)))
            rec["library_ms"] = None    # no single PyTorch call computes it
            rec.update(ffn_bound(x, w1c))
            max_err["ffn_ln"] = max(max_err["ffn_ln"], err)
            emit({"phase": "kernel", "name": "ffn_ln", **rec})
            if n == 12288 and dtype == torch.bfloat16:
                main["ffn_ln"] = rec
        torch.cuda.empty_cache()
    return {name: {"max_abs_err": max_err[name],
                   **{k: main[name][k] for k in (
                       "ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms")}}
            for name in ("ffn_ln", "attention")}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bottleneck_bound(x, blk, out):
    """x read, y written, the weights and folds read once; the products of
    conv1 on every input pixel, conv2, conv3 and the projection on every
    output pixel at the peak rate of x's dtype."""
    b, h, w, c = x.shape
    m, co = blk.w1.shape[1], blk.w3.shape[1]
    p_in, p_out = b * h * w, out.numel() // co
    flops = 2 * (p_in * c * m + p_out * (9 * m * m + m * co
                                         + (c * co if blk.wd is not None
                                            else 0)))
    moved = nbytes(x, out, *blk.args())
    return {**bound_terms(moved, products=flops / product_rate(x.dtype)),
            "flops": flops}


def stem_bound(images, w7, fold, out):
    """The float32 images, kernel and fold read once, the pooled output
    written once; 2 x 147 x 64 operations per conv output pixel at the
    peak rate of the compute dtype."""
    b, h, w, _ = images.shape
    flops = 2 * b * (h // 2) * (w // 2) * 147 * 64
    return {**bound_terms(nbytes(images, w7, fold, out),
                          products=flops / product_rate(w7.dtype)),
            "flops": flops}


def stem_pool_bound(x, fold, out):
    """x read and out written once; a multiply, an add and a max with 0 per
    input element and 8 maxes per output element, float32."""
    ops = 3 * x.numel() + 8 * out.numel()
    return bound_terms(nbytes(x, fold, out), elementwise=ops / FP32_OPS_PER_S)


def random_bottleneck(cin, m, stride, proj, gen, dev):
    """A port Bottleneck with seeded random weights and frozen-BN
    statistics (so that the folds are not trivial)."""
    blk = detr_lib.Bottleneck(cin, m, stride, downsample=proj)
    with torch.no_grad():
        for mod in blk.modules():
            if isinstance(mod, torch.nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0, fan_in ** -0.5, generator=gen)
            elif isinstance(mod, detr_lib.FrozenBatchNorm):
                mod.weight.uniform_(0.5, 1.5, generator=gen)
                mod.bias.normal_(0, 0.2, generator=gen)
                mod.running_mean.normal_(0, 0.5, generator=gen)
                mod.running_var.uniform_(0.5, 2.0, generator=gen)
    return blk.to(dev).eval().requires_grad_(False)


def bottleneck_truth(x, blk, stride):
    """float64 block with the kernel's roundings of a and b to x's dtype,
    exact sums."""
    cd, f = x.dtype, torch.float64
    w1, s1, w2, s2, w3, s3, wd, sd = (None if t is None else t.to(f)
                                      for t in blk.args())
    xf = x.to(f)
    a = torch.relu(xf @ w1 * s1[0] + s1[1]).to(cd).to(f)
    acc = F.conv2d(a.permute(0, 3, 1, 2), w2.permute(3, 2, 0, 1),
                   stride=stride, padding=1).permute(0, 2, 3, 1)
    b = torch.relu(acc * s2[0] + s2[1]).to(cd).to(f)
    c = b @ w3 * s3[0] + s3[1]
    idn = xf if wd is None else xf[:, ::stride, ::stride] @ wd * sd[0] + sd[1]
    return torch.relu(c + idn)


def stem_truth(images, w7, fold):
    """float64 stem on the compute-dtype-rounded images and kernel, exact
    sums."""
    f = torch.float64
    x = images.to(w7.dtype).to(f).permute(0, 3, 1, 2)
    conv = F.conv2d(x, w7.to(f).permute(3, 2, 0, 1), stride=2, padding=3)
    s = fold.to(f)
    v = torch.relu(conv * s[0][:, None, None] + s[1][:, None, None])
    return F.max_pool2d(v, 3, 2, 1).permute(0, 2, 3, 1)


def check_trunk_kernel(name, got, want, truth_fn):
    """float32: within TRUNK_F32_TOL of the output's scale; bf16: at most 2x
    the plain version's error against the float64 truth."""
    err = (got.float() - want.float()).abs().max().item()
    rec = {"max_abs_err": err}
    if got.dtype == torch.float32:
        ratio = err / (TRUNK_F32_TOL * want.abs().max().item())
        if ratio > 1:
            raise AssertionError(f"{name}: float32 kernel vs plain "
                                 f"{ratio:.3g} x the tolerance")
        rec["max_err_over_tol"] = ratio
    else:
        rec.update(check_bf16(name, got, want, truth_fn()))
    return rec


# the trunk's stride-1 blocks at 1024^2, batch 12: (name, H, W, C_in, M,
# projection, launches per encode); C_out = 4 M
K3_CASES = (("layer1_0", 256, 256, 64, 64, True, 1),
            ("layer1_1", 256, 256, 256, 64, False, 2),
            ("layer2", 128, 128, 512, 128, False, 3),
            ("layer3", 64, 64, 1024, 256, False, 22),
            ("layer4", 32, 32, 2048, 512, False, 2))
# the transitions: (name, H, W, C_in, M)
K4_CASES = (("layer2_0", 256, 256, 256, 128), ("layer3_0", 128, 128, 512, 256),
            ("layer4_0", 64, 64, 1024, 512))


def _launch_mean(recs, weights_, key):
    return sum(r[key] * n for r, n in zip(recs, weights_)) / sum(weights_)


def phase_kernel_trunk():
    """The trunk kernels vs their plain versions at the production shapes
    (batch 12, 1024^2 images; K6 at the stem conv output of 1020^2 images),
    bf16 and float32, each timed beside its plain version and the port's
    unfused counterpart (cuDNN and its passes).  Returns, per kernel, the
    bf16 numbers as a mean per launch over one encode's launches (K6: its
    one case)."""
    dev = torch.device("cuda")
    disable_tf32()
    gen = torch.Generator(device=dev).manual_seed(3)
    cpu_gen = torch.Generator().manual_seed(4)
    b = 12
    summary = {}

    def timing(kernel_fn, plain_fn, unfused_fn, dtype):
        few = dtype == torch.float32
        rec = timed(kernel_fn, plain_fn, plain_iters=2 if few else 3,
                    kernel_iters=3 if few else 10)
        rec["unfused_ms"] = cuda_ms(unfused_fn, 3)
        return rec

    # K5: the whole stem at (12, 1024, 1024, 3)
    net = detr_lib.ResNet101((0, 0, 0, 0))
    with torch.no_grad():
        net.conv1.weight.normal_(0, 147 ** -0.5, generator=cpu_gen)
        net.bn1.running_var.uniform_(0.5, 2.0, generator=cpu_gen)
        net.bn1.bias.normal_(0, 0.2, generator=cpu_gen)
    net = net.to(dev).requires_grad_(False)
    images = torch.randn((b, 1024, 1024, 3), device=dev, generator=gen)
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        prep = resnet_fused.prepared(net, dtype)
        args = (images, prep.stem_w7, prep.stem_fold)
        got = stem.stem_conv_pool_kernel(*args)
        want = stem.stem_conv_pool_plain(*args, compute_dtype=dtype)
        torch.cuda.synchronize()
        rec = {"shape": list(images.shape), "dtype": str(dtype)[6:],
               **check_trunk_kernel("stem_conv_pool", got, want,
                                    lambda: stem_truth(*args)),
               **timing(lambda: stem.stem_conv_pool_kernel(*args),
                        lambda: stem.stem_conv_pool_plain(
                            *args, compute_dtype=dtype),
                        lambda: net(images, dtype), dtype),
               "library_ms": None, **stem_bound(*args, got)}
        del got, want
        emit({"phase": "kernel", "name": "stem_conv_pool", **rec})
        recs.append(rec)
    summary["stem_conv_pool"] = {**recs[0], "max_abs_err": max(
        r["max_abs_err"] for r in recs)}
    del images, net
    torch.cuda.empty_cache()

    # K6: BN + ReLU + pool of the stem conv output of 1020^2 images
    bn = detr_lib.FrozenBatchNorm(64)
    with torch.no_grad():
        bn.running_var.uniform_(0.5, 2.0, generator=cpu_gen)
        bn.bias.normal_(0, 0.2, generator=cpu_gen)
    bn = bn.to(dev)
    fold = bottleneck.fold_bn(bn)
    conv32 = torch.randn((b, 510, 510, 64), device=dev, generator=gen)
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        conv = conv32.to(dtype)
        got = stem.stem_pool_kernel(conv, fold)
        want = stem.stem_pool_plain(conv, fold)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"stem_pool kernel != plain ({dtype}): "
                                 f"{(got.float() - want.float()).abs().max()}")
        nchw = conv.permute(0, 3, 1, 2)
        rec = {"shape": list(conv.shape), "dtype": str(dtype)[6:],
               "max_abs_err": 0.0, "exact": True,
               **timing(lambda: stem.stem_pool_kernel(conv, fold),
                        lambda: stem.stem_pool_plain(conv, fold),
                        lambda: F.max_pool2d(torch.relu(bn(nchw, dtype)),
                                             3, 2, 1), dtype),
               "library_ms": None, **stem_pool_bound(conv, fold, got)}
        del got, want
        emit({"phase": "kernel", "name": "stem_pool", **rec})
        recs.append(rec)
    summary["stem_pool"] = recs[0]
    del conv32, conv
    torch.cuda.empty_cache()

    # K3 and K4 at the trunk's shapes
    for name, cases, stride in (("bottleneck", K3_CASES, 1),
                                ("bottleneck_s2", K4_CASES, 2)):
        main, counts, max_err = [], [], 0.0
        for case in cases:
            label, h, w, cin, m = case[:5]
            proj = case[5] if stride == 1 else True
            mod = random_bottleneck(cin, m, stride, proj, cpu_gen, dev)
            x32 = torch.randn((b, h, w, cin), device=dev, generator=gen)
            kernel = bottleneck.bottleneck_kernel if stride == 1 \
                else bottleneck.bottleneck_s2_kernel
            plain = bottleneck.fused_bottleneck_plain if stride == 1 \
                else bottleneck.fused_bottleneck_s2_plain
            for dtype in (torch.bfloat16, torch.float32):
                blk = resnet_fused.prepare_block(mod, stride, dtype)
                x = x32.to(dtype)
                got = kernel(x, *blk.args())
                want = plain(x, *blk.args())
                torch.cuda.synchronize()
                rec = {"case": label, "shape": list(x.shape), "m": m,
                       "co": 4 * m, "dtype": str(dtype)[6:],
                       **check_trunk_kernel(
                           f"{name} {label}", got, want,
                           lambda: bottleneck_truth(x, blk, stride)),
                       "library_ms": None, **bottleneck_bound(x, blk, got)}
                del got, want
                x_nchw = x.permute(0, 3, 1, 2)
                rec.update(timing(lambda: kernel(x, *blk.args()),
                                  lambda: plain(x, *blk.args()),
                                  lambda: mod(x_nchw, dtype), dtype))
                emit({"phase": "kernel", "name": name, **rec})
                max_err = max(max_err, rec["max_abs_err"])
                if dtype == torch.bfloat16:
                    main.append(rec)
                    counts.append(case[6] if stride == 1 else 1)
                del x, x_nchw, blk
                torch.cuda.empty_cache()
            del mod, x32
        # per launch over one encode: the launch-weighted means, bound by
        # what bounds the case with the most launches
        summary[name] = {
            "max_abs_err": max_err,
            "bound_by": main[counts.index(max(counts))]["bound_by"],
            **{k: _launch_mean(main, counts, k) for k in (
                "ms", "plain_ms", "unfused_ms", "bound_ms")},
            "library_ms": None}
    return {name: {k: rec[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "unfused_ms")} for name, rec in summary.items()}


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
    expect = expected(pair_pool=len(batches))
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


def device_profile(fn, n, top_ops=16, groups=None):
    """torch.profiler over fn(): device busy share of the wall time, kernels
    by name, operators by input shape, per call of n; with `groups` (label
    -> substring of a kernel name) also each group's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        # a tiny kernel first: the trace at times lacks the window's first
        # kernel (seen with the fused trunk's stem kernel)
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
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
    grouped = {label: sum(t for name, t in kernels.items() if part in name)
               / 1e3 / n for label, part in (groups or {}).items()}

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
            "group_ms_per_call": grouped,
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
    expect = expected(pair_pool_idx=2 * steps, pair_pool_bwd=2 * steps)
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
    expect = expected(pair_pool=n_test + 2, pair_pool_idx=2 * n_train,
                      pair_pool_bwd=2 * n_train)
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


def image_batches(rng, n, batch_size, image_size, with_aug):
    """n request/train batches of seeded normalised images with synthetic
    VG objects (no features: the featurizer computes them)."""
    for _ in range(n):
        b = synthetic_batch(rng, batch_size=batch_size, max_objects=20,
                            with_aug=False)
        del b["features"]
        yield {**b, **synthetic_images(rng, batch_size, image_size,
                                       with_aug=with_aug)}


def phase_featurize():
    """The live DETR-101 featurizer at full width through the port's entry
    points, with the default config (fused trunk and encoder kernels on the
    card).  Returns the trunk and encoder kernels' launches over one
    serving call (predict from 12 images)."""
    torch.cuda.empty_cache()
    cfg = config_lib.derive("vg", hierarchical_pred=True, run_mode="eval",
                            training={"batch_size": 12})
    log = []
    t0 = time.perf_counter()
    featurize, detr = loop.load_detr_featurizer(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0),
        log_fn=log.append)
    init_s = time.perf_counter() - t0
    if not (log and log[0].startswith("WARNING")):
        raise AssertionError(f"expected the random-weights warning: {log}")
    if not (detr.fused_backbone and detr.flash_encoder) \
            or detr.backbone.blocks != (3, 4, 23, 3) \
            or len(detr.encoder_layers()) != 6:
        raise AssertionError("not the full DETR-101 with fused_backbone and "
                             "flash_encoder on")
    size = cfg.model.image_size
    rng = np.random.default_rng(21)
    images = synthetic_images(rng, 12, size)
    x12 = torch.from_numpy(images["image"]).cuda()
    x24 = torch.cat([x12, torch.from_numpy(images["image_aug"]).cuda()])

    def encode(x):
        with torch.inference_mode():
            return detr.encode_features(x)

    def trunk(x, upto=None):
        with torch.inference_mode():
            if detr.fused_backbone:
                return resnet_fused.resnet_forward_fused(
                    detr.backbone, x, detr.dtype, upto=upto)
            return detr.backbone(x, detr.dtype)

    def per_encode(n, **extra):
        return expected(**{k: v * n for k, v in PER_ENCODE.items()}, **extra)

    timing, timing_unfused = {}, {}
    for fused, name, x in ((True, "encode_12", x12), (True, "encode_24", x24),
                           (False, "encode_12", x12),
                           (False, "encode_24", x24)):
        detr.fused_backbone = fused                     # off: the cuDNN trunk
        feats = encode(x)                               # warm-up
        torch.cuda.synchronize()
        s = cfg.model.feature_size
        if feats.shape != (x.shape[0], s, s, 256) \
                or feats.dtype != torch.float32 \
                or not bool(torch.isfinite(feats).all()):
            raise AssertionError(f"{name}: features {tuple(feats.shape)} "
                                 f"{feats.dtype}, finite "
                                 f"{bool(torch.isfinite(feats).all())}")
        del feats
        reps = 3
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            encode(x)
        end.record()
        torch.cuda.synchronize()
        counts = read_counts()
        want = per_encode(reps) if fused \
            else expected(ffn_ln=6 * reps, attention=6 * reps)
        if counts != want:
            raise AssertionError(f"{name} (fused trunk {fused}): launches "
                                 f"over {reps} encodes {counts}, expected "
                                 f"{want}")
        ms = start.elapsed_time(end) / reps
        (timing if fused else timing_unfused)[name] = {
            "ms": ms, "ms_per_image": ms / x.shape[0],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts}

    # where the time of one encode of 12 goes: the unfused trunk, then the
    # fused one (the rest of the phase runs fused)
    prof_trunk_unfused = device_profile(lambda: trunk(x12), 1)
    detr.fused_backbone = True
    kernel_groups = {"attention": "attention_tc_kernel",
                     "ffn_ln": "ffn_ln_tc_kernel",
                     "bottleneck": "bottleneck_kernel",
                     "stem_conv_pool": "stem_conv_pool_kernel"}
    prof_trunk = device_profile(lambda: trunk(x12), 1, groups=kernel_groups)
    prof_encode = device_profile(lambda: encode(x12), 1,
                                 groups=kernel_groups)
    # the fused trunk's stages: CUDA-event times of its chained prefixes
    prefix_ms = {u: cuda_ms(lambda u=u: trunk(x12, upto=u), 3)
                 for u in ("stem", "layer1", "layer2", "layer3", "layer4")}
    stages, before = {}, 0.0
    for u, ms in prefix_ms.items():
        stages[u] = ms - before
        before = ms

    # serving: SceneGraphPredictor.predict from 12 images
    model = make_relation_classifier(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    predictor = SceneGraphPredictor(cfg, model, detr_model=detr,
                                    device="cuda")
    request = next(image_batches(rng, 1, 12, size, with_aug=False))
    predictor.predict(request, top_k=50)                # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    graphs = predictor.predict(request, top_k=50)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    predict_launches = read_counts()
    if predict_launches != per_encode(1, pair_pool=1):
        raise AssertionError(f"predict from images launched "
                             f"{predict_launches}")
    if len(graphs) != 12 or not sum(len(g) for g in graphs):
        raise AssertionError("the predictor returned no edges")
    if not all(np.isfinite(e["confidence"]) for g in graphs for e in g):
        raise AssertionError("non-finite edge confidences")
    features = featurize({"image": request["image"]})["features"]
    head_batch = {**{k: v for k, v in request.items() if k != "image"},
                  "features": features,
                  "rel": np.full((12, 20, 20), -1, np.int32)}
    prof_head = device_profile(lambda: predictor.estep(head_batch), 1)
    encode_ms = prof_encode["device_ms_per_call"]
    trunk_ms = prof_trunk["device_ms_per_call"]
    kern = prof_encode["group_ms_per_call"]
    split = {"trunk_ms": trunk_ms,
             "trunk_unfused_ms": prof_trunk_unfused["device_ms_per_call"],
             "trunk_stage_ms": stages,
             "bottleneck_kernels_ms": kern["bottleneck"],
             "stem_kernel_ms": kern["stem_conv_pool"],
             "encoder_ms": encode_ms - trunk_ms,
             "attention_kernel_ms": kern["attention"],
             "ffn_ln_kernel_ms": kern["ffn_ln"],
             "encoder_rest_ms": encode_ms - trunk_ms - kern["attention"]
             - kern["ffn_ln"],
             "relation_head_ms": prof_head["device_ms_per_call"]}
    del features, head_batch, predictor
    torch.cuda.empty_cache()

    # training: fit with the featurizer, 2 steps, both views in one
    # 2B dispatch per step
    with tempfile.TemporaryDirectory() as tmp:
        fcfg = bench.bench_config(
            num_epoch=1, print_freq=1, eval_freq=0,
            checkpoint_path=os.path.join(tmp, "ck"),
            result_path=os.path.join(tmp, "res"))
        fmodel = make_relation_classifier(
            fcfg, device="cuda", generator=torch.Generator().manual_seed(1))
        steps, lines = 2, []
        reset_counts()
        t0 = time.perf_counter()
        loop.fit(fcfg, fmodel,
                 lambda e: image_batches(np.random.default_rng(30 + e),
                                         steps, 12, size, with_aug=True),
                 None, steps_per_epoch=steps,
                 artifacts=load_vg_artifacts("datasets/artifacts"),
                 device="cuda", featurize=loop.make_detr_featurize_fn(
                     fcfg, detr), log_fn=lines.append)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = read_counts()
    expect = per_encode(steps, pair_pool_idx=2 * steps,
                        pair_pool_bwd=2 * steps)
    if fit_launches != expect:
        raise AssertionError(f"fit(featurize=) launched {fit_launches}, "
                             f"expected {expect}")
    train_lines = [ln for ln in lines if ln.startswith("TRAIN")]
    if len(train_lines) != steps or any("nan" in ln.lower()
                                        for ln in train_lines):
        raise AssertionError(f"fit printed {lines}")
    emit({"phase": "featurize", "batch_size": 12, "image_size": size,
          "compute_dtype": cfg.model.compute_dtype,
          "fused_backbone": cfg.model.fused_backbone,
          "flash_encoder": cfg.model.flash_encoder,
          "resolved": dict(zip(("fused_backbone", "flash_encoder"),
                               detr_lib.resolve_detr_modes(
                                   cfg, torch.device("cuda")))),
          "weights": log[0], "init_s": init_s, **timing,
          "fused_backbone_off": timing_unfused,
          "predict_s": predict_s, "predict_launches": predict_launches,
          "predict_edges": sum(len(g) for g in graphs),
          "device_split_encode_12": split,
          "profile_encode_12": prof_encode, "profile_trunk_12": prof_trunk,
          "profile_trunk_unfused_12": prof_trunk_unfused,
          "profile_relation_head": prof_head,
          "fit_steps": steps, "fit_s": fit_s, "fit_launches": fit_launches,
          "fit_lines": lines})
    del detr, fmodel
    torch.cuda.empty_cache()
    return {k: predict_launches[k] for k in PER_ENCODE}


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
            if counts != expected(pair_pool_idx=2, pair_pool_bwd=2):
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

    # encode_features at reduced depth, 1024x512 (L = 512: every encoder
    # layer runs the kernels on the card, the plain versions on the CPU)
    dcfg = config_lib.derive("vg", model={
        "detr_blocks": (1, 1, 1, 1), "detr_enc_layers": 2,
        "compute_dtype": "float32", "flash_encoder": "on"})
    sd = weights.init_detr_params(dcfg, torch.Generator().manual_seed(2))
    image = synthetic_images(np.random.default_rng(40), 1, 1024,
                             with_aug=False)["image"][:, :, :512].copy()
    mask = np.ones((1, 1024, 512), bool)
    mask[0, :, 400:] = False
    feats = {}
    for dev in ("cuda", "cpu"):
        detr = detr_lib.make_detr(dcfg, device=dev, state_dict=sd)
        reset_counts()
        with torch.inference_mode():
            feats[dev] = detr.encode_features(
                torch.from_numpy(image).to(dev),
                torch.from_numpy(mask).to(dev)).cpu()
        if dev == "cuda" and read_counts() != expected(ffn_ln=2,
                                                       attention=2):
            raise AssertionError(f"card encode launched {read_counts()}")
    enc_err = float((feats["cuda"] - feats["cpu"]).abs().max())
    if not enc_err <= 1e-4:
        raise AssertionError(f"card vs CPU encode_features: {enc_err} > "
                             f"1e-4")
    emit({"phase": "parity_encode", "image": [1024, 512], "tokens": 512,
          "detr_blocks": [1, 1, 1, 1], "encoder_layers": 2,
          "max_abs_err": enc_err, "tolerance": 1e-4})
    return phase_parity_trunk()


def phase_parity_trunk():
    """The fused trunk on the card (kernels) and on the CPU (plain
    versions), float32, blocks (1, 1, 1, 1) at full width, seeded random
    weights and frozen-BN statistics, on a 1024x512 image (the stem
    kernel, K3, K4 at every transition) and a 1020x508 one (the plain stem
    conv and K6, the plain fallback at the odd layer2 transition, K3, K4).
    Returns K6's launches."""
    blocks = (1, 1, 1, 1)
    tcfg = config_lib.derive("vg", model={"detr_blocks": blocks,
                                          "compute_dtype": "float32"})
    gen = torch.Generator().manual_seed(9)
    sd = {}
    for k, v in weights.init_detr_params(tcfg, gen).items():
        if not k.startswith("backbone."):
            continue
        if k.endswith("running_var") or k.endswith(".weight") and v.dim() == 1:
            v = torch.empty_like(v).uniform_(0.5, 2.0, generator=gen)
        elif k.endswith("running_mean") or k.endswith(".bias"):
            v = torch.empty_like(v).normal_(0, 0.2, generator=gen)
        sd[k.removeprefix("backbone.")] = v
    nets = {}
    for dev in ("cuda", "cpu"):
        nets[dev] = detr_lib.ResNet101(blocks).to(dev)
        nets[dev].load_state_dict(sd)
        nets[dev].requires_grad_(False)
    full = synthetic_images(np.random.default_rng(41), 1, 1024,
                            with_aug=False)["image"]
    cases = (((1024, 512), expected(stem_conv_pool=1, bottleneck=1,
                                    bottleneck_s2=3)),
             ((1020, 508), expected(stem_pool=1, bottleneck=1,
                                    bottleneck_s2=2)))
    k6 = 0
    for (h, w), want in cases:
        image = torch.from_numpy(full[:, :h, :w].copy())
        outs = {}
        for dev in ("cuda", "cpu"):
            reset_counts()
            with torch.inference_mode():
                outs[dev] = resnet_fused.resnet_forward_fused(
                    nets[dev], image.to(dev), torch.float32).cpu()
            if dev == "cuda":
                counts = read_counts()
                if counts != want:
                    raise AssertionError(f"card trunk {h}x{w} launched "
                                         f"{counts}, expected {want}")
                k6 += counts["stem_pool"]
        scale = outs["cpu"].abs().max().item()
        err = (outs["cuda"] - outs["cpu"]).abs().max().item()
        # sums of up to 9 * 512 float32 products in another order, through
        # 5 blocks: ~1e-6 of the output's scale
        if not err <= TRUNK_F32_TOL * scale:
            raise AssertionError(f"card vs CPU fused trunk {h}x{w}: {err} > "
                                 f"{TRUNK_F32_TOL} x {scale}")
        emit({"phase": "parity_trunk", "image": [h, w],
              "detr_blocks": list(blocks), "shape": list(outs["cpu"].shape),
              "max_abs_err": err, "scale": scale,
              "tolerance": f"{TRUNK_F32_TOL} x scale", "launches": want})
    return k6


def main():
    ap = argparse.ArgumentParser(description="chip smoke of the port")
    ap.add_argument("--phases",
                    default="kernel,slice,profile,train,featurize,parity")
    phases = set(ap.parse_args().phases.split(","))
    info = phase_device()
    phase_build()
    kernel = {}
    if "kernel" in phases:
        kernel.update(phase_kernel())
        kernel.update(phase_kernel_encoder(info["exp_per_s"]))
        kernel.update(phase_kernel_trunk())
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
    if "featurize" in phases:
        launches.update(phase_featurize())
    if "parity" in phases:
        # K6 runs on the fallback for images that are even but not
        # divisible by 8, not at 1024^2: its count is the parity run's
        launches["stem_pool"] = phase_parity()
    if len(kernel) != len(KERNELS) or len(launches) != len(KERNELS):
        return 0                                # a partial run: no summary
    rows = [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches[name],
             **{k: kernel[name][k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "unfused_ms") if k in kernel[name]}}
            for name, (_, _, source, replaces) in KERNELS.items()]
    emit({"kernels": rows})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
