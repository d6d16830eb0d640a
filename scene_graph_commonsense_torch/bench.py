"""Training throughput of the port on one NVIDIA card.

    python -m scene_graph_commonsense_torch.bench

Runs the full hierarchical PredCLS train step (main view over all valid
pairs, augmented view over the connected pairs, all loss terms, backward
through the pair-pool kernels, the SGD update) on one synthetic VG-shaped
batch at full width, with bench.py's configuration: batch 12, pair capacity
1024, augmented capacity 1024 // 4, grad_clip_norm 5.0, bf16 compute,
mean 8 objects per image.  Prints ONE JSON line with bench.py's keys:

  {"metric": "train_images_per_sec_per_chip", "value": N, "unit": "img/s",
   "mfu_pct": N, ...}

value: images over the host-clock time of STEPS steps after WARMUP steps,
ending in a device synchronisation.  mfu_pct: train_step_flops (an analytic
count of the convolutions and dense layers, forward x 3 for forward plus
backward) over the measured step time over the card's dense bf16 peak
(989 TFLOP/s for an H100 SXM).  Runs only on a card; raises without one.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from scene_graph_commonsense_torch import config as config_lib
from scene_graph_commonsense_torch.constants import class_weights
from scene_graph_commonsense_torch.data.pipeline import to_device
from scene_graph_commonsense_torch.data.synthetic import synthetic_batch
from scene_graph_commonsense_torch.device import resolve_device
from scene_graph_commonsense_torch.models.relation_head import (
    make_relation_classifier)
from scene_graph_commonsense_torch.parallel.mesh import replicate_tree
from scene_graph_commonsense_torch.train import engine

BATCH_SIZE = 12
PAIR_CAPACITY = 1024    # realistic VG pair load for batch 12 (~70 per image)
GRAD_CLIP_NORM = 5.0
MEAN_OBJECTS = 8.0
STEPS = 20
WARMUP = 3
PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense (NVIDIA data sheet)


def bench_config(**training):
    """bench.py's model and traffic: derive("vg", hierarchical_pred=True)
    at batch 12 and pair capacity 1024, clip 5.0."""
    return config_lib.derive(
        "vg", hierarchical_pred=True,
        training={"batch_size": BATCH_SIZE, "pair_capacity": PAIR_CAPACITY,
                  "grad_clip_norm": GRAD_CLIP_NORM, **training})


def view_forward_flops(cfg, pairs: int) -> float:
    """Multiply-add FLOPs (2 per MAC) of one view's forward: conv1 once per
    image (both streams), conv2 once per object (both streams), conv3 and
    fc1, fc2 and the heads once per pair slot."""
    m = cfg.model
    b, n = cfg.training.batch_size, cfg.data.max_objects
    s, c, h = m.feature_size, m.num_img_feature + 1, m.hidden_dim
    hp = s // 2
    conv1 = 2 * b * s * s * c * h * 2
    conv2 = 2 * b * n * s * s * 9 * h * 4 * h * 2
    conv3 = pairs * hp * hp * 9 * 4 * h * 8 * h * 2
    fc1 = pairs * 8 * h * (s // 4) ** 2 * 4096 * 2
    heads = m.num_relations + 1 + (3 if m.hierarchical_pred else 0)
    fc2 = pairs * (4096 + 2 * m.num_super_classes + heads) * 512 * 2
    return float(conv1 + conv2 + conv3 + fc1 + fc2)


def train_step_flops(cfg) -> float:
    """Forward of both views, x 3 for the backward (input and weight
    gradients)."""
    return 3 * (view_forward_flops(cfg, engine.train_pair_capacity(cfg))
                + view_forward_flops(cfg, engine.aug_pair_capacity(cfg)))


def optimizer(cfg) -> engine.SGD:
    """The train step's optimizer at a constant learning rate (as
    bench.py)."""
    tc = cfg.training
    return engine.make_optimizer(tc.learning_rate, momentum=tc.momentum,
                                 weight_decay=tc.weight_decay,
                                 grad_clip_norm=tc.grad_clip_norm,
                                 momentum_dtype=tc.momentum_dtype)


def setup(cfg=None, seed: int = 0, device=None, mesh=None):
    """(cfg, model, step, state, batch): seeded random weights, the train
    step with optimizer(cfg), one synthetic batch with the augmented view,
    on the device (default cuda).  With a mesh (parallel/mesh.py) the step
    is the data-parallel one on the mesh's device, the weights broadcast
    from rank 0, and the batch stays global."""
    cfg = cfg or bench_config()
    dev = resolve_device(device if mesh is None else mesh.device)
    model = make_relation_classifier(
        cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    opt = optimizer(cfg)
    step = engine.make_train_step(model, cfg, opt, class_weights("vg"),
                                  device=dev, mesh=mesh)
    state = engine.init_train_state(model, opt)
    if mesh is not None:
        replicate_tree(mesh, state.params)
    return cfg, model, step, state, bench_batch(cfg, seed, dev)


def bench_batch(cfg, seed: int = 0, device=None):
    """setup's synthetic batch (the augmented view, MEAN_OBJECTS objects an
    image) from `seed`, on the device (default cuda)."""
    batch = synthetic_batch(
        np.random.default_rng(seed), batch_size=cfg.training.batch_size,
        max_objects=cfg.data.max_objects,
        feature_size=cfg.model.feature_size,
        num_channels=cfg.model.num_img_feature,
        num_classes=cfg.model.num_classes,
        num_relations=cfg.model.num_relations, mean_objects=MEAN_OBJECTS)
    return to_device(batch, resolve_device(device))


def card_name() -> str:
    """nvidia-smi's name and power limit of the first card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def run(steps: int = STEPS, warmup: int = WARMUP, seed: int = 0) -> dict:
    cfg, _, step, state, batch = setup(seed=seed, device="cuda")
    for _ in range(warmup):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        state, metrics = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_s = dt / steps
    flops = train_step_flops(cfg)
    return {
        "metric": "train_images_per_sec_per_chip",
        "value": cfg.training.batch_size * steps / dt,
        "unit": "img/s",
        "mfu_pct": 100 * flops / step_s / PEAK_BF16_FLOPS,
        "step_ms": step_s * 1e3,
        "device_step_ms": start.elapsed_time(end) / steps,
        "train_step_tflop": flops / 1e12,
        "loss": float(metrics["loss"]),
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": card_name(),
    }


def main():
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
