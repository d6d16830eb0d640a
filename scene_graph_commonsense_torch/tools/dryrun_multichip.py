"""One data-parallel train step, one sharded eval step and one data x
tensor parallel train step over N processes on tiny shapes (the
counterpart of the JAX package's __graft_entry__.dryrun_multichip):

    python -m scene_graph_commonsense_torch.tools.dryrun_multichip \\
        [--n 2] [--device cuda|cpu] [--backend nccl|gloo]

Starts N processes that join one process group through a file store (NCCL
on cards, one card per process, the default; gloo with --device cpu; with
--backend gloo on cuda, gloo's CUDA path, which puts every process on the
first card when there are fewer cards than processes),
shard a synthetic batch of 2N images over the data axis, take one train
step (gradients averaged over the group) and one sharded eval step, and
check that the loss and the relation scores are finite; then, at an even
N, two train steps on a (N / 2, 2) mesh, fc1 and fc2_h split over its
model axis (parallel/tp.py), on a fresh batch: the shard_map step that fit
and the CLI run at parallel.model_axis 2 (each data shard's own losses),
then the global-batch step (make_train_step(global_batch=True), the losses
of the whole global batch), as the JAX package's dp x tp leg runs its GSPMD
step; rank 0 prints a line for each.  Exits 1 if any process fails.
"""

import argparse
import os
import sys
import tempfile
from typing import Optional

import numpy as np

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_rank(rank: int, n: int, store: str, device: str,
             backend: Optional[str] = None) -> None:
    """The dry run of one process."""
    import torch.distributed as dist

    from scene_graph_commonsense_torch.config import derive
    from scene_graph_commonsense_torch.constants import class_weights
    from scene_graph_commonsense_torch.data.synthetic import synthetic_batch
    from scene_graph_commonsense_torch.models.relation_head import (
        make_relation_classifier)
    from scene_graph_commonsense_torch.parallel.mesh import (
        init_multihost, make_mesh, replicate_tree, shard_batch)
    from scene_graph_commonsense_torch.train import engine

    init_multihost(f"file://{store}", n, rank, device=device,
                   backend=backend)
    try:
        say = print if rank == 0 else (lambda *a, **k: None)
        batch_size = 2 * n
        cfg = derive(
            "vg", hierarchical_pred=True,
            model={"feature_size": 16, "hidden_dim": 8,
                   "num_img_feature": 16, "compute_dtype": "float32"},
            data={"max_objects": 5}, training={"batch_size": batch_size})
        mesh = make_mesh(data=n, device=device)
        model = make_relation_classifier(cfg, device=mesh.device)
        opt = engine.make_optimizer(cfg.training.learning_rate)
        state = engine.init_train_state(model, opt)
        replicate_tree(mesh, state.params)
        step = engine.make_train_step(model, cfg, opt, class_weights("vg"),
                                      mesh=mesh)
        batch = synthetic_batch(
            np.random.default_rng(0), batch_size=batch_size,
            max_objects=cfg.data.max_objects,
            feature_size=cfg.model.feature_size,
            num_channels=cfg.model.num_img_feature)
        state, metrics = step(state, shard_batch(mesh, batch))
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss}")
        say(f"dryrun_multichip({n}) dp ok: loss={loss:.4f}, "
            f"pairs={float(metrics['num_pairs']):g}", flush=True)

        # the sharded eval path: the same data axis drives the
        # deterministic forward, every rank gathering the global outputs
        estep = engine.make_eval_step(model, cfg, mesh=mesh)
        out = estep(shard_batch(mesh, {k: v for k, v in batch.items()
                                       if k != "features_aug"}))
        live = out["pair_mask"]
        rel_max = float(out["relation"][live].max())
        if not np.isfinite(rel_max):
            raise RuntimeError(f"non-finite eval output {rel_max}")
        say(f"dryrun_multichip({n}) sharded eval ok: {int(live.sum())} "
            f"live pairs", flush=True)

        if n >= 2 and n % 2 == 0:
            # dp x tp: fc1 column-parallel, fc2_h row-parallel over the
            # model axis, the batch over the data axis; the shard_map step,
            # then the global batch's losses (the JAX package's GSPMD step)
            mesh2 = make_mesh(data=n // 2, model=2, device=device)
            batch2 = shard_batch(mesh2, synthetic_batch(
                np.random.default_rng(1), batch_size=batch_size,
                max_objects=cfg.data.max_objects,
                feature_size=cfg.model.feature_size,
                num_channels=cfg.model.num_img_feature))
            for global_batch, name in ((False, "dp x tp"),
                                       (True, "dp x tp global batch")):
                model2 = make_relation_classifier(cfg, device=mesh2.device)
                replicate_tree(mesh2, dict(model2.named_parameters()))
                step2 = engine.make_train_step(
                    model2, cfg, opt, class_weights("vg"), mesh=mesh2,
                    global_batch=global_batch)
                _, m2 = step2(engine.init_train_state(model2, opt), batch2)
                loss2 = float(m2["loss"])
                if not np.isfinite(loss2):
                    raise RuntimeError(f"non-finite {name} loss {loss2}")
                say(f"dryrun_multichip({n}) {name} ({n // 2}x2) ok: "
                    f"loss={loss2:.4f}", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device: str = "cuda", timeout: float = 600,
                     backend: Optional[str] = None) -> int:
    """Runs the dry run in n processes; returns 1 if any failed, else 0."""
    from scene_graph_commonsense_torch.parallel.launch import run_processes

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p)}
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", __spec__.name, "--n", str(n),
               "--device", device, "--store", os.path.join(tmp, "store")]
        if backend is not None:
            cmd += ["--backend", backend]
        codes, _ = run_processes([cmd + ["--rank", str(r)]
                                  for r in range(n)], PACKAGE_ROOT, env,
                                 timeout=timeout)
    return int(any(codes))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is None:
        return dryrun_multichip(args.n, args.device, backend=args.backend)
    run_rank(args.rank, args.n, args.store, args.device, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
