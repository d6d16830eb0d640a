"""Epoch-level training loop and the frozen DETR featurizer (torch port of
scene_graph_commonsense_tpu/train/loop.py; data and tensor parallel over a
mesh, parallel/mesh.py and parallel/tp.py).

The orchestration of reference train_test.py:31-330: per-epoch loop,
step-decay learning rate (x0.1 at the scheduler epochs), per-epoch
checkpoint, and a truncated PredCLS test pass after each epoch (100 batches
for epochs < 2, reference train_test.py:347-348).  Train-time recall
(reference train_utils.py:105-110) comes from a deterministic eval pass
over the current batch at eval_freq.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from scene_graph_commonsense_torch.constants import class_weights
from scene_graph_commonsense_torch.data.pipeline import (
    prefetch_iterator, to_device)
from scene_graph_commonsense_torch.device import resolve_device
from scene_graph_commonsense_torch.eval import engines
from scene_graph_commonsense_torch.eval.builders import (
    build_candidates, build_targets)
from scene_graph_commonsense_torch.models.detr import (
    DETR, make_detr, module_from_cfg as detr_module)
from scene_graph_commonsense_torch.models.weights import (
    detr_encode_half, detr_from_flax_bytes, detr_from_hub_state_dict)
from scene_graph_commonsense_torch.parallel import tp as tp_lib
from scene_graph_commonsense_torch.parallel.mesh import (
    replicate_tree, shard_batch)
from scene_graph_commonsense_torch.train import checkpoint as ckpt_lib
from scene_graph_commonsense_torch.train import engine
from scene_graph_commonsense_torch.utils import profiling
from scene_graph_commonsense_torch.utils.logging import (
    ResultRecorder, format_test_line, format_train_line)
from scene_graph_commonsense_torch.utils.profiling import (
    ScalarWriter, StepProfiler, StepTimer)


def lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """Step decay: lr *= 0.1 at each scheduler epoch (reference
    train_test.py:138-139), as optax.piecewise_constant_schedule computes
    it: the scale applies from the boundary step on."""
    base = cfg.training.learning_rate
    boundaries = sorted({e * steps_per_epoch: 0.1
                         for e in cfg.training.scheduler_epochs}.items())

    def schedule(count: int) -> float:
        v = base
        for threshold, scale in boundaries:
            indicator = 1.0 if count < threshold else 0.0
            v = v * indicator + (1 - indicator) * scale * v
        return v

    return schedule


def eval_mesh(cfg, mesh):
    """The mesh to use for sharded evaluation, or None when the eval batch
    cannot be evenly sharded or the data axis is 1 (the JAX package's rule,
    which reads the data axis alone: single-device eval then; a model
    sharded over the mesh's model axis still runs its TP layers, on every
    rank, on the whole batch)."""
    if mesh is None:
        return None
    shards = mesh.shape["data"]
    if shards <= 1 or cfg.training.batch_size % shards != 0:
        return None
    return mesh


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def checkpoint_file(cfg, epoch: int) -> str:
    """<checkpoint_path>/<reference name>.pt of an epoch's weights."""
    name = ckpt_lib.checkpoint_name(
        cfg.model.hierarchical_pred, cfg.training.run_mode,
        cfg.data.supcat_clustering, epoch)
    return os.path.join(cfg.training.checkpoint_path, name + ".pt")


def load_detr(cfg, device=None, generator: Optional[torch.Generator] = None,
              log_fn: Callable[[str], None] = print,
              detection: bool = False) -> DETR:
    """The frozen DETR-101 on `device` (default cuda): the encode half (the
    featurizer), or with `detection` the whole detector.  Weights come from
    cfg.model.detr_pretrained: a `.msgpack` is the JAX package's converted
    checkpoint (flax.serialization.to_bytes of its DETR params, read
    without flax); any other file is a torch state dict in torch-hub names
    (`torch.save` of the hub model's state_dict, or a dict with it under
    "model").  The encode half is taken from a checkpoint of the whole
    detector; otherwise the file must hold exactly what the config builds,
    or a ValueError names the keys missing or left over.  When the file is
    absent, the weights come from a seeded random init (`generator`,
    default seeded with cfg.training.seed) with a loud warning: fine for
    plumbing and timing, useless for recall."""
    path = cfg.model.detr_pretrained
    state_dict = None
    if os.path.exists(path):
        if path.endswith(".msgpack"):
            with open(path, "rb") as f:
                state_dict = detr_from_flax_bytes(f.read())
        else:
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
            state_dict = detr_from_hub_state_dict(
                ckpt.get("model", ckpt), cfg.model.detr_enc_layers,
                tuple(cfg.model.detr_blocks),
                cfg.model.detr_dec_layers if detection else None)
        if not detection:
            state_dict = detr_encode_half(state_dict)
        with torch.device("meta"):        # names only: allocates nothing
            want = set(detr_module(cfg, detection=detection).state_dict())
        missing = sorted(want - set(state_dict))
        extra = sorted(set(state_dict) - want)
        if missing or extra:
            raise ValueError(
                f"{path} does not hold the DETR "
                f"{'detector' if detection else 'encode half'} this config "
                f"builds: {len(missing)} keys missing {missing[:8]}, "
                f"{len(extra)} left over {extra[:8]}")
    else:
        log_fn(f"WARNING: {path} not found — using randomly initialized "
               f"DETR weights (give the JAX package's DETR checkpoint "
               f"(.msgpack) or a torch-hub DETR state dict for meaningful "
               f"{'detections' if detection else 'features'})")
    return make_detr(cfg, device=device, state_dict=state_dict,
                     generator=generator, detection=detection)


def load_detr_featurizer(cfg, device=None,
                         generator: Optional[torch.Generator] = None,
                         log_fn: Callable[[str], None] = print):
    """The frozen DETR-101 featurizer on `device` (default cuda), its
    weights as load_detr gives them.  Returns (featurize_fn, detr_model)."""
    detr = load_detr(cfg, device, generator, log_fn)
    return make_detr_featurize_fn(cfg, detr), detr


def make_detr_featurize_fn(cfg, detr_model: Optional[DETR],
                           detr_params=None):
    """Returns featurize(batch) -> batch with 'features' (and
    'features_aug' when an augmented image view is present) computed by the
    frozen DETR encoder (reference train_utils.py:9-18, run per batch under
    no_grad); the image keys are popped.  `detr_params`, a state dict of the
    port's names, is loaded into `detr_model` if given.  The encoder runs
    under torch.inference_mode on the model's device; the features are
    copied out of inference mode so that a train step may save them for its
    backward."""
    if detr_params is not None:
        detr_model.load_state_dict(detr_params)

    def encode(images):
        dev = next(detr_model.parameters()).device
        with torch.inference_mode():
            with profiling.span("serve.image_copy", device=True):
                images = torch.as_tensor(images).to(dev)
            with profiling.span("serve.encode", device=True):
                return detr_model.encode_features(images)

    @profiling.traced("serve.features", device=True)
    def featurize(batch: Dict) -> Dict:
        batch = dict(batch)
        need_plain = "features" not in batch and "image" in batch
        need_aug = "features_aug" not in batch and "image_aug" in batch
        if need_plain and need_aug:
            # both views in one 2B dispatch: the larger batch fills the
            # card better than two B dispatches
            n = len(batch["image"])
            both = encode(torch.cat([torch.as_tensor(batch["image"]),
                                     torch.as_tensor(batch["image_aug"])]))
            batch["features"] = both[:n].clone()
            batch["features_aug"] = both[n:].clone()
        elif need_plain:
            batch["features"] = encode(batch["image"]).clone()
        elif need_aug:
            batch["features_aug"] = encode(batch["image_aug"]).clone()
        batch.pop("image", None)
        batch.pop("image_aug", None)
        return batch

    return featurize


def fit(cfg, model, train_batches_fn: Callable[[int], Iterable],
        test_batches_fn: Optional[Callable[[int], Iterable]] = None,
        steps_per_epoch: int = 1000, artifacts=None, device=None,
        featurize: Optional[Callable[[Dict], Dict]] = None,
        chunk_size: int = 0,
        log_fn: Callable[[str], None] = print,
        mesh=None) -> engine.TrainState:
    """Full training run on one device (default cuda) or over a mesh;
    returns the final TrainState.  `model` is a RelationClassifier whose
    parameters are trained in place; the batch functions map an epoch to
    an iterable of numpy batch dicts.  `featurize` (make_detr_featurize_fn) turns image
    batches into feature batches on the prefetcher's thread, overlapping
    the train step.  `chunk_size` > 0 runs the train step's pair trunk in
    chunks (engine.make_train_step).  training.tensorboard writes the
    scalars of the JAX fit (ScalarWriter, training.tensorboard_dir), and
    training.profile_dir with profile_start_step >= 0 traces
    profile_num_steps steps (StepProfiler).

    With a mesh (parallel/mesh.py) every rank calls fit with the same
    batch functions and runs on the mesh's device: the weights are
    broadcast from rank 0, each rank takes its rows of every global train
    batch before featurizing it (no rank encodes images it then drops) and
    steps on them with the data-parallel train step; the train-time recall
    and the test pass go through the sharded eval step
    (make_eval_step(mesh=eval_mesh(cfg, mesh))), each rank encoding only
    its rows of a test batch too.  Rank 0 alone runs the evaluators and
    writes the checkpoints, the result files, the scalars, the trace and
    the log lines.  A model axis above 1 shards the model after the
    broadcast (tp.shard_module, in place): the ranks of a model group take
    the same rows, and each checkpoint holds the gathered, unsharded
    weights (tp.full_state_dict), the file an unsharded run writes, which
    a resume shards again."""
    tc = cfg.training
    dev = resolve_device(device if mesh is None else mesh.device)
    lead = mesh is None or mesh.rank == 0
    if not lead:
        def log_fn(line):
            return None
    schedule = lr_schedule(cfg, steps_per_epoch)
    opt = engine.make_optimizer(schedule, momentum=tc.momentum,
                                weight_decay=tc.weight_decay,
                                grad_clip_norm=tc.grad_clip_norm,
                                momentum_dtype=tc.momentum_dtype)
    cs_tables = None
    if tc.run_mode == "train_cs":
        if artifacts is None or artifacts.cs_aligned is None:
            raise ValueError("train_cs requires converted commonsense "
                             "triplet tables (run prepare_cs first)")
        cs_tables = (artifacts.cs_aligned, artifacts.cs_violated)

    # resume: the previous epoch's weights only (reference
    # train_test.py:83-94 restores the state_dict; the momentum starts
    # fresh)
    if tc.continue_train and tc.start_epoch > 0:
        path = checkpoint_file(cfg, tc.start_epoch - 1)
        if os.path.exists(path):
            tp_lib.load_full_state_dict(model, ckpt_lib.load(path))
            log_fn(f"Resumed relation weights from {path}")
        else:
            log_fn(f"WARNING: continue_train set but {path} not found — "
                   f"training from scratch")

    if mesh is not None:
        # rank 0's weights on every rank, before make_train_step shards
        # them over the model axis
        model.to(dev)
        replicate_tree(mesh, dict(model.named_parameters()))
    step = engine.make_train_step(
        model, cfg, opt, class_weights(cfg.data.dataset,
                                       cfg.data.supcat_clustering,
                                       faithful=tc.faithful_dynamics),
        cs_tables=cs_tables, mesh=mesh, device=dev, chunk_size=chunk_size)
    # the schedule count starts at the resume point, so a resumed run past
    # a scheduler epoch does not train at the undecayed rate
    state = engine.init_train_state(model, opt,
                                    step=tc.start_epoch * steps_per_epoch)

    if lead:
        recorder = ResultRecorder(tc.result_path, "train_results",
                                  fresh=not tc.continue_train)
        test_recorder = ResultRecorder(tc.result_path, "test_results",
                                       fresh=not tc.continue_train)
    writer = ScalarWriter(tc.tensorboard_dir, enabled=tc.tensorboard and lead)
    profiler = StepProfiler(tc.profile_dir if lead else "",
                            tc.profile_start_step, tc.profile_num_steps,
                            device=dev)
    timer = StepTimer()
    train_eval, _ = engines._make_evaluators(cfg, artifacts, predcls=True)
    test_mesh = eval_mesh(cfg, mesh)
    train_estep = engine.make_eval_step(model, cfg, device=dev,
                                        mesh=test_mesh)
    host_step = state.step
    overflow_warned = False

    def _prep_train(batch: Dict):
        # on the producer thread: the rank's rows, featurize, the copy to
        # the card; the recall's targets stay global, on the host
        host = {k: _host(batch[k]) for k in engines.HOST_KEYS}
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        batch = featurize(batch) if featurize is not None else dict(batch)
        batch.pop("annot_path", None)
        return to_device(batch, dev), host

    def _prep_test(batch: Dict):
        # test batches stay global and numpy apart from their features
        # (run_eval_pc's evaluators read them on the host); over a mesh,
        # the rank's rows are featurized alone (engines.shard_eval_batch)
        if test_mesh is not None:
            return engines.shard_eval_batch(test_mesh, batch, featurize)
        batch = featurize(batch) if featurize is not None else dict(batch)
        batch.pop("annot_path", None)
        return batch

    def _prepped(batches, prep):
        if tc.prefetch_batches > 0:
            return prefetch_iterator(batches, tc.prefetch_batches, prep)
        return map(prep, batches)

    for epoch in range(tc.start_epoch, tc.num_epoch):
        log_fn(f"Start Training... EPOCH {epoch} / {tc.num_epoch}")
        # per-epoch train recall, like the reference's in-epoch accumulation
        train_eval.reset()
        t0 = time.time()
        for batch_count, (batch, host) in enumerate(_prepped(
                train_batches_fn(epoch), _prep_train)):
            profiler.step(host_step)
            state, metrics = step(state, batch)
            host_step += 1
            timer.tick()

            recall = mean_recall = None
            if tc.eval_freq > 0 and batch_count % tc.eval_freq == 0:
                # every rank joins the sharded step's gathers; rank 0
                # alone runs the evaluator
                out = train_estep(batch)
                if lead:
                    out = engines.to_numpy(out)
                    cand = build_candidates(
                        out["relation"], out["connectivity"],
                        out["super_relation"], out["pair_img"],
                        out["pair_sub"], out["pair_obj"], out["pair_mask"],
                        out["iou_ok"], host["cats"], host["boxes"],
                        hierarchical=cfg.model.hierarchical_pred,
                        num_geometric=cfg.model.num_geometric,
                        num_possessive=cfg.model.num_possessive)
                    tgt = build_targets(host["rel"], host["cats"],
                                        host["boxes"], host["valid"])
                    train_eval.accumulate(cand, tgt)
                    res = train_eval.compute()
                    recall, mean_recall = res["recall"], res["mean_recall"]

            if lead and batch_count % tc.print_freq == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                if not overflow_warned and (
                        metrics["pair_overflow"] > 0
                        or metrics["aug_pair_overflow"] > 0):
                    overflow_warned = True
                    log_fn("WARNING: packed pair buffer overflow — live "
                           "pairs exceed training.pair_capacity and the "
                           "excess is DROPPED (results can shift); raise "
                           "pair_capacity / aug_pair_capacity")
                # the rate of the NEXT update, as the JAX loop prints it
                lr = float(schedule(host_step))
                imgs = (batch_count + 1) * tc.batch_size
                line = format_train_line(epoch, batch_count, lr, recall,
                                         mean_recall, losses=metrics)
                log_fn(f"{line}, {imgs / (time.time() - t0):.1f} img/s")
                recorder.add({"epoch": epoch, "batch": batch_count,
                              "lr": lr, **metrics})
                # the reference's tag set (train_test.py:279-285: the loss
                # terms, lr) and the step timing
                writer.scalars(metrics, host_step, prefix="train/")
                writer.scalar("train/lr", lr, host_step)
                writer.scalars(timer.summary(tc.batch_size), host_step,
                               prefix="perf/")

        # per-epoch checkpoint (reference train_test.py:311-322); the
        # gathered weights where sharded (every rank joins the gather)
        weights_ = tp_lib.full_state_dict(model)
        if lead:
            path = checkpoint_file(cfg, epoch)
            ckpt_lib.save(path, weights_)
            log_fn(f"Saved checkpoint {path}")
        del weights_

        if test_batches_fn is not None:
            max_batches = 100 if epoch < 2 else None  # train_test.py:347
            res = engines.run_eval_pc(
                cfg, model, _prepped(test_batches_fn(epoch), _prep_test),
                artifacts=artifacts, max_batches=max_batches,
                estep=train_estep, mesh=test_mesh)
            log_fn(format_test_line(epoch, res["recall"],
                                    res["mean_recall"],
                                    res.get("recall_zs")))
            if lead:
                test_recorder.add({
                    "epoch": epoch,
                    "recall": list(map(float, res["recall"])),
                    "mean_recall": list(map(float, res["mean_recall"]))})
            # test R@k scalars (reference train_test.py:446-450)
            for k, r in zip((20, 50, 100), res["recall"]):
                writer.scalar(f"test/R@{k}", r, epoch)
            for k, r in zip((20, 50, 100), res["mean_recall"]):
                writer.scalar(f"test/mR@{k}", r, epoch)
    profiler.close()
    writer.close()
    summary = timer.summary(tc.batch_size)
    if summary:
        log_fn("train steps (host clock): " + ", ".join(
            f"{k}={v:.1f}" for k, v in summary.items()))
    return state
