"""Epoch-level training loop and the frozen DETR featurizer (torch port of
scene_graph_commonsense_tpu/train/loop.py, one device, without a mesh).

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
from scene_graph_commonsense_torch.models.detr import DETR, make_detr
from scene_graph_commonsense_torch.models.weights import (
    detr_from_hub_state_dict)
from scene_graph_commonsense_torch.train import checkpoint as ckpt_lib
from scene_graph_commonsense_torch.train import engine
from scene_graph_commonsense_torch.utils.logging import (
    ResultRecorder, format_test_line, format_train_line)
from scene_graph_commonsense_torch.utils.profiling import (
    StepTimer, check_observability)


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


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def checkpoint_file(cfg, epoch: int) -> str:
    """<checkpoint_path>/<reference name>.pt of an epoch's weights."""
    name = ckpt_lib.checkpoint_name(
        cfg.model.hierarchical_pred, cfg.training.run_mode,
        cfg.data.supcat_clustering, epoch)
    return os.path.join(cfg.training.checkpoint_path, name + ".pt")


def load_detr_featurizer(cfg, device=None,
                         generator: Optional[torch.Generator] = None,
                         log_fn: Callable[[str], None] = print):
    """The frozen DETR-101 featurizer on `device` (default cuda).  Weights
    come from cfg.model.detr_pretrained, a torch state dict in
    torch-hub names (`torch.save` of the hub model's state_dict, or a dict
    with it under "model"); when that file is absent, from a seeded random
    init (`generator`, default seeded with cfg.training.seed) with a loud
    warning: fine for plumbing and timing, useless for recall.  Returns
    (featurize_fn, detr_model)."""
    path = cfg.model.detr_pretrained
    state_dict = None
    if os.path.exists(path):
        if path.endswith(".msgpack"):
            raise ValueError(
                f"{path} is a flax msgpack checkpoint of the JAX package; "
                f"the PyTorch port cannot read it (it does not depend on "
                f"flax).  Point model.detr_pretrained at the torch-hub DETR "
                f"state dict (.pth) it was converted from.")
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        state_dict, _ = detr_from_hub_state_dict(
            ckpt.get("model", ckpt), cfg.model.detr_enc_layers,
            tuple(cfg.model.detr_blocks))
    else:
        log_fn(f"WARNING: {path} not found — using randomly initialized "
               f"DETR weights (give a torch-hub DETR state dict for "
               f"meaningful features)")
    detr = make_detr(cfg, device=device, state_dict=state_dict,
                     generator=generator)
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
            return detr_model.encode_features(
                torch.as_tensor(images).to(dev))

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
        log_fn: Callable[[str], None] = print) -> engine.TrainState:
    """Full training run on one device (default cuda); returns the final
    TrainState.  `model` is a RelationClassifier whose parameters are
    trained in place; the batch functions map an epoch to an iterable of
    numpy batch dicts.  `featurize` (make_detr_featurize_fn) turns image
    batches into feature batches on the prefetcher's thread, overlapping
    the train step."""
    tc = cfg.training
    check_observability(tc)
    dev = resolve_device(device)
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
            model.load_state_dict(ckpt_lib.load(path))
            log_fn(f"Resumed relation weights from {path}")
        else:
            log_fn(f"WARNING: continue_train set but {path} not found — "
                   f"training from scratch")

    step = engine.make_train_step(
        model, cfg, opt, class_weights(cfg.data.dataset,
                                       cfg.data.supcat_clustering,
                                       faithful=tc.faithful_dynamics),
        cs_tables=cs_tables, device=dev)
    # the schedule count starts at the resume point, so a resumed run past
    # a scheduler epoch does not train at the undecayed rate
    state = engine.init_train_state(model, opt,
                                    step=tc.start_epoch * steps_per_epoch)

    recorder = ResultRecorder(tc.result_path, "train_results",
                              fresh=not tc.continue_train)
    test_recorder = ResultRecorder(tc.result_path, "test_results",
                                   fresh=not tc.continue_train)
    timer = StepTimer()
    train_eval, _ = engines._make_evaluators(cfg, artifacts)
    train_estep = engine.make_eval_step(model, cfg, device=dev)
    host_step = state.step
    overflow_warned = False

    def _prep(batch: Dict, on_device: bool) -> Dict:
        # featurize, then (train batches) the copy to the card, all on the
        # producer thread; test batches stay numpy apart from their
        # features (run_eval_pc's evaluators read them on the host)
        batch = featurize(batch) if featurize is not None else dict(batch)
        batch.pop("annot_path", None)
        return to_device(batch, dev) if on_device else batch

    def _prepped(batches, on_device: bool):
        prep = lambda b: _prep(b, on_device)  # noqa: E731
        if tc.prefetch_batches > 0:
            return prefetch_iterator(batches, tc.prefetch_batches, prep)
        return map(prep, batches)

    for epoch in range(tc.start_epoch, tc.num_epoch):
        log_fn(f"Start Training... EPOCH {epoch} / {tc.num_epoch}")
        # per-epoch train recall, like the reference's in-epoch accumulation
        train_eval.reset()
        t0 = time.time()
        for batch_count, batch in enumerate(_prepped(train_batches_fn(epoch),
                                                     on_device=True)):
            state, metrics = step(state, batch)
            host_step += 1
            timer.tick()

            recall = mean_recall = None
            if tc.eval_freq > 0 and batch_count % tc.eval_freq == 0:
                out = engines.to_numpy(train_estep(batch))
                cats, boxes = _host(batch["cats"]), _host(batch["boxes"])
                cand = build_candidates(
                    out["relation"], out["connectivity"],
                    out["super_relation"], out["pair_img"],
                    out["pair_sub"], out["pair_obj"], out["pair_mask"],
                    out["iou_ok"], cats, boxes,
                    hierarchical=cfg.model.hierarchical_pred,
                    num_geometric=cfg.model.num_geometric,
                    num_possessive=cfg.model.num_possessive)
                tgt = build_targets(_host(batch["rel"]), cats, boxes,
                                    _host(batch["valid"]))
                train_eval.accumulate(cand, tgt)
                res = train_eval.compute()
                recall, mean_recall = res["recall"], res["mean_recall"]

            if batch_count % tc.print_freq == 0:
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

        # per-epoch checkpoint (reference train_test.py:311-322)
        path = checkpoint_file(cfg, epoch)
        ckpt_lib.save(path, model)
        log_fn(f"Saved checkpoint {path}")

        if test_batches_fn is not None:
            max_batches = 100 if epoch < 2 else None  # train_test.py:347
            res = engines.run_eval_pc(
                cfg, model, _prepped(test_batches_fn(epoch),
                                     on_device=False),
                artifacts=artifacts, max_batches=max_batches,
                estep=train_estep)
            log_fn(format_test_line(epoch, res["recall"],
                                    res["mean_recall"],
                                    res.get("recall_zs")))
            test_recorder.add({"epoch": epoch,
                               "recall": list(map(float, res["recall"])),
                               "mean_recall": list(map(float,
                                                       res["mean_recall"]))})
    summary = timer.summary(tc.batch_size)
    if summary:
        log_fn("train steps (host clock): " + ", ".join(
            f"{k}={v:.1f}" for k, v in summary.items()))
    return state
