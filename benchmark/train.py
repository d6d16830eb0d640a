"""The train cells: the port's train step from features, fed as fit feeds
it, measured over the window, and checked against the reference.

Set-up builds one train step with its model and optimizer state
(engine.make_train_step over the benchmark's seeded weights), and a pool of
distinct seeded global batches that cycle through the port's
prefetch_iterator with to_device (and shard_batch on a mesh) as transform.
The first `check_steps` steps of the window's own call and feed are the
check's: the losses they return, the norm of each parameter's first
gradient as the optimizer got it (its momentum trace after one step, less
the weight decay), and the norm of each parameter's change after them are
kept.  After `warmup_steps` more steps the window runs for `seconds`; a
traced run then profiles about trace_seconds of steps.  Once the window
has closed and the program is freed, the reference follows the same
first steps from the same weights and batches.
"""

from __future__ import annotations

import itertools
import sys
import time
from typing import Dict, List

from benchmark import check, generate, harness, weights, work
from benchmark.reference import relation


unit_flops = work.train_step_flops


def _rows(batch: Dict, rank: int, ranks: int) -> Dict:
    b = len(batch["valid"]) // ranks
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def run(ctx) -> Dict:
    """One run of a train cell on this rank.  Returns the record for the
    readers, the numbers compared and the peak device memory."""
    from scene_graph_commonsense_torch.data.pipeline import (
        prefetch_iterator, to_device)
    from scene_graph_commonsense_torch.models.relation_head import (
        make_relation_classifier)
    from scene_graph_commonsense_torch.parallel.mesh import (
        replicate_tree, shard_batch)
    from scene_graph_commonsense_torch.train import engine
    conf, tr, dev, mesh = ctx.conf, ctx.traffic, ctx.device, ctx.mesh
    ctx.mark("imports")
    ranks, b = tr["ranks"], tr["images_per_rank"]
    rank = 0 if mesh is None else mesh.rank
    t = conf["training"]
    # the buffers scaled by the ranks, so that each rank's are the
    # configuration's
    cfg = harness.port_config(
        conf, ranks * b, ctx.seed,
        **{k: t[k] for k in ("learning_rate", "momentum", "weight_decay",
                             "lambda_contrast", "lambda_connectivity",
                             "lambda_not_connected", "grad_clip_norm")},
        pair_capacity=ranks * t["pair_capacity"],
        aug_pair_capacity=ranks * t["aug_pair_capacity"])
    shapes = relation.param_shapes(conf)
    model = make_relation_classifier(
        cfg, device=dev,
        state_dict=weights.draw(shapes, ctx.seed, weights.HEAD_SALT, dev))
    opt = engine.make_optimizer(
        t["learning_rate"], momentum=t["momentum"],
        weight_decay=t["weight_decay"], grad_clip_norm=t["grad_clip_norm"])
    step = engine.make_train_step(
        model, cfg, opt, relation.class_weights(conf, "cpu").numpy(),
        device=dev, mesh=mesh)
    state = engine.init_train_state(model, opt)
    if mesh is not None:
        replicate_tree(mesh, state.params)
    ctx.mark("weights")
    pool = generate.train_pool(conf, tr, ctx.seed)
    units = [work.train_unit(conf, _rows(g, rank, ranks), t["pair_capacity"],
                             t["aug_pair_capacity"]) for g in pool]

    def transform(batch):
        return to_device(batch if mesh is None else shard_batch(mesh, batch),
                         dev)

    feed = prefetch_iterator(itertools.cycle(pool), tr["prefetch"],
                             transform)
    ctx.mark("traffic")
    # the check's first steps, through the window's own call and feed
    check_s = 0.0
    c0 = time.perf_counter()
    p0 = weights.draw(shapes, ctx.seed, weights.HEAD_SALT, dev)
    check_s += time.perf_counter() - c0
    losses, grad_norms = [], None
    for k in range(tr["check_steps"]):
        state, metrics = step(state, next(feed))
        losses.append(metrics["loss"])
        if k == 0:
            ctx.sync()
            c0 = time.perf_counter()
            wd = t["weight_decay"]
            grad_norms = {n: float((state.opt_state.trace[n].double()
                                    - wd * p0[n].double()).norm())
                          for n in shapes}
            check_s += time.perf_counter() - c0
    c0 = time.perf_counter()
    change_norms = {n: float((state.params[n].detach().double()
                              - p0[n].double()).norm()) for n in shapes}
    replica = check.replica_digest(state.params) if mesh else None
    losses = [float(v) for v in losses]
    del p0
    check_s += time.perf_counter() - c0
    for _ in range(tr["warmup_steps"]):
        state, _ = step(state, next(feed))
    done = tr["check_steps"] + tr["warmup_steps"]

    # the window
    spans: Dict[str, List[float]] = {"feed_wait": []}
    events = []
    ctx.mark("warm-up")
    ctx.open_window()
    t0 = time.perf_counter()
    ctx.setup_s = t0 - ctx.t_start - check_s
    steps = 0
    while True:
        tw = time.perf_counter()
        batch = next(feed)
        spans["feed_wait"].append((time.perf_counter() - tw) * 1e3)
        if ctx.trace:
            ev = ctx.events()
            ev[0].record()
        state, last = step(state, batch)
        if ctx.trace:
            ev[1].record()
            events.append(ev)
        steps += 1
        if ctx.window_over(t0):
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    peak = ctx.peak()
    print(f"the window's last loss: {float(last['loss'])!r} after "
          f"{done + steps} steps", file=sys.stderr)
    if events:
        spans["train_step"] = [a.elapsed_time(e) for a, e in events]
    first = done
    rec = harness.Record(
        mode="train", chips=ctx.chips, window_s=window_s,
        units=[units[(first + i) % len(pool)] for i in range(steps)],
        spans=spans)
    if ctx.trace:
        rec.profile, rec.traced_units = _traced(
            ctx, step, state, feed, pool, units, first + steps,
            window_s / steps)
    feed.close()
    del step, state, model, feed, batch, last
    ctx.free()
    numbers = _compare(ctx, conf, pool, rank, ranks, losses, grad_norms,
                       change_norms, replica)
    return {"record": rec, "numbers": numbers, "peak": peak,
            "attempted": steps * b * ranks}


def _traced(ctx, step, state, feed, pool, units, first, step_s):
    """About trace_seconds of steps under the profiler."""
    from torch.profiler import record_function
    n = max(3, int(round(ctx.traffic["trace_seconds"] / step_s)))
    box = {"state": state}

    def run_unit(i):
        with record_function("feed.next"):
            batch = next(feed)
        with record_function("train.step"):
            box["state"], _ = step(box["state"], batch)

    prof = ctx.profile(run_unit, n)
    # unit 0 of the traced run is its warm-up
    traced = [units[(first + 1 + i) % len(pool)] for i in range(n)]
    return prof, traced


def _compare(ctx, conf, pool, rank, ranks, losses, grad_norms, change_norms,
             replica) -> Dict[str, float]:
    """The reference's first steps against the program's, on rank 0 (every
    rank's replica digest gathered to it)."""
    digests = ctx.gather(replica)
    if rank != 0:
        return {}
    t = conf["training"]
    steps = len(losses)
    batches = [[_rows(pool[k], r, ranks) for r in range(ranks)]
               for k in range(steps)]
    p0 = weights.draw(relation.param_shapes(conf), ctx.seed,
                      weights.HEAD_SALT, ctx.device)
    ref = relation.train_steps(conf, p0, batches, ctx.seed,
                               t["pair_capacity"], t["aug_pair_capacity"])
    numbers = check.train_numbers(
        {"loss": losses, "grad_norms": grad_norms,
         "change_norms": change_norms}, ref)
    if ranks > 1:
        numbers["replicas"] = check.replica_spread(digests)
    return numbers


def _half(batch: Dict) -> Dict:
    b = len(batch["valid"]) // 2
    return {k: v[:b] for k, v in batch.items()}


def control_readings(conf: Dict, traffic: Dict, seed: int, device
                     ) -> Dict[str, Dict[str, float]]:
    """The check's numbers read off the reference in float8 operands
    (control) and on the first half of each rank's images (half) in the
    program's place, against the reference in float32."""
    t = conf["training"]
    ranks = traffic["ranks"]
    pool = generate.train_pool(conf, traffic, seed)
    steps = traffic["check_steps"]
    p0 = weights.draw(relation.param_shapes(conf), seed, weights.HEAD_SALT,
                      device)

    def follow(q=None, cut=None):
        return relation.train_steps(
            conf, p0, [[(cut or dict)(_rows(pool[k], r, ranks))
                        for r in range(ranks)] for k in range(steps)],
            seed, t["pair_capacity"], t["aug_pair_capacity"], q=q)

    ref = follow()
    return {"control": check.train_numbers(follow(q=check.fp8), ref),
            "half": check.train_numbers(follow(cut=_half), ref)}
