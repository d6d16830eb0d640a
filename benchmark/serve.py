"""The serve cells: SceneGraphPredictor.predict from images (PredCLS), one
request at a time, at a rate fixed in the traffic file or back to back.

Set-up builds the predictor over the benchmark's seeded relation head and
DETR featurizer, and a pool of distinct seeded requests of host float32
images; `warmup_requests` requests warm every shape.  Request i of the
window is pool[i % pool size].  With rate_per_s > 0 request i is due at
i / rate after the window opens, is sent when due or, where the previous
one is still running, when that returns, and its latency runs from when it
was due; the window holds the floor(seconds * rate) requests due in it.
With rate 0 requests run back to back for `seconds` and each latency runs
from its send.  The predictor's featurize and estep are wrapped to keep the
outputs of `check_requests` requests drawn from the seed, and, in a traced
run, to time them with CUDA events; the featurizer's trunk is tapped to keep
those requests' trunk output (C5) too.  Once the window has closed and the
program is freed, the reference works those requests out again from their
images.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import check, generate, harness, weights, work
from benchmark.reference import detr as ref_detr
from benchmark.reference import relation

unit_flops = work.serve_flops


class _Wrapped:
    """The predictor's featurize and estep, CUDA events around each when
    timed, and the eval step's and the trunk's outputs of the sampled
    sequence numbers kept."""

    def __init__(self, ctx, predictor, featurizer, sample):
        self.ctx, self.sample, self.seq = ctx, set(sample), -1
        self.kept: Dict[int, Dict] = {}
        self.events = {"featurize": [], "estep": []}
        self.estep_done = 0.0
        self.timed = False
        for name in ("featurize", "estep"):
            setattr(predictor, name, self._wrap(name,
                                                getattr(predictor, name)))
        self.untap = self._tap_trunk(featurizer)

    def _keep_c5(self, c5):
        if self.seq in self.sample:
            self.kept.setdefault(self.seq, {})["c5"] = c5.detach().clone()
        return c5

    def _tap_trunk(self, featurizer):
        """Keeps the trunk's output, from the fused trunk or the plain one,
        whichever the featurizer runs; returns the function that removes
        the tap."""
        from scene_graph_commonsense_torch.models import detr as detr_mod
        fused = detr_mod.resnet_forward_fused
        plain = featurizer.backbone.forward
        detr_mod.resnet_forward_fused = \
            lambda backbone, images, dtype: self._keep_c5(
                fused(backbone, images, dtype))
        featurizer.backbone.forward = \
            lambda x, dtype: self._keep_c5(plain(x, dtype))

        def untap():
            detr_mod.resnet_forward_fused = fused
            del featurizer.backbone.forward
        return untap

    def _wrap(self, name, fn):
        from torch.profiler import record_function

        def call(rows):
            ev = self.ctx.events() if self.timed else None
            if ev:
                ev[0].record()
            with record_function("serve." + name):
                out = fn(rows)
            if ev:
                ev[1].record()
                self.events[name].append(ev)
            if name == "estep" and self.seq in self.sample:
                self.kept.setdefault(self.seq, {})["estep"] = out
            if name == "estep" and self.timed:
                self.ctx.sync()
                self.estep_done = time.perf_counter()
            return out
        return call


def run(ctx) -> Dict:
    from scene_graph_commonsense_torch.inference import SceneGraphPredictor
    from scene_graph_commonsense_torch.models.detr import make_detr
    from scene_graph_commonsense_torch.models.relation_head import (
        make_relation_classifier)
    conf, tr, dev = ctx.conf, ctx.traffic, ctx.device
    ctx.mark("imports")
    b = tr["images"]
    cfg = harness.port_config(conf, b, ctx.seed)
    model = make_relation_classifier(cfg, device=dev, state_dict=weights.draw(
        relation.param_shapes(conf), ctx.seed, weights.HEAD_SALT, dev))
    featurizer = make_detr(cfg, device=dev, state_dict=weights.draw(
        ref_detr.param_shapes(conf), ctx.seed, weights.DETR_SALT, dev))
    predictor = SceneGraphPredictor(cfg, model, detr_model=featurizer,
                                    device=dev)
    ctx.mark("weights")
    pool = generate.serve_pool(conf, tr, ctx.seed, dev)
    ctx.mark("traffic")
    units = [work.serve_unit(conf, r) for r in pool]
    rate = tr["rate_per_s"]
    # the sampled requests: among those due in the window, or with back to
    # back requests among the first seconds * 2, which any run completes
    due = int(ctx.seconds * (rate if rate > 0 else 2))
    rng = np.random.default_rng([ctx.seed, 7])
    sample = sorted(rng.choice(due, min(tr["check_requests"], due),
                               replace=False).tolist())
    wrapped = _Wrapped(ctx, predictor, featurizer, sample)
    top_k = tr["top_k"]
    for i in range(tr["warmup_requests"]):
        predictor.predict(pool[i % len(pool)], top_k=top_k)
    first = tr["warmup_requests"]

    spans: Dict[str, List[float]] = {"queue_wait": [], "predict_host": []}
    latency, graphs = [], {}
    ctx.mark("warm-up")
    ctx.open_window()
    wrapped.timed = ctx.trace
    t0 = time.perf_counter()
    ctx.setup_s = t0 - ctx.t_start
    i = 0
    while (i < due) if rate > 0 else not ctx.window_over(t0):
        when = t0 + i / rate if rate > 0 else time.perf_counter()
        pause = when - time.perf_counter()
        if pause > 0:
            time.sleep(pause)
        sent = time.perf_counter()
        wrapped.seq = i
        out = predictor.predict(pool[(first + i) % len(pool)], top_k=top_k)
        done = time.perf_counter()
        latency.append((done - when) * 1e3)
        spans["queue_wait"].append((sent - when) * 1e3)
        if ctx.trace:
            spans["predict_host"].append((done - wrapped.estep_done) * 1e3)
        if i in wrapped.sample:
            graphs[i] = out
        i += 1
    window_s = time.perf_counter() - t0
    peak = ctx.peak()
    wrapped.timed = False
    wrapped.seq = -1
    for name, evs in wrapped.events.items():
        if evs:
            spans[name] = [a.elapsed_time(e) for a, e in evs]
    if not ctx.trace:
        del spans["predict_host"]
    rec = harness.Record(
        mode="serve", chips=ctx.chips, window_s=window_s,
        units=[units[(first + k) % len(pool)] for k in range(i)],
        spans=spans, latency_ms=latency)
    if ctx.trace:
        n = max(3, int(round(tr["trace_seconds"] * i / window_s)))
        start = first + i

        def run_unit(k):
            from torch.profiler import record_function
            with record_function("serve.predict"):
                predictor.predict(pool[(start + k) % len(pool)], top_k=top_k)

        rec.profile = ctx.profile(run_unit, n)
        rec.traced_units = [units[(start + 1 + k) % len(pool)]
                            for k in range(n)]
    wrapped.untap()
    kept = {k: {"estep": {n: t.cpu().numpy() for n, t in v["estep"].items()
                          if isinstance(t, torch.Tensor)},
                "c5": v["c5"].cpu() if "c5" in v else None}
            for k, v in wrapped.kept.items() if k in graphs}
    del predictor, model, featurizer, wrapped
    ctx.free()
    numbers = compare(conf, [pool[(first + k) % len(pool)] for k in kept],
                      [kept[k] for k in kept], [graphs[k] for k in kept],
                      ctx.seed, dev, top_k)
    return {"record": rec, "numbers": numbers, "peak": peak,
            "attempted": i * b}


def compare(conf, requests, kept, graphs, seed, dev, top_k,
            q=None) -> Dict[str, float]:
    """The reference on each sampled request against what the program
    kept; with `q`, the reference in lower precision stands in the
    program's place (the control), and kept/graphs are ignored."""
    head = weights.draw(relation.param_shapes(conf), seed,
                        weights.HEAD_SALT, dev)
    feat_w = weights.draw(ref_detr.param_shapes(conf), seed,
                          weights.DETR_SALT, dev)
    worst = {"trunk": 0.0, "scores": 0.0, "confidence": 0.0, "ranking": 0.0}
    if not requests:
        return {k: float("inf") for k in worst}
    for j, req in enumerate(requests):
        images = torch.as_tensor(req["image"], device=dev)
        depth = torch.as_tensor(req["depth"], device=dev)
        f_ref, c5_ref = ref_detr.features(feat_w, conf, images)
        pairs, rel, conn = relation.eval_scores(head, conf, f_ref, depth, req)
        rel, conn = rel.double().cpu().numpy(), conn.double().cpu().numpy()
        ref_scores = relation.candidate_scores(conf, req, pairs, rel, conn,
                                               top_k)
        if q is None:
            out, got_graphs = kept[j]["estep"], graphs[j]
            c5_got = kept[j]["c5"]
        else:
            f_got, c5_got = ref_detr.features(feat_w, conf, images, q=q)
            p2, r2, c2 = relation.eval_scores(head, conf, f_got, depth, req,
                                              q=q)
            r2, c2 = r2.double().cpu().numpy(), c2.double().cpu().numpy()
            out = {"pair_img": p2[:, 0], "pair_sub": p2[:, 1],
                   "pair_obj": p2[:, 2], "pair_mask": np.ones(len(p2), bool),
                   "relation": r2, "connectivity": c2}
            got_graphs = control_graphs(conf, req, p2, r2, c2, top_k)
        conf_gap, rank_gap = check.edges_gaps(got_graphs, req, ref_scores)
        gaps = {"trunk": float("inf") if c5_got is None
                else check.relative_gap(c5_got.to(dev), c5_ref),
                "scores": check.scores_gap(out, pairs, rel, conn),
                "confidence": conf_gap, "ranking": rank_gap}
        worst = {k: max(worst[k], gaps[k]) for k in worst}
    return worst


def control_graphs(conf, req, pairs, rel, conn, top_k) -> List[List[Dict]]:
    """The edges the control returns: its own top_k candidates per image,
    in the predictor's edge format."""
    scores = relation.candidate_scores(conf, req, pairs, rel, conn, top_k)
    m = conf["model"]
    bounds = ((0, m["num_geometric"]),
              (m["num_geometric"], m["num_geometric"] + m["num_possessive"]),
              (m["num_geometric"] + m["num_possessive"], rel.shape[1]))
    boxes, cats = np.asarray(req["boxes"]), np.asarray(req["cats"])
    out = []
    for i, sc in enumerate(scores):
        cands = []
        for (s, o, r), v in sc["all"].items():
            lo, hi = next(bd for bd in bounds if bd[0] <= r < bd[1])
            if all(sc["all"][(s, o, x)] <= v for x in range(lo, hi)):
                cands.append((v, s, o, r))
        cands.sort(key=lambda c: -c[0])
        out.append([{"subject_box": boxes[i, s].tolist(),
                     "object_box": boxes[i, o].tolist(),
                     "subject_id": int(cats[i, s]),
                     "object_id": int(cats[i, o]), "relation_id": r,
                     "confidence": v} for v, s, o, r in cands[:top_k]])
    return out


def control_readings(conf: Dict, traffic: Dict, seed: int, device
                     ) -> Dict[str, Dict[str, float]]:
    """The check's numbers with the reference in float8 operands standing
    in the program's place (control) on the seed's first check_requests
    requests."""
    pool = generate.serve_pool(conf, traffic, seed, device)
    reqs = pool[:traffic["check_requests"]]
    return {"control": compare(conf, reqs, None, None, seed, device,
                               traffic["top_k"], q=check.fp8)}
