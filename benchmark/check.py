"""The numbers that decide `correct`, each the gap between what the timed
path produced and what the reference works out from the same inputs.

Train cells (by the worst step or parameter):
  loss     |loss - reference loss| / |reference loss|, the worst of the
           checked steps;
  grad     per parameter | |g| - |g_ref| | / max(|g_ref|, the median
           parameter's |g_ref|), g the first step's gradient as the
           optimizer got it, the worst parameter;
  change   the same of each parameter's change over the checked steps;
  replicas (data-parallel cells) the largest difference between the
           ranks' parameter digests after those steps, which must be 0.
A parameter whose reference gradient is under a thousandth of the median
parameter's moves by round-off alone and is left out of grad and change.

Serve cells (by the worst sampled request; the reference featurizes the
images itself, so the featurizer's error reaches all four):
  trunk      |C5 - C5_ref| / |C5_ref| over the request's images, C5 the
             DETR trunk's output (the ResNet-101 kernels');
  scores     the largest |difference| of a live pair's relation
             log-probability or connectivity logit from the eval step;
  confidence the largest |difference| of a returned edge's confidence
             from the reference's score of that edge (infinite where the
             reference has no such candidate);
  ranking    the largest amount by which the reference scores the k-th
             returned edge below its own k-th best candidate (infinite
             where the number of edges differs).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with a per-tensor scale to its largest
    magnitude (the lower-precision control's operands)."""
    amax = x.detach().abs().max().float().clamp_min(1e-30)
    scale = 448.0 / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float()
            / scale).to(x.dtype)


def _worst_leaf(got: Dict[str, float], want: Dict[str, float],
                keep: Sequence[str]) -> float:
    med = float(np.median([want[k] for k in keep]))
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in keep)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    g_ref = ref["grad_norms"]
    med = float(np.median(list(g_ref.values())))
    keep = [k for k, v in g_ref.items() if v >= 1e-3 * med]
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["loss"], ref["loss"]))
    return {"loss": float(loss),
            "grad": _worst_leaf(prog["grad_norms"], g_ref, keep),
            "change": _worst_leaf(prog["change_norms"],
                                  ref["change_norms"], keep)}


def replica_digest(params: Dict[str, torch.Tensor]) -> List[float]:
    """Per parameter: its sum and its sum of squares, in float64."""
    return [v for p in params.values()
            for v in (float(p.detach().double().sum()),
                      float(p.detach().double().pow(2).sum()))]


def replica_spread(digests: List[List[float]]) -> float:
    d = np.asarray(digests, np.float64)
    return float(np.abs(d - d[0]).max())


def relative_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| in float64 (a non-finite value reads inf)."""
    got, want = got.double(), want.double()
    gap = float((got - want).norm() / want.norm().clamp_min(1e-300))
    return gap if gap == gap else float("inf")


def scores_gap(out: Dict[str, np.ndarray], pairs: np.ndarray,
               relation: np.ndarray, connectivity: np.ndarray) -> float:
    """The eval step's outputs (pair_img/sub/obj/mask, relation,
    connectivity over its buffer) against the reference's per pair."""
    live = np.nonzero(out["pair_mask"])[0]
    key = {tuple(r): i for i, r in enumerate(pairs.tolist())}
    rows = [key.get((int(out["pair_img"][j]), int(out["pair_sub"][j]),
                     int(out["pair_obj"][j])), -1) for j in live]
    if len(rows) != len(pairs) or min(rows, default=0) < 0:
        return float("inf")
    rel = np.abs(out["relation"][live].astype(np.float64)
                 - relation[rows]).max()
    con = np.abs(out["connectivity"][live].astype(np.float64)
                 - connectivity[rows]).max()
    return float(max(rel, con))


def edges_gaps(graphs: List[List[Dict]], batch: Dict,
               scores: List[Dict]) -> tuple:
    """(confidence, ranking) of one request's returned graphs against the
    reference's scores (reference.relation.candidate_scores)."""
    boxes, cats = np.asarray(batch["boxes"]), np.asarray(batch["cats"])
    conf_gap = rank_gap = 0.0
    for i, edges in enumerate(graphs):
        by_key = {}
        for (s, o, r), v in scores[i]["all"].items():
            k = (tuple(boxes[i, s].tolist()), int(cats[i, s]),
                 tuple(boxes[i, o].tolist()), int(cats[i, o]), r)
            by_key[k] = max(v, by_key.get(k, -np.inf))
        best = scores[i]["best"]
        if len(best) != len(edges):
            return float("inf"), float("inf")
        for j, e in enumerate(edges):
            k = (tuple(e["subject_box"]), e["subject_id"],
                 tuple(e["object_box"]), e["object_id"], e["relation_id"])
            if k not in by_key:
                return float("inf"), float("inf")
            conf_gap = max(conf_gap, abs(e["confidence"] - by_key[k]))
            rank_gap = max(rank_gap, best[j] - by_key[k])
    return conf_gap, rank_gap
