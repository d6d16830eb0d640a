"""IETrans / NICE style data transfer (a numpy copy of
scene_graph_commonsense_tpu/data/label_transfer.py, kept so that the port
imports nothing of the JAX package): relabel training annotations with a
trained model's predictions to counter the long-tailed predicate
distribution.

The reference composes its hierarchical and commonsense method with both
data pipelines: "Motifs+IETrans+Ours" is its SOTA row and "Motifs+NICE+Ours"
its strongest NICE row (reference README_PLUGANDPLAY.md:192-200).  The
operators work on the directed (N, N) relation matrix of ops/pairs.py, so
the rewritten labels feed any training path (flagship or predictor
families).  Pure numpy (Zhang et al. 2022 "Fine-Grained Scene Graph
Generation with Data Transfer"; Li et al. 2022 "The Devil is in the
Labels"):

  * internal transfer: a labeled pair moves from a head predicate to a
    rarer (tail) one the model scores higher;
  * external transfer: confident unlabeled pairs take the model's
    predicate;
  * NICE correction: a GT predicate the model confidently contradicts is
    replaced.

Selection is margin-ranked across the whole collection (the top `percent`
of candidates), as IETrans' k%-thresholded transfers.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Sequence, Tuple

import numpy as np


class TransferCandidate(NamedTuple):
    """One proposed relabel: pair (sub, obj) of image `image`, predicate
    `old` (-1 = unlabeled) -> `new`, ranked by `margin` (bigger = more
    confident)."""
    image: int
    sub: int
    obj: int
    old: int
    new: int
    margin: float


def predicate_frequencies(rels: Iterable[np.ndarray],
                          num_relations: int) -> np.ndarray:
    """(R,) GT instance counts over a collection of directed (N, N)
    relation matrices."""
    freq = np.zeros(num_relations, np.int64)
    for rel in rels:
        lab = rel[rel >= 0]
        np.add.at(freq, lab, 1)
    return freq


def internal_candidates(image: int, rel: np.ndarray, scores: np.ndarray,
                        freq: np.ndarray) -> List[TransferCandidate]:
    """Head->tail relabel proposals for one image.

    rel: (N, N) directed GT (-1 = none); scores: (N, N, R) model scores
    (any monotone confidence, e.g. the hierarchical joint log-probs);
    freq: (R,) dataset predicate counts.  A labeled pair (p_old) is a
    candidate iff the model's argmax p_new is strictly rarer than p_old
    and scored above it; the margin is the score gap."""
    out: List[TransferCandidate] = []
    subs, objs = np.nonzero(rel >= 0)
    for i, j in zip(subs, objs):
        p_old = int(rel[i, j])
        p_new = int(np.argmax(scores[i, j]))
        if p_new == p_old or freq[p_new] >= freq[p_old]:
            continue
        s_new = float(scores[i, j, p_new])
        s_old = float(scores[i, j, p_old])
        # guard BEFORE the subtraction: (-inf) - (-inf) would both raise a
        # RuntimeWarning and produce NaN — a GT pair the model never scored
        # (e.g. truncated out of a capped pair pack) must not become a
        # candidate, and real NaN regressions should not be masked as
        # warning noise
        if not (np.isfinite(s_new) and np.isfinite(s_old)):
            continue
        margin = s_new - s_old
        if margin <= 0:
            continue
        out.append(TransferCandidate(image, int(i), int(j), p_old, p_new,
                                     margin))
    return out


def external_candidates(image: int, rel: np.ndarray, scores: np.ndarray,
                        conn: np.ndarray, valid_pair: np.ndarray,
                        min_conn: float = 0.5) -> List[TransferCandidate]:
    """NA->predicate proposals: unlabeled valid pairs the model considers
    RELATED (conn >= min_conn), ranked by relatedness + predicate
    confidence.  The relatedness gate is essential: a 20-object image has
    380 directed valid pairs but ~6 GT relations, so proposing every NA
    pair would pseudo-label the whole grid and drown the real
    annotations (IETrans' external transfer likewise only labels NA pairs
    the model confidently relates).

    conn: (N, N) relatedness probability (sigmoid of the connectivity
    logit); valid_pair: (N, N) bool (both objects real, no self-pairs)."""
    out: List[TransferCandidate] = []
    subs, objs = np.nonzero(valid_pair & (rel < 0) & (conn >= min_conn))
    for i, j in zip(subs, objs):
        p_new = int(np.argmax(scores[i, j]))
        c, s = float(conn[i, j]), float(scores[i, j, p_new])
        if not (np.isfinite(c) and np.isfinite(s)):
            continue
        out.append(TransferCandidate(image, int(i), int(j), -1, p_new,
                                     c + s))
    return out


def nice_candidates(image: int, rel: np.ndarray, scores: np.ndarray,
                    min_gap: float = 0.0) -> List[TransferCandidate]:
    """Noisy-label corrections: GT pairs whose model argmax disagrees with
    the annotation by more than `min_gap` (no rarity constraint — NICE
    corrects noise in either direction)."""
    out: List[TransferCandidate] = []
    subs, objs = np.nonzero(rel >= 0)
    for i, j in zip(subs, objs):
        p_old = int(rel[i, j])
        p_new = int(np.argmax(scores[i, j]))
        if p_new == p_old:
            continue
        s_new = float(scores[i, j, p_new])
        s_old = float(scores[i, j, p_old])
        # finite-guard before the subtraction (see internal_candidates)
        if not (np.isfinite(s_new) and np.isfinite(s_old)):
            continue
        margin = s_new - s_old
        if margin > min_gap:
            out.append(TransferCandidate(image, int(i), int(j), p_old,
                                         p_new, margin))
    return out


def select_top_percent(cands: Sequence[TransferCandidate],
                       percent: float) -> List[TransferCandidate]:
    """IETrans' k%-threshold: keep the `percent` (0..100] most confident
    candidates, globally margin-ranked."""
    if not cands or percent <= 0:
        return []
    k = max(1, int(round(len(cands) * min(percent, 100.0) / 100.0)))
    return sorted(cands, key=lambda c: -c.margin)[:k]


def apply_candidates(rels: Dict[int, np.ndarray],
                     cands: Iterable[TransferCandidate]
                     ) -> Tuple[Dict[int, np.ndarray], Dict[str, int]]:
    """Applies relabels to a dict image -> directed (N, N) rel matrix
    (copies; inputs untouched).  Returns (new rels, summary counts)."""
    out = {k: v.copy() for k, v in rels.items()}
    n_int = n_ext = 0
    for c in cands:
        out[c.image][c.sub, c.obj] = c.new
        if c.old < 0:
            n_ext += 1
        else:
            n_int += 1
    return out, {"relabeled": n_int, "added": n_ext}


def ietrans(rels: Dict[int, np.ndarray],
            scores: Dict[int, np.ndarray],
            conns: Dict[int, np.ndarray],
            valid_pairs: Dict[int, np.ndarray],
            num_relations: int,
            internal_percent: float = 70.0,
            external_percent: float = 100.0,
            external_min_conn: float = 0.5
            ) -> Tuple[Dict[int, np.ndarray], Dict[str, int]]:
    """Full IETrans pass over a collection: internal (head->tail) then
    external (NA->predicate) transfer, each top-percent thresholded.
    Defaults follow the paper's reported sweet spot (k_i = 70%, external
    on all unlabeled pairs that pass the relatedness gate)."""
    freq = predicate_frequencies(rels.values(), num_relations)
    internal: List[TransferCandidate] = []
    external: List[TransferCandidate] = []
    for img, rel in rels.items():
        internal += internal_candidates(img, rel, scores[img], freq)
        external += external_candidates(img, rel, scores[img], conns[img],
                                        valid_pairs[img],
                                        min_conn=external_min_conn)
    chosen = (select_top_percent(internal, internal_percent)
              + select_top_percent(external, external_percent))
    return apply_candidates(rels, chosen)


def nice(rels: Dict[int, np.ndarray], scores: Dict[int, np.ndarray],
         percent: float = 30.0
         ) -> Tuple[Dict[int, np.ndarray], Dict[str, int]]:
    """NICE-style noisy-label correction pass: the top `percent` most
    confidently contradicted GT labels are replaced by the model's
    prediction."""
    cands: List[TransferCandidate] = []
    for img, rel in rels.items():
        cands += nice_candidates(img, rel, scores[img])
    return apply_candidates(rels, select_top_percent(cands, percent))


# ---------------------------------------------------------------------------
# Annotation rewrite (npz round trip)
# ---------------------------------------------------------------------------

def inverse_rel_map(rel_map: np.ndarray) -> np.ndarray:
    """Inverse of the frequency->cluster predicate permutation the dataset
    applies at load time (data/dataset.py).  Raw class 12 ("wears") is
    merged into 4 ("wearing") before the map, so the inverse returns 4 for
    that shared slot — rewritten annotations simply never re-emit the
    merged alias."""
    rel_map = np.asarray(rel_map, np.int64)
    inv = np.zeros(len(rel_map), np.int64)
    for raw, mapped in enumerate(rel_map):
        if raw == 12 or mapped < 0:
            continue
        inv[mapped] = raw
    # the dead "wears" slot (rel_map[12]) never appears in GT but a model
    # can still argmax it; write it back as raw 4 ("wearing"), not as
    # whatever np.zeros left in that entry
    if 0 <= rel_map[12] < len(inv) and rel_map[12] != rel_map[4]:
        inv[rel_map[12]] = 4
    return inv


def rewrite_annotation(rec: Dict, new_rel: np.ndarray,
                       rel_map: np.ndarray) -> Dict:
    """Returns a copy of one npz annotation record with its
    relationships/subj_or_obj rows rebuilt from a (N_max, N_max) directed
    relation matrix in MODEL (cluster-order) label space.

    The lower-triangular storage holds one relation per unordered pair
    (the reference's contract, dataset_utils.py:156-184); if a transfer
    labeled both directions, the subject-direction entry wins
    (ops/pairs.py::lower_from_directed)."""
    from scene_graph_commonsense_torch.ops.pairs import (
        lower_from_directed)

    n = int(len(np.asarray(rec["categories"])))
    inv = inverse_rel_map(rel_map)
    raw = np.where(new_rel >= 0,
                   inv[np.clip(new_rel, 0, len(inv) - 1)], -1)
    relationships, subj_or_obj = lower_from_directed(raw, n)
    out = dict(rec)
    out["relationships"] = relationships
    out["subj_or_obj"] = subj_or_obj
    return out
