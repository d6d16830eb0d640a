"""Plug-and-play hierarchy and commonsense components (torch port of
scene_graph_commonsense_tpu/plugandplay.py).

The reference's second half is a recipe for grafting the hierarchical head
and the commonsense validator onto Scene-Graph-Benchmark models (Neural
Motifs, VCTree, VTransE, TDE, NICE, IETrans; reference
README_PLUGANDPLAY.md:56-158).  The components, for any relation model that
produces per-pair hidden states:

  * BayesHead        log-space hierarchical head (models/relation_head.py);
  * BayesHeadProd    probability-space variant, p(rel | sup) * p(sup) (the
    'Prod' head of README_PLUGANDPLAY.md:56-60);
  * hierarchical_relation_loss  super-category NLL + per-branch NLL
    (RelationHierarchicalLossComputation, README_PLUGANDPLAY.md:97-108);
  * hierarchical_postprocess    each pair's 3 ranked branch candidates
    (HierarchPostProcessor, README_PLUGANDPLAY.md:85-96);
  * CommonsenseValidator        inference-time LLM filter over the top-k
    predicted triplets: rejected triplets' scores drop to -inf before
    re-sorting (README_PLUGANDPLAY.md:131-158).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from scene_graph_commonsense_torch.commonsense.cache import EdgeCache
from scene_graph_commonsense_torch.commonsense.client import (
    batch_query_edges)
from scene_graph_commonsense_torch.models.relation_head import (  # noqa
    BayesianHead as BayesHead, _dense)
from scene_graph_commonsense_torch.train.losses import relation_loss


class BayesHeadProd(nn.Module):
    """Probability-space hierarchical head: each branch's softmax times the
    super-category probability, the softmaxes in float32."""

    def __init__(self, in_features: int, num_geometric: int = 15,
                 num_possessive: int = 11, num_semantic: int = 24,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc5 = nn.Linear(in_features, 3)
        self.fc3_1 = nn.Linear(in_features, num_geometric)
        self.fc3_2 = nn.Linear(in_features, num_possessive)
        self.fc3_3 = nn.Linear(in_features, num_semantic)

    def forward(self, h: torch.Tensor):
        dt = self.dtype
        sup = torch.softmax(_dense(self.fc5, h, dt).to(torch.float32), -1)
        branches = []
        for i, layer in enumerate((self.fc3_1, self.fc3_2, self.fc3_3)):
            logits = _dense(layer, h, dt).to(torch.float32)
            branches.append(torch.softmax(logits, -1) * sup[:, i:i + 1])
        return branches[0], branches[1], branches[2], sup


def hierarchical_relation_loss(rel1, rel2, rel3, super_rel, targets,
                               connected, class_weights=None):
    """RelationHierarchicalLossComputation over generic branch
    log-probabilities (already composed with log p(super))."""
    relation = torch.cat([rel1, rel2, rel3], dim=1)
    if class_weights is None:
        class_weights = torch.ones(relation.shape[1], dtype=relation.dtype,
                                   device=relation.device)
    return relation_loss(relation, super_rel, targets, connected,
                         class_weights, rel1.shape[1], rel2.shape[1],
                         hierarchical=True)


def hierarchical_postprocess(rel1, rel2, rel3, pair_scores=None):
    """HierarchPostProcessor: each pair emits one candidate per
    super-category branch (the argmax within the branch), ranked by the
    branch's max log-probability plus optional pair scores.

    Returns (rel_ids (3P,), scores (3P,), pair_index (3P,), order (3P,));
    `order` sorts the candidates by descending score (stable)."""
    ng, npos = rel1.shape[1], rel2.shape[1]
    p = rel1.shape[0]
    rel_ids = torch.cat([rel1.argmax(1), rel2.argmax(1) + ng,
                         rel3.argmax(1) + ng + npos])
    scores = torch.cat([rel1.amax(1), rel2.amax(1), rel3.amax(1)])
    if pair_scores is not None:
        scores = scores + pair_scores.repeat(3)
    pair_index = torch.arange(p, device=rel1.device).repeat(3)
    order = torch.argsort(-scores, stable=True)
    return rel_ids, scores, pair_index, order


class CommonsenseValidator:
    """Inference-time commonsense filter (the CommonsenseValidator of the
    plug-and-play recipe): asks the LLM about the top-k predicted triplets
    and returns +1 / -1 per triplet; callers set rejected triplets' scores
    to -inf and re-sort (README_PLUGANDPLAY.md:141-155).  The LLM is
    reached only through `transport(prompts) -> completions`
    (commonsense/client.py; default: the OpenAI completion transport)."""

    def __init__(self, transport: Optional[Callable] = None,
                 top_k: int = 20, max_cache_size: int = 10000,
                 object_names: Optional[Sequence[str]] = None,
                 relation_names: Optional[Sequence[str]] = None):
        from scene_graph_commonsense_torch.constants import (
            VG_OBJECTS, VG_RELATIONS_BY_SUPER)
        if transport is None:
            from scene_graph_commonsense_torch.commonsense.client import (
                openai_completion_transport)
            transport = openai_completion_transport()
        self.transport = transport
        self.top_k = top_k
        self.cache = EdgeCache(max_cache_size)
        self.object_names = object_names or VG_OBJECTS
        self.relation_names = relation_names or VG_RELATIONS_BY_SUPER

    def query(self, sub_cats, rels, obj_cats) -> np.ndarray:
        """(K,) int arrays -> (K,) votes in {+1, -1}."""
        edges = [f"{self.object_names[int(s)]} "
                 f"{self.relation_names[int(r)]} "
                 f"{self.object_names[int(o)]}"
                 for s, r, o in zip(sub_cats, rels, obj_cats)]
        votes, _ = batch_query_edges(edges, self.cache, self.transport)
        return np.asarray(votes, np.int32)

    def filter_scores(self, scores: np.ndarray, sub_cats, rels,
                      obj_cats) -> np.ndarray:
        """Applies the -inf rejection to the top-k scored triplets and
        returns the new scores (callers re-sort)."""
        scores = np.asarray(scores, np.float64).copy()
        order = np.argsort(-scores, kind="stable")[:self.top_k]
        # already rejected (-inf) candidates would waste paid queries
        order = order[np.isfinite(scores[order])]
        if len(order) == 0:
            return scores
        votes = self.query(np.asarray(sub_cats)[order],
                           np.asarray(rels)[order],
                           np.asarray(obj_cats)[order])
        scores[order[votes == -1]] = -np.inf
        return scores
