"""Plug-and-play hierarchical predictors: Motifs / Transformer / VCTree /
VTransE (torch port of scene_graph_commonsense_tpu/models/predictors.py).

Each predictor couples a context encoder of models/context.py with

  pair hidden  h = W_s(ctx[sub]) * W_o(ctx[obj]) * W_u(union)   (Motifs'
               post-composition; VTransE's difference W_o(obj) - W_s(sub)
               in place of the first product), LayerNorm, a ReLU MLP;
  outputs      (rel1, rel2, rel3, super) log-probabilities of a
               BayesianHead, optionally shifted by a learned frequency-bias
               table over (sub_label, obj_label) (Motifs' prior), and a
               relatedness logit.

The bias row splits into the three branch segments, added to the branch
logits before their softmax, and each segment's logsumexp is added to the
super-category logits, so the composed joint is softmax(head logits +
bias) marginalized the hierarchical way (models/relation_head.BayesianHead).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from scene_graph_commonsense_torch.models.context import (
    LN_EPS, MotifsContext, TransformerContext, VCTreeContext,
    VTransEContext, _take)
from scene_graph_commonsense_torch.models.relation_head import (
    BayesianHead, _dense)

# The hierarchical head with optional frequency bias IS the standalone
# BayesianHead (models/relation_head.py), as in the JAX package.
BiasedBayesHead = BayesianHead

CONTEXTS = {"motifs": MotifsContext, "transformer": TransformerContext,
            "vctree": VCTreeContext, "vtranse": VTransEContext}


class FrequencyBias(nn.Module):
    """Learned (sub_label, obj_label) -> predicate-logit table (Motifs'
    frequency baseline), zero at initialisation.  Labels are clipped into
    [-1, num_classes - 1] and shifted by one (row 0 = unknown)."""

    def __init__(self, num_classes: int = 150, num_relations: int = 50):
        super().__init__()
        self.num_classes = num_classes
        self.table = nn.Embedding((num_classes + 1) ** 2, num_relations)
        nn.init.zeros_(self.table.weight)

    def forward(self, sub_labels: torch.Tensor,
                obj_labels: torch.Tensor) -> torch.Tensor:
        c = self.num_classes
        idx = (torch.clamp(sub_labels + 1, 0, c) * (c + 1)
               + torch.clamp(obj_labels + 1, 0, c))
        return F.embedding(idx.long(), self.table.weight)


class HierarchicalPredictor(nn.Module):
    """Context encoder + pair composition + (biased) BayesianHead.

    forward(feats (B,N,D), boxes (B,N,4), labels (B,N) int, valid (B,N)
            bool, pair_sub (B,P), pair_obj (B,P), pair_mask (B,P),
            union_feats (B,P,Du) or None)
      -> dict(rel1 / rel2 / rel3 / super_relation / relation /
              connectivity over (B*P,), obj_logits (B,N,C), pair_mask
              (B*P,), and for VCTree structure_scores (B,N,N))

    `feature_dim` is D; `union_dim` is Du, None for a predictor without
    the union branch (post_union)."""

    def __init__(self, family: str = "motifs", feature_dim: int = 256,
                 union_dim: Optional[int] = None, hidden_dim: int = 256,
                 pair_dim: int = 512, num_classes: int = 150,
                 num_geometric: int = 15, num_possessive: int = 11,
                 num_semantic: int = 24, mode: str = "predcls",
                 use_freq_bias: bool = True, box_scale: float = 32.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if family not in CONTEXTS:
            raise ValueError(f"unknown context family {family!r}; "
                             f"expected one of {sorted(CONTEXTS)}")
        self.family = family
        self.mode = mode
        self.pair_dim = pair_dim
        self.dtype = dtype
        self.use_freq_bias = use_freq_bias
        self.context = CONTEXTS[family](
            feature_dim, hidden_dim=hidden_dim, num_classes=num_classes,
            mode=mode, box_scale=box_scale, dtype=dtype)
        ctx_dim = 2 * hidden_dim
        self.post_sub = nn.Linear(ctx_dim, pair_dim)
        self.post_obj = nn.Linear(ctx_dim, pair_dim)
        if union_dim is not None:
            self.post_union = nn.Linear(union_dim, pair_dim)
        self.pair_norm = nn.LayerNorm(pair_dim, eps=LN_EPS)
        self.pair_mlp = nn.Linear(pair_dim, pair_dim)
        nr = num_geometric + num_possessive + num_semantic
        if use_freq_bias:
            self.freq = FrequencyBias(num_classes, nr)
        self.head = BayesianHead(pair_dim, num_geometric, num_possessive,
                                 num_semantic, dtype=dtype)
        self.rel_conf = nn.Linear(pair_dim, 1)

    def forward(self, feats, boxes, labels, valid, pair_sub, pair_obj,
                pair_mask, union_feats=None) -> Dict[str, torch.Tensor]:
        dt = self.dtype
        ctx_out = self.context(feats, boxes, labels, valid)
        ctx, obj_logits = ctx_out[0], ctx_out[1]
        sub_rep = _dense(self.post_sub, _take(ctx, pair_sub), dt)
        obj_rep = _dense(self.post_obj, _take(ctx, pair_obj), dt)
        if self.family == "vtranse":
            # the translation embedding: subject + predicate ~ object in
            # the projected space (Zhang et al. 2017 eq. 2)
            h = obj_rep - sub_rep
        else:
            h = sub_rep * obj_rep
        if union_feats is not None:
            h = h * _dense(self.post_union, union_feats.to(dt), dt)
        # the triple product compounds scale: normalize before the MLP
        h = F.layer_norm(h, (self.pair_dim,),
                         self.pair_norm.weight.to(h.dtype),
                         self.pair_norm.bias.to(h.dtype), LN_EPS)
        h = torch.relu(_dense(self.pair_mlp, h, dt))
        h = h.reshape(-1, self.pair_dim)

        bias = None
        if self.use_freq_bias:
            lab = labels if self.mode == "predcls" \
                else obj_logits.argmax(dim=-1)
            bias = self.freq(_take(lab, pair_sub).reshape(-1),
                             _take(lab, pair_obj).reshape(-1))
        r1, r2, r3, sup = self.head(h, bias)
        # relatedness head (the connectivity term; SGB models carry it as a
        # background predicate class)
        conn = _dense(self.rel_conf, h, dt)[:, 0].to(torch.float32)
        out = {"rel1": r1, "rel2": r2, "rel3": r3, "super_relation": sup,
               "relation": torch.cat([r1, r2, r3], dim=1),
               "connectivity": conn, "obj_logits": obj_logits,
               "pair_mask": pair_mask.reshape(-1)}
        if len(ctx_out) > 2:
            out["structure_scores"] = ctx_out[2]
        return out
