"""Loss functions over the packed pair buffer (torch port of
scene_graph_commonsense_tpu/train/losses.py, without `faithful_losses`).

All losses are fully masked, with no data-dependent shapes, and consume the
whole batch's pairs at once: the reference's per-pair-column estimators
(reference train_utils.py:21-157) as masked means.  The clean estimator of
the JAX package: one masked mean per term, without the reference's
connectivity rebinding and column re-accumulation (those live only in the
JAX package's faithful mode, not yet ported).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=like.dtype, device=like.device)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of values where mask, 0 if mask is empty (the reference's
    `0.0 if nan` guards, train_utils.py:56-71)."""
    mask = mask.to(values.dtype)
    count = mask.sum()
    return torch.where(count > 0,
                       (values * mask).sum() / torch.clamp(count, min=1),
                       _zero(values))


def _weighted_nll(log_probs: torch.Tensor, targets: torch.Tensor,
                  weights: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """torch.nn.NLLLoss(weight=w) semantics: sum(w[y] * -logp[y]) / sum(w[y])
    over masked rows (reference train_test.py:109-112)."""
    safe_t = torch.clamp(targets, 0, log_probs.shape[-1] - 1).long()
    nll = -torch.gather(log_probs, 1, safe_t[:, None])[:, 0]
    w = weights[safe_t] * mask.to(log_probs.dtype)
    wsum = w.sum()
    return torch.where(wsum > 0,
                       (nll * w).sum() / torch.clamp(wsum, min=1e-12),
                       _zero(nll * w))


def relation_loss(relation: torch.Tensor,
                  super_relation: Optional[torch.Tensor],
                  targets: torch.Tensor, connected: torch.Tensor,
                  class_weights: torch.Tensor, num_geometric: int,
                  num_possessive: int, hierarchical: bool) -> torch.Tensor:
    """Relationship loss over connected pairs.

    Hierarchical (reference train_utils.py:116-151): unweighted NLL on the
    super-category head plus, per branch, a class-weighted NLL on the
    composed log p(rel, super) restricted to targets in that branch.  Flat
    (reference train_utils.py:153-155): class-weighted cross-entropy.

    relation: (P, R) log-probs (hierarchical) or logits (flat); targets:
    (P,) relation ids in super-category order, -1 = none; connected: (P,)
    bool."""
    connected = connected & (targets >= 0)
    if not hierarchical:
        return _weighted_nll(F.log_softmax(relation, dim=-1), targets,
                             class_weights, connected)
    ng, npos = num_geometric, num_possessive
    # super-category target: 0 geometric / 1 possessive / 2 semantic
    # (reference utils.py:28-35)
    sup_t = torch.where(targets < ng, 0, torch.where(targets < ng + npos,
                                                     1, 2))
    loss = _weighted_nll(super_relation, sup_t,
                         torch.ones(3, dtype=super_relation.dtype,
                                    device=super_relation.device),
                         connected)
    branches = [(0, ng), (ng, npos), (ng + npos,
                                      relation.shape[1] - ng - npos)]
    for offset, width in branches:
        in_branch = connected & (targets >= offset) \
            & (targets < offset + width)
        loss = loss + _weighted_nll(
            relation[:, offset:offset + width], targets - offset,
            class_weights[offset:offset + width], in_branch)
    return loss


class ConnectivityStats(NamedTuple):
    loss: torch.Tensor
    num_connected: torch.Tensor
    num_not_connected: torch.Tensor
    num_connected_pred: torch.Tensor
    precision_hits: torch.Tensor  # predicted connected and truly related
    recall_hits: torch.Tensor     # truly connected and predicted connected


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as jax.nn.softplus computes it (logaddexp(x, 0));
    F.softplus switches to the identity above its threshold, which differs
    by up to exp(-20)."""
    return torch.logaddexp(x, _zero(x))


def connectivity_loss(logits: torch.Tensor, connected: torch.Tensor,
                      valid: torch.Tensor, lambda_not_connected: float
                      ) -> ConnectivityStats:
    """BCE-with-logits on the connectivity head over all valid directed
    pairs: target 1 for connected, 0 otherwise; the not-connected term is
    scaled by lambda_not_connected (reference train_utils.py:64-92)."""
    connected = connected & valid
    not_connected = valid & ~connected
    loss = lambda_not_connected * _masked_mean(_softplus(logits),
                                               not_connected) \
        + _masked_mean(_softplus(-logits), connected)
    prob = torch.sigmoid(logits)
    pred_pos = (prob >= 0.5) & valid

    def count(m):
        return m.sum().to(torch.int32)

    return ConnectivityStats(
        loss=loss,
        num_connected=count(connected),
        num_not_connected=count(not_connected),
        num_connected_pred=count(pred_pos),
        precision_hits=count(pred_pos & connected),
        recall_hits=count((prob >= 0.5) & connected))


def commonsense_loss(relation: torch.Tensor, sub_cats: torch.Tensor,
                     obj_cats: torch.Tensor, valid: torch.Tensor,
                     aligned_table: torch.Tensor,
                     violated_table: torch.Tensor, num_geometric: int,
                     num_possessive: int, num_classes: int,
                     lambda_weak: float, lambda_strong: float,
                     hierarchical: bool) -> torch.Tensor:
    """Commonsense penalty for train_cs (reference train_utils.py:36-60).

    Every prediction (the argmax of each branch, hierarchical; the global
    argmax, flat) forms a (sub, rel, obj) triplet; predictions outside the
    LLM-aligned set pay lambda_weak * max-prob, predictions inside the
    violated set pay lambda_strong * max-prob.  aligned_table /
    violated_table: (C * R * C,) bool dense membership."""
    if hierarchical:
        ng, npos = num_geometric, num_possessive
        bounds = [(0, ng), (ng, ng + npos), (ng + npos, relation.shape[1])]
        probs, preds = [], []
        for lo, hi in bounds:
            block = relation[:, lo:hi]
            probs.append(F.softmax(block, dim=-1).max(dim=-1).values)
            preds.append(block.argmax(dim=-1) + lo)
        rel_prob = torch.cat(probs)
        rel_pred = torch.cat(preds)
        sub = torch.cat([sub_cats] * 3)
        obj = torch.cat([obj_cats] * 3)
        mask = torch.cat([valid] * 3)
    else:
        rel_prob = F.softmax(relation, dim=-1).max(dim=-1).values
        rel_pred = relation.argmax(dim=-1)
        sub, obj, mask = sub_cats, obj_cats, valid
    num_relations = relation.shape[-1]
    tid = (sub.long() * num_relations + rel_pred) * num_classes + obj.long()
    in_yes = aligned_table[tid]
    in_no = violated_table[tid]
    return lambda_weak * _masked_mean(rel_prob, mask & ~in_yes) \
        + lambda_strong * _masked_mean(rel_prob, mask & in_no)


def supcon_hierar_loss(features: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor, num_geometric: int,
                       num_possessive: int, temperature: float = 0.07,
                       base_temperature: float = 0.07) -> torch.Tensor:
    """Hierarchical supervised-contrastive loss (reference
    sup_contrast/losses.py:85-181) with padding masks.

    features: (M, 2, D) two views (plain and augmented) of each connected
    pair's hidden state; labels: (M,) relation id; valid: (M,) bool.  Each
    anchor's softmax denominator is restricted to samples whose relation
    has the same super-category parent."""
    m, n_views, _ = features.shape
    parent = torch.where(labels < num_geometric, 0,
                         torch.where(labels < num_geometric + num_possessive,
                                     1, 2))
    feats = torch.where(valid[:, None, None], features, _zero(features))
    # contrast_feature = cat(unbind(features, dim=1)): view-major
    z = torch.cat([feats[:, i, :] for i in range(n_views)], dim=0)
    big_valid = valid.repeat(n_views)
    big_labels = labels.repeat(n_views)
    big_parent = parent.repeat(n_views)

    logits = (z @ z.T) / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()

    not_self = ~torch.eye(m * n_views, dtype=torch.bool, device=z.device)
    both_valid = big_valid[:, None] & big_valid[None, :]
    pos_mask = ((big_labels[:, None] == big_labels[None, :]) & not_self
                & both_valid).to(logits.dtype)
    den_mask = ((big_parent[:, None] == big_parent[None, :]) & not_self
                & both_valid).to(logits.dtype)

    exp_logits = torch.exp(logits) * den_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True)
                                  + 1e-7)
    mean_log_prob_pos = (pos_mask * log_prob).sum(dim=1) \
        / (pos_mask.sum(dim=1) + 1e-7)
    per_anchor = -(temperature / base_temperature) * mean_log_prob_pos
    return _masked_mean(per_anchor, big_valid)
