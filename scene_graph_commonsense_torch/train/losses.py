"""Loss functions over the packed pair buffer (torch port of
scene_graph_commonsense_tpu/train/losses.py).

All losses are fully masked, with no data-dependent shapes, and consume the
whole batch's pairs at once: the reference's per-pair-column estimators
(reference train_utils.py:21-157) as masked means.  The default is the clean
estimator of the JAX package: one masked mean per term, without the
reference's connectivity rebinding and column re-accumulation;
`faithful_losses` keeps those loop artifacts (training.faithful_dynamics).

`total`, where a loss takes it, maps each detached denominator (a masked
count or a weight sum of this batch, or a grid of them) to the one the mean
divides by: the data-parallel plug-and-play step and the flagship's
global-batch step pass the group's sum (parallel.mesh.global_losses), so
that each rank's loss is its rows' share of the global batch's loss
(train/pnp_engine.py, train/engine.py); None divides by this batch's own.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

Total = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=like.dtype, device=like.device)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor,
                 total: Total = None) -> torch.Tensor:
    """Mean of values where mask, 0 if mask is empty (the reference's
    `0.0 if nan` guards, train_utils.py:56-71)."""
    mask = mask.to(values.dtype)
    count = mask.sum()
    if total is not None:
        count = total(count)
    return torch.where(count > 0,
                       (values * mask).sum() / torch.clamp(count, min=1),
                       _zero(values))


def _weighted_nll(log_probs: torch.Tensor, targets: torch.Tensor,
                  weights: torch.Tensor, mask: torch.Tensor,
                  total: Total = None) -> torch.Tensor:
    """torch.nn.NLLLoss(weight=w) semantics: sum(w[y] * -logp[y]) / sum(w[y])
    over masked rows (reference train_test.py:109-112)."""
    safe_t = torch.clamp(targets, 0, log_probs.shape[-1] - 1).long()
    nll = -torch.gather(log_probs, 1, safe_t[:, None])[:, 0]
    w = weights[safe_t] * mask.to(log_probs.dtype)
    wsum = w.sum()
    if total is not None:
        wsum = total(wsum)
    return torch.where(wsum > 0,
                       (nll * w).sum() / torch.clamp(wsum, min=1e-12),
                       _zero(nll * w))


def relation_loss(relation: torch.Tensor,
                  super_relation: Optional[torch.Tensor],
                  targets: torch.Tensor, connected: torch.Tensor,
                  class_weights: torch.Tensor, num_geometric: int,
                  num_possessive: int, hierarchical: bool,
                  total: Total = None) -> torch.Tensor:
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
                             class_weights, connected, total)
    ng, npos = num_geometric, num_possessive
    # super-category target: 0 geometric / 1 possessive / 2 semantic
    # (reference utils.py:28-35)
    sup_t = torch.where(targets < ng, 0, torch.where(targets < ng + npos,
                                                     1, 2))
    loss = _weighted_nll(super_relation, sup_t,
                         torch.ones(3, dtype=super_relation.dtype,
                                    device=super_relation.device),
                         connected, total)
    branches = [(0, ng), (ng, npos), (ng + npos,
                                      relation.shape[1] - ng - npos)]
    for offset, width in branches:
        in_branch = connected & (targets >= offset) \
            & (targets < offset + width)
        loss = loss + _weighted_nll(
            relation[:, offset:offset + width], targets - offset,
            class_weights[offset:offset + width], in_branch, total)
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
                      valid: torch.Tensor, lambda_not_connected: float,
                      total: Total = None) -> ConnectivityStats:
    """BCE-with-logits on the connectivity head over all valid directed
    pairs: target 1 for connected, 0 otherwise; the not-connected term is
    scaled by lambda_not_connected (reference train_utils.py:64-92)."""
    connected = connected & valid
    not_connected = valid & ~connected
    loss = lambda_not_connected * _masked_mean(_softplus(logits),
                                               not_connected, total) \
        + _masked_mean(_softplus(-logits), connected, total)
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
                     hierarchical: bool, total: Total = None
                     ) -> torch.Tensor:
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
    return lambda_weak * _masked_mean(rel_prob, mask & ~in_yes, total) \
        + lambda_strong * _masked_mean(rel_prob, mask & in_no, total)


def faithful_losses(model_cfg, train_cfg, relation: torch.Tensor,
                    super_relation: Optional[torch.Tensor],
                    conn_logits: torch.Tensor, rel_targets: torch.Tensor,
                    valid: torch.Tensor, class_weights: torch.Tensor,
                    sub_cats: Optional[torch.Tensor] = None,
                    obj_cats: Optional[torch.Tensor] = None,
                    cs_tables=None,
                    loss_contrast: Optional[torch.Tensor] = None,
                    total: Total = None):
    """Reference-faithful training dynamics, as masked grid math.

    The reference's triangular Python loop computes every loss term as a
    per-COLUMN mean (a column = one (subject_slot, object_slot) grid cell
    over the batch) and accumulates the columns with three loop artifacts
    that the clean estimator (engine.compute_losses) drops:

      * connectivity rebinding: a column with any connected row REPLACES
        its not-connected BCE term with the connected-row BCE (reference
        train_utils.py:70-92);
      * triangular re-accumulation: column-direction s (0-based, E in all)
        weighs (E - s) in the backward loss (reference
        train_test.py:219-258);
      * lambda_contrast applied twice (train_test.py:268-272).

    Inputs are grids: relation (B, N, N, R) branch log-probs (or flat
    logits), super_relation (B, N, N, 3) or None, conn_logits (B, N, N),
    rel_targets (B, N, N) int (-1 = none), valid (B, N), sub/obj_cats
    (B, N) (train_cs only).  Sums run in relation.dtype, as in the JAX
    package.  Returns (total, metrics): the plain per-term column sums and
    `lr_scale`, the dynamic-LR factor sqrt(#images at the batch-max object
    count / B) in effect at the reference's optimizer.step()
    (train_test.py:192).  With `total` every per-cell count and weight sum
    is the group's, and so are a column's connected rows (the rebinding),
    the batch-max object count and its share of the images (the weights,
    lr_scale)."""
    m = model_cfg
    b, n = valid.shape
    dt = relation.dtype
    dev = relation.device
    zero = torch.zeros((), dtype=dt, device=dev)
    if loss_contrast is None:
        loss_contrast = torch.zeros((), dtype=torch.float32, device=dev)

    eye = torch.eye(n, dtype=torch.bool, device=dev)
    rv = valid[:, :, None] & valid[:, None, :] & ~eye[None]
    connected = rv & (rel_targets >= 0)

    def tot(t):
        return t if total is None else total(t)

    def cell_mean(v, mask, cnt=None):
        mk = mask.to(dt)
        if cnt is None:
            cnt = tot(mk.sum(0))
        return torch.where(cnt > 0, (v * mk).sum(0) / torch.clamp(cnt, min=1),
                           zero)

    def cell_weighted_nll(logp, tgt, w, mask):
        safe = torch.clamp(tgt, 0, logp.shape[-1] - 1).long()
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        ww = w[safe] * mask.to(dt)
        wsum = tot(ww.sum(0))
        return torch.where(wsum > 0, (nll * ww).sum(0)
                           / torch.clamp(wsum, min=1e-12), zero)

    # connectivity with the rebinding quirk
    conn_cnt = tot(connected.to(dt).sum(0))
    pos_cell = cell_mean(_softplus(-conn_logits), connected, conn_cnt)
    neg_cell = cell_mean(_softplus(conn_logits), rv & ~connected)
    conn_cell = torch.where(conn_cnt > 0, pos_cell,
                            train_cfg.lambda_not_connected * neg_cell)

    # relationship per column
    ng, npos = m.num_geometric, m.num_possessive
    if m.hierarchical_pred:
        sup_t = torch.where(rel_targets < ng, 0,
                            torch.where(rel_targets < ng + npos, 1, 2))
        rel_cell = cell_weighted_nll(super_relation, sup_t,
                                     torch.ones(3, dtype=dt, device=dev),
                                     connected)
        for off, width in ((0, ng), (ng, npos),
                           (ng + npos, relation.shape[-1] - ng - npos)):
            in_b = connected & (rel_targets >= off) \
                & (rel_targets < off + width)
            rel_cell = rel_cell + cell_weighted_nll(
                relation[..., off:off + width], rel_targets - off,
                class_weights[off:off + width], in_b)
    else:
        rel_cell = cell_weighted_nll(F.log_softmax(relation, dim=-1),
                                     rel_targets, class_weights, connected)

    # commonsense per column (train_cs): entry means over (branch, batch)
    cs_cell = torch.zeros((n, n), dtype=dt, device=dev)
    if cs_tables is not None:
        aligned, violated = cs_tables
        if m.hierarchical_pred:
            bounds = ((0, ng), (ng, ng + npos),
                      (ng + npos, relation.shape[-1]))
        else:
            bounds = ((0, relation.shape[-1]),)
        probs = torch.stack([F.softmax(relation[..., lo:hi], dim=-1)
                             .max(dim=-1).values for lo, hi in bounds])
        preds = torch.stack([relation[..., lo:hi].argmax(dim=-1) + lo
                             for lo, hi in bounds])       # (K, B, N, N)
        sub = sub_cats.long()[None, :, :, None]
        obj = obj_cats.long()[None, :, None, :]
        tid = (sub * relation.shape[-1] + preds) * m.num_classes + obj
        k = probs.shape[0]
        rvk = rv[None].expand(k, b, n, n)
        probs2 = probs.reshape(k * b, n, n)
        weak = (rvk & ~aligned[tid]).reshape(k * b, n, n)
        strong = (rvk & violated[tid]).reshape(k * b, n, n)
        cs_cell = train_cfg.lambda_cs_weak * cell_mean(probs2, weak) \
            + train_cfg.lambda_cs_strong * cell_mean(probs2, strong)

    # triangular re-accumulation weights
    # the images by valid-object count (the group's with `total`)
    hist = tot(F.one_hot(valid.sum(1), n + 1).sum(0).to(dt))
    n_max = torch.where(hist > 0, torch.arange(n + 1, device=dev), 0).max()
    e_total = (n_max * (n_max - 1)).to(dt)
    i = torch.arange(n, device=dev)[:, None]
    j = torch.arange(n, device=dev)[None, :]
    s_lower = 2 * (i * (i - 1) // 2 + j)              # direction 1 (i > j)
    s_upper = 2 * (j * (j - 1) // 2 + i) + 1          # direction 2 (i < j)
    s_idx = torch.where(i > j, s_lower, s_upper).to(dt)
    tri_w = torch.clamp(e_total - s_idx, min=0.0)

    lam_c = train_cfg.lambda_connectivity
    lam_cs = train_cfg.lambda_commonsense
    tri_total = (tri_w * (rel_cell + lam_c * conn_cell
                          + lam_cs * cs_cell)).sum()
    total = tri_total \
        + train_cfg.lambda_contrast ** 2 * loss_contrast  # applied twice

    prob = torch.sigmoid(conn_logits)
    pred_pos = (prob >= 0.5) & rv

    def count(mask):
        return mask.sum().to(torch.int32)

    metrics = {
        "loss": total,
        "loss_relationship": rel_cell.sum(),
        "loss_connectivity": conn_cell.sum(),
        "loss_commonsense": cs_cell.sum(),
        "loss_contrast": loss_contrast,
        "num_connected": count(connected),
        "num_not_connected": count(rv & ~connected),
        "num_connected_pred": count(pred_pos),
        "connectivity_precision_hits": count(pred_pos & connected),
        "connectivity_recall_hits": count((prob >= 0.5) & connected),
        "lr_scale": torch.sqrt(hist[n_max] / hist.sum()),
    }
    return total, metrics


def _parent(labels: torch.Tensor, num_geometric: int,
            num_possessive: int) -> torch.Tensor:
    return torch.where(labels < num_geometric, 0,
                       torch.where(labels < num_geometric + num_possessive,
                                   1, 2))


def supcon_hierar_loss(features: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor, num_geometric: int,
                       num_possessive: int, temperature: float = 0.07,
                       base_temperature: float = 0.07, total: Total = None,
                       contrast: Optional[Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]] = None,
                       offset: int = 0) -> torch.Tensor:
    """Hierarchical supervised-contrastive loss (reference
    sup_contrast/losses.py:85-181) with padding masks.

    features: (M, 2, D) two views (plain and augmented) of each connected
    pair's hidden state; labels: (M,) relation id; valid: (M,) bool.  Each
    anchor's softmax denominator is restricted to samples whose relation
    has the same super-category parent.

    `contrast` (with `total`): (features, labels, valid) of every rank's
    samples, this batch's at rows [offset, offset + M) (gathered over the
    data group, the features by parallel.mesh.gather_rows).  The anchors
    are then this batch's, the samples they contrast with every rank's, and
    the mean is over the group's valid anchors: the rank's share of the
    global batch's loss.  Without, the samples are this batch's."""
    m, n_views, _ = features.shape

    def view_major(features, labels, valid):
        # contrast_feature = cat(unbind(features, dim=1)): view-major
        feats = torch.where(valid[:, None, None], features, _zero(features))
        labels = labels.repeat(n_views)
        return (torch.cat([feats[:, i, :] for i in range(n_views)], dim=0),
                labels, _parent(labels, num_geometric, num_possessive),
                valid.repeat(n_views))

    z, big_labels, big_parent, big_valid = view_major(features, labels,
                                                      valid)
    if contrast is None:
        contrast = (features, labels, valid)
    mc = contrast[0].shape[0]
    zc, labels_c, parent_c, valid_c = view_major(*contrast)
    self_col = torch.cat([torch.arange(m, device=z.device) + v * mc + offset
                          for v in range(n_views)])
    not_self = torch.arange(mc * n_views, device=z.device)[None, :] \
        != self_col[:, None]

    logits = (z @ zc.T) / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()

    both_valid = big_valid[:, None] & valid_c[None, :]
    pos_mask = ((big_labels[:, None] == labels_c[None, :]) & not_self
                & both_valid).to(logits.dtype)
    den_mask = ((big_parent[:, None] == parent_c[None, :]) & not_self
                & both_valid).to(logits.dtype)

    exp_logits = torch.exp(logits) * den_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True)
                                  + 1e-7)
    mean_log_prob_pos = (pos_mask * log_prob).sum(dim=1) \
        / (pos_mask.sum(dim=1) + 1e-7)
    per_anchor = -(temperature / base_temperature) * mean_log_prob_pos
    return _masked_mean(per_anchor, big_valid, total)
