"""Plain PyTorch reference of HIERCOM's relation head, its losses and its
optimizer (bowen-upenn/scene_graph_commonsense: model.py, train_utils.py,
sup_contrast/losses.py, train_test.py), written from the published model
and nothing of the port.

The forward is the published per-pair form: each object's masked stack
[features * mask ++ depth * mask] through a 1x1 conv and tanh (conv1 of the
subject and of the object stream), the pair's two maps concatenated through
one 3x3 conv (conv2), ReLU, 2x2 max pool, a 3x3 conv (conv3), ReLU, 2x2
max pool, fc1, ReLU, dropout, then fc2 on [h ++ onehot(c_sub) ++
onehot(c_obj) ++ super_sub ++ super_obj], ReLU, dropout, and the heads: a
connectivity logit, three super-class branches composed with the
super-class log-probability (Bayes' rule), and its log-softmax.

Parameters are named by the layer they feed.  conv2's weight is stored as
its subject half `conv2_sub.weight` and object half `conv2_obj.weight` (the
bias as `conv2_obj.bias`), and fc2's as `fc2_h`, `emb_c1`, `emb_c2`,
`fc2_s1`, `fc2_s2`, the blocks of the one matrix; fc1 reads the pooled map
flattened in (y, x, channel) order.  The reference concatenates them and
applies the layers whole.

Runs in float32 with TF32 off.  `q`, where a function takes it, rounds the
operands of every convolution and matrix product (the lower-precision
control); None leaves them as they are.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import full_float32

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _q(q: Quant, x: torch.Tensor) -> torch.Tensor:
    return x if q is None else q(x)


def param_shapes(conf: Dict) -> Dict[str, tuple]:
    """Name -> shape of every parameter of the head the configuration
    describes."""
    m = conf["model"]
    h, s = m["hidden_dim"], m["feature_size"]
    cin = m["num_img_feature"] + 1
    shapes = {
        "conv1_sub.weight": (h, cin, 1, 1), "conv1_sub.bias": (h,),
        "conv1_obj.weight": (h, cin, 1, 1), "conv1_obj.bias": (h,),
        "conv2_sub.weight": (4 * h, h, 3, 3),
        "conv2_obj.weight": (4 * h, h, 3, 3), "conv2_obj.bias": (4 * h,),
        "conv3.weight": (8 * h, 4 * h, 3, 3), "conv3.bias": (8 * h,),
        "fc1.weight": (4096, 8 * h * (s // 4) ** 2), "fc1.bias": (4096,),
        "fc2_h.weight": (512, 4096), "fc2_h.bias": (512,),
        "emb_c1.weight": (m["num_classes"], 512),
        "emb_c2.weight": (m["num_classes"], 512),
    }
    if conf["use_super"]:
        shapes["fc2_s1.weight"] = (512, m["num_super_classes"])
        shapes["fc2_s2.weight"] = (512, m["num_super_classes"])
    shapes.update({"fc4.weight": (1, 512), "fc4.bias": (1,)})
    for i, k in enumerate((m["num_geometric"], m["num_possessive"],
                           m["num_semantic"]), 1):
        shapes[f"fc3_{i}.weight"] = (k, 512)
        shapes[f"fc3_{i}.bias"] = (k,)
    shapes.update({"fc5.weight": (3, 512), "fc5.bias": (3,)})
    return shapes


def box_masks(boxes: torch.Tensor, size: int) -> torch.Tensor:
    """(..., 4) boxes (x0, x1, y0, y1) -> (..., size, size) float masks,
    mask[int(y0):int(y1), int(x0):int(x1)] = 1."""
    b = torch.clamp(torch.trunc(boxes), 0, size)
    grid = torch.arange(size, device=boxes.device, dtype=boxes.dtype)
    ys = (grid[:, None] >= b[..., 2, None, None]) \
        & (grid[:, None] < b[..., 3, None, None])
    xs = (grid[None, :] >= b[..., 0, None, None]) \
        & (grid[None, :] < b[..., 1, None, None])
    return (ys & xs).to(torch.float32)


def enumerate_pairs(ok: np.ndarray, capacity: int) -> np.ndarray:
    """(B, N, N) bool -> (P, 3) int64 (image, subject, object) of the True
    entries in image-, subject-, object-major order, the first `capacity`
    of them (a buffer of that many pairs keeps these)."""
    return np.argwhere(ok)[:capacity]


def valid_pairs(valid: np.ndarray) -> np.ndarray:
    """(B, N) -> (B, N, N): both objects valid, no self-pairs."""
    v = np.asarray(valid, bool)
    return v[:, :, None] & v[:, None, :] & ~np.eye(v.shape[1], dtype=bool)


def object_maps(p: Dict[str, torch.Tensor], features: torch.Tensor,
                depth: torch.Tensor, boxes: torch.Tensor, q: Quant = None):
    """conv1 and tanh of each object's masked stack, per stream.
    features (B, S, S, C), depth (B, S, S, 1), boxes (B, N, 4).  Returns
    (u_sub, u_obj), each (B, N, h, S, S)."""
    b, s = features.shape[:2]
    n = boxes.shape[1]
    x = torch.cat([features, depth], dim=-1).permute(0, 3, 1, 2)  # B,C+1,S,S
    m = box_masks(boxes, s)                                        # B,N,S,S
    stack = (x[:, None] * m[:, :, None]).reshape(b * n, x.shape[1], s, s)
    outs = []
    for name in ("conv1_sub", "conv1_obj"):
        u = torch.tanh(F.conv2d(_q(q, stack), _q(q, p[name + ".weight"]),
                                p[name + ".bias"]))
        outs.append(u.reshape(b, n, -1, s, s))
    return outs[0], outs[1]


def pair_forward(p: Dict[str, torch.Tensor], conf: Dict, u_sub, u_obj,
                 pairs: torch.Tensor, cats: torch.Tensor,
                 super_mh: Optional[torch.Tensor],
                 keep: Sequence[Optional[torch.Tensor]] = (None, None),
                 q: Quant = None) -> Dict[str, torch.Tensor]:
    """The pair stage and the heads over `pairs` (P, 3) (image, subject,
    object).  keep = (keep mask after fc1 (P, 4096), after fc2 (P, 512)),
    None for no dropout."""
    m = conf["model"]
    rate = m["dropout_rate"]
    img, si, oj = pairs[:, 0], pairs[:, 1], pairs[:, 2]
    x = torch.cat([u_sub[img, si], u_obj[img, oj]], dim=1)
    w2 = torch.cat([p["conv2_sub.weight"], p["conv2_obj.weight"]], dim=1)
    x = F.conv2d(_q(q, x), _q(q, w2), p["conv2_obj.bias"], padding=1)
    x = F.max_pool2d(torch.relu(x), 2)
    x = F.conv2d(_q(q, x), _q(q, p["conv3.weight"]), p["conv3.bias"],
                 padding=1)
    x = F.max_pool2d(torch.relu(x), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)      # (y, x, c)
    h = torch.relu(F.linear(_q(q, x), _q(q, p["fc1.weight"]),
                            p["fc1.bias"]))
    if keep[0] is not None:
        h = torch.where(keep[0], h / (1 - rate), torch.zeros_like(h))
    c = m["num_classes"]
    parts = [h, F.one_hot(cats[img, si].long(), c).float(),
             F.one_hot(cats[img, oj].long(), c).float()]
    blocks = [p["fc2_h.weight"], p["emb_c1.weight"].t(),
              p["emb_c2.weight"].t()]
    if conf["use_super"]:
        parts += [super_mh[img, si], super_mh[img, oj]]
        blocks += [p["fc2_s1.weight"], p["fc2_s2.weight"]]
    z = F.linear(_q(q, torch.cat(parts, dim=1)),
                 _q(q, torch.cat(blocks, dim=1)), p["fc2_h.bias"])
    pred = torch.relu(z)
    if keep[1] is not None:
        pred = torch.where(keep[1], pred / (1 - rate), torch.zeros_like(pred))

    def dense(name):
        return F.linear(_q(q, pred), _q(q, p[name + ".weight"]),
                        p[name + ".bias"])

    sup = F.log_softmax(dense("fc5"), dim=1)
    temps = (m["T1"], m["T2"], m["T3"])
    rels = [F.log_softmax(dense(f"fc3_{i + 1}") / temps[i], dim=1)
            + sup[:, i:i + 1] for i in range(3)]
    return {"hidden": pred, "connectivity": dense("fc4")[:, 0],
            "relation": torch.cat(rels, dim=1), "super_relation": sup}


def _nll(logp: torch.Tensor, target: torch.Tensor, weight: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """torch.nn.NLLLoss(weight) over the masked rows; 0 when none."""
    t = torch.clamp(target, 0, logp.shape[1] - 1)
    w = weight[t] * mask
    nll = -logp.gather(1, t[:, None])[:, 0]
    total = w.sum()
    return (nll * w).sum() / total if total > 0 else nll.sum() * 0


def _masked_mean(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    count = mask.sum()
    return (v * mask).sum() / count if count > 0 else v.sum() * 0


def relation_losses(out: Dict, targets: torch.Tensor, class_weights,
                    conf: Dict) -> torch.Tensor:
    """Hierarchical relation loss + lambda_connectivity * connectivity BCE
    over one view's pairs; targets -1 where unrelated."""
    m, t = conf["model"], conf["training"]
    ng, npos = m["num_geometric"], m["num_possessive"]
    conn = (targets >= 0).float()
    sup_t = torch.where(targets < ng, 0, torch.where(targets < ng + npos,
                                                     1, 2))
    loss = _nll(out["super_relation"], sup_t,
                torch.ones(3, device=targets.device), conn)
    for off, width in ((0, ng), (ng, npos),
                       (ng + npos, m["num_relations"] - ng - npos)):
        inb = conn * ((targets >= off) & (targets < off + width)).float()
        loss = loss + _nll(out["relation"][:, off:off + width],
                           targets - off, class_weights[off:off + width],
                           inb)
    logit = out["connectivity"]
    bce = t["lambda_not_connected"] * _masked_mean(
        F.softplus(logit, threshold=1e9), 1 - conn) \
        + _masked_mean(F.softplus(-logit, threshold=1e9), conn)
    return loss + t["lambda_connectivity"] * bce


def supcon_hierar(features: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor, conf: Dict) -> torch.Tensor:
    """Hierarchical SupCon (sup_contrast/losses.py): features (M, 2, D),
    two views of each connected pair; the softmax denominator of an anchor
    runs over the samples whose relation shares its super-class."""
    m = conf["model"]
    ng, npos = m["num_geometric"], m["num_possessive"]
    temp = conf["training"]["supcon_temperature"]
    keep = valid.float()
    z = torch.cat([features[:, 0] * keep[:, None],
                   features[:, 1] * keep[:, None]])
    lab = labels.repeat(2)
    par = torch.where(lab < ng, 0, torch.where(lab < ng + npos, 1, 2))
    ok = valid.repeat(2)
    n = z.shape[0]
    logits = z @ z.t() / temp
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    both = ok[:, None] & ok[None, :] & ~torch.eye(n, dtype=torch.bool,
                                                  device=z.device)
    pos = ((lab[:, None] == lab[None, :]) & both).float()
    den = ((par[:, None] == par[None, :]) & both).float()
    log_prob = logits - torch.log((torch.exp(logits) * den).sum(
        1, keepdim=True) + 1e-7)
    mean_pos = (pos * log_prob).sum(1) / (pos.sum(1) + 1e-7)
    return _masked_mean(-mean_pos, ok.float())


def dropout_keeps(seed: int, step: int, rank: int, rows: Sequence[int],
                  device) -> List[torch.Tensor]:
    """The four keep masks of one train step (main view after fc1 and after
    fc2, augmented view likewise), drawn as the configuration's dropout is
    keyed: streams seeded by numpy's SeedSequence of (seed, step[, rank])
    into torch generators on the device, one Bernoulli(keep) draw of each
    site's whole buffer (rows[0] main rows, rows[1] augmented rows)."""
    key = [seed, step] if rank == 0 else [seed, step, rank]
    seeds = np.random.SeedSequence(key).generate_state(4, np.uint64)
    shapes = [(rows[0], 4096), (rows[0], 512), (rows[1], 4096),
              (rows[1], 512)]
    return [torch.empty(shape, device=device).bernoulli_(
        0.5, generator=torch.Generator(device=device).manual_seed(
            int(s) >> 1)) > 0 for s, shape in zip(seeds, shapes)]


def batch_loss(p: Dict[str, torch.Tensor], conf: Dict, batch: Dict,
               keeps: Sequence[torch.Tensor], class_weights: torch.Tensor,
               capacity: int, aug_capacity: int,
               q: Quant = None) -> torch.Tensor:
    """The train loss of one batch (numpy arrays): the main view over the
    first `capacity` valid pairs, and where the batch has features_aug the
    augmented view over the first `aug_capacity` connected pairs feeding
    SupCon with the main view's hidden states of the same pairs."""
    dev = class_weights.device
    t = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    ok = valid_pairs(batch["valid"])
    main = enumerate_pairs(ok, capacity)
    pairs = torch.as_tensor(main, device=dev)
    rel = t["rel"].long()
    targets = rel[pairs[:, 0], pairs[:, 1], pairs[:, 2]]
    u_s, u_o = object_maps(p, t["features"], t["depth"], t["boxes"], q)
    out = pair_forward(p, conf, u_s, u_o, pairs, t["cats"],
                       t.get("super_mh"), (keeps[0][:len(main)],
                                           keeps[1][:len(main)]), q)
    loss = relation_losses(out, targets, class_weights, conf)
    if "features_aug" in batch:
        conn = enumerate_pairs(ok & (batch["rel"] >= 0), aug_capacity)
        cpairs = torch.as_tensor(conn, device=dev)
        a_s, a_o = object_maps(p, t["features_aug"], t["depth"], t["boxes"],
                               q)
        out_c = pair_forward(p, conf, a_s, a_o, cpairs, t["cats"],
                             t.get("super_mh"), (keeps[2][:len(conn)],
                                                 keeps[3][:len(conn)]), q)
        where = {tuple(r): i for i, r in enumerate(main.tolist())}
        pos = [where.get(tuple(r), 0) for r in conn.tolist()]
        found = torch.as_tensor([tuple(r) in where for r in conn.tolist()],
                                device=dev, dtype=torch.bool)
        feats = torch.stack([out["hidden"][pos], out_c["hidden"]], dim=1)
        labels = rel[cpairs[:, 0], cpairs[:, 1], cpairs[:, 2]]
        loss = loss + conf["training"]["lambda_contrast"] * supcon_hierar(
            feats, labels, found, conf)
    return loss


def class_weights(conf: Dict, device) -> torch.Tensor:
    """1 - count / sum of the configuration's predicate counts."""
    c = np.asarray(conf["relation_counts"], np.float64)
    return torch.as_tensor((1.0 - c / c.sum()).astype(np.float32),
                           device=device)


def train_steps(conf: Dict, params0: Dict[str, torch.Tensor],
                rank_batches: Sequence[Sequence[Dict]], seed: int,
                capacity: int, aug_capacity: int, q: Quant = None,
                ) -> Dict:
    """The configuration's train steps from params0: rank_batches[k] holds
    step k's batch of each data-parallel rank (one for a single card); a
    step's gradient is the mean of the ranks' gradients of their own
    losses, clipped by global norm where the configuration sets a clip,
    weight decay added, then momentum SGD in float32.  Returns each step's
    loss (the ranks' mean), each parameter's norm of the first step's
    gradient as the optimizer got it, and of its change over all the
    steps."""
    full_float32()
    t = conf["training"]
    dev = next(iter(params0.values())).device
    weights = class_weights(conf, dev)
    p = {k: v.detach().clone() for k, v in params0.items()}
    trace = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad_norms = [], None
    for step, batches in enumerate(rank_batches):
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        step_loss = 0.0
        for rank, batch in enumerate(batches):
            leaves = {k: v.requires_grad_(True) for k, v in p.items()}
            keeps = dropout_keeps(seed, step, rank, (capacity, aug_capacity),
                                  dev)
            loss = batch_loss(leaves, conf, batch, keeps, weights, capacity,
                              aug_capacity, q)
            g = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
            for k, gk in zip(leaves, g):
                if gk is not None:
                    grads[k] += gk / len(batches)
            step_loss += float(loss.detach()) / len(batches)
            p = {k: v.detach() for k, v in p.items()}
        losses.append(step_loss)
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum()
                                  for g in grads.values()))
            if t["grad_clip_norm"] > 0 and norm >= t["grad_clip_norm"]:
                for g in grads.values():
                    g.mul_(float(t["grad_clip_norm"] / norm))
            if step == 0:
                grad_norms = {k: float(g.double().norm())
                              for k, g in grads.items()}
            for k in p:
                g = grads[k] + t["weight_decay"] * p[k]
                trace[k] = g + t["momentum"] * trace[k]
                p[k] = p[k] - t["learning_rate"] * trace[k]
    change = {k: float((p[k].double() - params0[k].double()).norm())
              for k in p}
    return {"loss": losses, "grad_norms": grad_norms,
            "change_norms": change, "params": p}


@torch.no_grad()
def eval_scores(p: Dict[str, torch.Tensor], conf: Dict, features,
                depth, batch: Dict, block: int = 256, q: Quant = None):
    """The deterministic forward over every valid pair of a request (its own
    features (B, S, S, C)): (pairs (P, 3) numpy, relation (P, R),
    connectivity (P,)), in blocks of `block` pairs."""
    dev = features.device
    boxes = torch.as_tensor(batch["boxes"], device=dev)
    cats = torch.as_tensor(batch["cats"], device=dev)
    sup = batch.get("super_mh")
    sup = None if sup is None else torch.as_tensor(sup, device=dev)
    u_s, u_o = object_maps(p, features.float(), depth.float(), boxes, q)
    pairs = enumerate_pairs(valid_pairs(batch["valid"]), 1 << 30)
    rel, conn = [], []
    for lo in range(0, len(pairs), block):
        pr = torch.as_tensor(pairs[lo:lo + block], device=dev)
        out = pair_forward(p, conf, u_s, u_o, pr, cats, sup, q=q)
        rel.append(out["relation"])
        conn.append(out["connectivity"])
    return pairs, torch.cat(rel), torch.cat(conn)


def candidate_scores(conf: Dict, batch: Dict, pairs: np.ndarray,
                     relation: np.ndarray, connectivity: np.ndarray,
                     top_k: int) -> List[Dict]:
    """PredCLS ranking (train_test.py's evaluation), per image: a pair whose
    two box masks share a grid cell scores each predicate by its composed
    log-probability plus log sigmoid(connectivity); its candidates are the
    best predicate of each super-class branch.  Returns per image "all",
    (subject slot, object slot, predicate) -> score for every predicate of
    every such pair, and "best", the top_k candidates' scores, best
    first."""
    m = conf["model"]
    ng, npos = m["num_geometric"], m["num_possessive"]
    s = m["feature_size"]
    b = np.clip(np.trunc(np.asarray(batch["boxes"], np.float64)), 0, s)
    img, si, oj = pairs[:, 0], pairs[:, 1], pairs[:, 2]
    bs, bo = b[img, si], b[img, oj]
    iw = np.minimum(bs[:, 1], bo[:, 1]) - np.maximum(bs[:, 0], bo[:, 0])
    ih = np.minimum(bs[:, 3], bo[:, 3]) - np.maximum(bs[:, 2], bo[:, 2])
    overlap = (iw > 0) & (ih > 0)
    conn = -np.logaddexp(0.0, -np.asarray(connectivity, np.float64))
    score = np.asarray(relation, np.float64) + conn[:, None]
    bounds = ((0, ng), (ng, ng + npos), (ng + npos, score.shape[1]))
    out = []
    for i in range(np.asarray(batch["cats"]).shape[0]):
        rows = np.nonzero((img == i) & overlap)[0]
        every = {(int(si[k]), int(oj[k]), r): float(score[k, r])
                 for k in rows for r in range(score.shape[1])}
        best = sorted((float(score[k, lo:hi].max()) for k in rows
                       for lo, hi in bounds), reverse=True)[:top_k]
        out.append({"all": every, "best": best})
    return out
