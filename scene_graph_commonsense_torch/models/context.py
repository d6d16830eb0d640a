"""Object-context encoders of the plug-and-play model families (torch port
of scene_graph_commonsense_tpu/models/context.py).

The reference grafts its hierarchical head onto Scene-Graph-Benchmark
context models (reference README_PLUGANDPLAY.md:56-158).  Over the fixed
(B, N_max) padded object layout:

  * MaskedBiLSTM       bidirectional LSTM whose carry is frozen and whose
    output is zero at padded positions (any mask, not only prefixes);
  * MotifsContext      Neural Motifs (Zellers et al. 2018): masked biLSTMs
    over [visual, label embedding, box embedding], soft label decoding
    outside predcls;
  * TransformerContext the SGB Transformer predictor's pre-LN encoder with
    padding masked out of the attention;
  * VCTreeContext      VCTree (Tang et al. 2019): Prim's maximum spanning
    arborescence in N-1 fixed iterations, then a level-synchronous
    bidirectional tree GRU (every node updated per level, only the level's
    nodes committed);
  * VTransEContext     VTransE (Zhang et al. 2017): no context propagation,
    a projection of [visual, label embedding, box geometry].

Every encoder maps (feats (B,N,D), boxes (B,N,4), labels (B,N) int,
valid (B,N) bool) to (edge context (B,N,2H), object logits (B,N,C)).

Parameter names follow the flax tree (models/weights.predictor_from_flax):
flax's OptimizedLSTMCell keeps eight kernels, ii/if/ig/io and hi/hf/hg/ho;
here they are two Linear layers per cell, `i` (no bias) and `h`, each the
four gates concatenated in the order i, f, g, o.  flax's attention kernels
(D, heads, head_dim) are Linear layers on the flattened heads.  The layers
a flax module gives `dtype` compute in `dtype`; LayerNorm (eps 1e-6, as in
flax), the LSTM and the tree GRU compute in the promoted dtype of their
inputs and weights, as flax does; logits are cast to float32 where the JAX
package casts them.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from scene_graph_commonsense_torch.models.relation_head import (
    _dense, _embed)
from scene_graph_commonsense_torch.ops.nms import box_iou_xyxy

LN_EPS = 1e-6                 # flax nn.LayerNorm's default epsilon


def box_position_features(boxes: torch.Tensor, size: float = 32.0
                          ) -> torch.Tensor:
    """(..., 4) boxes (x_min, x_max, y_min, y_max) on a `size` grid ->
    (..., 9) normalized geometry [x1, y1, x2, y2, cx, cy, w, h, area]
    (Motifs' encode_box_info)."""
    b = boxes / size
    x1, x2, y1, y2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    w, h = x2 - x1, y2 - y1
    return torch.stack([x1, y1, x2, y2, (x1 + x2) / 2, (y1 + y2) / 2,
                        w, h, w * h], dim=-1)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A flax Dense without `dtype`: computes in the promoted dtype of the
    input and the weights."""
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-image gather: x (B, N, ...) at idx (B, P) -> (B, P, ...)."""
    idx = idx.long()
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(
        x, 1, idx[..., None].expand(-1, -1, *x.shape[2:]))


class _LSTMCell(nn.Module):
    """flax OptimizedLSTMCell's parameters, gates (i, f, g, o) stacked."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.i = nn.Linear(in_features, 4 * features, bias=False)
        self.h = nn.Linear(features, 4 * features)


class _MaskedLSTM(nn.Module):
    """One direction of MaskedBiLSTM: every step runs, a masked step leaves
    the carry as it was and outputs 0."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        self.cell = _LSTMCell(in_features, features)

    def forward(self, xs: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        b, n, _ = xs.shape
        # the input half of every step's gates in one product
        xi = _linear(self.cell.i, xs)
        zero = xs.new_zeros((b, self.features))
        c = h = zero
        outs = []
        for t in range(n):
            z = _linear(self.cell.h, h) + xi[:, t]
            i, f, g, o = z.chunk(4, dim=-1)
            new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            new_h = torch.sigmoid(o) * torch.tanh(new_c)
            mt = m[:, t, None]
            c = torch.where(mt, new_c, c)
            h = torch.where(mt, new_h, h)
            outs.append(torch.where(mt, new_h, zero))
        return torch.stack(outs, dim=1)


class MaskedBiLSTM(nn.Module):
    """Bidirectional masked LSTM over (B, N, D) with validity (B, N): both
    directions run all N steps, masked steps are the identity on the carry
    (works for any mask, not only prefixes)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.fwd = _MaskedLSTM(in_features, features)
        self.bwd = _MaskedLSTM(in_features, features)

    def forward(self, xs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        m = valid.to(torch.bool)
        fwd = self.fwd(xs, m)
        bwd = self.bwd(xs.flip(1), m.flip(1)).flip(1)
        return torch.cat([fwd, bwd], dim=-1)


class _ContextBase(nn.Module):
    """The label and box embeddings every family starts from."""

    def __init__(self, feature_dim: int, hidden_dim: int, embed_dim: int,
                 num_classes: int, mode: str, box_scale: float,
                 dtype: torch.dtype):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_classes = num_classes
        self.mode = mode
        self.box_scale = box_scale
        self.dtype = dtype
        self.in_features = feature_dim + embed_dim + 32
        self.label_embed = nn.Embedding(num_classes + 1, embed_dim)
        self.box_embed = nn.Linear(9, 32)

    def _inputs(self, feats, boxes, labels):
        """([feats, label embedding, box embedding], the GT labels'
        embedding).  The GT labels are an input only in predcls; in
        sgcls/sgdet the object class is the prediction target and the input
        embedding is the 'unknown' slot 0."""
        dt = self.dtype
        pos = _dense(self.box_embed, box_position_features(
            boxes, self.box_scale).to(dt), dt)
        lab = _embed(self.label_embed,
                     torch.clamp(labels + 1, 0, self.num_classes), dt)
        lab_in = lab if self.mode == "predcls" else _embed(
            self.label_embed, torch.zeros_like(labels), dt)
        return torch.cat([feats.to(dt), lab_in, pos], dim=-1), lab

    def _soft_labels(self, logits: torch.Tensor) -> torch.Tensor:
        """The predicted label distribution re-embedded through the table
        (without its 'unknown' row): the differentiable stand-in for
        Motifs' sequential decode outside predcls."""
        soft = torch.softmax(logits, dim=-1).to(self.dtype)
        table = self.label_embed.weight[1:]
        dt = torch.promote_types(soft.dtype, table.dtype)
        return soft.to(dt) @ table.to(dt)


class MotifsContext(_ContextBase):
    """Neural Motifs object + edge context:

    obj_ctx  = biLSTM([feat, embed(label), embed(box)])     (obj_layers)
    logits   = decode(obj_ctx)
    edge_ctx = biLSTM([obj_ctx, embed(decoded label)])      (edge_layers)
    """

    def __init__(self, feature_dim: int, hidden_dim: int = 256,
                 embed_dim: int = 100, num_classes: int = 150,
                 obj_layers: int = 1, edge_layers: int = 1,
                 mode: str = "predcls", box_scale: float = 32.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(feature_dim, hidden_dim, embed_dim, num_classes,
                         mode, box_scale, dtype)
        h = hidden_dim
        self.obj_layers = obj_layers
        self.edge_layers = edge_layers
        for i in range(obj_layers):
            self.add_module(f"obj_lstm{i}", MaskedBiLSTM(
                self.in_features if i == 0 else 2 * h, h))
        self.decode = nn.Linear(2 * h, num_classes)
        for i in range(edge_layers):
            self.add_module(f"edge_lstm{i}", MaskedBiLSTM(
                2 * h + embed_dim if i == 0 else 2 * h, h))

    def forward(self, feats, boxes, labels, valid):
        x, lab = self._inputs(feats, boxes, labels)
        for i in range(self.obj_layers):
            x = getattr(self, f"obj_lstm{i}")(x, valid)
        obj_ctx = x
        logits = _dense(self.decode, obj_ctx, self.dtype).to(torch.float32)
        dec = lab if self.mode == "predcls" else self._soft_labels(logits)
        y = torch.cat([obj_ctx, dec.to(obj_ctx.dtype)], dim=-1)
        for i in range(self.edge_layers):
            y = getattr(self, f"edge_lstm{i}")(y, valid)
        return y, logits


class _Attention(nn.Module):
    """flax MultiHeadDotProductAttention (self-attention, no dropout): the
    query scaled by 1/sqrt(head_dim), masked logits set to the dtype's
    finfo.min (a row with every key masked attends uniformly, where a
    boolean SDPA mask would give NaN), the softmax in `dtype`."""

    def __init__(self, features: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.query = nn.Linear(features, features)
        self.key = nn.Linear(features, features)
        self.value = nn.Linear(features, features)
        self.out = nn.Linear(features, features)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b, n, d = x.shape
        hd = d // self.num_heads

        def heads(layer):
            return _dense(layer, x, dt).reshape(b, n, self.num_heads, hd)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        q = q / torch.tensor(math.sqrt(hd), dtype=dt)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = w.masked_fill(~mask, torch.finfo(dt).min)
        w = torch.softmax(w, dim=-1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, d)
        return _dense(self.out, o, dt)


class TransformerContext(_ContextBase):
    """SGB Transformer predictor's context: pre-LN self-attention blocks
    with padding masked out of the attention."""

    def __init__(self, feature_dim: int, hidden_dim: int = 256,
                 embed_dim: int = 100, num_classes: int = 150,
                 num_layers: int = 2, num_heads: int = 4,
                 mode: str = "predcls", box_scale: float = 32.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(feature_dim, hidden_dim, embed_dim, num_classes,
                         mode, box_scale, dtype)
        h = hidden_dim
        self.num_layers = num_layers
        self.proj = nn.Linear(self.in_features, h)
        for i in range(num_layers):
            self.add_module(f"ln_a{i}", nn.LayerNorm(h, eps=LN_EPS))
            self.add_module(f"attn{i}", _Attention(h, num_heads, dtype))
            self.add_module(f"ln_m{i}", nn.LayerNorm(h, eps=LN_EPS))
            self.add_module(f"mlp_in{i}", nn.Linear(h, 4 * h))
            self.add_module(f"mlp_out{i}", nn.Linear(4 * h, h))
        self.decode = nn.Linear(h, num_classes)
        self.edge_proj = nn.Linear(h + embed_dim, 2 * h)

    def forward(self, feats, boxes, labels, valid):
        dt = self.dtype
        x, lab = self._inputs(feats, boxes, labels)
        x = _dense(self.proj, x, dt)
        mask = valid[:, None, None, :] & valid[:, None, :, None]
        for i in range(self.num_layers):
            ln_a = getattr(self, f"ln_a{i}")
            h = F.layer_norm(x, ln_a.normalized_shape, ln_a.weight.to(x.dtype),
                             ln_a.bias.to(x.dtype), LN_EPS)
            x = x + getattr(self, f"attn{i}")(h, mask)
            ln_m = getattr(self, f"ln_m{i}")
            h = F.layer_norm(x, ln_m.normalized_shape, ln_m.weight.to(x.dtype),
                             ln_m.bias.to(x.dtype), LN_EPS)
            h = _dense(getattr(self, f"mlp_in{i}"), h, dt)
            x = x + _dense(getattr(self, f"mlp_out{i}"), torch.relu(h), dt)
        vm = valid[..., None]
        x = torch.where(vm, x, torch.zeros_like(x))
        logits = _dense(self.decode, x, dt).to(torch.float32)
        if self.mode != "predcls":
            lab = self._soft_labels(logits)
        edge = _dense(self.edge_proj, torch.cat([x, lab.to(x.dtype)], -1), dt)
        return torch.where(vm, edge, torch.zeros_like(edge)), logits


def prim_arborescence(scores: torch.Tensor, valid: torch.Tensor,
                      root: torch.Tensor) -> torch.Tensor:
    """Maximum spanning arborescence of each image's N x N pair scores,
    batched: Prim's algorithm as exactly N-1 iterations, each one masked
    argmax over the flattened N x N frontier (ties go to the first flat
    index; an image with no frontier left stops growing).

    scores (B, N, N), valid (B, N) bool, root (B,) -> parent (B, N) int64;
    parent[i] = i for the root and for invalid or unreached nodes."""
    b, n, _ = scores.shape
    ar = torch.arange(n, device=scores.device)
    in_tree = (ar[None] == root[:, None]) & valid
    parent = ar.expand(b, n).clone()
    neg = torch.full((), -math.inf, dtype=scores.dtype, device=scores.device)
    rows = torch.arange(b, device=scores.device)
    for _ in range(n - 1):
        frontier = in_tree[:, :, None] & ~in_tree[:, None, :] \
            & valid[:, None, :]
        s = torch.where(frontier, scores, neg).reshape(b, n * n)
        flat = s.argmax(dim=1)
        pi, ci = flat // n, flat % n
        ok = s[rows, flat] > -math.inf
        in_tree[rows, ci] = in_tree[rows, ci] | ok
        parent[rows, ci] = torch.where(ok, pi, parent[rows, ci])
    return parent


def tree_depths(parent: torch.Tensor) -> torch.Tensor:
    """Depth of each node from parent pointers (B, N) (roots and self-loops
    0) by N pointer-chasing iterations."""
    n = parent.shape[1]
    is_root = parent == torch.arange(n, device=parent.device)[None]
    depth = torch.zeros_like(parent)
    for _ in range(n):
        depth = torch.where(is_root, torch.zeros_like(depth),
                            torch.gather(depth, 1, parent) + 1)
    return depth


class _TreeGRUStep(nn.Module):
    """h = (1 - z) * msg + z * tanh(cand([x, r * msg])), [z, r] =
    sigmoid(gates([x, msg])): the gated update of both tree passes."""

    def __init__(self, features: int):
        super().__init__()
        self.gates = nn.Linear(2 * features, 2 * features)
        self.cand = nn.Linear(2 * features, features)

    def forward(self, x: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
        zr = torch.sigmoid(_linear(self.gates, torch.cat([x, msg], -1)))
        z, r = zr.chunk(2, dim=-1)
        cand = torch.tanh(_linear(self.cand, torch.cat([x, r * msg], -1)))
        return (1 - z) * msg + z * cand


class VCTreeContext(_ContextBase):
    """VCTree context: (1) pair scores, a symmetrized bilinear form on
    projected object features plus the boxes' IoU; (2) Prim's maximum
    spanning arborescence rooted at the highest-scoring valid object; (3) a
    bidirectional tree GRU run level by level, root to leaves (each node
    reads its parent) and leaves to root (each node sums its children,
    index_add_ over the parent index).

    forward returns (edge context (B,N,2H), object logits (B,N,C), pair
    scores (B,N,N)): the scores are what the trainer's structure loss reads
    (Prim's argmax gives the structure no gradient)."""

    def __init__(self, feature_dim: int, hidden_dim: int = 256,
                 embed_dim: int = 100, num_classes: int = 150,
                 mode: str = "predcls", box_scale: float = 32.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(feature_dim, hidden_dim, embed_dim, num_classes,
                         mode, box_scale, dtype)
        h = hidden_dim
        self.proj = nn.Linear(self.in_features, h)
        self.score_q = nn.Linear(h, h)
        self.score_k = nn.Linear(h, h)
        self.rootness = nn.Linear(h, 1)
        self.down = _TreeGRUStep(h)
        self.up = _TreeGRUStep(h)
        self.decode = nn.Linear(2 * h, num_classes)

    def project(self, feats, boxes, labels, valid) -> torch.Tensor:
        """The per-object input of the scores and the tree passes (B,N,H),
        zero at padded objects."""
        x, _ = self._inputs(feats, boxes, labels)
        x = _dense(self.proj, x, self.dtype)
        return torch.where(valid[..., None], x, torch.zeros_like(x))

    def structure(self, x, boxes, valid):
        """(pair scores (B,N,N), parent (B,N), depth (B,N)) of the
        projected objects: 1 and 2 of the class docstring."""
        dt = self.dtype
        n = x.shape[1]
        # 1. pair scores (symmetrized bilinear + overlap prior)
        q = _dense(self.score_q, x, dt)
        k = _dense(self.score_k, x, dt)
        scores = torch.einsum("bnd,bmd->bnm", q, k).to(torch.float32)
        scores = (scores + scores.transpose(1, 2)) / torch.sqrt(
            torch.tensor(float(self.hidden_dim), dtype=torch.float32))
        xyxy = boxes[..., [0, 2, 1, 3]]             # grid conv. -> xyxy
        pair_scores = scores + box_iou_xyxy(xyxy[:, :, None],
                                            xyxy[:, None, :])
        eye = torch.eye(n, dtype=torch.bool, device=x.device)
        masked = pair_scores.masked_fill(eye, -math.inf)

        # 2. structure (no gradient through the argmaxes)
        rootness = _dense(self.rootness, x, dt)[..., 0].to(torch.float32)
        root = torch.where(valid, rootness,
                           torch.full_like(rootness, -math.inf)).argmax(1)
        with torch.no_grad():
            parent = prim_arborescence(masked.detach(), valid, root)
            depth = tree_depths(parent)
        return pair_scores, parent, depth

    def forward(self, feats, boxes, labels, valid):
        dt = self.dtype
        b, n = labels.shape
        x = self.project(feats, boxes, labels, valid)
        vm = valid[..., None]
        pair_scores, parent, depth = self.structure(x, boxes, valid)

        # 3. the level-synchronous bidirectional tree GRU
        ar = torch.arange(n, device=x.device)
        h_down = torch.zeros_like(x)
        for level in range(n):                   # root -> leaves
            msg = _take(h_down, parent)
            cand = self.down(x, msg)
            commit = ((depth == level) & valid)[..., None]
            h_down = torch.where(commit, cand, h_down)
        h_down = torch.where(vm, h_down, torch.zeros_like(h_down))

        h_up = torch.zeros_like(x)
        seg = (parent + (torch.arange(b, device=x.device) * n)[:, None]
               ).reshape(-1)
        for level in range(n - 1, -1, -1):       # leaves -> root
            is_child = ((depth == level + 1) & valid
                        & (parent != ar[None]))[..., None]
            child = torch.where(is_child, h_up, torch.zeros_like(h_up))
            msg = torch.zeros_like(h_up).reshape(b * n, -1).index_add(
                0, seg, child.reshape(b * n, -1)).reshape(b, n, -1)
            cand = self.up(x, msg)
            commit = ((depth == level) & valid)[..., None]
            h_up = torch.where(commit, cand, h_up)
        h_up = torch.where(vm, h_up, torch.zeros_like(h_up))

        ctx = torch.cat([h_down, h_up], dim=-1)
        logits = _dense(self.decode, ctx, dt).to(torch.float32)
        return ctx, logits, pair_scores


class VTransEContext(_ContextBase):
    """VTransE feature extractor: each object's representation is a
    projection of [visual, label embedding, box geometry] (no context
    propagation); the translation embedding lives in the predictor's pair
    stage (HierarchicalPredictor)."""

    def __init__(self, feature_dim: int, hidden_dim: int = 256,
                 embed_dim: int = 100, num_classes: int = 150,
                 mode: str = "predcls", box_scale: float = 32.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(feature_dim, hidden_dim, embed_dim, num_classes,
                         mode, box_scale, dtype)
        h = hidden_dim
        self.proj = nn.Linear(self.in_features, h)
        self.decode = nn.Linear(h, num_classes)
        self.edge_proj = nn.Linear(h + embed_dim, 2 * h)

    def forward(self, feats, boxes, labels, valid):
        dt = self.dtype
        x, lab = self._inputs(feats, boxes, labels)
        x = torch.relu(_dense(self.proj, x, dt))
        vm = valid[..., None]
        x = torch.where(vm, x, torch.zeros_like(x))
        logits = _dense(self.decode, x, dt).to(torch.float32)
        if self.mode != "predcls":
            lab = self._soft_labels(logits)
        edge = _dense(self.edge_proj, torch.cat([x, lab.to(x.dtype)], -1), dt)
        return torch.where(vm, edge, torch.zeros_like(edge)), logits
