"""Hierarchical / flat relation classifier (torch port of
scene_graph_commonsense_tpu/models/relation_head.py).

Same factored parameters as the JAX package, so one weight tree serves both
(models/weights.py converts):

  * factored object streams: a_i = conv2_sub(tanh(conv1_sub(x_i))) and
    b_j = conv2_obj(tanh(conv1_obj(x_j))) once per object, the pair stage
    starting at a_sub + b_obj; conv2_sub carries no bias so that the sum
    equals the reference's conv2 on the channel concat;
  * maxpool and ReLU commute, so the pair stage pools before the activation
    (ops/pair_pool.py fuses gather + add + pool + relu);
  * fc2 on concat(h, onehot(c1), onehot(c2), s1, s2) as a dense on h plus two
    embedding lookups plus two multi-hot matmuls.

Tensors are NHWC at every public method, as in the JAX package; convolutions
run on the NCHW view of NHWC memory (channels-last), and the fc1 input is
flattened in (y, x, c) order.  Parameters stay float32 and are cast to the
compute dtype layer by layer, as flax does (the cast's backward hands the
float32 parameters the compute-dtype gradients, upcast); the heads run in at
least float32.

Dropout is functional, like flax's `deterministic` flag: the two dropout
sites (after fc1, after fc2) drop only when the caller passes a
DropoutStream for that site (train/engine.py's RowBlock), and never
otherwise, whatever the module's train()/eval() mode.  The masks are not
JAX's masks.

Tensor parallelism (parallel/tp.py) runs inside the module, so that every
caller of the pair trunk and the head gets it: after tp.shard_module the
module holds this rank's rows of fc1 and columns of fc2_h, and
pair_trunk_from_pooled / pair_head run the model group's collectives.
Dropout then draws the full-width mask of each site from the generator and
keeps this rank's columns of the first, so that a sharded step drops what
the unsharded one drops and every rank of the model group draws the same
mask after fc2.
"""

from __future__ import annotations

from typing import Dict, Optional, Protocol, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from scene_graph_commonsense_torch.parallel import tp as tp_lib
from scene_graph_commonsense_torch.utils import profiling


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> f32 for softmax/heads without downcasting f64 parity runs."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _conv(layer: nn.Conv2d, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """NHWC conv in `dtype`, SAME padding for 3x3 and VALID for 1x1."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), layer.weight.to(dtype),
                 bias, padding=layer.padding)
    return y.permute(0, 2, 3, 1)


class DropoutStream(Protocol):
    """A dropout site's stream: draw_keep returns a keep mask of `shape`,
    True with probability keep_prob."""

    def draw_keep(self, shape, keep_prob: float,
                  device) -> torch.Tensor: ...


def _dense(layer: nn.Module, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[DropoutStream],
             shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """flax nn.Dropout: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate); the identity without a generator or at
    rate 0.  `shard` = (index, count): x is the index-th of count equal
    column blocks of the activation, whose full-width mask is drawn and
    sliced.  `generator` is the site's DropoutStream."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    shape = x.shape if shard is None \
        else x.shape[:-1] + (x.shape[-1] * shard[1],)
    keep = generator.draw_keep(shape, keep_prob, x.device)
    if shard is not None:
        w = x.shape[-1]
        keep = keep[..., shard[0] * w:(shard[0] + 1) * w]
    return torch.where(keep, x / keep_prob,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _embed(table: nn.Embedding, idx: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    return F.embedding(idx.long(), table.weight.to(dtype))


class BayesianHead(nn.Module):
    """Standalone hierarchical prediction head (the plug-and-play variant,
    reference model.py:9-34): three per-super-category predicate branches
    composed with the super-category log-probability by Bayes' rule,
    log p(rel, super) = log p(rel | super) + log p(super).  The layers
    compute in `dtype` and the logits in at least float32, as in the JAX
    package's BayesianHead."""

    def __init__(self, in_features: int, num_geometric: int = 15,
                 num_possessive: int = 11, num_semantic: int = 24,
                 T1: float = 1.0, T2: float = 1.0, T3: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sizes = (num_geometric, num_possessive, num_semantic)
        self.temperatures = (T1, T2, T3)
        self.dtype = dtype
        self.fc5 = nn.Linear(in_features, 3)
        self.fc3_1 = nn.Linear(in_features, num_geometric)
        self.fc3_2 = nn.Linear(in_features, num_possessive)
        self.fc3_3 = nn.Linear(in_features, num_semantic)

    def forward(self, h: torch.Tensor, bias: Optional[torch.Tensor] = None):
        """h: (P, in_features).  Optional `bias` (P, num_relations): an
        additive per-predicate logit row (e.g. Motifs' frequency prior),
        split across the three branch segments; each segment's logsumexp
        shifts the super-category logits, so the composed joint equals
        softmax(logits + bias) marginalized the hierarchical way.  Returns
        (rel1, rel2, rel3, super) log-probabilities."""
        dt = self.dtype
        ng, npos, _ = self.sizes
        sup_logits = _at_least_f32(_dense(self.fc5, h, dt))
        segs = (None, None, None) if bias is None else (
            bias[:, :ng], bias[:, ng:ng + npos], bias[:, ng + npos:])
        if bias is not None:
            sup_logits = sup_logits + torch.stack(
                [torch.logsumexp(s, dim=1) for s in segs], dim=1)
        sup = F.log_softmax(sup_logits, 1)
        branches = []
        for i, (layer, t) in enumerate(zip(
                (self.fc3_1, self.fc3_2, self.fc3_3), self.temperatures)):
            logits = _at_least_f32(_dense(layer, h, dt))
            if segs[i] is not None:
                logits = logits + segs[i]
            branches.append(F.log_softmax(logits / t, 1) + sup[:, i:i + 1])
        return branches[0], branches[1], branches[2], sup


class RelationClassifier(nn.Module):
    """Pair-grid relation classifier with flat or hierarchical output."""

    def __init__(self, hidden_dim: int = 128, feature_size: int = 32,
                 num_img_feature: int = 256, num_classes: int = 150,
                 num_super_classes: int = 17, num_relations: int = 50,
                 num_geometric: int = 15, num_possessive: int = 11,
                 num_semantic: int = 24, hierarchical: bool = True,
                 use_super: bool = True, dropout_rate: float = 0.5,
                 T1: float = 1.0, T2: float = 1.0, T3: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h = hidden_dim
        cin = num_img_feature + 1                 # features ++ depth
        self.hidden_dim = h
        self.hierarchical = hierarchical
        self.use_super = use_super
        self.temperatures = (T1, T2, T3)
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.tp_mesh = None               # set by tp.shard_module

        def conv(cin_, cout, k, bias=True):
            return nn.Conv2d(cin_, cout, k, padding=k // 2, bias=bias)

        self.conv1_sub = conv(cin, h, 1)
        self.conv1_obj = conv(cin, h, 1)
        self.conv2_sub = conv(h, 4 * h, 3, bias=False)
        self.conv2_obj = conv(h, 4 * h, 3)
        self.conv3 = conv(4 * h, 8 * h, 3)
        self.fc1 = nn.Linear(8 * h * (feature_size // 4) ** 2, 4096)
        self.fc2_h = nn.Linear(4096, 512)
        self.emb_c1 = nn.Embedding(num_classes, 512)
        self.emb_c2 = nn.Embedding(num_classes, 512)
        if use_super:
            self.fc2_s1 = nn.Linear(num_super_classes, 512, bias=False)
            self.fc2_s2 = nn.Linear(num_super_classes, 512, bias=False)
        self.fc4 = nn.Linear(512, 1)
        if hierarchical:
            self.fc3_1 = nn.Linear(512, num_geometric)
            self.fc3_2 = nn.Linear(512, num_possessive)
            self.fc3_3 = nn.Linear(512, num_semantic)
            self.fc5 = nn.Linear(512, 3)
        else:
            self.fc3 = nn.Linear(512, num_relations)

    # ---------------- per-object stage ----------------

    def object_streams(self, x: torch.Tensor):
        """x: (M, S, S, 2*hidden+1) masked feature+depth stack per object.
        Returns subject/object streams a, b: (M, S, S, 4*hidden)."""
        dt = self.dtype
        u = torch.tanh(_conv(self.conv1_sub, x, dt))
        v = torch.tanh(_conv(self.conv1_obj, x, dt))
        return _conv(self.conv2_sub, u, dt), _conv(self.conv2_obj, v, dt)

    def _masked_entity_maps(self, features: torch.Tensor, depth: torch.Tensor,
                            masks: torch.Tensor):
        """conv1 once per image with the binary occupancy mask folded in
        afterwards: for a {0,1} mask m and a 1x1 conv,
        conv1(x * m) == where(m, conv1(x), bias), so the (B*N, S, S, C+1)
        masked stack is never built.  PRECONDITION: binary masks (all
        producers are boxes_to_masks(...) * valid).

        features: (B, S, S, C); depth: (B, S, S, 1); masks: (B, N, S, S).
        Returns entity maps u, v: (B*N, S, S, hidden)."""
        dt = self.dtype
        bsz, n = masks.shape[:2]
        x = torch.cat([features.to(dt), depth.to(dt)], dim=-1)
        y_sub = _conv(self.conv1_sub, x, dt)[:, None]     # (B, 1, S, S, h)
        y_obj = _conv(self.conv1_obj, x, dt)[:, None]
        m = (masks > 0)[..., None]                        # (B, N, S, S, 1)
        u = torch.tanh(torch.where(m, y_sub, self.conv1_sub.bias.to(dt)))
        v = torch.tanh(torch.where(m, y_obj, self.conv1_obj.bias.to(dt)))
        s = u.shape[2]
        return (u.reshape(bsz * n, s, s, self.hidden_dim),
                v.reshape(bsz * n, s, s, self.hidden_dim))

    def object_streams_from_image(self, features: torch.Tensor,
                                  depth: torch.Tensor, masks: torch.Tensor):
        """object_streams with the per-image conv1 masking identity; one 3x3
        SAME conv2 per stream.  Returns contiguous NHWC (B*N, S, S, 4h)."""
        u, v = self._masked_entity_maps(features, depth, masks)
        dt = self.dtype
        return (_conv(self.conv2_sub, u, dt).contiguous(),
                _conv(self.conv2_obj, v, dt).contiguous())

    # ---------------- per-pair stage ----------------

    def pair_trunk(self, a_sub: torch.Tensor, b_obj: torch.Tensor,
                   generator: Optional[DropoutStream] = None
                   ) -> torch.Tensor:
        """(P, S, S, 4h) gathered streams -> (P, 4096) pair hidden."""
        s = F.max_pool2d((a_sub + b_obj).permute(0, 3, 1, 2), 2)
        return self.pair_trunk_from_pooled(torch.relu(s).permute(0, 2, 3, 1),
                                           generator)

    def pair_trunk_from_pooled(self, s: torch.Tensor,
                               generator: Optional[DropoutStream] = None
                               ) -> torch.Tensor:
        """(P, S/2, S/2, 4h) pooled+activated pair maps -> (P, 4096): conv3
        SAME, relu, 2x2 maxpool, NHWC flatten, fc1, relu, dropout (with a
        generator).  Sharded (tp.shard_module): fc1 column-parallel, the
        output this rank's (P, 4096 / model) columns."""
        dt = self.dtype
        s = torch.relu(_conv(self.conv3, s, dt))
        s = F.max_pool2d(s.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        s = s.reshape(s.shape[0], -1)
        mesh = self.tp_mesh
        if mesh is None:
            return _dropout(torch.relu(_dense(self.fc1, s, dt)),
                            self.dropout_rate, generator)
        s = torch.relu(_dense(self.fc1, tp_lib.copy_to_model(s, mesh), dt))
        return _dropout(s, self.dropout_rate, generator,
                        shard=(mesh.model_index, mesh.model))

    def pair_head(self, h: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                  s1: Optional[torch.Tensor], s2: Optional[torch.Tensor],
                  generator: Optional[DropoutStream] = None
                  ) -> Dict[str, torch.Tensor]:
        """Label-conditioned head.  h: (P, 4096), sharded (P, 4096 / model);
        c1/c2: (P,) subject / object classes; s1/s2: (P, num_super_classes)
        multi-hot or None; dropout after fc2 with a generator.  Sharded:
        fc2_h row-parallel.  Each rank's partial product of the
        compute-dtype operands is taken and summed over the model group in
        at least float32, and the bias added once, after the sum, before
        the one rounding to the compute dtype: the rounding of the
        unsharded layer's float32 accumulation (partial products rounded to
        bf16 each would flip the ReLU of sums near 0)."""
        dt = self.dtype
        mesh = self.tp_mesh
        if mesh is None:
            z = _dense(self.fc2_h, h, dt)
        else:
            part = F.linear(_at_least_f32(h.to(dt)),
                            _at_least_f32(self.fc2_h.weight.to(dt)))
            z = (tp_lib.reduce_from_model(part, mesh)
                 + _at_least_f32(self.fc2_h.bias.to(dt))).to(dt)
        z = z + _embed(self.emb_c1, c1, dt) + _embed(self.emb_c2, c2, dt)
        if self.use_super and s1 is not None:
            z = z + _dense(self.fc2_s1, s1, dt) + _dense(self.fc2_s2, s2, dt)
        pred = _dropout(torch.relu(z), self.dropout_rate, generator)

        out = {"hidden": pred,
               "connectivity": _at_least_f32(_dense(self.fc4, pred, dt)[:, 0])}
        if self.hierarchical:
            sup = F.log_softmax(_at_least_f32(_dense(self.fc5, pred, dt)), 1)
            rels = []
            for i, (layer, t) in enumerate(zip(
                    (self.fc3_1, self.fc3_2, self.fc3_3), self.temperatures)):
                logits = _at_least_f32(_dense(layer, pred, dt))
                rels.append(F.log_softmax(logits / t, 1) + sup[:, i:i + 1])
            out["relation"] = torch.cat(rels, dim=1)
            out["super_relation"] = sup
        else:
            out["relation"] = _at_least_f32(_dense(self.fc3, pred, dt))
            out["super_relation"] = None
        return out

    # ---------------- reference-shaped entry point ----------------

    def forward(self, x_sub: torch.Tensor, x_obj: torch.Tensor,
                c1: torch.Tensor, c2: torch.Tensor,
                s1: Optional[torch.Tensor] = None,
                s2: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Direct per-pair forward mirroring the reference signature
        `forward(h_sub, h_obj, c1, c2, s1, s2)`; x_sub/x_obj:
        (P, S, S, 2*hidden+1) masked stacks.  The oracle of the factored
        path."""
        a, _ = self.object_streams(x_sub)
        _, b = self.object_streams(x_obj)
        return self.pair_head(self.pair_trunk(a, b), c1, c2, s1, s2)


def assemble_object_stack(features: torch.Tensor, depth: torch.Tensor,
                          masks: torch.Tensor) -> torch.Tensor:
    """Builds the per-object masked input stack.

    features: (B, S, S, C) frozen detector features; depth: (B, S, S, 1)
    estimated depth; masks: (B, N, S, S) object occupancy.  Returns
    (B, N, S, S, C + 1) = [features * mask ++ depth * mask] per object
    (reference train_test.py:195-204): the input of the reference-shaped
    forward, which RelationClassifier._masked_entity_maps never builds."""
    m = masks[..., None].to(features.dtype)
    feat = features[:, None] * m
    dep = depth[:, None].to(features.dtype) * m
    return torch.cat([feat, dep], dim=-1)


def module_from_cfg(cfg) -> RelationClassifier:
    """The classifier a Config describes (the dataset decides use_super,
    reference model.py:125-128), with torch's default initialisation."""
    m = cfg.model
    return RelationClassifier(
        hidden_dim=m.hidden_dim, feature_size=m.feature_size,
        num_img_feature=m.num_img_feature, num_classes=m.num_classes,
        num_super_classes=m.num_super_classes,
        num_relations=m.num_relations, num_geometric=m.num_geometric,
        num_possessive=m.num_possessive, num_semantic=m.num_semantic,
        hierarchical=m.hierarchical_pred,
        use_super=(cfg.data.dataset == "vg"),
        dropout_rate=m.dropout_rate, T1=m.T1, T2=m.T2, T3=m.T3,
        dtype=getattr(torch, m.compute_dtype))


@profiling.traced("setup.model")
def make_relation_classifier(cfg, device=None, generator=None,
                             state_dict=None) -> RelationClassifier:
    """The classifier on `device` (default cuda), in eval mode.  Weights
    come from `state_dict` if given, else from
    weights.init_params(cfg, generator)."""
    from scene_graph_commonsense_torch.device import resolve_device
    from scene_graph_commonsense_torch.models.weights import init_params
    dev = resolve_device(device)
    with torch.device("meta"):        # allocated once, on the device, below
        model = module_from_cfg(cfg)
    model = model.to_empty(device=dev)
    if state_dict is None:
        state_dict = init_params(cfg, generator)
    model.load_state_dict(state_dict)
    return model.eval()

