"""Training and evaluation steps over the packed pair grid (torch port of
scene_graph_commonsense_tpu/train/engine.py).  With a mesh
(parallel/mesh.py) each rank steps on the rows of its data index of the
global batch: the train step averages the gradients and metrics over the
data group before the update (or, with global_batch, sums its share of the
global batch's losses), the eval step concatenates the data group's
outputs.  A mesh with a model axis above 1 also splits the relation head's
fc1 and fc2_h over the model group (parallel/tp.py), as the JAX package's
parallel/tp.py lays them out.

Batch dict (fixed shapes; B images, N = max_objects, S = feature_size):
  features:     (B, S, S, C)   frozen detector features
  features_aug: (B, S, S, C)   augmented view (training only; optional)
  depth:        (B, S, S, 1)   estimated depth map
  cats:         (B, N) int32   object classes (padding slots hold 0)
  super_mh:     (B, N, K) f32  super-class multi-hots (optional)
  boxes:        (B, N, 4) f32  (x_min, x_max, y_min, y_max) on the grid
  rel:          (B, N, N) int32 directed GT relations (-1 = none)
  valid:        (B, N) bool
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch
import torch.utils.checkpoint

from scene_graph_commonsense_torch.device import disable_tf32, resolve_device
from scene_graph_commonsense_torch.models.relation_head import (
    RelationClassifier)
from scene_graph_commonsense_torch.ops import boxes as box_ops
from scene_graph_commonsense_torch.ops import pairs as pair_ops
from scene_graph_commonsense_torch.ops import sgd as sgd_ops
from scene_graph_commonsense_torch.ops.pair_pool import pair_pool
from scene_graph_commonsense_torch.parallel import mesh as mesh_lib
from scene_graph_commonsense_torch.parallel import tp as tp_lib
from scene_graph_commonsense_torch.train import losses as L
from scene_graph_commonsense_torch.utils import profiling

# the batch entries the eval step reads
MODEL_KEYS = ("features", "depth", "cats", "super_mh", "boxes", "rel",
              "valid")
# ... and the train step
TRAIN_KEYS = MODEL_KEYS + ("features_aug",)


def _chunk_generator(seed: int, chunk: int, device) -> torch.Generator:
    """The dropout stream of one chunk of the pair trunk, seeded from the
    trunk stream's seed and the chunk index (the JAX package splits the
    trunk key once per chunk).  Made inside the checkpointed chunk, so the
    recompute in the backward draws the same mask."""
    s = np.random.SeedSequence([seed, chunk]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(s[0]) >> 1)


def _rows_at(keep: torch.Tensor, offset: int, rows: int) -> torch.Tensor:
    """Rows [offset, offset + rows) of a drawn keep mask; rows past its end
    keep everything (they are padding slots of the buffer)."""
    block = keep[offset:offset + rows]
    if block.shape[0] < rows:
        block = torch.cat([block, block.new_ones(
            (rows - block.shape[0],) + tuple(keep.shape[1:]))])
    return block


class RowBlock:
    """A dropout stream (models/relation_head.DropoutStream): rows
    [offset, offset + n) of the keep mask of a pair buffer of `rows` rows.
    chunk 0: the buffer's mask is drawn at once from `generator`; chunk >
    0: chunk k of `chunk` rows from _chunk_generator(generator's seed, k),
    as the chunked trunk draws it.  The unsharded step's streams start at
    offset 0; the global-batch step's, on a rank, where its pairs sit in
    the global packing."""

    def __init__(self, generator: torch.Generator, rows: int,
                 offset: int = 0, chunk: int = 0):
        self.generator = generator
        self.rows = rows
        self.offset = offset
        self.chunk = chunk

    def at(self, offset: int) -> "RowBlock":
        """The stream of this one's rows from `offset` on."""
        return RowBlock(self.generator, self.rows, self.offset + offset,
                        self.chunk)

    def draw_keep(self, shape, keep_prob: float, device) -> torch.Tensor:
        rows, width = shape[0], tuple(shape[1:])
        if self.chunk <= 0:
            keep = torch.empty((self.rows,) + width, device=device) \
                .bernoulli_(keep_prob, generator=self.generator) > 0
            return _rows_at(keep, self.offset, rows)
        first = self.offset // self.chunk
        last = (self.offset + rows - 1) // self.chunk
        seed = self.generator.initial_seed()
        keep = torch.cat([
            torch.empty((self.chunk,) + width, device=device).bernoulli_(
                keep_prob, generator=_chunk_generator(seed, k, device)) > 0
            for k in range(first, last + 1)])
        return _rows_at(keep, self.offset - first * self.chunk, rows)


def _stream(generator: torch.Generator, rows: int, offset: int,
            chunk_size: int) -> RowBlock:
    """The RowBlock of a buffer of `rows` rows whose trunk runs in chunks of
    chunk_size (_chunked_pair_trunk's rule: chunked iff 0 < chunk_size <
    rows)."""
    return RowBlock(generator, rows, offset,
                    chunk_size if 0 < chunk_size < rows else 0)


def _chunked_pair_trunk(model: RelationClassifier, a: torch.Tensor,
                        b: torch.Tensor, packed: pair_ops.PackedPairs,
                        chunk_size: int,
                        generator: Optional[RowBlock] = None
                        ) -> torch.Tensor:
    """The pair trunk (pair_pool, then pair_trunk_from_pooled) over the
    packed pairs, in chunks of `chunk_size` pairs, so that the (P, S/2,
    S/2, 4h) pooled maps and the trunk's activations never exist at the
    full pair capacity: the memory guard of the JAX package's
    `_chunked_pair_trunk`.  The index buffers are padded to whole chunks
    with index 0 and the padded rows are sliced off.  With gradients on,
    each chunk runs under torch.utils.checkpoint (its activations are
    recomputed in the backward: the pair pool's forward with index runs
    twice a chunk, its backward once).  chunk_size <= 0 or >= the capacity
    runs the whole buffer at once.  `generator`, a RowBlock, gives chunk k
    its rows from k * chunk_size on."""
    p_cap = packed.flat_sub.shape[0]
    if chunk_size <= 0 or chunk_size >= p_cap:
        pooled = pair_pool(a, b, packed.flat_sub, packed.flat_obj)
        return model.pair_trunk_from_pooled(pooled, generator)
    n_chunks = -(-p_cap // chunk_size)
    pad = packed.flat_sub.new_zeros(n_chunks * chunk_size - p_cap)
    flat_sub = torch.cat([packed.flat_sub, pad])
    flat_obj = torch.cat([packed.flat_obj, pad])

    def one_chunk(a_, b_, sub, obj, k):
        gen = None if generator is None else generator.at(k * chunk_size)
        return model.pair_trunk_from_pooled(pair_pool(a_, b_, sub, obj), gen)

    hs = []
    for k in range(n_chunks):
        sub = flat_sub[k * chunk_size:(k + 1) * chunk_size]
        obj = flat_obj[k * chunk_size:(k + 1) * chunk_size]
        if torch.is_grad_enabled():
            hs.append(torch.utils.checkpoint.checkpoint(
                one_chunk, a, b, sub, obj, k, use_reentrant=False,
                preserve_rng_state=False))
        else:
            hs.append(one_chunk(a, b, sub, obj, k))
    return torch.cat(hs)[:p_cap]


def forward_pairs(model: RelationClassifier, batch: Dict[str, torch.Tensor],
                  capacity: int, *, view: str = "features",
                  generators: Optional[Sequence[RowBlock]] = None,
                  packed: Optional[pair_ops.PackedPairs] = None,
                  chunk_size: int = 0
                  ) -> Tuple[Dict[str, torch.Tensor], pair_ops.PackedPairs]:
    """Full pair-grid forward for one batch view: masks -> object streams of
    batch[view] -> pairs packed at `capacity` (all valid pairs, unless a
    precomputed `packed` buffer is given, e.g. the connected pairs of the
    contrastive view) -> fused pair assembly (ops/pair_pool.py: the CUDA
    kernels on CUDA tensors, the plain versions on CPU tensors; with
    gradient when the weights require it) -> trunk -> label-conditioned
    head.  `generators` = (trunk, head) RowBlocks turn dropout on at the
    two sites with independent streams; None runs deterministically.  chunk_size > 0
    runs the pair assembly and trunk in chunks (_chunked_pair_trunk)."""
    b, n = batch["cats"].shape
    s = batch["features"].shape[1]
    masks = box_ops.boxes_to_masks(batch["boxes"], s,
                                   batch["features"].dtype)
    masks = masks * batch["valid"][:, :, None, None].to(masks.dtype)
    gen_t, gen_h = generators if generators is not None else (None, None)
    if packed is None:
        packed = pair_ops.pack_pairs(pair_ops.pair_validity(batch["valid"]),
                                     capacity)
    a, bb = model.object_streams_from_image(batch[view], batch["depth"],
                                            masks)
    h = _chunked_pair_trunk(model, a, bb, packed, chunk_size, gen_t)
    flat_cats = batch["cats"].reshape(b * n)
    c1 = flat_cats.index_select(0, packed.flat_sub)
    c2 = flat_cats.index_select(0, packed.flat_obj)
    s1 = s2 = None
    if batch.get("super_mh") is not None:
        flat_super = batch["super_mh"].reshape(b * n, -1)
        s1 = flat_super.index_select(0, packed.flat_sub)
        s2 = flat_super.index_select(0, packed.flat_obj)
    out = model.pair_head(h, c1, c2, s1, s2, gen_h)
    out["sub_cat"] = c1
    out["obj_cat"] = c2
    return out, packed


def _grid_at(grid: torch.Tensor, packed: pair_ops.PackedPairs,
             n: int) -> torch.Tensor:
    """(B, N, N) grid -> (P,) values at each packed pair."""
    flat = grid.reshape(grid.shape[0], n * n)
    return flat[packed.img.long(), (packed.sub * n + packed.obj).long()]


def _scatter_grid(vals: torch.Tensor, packed: pair_ops.PackedPairs, b: int,
                  n: int) -> torch.Tensor:
    """Per-packed-pair values (P, ...) back onto the (B, N, N, ...) grid
    (the faithful-dynamics losses are per grid cell).  Padding slots add
    zeros at flat position 0: grid cell (0, 0, 0) is a self-pair, never
    live, so nothing real is touched.  Differentiable (index_add_)."""
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    idx = torch.where(packed.mask, packed.flat_id,
                      torch.zeros_like(packed.flat_id)).long()
    mb = packed.mask.reshape(packed.mask.shape + (1,) * (vals.dim() - 1))
    flat = torch.zeros((b * n * n,) + tuple(vals.shape[1:]),
                       dtype=vals.dtype, device=vals.device)
    flat.index_add_(0, idx, torch.where(mb, vals, zero))
    return flat.reshape((b, n, n) + tuple(vals.shape[1:]))


def pair_targets(batch: Dict[str, torch.Tensor],
                 packed: pair_ops.PackedPairs) -> torch.Tensor:
    """(P,) GT relation per packed directed pair; -1 where unrelated."""
    rel = _grid_at(batch["rel"], packed, batch["cats"].shape[1])
    return torch.where(packed.mask, rel, torch.full_like(rel, -1))


def make_eval_step(model: RelationClassifier, cfg, capacity: int = 0,
                   device=None, chunk_size: int = 0, mesh=None):
    """Deterministic forward returning everything the evaluator needs
    (relations, connectivity, packed indexing, overlap filter), under
    torch.inference_mode.  Deterministic whatever the module's mode: the
    step passes no dropout generators (models/relation_head.py), so a
    train step run on the same module in between changes nothing but the
    weights.  The model is moved to `device` (default cuda; raises where
    CUDA is absent unless device="cpu").  TF32 is turned off
    (device.disable_tf32) so float32 runs in full float32.  The step takes
    a batch dict of numpy arrays or tensors and returns tensors on the
    device.  chunk_size > 0 runs the pair trunk in chunks of that many
    pairs (forward_pairs): one pair-pool launch per chunk.

    With a mesh the step runs on the mesh's device and takes this rank's
    rows of the global batch (parallel.mesh.shard_batch).  Each rank packs
    its own pair buffer at ceil(capacity / shards), shards the data axis;
    pair_img is shifted to global image indices and every output is
    gathered over the data group in data-index order, so every rank
    returns the single-device contract of the global batch, with
    pair_count and pair_capacity one entry per shard.  A shard truncates at
    its own bound, so below the worst-case capacity a dense shard can drop
    pairs that one global buffer would keep.  A model axis above 1 shards
    the model (tp.shard_module, in place): the ranks of a model group step
    on the same rows with their shards of fc1 and fc2_h."""
    dev = resolve_device(device if mesh is None else mesh.device)
    disable_tf32()
    model.to(dev).eval()
    tp_lib.shard_module(model, mesh)
    cap = capacity or cfg.pair_capacity
    shards = 1 if mesh is None else mesh.shape["data"]
    local_cap = max(-(-cap // shards), 1)

    @profiling.traced("serve.eval_step", device=True)
    @torch.inference_mode()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        batch = {k: torch.as_tensor(batch[k], device=dev)
                 for k in MODEL_KEYS if batch.get(k) is not None}
        out, packed = forward_pairs(model, batch, local_cap,
                                    chunk_size=chunk_size)
        s = batch["features"].shape[1]
        b, n = batch["cats"].shape
        iou_ok = _grid_at(pair_ops.eval_pair_filter(batch["boxes"], s),
                          packed, n) & packed.mask
        res = {
            "relation": out["relation"],
            "super_relation": out["super_relation"],
            "connectivity": out["connectivity"],
            "targets": pair_targets(batch, packed),
            "pair_img": packed.img, "pair_sub": packed.sub,
            "pair_obj": packed.obj, "pair_mask": packed.mask,
            "iou_ok": iou_ok,
            # truncation telemetry, one entry per shard; engines warn when
            # count > capacity
            "pair_count": packed.count[None],
            "pair_capacity": torch.full((1,), local_cap, dtype=torch.int32,
                                        device=dev),
        }
        if mesh is None:
            return res
        res["pair_img"] = packed.img + mesh.data_index * b
        return mesh_lib.all_gather_rows(mesh, res)

    return step


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def compute_losses(model_cfg, train_cfg, out, packed, targets,
                   class_weights, cs_tables=None, loss_contrast=None,
                   total=None):
    """All loss terms and scalar metrics for one batch (the contrastive term
    is computed by the caller over the connected-pairs buffer).  Returns
    (total, metrics); metrics are 0-dim tensors on the device.  `total`:
    the losses' denominator hook (train/losses.py)."""
    m = model_cfg
    valid = packed.mask
    connected = (targets >= 0) & valid
    f32_zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    if loss_contrast is None:
        loss_contrast = f32_zero
    loss_rel = L.relation_loss(
        out["relation"], out["super_relation"], targets, connected,
        class_weights, m.num_geometric, m.num_possessive,
        m.hierarchical_pred, total)
    conn = L.connectivity_loss(out["connectivity"], connected, valid,
                               train_cfg.lambda_not_connected, total)
    loss_cs = f32_zero
    if cs_tables is not None:
        loss_cs = L.commonsense_loss(
            out["relation"], out["sub_cat"], out["obj_cat"], valid,
            cs_tables[0], cs_tables[1], m.num_geometric, m.num_possessive,
            m.num_classes, train_cfg.lambda_cs_weak,
            train_cfg.lambda_cs_strong, m.hierarchical_pred, total)
    loss = loss_rel \
        + train_cfg.lambda_connectivity * conn.loss \
        + train_cfg.lambda_commonsense * loss_cs \
        + train_cfg.lambda_contrast * loss_contrast
    metrics = {
        "loss": loss, "loss_relationship": loss_rel,
        "loss_connectivity": conn.loss, "loss_commonsense": loss_cs,
        "loss_contrast": loss_contrast,
        "num_connected": conn.num_connected,
        "num_not_connected": conn.num_not_connected,
        "num_connected_pred": conn.num_connected_pred,
        "connectivity_precision_hits": conn.precision_hits,
        "connectivity_recall_hits": conn.recall_hits,
        "num_pairs": packed.count,
    }
    return loss, metrics


Schedule = Union[float, Callable[[int], float]]


class SGDState(NamedTuple):
    """The momentum trace per parameter name, in momentum_dtype, and the
    update count the learning-rate schedule reads."""
    trace: Dict[str, torch.Tensor]
    count: int


class SGD:
    """optax.chain(clip_by_global_norm, add_decayed_weights, sgd(momentum))
    as make_optimizer of the JAX package builds it (engine.py:54-72), written
    out because torch.optim.SGD differs from it in three places: the clip
    (torch.nn.utils.clip_grad_norm_ scales by max_norm / (norm + 1e-6)
    always, optax by max_norm / norm only when norm >= max_norm), a
    bfloat16 momentum buffer, and the learning rate read from the schedule
    at the count before the update.  Per parameter, in the master dtype:

        g <- g / norm * max_norm    if grad_clip_norm > 0 and norm >= it
        g <- g + weight_decay * p
        t <- g + momentum * t       (t stored in momentum_dtype)
        p <- p + (-lr(count)) * t

    The parameters are updated in place (ops/sgd.py: two kernel launches
    for every parameter at once on the card, with no host
    synchronisation)."""

    def __init__(self, learning_rate: Schedule, momentum: float = 0.9,
                 weight_decay: float = 1e-4, grad_clip_norm: float = 0.0,
                 momentum_dtype: str = "float32"):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.momentum_dtype = getattr(torch, momentum_dtype)
        self.scratch = sgd_ops.Scratch()

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params: Dict[str, torch.Tensor],
             count: int = 0) -> SGDState:
        return SGDState({k: torch.zeros_like(p, dtype=self.momentum_dtype)
                         for k, p in params.items()}, count)

    @profiling.traced("train.optimizer")
    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: SGDState,
               params: Dict[str, torch.Tensor],
               scale: Optional[torch.Tensor] = None,
               mesh=None) -> SGDState:
        """One update; consumes `grads` (a float32 trace takes over each
        gradient's buffer) and leaves `state` as it was.  `scale`, a 0-dim
        tensor, multiplies the update -lr * t after the momentum (the
        faithful dynamic learning rate; the trace stays unscaled).  `mesh`,
        where `params` hold TP shards (parallel/tp.py): the clip's global
        norm is the unsharded model's."""
        sum_squares = None
        if mesh is not None and mesh.model > 1:
            sum_squares = functools.partial(tp_lib.global_sum_squares, mesh,
                                            params)
        trace, _ = sgd_ops.sgd_update(
            grads, params, state.trace, self.lr(state.count), self.momentum,
            self.weight_decay, self.grad_clip_norm, self.momentum_dtype,
            scale, sum_squares, self.scratch)
        return SGDState(trace, state.count + 1)


def make_optimizer(learning_rate: Schedule, momentum: float = 0.9,
                   weight_decay: float = 1e-4, grad_clip_norm: float = 0.0,
                   momentum_dtype: str = "float32") -> SGD:
    """SGD with momentum and coupled weight decay, matching torch.optim.SGD
    (reference train_test.py:100-101): the decay joins the gradient before
    the momentum update.  grad_clip_norm > 0 adds global-norm clipping, a
    deviation from the reference that tames the SupCon term's gradient
    spikes.  momentum_dtype="bfloat16" halves the momentum buffer."""
    return SGD(learning_rate, momentum=momentum, weight_decay=weight_decay,
               grad_clip_norm=grad_clip_norm, momentum_dtype=momentum_dtype)


class TrainState(NamedTuple):
    """params: the model's parameters by name (the tensors themselves: the
    optimizer updates them, and so the model, in place); opt_state: the
    SGDState; step: the number of train steps taken."""
    params: Dict[str, torch.Tensor]
    opt_state: SGDState
    step: int


def init_train_state(model: RelationClassifier, optimizer: SGD,
                     step: int = 0) -> TrainState:
    """A TrainState over the model's parameters; `step` also seeds the
    schedule count (a resumed run continues its learning-rate schedule)."""
    params = dict(model.named_parameters())
    return TrainState(params, optimizer.init(params, count=step), step)


def dropout_generators(seed: int, step: int, device, rank: int = 0) -> list:
    """Four independent dropout streams for one train step, (trunk, head)
    of the main view then of the augmented view, seeded from (seed, step)
    and, on ranks above 0, the rank: the counterpart of the JAX step's
    fold_in(rng, step), its fold_in of the data-axis index (per-shard
    streams, like per-rank seeds under DDP) and its splits (engine.py:162,
    301, 316).  Rank 0 draws the single-device step's streams."""
    key = [seed, step] if rank == 0 else [seed, step, rank]
    seeds = np.random.SeedSequence(key).generate_state(4, np.uint64)
    return [torch.Generator(device=device).manual_seed(int(s) >> 1)
            for s in seeds]


def train_pair_capacity(cfg, shards: int = 1) -> int:
    """Capacity of one shard's main-view pair buffer: cfg.pair_capacity //
    shards (at least 1), or with training.faithful_dynamics every valid
    pair of the shard, max(batch_size // shards, 1) * max_objects *
    (max_objects - 1) (the per-column losses need each valid pair on the
    grid)."""
    if cfg.training.faithful_dynamics:
        n = cfg.data.max_objects
        return max(cfg.training.batch_size // shards, 1) * n * (n - 1)
    return max(cfg.pair_capacity // shards, 1)


def aug_pair_capacity(cfg, shards: int = 1) -> int:
    """Capacity of one shard's augmented-view buffer of connected pairs:
    connected pairs (GT relations) are an order of magnitude sparser than
    valid pairs.  An explicit TrainConfig.aug_pair_capacity is global and
    divided across the shards; 0 takes the shard's main-view capacity
    // 4 (the faithful one in faithful mode); within [1, main view's]."""
    cap = train_pair_capacity(cfg, shards)
    aug = cfg.training.aug_pair_capacity
    aug = aug // shards if aug > 0 else cap // 4
    return min(max(aug, 1), cap)


@profiling.traced("train.allreduce", device=True)
def reduce_over_mesh(mesh, params: Dict[str, torch.Tensor],
                     metrics: Dict[str, torch.Tensor], allreduce_dtype,
                     reduce=mesh_lib.all_mean_):
    """The gradients and the metrics reduced over the data group by
    `reduce` (in place on a flat buffer: all_mean_, the flagship's pmean,
    or all_sum_, the plug-and-play step's sum of its global losses' shares):
    one all-reduce of every gradient flattened into one buffer (in
    `allreduce_dtype`, cast back to each master dtype), one of the metrics
    in float64 (integer counts come back as float64, as pmean makes them
    floats).  Returns (grads by name, metrics)."""
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in params.items()}
    flat = reduce(mesh, torch.cat(
        [g.reshape(-1).to(allreduce_dtype) for g in grads.values()]))
    off = 0
    for k, g in grads.items():
        grads[k] = flat[off:off + g.numel()].view_as(g).to(g.dtype)
        off += g.numel()
    reduced = reduce(mesh, torch.stack(
        [v.detach().to(torch.float64) for v in metrics.values()]))
    metrics = {k: m.to(v.dtype) if v.is_floating_point() else m
               for (k, v), m in zip(metrics.items(), reduced)}
    return grads, metrics


def _cut(packed: pair_ops.PackedPairs, keep: int) -> pair_ops.PackedPairs:
    """The packing with its slots from `keep` on turned into padding
    (pack_pairs' parking slot, pair (0, 0, 1) of image 0, masked); the
    count is left as it is."""
    live = packed.mask & (torch.arange(packed.mask.shape[0],
                                       device=packed.mask.device) < keep)
    zero = torch.zeros_like(packed.img)
    return pair_ops.PackedPairs(
        img=torch.where(live, packed.img, zero),
        sub=torch.where(live, packed.sub, zero),
        obj=torch.where(live, packed.obj, zero + 1),
        flat_sub=torch.where(live, packed.flat_sub, zero),
        flat_obj=torch.where(live, packed.flat_obj, zero + 1),
        mask=live, count=packed.count,
        flat_id=torch.where(live, packed.flat_id, zero - 1))


def train_losses(model: RelationClassifier, cfg,
                 batch: Dict[str, torch.Tensor], capacity: int,
                 aug_capacity: int,
                 gens: Sequence[torch.Generator], weights: torch.Tensor,
                 cs_tables=None, chunk_size: int = 0, mesh=None):
    """The train step's forward and losses on one batch of tensors (a
    rank's rows under a mesh): the main view packed at `capacity` and,
    when the batch has features_aug, the augmented view's connected pairs
    at `aug_capacity` feeding the hierarchical SupCon term; faithful_losses
    over the scattered grid with training.faithful_dynamics, compute_losses
    otherwise.  `gens` are dropout_generators' four streams.  Returns
    (total, metrics) with the pair-overflow metrics (the valid, and the
    connected, pairs left out of the buffers).

    With `mesh` the batch is this rank's rows of a global batch and the
    losses are its share of the global batch's (the global-batch step):
    the valid and the connected pairs are numbered over the global batch
    in pack_pairs' image-major order (this rank's offsets from one
    all-gather of its counts, parallel.mesh.exclusive_prefix), and a pair
    is kept iff its number is below the global `capacity` (`aug_capacity`);
    a rank's buffers hold min(capacity, its images' b * n * (n - 1) pairs),
    as many on every rank, and every kept pair of its own; every rank draws
    `gens`' masks of the global buffers and keeps its rows (RowBlock); the
    SupCon term contrasts this rank's
    anchors with every rank's connected pairs (parallel.mesh.gather_rows);
    every denominator is the group's (parallel.mesh.global_losses).  Every
    metric but lr_scale is then this rank's share, which the group's sum
    makes global."""
    m = cfg.model
    faithful = cfg.training.faithful_dynamics
    b, n = batch["cats"].shape
    valid_grid = pair_ops.pair_validity(batch["valid"])
    conn_grid = valid_grid & (batch["rel"] >= 0)
    off = off_c = 0
    buf, buf_c = capacity, aug_capacity
    if mesh is not None:
        off, off_c = mesh_lib.exclusive_prefix(
            mesh, torch.stack([valid_grid.sum(), conn_grid.sum()]))
        buf = min(capacity, b * n * (n - 1))
        buf_c = min(aug_capacity, b * n * (n - 1))
    gens = [_stream(g, capacity, off, chunk_size) for g in gens[:2]] \
        + [_stream(g, aug_capacity, off_c, chunk_size) for g in gens[2:]]
    packed = pair_ops.pack_pairs(valid_grid, buf)
    if mesh is not None:
        packed = _cut(packed, capacity - off)
    out, _ = forward_pairs(model, batch, buf, view="features",
                           generators=gens[:2], packed=packed,
                           chunk_size=chunk_size)
    targets = pair_targets(batch, packed)
    aug_overflow = torch.zeros((), dtype=torch.int32,
                               device=batch["cats"].device)
    supcon = None
    if "features_aug" in batch:
        # the SupCon loss reads only CONNECTED pairs' hidden states
        # (reference train_utils.py:96-99)
        packed_c = pair_ops.pack_pairs(conn_grid, buf_c)
        if mesh is not None:
            packed_c = _cut(packed_c, aug_capacity - off_c)
        aug_overflow = packed_c.count - packed_c.mask.sum()
        out_aug, _ = forward_pairs(
            model, batch, buf_c, view="features_aug",
            generators=gens[2:], packed=packed_c, chunk_size=chunk_size)
        pos, found = pair_ops.align_packings(packed, packed_c)
        feats = torch.stack([out["hidden"][pos.long()],
                             out_aug["hidden"]], dim=1)
        feats = feats.to(torch.promote_types(feats.dtype, torch.float32))
        labels = torch.clamp(pair_targets(batch, packed_c), min=0)
        supcon = {"features": feats, "labels": labels, "valid": found}
        if mesh is not None:
            peers = mesh_lib.all_gather_rows(mesh, {"labels": labels,
                                                    "valid": found})
            supcon.update(contrast=(mesh_lib.gather_rows(mesh, feats),
                                    peers["labels"], peers["valid"]),
                          offset=mesh.data_index * feats.shape[0])
    if faithful:
        sup_grid = None
        if m.hierarchical_pred:
            sup_grid = _scatter_grid(out["super_relation"], packed, b, n)
        grids = (_scatter_grid(out["relation"], packed, b, n), sup_grid,
                 _scatter_grid(out["connectivity"], packed, b, n))

    def losses(total):
        loss_contrast = None if supcon is None else L.supcon_hierar_loss(
            num_geometric=m.num_geometric, num_possessive=m.num_possessive,
            total=total, **supcon)
        if faithful:
            return L.faithful_losses(
                m, cfg.training, *grids, batch["rel"], batch["valid"],
                weights, sub_cats=batch["cats"], obj_cats=batch["cats"],
                cs_tables=cs_tables, loss_contrast=loss_contrast,
                total=total)
        return compute_losses(m, cfg.training, out, packed, targets,
                              weights, cs_tables, loss_contrast, total)

    total, metrics = losses(None) if mesh is None \
        else mesh_lib.global_losses(mesh, losses)
    # silent pair-dropping is where the static capacity can change
    # results: reported, and warned about by the loop
    metrics["pair_overflow"] = (packed.count
                                - packed.mask.sum()).to(torch.float32)
    metrics["aug_pair_overflow"] = aug_overflow.to(torch.float32)
    return total, metrics


def make_train_step(model: RelationClassifier, cfg, optimizer: SGD,
                    class_weights, cs_tables=None, mesh=None, device=None,
                    chunk_size: int = 0, global_batch: bool = False):
    """The train step: forward of the main view over all
    valid pairs and, when the batch has features_aug, of the augmented view
    over the connected pairs only (packed at aug_pair_capacity) feeding the
    hierarchical SupCon term; the losses; backward (the pair pool's
    backward kernel included); the optimizer update.

        step(state, batch) -> (state, metrics)

    The batch is a dict of numpy arrays or tensors; metrics are 0-dim
    tensors on the device (read them with float() when needed: that
    synchronises).  The model's float32 parameters are the master weights;
    the forward casts them to cfg.model.compute_dtype layer by layer.
    Dropout draws from dropout_generators(cfg.training.seed, state.step).
    With training.faithful_dynamics the main view packs every valid pair
    (train_pair_capacity), the losses are faithful_losses over the
    scattered grid, and the update is multiplied by its lr_scale.
    chunk_size > 0 runs both views' pair trunks in chunks with
    recomputation (forward_pairs).

    With a mesh (parallel/mesh.py) the step runs on the mesh's device and
    takes this rank's rows of the global batch (parallel.mesh.shard_batch),
    packed at the shard's capacities (train_pair_capacity /
    aug_pair_capacity of the data axis); dropout draws the streams of the
    rank's data index.  After the backward the gradients and the metrics
    are averaged over the data group (an all-reduce each, the gradients in
    training.grad_allreduce_dtype), so the clip, the momentum and faithful
    mode's lr_scale act on the means and every rank applies the same
    update to its replica: the JAX package's shard_map step over 'data'.

    A model axis above 1 shards the model first (tp.shard_module, in place;
    build the TrainState after this call, so that its momentum has the
    shards' shapes): fc1 column-parallel and fc2_h row-parallel over the
    model group, whose ranks step on the same rows.  The replicated
    parameters' gradients are then averaged over the model group (one more
    all-reduce, which keeps the replicas bit-identical) and the clip's
    global norm is the unsharded model's.  The update equals the unsharded
    data-parallel step's, to the rounding of the split sums.

    global_batch=True (with a mesh) is the counterpart of the JAX
    package's GSPMD step (its parallel/tp.py recipe: shard_params, then the
    mesh-less step on a P('data') batch): the losses are the whole global
    batch's, so that a step at any (data, model) equals the unsharded step
    on the global batch, to the rounding of the split sums.  Each rank
    takes its segment of the global packing at the global capacities
    (in buffers of its own images' length), draws rank 0's dropout streams at the global width and keeps its rows,
    and computes its share of every loss over the group's denominators
    (train_losses(mesh=)); the gradients and the metrics are then summed
    over the data group, not averaged.  The default, False, is the JAX
    package's shard_map step, which its fit and CLI run."""
    dev = resolve_device(device if mesh is None else mesh.device)
    disable_tf32()
    model.to(dev)
    tp_lib.shard_module(model, mesh)
    tp = mesh is not None and mesh.model > 1
    faithful = cfg.training.faithful_dynamics
    glob = mesh is not None and global_batch
    shards = 1 if mesh is None or glob else mesh.shape["data"]
    rank = 0 if mesh is None or glob else mesh.data_index
    capacity = train_pair_capacity(cfg, shards)
    aug_capacity = aug_pair_capacity(cfg, shards)
    allreduce_dtype = getattr(torch, cfg.training.grad_allreduce_dtype)
    weights = torch.as_tensor(np.asarray(class_weights), device=dev)
    if cs_tables is not None:
        cs_tables = tuple(torch.as_tensor(np.asarray(t), device=dev)
                          for t in cs_tables)

    @profiling.traced("train.update", device=True)
    def step(state: TrainState, batch: Dict):
        if tp and state.opt_state.trace["fc1.weight"].shape \
                != model.fc1.weight.shape:
            raise ValueError("the TrainState predates the model's TP "
                             "sharding: build it after make_train_step")
        batch = {k: torch.as_tensor(batch[k], device=dev)
                 for k in TRAIN_KEYS if batch.get(k) is not None}
        gens = dropout_generators(cfg.training.seed, state.step, dev, rank)
        model.train()
        for p in state.params.values():
            p.grad = None
        with profiling.span("train.losses"):
            total, metrics = train_losses(
                model, cfg, batch, capacity, aug_capacity, gens, weights,
                cs_tables, chunk_size, mesh if glob else None)
        with profiling.span("train.backward"):
            total.backward()
        if mesh is None:
            grads = {k: p.grad for k, p in state.params.items()}
        else:
            # the global step's lr_scale is the group's already
            lr_scale = metrics.pop("lr_scale", None) if glob else None
            grads, metrics = reduce_over_mesh(
                mesh, state.params, metrics, allreduce_dtype,
                reduce=mesh_lib.all_sum_ if glob else mesh_lib.all_mean_)
            if lr_scale is not None:
                metrics["lr_scale"] = lr_scale
            if tp:
                tp_lib.mean_replicated_grads_(mesh, state.params, grads)
        # faithful: the dynamic learning rate of the reference's last
        # column (train_test.py:192) scales this step's update
        opt_state = optimizer.update(
            grads, state.opt_state, state.params,
            scale=metrics["lr_scale"].detach() if faithful else None,
            mesh=mesh if tp else None)
        for p in state.params.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return step
