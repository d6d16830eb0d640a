"""Training and evaluation of the plug-and-play predictor families (torch
port of scene_graph_commonsense_tpu/train/pnp_engine.py), on one device or
over a data-parallel mesh (parallel/mesh.py).

A HierarchicalPredictor (Motifs / Transformer / VCTree / VTransE context,
models/predictors.py) trains and evaluates on the batch contract of the
flagship relation head (train/engine.py), with per-object features
mask-pooled from the frozen detector's feature map (the stand-in for SGB's
ROIAlign box features).  Pairs are the full N x N directed grid per image
(diagonal and padding masked), so every shape is static and the recall
evaluator of eval/recall.py scores the outputs.  No kernel of csrc/ runs
here: the pooling is two batched products and the contexts are plain
PyTorch, as they are plain XLA in the JAX package.

Over a mesh each rank runs its rows of the global batch.  The JAX package
partitions these steps by GSPMD over the global batch, so two things that a
per-rank program would make local stay global here: every loss is a ratio
of sums over the whole batch (each denominator is the group's sum, and the
gradients of the ranks' shares are summed), and TDE's counterfactual mean
feature is the mean over every rank's rows.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from scene_graph_commonsense_torch.device import disable_tf32, resolve_device
from scene_graph_commonsense_torch.models import weights
from scene_graph_commonsense_torch.models.predictors import (
    HierarchicalPredictor)
from scene_graph_commonsense_torch.ops import boxes as box_ops
from scene_graph_commonsense_torch.ops import pairs as pair_ops
from scene_graph_commonsense_torch.parallel import mesh as mesh_lib
from scene_graph_commonsense_torch.train import checkpoint as ckpt_lib
from scene_graph_commonsense_torch.train import engine
from scene_graph_commonsense_torch.train import losses as L

# the batch entries the predictor steps read
MODEL_KEYS = ("features", "boxes", "cats", "valid", "rel")


def roi_pool_features(features: torch.Tensor, boxes: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Mask-average-pool the (B, S, S, C) feature map per object box ->
    (B, N, C): the static-shape equivalent of per-box ROI pooling."""
    s = features.shape[1]
    masks = box_ops.boxes_to_masks(boxes, s, features.dtype)  # (B,N,S,S)
    masks = masks * valid[:, :, None, None].to(masks.dtype)
    area = masks.sum(dim=(2, 3)).clamp_min(1.0)
    pooled = torch.einsum("bnhw,bhwc->bnc", masks, features)
    return pooled / area[..., None]


def union_pool_features(features: torch.Tensor, boxes: torch.Tensor,
                        pair_sub: torch.Tensor, pair_obj: torch.Tensor
                        ) -> torch.Tensor:
    """(B, P, C) features mask-pooled over each pair's union box."""
    s = features.shape[1]

    def take(idx):
        return torch.gather(boxes, 1, idx.long()[..., None].expand(-1, -1, 4))

    union = box_ops.union_box(take(pair_sub), take(pair_obj))  # (B, P, 4)
    masks = box_ops.boxes_to_masks(union, s, features.dtype)
    area = masks.sum(dim=(2, 3)).clamp_min(1.0)
    pooled = torch.einsum("bphw,bhwc->bpc", masks, features)
    return pooled / area[..., None]


def grid_pairs(b: int, n: int, device=None):
    """All N*N directed (sub, obj) slot pairs per image, row-major (the
    order the relation grid flattens to): two (B, N*N) int32 tensors."""
    ar = torch.arange(n, dtype=torch.int32, device=device)
    sub = ar.repeat_interleave(n)
    obj = ar.repeat(n)
    return sub.expand(b, n * n), obj.expand(b, n * n)


def _forward(predictor: HierarchicalPredictor, batch: Dict[str, torch.Tensor],
             counterfactual: bool = False, mesh=None
             ) -> Dict[str, torch.Tensor]:
    b, n = batch["cats"].shape
    dev = batch["cats"].device
    feats = roi_pool_features(batch["features"], batch["boxes"],
                              batch["valid"])
    pair_sub, pair_obj = grid_pairs(b, n, dev)
    pair_mask = pair_ops.pair_validity(batch["valid"]).reshape(b, n * n)
    union = union_pool_features(batch["features"], batch["boxes"],
                                pair_sub, pair_obj)
    if counterfactual:
        # TDE intervention (Tang et al. 2020): every object and union
        # feature is replaced by the mean feature, labels and boxes kept
        # (the context and bias paths are untouched).  The mean is the
        # batch's masked mean, over all images (the JAX package's choice:
        # no running mean to carry): over a mesh the sums and counts of
        # every rank's rows, in one all-reduce.
        v = batch["valid"].to(feats.dtype)
        pm = pair_mask.to(union.dtype)
        c = feats.shape[-1]
        sums = torch.cat([(feats * v[..., None]).sum((0, 1)), v.sum()[None],
                          (union * pm[..., None]).sum((0, 1)),
                          pm.sum()[None].to(union.dtype)])
        if mesh is not None:
            sums = mesh_lib.global_total(mesh, sums)
        feats = (sums[:c] / sums[c].clamp_min(1.0)).expand(feats.shape)
        union = (sums[c + 1:-1] / sums[-1].clamp_min(1.0)).expand(
            union.shape)
    out = predictor(feats, batch["boxes"], batch["cats"], batch["valid"],
                    pair_sub, pair_obj, pair_mask, union)
    out["pair_img"] = torch.arange(b, dtype=torch.int32,
                                   device=dev).repeat_interleave(n * n)
    out["pair_sub"] = pair_sub.reshape(-1)
    out["pair_obj"] = pair_obj.reshape(-1)
    rel = batch["rel"].reshape(-1)
    out["targets"] = torch.where(out["pair_mask"], rel,
                                 torch.full_like(rel, -1))
    return out


def _host(x) -> np.ndarray:
    """A batch entry on the host (numpy arrays pass through)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _device_batch(batch: Dict, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k], device=dev) for k in MODEL_KEYS}


def make_pnp_train_step(predictor: HierarchicalPredictor, cfg,
                        optimizer: engine.SGD, cs_tables=None, mesh=None,
                        device=None):
    """The train step of a predictor family on one device (default cuda):
    hierarchical relation NLL + connectivity BCE, plus VCTree's structure
    BCE, the object-decode CE outside predcls, and the commonsense penalty
    over the LLM-validated triplet tables when cs_tables is given (the
    train_cs composition the reference applies to its base model,
    reference train_utils.py:36-60).

        step(state, batch) -> (state, metrics)

    `state` is an engine.TrainState over the predictor's parameters (which
    the optimizer updates in place); metrics are 0-dim tensors on the
    device.  The predictor has no dropout, so the step is deterministic.

    With a mesh (parallel/mesh.py) the step runs on the mesh's device and
    takes this rank's rows of the global batch (parallel.mesh.shard_batch).
    The losses are the global batch's, as the JAX package's GSPMD step
    computes them: every term is a ratio of sums over the whole batch, so
    each denominator (a masked count or weight sum, detached: it depends on
    the batch and the argmax only) is the group's sum, each rank
    back-propagates its rows' numerators over it, and the gradients and the
    metrics are summed over the group (not averaged).  The denominators
    travel in one all-reduce a step (parallel.mesh.global_losses), their
    losses computed once without gradients to collect them.  The clip and the
    momentum then act on the global gradient, and every rank applies the
    same update."""
    dev = resolve_device(device if mesh is None else mesh.device)
    disable_tf32()
    predictor.to(dev)
    tc, m = cfg.training, cfg.model
    if cs_tables is not None:
        cs_tables = tuple(torch.as_tensor(np.asarray(t), device=dev)
                          for t in cs_tables)

    def losses(batch, out, total):
        """(loss, metrics) of one forward's outputs; `total` maps each
        denominator (L's `total`)."""
        targets = out["targets"]
        valid_p = out["pair_mask"]
        connected = (targets >= 0) & valid_p
        ones = torch.ones(out["relation"].shape[1], dtype=torch.float32,
                          device=dev)
        loss_rel = L.relation_loss(
            out["relation"], out["super_relation"], targets, connected,
            ones, m.num_geometric, m.num_possessive, hierarchical=True,
            total=total)
        conn = L.connectivity_loss(out["connectivity"], connected, valid_p,
                                   tc.lambda_not_connected, total=total)
        loss = loss_rel + tc.lambda_connectivity * conn.loss
        extra = {}
        b, n = batch["cats"].shape
        valid = batch["valid"]
        if "structure_scores" in out:
            # VCTree's supervised structure loss (the differentiable half
            # of its hybrid learning): pair scores -> GT relatedness in
            # either direction; without it the score and rootness layers
            # get no gradient through Prim's argmax
            s = out["structure_scores"].to(torch.float32)
            rel = batch["rel"]
            related = (rel >= 0) | (rel.transpose(1, 2) >= 0)
            eye = torch.eye(n, dtype=torch.bool, device=dev)
            vp = valid[:, :, None] & valid[:, None, :] & ~eye
            bce = torch.where(related, L._softplus(-s), L._softplus(s))
            loss_struct = L._masked_mean(bce, vp, total)
            loss = loss + loss_struct
            extra["loss_structure"] = loss_struct
        if predictor.mode != "predcls":
            lab = F.log_softmax(out["obj_logits"], dim=-1)
            nll = -torch.gather(lab, -1, batch["cats"].long()[..., None]
                                )[..., 0]
            loss = loss + L._masked_mean(nll, valid, total)
        loss_cs = torch.zeros((), dtype=torch.float32, device=dev)
        if cs_tables is not None:
            flat_cats = batch["cats"].reshape(b * n)
            img = out["pair_img"]
            loss_cs = L.commonsense_loss(
                out["relation"], flat_cats[(img * n + out["pair_sub"]).long()],
                flat_cats[(img * n + out["pair_obj"]).long()], valid_p,
                cs_tables[0], cs_tables[1], m.num_geometric,
                m.num_possessive, m.num_classes, tc.lambda_cs_weak,
                tc.lambda_cs_strong, hierarchical=True, total=total)
            loss = loss + tc.lambda_commonsense * loss_cs
        return loss, {"loss": loss, "loss_relationship": loss_rel,
                      "loss_connectivity": conn.loss,
                      "loss_commonsense": loss_cs, **extra}

    def step(state: engine.TrainState, batch: Dict):
        batch = _device_batch(batch, dev)
        for p in state.params.values():
            p.grad = None
        out = _forward(predictor, batch)
        if mesh is None:
            loss, metrics = losses(batch, out, None)
        else:
            loss, metrics = mesh_lib.global_losses(
                mesh, lambda total: losses(batch, out, total))
        loss.backward()
        if mesh is None:
            grads = {k: p.grad for k, p in state.params.items()}
        else:
            grads, metrics = engine.reduce_over_mesh(
                mesh, state.params, metrics,
                next(iter(state.params.values())).dtype,
                reduce=mesh_lib.all_sum_)
        opt_state = optimizer.update(grads, state.opt_state, state.params)
        for p in state.params.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        return engine.TrainState(state.params, opt_state,
                                 state.step + 1), metrics

    return step


def make_pnp_eval_step(predictor: HierarchicalPredictor, cfg,
                       tde: bool = False, mesh=None, device=None):
    """The deterministic forward on one device (default cuda) returning
    what the evaluator needs, under torch.inference_mode.  With tde=True
    each pair is scored by its Total Direct Effect (Tang et al. 2020, the
    +TDE rows of reference README_PLUGANDPLAY.md:181-188): relation and
    super scores become factual minus counterfactual, where the
    counterfactual forward sees the batch's mean visual features (labels
    and boxes intact); the outputs are then ranking scores, not
    log-probabilities.

    With a mesh the step runs on the mesh's device and takes this rank's
    rows of the global batch (parallel.mesh.shard_batch); pair_img is
    shifted to global image indices and every output is gathered over the
    ranks in rank order, so every rank returns the single-device outputs
    of the global batch.  TDE's mean feature is the global batch's (an
    all-reduce of the sums and counts), as the JAX package's GSPMD step
    computes it: the one place where a shard is not independent."""
    dev = resolve_device(device if mesh is None else mesh.device)
    disable_tf32()
    predictor.to(dev)

    @torch.inference_mode()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        batch = _device_batch(batch, dev)
        out = _forward(predictor, batch)
        if tde:
            out_cf = _forward(predictor, batch, counterfactual=True,
                              mesh=mesh)
            for k in ("relation", "super_relation"):
                out[k] = out[k] - out_cf[k]
        b, n = batch["cats"].shape
        s = batch["features"].shape[1]
        out["iou_ok"] = pair_ops.eval_pair_filter(batch["boxes"], s) \
            .reshape(b * n * n) & out["pair_mask"]
        res = {k: out[k] for k in
               ("relation", "super_relation", "connectivity", "targets",
                "pair_img", "pair_sub", "pair_obj", "pair_mask", "iou_ok")}
        if mesh is None:
            return res
        res["pair_img"] = res["pair_img"] + mesh.data_index * b
        return mesh_lib.all_gather_rows(mesh, res)

    return step


def init_predictor_params(cfg, predictor: HierarchicalPredictor,
                          generator: Optional[torch.Generator] = None,
                          log_fn: Callable[[str], None] = print
                          ) -> Dict[str, torch.Tensor]:
    """Fresh weights of `predictor` (flax's distributions,
    weights.init_predictor_state; `generator` defaults to one seeded with
    cfg.training.seed), label embeddings from GloVe when the table exists
    (apply_glove_init)."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.training.seed)
    return apply_glove_init(
        cfg, weights.init_predictor_state(predictor, generator),
        log_fn=log_fn)


def apply_glove_init(cfg, state_dict: Dict[str, torch.Tensor],
                     log_fn: Callable[[str], None] = print
                     ) -> Dict[str, torch.Tensor]:
    """GloVe label-embedding init of the context models (the reference's
    SGB graft targets start from GloVe vectors, reference
    README_PLUGANDPLAY.md:56-69).  When cfg.model.glove_embeddings (a path
    relative to the working directory) names a table built by
    tools/glove_embeddings.py, every `label_embed` table gets its resolved
    class rows replaced (the padding row and unresolved names keep their
    init).  An absent table falls back to the committed `.synthetic.npz`
    stand-in beside it, and without either the init stays, with a log
    line."""
    path = cfg.model.glove_embeddings
    if not path:
        return state_dict
    if not os.path.exists(path):
        synth = path[:-len(".npz")] + ".synthetic.npz" \
            if path.endswith(".npz") else ""
        if synth and os.path.exists(synth):
            path = synth
        else:
            log_fn(f"glove_embeddings: {path} not found — context label "
                   f"embeddings keep their learned init (build the table "
                   f"with tools/glove_embeddings.py)")
            return state_dict
    with np.load(path) as npz:
        vecs, found = npz["vectors"], npz["found"]
        source = str(npz["source"]) if "source" in npz else "glove"
    out = dict(state_dict)
    hit = False
    for key, tab in state_dict.items():
        if key.split(".")[-2:] != ["label_embed", "weight"]:
            continue
        if tab.shape[1] != vecs.shape[1]:
            raise ValueError(
                f"glove_embeddings dim {vecs.shape[1]} != embed_dim "
                f"{tab.shape[1]} at {key}; rebuild the table with a "
                f"matching GloVe dim")
        tab = tab.clone()
        rows = np.nonzero(found[:tab.shape[0]])[0]
        tab[torch.as_tensor(rows)] = torch.as_tensor(vecs[rows],
                                                     dtype=tab.dtype)
        out[key] = tab
        hit = True
    if hit:
        log_fn(f"Initialized context label embeddings from {path} "
               f"(source={source}, {int(found.sum())}/{len(found)} "
               f"classes)")
    return out


def make_predictor(cfg, family: str, device=None,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None,
                   log_fn: Callable[[str], None] = print
                   ) -> HierarchicalPredictor:
    """The predictor family `family` on `device` (default cuda) at the JAX
    package's widths (hidden 256, pair 512, embeddings 100, float32), its
    mode from cfg.training.eval_mode, holding `state_dict` or else
    init_predictor_params's weights."""
    mode = {"pc": "predcls", "sgc": "sgcls", "sgd": "sgdet"}[
        cfg.training.eval_mode]
    dev = resolve_device(device)
    m = cfg.model
    with torch.device("meta"):        # allocated once, on the device, below
        predictor = HierarchicalPredictor(
            family=family, feature_dim=m.num_img_feature,
            union_dim=m.num_img_feature, num_classes=m.num_classes,
            num_geometric=m.num_geometric, num_possessive=m.num_possessive,
            num_semantic=m.num_semantic, mode=mode,
            box_scale=float(m.feature_size))
    if state_dict is None:
        state_dict = init_predictor_params(cfg, predictor, log_fn=log_fn)
    predictor = predictor.to_empty(device=dev)
    predictor.load_state_dict(state_dict)
    return predictor.eval()


def checkpoint_name(family: str, cluster: str, epoch: int,
                    run_mode: str = "train") -> str:
    """Pnp{Family}Model[_CS]_{cluster}{epoch}: the plug-and-play analogue
    of the flagship naming (train/checkpoint.checkpoint_name); train_cs and
    eval_cs runs carry the _CS marker.  The file is <name>.pt."""
    cs = "_CS" if run_mode in ("train_cs", "eval_cs") else ""
    return f"Pnp{family.capitalize()}Model{cs}_{cluster}{epoch}"


def checkpoint_file(cfg, family: str, epoch: int,
                    run_mode: str = "train") -> str:
    return os.path.join(cfg.training.checkpoint_path, checkpoint_name(
        family, cfg.data.supcat_clustering, epoch, run_mode) + ".pt")


def _strip(batch: Dict) -> Dict:
    """Drops what the predictor never reads before featurize: the
    annotation paths and the augmented view (encoding it would cost a
    frozen-DETR forward per batch)."""
    batch = dict(batch)
    for k in ("annot_path", "image_aug", "features_aug"):
        batch.pop(k, None)
    return batch


def fit_predictor(cfg, family: str,
                  train_batches_fn: Callable[[int], Iterable],
                  test_batches_fn: Optional[Callable[[int], Iterable]] = None,
                  artifacts=None, featurize=None, steps_per_epoch=1000,
                  device=None, log_fn: Callable[[str], None] = print):
    """Training driver of a predictor family on one device (default cuda),
    the orchestration of train.loop.fit: per epoch the train steps, a
    checkpoint <checkpoint_path>/<checkpoint_name>.pt, and a PredCLS test
    pass (100 batches for epochs < 2).  The optimizer is the flagship's
    (engine.make_optimizer, cfg.training's knobs) with grad_clip_norm 0
    replaced by 5.0: the fresh context models spike early (the JAX
    package's documented deviation).  train_cs starts from the baseline's
    last checkpoint when it exists.  Returns (predictor, state)."""
    from scene_graph_commonsense_torch.train.loop import lr_schedule
    tc = cfg.training
    dev = resolve_device(device)
    predictor = make_predictor(cfg, family, device=dev)
    cs_tables = None
    if tc.run_mode == "train_cs":
        if artifacts is None or artifacts.cs_aligned is None:
            raise ValueError("train_cs requires converted commonsense "
                             "triplet tables (run prepare_cs first)")
        cs_tables = (artifacts.cs_aligned, artifacts.cs_violated)
        # the CS run continues from the baseline predictor (the
        # reference's train_cs resumes its baseline checkpoint, reference
        # train_test.py:83-94)
        base = checkpoint_file(cfg, family, tc.num_epoch - 1)
        if os.path.exists(base):
            predictor.load_state_dict(ckpt_lib.load(base))
            log_fn(f"[pnp:{family}] resumed baseline weights from {base}")
    opt = engine.make_optimizer(lr_schedule(cfg, steps_per_epoch),
                                momentum=tc.momentum,
                                weight_decay=tc.weight_decay,
                                grad_clip_norm=tc.grad_clip_norm or 5.0)
    step = make_pnp_train_step(predictor, cfg, opt, cs_tables=cs_tables,
                               device=dev)
    estep = make_pnp_eval_step(predictor, cfg, device=dev)
    state = engine.init_train_state(predictor, opt)

    for epoch in range(tc.start_epoch, tc.num_epoch):
        log_fn(f"[pnp:{family}] Start Training... EPOCH {epoch} / "
               f"{tc.num_epoch}")
        for i, batch in enumerate(train_batches_fn(epoch)):
            batch = _strip(batch)
            if featurize is not None:
                batch = featurize(batch)
            state, metrics = step(state, batch)
            if i % tc.print_freq == 0:
                log_fn(f"[pnp:{family}] epoch {epoch} batch {i} " +
                       " ".join(f"{k}={float(v):.4f}"
                                for k, v in sorted(metrics.items())))
        path = checkpoint_file(cfg, family, epoch, tc.run_mode)
        ckpt_lib.save(path, predictor)
        log_fn(f"[pnp:{family}] Saved checkpoint {path}")
        if test_batches_fn is not None:
            res = run_eval_pc_predictor(
                cfg, predictor, test_batches_fn(epoch), artifacts=artifacts,
                featurize=featurize, max_batches=100 if epoch < 2 else None,
                estep=estep, device=dev)
            log_fn(f"[pnp:{family}] TEST epoch {epoch} "
                   f"R@k: {res['recall']} mR@k: {res['mean_recall']}")
    return predictor, state


def run_eval_pc_predictor(cfg, predictor: HierarchicalPredictor,
                          batches: Iterable[Dict], artifacts=None,
                          featurize=None, max_batches: Optional[int] = None,
                          use_cs: bool = False, estep=None, tde: bool = False,
                          device=None, mesh=None) -> Dict:
    """PredCLS evaluation of a predictor family with the recall evaluator.
    use_cs applies the commonsense triplet filtering (eval_cs) through the
    flagship's dense tables; tde scores pairs by Total Direct Effect
    (make_pnp_eval_step).  Pass a prebuilt `estep` to reuse it (the tde
    flag is then the step's own).

    With a mesh (every rank iterates the same global batches) each rank
    takes its rows of each batch before `featurize` (no rank encodes images
    it then drops) and steps on them through make_pnp_eval_step(mesh=),
    which gathers the global outputs on every rank (a prebuilt `estep` must
    be one); rank 0 alone runs the evaluator, and every rank returns its
    results."""
    from scene_graph_commonsense_torch.eval.builders import (
        build_candidates, build_targets)
    from scene_graph_commonsense_torch.eval.engines import (
        _make_evaluators, to_numpy)
    evaluator, _ = _make_evaluators(cfg, artifacts, predcls=True)
    if estep is None:
        estep = make_pnp_eval_step(predictor, cfg, tde=tde, device=device,
                                   mesh=mesh)
    cs_a = cs_v = None
    if use_cs:
        if artifacts is None or artifacts.cs_aligned is None:
            raise ValueError("eval_cs requires converted commonsense "
                             "triplet tables (run prepare_cs first)")
        cs_a, cs_v = artifacts.cs_aligned, artifacts.cs_violated
    lead = mesh is None or mesh.rank == 0
    m = cfg.model
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        batch = _strip(batch)
        rows = batch if mesh is None else mesh_lib.shard_batch(mesh, batch)
        if featurize is not None:
            rows = featurize(rows)
        out = estep(rows)
        if not lead:
            continue
        out = to_numpy(out)
        cats, boxes = _host(batch["cats"]), _host(batch["boxes"])
        cand = build_candidates(
            out["relation"], out["connectivity"], out["super_relation"],
            out["pair_img"], out["pair_sub"], out["pair_obj"],
            out["pair_mask"], out["iou_ok"], cats, boxes,
            hierarchical=True, num_geometric=m.num_geometric,
            num_possessive=m.num_possessive, cs_aligned=cs_a,
            cs_violated=cs_v, num_obj_classes=m.num_classes)
        tgt = build_targets(_host(batch["rel"]), cats, boxes,
                            _host(batch["valid"]))
        evaluator.accumulate(cand, tgt)
    res = evaluator.compute() if lead else None
    return res if mesh is None else mesh_lib.broadcast_object(mesh, res)
