"""IETrans / NICE data-transfer tool (the port's counterpart of the repo's
tools/label_transfer.py: the same arguments, passes and summary line).

Runs a trained relation model over the training annotations, proposes
relabels (data/label_transfer.py), and writes a rewritten annotation set
that any training path consumes unchanged — the reference's
scenegraph_benchmark_ietrans/ and _nice/ pipelines (reference
README_PLUGANDPLAY.md:21-22, 192-200).

Usage:
  # smoke run on synthetic batches (seeded weights, no files written)
  python -m scene_graph_commonsense_torch.tools.label_transfer \\
      --mode ietrans --synthetic 4 [--device cpu]

  # real pass: score the train annotations with a checkpoint (the port's
  # .pt) and write the transferred annotation npz files under --out_dir
  python -m scene_graph_commonsense_torch.tools.label_transfer \\
      --mode nice --percent 30 --config cfg.yaml \\
      --checkpoint checkpoints/HierRelationModel_Baseline_motif2.pt \\
      --out_dir datasets/vg_ietrans

The real pass reads images through the frozen DETR (train/loop.
load_detr_featurizer) or, with data.features_dir, the feature cache.  The
rewritten files keep their path relative to data.annot_dir, and only the
images whose labels changed are written: copy the annotation directory and
lay --out_dir over it for a training run.  Prints one JSON summary line
(candidate/applied counts and the predicate histogram shift).  Runs on
--device (default cuda).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, Iterable

import numpy as np
import torch

from scene_graph_commonsense_torch.data import label_transfer as lt
from scene_graph_commonsense_torch.ops import pairs as pair_ops

IMAGE_KEYS = ("image", "image_aug", "image_nonsq", "pixel_mask")


def _host(x) -> np.ndarray:
    """A host numpy array of a batch entry or an eval output (bfloat16 read
    as float32, as numpy has no bfloat16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def collect_scores(cfg, batches: Iterable[Dict], estep) -> Dict[int, Dict]:
    """Runs the eval step (train.engine.make_eval_step) over batches and
    scatters the packed pair outputs back onto per-image (N, N, R) score
    grids.

    Returns dict image_key -> {rel, scores, conn, valid_pair, annot_path}."""
    n = cfg.data.max_objects
    out_recs: Dict[int, Dict] = {}
    for batch in batches:
        paths = batch.get("annot_path")
        batch = {k: v for k, v in batch.items()
                 if k not in IMAGE_KEYS and k != "annot_path"}
        out = {k: _host(v) for k, v in estep(batch).items()}
        b = _host(batch["cats"]).shape[0]
        r = out["relation"].shape[1]
        scores = np.full((b, n, n, r), -np.inf, np.float32)
        conn = np.zeros((b, n, n), np.float32)
        m = out["pair_mask"]
        at = (out["pair_img"][m], out["pair_sub"][m], out["pair_obj"][m])
        scores[at] = out["relation"][m]
        conn[at] = 1.0 / (1.0 + np.exp(-out["connectivity"][m]))
        vp = pair_ops.pair_validity(
            torch.as_tensor(_host(batch["valid"]))).numpy()
        rel = _host(batch["rel"])
        for bi in range(b):
            out_recs[len(out_recs)] = {
                "rel": rel[bi], "scores": scores[bi], "conn": conn[bi],
                "valid_pair": vp[bi],
                "annot_path": None if paths is None else paths[bi],
            }
    return out_recs


def transfer(recs: Dict[int, Dict], mode: str, num_relations: int,
             percent=None, external_percent: float = 100.0,
             external_min_conn: float = 0.5):
    """The IETrans or NICE pass over collect_scores' records: returns
    (rels, new_rels, summary counts)."""
    rels = {k: r["rel"] for k, r in recs.items()}
    scores = {k: r["scores"] for k, r in recs.items()}
    if mode == "ietrans":
        new_rels, summary = lt.ietrans(
            rels, scores,
            {k: r["conn"] for k, r in recs.items()},
            {k: r["valid_pair"] for k, r in recs.items()},
            num_relations,
            internal_percent=percent if percent is not None else 70.0,
            external_percent=external_percent,
            external_min_conn=external_min_conn)
    else:
        new_rels, summary = lt.nice(
            rels, scores, percent=percent if percent is not None else 30.0)
    return rels, new_rels, summary


def write_transferred(cfg, recs: Dict[int, Dict], rels, new_rels,
                      out_dir: str):
    """Writes the rewritten annotation of every image whose labels changed
    under out_dir, at its path relative to cfg.data.annot_dir, as .npz.
    Returns (written, skipped)."""
    from scene_graph_commonsense_torch.constants import rel_index_map
    from scene_graph_commonsense_torch.data.dataset import load_annotation
    rel_map = rel_index_map(cfg.data.supcat_clustering)
    os.makedirs(out_dir, exist_ok=True)
    written = skipped = 0
    for k, r in recs.items():
        if r["annot_path"] is None or np.array_equal(new_rels[k], rels[k]):
            continue
        rec = load_annotation(r["annot_path"])
        if rec is None:
            # the dataset's annot_path names the reference .pkl; read the
            # .npz beside it as VGDataset.get_example does
            rec = load_annotation(os.path.splitext(r["annot_path"])[0]
                                  + ".npz")
        if rec is None:
            skipped += 1
            continue
        rec2 = lt.rewrite_annotation(rec, new_rels[k], rel_map)
        name = os.path.splitext(os.path.relpath(
            r["annot_path"], cfg.data.annot_dir))[0] + ".npz"
        out = os.path.join(out_dir, name)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        np.savez_compressed(
            out, image_depth=rec2["image_depth"],
            categories=rec2["categories"], bbox=rec2["bbox"],
            relationships=np.array(rec2["relationships"], dtype=object),
            subj_or_obj=np.array(rec2["subj_or_obj"], dtype=object),
            super_categories=np.array(rec2.get("super_categories", []),
                                      dtype=object))
        written += 1
    return written, skipped


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=["ietrans", "nice"],
                    default="ietrans")
    ap.add_argument("--percent", type=float, default=None,
                    help="internal-transfer (ietrans) / correction (nice) "
                         "top-percent threshold")
    ap.add_argument("--external_percent", type=float, default=100.0)
    ap.add_argument("--external_min_conn", type=float, default=0.5,
                    help="relatedness-probability gate for external "
                         "(NA->predicate) transfer")
    ap.add_argument("--checkpoint", default=None,
                    help="relation weights (train/checkpoint.save's .pt); "
                         "default the seeded initialisation")
    ap.add_argument("--out_dir", default=None,
                    help="where rewritten *_annotations.npz land "
                         "(required unless --synthetic)")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from scene_graph_commonsense_torch.config import load_config
    from scene_graph_commonsense_torch.models.relation_head import (
        make_relation_classifier)
    from scene_graph_commonsense_torch.train import checkpoint as ckpt_lib
    from scene_graph_commonsense_torch.train import engine

    cfg = load_config(args.config)
    cfg = cfg.replace(training=dataclasses.replace(
        cfg.training, batch_size=args.batch_size))
    model = make_relation_classifier(
        cfg, device=args.device,
        state_dict=ckpt_lib.load(args.checkpoint) if args.checkpoint
        else None)
    estep = engine.make_eval_step(model, cfg, device=args.device)

    if args.synthetic:
        from scene_graph_commonsense_torch.data.synthetic import (
            synthetic_batch)
        rng = np.random.default_rng(0)
        batches = [synthetic_batch(
            rng, batch_size=args.batch_size,
            max_objects=cfg.data.max_objects,
            feature_size=cfg.model.feature_size,
            num_channels=cfg.model.num_img_feature, with_aug=False)
            for _ in range(args.synthetic)]
    else:
        if not args.out_dir:
            sys.exit("--out_dir required for a real (non-synthetic) pass")
        from scene_graph_commonsense_torch.data.dataset import (
            VGDataset, batches_from_dataset)
        from scene_graph_commonsense_torch.train.loop import (
            load_detr_featurizer)
        annot = cfg.data.annotation_train
        if not os.path.exists(annot):
            sys.exit(f"{annot} not found — run the preprocess_vg tool "
                     f"first or use --synthetic N")
        with open(annot) as f:
            annotations = json.load(f)
        ds = VGDataset(cfg, annotations, training=False)
        featurize, _ = load_detr_featurizer(cfg, device=args.device)
        # drop_last=False: a rewrite tool must cover every image
        batches = map(featurize,
                      batches_from_dataset(ds, args.batch_size,
                                           seed=cfg.training.seed,
                                           shuffle=False, drop_last=False))

    recs = collect_scores(cfg, batches, estep)
    rels, new_rels, summary = transfer(
        recs, args.mode, cfg.model.num_relations, args.percent,
        args.external_percent, args.external_min_conn)
    written = skipped = 0
    if args.out_dir:
        written, skipped = write_transferred(cfg, recs, rels, new_rels,
                                             args.out_dir)
    # the share of GT instances in the 25 rarest predicates, before and after
    freq_before = lt.predicate_frequencies(rels.values(),
                                           cfg.model.num_relations)
    freq_after = lt.predicate_frequencies(new_rels.values(),
                                          cfg.model.num_relations)
    tail = freq_before.argsort()[:25]
    line = {
        "mode": args.mode, "images": len(recs), **summary,
        "written": written, "skipped": skipped,
        "tail_mass_before": round(float(
            freq_before[tail].sum() / max(freq_before.sum(), 1)), 4),
        "tail_mass_after": round(float(
            freq_after[tail].sum() / max(freq_after.sum(), 1)), 4),
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
