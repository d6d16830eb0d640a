"""Precomputes the frozen DETR-101 feature maps of a Visual Genome split.

The reference re-runs its frozen detector on every image in every epoch
(reference train_test.py:152-154 under no_grad).  Since the detector never
trains, its encoder output per image is a constant; this tool computes it
once and writes one `<image>_features.npz` per image, float16 (S, S, C)
under the key "features": the layout of the JAX package's
tools/precompute_features.py, so either package reads the other's cache.
With `data: {features_dir: ...}` set, the loaders emit the cached map and a
PredCLS eval reads no image.

    python -m scene_graph_commonsense_torch.tools.precompute_features \\
        --split test --out datasets/vg_features [--config cfg.yaml] \\
        [--batch_size 12] [--device cuda|cpu]

Prints one JSON line {"split", "written", "out"}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def precompute_features(cfg, split: str, out: str, batch_size: int = 12,
                        device=None, featurize=None) -> int:
    """Writes the feature map of every image of `split` that the loader
    keeps; returns how many.  `featurize` (train.loop.make_detr_featurize_fn)
    defaults to load_detr_featurizer(cfg, device)."""
    from scene_graph_commonsense_torch.data.dataset import (
        VGDataset, batches_from_dataset)
    from scene_graph_commonsense_torch.train.loop import load_detr_featurizer
    annot = (cfg.data.annotation_train if split == "train"
             else cfg.data.annotation_test)
    if not os.path.exists(annot):
        raise FileNotFoundError(f"{annot} not found — run the "
                                f"preprocessing pipeline first")
    with open(annot) as f:
        annotations = json.load(f)
    # training=False: no contrastive view; the features of the main view
    # are what gets cached
    ds = VGDataset(cfg, annotations, training=False)
    batches = batches_from_dataset(ds, batch_size, shuffle=False,
                                   drop_last=False)
    if featurize is None:
        featurize, _ = load_detr_featurizer(cfg, device)
    os.makedirs(out, exist_ok=True)
    written = 0
    for batch in batches:
        paths = batch["annot_path"]
        feats = featurize(batch)["features"]
        feats = np.asarray(feats.cpu().numpy() if hasattr(feats, "cpu")
                           else feats, np.float32).astype(np.float16)
        for bi, path in enumerate(paths):
            # mirror the annotation cache's relative layout (file names may
            # carry subdirectories, e.g. VG_100K/123) so the loaders'
            # features_dir lookup by image file_name resolves
            name = os.path.relpath(str(path), cfg.data.annot_dir)
            name = name.replace("_annotations.pkl", "").replace(
                "_annotations.npz", "")
            dst = os.path.join(out, name + "_features.npz")
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            np.savez_compressed(dst, features=feats[bi])
            written += 1
            if written % 1000 == 0:
                print(f"{written} feature maps written", flush=True)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--split", choices=["train", "test"], default="train")
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--batch_size", type=int, default=12)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    from scene_graph_commonsense_torch.config import load_config
    cfg = load_config(args.config)
    try:
        written = precompute_features(cfg, args.split, args.out,
                                      args.batch_size, args.device)
    except FileNotFoundError as e:
        sys.exit(str(e))
    print(json.dumps({"split": args.split, "written": written,
                      "out": args.out}))


if __name__ == "__main__":
    main()
