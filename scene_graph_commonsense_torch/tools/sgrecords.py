"""Writes the SGRC records of a Visual Genome split for the C++ batch
packer (data/native): the sgrecords stage of the JAX package's
tools/preprocess_vg.py, byte for byte, so either package reads the other's
records.

    python -m scene_graph_commonsense_torch.tools.sgrecords --split train \\
        --out datasets/vg_sgrc_train [--config cfg.yaml] [--embed-images]

Records bake in the 'wears' merge and the cluster permutation
(data.dataset.remap_lower_relationships) and the reference's super-category
multi-hot, so they are specific to the clustering: keep one directory per
clustering.  --embed-images writes v2 records (the raw RGB image embedded),
which training needs for its per-epoch contrastive view; v1 records carry
annotations only (PredCLS eval with a feature cache).  Point data.sgrc_dir
at the directory.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def write_sgrecords(cfg, split: str, out_dir: str,
                    embed_images: bool = False, log_fn=print) -> int:
    """One `<name>.sgrec` per image of the split that the loader keeps
    (2..max_objects objects, annotation and, with embed_images, image
    present); returns the number written."""
    from scene_graph_commonsense_torch.constants import rel_index_map
    from scene_graph_commonsense_torch.data.artifacts import super_multi_hot
    from scene_graph_commonsense_torch.data.dataset import (
        load_annotation, remap_lower_relationships)
    from scene_graph_commonsense_torch.data.native import write_sgrec

    annot = (cfg.data.annotation_train if split == "train"
             else cfg.data.annotation_test)
    with open(annot) as f:
        images = json.load(f)["images"]
    rel_map = rel_index_map(cfg.data.supcat_clustering)
    os.makedirs(out_dir, exist_ok=True)
    n_max = cfg.data.max_objects
    written = skipped = 0
    for img in images:
        name = os.path.splitext(img["file_name"])[0]
        rec = load_annotation(os.path.join(
            cfg.data.annot_dir, name + "_annotations.pkl"))
        if rec is None:
            rec = load_annotation(os.path.join(
                cfg.data.annot_dir, name + "_annotations.npz"))
        if rec is None:
            skipped += 1
            continue
        n = len(rec["categories"])
        if n <= 1 or n > n_max:        # reference dataloader.py:119
            skipped += 1
            continue
        rels = remap_lower_relationships(rec["relationships"], rel_map)
        super_mh = np.zeros((n, 17), np.uint8)
        if "super_categories" in rec:
            scs = [np.asarray(s).reshape(-1)
                   for s in rec["super_categories"]]
            super_mh = super_multi_hot(scs).astype(np.uint8)
        image = None
        if embed_images:
            img_path = os.path.join(cfg.data.image_dir, img["file_name"])
            if not os.path.exists(img_path):
                skipped += 1
                continue
            from PIL import Image
            with Image.open(img_path) as im:
                image = np.asarray(im.convert("RGB"))
        # VG's file names carry their image folder (VG_100K/<id>.jpg): the
        # record keeps it, as the annotation cache does
        path = os.path.join(out_dir, name + ".sgrec")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_sgrec(path,
                    np.asarray(rec["categories"], np.int32),
                    np.asarray(rec["bbox"], np.float32),
                    super_mh, rels, rec["subj_or_obj"],
                    np.asarray(rec["image_depth"], np.float32),
                    feature_size=cfg.model.feature_size, image=image)
        written += 1
    log_fn(f"wrote {written} SGRC records under {out_dir} "
           f"({skipped} images skipped)")
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--split", choices=["train", "test"], default="train")
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--embed-images", action="store_true")
    args = ap.parse_args(argv)
    from scene_graph_commonsense_torch.config import load_config
    write_sgrecords(load_config(args.config), args.split, args.out,
                    embed_images=args.embed_images)


if __name__ == "__main__":
    main()
