"""Fabricates a miniature OpenImages V6 in the SGTR on-disk format that
data/oiv6.py reads (reference dataloader.py:272-339), so the OIv6 loader,
the CLI's --dataset oiv6 and the chip smoke run end to end without the real
dataset.

Outputs:
  <out>/images/<img_fn>.jpg      RGB images, one class-coded rectangle per
                                 object (tools/make_mini_vg.render)
  <out>/depth/<img_fn>_depth.npz {"depth": (fs, fs) float32} in [0, 1)
  <out>/vrd-train-anno.json, vrd-test-anno.json: lists of records
      img_fn      image name without ".jpg"
      img_size    [width, height]
      det_labels  (n,) object classes in [0, 601)
      bbox        (n, 4) pixel boxes (x_min, y_min, x_max, y_max)
      rel         (k, 3) triplets (subject index, object index, raw
                  relation id in [0, 30)), overlapping pairs only; objects
                  0 and 1 share a box and are always related

Each image takes the next (height, width) of `sizes` in turn (default
OIv6-like sizes with a 1024 long side).

    python -m scene_graph_commonsense_torch.tools.make_mini_oiv6 \\
        --out datasets/mini_oiv6 --images 24 [--max-objects 20] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from scene_graph_commonsense_torch.tools.make_mini_vg import render

# (height, width) of OIv6-like images: the long side is 1024
OIV6_SIZES = ((768, 1024), (683, 1024), (1024, 768), (576, 1024),
              (1024, 1024))


def make_mini_oiv6(out: str, images: int = 24, max_objects: int = 20,
                   num_classes: int = 601, num_relations: int = 30,
                   feature_size: int = 32, seed: int = 0,
                   train_frac: float = 0.5,
                   sizes: Optional[Sequence[Tuple[int, int]]] = None
                   ) -> Tuple[int, int]:
    """Writes the miniature dataset under `out`; returns (train, test)
    image counts."""
    from PIL import Image
    sizes = sizes or OIV6_SIZES
    rng = np.random.default_rng(seed)
    for sub in ("images", "depth"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    records = []
    fs = feature_size
    for i in range(images):
        name = f"oiv6_{i:06d}"
        h, w = sizes[i % len(sizes)]
        n = int(rng.integers(2, max_objects + 1))
        cats = rng.integers(0, num_classes, n)
        # grid boxes (x0, x1, y0, y1) for the picture, pixel boxes for the
        # record
        x0 = rng.integers(0, fs - 2, n)
        y0 = rng.integers(0, fs - 2, n)
        grid = np.stack([x0, np.minimum(x0 + rng.integers(2, fs // 2, n), fs),
                         y0, np.minimum(y0 + rng.integers(2, fs // 2, n), fs)],
                        1)
        grid[1] = grid[0]          # one overlapping pair in every image
        sx, sy = w / fs, h / fs
        bbox = [[float(b[0] * sx), float(b[2] * sy), float(b[1] * sx),
                 float(b[3] * sy)] for b in grid]
        rel = []
        for si in range(n):
            for oi in range(n):
                overlap = (min(grid[si, 1], grid[oi, 1])
                           > max(grid[si, 0], grid[oi, 0])
                           and min(grid[si, 3], grid[oi, 3])
                           > max(grid[si, 2], grid[oi, 2]))
                # the relation is a function of the subject's class
                if si != oi and overlap and (
                        rng.random() < 0.3 or (si, oi) == (0, 1)):
                    rel.append([si, oi, int(cats[si] * 7 + 3)
                                % num_relations])
        img = render(rng, cats, grid, fs, h, w)
        Image.fromarray(img).save(
            os.path.join(out, "images", name + ".jpg"), quality=90)
        np.savez(os.path.join(out, "depth", name + "_depth.npz"),
                 depth=rng.random((fs, fs)).astype(np.float32))
        records.append({"img_fn": name, "img_size": [w, h],
                        "det_labels": [int(c) for c in cats],
                        "bbox": bbox, "rel": rel})
    n_train = int(train_frac * images)
    for split, chunk in (("train", records[:n_train]),
                         ("test", records[n_train:])):
        with open(os.path.join(out, f"vrd-{split}-anno.json"), "w") as f:
            json.dump(chunk, f)
    return n_train, images - n_train


def data_config(out: str) -> dict:
    """The config's `data` keys that point the OIv6 loader at `out`."""
    return {"image_dir": os.path.join(out, "images"),
            "depth_dir": os.path.join(out, "depth"),
            "annotation_train": os.path.join(out, "vrd-train-anno.json"),
            "annotation_test": os.path.join(out, "vrd-test-anno.json")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="datasets/mini_oiv6")
    ap.add_argument("--images", type=int, default=24)
    ap.add_argument("--max-objects", type=int, default=20)
    ap.add_argument("--feature-size", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-frac", type=float, default=0.5)
    ap.add_argument("--sizes", default="",
                    help="comma-separated HxW image sizes taken in turn")
    a = ap.parse_args(argv)
    sizes = [tuple(int(v) for v in s.split("x"))
             for s in a.sizes.split(",") if s] or None
    n_train, n_test = make_mini_oiv6(
        a.out, a.images, a.max_objects, feature_size=a.feature_size,
        seed=a.seed, train_frac=a.train_frac, sizes=sizes)
    print(f"wrote {n_train + n_test} images to {a.out} "
          f"({n_train} train / {n_test} test)")


if __name__ == "__main__":
    main()
