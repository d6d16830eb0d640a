"""Fabricates a miniature Visual Genome in the reference's on-disk format
(the port's copy of the JAX package's tools/make_mini_vg.py: one seed gives
the same files), so the port's loaders, records and CLI can be driven end to
end without the real 108k-image dataset.

Outputs (reference contract, reference dataloader.py:59-165,
dataset_utils.py:28-200):
  <out>/images/mini_000000.jpg ...          RGB images with one colored
                                            rectangle per object (class ->
                                            colour, so recall can beat
                                            random)
  <out>/annot/mini_000000_annotations.pkl   torch-saved dict:
      categories       (n,) int64
      super_categories list of per-object super-cat id tensors
      bbox             (n, 4) float32, feature-grid (x0, x1, y0, y1)
      relationships    lower-triangular rows: row i (len i) relates object
                       i to objects 0..i-1, raw predicate ids (pre-reorder)
      subj_or_obj      same shape, 1.0 = row object is subject, 0.0 =
                       object, -1.0 = no relation
      image_depth      (1, fs, fs) float32
  <out>/instances_vg_train.json, instances_vg_test.json

Relations follow a fixed grammar over object classes (the predicate is a
function of the subject's class) so the relation signal is learnable.
Images are image_size squares, or with --sizes HxW,... each image takes the
next size in turn (VG's common sizes are 800x600, 600x800, 500x375,
500x333, 1024x768).

    python -m scene_graph_commonsense_torch.tools.make_mini_vg \\
        --out datasets/mini_vg --images 200 [--feature-size 32] \\
        [--max-objects 12] [--seed 0] [--sizes 600x800,800x600]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np


def scene(rng, num_objects, fs, num_classes=150, num_rel=50):
    """Classes, area-sorted grid boxes and the lower-triangular relation
    rows of one image."""
    cats = rng.integers(0, num_classes, num_objects)
    # well-formed grid boxes, area-sorted descending like the offline
    # pipeline (reference dataset_utils.py:117)
    x0 = rng.integers(0, fs - 2, num_objects)
    y0 = rng.integers(0, fs - 2, num_objects)
    w = rng.integers(2, max(fs // 2, 3), num_objects)
    h = rng.integers(2, max(fs // 2, 3), num_objects)
    boxes = np.stack([x0, np.minimum(x0 + w, fs),
                      y0, np.minimum(y0 + h, fs)], 1).astype(np.float32)
    area = (boxes[:, 1] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 2])
    order = np.argsort(-area, kind="stable")
    cats, boxes = cats[order], boxes[order]

    rel_rows, dir_rows = [], []
    for i in range(1, num_objects):
        row = np.full(i, -1, np.int64)
        direction = np.full(i, -1.0, np.float32)
        for j in range(i):
            # only overlapping pairs are related: PredCLS eval drops pairs
            # with zero joint-mask IoU (reference evaluate.py:149-156)
            overlap = (min(boxes[i, 1], boxes[j, 1])
                       > max(boxes[i, 0], boxes[j, 0])
                       and min(boxes[i, 3], boxes[j, 3])
                       > max(boxes[i, 2], boxes[j, 2]))
            if overlap and rng.random() < 0.6:
                direction[j] = float(rng.integers(0, 2))
                # the predicate is a function of the subject's class alone
                sub_cat = cats[i] if direction[j] == 1.0 else cats[j]
                row[j] = (int(sub_cat) * 7 + 3) % num_rel
        rel_rows.append(row)
        dir_rows.append(direction)
    return cats, boxes, rel_rows, dir_rows


def render(rng, cats, boxes, fs, size=256, width: Optional[int] = None):
    """Class-coded rectangles on a noisy background, size x size pixels, or
    size rows by `width` columns."""
    width = size if width is None else width
    img = rng.integers(90, 120, (size, width, 3)).astype(np.uint8)
    sy, sx = size / fs, width / fs
    for c, (bx0, bx1, by0, by1) in zip(cats, boxes):
        color = np.array([(c * 53) % 200 + 55, (c * 101) % 200 + 55,
                          (c * 29) % 200 + 55], np.uint8)
        xs, xe = int(bx0 * sx), max(int(bx1 * sx), int(bx0 * sx) + 2)
        ys, ye = int(by0 * sy), max(int(by1 * sy), int(by0 * sy) + 2)
        img[ys:ye, xs:xe] = color
    return img


def make_mini_vg(out: str, images: int = 200, feature_size: int = 32,
                 image_size: int = 256, max_objects: int = 12,
                 num_classes: int = 150, seed: int = 0,
                 train_frac: float = 0.75,
                 sizes: Optional[Sequence[Tuple[int, int]]] = None
                 ) -> Tuple[int, int]:
    """Writes the miniature dataset under `out`; returns (train, test)
    image counts.  `sizes`: (height, width) of each image in turn (default
    image_size squares).  Reads the super-categories from
    datasets/artifacts, relative to the working directory."""
    import torch
    from PIL import Image

    from scene_graph_commonsense_torch.data.artifacts import (
        load_vg_artifacts)

    art = load_vg_artifacts("datasets/artifacts")
    if art.sub2super is not None:
        sup_lists = [list(np.nonzero(row)[0]) for row in art.sub2super]
    else:
        sup_lists = [[c % 17] for c in range(150)]

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(out, "images")
    annot_dir = os.path.join(out, "annot")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(annot_dir, exist_ok=True)

    names = []
    for i in range(images):
        name = f"mini_{i:06d}"
        n = int(rng.integers(2, max_objects + 1))
        cats, boxes, rel_rows, dir_rows = scene(rng, n, feature_size,
                                                num_classes=num_classes)
        h, w = (image_size, None) if sizes is None \
            else sizes[i % len(sizes)]
        img = render(rng, cats, boxes, feature_size, h, w)
        Image.fromarray(img).save(os.path.join(img_dir, name + ".jpg"),
                                  quality=90)
        depth = rng.random((1, feature_size, feature_size)) \
            .astype(np.float32)
        annot = {
            "categories": torch.from_numpy(cats.astype(np.int64)),
            "super_categories": [torch.as_tensor(sup_lists[int(c)])
                                 for c in cats],
            "bbox": torch.from_numpy(boxes),
            "relationships": [torch.from_numpy(r) for r in rel_rows],
            "subj_or_obj": [torch.from_numpy(d) for d in dir_rows],
            "image_depth": torch.from_numpy(depth),
        }
        torch.save(annot, os.path.join(annot_dir,
                                       name + "_annotations.pkl"))
        names.append(name + ".jpg")

    n_train = int(train_frac * len(names))
    for split, chunk in (("train", names[:n_train]),
                         ("test", names[n_train:])):
        path = os.path.join(out, f"instances_vg_{split}.json")
        with open(path, "w") as f:
            json.dump({"images": [{"file_name": nm} for nm in chunk]}, f)
    return n_train, len(names) - n_train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="datasets/mini_vg")
    ap.add_argument("--images", type=int, default=200)
    ap.add_argument("--feature-size", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--max-objects", type=int, default=12)
    ap.add_argument("--num-classes", type=int, default=150,
                    help="restrict object classes to 0..N-1 so tiny runs "
                         "see each class pair often enough to learn")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-frac", type=float, default=0.75)
    ap.add_argument("--sizes", default="",
                    help="comma-separated HxW image sizes taken in turn")
    a = ap.parse_args(argv)
    sizes = [tuple(int(v) for v in s.split("x"))
             for s in a.sizes.split(",") if s] or None
    n_train, n_test = make_mini_vg(
        a.out, a.images, a.feature_size, a.image_size, a.max_objects,
        a.num_classes, a.seed, a.train_frac, sizes)
    print(f"wrote {n_train + n_test} images to {a.out} "
          f"({n_train} train / {n_test} test)")


if __name__ == "__main__":
    main()
