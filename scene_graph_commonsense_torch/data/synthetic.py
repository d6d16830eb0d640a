"""Synthetic VG-shaped batches for tests and benchmarks.

A copy of scene_graph_commonsense_tpu/data/synthetic.py (numpy only), kept so
that the port imports nothing of the JAX package.

Generates statistically plausible scenes (object-count distribution matching
the <=20-object filter of reference dataloader.py:118-119, area-sorted boxes,
sparse directed relations) without needing the Visual Genome images on disk.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_batch(rng: np.random.Generator, batch_size: int = 12,
                    max_objects: int = 20, feature_size: int = 32,
                    num_channels: int = 256, num_classes: int = 150,
                    num_super: int = 17, num_relations: int = 50,
                    mean_objects: float = 8.0, rel_density: float = 0.25,
                    with_aug: bool = True,
                    dtype=np.float32) -> Dict[str, np.ndarray]:
    b, n, s = batch_size, max_objects, feature_size
    feats = rng.standard_normal((b, s, s, num_channels)).astype(dtype)
    depth = rng.random((b, s, s, 1)).astype(dtype)

    counts = np.clip(rng.poisson(mean_objects, b), 2, n)
    valid = np.arange(n)[None, :] < counts[:, None]

    # well-formed boxes, sorted by area descending like the offline
    # preprocessing (reference dataset_utils.py:117)
    x0 = rng.integers(0, s - 2, (b, n))
    y0 = rng.integers(0, s - 2, (b, n))
    w = rng.integers(2, s, (b, n))
    h = rng.integers(2, s, (b, n))
    boxes = np.stack([x0, np.minimum(x0 + w, s),
                      y0, np.minimum(y0 + h, s)], axis=-1).astype(np.float32)
    area = (boxes[..., 1] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 2])
    order = np.argsort(-area, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], axis=1)

    cats = rng.integers(0, num_classes, (b, n)).astype(np.int32)
    cats[~valid] = 0
    super_mh = (rng.random((b, n, num_super)) < 2.0 / num_super)
    super_mh |= np.eye(num_super, dtype=bool)[cats % num_super]
    super_mh = super_mh.astype(dtype)
    super_mh[~valid] = 0

    # sparse directed relations: at most one direction per unordered pair
    rel = np.full((b, n, n), -1, dtype=np.int32)
    for bi in range(b):
        c = counts[bi]
        for i in range(1, c):
            for j in range(i):
                if rng.random() < rel_density:
                    r = rng.integers(0, num_relations)
                    if rng.random() < 0.5:
                        rel[bi, i, j] = r
                    else:
                        rel[bi, j, i] = r

    batch = {
        "features": feats,
        "depth": depth,
        "cats": cats,
        "super_mh": super_mh,
        "boxes": boxes,
        "rel": rel,
        "valid": valid,
    }
    if with_aug:
        batch["features_aug"] = (
            feats + 0.05 * rng.standard_normal(feats.shape)).astype(dtype)
    return batch


# BGR channel means subtracted from [0, 1] pixels by the square featurize
# view (scene_graph_commonsense_tpu/data/dataset.py square_image)
BGR_MEAN = np.array([102.9801, 115.9465, 122.7717], np.float32)


def synthetic_images(rng: np.random.Generator, batch_size: int = 12,
                     image_size: int = 1024, with_aug: bool = True
                     ) -> Dict[str, np.ndarray]:
    """Seeded square images normalised as the VG featurize view normalises
    them (square_image: uint8 pixels / 255 - the BGR means), float32
    (B, S, S, 3) under 'image'; with_aug adds 'image_aug', a second view
    with a per-image brightness and contrast change of the same pixels."""
    shape = (batch_size, image_size, image_size, 3)
    pixels = rng.integers(0, 256, shape, dtype=np.uint8)
    out = {"image": pixels.astype(np.float32) / 255.0 - BGR_MEAN}
    if with_aug:
        gain = rng.uniform(0.6, 1.4, (batch_size, 1, 1, 1))
        shift = rng.uniform(-40, 40, (batch_size, 1, 1, 1))
        aug = np.clip(pixels * gain + shift, 0, 255).astype(np.uint8)
        out["image_aug"] = aug.astype(np.float32) / 255.0 - BGR_MEAN
    return out
