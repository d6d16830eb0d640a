"""The benchmark's traffic: seeded VG- and OIv6-shaped batches and requests.

One generator for every traffic mix: the mix's data file
(benchmark/traffic/<name>.json) gives the parameters, the configuration file
the shapes.  The scenes follow the port's data/synthetic.py (copied here, so
that the traffic owes nothing to the program): Poisson object counts of mean
`mean_objects` clipped to [min_objects, max_objects], area-sorted integer
boxes on the feature grid, sparse directed relations.

Every seed gets the same work.  The object counts of a pool are the
quantiles of the clipped Poisson law, the same multiset for every seed; the
seed only deals them out to the images.  An image of n objects holds
round(rel_density * n (n - 1) / 2) related unordered pairs; the seed picks
which, their direction and their predicates.  So a pool's valid pairs and
connected pairs add up to the same totals under every seed, in another
order.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

# BGR channel means subtracted from [0, 1] pixels by the VG featurize view
BGR_MEAN = np.array([102.9801, 115.9465, 122.7717], np.float32)


def object_counts(n_images: int, mean: float, lo: int, hi: int) -> np.ndarray:
    """The (i + 0.5) / n quantiles of Poisson(mean) clipped to [lo, hi]:
    a fixed multiset of object counts for n images."""
    cdf, k, term = [], 0, math.exp(-mean)
    total = term
    while total < 1.0 - 1e-12 and k < 10 * hi:
        cdf.append(total)
        k += 1
        term *= mean / k
        total += term
    cdf = np.asarray(cdf + [1.0])
    q = (np.arange(n_images) + 0.5) / n_images
    return np.clip(np.searchsorted(cdf, q), lo, hi).astype(np.int64)


def scene_batch(rng: np.random.Generator, counts: np.ndarray, conf: Dict,
                rel_density: float) -> Dict[str, np.ndarray]:
    """Objects, boxes, classes, super-class multi-hots (where the
    configuration has them) and directed relations of len(counts) images,
    without image content."""
    m = conf["model"]
    b, n, s = len(counts), conf["data"]["max_objects"], m["feature_size"]
    valid = np.arange(n)[None, :] < counts[:, None]
    x0 = rng.integers(0, s - 2, (b, n))
    y0 = rng.integers(0, s - 2, (b, n))
    w = rng.integers(2, s, (b, n))
    h = rng.integers(2, s, (b, n))
    boxes = np.stack([x0, np.minimum(x0 + w, s),
                      y0, np.minimum(y0 + h, s)], axis=-1).astype(np.float32)
    area = (boxes[..., 1] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 2])
    order = np.argsort(-area, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], axis=1)
    cats = rng.integers(0, m["num_classes"], (b, n)).astype(np.int32)
    cats[~valid] = 0
    rel = np.full((b, n, n), -1, np.int32)
    for bi, c in enumerate(counts):
        lower = [(i, j) for i in range(1, c) for j in range(i)]
        k = int(round(rel_density * len(lower)))
        for t in rng.permutation(len(lower))[:k]:
            i, j = lower[t]
            r = rng.integers(0, m["num_relations"])
            if rng.random() < 0.5:
                rel[bi, i, j] = r
            else:
                rel[bi, j, i] = r
    out = {"cats": cats, "boxes": boxes, "rel": rel, "valid": valid}
    if conf["use_super"]:
        k = m["num_super_classes"]
        mh = rng.random((b, n, k)) < 2.0 / k
        mh |= np.eye(k, dtype=bool)[cats % k]
        mh = mh.astype(np.float32)
        mh[~valid] = 0
        out["super_mh"] = mh
    return out


def train_pool(conf: Dict, traffic: Dict, seed: int) -> List[Dict]:
    """traffic["pool_batches"] global train batches of ranks *
    images_per_rank images: DETR-shaped float32 features, depth, the scene,
    and the augmented view where the configuration has one (the features
    plus aug_noise Gaussian noise, as synthetic_batch makes it)."""
    rng = np.random.default_rng(seed)
    m = conf["model"]
    b = traffic["ranks"] * traffic["images_per_rank"]
    pool = traffic["pool_batches"]
    counts = rng.permutation(object_counts(
        pool * b, traffic["mean_objects"], traffic["min_objects"],
        conf["data"]["max_objects"])).reshape(pool, b)
    s, c = m["feature_size"], m["num_img_feature"]
    batches = []
    for k in range(pool):
        feats = rng.standard_normal((b, s, s, c), dtype=np.float32)
        batch = {"features": feats,
                 "depth": rng.random((b, s, s, 1), dtype=np.float32),
                 **scene_batch(rng, counts[k], conf, traffic["rel_density"])}
        if conf["augmented_view"]:
            batch["features_aug"] = feats + np.float32(
                traffic["aug_noise"]) * rng.standard_normal(
                    feats.shape, dtype=np.float32)
        batches.append(batch)
    return batches


def serve_pool(conf: Dict, traffic: Dict, seed: int, device) -> List[Dict]:
    """traffic["pool_requests"] PredCLS requests of traffic["images"]
    square images each: uint8 pixels drawn on `device` from the seed,
    normalised as the VG featurize view normalises them (/ 255 - the BGR
    means), copied to the host once as float32 (B, S*32, S*32, 3) under
    'image'; depth on the feature grid; the scene without relations."""
    import torch
    rng = np.random.default_rng(seed)
    m = conf["model"]
    b, pool = traffic["images"], traffic["pool_requests"]
    side, s = m["image_size"], m["feature_size"]
    counts = rng.permutation(object_counts(
        pool * b, traffic["mean_objects"], traffic["min_objects"],
        conf["data"]["max_objects"])).reshape(pool, b)
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(0, 2 ** 62)))
    mean = torch.as_tensor(BGR_MEAN, device=device)
    requests = []
    for k in range(pool):
        pixels = torch.randint(0, 256, (b, side, side, 3), device=device,
                               generator=gen, dtype=torch.uint8)
        image = (pixels.to(torch.float32) / 255.0 - mean).cpu().numpy()
        scene = scene_batch(rng, counts[k], conf, 0.0)
        del scene["rel"]
        requests.append({"image": image,
                         "depth": rng.random((b, s, s, 1), dtype=np.float32),
                         **scene})
    return requests
