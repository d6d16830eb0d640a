"""OpenImages V6 dataset over SGTR-processed annotations (a copy of
scene_graph_commonsense_tpu/data/oiv6.py, kept so that the port imports
nothing of the JAX package; the same files give the same batches, bit for
bit, in both packages).

Mirrors the reference OpenImageV6Dataset contract (reference
dataloader.py:272-339): per-image dicts with 601 object classes, 30
relations reordered by super-category, precomputed depth maps, and the
padded pair-grid format of the VG loader (data/dataset.py).  OIv6 carries
no super-class multi-hots and no augmented view.

PIL is imported inside get_example, so the package imports without it.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from scene_graph_commonsense_torch.constants import OIV6_REORDER_BY_SUPER
from scene_graph_commonsense_torch.data.dataset import (
    check_feature_cache, collate, nonsquare_canvas)
from scene_graph_commonsense_torch.ops.boxes import resize_box

OIV6_BGR_MEAN = np.array([103.530, 116.280, 123.675], np.float32)


class OIV6Dataset:
    """Loads SGTR-style vrd-{train,test}-anno.json records."""

    def __init__(self, cfg, annotation_path: str, training: bool = True,
                 image_dir: Optional[str] = None,
                 depth_dir: Optional[str] = None,
                 load_images: bool = False):
        self.cfg = cfg
        self.training = training
        self.image_dir = image_dir
        self.depth_dir = depth_dir
        self.load_images = load_images
        with open(annotation_path) as f:
            self.annotations = json.load(f)
        self.use_feature_cache = check_feature_cache(
            cfg.data.features_dir,
            (rec["img_fn"] for rec in self.annotations))

    def __len__(self):
        return len(self.annotations)

    def get_example(self, idx: int) -> Optional[Dict]:
        cfg = self.cfg
        n_max = cfg.data.max_objects
        s = cfg.model.feature_size
        rec = self.annotations[idx]
        cats = np.asarray(rec["det_labels"], np.int64)
        n = len(cats)
        if n <= 1 or n > n_max:
            return None                 # reference dataloader.py:307
        h_img, w_img = rec["img_size"][1], rec["img_size"][0]

        boxes = np.zeros((n_max, 4), np.float32)
        for i, b in enumerate(rec["bbox"]):   # raw x_min,y_min,x_max,y_max
            rb = resize_box(b, (h_img, w_img), (s, s))
            # canonical (x_min, x_max, y_min, y_max); the reference stores
            # (box[0], box[2], box[1], box[3]) of its resize output
            # (reference dataloader.py:313-316)
            boxes[i] = [rb[0], rb[2], rb[1], rb[3]]

        # directed relation grid from the raw triplet list (reference
        # dataloader.py:319-334): triplet = (subject_idx, object_idx, rel)
        rel = np.full((n_max, n_max), -1, np.int32)
        for t in rec["rel"]:
            si, oi, r = int(t[0]), int(t[1]), int(t[2])
            if si == oi or si >= n or oi >= n:
                continue
            rel[si, oi] = OIV6_REORDER_BY_SUPER[r]

        depth = np.zeros((s, s, 1), np.float32)
        if cfg.model.use_depth and self.depth_dir is not None:
            dp = os.path.join(self.depth_dir, rec["img_fn"] + "_depth.npz")
            if os.path.exists(dp):
                depth = np.load(dp)["depth"].reshape(s, s, 1)

        ex = {
            "cats": np.pad(cats.astype(np.int32), (0, n_max - n)),
            "boxes": boxes,
            "rel": rel,
            "valid": np.arange(n_max) < n,
            # no super-class multi-hots on OIv6 (the reference model's fc2
            # takes the classes only, reference model.py:127-128)
            "super_mh": None,
            "depth": depth,
            "annot_path": rec["img_fn"],
        }
        # the frozen detector's features from the cache, as for VG (a
        # partial cache is rejected at __init__: check_feature_cache)
        have_features = False
        if self.use_feature_cache:
            fp = os.path.join(cfg.data.features_dir,
                              rec["img_fn"] + "_features.npz")
            ex["features"] = np.load(fp)["features"].astype(np.float32)
            have_features = True
        if self.load_images and self.image_dir is not None:
            from PIL import Image
            path = os.path.join(self.image_dir, rec["img_fn"] + ".jpg")
            if not os.path.exists(path):
                return None
            with Image.open(path) as im:
                raw = np.asarray(im.convert("RGB"))
            if not have_features:
                img = Image.fromarray(raw).resize(
                    (cfg.model.image_size, cfg.model.image_size))
                # 0-255 pixels, channels flipped to BGR before the mean
                ex["image"] = np.asarray(img, np.float32)[..., ::-1] \
                    - OIV6_BGR_MEAN
            canvas, mask = nonsquare_canvas(raw)
            ex["image_nonsq"] = canvas
            ex["pixel_mask"] = mask
        return ex


def oiv6_batches(dataset: OIV6Dataset, batch_size: int, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = False
                 ) -> Iterator[Dict]:
    """Fixed-size batches in a seeded order, skipping filtered images.  The
    last partial batch is padded to batch_size with copies of its first
    example holding no valid object and no relation (they add nothing to
    the evaluators), so no test image is dropped."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    buf: List[Dict] = []
    for idx in order:
        ex = dataset.get_example(int(idx))
        if ex is None:
            continue
        buf.append({k: v for k, v in ex.items() if v is not None})
        if len(buf) == batch_size:
            yield collate(buf)
            buf = []
    if buf and not drop_last:
        while len(buf) < batch_size:
            filler = copy.deepcopy(buf[0])
            filler["valid"] = np.zeros_like(filler["valid"])
            filler["rel"] = np.full_like(filler["rel"], -1)
            buf.append(filler)
        yield collate(buf)
