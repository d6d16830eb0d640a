"""Visual Genome dataset producing fixed-shape numpy batches (a copy of
scene_graph_commonsense_tpu/data/dataset.py's VG half, kept so that the port
imports nothing of the JAX package; one seed gives the same batches, bit for
bit, in both packages).

Replaces the reference's ragged per-image tuples and None-filtering collate
(reference dataloader.py:59-165, utils.py:18-25) with padded, mask-carrying
batches in the train.engine contract.  Reads either the reference's
per-image `*_annotations.pkl` torch pickles or their `.npz` equivalents.

Per-image semantics of reference dataloader.py:
  * images with <2 or >max_objects objects are dropped (:118-119);
  * predicates: raw label 12 'wears' merges into 4 'wearing', then the
    frequency->cluster permutation reorders ids (:135-147);
  * square image resize to image_size with the BGR-mean normalization
    (:40-51), plus a color-jittered second view for contrastive training;
  * eval keeps a non-square (<=600/1000) view on a fixed canvas with a pixel
    mask for DETR detection (:109-111).

PIL is imported inside the functions that decode or resize images, so the
package imports without it.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from scene_graph_commonsense_torch.constants import rel_index_map
from scene_graph_commonsense_torch.data.artifacts import super_multi_hot
from scene_graph_commonsense_torch.ops.pairs import directed_rel_from_lower


def load_annotation(path: str) -> Optional[Dict]:
    """Loads one per-image annotation record (.npz or reference .pkl), or
    None when the file is absent."""
    if not os.path.exists(path):
        return None
    if path.endswith(".npz"):
        data = np.load(path, allow_pickle=True)
        return {k: data[k] for k in data.files}
    # the reference's records are torch pickles of tensors and lists
    rec = torch.load(path, map_location="cpu", weights_only=False)

    def to_np(x):
        return x.numpy() if hasattr(x, "numpy") else np.asarray(x)

    out = {
        "image_depth": to_np(rec["image_depth"]),
        "categories": to_np(rec["categories"]),
        "bbox": to_np(rec["bbox"]),
        "relationships": [to_np(r) for r in rec["relationships"]],
        "subj_or_obj": [to_np(r) for r in rec["subj_or_obj"]],
    }
    if "super_categories" in rec:
        out["super_categories"] = [to_np(s).reshape(-1)
                                   for s in rec["super_categories"]]
    return out


def remap_lower_relationships(relationships, rel_map: np.ndarray):
    """Raw lower-triangular relation rows -> trained predicate ids: the
    'wears'(12)->'wearing'(4) merge, then the frequency->cluster
    permutation (reference dataloader.py:144-147).  Shared by the dataset
    loader and the SGRC record writer so records bake in the same ids."""
    rels = []
    for row in relationships:
        row = np.asarray(row, np.int64).copy()
        row[row == 12] = 4
        rels.append(np.where(row >= 0, rel_map[np.clip(row, 0, 49)], -1))
    return rels


_LUMA = np.array([0.2989, 0.587, 0.114], np.float32)   # ITU-R 601


def _rgb_to_hsv(rgb: np.ndarray):
    """Vectorized float RGB(0..1) -> (h, s, v), torchvision-tensor-path
    semantics (colorsys math)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(axis=-1)
    minc = rgb.min(axis=-1)
    v = maxc
    deltac = maxc - minc
    s = np.where(maxc > 0, deltac / np.maximum(maxc, 1e-12), 0.0)
    dc = np.where(deltac > 0, deltac, 1.0)
    rc = (maxc - r) / dc
    gc = (maxc - g) / dc
    bc = (maxc - b) / dc
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(deltac > 0, (h / 6.0) % 1.0, 0.0)
    return h, s, v


def _hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    conds = [i == k for k in range(6)]
    r = np.select(conds, [v, q, p, p, t, v])
    g = np.select(conds, [t, v, v, q, p, p])
    b = np.select(conds, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


def adjust_hue(image: np.ndarray, hue_factor: float) -> np.ndarray:
    """Hue rotation by `hue_factor` (fraction of the hue circle, in
    [-0.5, 0.5]) on a float RGB image in 0..255: the torchvision
    `F.adjust_hue` tensor path."""
    h, s, v = _rgb_to_hsv(np.clip(image, 0, 255) / 255.0)
    h = (h + hue_factor) % 1.0
    return _hsv_to_rgb(h, s, v) * 255.0


def color_jitter_params(rng: np.random.Generator, brightness=0.4,
                        contrast=0.4, saturation=0.4, hue=0.1, p=0.8):
    """Draws the RandomApply/ColorJitter sample, (apply, order, factors)
    with op ids 0=brightness, 1=contrast, 2=saturation, 3=hue, in the exact
    sequence of the JAX package (p test, then permutation, then each op's
    factor lazily in permutation order), so one RNG stream gives the same
    augmentations in both packages.  The native train packer (data/native)
    applies the same factors."""
    order = np.arange(4)
    factors = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    if rng.random() > p:
        return False, order, factors
    order = rng.permutation(4)
    for k in order:
        if k == 0:
            factors[0] = rng.uniform(max(0.0, 1 - brightness),
                                     1 + brightness)
        elif k == 1:
            factors[1] = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        elif k == 2:
            factors[2] = rng.uniform(max(0.0, 1 - saturation),
                                     1 + saturation)
        else:
            factors[3] = rng.uniform(-hue, hue)
    return True, order, factors


def apply_color_jitter(image: np.ndarray, order: np.ndarray,
                       factors: np.ndarray) -> np.ndarray:
    """Applies the four torchvision-semantics adjustments (brightness =
    blend with black, contrast = blend with the mean luma, saturation =
    blend with per-pixel luma, hue = HSV rotation) in `order` with the
    given `factors` on a float RGB image in 0..255."""
    img = image.astype(np.float32)

    def adj_brightness(x):
        return x * factors[0]

    def adj_contrast(x):
        f = factors[1]
        mean = (x @ _LUMA).mean()
        return x * f + mean * (1.0 - f)

    def adj_saturation(x):
        f = factors[2]
        gray = (x @ _LUMA)[..., None]
        return x * f + gray * (1.0 - f)

    def adj_hue(x):
        return adjust_hue(x, factors[3])

    ops = [adj_brightness, adj_contrast, adj_saturation, adj_hue]
    for k in order:
        img = ops[k](img)
    return np.clip(img, 0, 255)


def color_jitter(rng: np.random.Generator, image: np.ndarray,
                 brightness=0.4, contrast=0.4, saturation=0.4,
                 hue=0.1, p=0.8) -> np.ndarray:
    """The reference's contrastive second-view transform
    RandomApply([ColorJitter(0.4, 0.4, 0.4, 0.1)], p=0.8) (reference
    dataloader.py:45-49) in numpy."""
    apply, order, factors = color_jitter_params(
        rng, brightness, contrast, saturation, hue, p)
    if not apply:
        return image
    return apply_color_jitter(image, order, factors)


BGR_MEAN = np.array([102.9801, 115.9465, 122.7717], np.float32)


def square_image(image: np.ndarray, size: int) -> np.ndarray:
    """Square resize + mean normalization (reference dataloader.py:43-51,
    101-104).

    The pixel scale keeps a reference quirk: the square (featurize) views
    pass through `255 * TwoCropTransform(...)` (reference
    dataloader.py:102), but TwoCropTransform returns a tuple
    (dataset_utils.py:23-24), so `255 *` is sequence replication and the
    pixels stay in ToTensor's [0, 1] range when the BGR means are
    subtracted.  Every reference relation checkpoint was trained on
    features of such images.  (The non-square detection view multiplies a
    real tensor and is 0-255, reference dataloader.py:110: see
    nonsquare_canvas.)"""
    from PIL import Image
    img = Image.fromarray(image.astype(np.uint8))
    img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0 - BGR_MEAN


def nonsquare_canvas(image: np.ndarray, min_side: int = 600,
                     max_side: int = 1000):
    """min-side-600 / max-side-1000 resize onto a fixed max_side canvas with
    a pixel mask (static-shape analogue of the reference's NestedTensor,
    reference dataloader.py:40-41, utils.py:185-204).  Pixels 0-255,
    channels flipped to BGR like the reference detection path
    (dataloader.py:110)."""
    from PIL import Image
    h, w = image.shape[:2]
    scale = min(min_side / min(h, w), max_side / max(h, w))
    nh, nw = int(round(h * scale)), int(round(w * scale))
    img = Image.fromarray(image.astype(np.uint8)).resize((nw, nh),
                                                         Image.BILINEAR)
    arr = np.asarray(img, np.float32)[..., ::-1] - BGR_MEAN
    canvas = np.zeros((max_side, max_side, 3), np.float32)
    canvas[:nh, :nw] = arr
    mask = np.zeros((max_side, max_side), bool)
    mask[:nh, :nw] = True
    return canvas, mask


def check_feature_cache(features_dir: str, names) -> bool:
    """True iff a feature cache is configured and holds every image of
    this split.  A partial cache is rejected as a whole (with a warning):
    examples would otherwise carry disjoint key sets ('features' or
    'image'), and collate, which stacks by the first example's keys, would
    fail on mixed batches."""
    if not features_dir:
        return False
    missing = 0
    total = 0
    for name in names:
        total += 1
        if not os.path.exists(os.path.join(features_dir,
                                           name + "_features.npz")):
            missing += 1
    if missing:
        print(f"WARNING: feature cache {features_dir} is missing "
              f"{missing}/{total} maps — falling back to per-batch "
              f"encoding (run python -m scene_graph_commonsense_torch."
              f"tools.precompute_features to complete it)")
        return False
    return total > 0


class VGDataset:
    """Per-image examples in the padded pair-grid format."""

    def __init__(self, cfg, annotations: Dict, training: bool = True,
                 load_images: bool = True, seed: int = 0):
        self.cfg = cfg
        self.training = training
        self.load_images = load_images
        self.images = annotations["images"]
        self.rel_map = rel_index_map(cfg.data.supcat_clustering)
        self.rng = np.random.default_rng(seed)
        self.use_feature_cache = check_feature_cache(
            cfg.data.features_dir,
            (os.path.splitext(img["file_name"])[0] for img in self.images))

    def __len__(self):
        return len(self.images)

    def annot_path(self, idx: int) -> str:
        name = os.path.splitext(self.images[idx]["file_name"])[0]
        return os.path.join(self.cfg.data.annot_dir,
                            name + "_annotations.pkl")

    def get_example(self, idx: int) -> Optional[Dict]:
        cfg = self.cfg
        n_max = cfg.data.max_objects
        rec = load_annotation(self.annot_path(idx))
        if rec is None:
            rec = load_annotation(self.annot_path(idx)[:-4] + ".npz")
        if rec is None:
            return None
        cats = np.asarray(rec["categories"], np.int64)
        n = len(cats)
        if n <= 1 or n > n_max:
            return None                     # reference dataloader.py:119
        boxes = np.asarray(rec["bbox"], np.float32)   # (n, 4) canonical

        # predicate merge + reorder (reference dataloader.py:144-147)
        rels = remap_lower_relationships(rec["relationships"], self.rel_map)
        rel = directed_rel_from_lower(rels, rec["subj_or_obj"], n, n_max)

        # the reference's encoding ({first, last} super-category only, see
        # data.artifacts.super_multi_hot / reference utils.py:123-133)
        super_mh = np.zeros((n_max, 17), np.float32)
        if "super_categories" in rec:
            scs = list(rec["super_categories"])
            super_mh[:len(scs)] = super_multi_hot(scs)

        s = cfg.model.feature_size
        ex = {
            "cats": np.pad(cats.astype(np.int32), (0, n_max - n)),
            "boxes": np.pad(boxes, ((0, n_max - n), (0, 0))),
            "rel": rel,
            "valid": np.arange(n_max) < n,
            "super_mh": super_mh,
            "depth": np.asarray(rec["image_depth"], np.float32).reshape(
                s, s, 1)
            if cfg.model.use_depth else np.zeros((s, s, 1), np.float32),
            "annot_path": self.annot_path(idx),
        }

        # Precomputed frozen-detector features (the port's
        # tools/precompute_features.py, or the JAX package's: one layout)
        # replace the per-epoch DETR encode of the main view.  The
        # contrastive view cannot be cached (fresh color jitter per epoch),
        # so training still reads the image for image_aug; PredCLS eval
        # skips image IO entirely.
        have_features = False
        if self.use_feature_cache:
            name = os.path.splitext(self.images[idx]["file_name"])[0]
            fpath = os.path.join(cfg.data.features_dir,
                                 name + "_features.npz")
            ex["features"] = np.load(fpath)["features"].astype(np.float32)
            have_features = True

        need_nonsq = (not self.training
                      and cfg.training.eval_mode in ("sgc", "sgd"))
        need_image = not have_features or self.training or need_nonsq
        if self.load_images and need_image:
            img_path = os.path.join(cfg.data.image_dir,
                                    self.images[idx]["file_name"])
            if not os.path.exists(img_path):
                return None
            from PIL import Image
            with Image.open(img_path) as im:
                raw = np.asarray(im.convert("RGB"))
            if not have_features:
                ex["image"] = square_image(raw, cfg.model.image_size)
            if self.training:
                ex["image_aug"] = square_image(
                    color_jitter(self.rng, raw.astype(np.float32)),
                    cfg.model.image_size)
            elif need_nonsq:
                canvas, mask = nonsquare_canvas(
                    raw, min_side=cfg.data.nonsq_min_side,
                    max_side=cfg.data.nonsq_canvas)
                ex["image_nonsq"] = canvas
                ex["pixel_mask"] = mask
        return ex


def batches_from_dataset(dataset, batch_size: int, seed: int = 0,
                         shuffle: bool = True, percent: float = 1.0,
                         drop_last: bool = True) -> Iterator[Dict]:
    """Assembles padded batches, skipping filtered images (the reference's
    None-dropping collate, utils.py:18-25, keeps ragged batches; here the
    batch refills to full size so shapes stay static)."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    order = order[:int(percent * len(order))]

    buf: List[Dict] = []
    for idx in order:
        ex = dataset.get_example(int(idx))
        if ex is None:
            continue
        buf.append(ex)
        if len(buf) == batch_size:
            yield collate(buf)
            buf = []
    if buf and not drop_last:
        yield collate(buf)


def collate(examples: List[Dict]) -> Dict[str, np.ndarray]:
    """Stacks examples by the first one's keys; annotation paths stay a
    list."""
    out = {}
    for k in examples[0]:
        if k == "annot_path":
            out[k] = [ex[k] for ex in examples]
        else:
            out[k] = np.stack([ex[k] for ex in examples])
    return out
