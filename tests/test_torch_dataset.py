"""The port's Visual Genome loader (data/dataset.py, data/depth.py, the numpy
halves of ops/pairs.py and data/artifacts.py) against the JAX package's, on
the CPU: the same miniature VG on disk (the repo's tools/make_mini_vg.py:
16 images at 64x64, feature grid 8, at most 6 objects of 10 classes) plus
hand-made records for the edge cases (.npz annotations, the 'wears' merge,
one and seven objects, a missing image, a missing annotation, a partial
feature cache).

Tolerance: none.  Every batch equals the JAX package's key by key
(np.array_equal, same dtype) in every mode: training (image and image_aug
from one seed), PredCLS eval, SGCLS/SGDET eval at a small canvas, with a
feature cache, and with percent, shuffle and drop_last; the helper
functions give equal arrays on equal inputs."""

import json
import os
import sys

import numpy as np
import pytest

from scene_graph_commonsense_tpu.config import derive as jax_derive
from scene_graph_commonsense_tpu.data import artifacts as jax_artifacts
from scene_graph_commonsense_tpu.data import dataset as jax_dataset
from scene_graph_commonsense_tpu.data import depth as jax_depth
from scene_graph_commonsense_tpu.ops import pairs as jax_pairs
from scene_graph_commonsense_torch.config import derive
from scene_graph_commonsense_torch.data import artifacts
from scene_graph_commonsense_torch.data import dataset
from scene_graph_commonsense_torch.data import depth
from scene_graph_commonsense_torch.ops import pairs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 8          # feature grid
N_MAX = 6


def _edge_record(rng, n, fs=FS, wears=False):
    """A reference-format annotation dict of n objects (numpy)."""
    rels, dirs = [], []
    for i in range(1, n):
        row = rng.integers(-1, 50, i).astype(np.int64)
        if wears:
            row[0] = 12
        d = np.where(row >= 0, rng.integers(0, 2, i).astype(np.float64),
                     -1.0)
        rels.append(row)
        dirs.append(d)
    return {"image_depth": rng.random((1, fs, fs)).astype(np.float32),
            "categories": rng.integers(0, 150, n),
            "bbox": np.sort(rng.integers(0, fs, (n, 2, 2)), axis=-1)
            .transpose(0, 2, 1).reshape(n, 4).astype(np.float32),
            "relationships": np.array(rels + [None], dtype=object)[:-1],
            "subj_or_obj": np.array(dirs + [None], dtype=object)[:-1],
            "super_categories": np.array(
                [rng.integers(0, 17, int(rng.integers(1, 4)))
                 for _ in range(n)] + [None], dtype=object)[:-1]}


def make_vg(root, images=16, feature_size=FS, image_size=64,
            max_objects=N_MAX, num_classes=10, edge_cases=True):
    """The repo's mini-VG, with edge_cases plus hand-made edge cases in the
    train and test splits; returns the data paths."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_mini_vg
    cwd = os.getcwd()
    os.chdir(ROOT)                  # the tool reads datasets/artifacts
    try:
        make_mini_vg.main(["--out", str(root), "--images", str(images),
                           "--feature-size", str(feature_size),
                           "--image-size", str(image_size),
                           "--max-objects", str(max_objects),
                           "--num-classes", str(num_classes)])
    finally:
        os.chdir(cwd)
    paths = {"annot_dir": str(root / "annot"),
             "image_dir": str(root / "images"),
             "annotation_train": str(root / "instances_vg_train.json"),
             "annotation_test": str(root / "instances_vg_test.json")}
    if not edge_cases:
        return paths
    rng = np.random.default_rng(5)
    from PIL import Image
    extra = {"train": [], "test": []}
    # .npz annotations: with the wears merge, one object (dropped), seven
    # objects (dropped at max 6), a missing image, a missing annotation
    for name, n, split, image in (("npz_wears", 5, "train", True),
                                  ("npz_one", 1, "train", True),
                                  ("npz_seven", 7, "test", True),
                                  ("npz_noimage", 3, "train", False),
                                  ("npz_wears_test", 4, "test", True),
                                  ("npz_noimage_test", 3, "test", False)):
        np.savez(root / "annot" / f"{name}_annotations.npz",
                 **_edge_record(rng, n, feature_size, wears=True))
        if image:
            h, w = (48, 80) if split == "train" else (72, 40)
            Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(
                np.uint8)).save(root / "images" / f"{name}.jpg")
        extra[split].append(name)
    extra["test"].append("no_annotation")
    for split, names in extra.items():
        path = root / f"instances_vg_{split}.json"
        images_ = json.loads(path.read_text())["images"]
        for i, name in enumerate(names):
            images_.insert(2 * i + 1, {"file_name": name + ".jpg"})
        path.write_text(json.dumps({"images": images_}))
    return paths


@pytest.fixture(scope="module")
def vg(tmp_path_factory):
    return make_vg(tmp_path_factory.mktemp("mini_vg"))


def _cfgs(data, **training):
    model = {"feature_size": FS, "image_size": 32}
    data = {"max_objects": N_MAX, "nonsq_min_side": 24, "nonsq_canvas": 40,
            **data}
    return (jax_derive("vg", model=model, data=data, training=training),
            derive("vg", model=model, data=data, training=training))


def _images(data, split):
    with open(data[f"annotation_{split}"]) as f:
        return json.load(f)


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k == "annot_path":
                assert g[k] == w[k]
            else:
                assert g[k].dtype == w[k].dtype, k
                assert np.array_equal(g[k], w[k]), k


def _both(vg, split, training, batch_kw=None, seed=3, data=None,
          **train_cfg):
    jc, tc = _cfgs({**vg, **(data or {})}, **train_cfg)
    ann = _images(vg, split)
    kw = {"shuffle": training, **(batch_kw or {})}
    want = jax_dataset.batches_from_dataset(
        jax_dataset.VGDataset(jc, ann, training=training, seed=seed), 3,
        **kw)
    got = dataset.batches_from_dataset(
        dataset.VGDataset(tc, ann, training=training, seed=seed), 3, **kw)
    return list(got), list(want)


def test_torch_dataset_training_batches_equal_jax(vg):
    got, want = _both(vg, "train", True, batch_kw={"seed": 1})
    _assert_batches_equal(got, want)
    keys = set(got[0])
    assert {"image", "image_aug", "rel", "super_mh", "depth"} <= keys
    assert got[0]["image"].shape == (3, 32, 32, 3)
    # the jitter changed some augmented view
    assert any(not np.array_equal(b["image"], b["image_aug"]) for b in got)


def test_torch_dataset_predcls_eval_batches_equal_jax(vg):
    got, want = _both(vg, "test", False, eval_mode="pc")
    _assert_batches_equal(got, want)
    assert "image" in got[0] and "image_nonsq" not in got[0]
    # the wears merge reached a batch: raw 12 -> 4 -> the motif permutation
    paths = [p for b in got for p in b["annot_path"]]
    assert any("npz_wears_test" in p for p in paths)
    assert not any("npz_seven" in p or "noimage" in p or "no_annotation"
                   in p for p in paths)


@pytest.mark.parametrize("mode", ["sgc", "sgd"])
def test_torch_dataset_detection_eval_batches_equal_jax(vg, mode):
    got, want = _both(vg, "test", False, eval_mode=mode)
    _assert_batches_equal(got, want)
    b = got[0]
    assert b["image_nonsq"].shape == (3, 40, 40, 3)
    assert b["pixel_mask"].dtype == bool
    # 64x64 images at min side 24 fill 24x24 of the 40x40 canvas
    assert b["pixel_mask"][0].sum() == 24 * 24


@pytest.fixture(scope="module")
def cache(vg, tmp_path_factory):
    """A feature cache of every image of both splits (random float16)."""
    out = tmp_path_factory.mktemp("features")
    rng = np.random.default_rng(9)
    for split in ("train", "test"):
        for img in _images(vg, split)["images"]:
            name = os.path.splitext(img["file_name"])[0]
            np.savez_compressed(out / f"{name}_features.npz",
                                features=rng.standard_normal(
                                    (FS, FS, 4)).astype(np.float16))
    return str(out)


@pytest.mark.parametrize("split,training,mode", [
    ("train", True, "pc"), ("test", False, "pc"), ("test", False, "sgd")])
def test_torch_dataset_feature_cache_batches_equal_jax(vg, cache, split,
                                                       training, mode):
    got, want = _both(vg, split, training, data={"features_dir": cache},
                      eval_mode=mode)
    _assert_batches_equal(got, want)
    assert got[0]["features"].dtype == np.float32
    assert "image" not in got[0]
    assert ("image_aug" in got[0]) == training
    assert ("image_nonsq" in got[0]) == (mode == "sgd")


def test_torch_dataset_partial_cache_rejected_as_jax(vg, cache, tmp_path,
                                                     capsys):
    import shutil
    partial = tmp_path / "partial"
    shutil.copytree(cache, partial)
    os.remove(partial / "mini_000013_features.npz")
    names = [os.path.splitext(i["file_name"])[0]
             for i in _images(vg, "test")["images"]]
    assert jax_dataset.check_feature_cache(str(partial), names) is False
    assert dataset.check_feature_cache(str(partial), names) is False
    assert "missing 1/" in capsys.readouterr().out
    assert dataset.check_feature_cache(cache, names) is True
    assert dataset.check_feature_cache("", names) is False
    got, want = _both(vg, "test", False, data={"features_dir": str(partial)},
                      eval_mode="pc")
    _assert_batches_equal(got, want)
    assert "features" not in got[0] and "image" in got[0]


@pytest.mark.parametrize("batch_kw", [
    {"percent": 0.5, "shuffle": True, "seed": 4},
    {"shuffle": False, "drop_last": False},
    {"percent": 0.7, "shuffle": True, "seed": 2, "drop_last": False}])
def test_torch_dataset_percent_shuffle_drop_last_equal_jax(vg, batch_kw):
    got, want = _both(vg, "train", True, batch_kw=batch_kw, seed=8)
    _assert_batches_equal(got, want)
    if not batch_kw.get("drop_last", True):
        assert len(got[-1]["cats"]) <= 3


def test_torch_dataset_load_annotation_equal_jax(vg):
    for name in ("mini_000000_annotations.pkl",
                 "npz_wears_annotations.npz", "absent_annotations.pkl",
                 "absent_annotations.npz"):
        path = os.path.join(vg["annot_dir"], name)
        want = jax_dataset.load_annotation(path)
        got = dataset.load_annotation(path)
        if want is None:
            assert got is None
            continue
        assert got.keys() == want.keys()
        for k in want:
            assert _equal(got[k], want[k]), k


def _equal(g, w):
    """Equal values and dtypes, element by element through lists and object
    arrays."""
    if isinstance(w, list) or (isinstance(w, np.ndarray)
                               and w.dtype == object):
        return len(g) == len(w) and all(_equal(a, b) for a, b in zip(g, w))
    g, w = np.asarray(g), np.asarray(w)
    return g.dtype == w.dtype and np.array_equal(g, w)


def test_torch_remap_and_pairs_equal_jax():
    rng = np.random.default_rng(0)
    for clustering in ("motif", "gpt2", "bert", "clip"):
        from scene_graph_commonsense_torch.constants import rel_index_map
        rel_map = rel_index_map(clustering)
        for n in (2, 5, 9):
            rec = _edge_record(rng, n, wears=True)
            w = jax_dataset.remap_lower_relationships(rec["relationships"],
                                                      rel_map)
            g = dataset.remap_lower_relationships(rec["relationships"],
                                                  rel_map)
            assert all(np.array_equal(a, b) for a, b in zip(g, w))
            want = jax_pairs.directed_rel_from_lower(w, rec["subj_or_obj"],
                                                     n, 10)
            got = pairs.directed_rel_from_lower(g, rec["subj_or_obj"], n, 10)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            back_w = jax_pairs.lower_from_directed(want, n)
            back_g = pairs.lower_from_directed(got, n)
            for gs, ws in zip(back_g, back_w):
                assert all(np.array_equal(a, b) and a.dtype == b.dtype
                           for a, b in zip(gs, ws))
            # round trip
            assert np.array_equal(pairs.directed_rel_from_lower(
                *back_g, n, 10), got)


@pytest.mark.parametrize("faithful", [True, False])
def test_torch_super_multi_hot_equal_jax(faithful):
    lists = [[3], [1, 5], [2, 7, 11], [], np.array([4, 0, 9, 16]), 6]
    want = jax_artifacts.super_multi_hot(lists, faithful=faithful)
    got = artifacts.super_multi_hot(lists, faithful=faithful)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # the reference quirk: three super-categories -> {first, last}
    assert got[2].sum() == (2 if faithful else 3)


def test_torch_color_jitter_equal_jax():
    rng = np.random.default_rng(1)
    image = rng.integers(0, 256, (37, 53, 3)).astype(np.float32)
    for seed in range(12):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        wa, wo, wf = jax_dataset.color_jitter_params(jr)
        ga, go, gf = dataset.color_jitter_params(tr)
        assert (ga, list(go)) == (wa, list(wo))
        assert np.array_equal(gf, wf)
        assert np.array_equal(
            dataset.apply_color_jitter(image, go, gf),
            jax_dataset.apply_color_jitter(image, wo, wf))
        # the draws leave the two streams in step
        assert jr.random() == tr.random()
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        assert np.array_equal(dataset.color_jitter(tr, image),
                              jax_dataset.color_jitter(jr, image))
    for hue in (-0.5, -0.1, 0.0, 0.07, 0.5):
        assert np.array_equal(dataset.adjust_hue(image, hue),
                              jax_dataset.adjust_hue(image, hue))
    rgb = image / 255.0
    for g, w in zip(dataset._rgb_to_hsv(rgb), jax_dataset._rgb_to_hsv(rgb)):
        assert np.array_equal(g, w)
    h, s, v = jax_dataset._rgb_to_hsv(rgb)
    assert np.array_equal(dataset._hsv_to_rgb(h, s, v),
                          jax_dataset._hsv_to_rgb(h, s, v))


@pytest.mark.parametrize("shape", [(48, 80), (600, 800), (375, 500),
                                   (64, 64)])
def test_torch_square_and_canvas_views_equal_jax(shape):
    rng = np.random.default_rng(shape[0])
    raw = rng.integers(0, 256, (*shape, 3)).astype(np.uint8)
    assert np.array_equal(dataset.square_image(raw, 96),
                          jax_dataset.square_image(raw, 96))
    for min_side, canvas in ((24, 40), (600, 1000)):
        gc, gm = dataset.nonsquare_canvas(raw, min_side, canvas)
        wc, wm = jax_dataset.nonsquare_canvas(raw, min_side, canvas)
        assert np.array_equal(gc, wc) and np.array_equal(gm, wm)
        assert gc.shape == (canvas, canvas, 3) and gm.dtype == bool
    assert np.array_equal(dataset.BGR_MEAN, jax_dataset.BGR_MEAN)


def test_torch_normalize_depth_equal_jax():
    rng = np.random.default_rng(2)
    for shape, fs in (((384, 512), 32), ((50, 70), 8), ((32, 32), 32)):
        d = rng.random(shape).astype(np.float32) * 7
        got = depth.normalize_depth(d, fs)
        want = jax_depth.normalize_depth(d, fs)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    flat = np.full((10, 10), 3.0, np.float32)    # zero span: no division
    assert np.array_equal(depth.normalize_depth(flat, 4),
                          jax_depth.normalize_depth(flat, 4))
