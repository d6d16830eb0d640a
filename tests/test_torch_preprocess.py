"""The port's offline VG preprocessing (data/preprocess.py, the raw-VG
fabricator tools/make_raw_vg.py, data/depth.make_midas_depth_fn) against the
JAX package's data/preprocess.py, on the CPU: the same raw VG on disk (10
images at 40-64 pixels with aliases, duplicate and small boxes, objects only
relationships name, two-name and unlisted objects, a corrupted id) through
each function of both packages.

Tolerance: none.  Every dict, list and array equals the JAX package's (the
instances JSON, sub2super, each cleaning step's data, each annotation
record); the annotation .npz files equal key by key, object arrays included
(np.array_equal and dtype per entry), with and without a seeded depth_fn;
the raw fixture's batches through both loaders equal key by key."""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from scene_graph_commonsense_tpu import constants as jax_constants
from scene_graph_commonsense_tpu.config import derive as jax_derive
from scene_graph_commonsense_tpu.data import dataset as jax_dataset
from scene_graph_commonsense_tpu.data import preprocess as jp
from scene_graph_commonsense_torch import constants
from scene_graph_commonsense_torch.config import derive
from scene_graph_commonsense_torch.data import dataset, depth
from scene_graph_commonsense_torch.data import preprocess as tp
from scene_graph_commonsense_torch.tools.make_raw_vg import make_raw_vg

SIZES = ((48, 64), (64, 48), (40, 40))
N_IMAGES = 10
N_TRAIN = 6
FS = 8
VOCAB = ("object_alias.txt", "predicate_alias.txt", "object_list.txt",
         "object_types.txt")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    return make_raw_vg(str(tmp_path_factory.mktemp("raw_vg")),
                       images=N_IMAGES, seed=3, sizes=SIZES, max_objects=8)


def load_raw(raw):
    return [json.load(open(os.path.join(raw["raw_dir"], name + ".json")))
            for name in ("image_data", "objects", "relationships")]


def vocab_paths(raw):
    return [os.path.join(raw["vocab_dir"], name) for name in VOCAB]


def instances(pp, raw, train=range(N_TRAIN), test=range(N_TRAIN, N_IMAGES),
              **kw):
    return pp.build_instances_dataset(*load_raw(raw), *vocab_paths(raw),
                                      list(train), list(test), **kw)


def seeded_depth(image):
    """A depth map that depends on the image's pixels only."""
    return depth.normalize_depth(
        np.asarray(image, np.float32).mean(axis=2), FS)


def assert_records_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, list) or (isinstance(w, np.ndarray)
                                   and w.dtype == object):
            assert len(g) == len(w), k
            for a, b in zip(g, w):
                assert np.asarray(a).dtype == np.asarray(b).dtype, k
                np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_torch_phrases_and_vocabulary_readers_match_jax(raw):
    assert constants.VG_OBJECT_SUPER_CLASSES == \
        jax_constants.VG_OBJECT_SUPER_CLASSES
    assert constants.VG_RELATIONS_BY_FREQ == \
        jax_constants.VG_RELATIONS_BY_FREQ
    for phrase in ("  Man's  ", "½ cup—full…", "Trees!", "café™ 10°",
                   "ON A", "x¢çûèé"):
        assert tp.clean_phrase(phrase) == jp.clean_phrase(phrase)
    alias, pred_alias, obj_list, types = vocab_paths(raw)
    for path in (alias, pred_alias):
        assert tp.read_alias(path) == jp.read_alias(path)
    assert tp.read_list(obj_list) == jp.read_list(obj_list)
    name2cid = {n: i for i, n in enumerate(tp.read_list(obj_list)[:40])}
    assert tp.read_object_types(types, name2cid,
                                constants.VG_OBJECT_SUPER_CLASSES) == \
        jp.read_object_types(types, name2cid,
                             jax_constants.VG_OBJECT_SUPER_CLASSES)


def test_torch_cleaning_steps_match_jax(raw):
    """Each cleaning step in turn on deep copies: the data after every step
    equals the JAX package's."""
    img, obj_t, rel_t = load_raw(raw)
    obj_j, rel_j = copy.deepcopy(obj_t), copy.deepcopy(rel_t)
    alias, pred_alias = (os.path.join(raw["vocab_dir"], n)
                         for n in VOCAB[:2])
    areas = {i["image_id"]: i["width"] * i["height"] for i in img}
    steps = [
        (tp.sync_objects, jp.sync_objects, lambda o, r: (o, r)),
        (tp.normalize_names, jp.normalize_names,
         lambda o, r: (o, r, tp.read_alias(alias),
                       tp.read_alias(pred_alias))),
        (tp.filter_small_boxes, jp.filter_small_boxes,
         lambda o, r: (o, areas)),
        (tp.merge_duplicate_boxes, jp.merge_duplicate_boxes,
         lambda o, r: (o,)),
        (tp.remap_merged_relationships, jp.remap_merged_relationships,
         lambda o, r: (o, r)),
    ]
    merged = 0
    for port_fn, jax_fn, args in steps:
        port_fn(*args(obj_t, rel_t))
        jax_fn(*args(obj_j, rel_j))
        assert obj_t == obj_j and rel_t == rel_j, port_fn.__name__
        merged += sum(len(o.get("ids", [1])) > 1
                      for im in obj_t for o in im["objects"])
    assert merged > 0                 # the fixture has duplicates to merge


@pytest.mark.parametrize("kw", [{}, {"num_classes": 12, "num_relations": 9,
                                     "area_frac": 0.01}])
def test_torch_build_instances_dataset_matches_jax(raw, kw):
    got, want = instances(tp, raw, **kw), instances(jp, raw, **kw)
    assert got == want
    train, test, _ = got
    assert len(train["images"]) == N_TRAIN
    assert len(test["images"]) == N_IMAGES - N_TRAIN
    assert all(i["id"] != 1592 for s in (train, test)
               for i in s["images"])
    assert train["annotations"] and train["instances"]


def test_torch_build_image_annotation_matches_jax(raw):
    train, _, _ = instances(tp, raw)
    by_inst, by_rel = {}, {}
    for inst in train["instances"]:
        by_inst.setdefault(inst["image_id"], []).append(inst)
    for rel in train["annotations"]:
        by_rel.setdefault(rel["image_id"], []).append(rel)
    built = 0
    for img in train["images"] + [train["images"][0]]:
        d = None if built < N_TRAIN else \
            np.random.default_rng(1).random((FS, FS)).astype(np.float32)
        args = (img, by_inst.get(img["id"], []), by_rel.get(img["id"], []),
                FS, d)
        got, want = tp.build_image_annotation(*args), \
            jp.build_image_annotation(*args)
        assert (got is None) == (want is None)
        if got is not None:
            assert_records_equal(got, want)
            built += 1
    assert built == N_TRAIN + 1


def npz_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with np.load(path, allow_pickle=True) as z:
                out[os.path.relpath(path, root)] = {k: z[k] for k in z.files}
    return out


def assert_npz_trees_equal(got_dir, want_dir):
    got, want = npz_files(got_dir), npz_files(want_dir)
    assert sorted(got) == sorted(want) and want
    for name in want:
        assert_records_equal(got[name], want[name])


@pytest.mark.parametrize("with_depth", [False, True])
def test_torch_build_all_annotations_files_match_jax(raw, tmp_path,
                                                     with_depth):
    train, test, _ = instances(tp, raw)
    fn = seeded_depth if with_depth else None
    for split in (train, test):
        n_t = tp.build_all_annotations(split, str(tmp_path / "t"), FS, fn,
                                       raw["image_dir"])
        n_j = jp.build_all_annotations(split, str(tmp_path / "j"), FS, fn,
                                       raw["image_dir"])
        assert n_t == n_j > 0
    assert_npz_trees_equal(str(tmp_path / "t"), str(tmp_path / "j"))
    # VG's file names keep their image folder in the cache
    assert os.path.isdir(tmp_path / "t" / "VG_100K_2")
    depths = [r["image_depth"] for r in npz_files(str(tmp_path / "t"))
              .values()]
    assert all(d.shape == (1, FS, FS) for d in depths)
    assert any(d.any() for d in depths) == with_depth


def test_torch_load_h5_split_matches_jax(tmp_path, monkeypatch):
    # tests/reference_shim.py registers an empty h5py module where the
    # reference parity tests are collected first: read the real package
    if not hasattr(sys.modules.get("h5py"), "File"):
        monkeypatch.delitem(sys.modules, "h5py", raising=False)
    import h5py
    split = np.random.default_rng(0).choice([0, 1, 2], 50)
    path = str(tmp_path / "split.h5")
    with h5py.File(path, "w") as f:
        f["split"] = split
    got, want = tp.load_h5_split(path), jp.load_h5_split(path)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], np.nonzero(split == 0)[0])
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tp.load_h5_split(path)


def test_torch_raw_vg_to_loader_batches_match_jax(raw, tmp_path):
    """raw fixture -> each package's instances and annotation cache -> each
    package's VGDataset: the same batches, key by key (training, with the
    jittered view from one seed, and eval)."""
    data = {}
    for name, pp in (("t", tp), ("j", jp)):
        train, _, _ = instances(pp, raw)
        pp.build_all_annotations(train, str(tmp_path / name), FS)
        data[name] = train
    assert data["t"] == data["j"]
    for training in (True, False):
        kw = dict(data={"max_objects": 20, "image_dir": raw["image_dir"]},
                  model={"feature_size": FS, "image_size": 32})
        tc = derive("vg", **{**kw, "data": {
            **kw["data"], "annot_dir": str(tmp_path / "t")}})
        jc = jax_derive("vg", **{**kw, "data": {
            **kw["data"], "annot_dir": str(tmp_path / "j")}})
        got = list(dataset.batches_from_dataset(
            dataset.VGDataset(tc, data["t"], training=training), 2,
            shuffle=False, drop_last=False))
        want = list(jax_dataset.batches_from_dataset(
            jax_dataset.VGDataset(jc, data["j"], training=training), 2,
            shuffle=False, drop_last=False))
        assert len(got) == len(want) >= 2
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert ("image_aug" in g) == training
            for k in w:
                if k == "annot_path":
                    assert [os.path.relpath(p, str(tmp_path / "t"))
                            for p in g[k]] == \
                        [os.path.relpath(p, str(tmp_path / "j"))
                         for p in w[k]]
                else:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    rels = np.concatenate([b["rel"].ravel() for b in got])
    assert (rels >= 0).any()


HUBCONF = '''
import torch
dependencies = ["torch"]


class _Depth(torch.nn.Module):
    def forward(self, x):
        return x.mean(dim=1)


def DPT_Large(pretrained=True):
    if pretrained:
        torch.hub.download_url_to_file(
            "http://localhost:9/dpt_large.pt", "/nonexistent/dpt.pt")
    return _Depth()


def MiDaS_small(pretrained=True):
    return _Depth()


class _Transforms:
    @staticmethod
    def small_transform(image):
        return torch.as_tensor(image, dtype=torch.float32).permute(
            2, 0, 1)[None]


def transforms():
    return _Transforms()
'''


def test_torch_midas_depth_fn_loads_only_from_the_hub_cache(tmp_path,
                                                            monkeypatch):
    """make_midas_depth_fn reads MiDaS from torch.hub's cache and downloads
    nothing: None without the cached code, None when the code would fetch
    its weights (the fetch is refused and the hub's downloader restored),
    a depth map on the grid when the model loads."""
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path))
    assert depth.make_midas_depth_fn(device="cpu") is None
    repo = tmp_path / "intel-isl_MiDaS_master"
    repo.mkdir()
    (repo / "hubconf.py").write_text(HUBCONF)
    fetch = torch.hub.download_url_to_file
    assert depth.make_midas_depth_fn(device="cpu") is None
    assert torch.hub.download_url_to_file is fetch
    fn = depth.make_midas_depth_fn("MiDaS_small", feature_size=FS,
                                   device="cpu")
    image = np.random.default_rng(0).integers(0, 256, (40, 56, 3),
                                              dtype=np.uint8)
    want = torch.as_tensor(image, dtype=torch.float32).mean(dim=2)
    np.testing.assert_array_equal(
        fn(image), depth.normalize_depth(want.numpy(), FS))
