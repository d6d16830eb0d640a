"""The port's native batch packer (data/native: write_sgrec, the g++-built
sgc_pack.cc, NativeBatchPacker), NativeRecordPipeline, the SGRC record tool
(tools/sgrecords.py) and the CLI's native batch source against the JAX
package's, on the CPU (g++ builds the library here).

Tolerance: none.  Record bytes equal the JAX writer's; packed batches equal
the JAX packer's on the same records and jitter, key by key
(np.array_equal), at 1, 4 and 8 threads; the native path with a feature
cache equals the port's Python loader key by key (annotation paths by image
name); two processes building the library at once both load it."""

import argparse
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

sys.path.insert(0, "tests")
sys.path.insert(0, "tools")
from test_native import make_record  # noqa: E402
from test_torch_dataset import N_MAX, make_vg  # noqa: E402

from scene_graph_commonsense_tpu.config import derive as jax_derive  # noqa
from scene_graph_commonsense_tpu.data import native as jax_native  # noqa
from scene_graph_commonsense_tpu.data import pipeline as jax_pipeline  # noqa
from scene_graph_commonsense_tpu.data.dataset import (  # noqa: E402
    color_jitter_params as jax_jitter_params)
from scene_graph_commonsense_torch.config import derive  # noqa: E402
from scene_graph_commonsense_torch.data import native  # noqa: E402
from scene_graph_commonsense_torch.data import pipeline  # noqa: E402
from scene_graph_commonsense_torch.data.dataset import (  # noqa: E402
    VGDataset, batches_from_dataset, color_jitter_params)

S, K = 16, 5
KEYS = ("cats", "boxes", "rel", "valid", "super_mh", "depth", "ok")


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's packer, built into a directory of this module's
    own: its build writes straight to its target, so it must not share
    one with the JAX tests that may build at the same time."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB", str(
            tmp_path_factory.mktemp("jax_native") / "libsgc_pack.so"))
        if jax_native.build_library() is None:
            pytest.fail("g++ could not build the JAX package's packer")
        yield


def _records(tmp_path, rng, counts, images=None):
    paths = []
    for i, n in enumerate(counts):
        p = str(tmp_path / f"r{i}.sgrec")
        image = None if images is None else images[i]
        native.write_sgrec(p, *make_record(rng, n, S, K), feature_size=S,
                           num_super=K, image=image)
        paths.append(p)
    return paths


def _assert_equal(got, want, keys):
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("n,image", [(1, None), (2, None), (7, None),
                                     (4, (37, 53)), (3, (1, 1))])
def test_torch_write_sgrec_bytes_equal_jax(tmp_path, n, image):
    rng = np.random.default_rng(n)
    rec = make_record(rng, n, S, K)
    raw = None if image is None else rng.integers(
        0, 256, (*image, 3)).astype(np.uint8)
    native.write_sgrec(str(tmp_path / "port"), *rec, feature_size=S,
                       num_super=K, image=raw)
    jax_native.write_sgrec(str(tmp_path / "jax"), *rec, feature_size=S,
                           num_super=K, image=raw)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()


def test_torch_write_sgrec_rejects_bad_input(tmp_path):
    rng = np.random.default_rng(0)
    cats, boxes, smh, rels, dirs, depth = make_record(rng, 4, S, K)
    p = str(tmp_path / "bad")
    with pytest.raises(ValueError, match="entries"):
        native.write_sgrec(p, cats, boxes, smh, rels[:-1], dirs[:-1], depth,
                           feature_size=S, num_super=K)
    with pytest.raises(ValueError, match="depth"):
        native.write_sgrec(p, cats, boxes, smh, rels, dirs, depth[:-1],
                           feature_size=S, num_super=K)
    with pytest.raises(ValueError, match="uint8"):
        native.write_sgrec(p, cats, boxes, smh, rels, dirs, depth,
                           feature_size=S, num_super=K,
                           image=np.zeros((4, 4, 3), np.float32))


@pytest.mark.parametrize("threads", [1, 4, 8])
def test_torch_packer_equals_jax(tmp_path, jax_lib, threads):
    rng = np.random.default_rng(3)
    counts = [int(c) for c in rng.integers(2, 9, 13)]
    paths = _records(tmp_path, rng, counts)
    # rejects: too many objects, garbage, a missing file, one object
    big = str(tmp_path / "big.sgrec")
    native.write_sgrec(big, *make_record(rng, 9, S, K), feature_size=S,
                       num_super=K)
    one = str(tmp_path / "one.sgrec")
    native.write_sgrec(one, *make_record(rng, 1, S, K), feature_size=S,
                       num_super=K)
    garbage = tmp_path / "garbage.sgrec"
    garbage.write_bytes(b"nonsense")
    paths[1:1] = [big, str(garbage), str(tmp_path / "missing.sgrec"), one]
    kw = dict(max_objects=8, feature_size=S, num_super=K,
              num_threads=threads)
    got = native.NativeBatchPacker(**kw).pack(paths)
    want = jax_native.NativeBatchPacker(**kw).pack(paths)
    _assert_equal(got, want, KEYS)
    assert got["num_packed"] == want["num_packed"] == 13
    assert list(got["ok"][1:5]) == [False] * 4
    assert not got["valid"][1:5].any() and (got["rel"][1:5] == -1).all()


@pytest.mark.parametrize("threads,want_plain", [(1, True), (4, False),
                                                (8, True)])
def test_torch_train_packer_equals_jax(tmp_path, jax_lib, threads,
                                       want_plain):
    rng = np.random.default_rng(4)
    sizes = [(37, 53), (120, 90), (64, 64), (30, 200), (75, 40), (50, 60)]
    raws = [rng.integers(0, 256, (*hw, 3)).astype(np.uint8) for hw in sizes]
    raws[2] = None                         # a v1 record: rejected
    paths = _records(tmp_path, rng, [3, 5, 2, 8, 4, 6], raws)
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    jitter = np.zeros((len(paths), 9), np.float32)
    for i in range(len(paths)):
        apply, order, factors = color_jitter_params(trng)
        wa, wo, wf = jax_jitter_params(jrng)
        assert apply == wa and np.array_equal(order, wo)
        jitter[i] = [float(apply), *order, *factors]
    assert jitter[:, 0].any() and not jitter[:, 0].all()
    kw = dict(max_objects=8, feature_size=S, num_super=K,
              num_threads=threads)
    got = native.NativeBatchPacker(**kw).pack_train(
        paths, jitter, 48, want_plain=want_plain)
    want = jax_native.NativeBatchPacker(**kw).pack_train(
        paths, jitter, 48, want_plain=want_plain)
    keys = KEYS + ("image_aug",) + (("image",) if want_plain else ())
    assert set(got) == set(want)
    _assert_equal(got, want, keys)
    assert list(got["ok"]) == [True, True, False, True, True, True]
    with pytest.raises(ValueError, match="jitter"):
        native.NativeBatchPacker(**kw).pack_train(paths, jitter[:2], 48)


@pytest.mark.parametrize("training", [False, True])
def test_torch_record_pipeline_equals_jax(tmp_path, jax_lib, training):
    rng = np.random.default_rng(5)
    counts = [int(c) for c in rng.integers(2, 9, 11)]
    raws = [rng.integers(0, 256, (int(rng.integers(20, 70)),
                                  int(rng.integers(20, 70)), 3)).astype(
        np.uint8) for _ in counts] if training else None
    paths = _records(tmp_path, rng, counts, raws)
    garbage = tmp_path / "bad.sgrec"
    garbage.write_bytes(b"garbage")
    paths.insert(3, str(garbage))            # skipped, the batch refilled
    kw = dict(batch_size=4, max_objects=8, feature_size=S, num_super=K,
              num_threads=4, seed=2, shuffle=True, training=training,
              image_size=32 if training else 0, want_plain=training)
    got_pipe = pipeline.NativeRecordPipeline(paths, **kw)
    want_pipe = jax_pipeline.NativeRecordPipeline(paths, **kw)
    for epoch in (0, 1):
        got = list(got_pipe.iter_epoch(epoch))
        want = list(want_pipe.iter_epoch(epoch))
        assert len(got) == len(want) == 2      # 11 good records
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            assert g["annot_path"] == w["annot_path"]
            _assert_equal(g, w, [k for k in w if k != "annot_path"])
            assert g["valid"].any(axis=1).all()
    with pytest.raises(ValueError, match="image_size"):
        pipeline.NativeRecordPipeline(paths, 4, training=True)


@pytest.fixture(scope="module")
def vg(tmp_path_factory):
    root = tmp_path_factory.mktemp("mini_vg_native")
    data = make_vg(root)
    # a feature cache of every image: the CLI's native source reads it
    feat = root / "features"
    feat.mkdir()
    rng = np.random.default_rng(6)
    for split in ("train", "test"):
        with open(data[f"annotation_{split}"]) as f:
            for img in json.load(f)["images"]:
                name = os.path.splitext(img["file_name"])[0]
                np.savez_compressed(feat / f"{name}_features.npz",
                                    features=rng.standard_normal(
                                        (8, 8, 4)).astype(np.float16))
    return {**data, "features_dir": str(feat)}


@pytest.mark.parametrize("split,embed", [("test", False), ("train", True)])
def test_torch_sgrecords_bytes_equal_jax(vg, tmp_path, split, embed):
    from preprocess_vg import stage_sgrecords
    from scene_graph_commonsense_torch.tools.sgrecords import (
        write_sgrecords)
    data = {k: v for k, v in vg.items() if k != "features_dir"}
    model = {"feature_size": 8}
    jc = jax_derive("vg", model=model, data={**data, "max_objects": N_MAX})
    tc = derive("vg", model=model, data={**data, "max_objects": N_MAX})
    want = stage_sgrecords(argparse.Namespace(
        split=split, out=str(tmp_path / "jax"), embed_images=embed), jc,
        log_fn=lambda *a: None)
    got = write_sgrecords(tc, split, str(tmp_path / "port"),
                          embed_images=embed, log_fn=lambda *a: None)
    assert got == want > 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() \
            == (tmp_path / "jax" / name).read_bytes(), name


def test_torch_native_path_matches_python_loader(vg, tmp_path):
    """v1 records + the feature cache through the CLI's native source equal
    the port's Python loader with the same cache (PredCLS eval)."""
    from scene_graph_commonsense_torch import __main__ as cli
    from scene_graph_commonsense_torch.tools.sgrecords import (
        write_sgrecords)
    cfg = derive("vg", model={"feature_size": 8},
                 data={**vg, "max_objects": N_MAX,
                       "sgrc_dir": str(tmp_path / "sgrc")},
                 training={"batch_size": 3, "eval_mode": "pc"})
    write_sgrecords(cfg, "test", cfg.data.sgrc_dir, log_fn=lambda *a: None)
    native_b = list(cli.native_batches(cfg)())
    with open(cfg.data.annotation_test) as f:
        images = json.load(f)
    # the records are sorted by name; so are the test images here
    images["images"].sort(key=lambda i: i["file_name"])
    ds = VGDataset(cfg, images, training=False)
    python_b = list(batches_from_dataset(ds, 3, shuffle=False))
    assert len(native_b) == len(python_b) >= 2
    for nb, pb in zip(native_b, python_b):
        assert set(nb) == set(pb)
        for k in pb:
            if k == "annot_path":
                want = [os.path.basename(p).rsplit("_annotations", 1)[0]
                        for p in pb[k]]
                got = [os.path.basename(p)[:-len(".sgrec")] for p in nb[k]]
                assert got == want
            else:
                assert nb[k].dtype == pb[k].dtype, k
                assert np.array_equal(nb[k], pb[k]), k
    # real_batches takes the native source for PredCLS eval with a cache
    assert cli.real_batches(cfg, training=False).__qualname__ \
        == cli.native_batches(cfg).__qualname__


def test_torch_packer_builds_in_two_processes_at_once(tmp_path):
    """Two processes building the library into an empty directory at the
    same time both load it; one library is left, no temporary file."""
    rng = np.random.default_rng(8)
    rec = str(tmp_path / "r.sgrec")
    native.write_sgrec(rec, *make_record(rng, 4, S, K), feature_size=S,
                       num_super=K)
    build = tmp_path / "build"
    script = textwrap.dedent(f"""
        import pathlib
        from scene_graph_commonsense_torch.data import native
        native.BUILD_DIR = pathlib.Path({str(build)!r})
        out = native.NativeBatchPacker(8, {S}, {K}).pack([{rec!r}])
        assert out["num_packed"] == 1
        print("packed", native.library_path().name)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.startswith("packed libsgc_pack_")
    assert [p.name for p in build.iterdir()] == [
        outs[0][0].split()[1]]


def test_torch_packer_raises_when_gxx_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "GXX_FLAGS",
                        native.GXX_FLAGS + ("-include", "no_such_header.h"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.NativeBatchPacker()
    assert not list(tmp_path.iterdir())
