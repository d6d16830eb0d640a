"""The port's preprocessing CLI (tools/preprocess_vg.py: the instances,
annotations, triplets and sgrecords stages) against the repo's
tools/preprocess_vg.py, on the CPU: both mains on the same raw VG (the
fixture of tests/test_torch_preprocess.py), each writing under its own
directories from a YAML config, from a working directory that holds the
vocabulary files at datasets/vg_scene_graph_annot.

Tolerance: none.  The instances JSONs equal the JAX stage's; the annotation
.npz files equal key by key, object arrays included (with --with_depth and
no MiDaS too: zero maps and the same printed line); vg_artifacts.npz equals
the JAX stage's key by key under a temporary artifacts_dir (the repo's file
untouched); the SGRC records equal byte for byte.  The instances stage
asserts the real split's sizes (75651 / 32422): both modules' load_h5_split
is replaced inside the test by one that gives index arrays of those sizes
over the fixture's images.  The JAX sgrecords stage cannot create the image
folders of VG's file names (VG_100K/<id>): the test makes them for it."""

import hashlib
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
sys.path.insert(0, "tools")
import preprocess_vg as jax_tool  # noqa: E402
from test_torch_preprocess import (  # noqa: E402
    N_IMAGES, N_TRAIN, SIZES, assert_npz_trees_equal)

from scene_graph_commonsense_tpu.data import depth as jax_depth  # noqa
from scene_graph_commonsense_tpu.data import preprocess as jp  # noqa: E402
from scene_graph_commonsense_torch.data import preprocess as tp  # noqa
from scene_graph_commonsense_torch.tools import preprocess_vg  # noqa: E402
from scene_graph_commonsense_torch.tools.make_raw_vg import (  # noqa: E402
    make_raw_vg)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(ROOT, "datasets", "artifacts", "vg_artifacts.npz")
FS = 8


def _config(root, name, raw):
    d = root / name
    data = {"annotation_train": str(d / "instances_vg_train.json"),
            "annotation_test": str(d / "instances_vg_test.json"),
            "annot_dir": str(d / "annot"), "image_dir": raw["image_dir"],
            "artifacts_dir": str(d / "artifacts")}
    d.mkdir()
    (d / "artifacts").mkdir()
    shutil.copy(ARTIFACTS, d / "artifacts")
    path = d / "cfg.yaml"
    path.write_text(json.dumps({"data": data,
                                "model": {"feature_size": FS}}))
    return str(path), data


@pytest.fixture(scope="module")
def vg(tmp_path_factory):
    """The raw VG, the vocabulary at the working directory's
    datasets/vg_scene_graph_annot, one config for each package, and the
    instances JSONs of both at the natural split."""
    root = tmp_path_factory.mktemp("preprocess_vg")
    raw = make_raw_vg(str(root / "rawvg"), images=N_IMAGES, seed=3,
                      sizes=SIZES, max_objects=8)
    shutil.copytree(raw["vocab_dir"], root / preprocess_vg.VOCAB_DIR)
    cfgs = {name: _config(root, name, raw) for name in ("t", "j")}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        tcfg = preprocess_vg.load_config(cfgs["t"][0])
        preprocess_vg.write_instances(tcfg, raw["raw_dir"], range(N_TRAIN),
                                      range(N_TRAIN, N_IMAGES))
    finally:
        os.chdir(cwd)
    for split in ("train", "test"):
        shutil.copy(cfgs["t"][1][f"annotation_{split}"],
                    cfgs["j"][1][f"annotation_{split}"])
    return {"root": root, "raw": raw, "cfgs": cfgs}


def run_both(vg, monkeypatch, capsys, *args):
    """Both mains with the same arguments (each its config); returns their
    printed lines with each package's directory named <dir>."""
    monkeypatch.chdir(vg["root"])
    out = {}
    for name in ("t", "j"):
        path, _ = vg["cfgs"][name]
        argv = ["--config", path, *args]
        if name == "t":
            preprocess_vg.main(argv + ["--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", ["preprocess_vg.py", *argv])
            jax_tool.main()
        out[name] = capsys.readouterr().out.replace(
            str(vg["root"] / name), "<dir>").splitlines()
    assert out["t"] == out["j"]
    return out["t"]


def test_torch_stage_instances_matches_jax(vg, monkeypatch, capsys):
    sizes = preprocess_vg.H5_SPLIT_SIZES
    split = (np.resize(np.arange(N_TRAIN), sizes[0]),
             N_TRAIN + np.resize(np.arange(N_IMAGES - N_TRAIN), sizes[1]))
    for pp in (tp, jp):
        monkeypatch.setattr(pp, "load_h5_split", lambda path: split)
    lines = run_both(vg, monkeypatch, capsys, "--stage", "instances",
                     "--raw_dir", vg["raw"]["raw_dir"])
    assert lines == [f"wrote <dir>/instances_vg_train.json ({sizes[0]} "
                     f"images) and <dir>/instances_vg_test.json "
                     f"({sizes[1]} images)"]
    for split_name in ("train", "test"):
        got, want = (json.load(open(vg["cfgs"][n][1][
            f"annotation_{split_name}"])) for n in ("t", "j"))
        assert got == want
    # the port refuses another split with a message, not an assert
    monkeypatch.setattr(tp, "load_h5_split",
                        lambda path: (split[0][:5], split[1]))
    with pytest.raises(ValueError, match="75651"):
        preprocess_vg.main(["--stage", "instances", "--config",
                            vg["cfgs"]["t"][0]])
    # leave the natural split for the stages after this one
    for name in ("t", "j"):
        preprocess_vg.write_instances(
            preprocess_vg.load_config(vg["cfgs"][name][0]),
            vg["raw"]["raw_dir"], range(N_TRAIN), range(N_TRAIN, N_IMAGES),
            vocab_dir=str(vg["root"] / preprocess_vg.VOCAB_DIR))


@pytest.mark.parametrize("with_depth", [False, True])
def test_torch_stage_annotations_matches_jax(vg, monkeypatch, capsys,
                                             tmp_path, with_depth):
    """Without MiDaS on disk (an empty torch.hub cache; the JAX package's
    loader, which would download, replaced by one that finds nothing)."""
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path))
    monkeypatch.setattr(jax_depth, "make_midas_depth_fn",
                        lambda **kw: None)
    for name in ("t", "j"):
        shutil.rmtree(vg["cfgs"][name][1]["annot_dir"], ignore_errors=True)
    extra = ["--with_depth"] if with_depth else []
    for split in ("train", "test"):
        lines = run_both(vg, monkeypatch, capsys, "--stage", "annotations",
                         "--split", split, *extra)
        assert ("MiDaS unavailable; writing zero depth maps" in lines) \
            == with_depth
        assert lines[-1].startswith("wrote ")
    assert_npz_trees_equal(vg["cfgs"]["t"][1]["annot_dir"],
                           vg["cfgs"]["j"][1]["annot_dir"])


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_torch_stage_triplets_matches_jax(vg, monkeypatch, capsys):
    before = _digest(ARTIFACTS)
    lines = run_both(vg, monkeypatch, capsys, "--stage", "triplets")
    assert lines[-1] == "wrote <dir>/artifacts/vg_artifacts.npz"
    assert _digest(ARTIFACTS) == before
    got, want = (np.load(os.path.join(vg["cfgs"][n][1]["artifacts_dir"],
                                      "vg_artifacts.npz"))
                 for n in ("t", "j"))
    with np.load(ARTIFACTS) as repo:
        assert set(got.files) == set(want.files) >= set(repo.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the wears -> wearing merge: raw 12 never reaches a table
    assert len(got["train_rel"]) > 0


@pytest.mark.parametrize("split,embed", [("train", True), ("test", False)])
def test_torch_stage_sgrecords_matches_jax(vg, monkeypatch, capsys, split,
                                           embed):
    if not os.path.isdir(vg["cfgs"]["t"][1]["annot_dir"]):
        for name in ("t", "j"):
            tp.build_all_annotations(
                json.load(open(vg["cfgs"][name][1][f"annotation_{split}"])),
                vg["cfgs"][name][1]["annot_dir"], FS)
    outs = {n: vg["root"] / n / f"sgrc_{split}" for n in ("t", "j")}
    for folder in ("VG_100K", "VG_100K_2"):
        (outs["j"] / folder).mkdir(parents=True, exist_ok=True)
    args = ["--stage", "sgrecords", "--split", split]
    if embed:
        args.append("--embed-images")
    monkeypatch.chdir(vg["root"])
    preprocess_vg.main(["--config", vg["cfgs"]["t"][0], *args,
                        "--out", str(outs["t"])])
    monkeypatch.setattr(sys, "argv", ["preprocess_vg.py", "--config",
                                      vg["cfgs"]["j"][0], *args, "--out",
                                      str(outs["j"])])
    jax_tool.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].replace(str(outs["t"]), "<out>") == \
        lines[1].replace(str(outs["j"]), "<out>")
    files = {n: sorted(str(p.relative_to(d)) for p in d.rglob("*.sgrec"))
             for n, d in outs.items()}
    assert files["t"] == files["j"] and files["t"]
    for name in files["t"]:
        assert (outs["t"] / name).read_bytes() == \
            (outs["j"] / name).read_bytes(), name
