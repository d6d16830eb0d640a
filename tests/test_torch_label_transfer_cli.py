"""The port's IETrans / NICE tool (tools/label_transfer.py) against the
repo's tools/label_transfer.py, on the CPU: both mains with the same
arguments and the same weights (the JAX tool's seeded initialisation, handed
to the port's as a .pt through weights.from_flax), the relation head in
float64 (JAX with x64 on): --synthetic batches, and a real pass over the
train split of a mini-VG (the repo's tools/make_mini_vg.py, the feature
grid 8) through a feature cache, in both modes.

Tolerance: none.  The JSON summary line equals the JAX tool's key for key,
and the rewritten annotation files equal the JAX tool's key by key, object
arrays included."""

import json
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, "tests")
sys.path.insert(0, "tools")
import label_transfer as jax_tool  # noqa: E402
from test_engine import init_params  # noqa: E402
from test_torch_dataset import make_vg  # noqa: E402
from test_torch_preprocess import assert_npz_trees_equal  # noqa: E402

from scene_graph_commonsense_tpu.config import load_config as jax_load  # noqa
from scene_graph_commonsense_tpu.models.relation_head import (  # noqa: E402
    make_relation_classifier)
from scene_graph_commonsense_torch.models import weights  # noqa: E402
from scene_graph_commonsense_torch.tools import label_transfer  # noqa: E402
from scene_graph_commonsense_torch.train import checkpoint as ckpt_lib  # noqa

# the relation head on the tiny DETR's grid, in float64; the DETR itself is
# built (as both tools build it) but the cache gives every feature map
MODEL = {"feature_size": 8, "image_size": 256, "hidden_dim": 8,
         "num_img_feature": 256, "compute_dtype": "float64",
         "detr_blocks": [1, 1, 1, 1], "detr_enc_layers": 1,
         "detr_dec_layers": 1, "dropout_rate": 0.0}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The mini-VG with a feature cache of its train split, the YAML of
    both runs, and the JAX tool's initial weights as the port's .pt."""
    root = tmp_path_factory.mktemp("label_transfer")
    data = {**make_vg(root, edge_cases=False), "max_objects": 6,
            "features_dir": str(root / "features")}
    rng = np.random.default_rng(7)
    with open(data["annotation_train"]) as f:
        for img in json.load(f)["images"]:
            name = os.path.splitext(img["file_name"])[0]
            path = root / "features" / f"{name}_features.npz"
            path.parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(path, features=rng.standard_normal(
                (8, 8, 256)).astype(np.float16))
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(json.dumps({"model": MODEL, "data": data}))
    with jax.enable_x64():
        jc = jax_load(str(cfg_path))
        params = init_params(jc, make_relation_classifier(jc), None)
    pt = str(root / "init.pt")
    ckpt_lib.save(pt, weights.from_flax(params))
    return {"root": root, "cfg": str(cfg_path), "pt": pt}


def run_both(setup, monkeypatch, capsys, *args):
    argv = ["--config", setup["cfg"], "--batch_size", "3", *args]
    label_transfer.main(argv + ["--device", "cpu", "--checkpoint",
                                setup["pt"]])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["label_transfer.py", *argv])
    with jax.enable_x64():
        jax_tool.main()
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(got) == json.loads(want)
    return json.loads(got)


def test_torch_label_transfer_synthetic_matches_jax(setup, monkeypatch,
                                                    capsys):
    line = run_both(setup, monkeypatch, capsys, "--mode", "ietrans",
                    "--synthetic", "2")
    assert line["images"] == 6 and line["written"] == 0
    assert line["relabeled"] + line["added"] > 0


@pytest.mark.parametrize("mode", ["ietrans", "nice"])
def test_torch_label_transfer_real_pass_matches_jax(setup, monkeypatch,
                                                    capsys, mode):
    outs = {n: str(setup["root"] / f"{mode}_{n}") for n in ("t", "j")}
    argv = ["--mode", mode, "--percent", "50"]
    label_transfer.main(["--config", setup["cfg"], "--batch_size", "3",
                         *argv, "--out_dir", outs["t"], "--device", "cpu",
                         "--checkpoint", setup["pt"]])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(sys, "argv", ["label_transfer.py", "--config",
                                      setup["cfg"], "--batch_size", "3",
                                      *argv, "--out_dir", outs["j"]])
    with jax.enable_x64():
        jax_tool.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["images"] == 12 and got["written"] > 0
    assert_npz_trees_equal(outs["t"], outs["j"])
