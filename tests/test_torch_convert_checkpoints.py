"""The port's checkpoint tool (tools/convert_checkpoints.py) and its weight
functions (models/weights.py: apply_key_remap, load_torch_checkpoint,
strip_ddp_prefix, from_reference_state_dict) against the JAX package's, on
the CPU.

Relation checkpoints: a seeded state dict in the reference's torch layout
(DDP 'module.' prefixes, saved as the reference's training saves it, once
under "model" beside an argparse.Namespace) at reduced widths (hidden 4,
grid 8), hierarchical and flat, VG and OIv6 class counts, through the tool;
the .pt it writes equals weights.from_flax of the JAX package's
convert_relation_state_dict of the same dict, exactly (torch.equal, same
dtype), and loads into the port's model; the CLI's --run_mode eval
restores it from training.checkpoint_path.  DETR: the hub-named replica of
tests/torch_detr.py at depth (1, 1, 1, 1) / 1 / 1, its backbone renamed to
detectron2's names through a before/after table; apply_key_remap gives the
JAX package's keys and arrays, and the tool's file loads through
load_detr_featurizer and encodes equal (torch.equal) to the un-renamed
dict.  A checkpoint that pickles other objects is refused."""

import argparse
import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from torch_detr import TorchDETR, randomize_bn_stats  # noqa: E402

from scene_graph_commonsense_tpu.models import weights as jax_weights  # noqa
from scene_graph_commonsense_torch.config import derive  # noqa: E402
from scene_graph_commonsense_torch.models import weights  # noqa: E402
from scene_graph_commonsense_torch.models.relation_head import (  # noqa
    make_relation_classifier)
from scene_graph_commonsense_torch.tools import convert_checkpoints  # noqa
from scene_graph_commonsense_torch.train import checkpoint as ckpt_lib  # noqa
from scene_graph_commonsense_torch.train import loop  # noqa: E402

H, FS, NS = 4, 8, 17
# the hierarchical heads' branch sizes (geometric, possessive, semantic)
BRANCHES = {"vg": (15, 11, 24), "oiv6": (4, 2, 24)}


def reference_state(rng, dataset, hierarchical):
    """A reference Bayesian/Flat RelationClassifier state dict (numpy,
    reference model.py:105-186) under DDP's prefixes."""
    num_classes = 150 if dataset == "vg" else 601
    use_super = dataset == "vg"
    st = {}

    def layer(name, *shape):
        st[f"module.{name}.weight"] = rng.standard_normal(shape) \
            .astype(np.float32) / np.sqrt(np.prod(shape[1:]))
        st[f"module.{name}.bias"] = 0.1 * rng.standard_normal(shape[0]) \
            .astype(np.float32)

    layer("conv1_1", H, 2 * H + 1, 1, 1)
    layer("conv1_2", H, 2 * H + 1, 1, 1)
    layer("conv2_1", 4 * H, 2 * H, 3, 3)
    layer("conv3_1", 8 * H, 4 * H, 3, 3)
    layer("fc1", 4096, 8 * H * (FS // 4) ** 2)
    layer("fc2", 512, 4096 + 2 * num_classes + (2 * NS if use_super else 0))
    layer("fc4", 1, 512)
    if hierarchical:
        for i, n in enumerate(BRANCHES[dataset]):
            layer(f"fc3_{i + 1}", n, 512)
        layer("fc5", 3, 512)
    else:
        layer("fc3", sum(BRANCHES[dataset]), 512)
    return st


@pytest.mark.parametrize("hierar", [True, False])
@pytest.mark.parametrize("dataset", ["vg", "oiv6"])
def test_torch_convert_relation_equals_jax_converter(tmp_path, rng, hierar,
                                                     dataset):
    num_classes = 150 if dataset == "vg" else 601
    use_super = dataset == "vg"
    st = reference_state(rng, dataset, hierar)
    src = str(tmp_path / "ref.pth")
    tensors = {k: torch.from_numpy(v) for k, v in st.items()}
    torch.save({"model": tensors, "args": argparse.Namespace(lr=0.1)}
               if hierar else tensors, src)
    out = str(tmp_path / "HierRelationModel_Baseline_motif0.pt")
    convert_checkpoints.main(["--kind", "relation", "--src", src, "--out",
                              out, "--dataset", dataset]
                             + (["--hierar"] if hierar else []))
    got = ckpt_lib.load(out)
    want = weights.from_flax(jax_weights.convert_relation_state_dict(
        st, hierarchical=hierar, use_super=use_super,
        num_classes=num_classes, num_super_classes=NS, hidden_dim=H,
        feature_size=FS))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    cfg = derive(dataset, hierarchical_pred=hierar,
                 model={"hidden_dim": H, "feature_size": FS,
                        "num_img_feature": 2 * H,
                        "compute_dtype": "float32"})
    make_relation_classifier(cfg, device="cpu", state_dict=got)


def test_torch_cli_eval_restores_the_converted_relation_checkpoint(
        tmp_path, rng):
    """The tool's .pt, named as the CLI names its checkpoints, is what
    `--run_mode eval` loads (python -m scene_graph_commonsense_torch)."""
    tensors = {k: torch.from_numpy(v)
               for k, v in reference_state(rng, "vg", True).items()}
    torch.save(tensors, tmp_path / "ref.pth")
    ck = tmp_path / "ck"
    convert_checkpoints.main([
        "--kind", "relation", "--hierar", "--src", str(tmp_path / "ref.pth"),
        "--out", str(ck / "HierRelationModel_Baseline_motif0.pt")])
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(json.dumps({
        "model": {"hidden_dim": H, "feature_size": FS,
                  "num_img_feature": 2 * H, "compute_dtype": "float32"},
        "data": {"max_objects": 4},
        "training": {"batch_size": 2, "test_epoch": 0,
                     "checkpoint_path": str(ck),
                     "result_path": str(tmp_path / "res")}}))
    out = subprocess.run(
        [sys.executable, "-m", "scene_graph_commonsense_torch",
         "--run_mode", "eval", "--eval_mode", "pc", "--hierar",
         "--synthetic", "1", "--config", str(cfg), "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Loaded relation checkpoint" in out.stdout


def test_torch_relation_widths_reject_a_non_square_grid(rng):
    st = reference_state(rng, "vg", True)
    assert convert_checkpoints.relation_widths(st) == {
        "hidden_dim": H, "feature_size": FS}
    st["module.fc1.weight"] = st["module.fc1.weight"][:, :-8 * H]
    with pytest.raises(ValueError, match="square grid"):
        convert_checkpoints.relation_widths(st)


def detectron2_name(key):
    """The detectron2 name of a torch-hub DETR backbone key (the names the
    reference's checkpoint carries, reference utils.py:96-119)."""
    m = re.fullmatch(r"backbone\.0\.body\.(.*)", key)
    if m is None:
        return key
    k = m.group(1)
    k = re.sub(r"^conv1\.", "stem.conv1.", k)
    k = re.sub(r"^bn1\.", "stem.conv1.norm.", k)
    k = re.sub(r"^layer(\d)\.",
               lambda g: f"res{int(g.group(1)) + 1}.", k)
    k = re.sub(r"\.bn(\d)\.", r".conv\1.norm.", k)
    k = k.replace(".downsample.0.", ".shortcut.")
    k = k.replace(".downsample.1.", ".shortcut.norm.")
    return "backbone." + k


def write_remap(root, keys):
    renamed = [k for k in keys if detectron2_name(k) != k]
    (root / "detr101_key_before.txt").write_text(
        "\n".join(detectron2_name(k) for k in renamed) + "\n")
    (root / "detr101_key_after.txt").write_text("\n".join(renamed) + "\n")
    return len(renamed)


DETR_MODEL = {"detr_blocks": (1, 1, 1, 1), "detr_enc_layers": 1,
              "detr_dec_layers": 1, "compute_dtype": "float32",
              "image_size": 64}


def test_torch_convert_detr_with_remap_encodes_as_the_hub_dict(tmp_path):
    torch.manual_seed(0)
    tm = TorchDETR(blocks=(1, 1, 1, 1), n_enc=1, n_dec=1)
    randomize_bn_stats(tm)
    hub = tm.state_dict()
    assert write_remap(tmp_path, list(hub)) > 50
    d2 = {detectron2_name(k): v for k, v in hub.items()}
    d2_np = {k: v.numpy() for k, v in d2.items()}
    before = str(tmp_path / "detr101_key_before.txt")
    after = str(tmp_path / "detr101_key_after.txt")
    got = weights.apply_key_remap(d2, before, after)
    want = jax_weights.apply_key_remap(d2_np, before, after)
    assert list(got) == list(want) == list(hub)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])

    src = str(tmp_path / "detr101_vg_ckpt.pth")
    torch.save({"model": {"module." + k: v for k, v in d2.items()},
                "epoch": 3, "args": argparse.Namespace(lr=1e-4)}, src)
    out = str(tmp_path / "detr101_vg.pth")
    convert_checkpoints.main(["--kind", "detr", "--src", src, "--out", out,
                              "--remap", str(tmp_path)])
    plain = str(tmp_path / "hub.pth")
    torch.save(hub, plain)
    images = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 64, 64, 3)), dtype=torch.float32)
    feats = []
    for path in (out, plain):
        cfg = derive("vg", model={**DETR_MODEL, "detr_pretrained": path})
        featurize, _ = loop.load_detr_featurizer(cfg, device="cpu",
                                                 log_fn=pytest.fail)
        feats.append(featurize({"image": images})["features"])
        loop.load_detr(cfg, device="cpu", detection=True,
                       log_fn=pytest.fail)
    assert feats[0].shape == (2, 2, 2, 256)
    assert torch.equal(feats[0], feats[1])


class _Payload:
    def __reduce__(self):
        return (print, ("unpickled",))


def test_torch_load_torch_checkpoint_refuses_other_objects(tmp_path):
    path = str(tmp_path / "bad.pth")
    with open(path, "wb") as f:
        pickle.dump({"model": {"w": torch.zeros(2)}, "x": _Payload()}, f,
                    protocol=2)
    with pytest.raises(pickle.UnpicklingError):
        weights.load_torch_checkpoint(path)
    torch.save({"w": torch.ones(2)}, path)
    assert torch.equal(weights.load_torch_checkpoint(path)["w"],
                       torch.ones(2))
