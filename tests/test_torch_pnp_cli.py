"""fit_predictor and the CLI's --predictor / --tde (train/pnp_engine.py,
__main__.py) against the JAX package's on the CPU: the checkpoints each
epoch writes (the port's names are the JAX package's with ".pt"), the
train_cs run resuming from the baseline's last checkpoint, the log lines,
and the CLI's two refusals.  The weights differ (each package draws its
own init), so no number is compared here: tests/test_torch_pnp.py holds
the steps."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_tiny import batches, cfgs

from scene_graph_commonsense_tpu.train import pnp_engine as jax_pnp
from scene_graph_commonsense_torch.train import pnp_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Artifacts:
    """The commonsense tables train_cs reads (no zero-shot table)."""

    def __init__(self, n_ids):
        rng = np.random.default_rng(0)
        self.zs_table = None
        self.cs_aligned = rng.random(n_ids) < 0.3
        self.cs_violated = rng.random(n_ids) < 0.3


def _shape(line):
    """A log line without its numbers and its checkpoint directory."""
    line = line.split(" R@k:")[0]
    if "batch" in line:
        line = " ".join(w.split("=")[0] for w in line.split())
    return os.path.basename(line).removesuffix(".pt")


def test_torch_fit_predictor_checkpoints_and_train_cs_resume(tmp_path):
    jc, tc = cfgs(dtype="float32", training={"num_epoch": 1,
                                             "print_freq": 1})
    bs = batches(2, with_aug=True, float64=False)
    n_ids = jc.model.num_classes * jc.model.num_relations \
        * jc.model.num_classes
    art = _Artifacts(n_ids)
    logs = {}
    cwd = os.getcwd()
    os.chdir(ROOT)          # the GloVe table path is relative to the root
    try:
        for name, lib, cfg in (("jax", jax_pnp, jc), ("torch", pnp_engine,
                                                       tc)):
            for run_mode in ("train", "train_cs"):
                c = cfg.replace(training=dataclasses.replace(
                    cfg.training, run_mode=run_mode,
                    checkpoint_path=str(tmp_path / name)))
                kw = {} if name == "jax" else {"device": "cpu"}
                lines = logs.setdefault(name, [])
                lib.fit_predictor(c, "motifs", lambda e: iter(bs),
                                  lambda e: iter(bs[:1]), artifacts=art,
                                  steps_per_epoch=2, log_fn=lines.append,
                                  **kw)
    finally:
        os.chdir(cwd)
    want = sorted(os.listdir(tmp_path / "jax"))
    assert want == ["PnpMotifsModel_CS_motif0", "PnpMotifsModel_motif0"]
    assert sorted(os.listdir(tmp_path / "torch")) == [n + ".pt"
                                                      for n in want]
    assert [_shape(x) for x in logs["torch"]] == \
        [_shape(x) for x in logs["jax"]]
    assert any("resumed baseline weights" in x for x in logs["torch"])
    # without tables train_cs refuses, as in JAX
    c = tc.replace(training=dataclasses.replace(tc.training,
                                                run_mode="train_cs"))
    with pytest.raises(ValueError, match="prepare_cs"):
        pnp_engine.fit_predictor(c, "motifs", lambda e: iter(bs),
                                 device="cpu")


def _cli(cwd, *args):
    return subprocess.run(
        [sys.executable, "-m", "scene_graph_commonsense_torch", "--hierar",
         "--eval_mode", "pc", "--synthetic", "2", "--batch_size", "2",
         "--device", "cpu", *args],
        cwd=cwd, capture_output=True, text=True, timeout=600)


def test_torch_cli_predictor_vctree_train_then_eval_tde(tmp_path):
    yaml_path = tmp_path / "cfg.yaml"
    yaml_path.write_text(json.dumps({
        "training": {"num_epoch": 1, "print_freq": 1, "test_epoch": 0,
                     "checkpoint_path": str(tmp_path / "ckpt"),
                     "result_path": str(tmp_path / "results")},
        "model": {"feature_size": 16, "num_img_feature": 16},
        "data": {"max_objects": 6}}))        # JSON is YAML
    res = _cli(ROOT, "--run_mode", "train", "--predictor", "vctree",
               "--config", str(yaml_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[pnp:vctree] TEST epoch 0" in res.stdout
    assert "loss_structure=" in res.stdout
    assert (tmp_path / "ckpt" / "PnpVctreeModel_motif0.pt").exists()
    res = _cli(ROOT, "--run_mode", "eval", "--predictor", "vctree", "--tde",
               "--config", str(yaml_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Loaded predictor checkpoint" in res.stdout
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(out["recall"]) == 3


@pytest.mark.parametrize("args,msg", [
    (["--run_mode", "eval", "--tde"], "--tde requires --predictor"),
    (["--run_mode", "prepare_cs", "--predictor", "motifs"],
     "--predictor does not support run_mode prepare_cs")])
def test_torch_cli_predictor_refusals(args, msg):
    res = _cli(ROOT, *args)
    assert res.returncode != 0
    assert msg in res.stderr
