"""The port stands alone: no module of scene_graph_commonsense_torch, and not
chip_smoke.py, imports JAX, flax, optax, msgpack or the JAX package; entry points run
on CUDA unless asked for the CPU; chip_smoke.py refuses to run without a card
or without the package beside it."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from scene_graph_commonsense_torch import device as device_lib
from scene_graph_commonsense_torch import config as torch_config
from scene_graph_commonsense_torch.models.relation_head import (
    make_relation_classifier)
from scene_graph_commonsense_torch.train import engine

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
             "scene_graph_commonsense_tpu"}


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_torch_port_imports_nothing_of_jax():
    files = sorted((ROOT / "scene_graph_commonsense_torch").rglob("*.py"))
    # chip_smoke.py, and the worker that the data-parallel tests spawn
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_mesh_worker.py"]
    assert len(files) > 15
    scanned = {p.relative_to(ROOT).as_posix() for p in files}
    for module in ("bench.py", "train/engine.py", "train/losses.py",
                   "train/loop.py", "utils/logging.py", "utils/profiling.py",
                   "data/pipeline.py", "ops/pair_pool.py",
                   "data/dataset.py", "data/native/__init__.py",
                   "data/depth.py", "tools/make_mini_vg.py",
                   "tools/precompute_features.py", "tools/sgrecords.py",
                   "commonsense/cache.py", "commonsense/client.py",
                   "commonsense/pipeline.py", "ops/boxes.py",
                   "data/oiv6.py", "data/label_transfer.py",
                   "models/context.py", "models/predictors.py",
                   "train/pnp_engine.py", "plugandplay.py",
                   "tools/make_mini_oiv6.py", "parallel/mesh.py",
                   "parallel/launch.py", "eval/visualization.py",
                   "tools/dryrun_multichip.py", "eval/engines.py",
                   "inference.py", "__main__.py"):
        assert f"scene_graph_commonsense_torch/{module}" in scanned, module
    for path in files:
        bad = _imported_roots(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
        assert "importlib" not in _imported_roots(path), path


def test_torch_device_resolver_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            device_lib.resolve_device(dev)
    assert device_lib.resolve_device("cpu") == torch.device("cpu")
    cfg = torch_config.derive(
        "vg", model={"feature_size": 8, "hidden_dim": 4,
                     "num_img_feature": 4}, data={"max_objects": 3},
        training={"batch_size": 1})
    with pytest.raises(RuntimeError):
        make_relation_classifier(cfg)
    model = make_relation_classifier(cfg, device="cpu")
    with pytest.raises(RuntimeError):
        engine.make_eval_step(model, cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device_lib.resolve_device() == torch.device("cuda")


def test_torch_eval_step_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    cfg = torch_config.derive(
        "vg", model={"feature_size": 8, "hidden_dim": 4,
                     "num_img_feature": 4}, data={"max_objects": 3},
        training={"batch_size": 1})
    engine.make_eval_step(make_relation_classifier(cfg, device="cpu"), cfg,
                          device="cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def _run_chip_smoke(cwd, env=None):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _assert_refused(res):
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_torch_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run")
    _assert_refused(_run_chip_smoke(ROOT))


def test_torch_chip_smoke_refuses_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = _run_chip_smoke(tmp_path, env)
    _assert_refused(res)
    assert "scene_graph_commonsense_torch" in res.stderr
