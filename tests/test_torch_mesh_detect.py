"""The port's data-parallel detection entry points (eval/engines.py
make_detr_detect_fn(mesh=), run_eval_sgc(mesh=), run_eval_sgd(mesh=),
inference.SceneGraphPredictor(mesh=), the CLI's --eval_mode sgd under two
processes) against the JAX package's on a 2-device data mesh, on the CPU.

World size 2 is one gloo group of two processes (tests/torch_mesh_worker.py,
rendezvous through a file store under the test's temporary directory),
started once for the module; the JAX side runs here on 2 of conftest's 8
host devices (make_mesh(data=2)), on the same weights and numpy batches.
The detector is DETR at full width and reduced depth (ResNet blocks
(1, 1, 1, 1), 1 encoder and 2 decoder layers; tests/torch_detr.py's
hub-named replica through the JAX converter) on 64^2 canvases, half of
every other one padded; the relation head is tests/test_engine.py's
tiny_cfg.

Tolerances, float64 (JAX with x64 on): the gathered detections within
1e-8 of JAX's sharded detector (the JAX package holds its own sharded
detector to 1e-4 of its single-device one, tests/test_detr.py), their
integer and boolean fields equal and of the same dtype; the SGCLS / SGDET
result dicts (R@k, mR@k, zsR@k) equal; the predictor's graphs the same
edges with confidences within 1e-8."""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from test_torch_cli_real import DETR_MODEL  # noqa: E402
from test_torch_dataset import N_MAX, make_vg  # noqa: E402
from test_torch_engines_detect import _detections  # noqa: E402
from test_torch_eval import _assert_results_equal  # noqa: E402
from test_torch_tiny import batches, cfgs, flax_params  # noqa: E402
from torch_detr import TorchDETR, randomize_bn_stats  # noqa: E402

from scene_graph_commonsense_tpu.data.artifacts import (  # noqa: E402
    load_vg_artifacts as jax_load_artifacts)
from scene_graph_commonsense_tpu.eval import engines as jax_engines  # noqa
from scene_graph_commonsense_tpu.inference import (  # noqa: E402
    SceneGraphPredictor as JaxPredictor)
from scene_graph_commonsense_tpu.models import detr as jdetr  # noqa: E402
from scene_graph_commonsense_tpu.models.relation_head import (  # noqa: E402
    make_relation_classifier as make_jax_classifier)
from scene_graph_commonsense_tpu.models.weights import (  # noqa: E402
    convert_detr_state_dict)
from scene_graph_commonsense_tpu.parallel import mesh as jax_mesh  # noqa
from scene_graph_commonsense_torch.data.synthetic import (  # noqa: E402
    synthetic_batch)
from scene_graph_commonsense_torch.inference import (  # noqa: E402
    SceneGraphPredictor)
from scene_graph_commonsense_torch.models import weights  # noqa: E402
from scene_graph_commonsense_torch.models.relation_head import (  # noqa
    make_relation_classifier)
from scene_graph_commonsense_torch.parallel import mesh as mesh_lib  # noqa
from scene_graph_commonsense_torch.parallel.launch import (  # noqa: E402
    run_processes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS_DIR = "datasets/artifacts"
WORLD = 2
BLOCKS, N_ENC, N_DEC = (1, 1, 1, 1), 1, 2
DETR = {"detr_blocks": BLOCKS, "detr_enc_layers": N_ENC,
        "detr_dec_layers": N_DEC, "fused_backbone": "off",
        "flash_encoder": "off"}
TOP_K = 10
INT_FIELDS = ("cats", "valid")


def _canvases(rng, b, size=64):
    """Detection views: standard-normal pixels, the right half of every
    other canvas padded."""
    mask = np.ones((b, size, size), bool)
    mask[1::2, :, size // 2:] = False
    return {"image_nonsq": rng.standard_normal((b, size, size, 3)),
            "pixel_mask": mask}


def _flax_detr():
    torch.manual_seed(0)
    hub = TorchDETR(blocks=BLOCKS, n_enc=N_ENC, n_dec=N_DEC)
    randomize_bn_stats(hub)
    return convert_detr_state_dict(
        {k: v.double().numpy() for k, v in hub.state_dict().items()},
        num_encoder_layers=N_ENC, num_decoder_layers=N_DEC, blocks=BLOCKS)


def _with_top2(cfg):
    return cfg.replace(training=dataclasses.replace(
        cfg.training, sgcls_top2_duplicates=True))


def _cli_yaml(root, data):
    path = root / "sgd.yaml"
    path.write_text(json.dumps({
        "model": {**DETR_MODEL, "detr_blocks": [1, 1, 1, 1]},
        "data": {**data, "max_objects": N_MAX, "nonsq_min_side": 128,
                 "nonsq_canvas": 256},
        "training": {"batch_size": 2, "test_epoch": 0,
                     "checkpoint_path": str(root / "ck"),
                     "result_path": str(root / "res")}}))
    return str(path)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every world-size-2 scenario in one gloo group of two processes; the
    inputs and the results of each."""
    work = tmp_path_factory.mktemp("mesh_detect")
    jc, tc = cfgs(model=DETR)
    rng = np.random.default_rng(21)
    rel_params = flax_params()
    detr_params = _flax_detr()
    sg = []
    for b in batches(2, seed=22, with_aug=False):
        sg.append({**b, **_canvases(rng, len(b["cats"]))})
    dets = [_detections(rng, b, jc.model.num_classes) for b in sg]
    # the predictor from images: a 256^2 request (an 8-cell grid) through
    # a tiny seeded DETR (d_model 16 = the head's channels)
    _, icfg = cfgs(model={"feature_size": 8},
                   training={"batch_size": WORLD})
    image_batch = synthetic_batch(rng, batch_size=WORLD, max_objects=N_MAX,
                                  feature_size=8, num_channels=16,
                                  with_aug=False, dtype=np.float64)
    del image_batch["features"]
    image_batch["image"] = rng.standard_normal((WORLD, 256, 256, 3))
    vg = make_vg(work / "vg", edge_cases=False)
    inputs = {"jc": jc, "rel_params": rel_params,
              "detr_params": detr_params, "sg": sg, "dets": dets,
              "predict": batches(1, seed=24, with_aug=False)[0]}
    sd64 = {k: v.to(torch.float64)
            for k, v in weights.from_flax(rel_params).items()}
    detr_sd = weights.detr_from_flax(detr_params)
    sg_eval = {"kind": "sg_eval", "cfg": tc, "state_dict": "rel",
               "dtype": torch.float64, "batches": sg, "dets": dets}
    spec = {"world": WORLD, "tensors": {"rel": sd64, "detr": detr_sd},
            "scenarios": [
        ("detect", {"kind": "detect", "cfg": tc, "detr_state_dict": "detr",
                    "batches": sg}),
        ("sgd", {**sg_eval, "mode": "sgd"}),
        ("sgc", {**sg_eval, "mode": "sgc"}),
        ("sgc_top2", {**sg_eval, "mode": "sgc", "cfg": _with_top2(tc)}),
        ("sgd_detr", {**sg_eval, "mode": "sgd", "dets": None,
                      "detr_state_dict": "detr"}),
        ("predictor", {"kind": "predictor", "cfg": tc, "state_dict": "rel",
                       "dtype": torch.float64, "batch": inputs["predict"],
                       "top_k": TOP_K, "image_cfg": icfg,
                       "image_state_dict": None,
                       "image_batch": image_batch,
                       "detr_kw": {"d_model": 16, "nhead": 2, "dim_ff": 32,
                                   "num_encoder_layers": 1,
                                   "backbone_blocks": BLOCKS,
                                   "dtype": torch.float64}}),
        ("cli", {"kind": "cli", "argvs": [[
            "--run_mode", "eval", "--eval_mode", "sgd", "--hierar",
            "--config", _cli_yaml(work, vg), "--device", "cpu"]]}),
    ]}
    torch.save(spec, work / "spec.pt")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
    logs = [work / f"rank{r}.log" for r in range(WORLD)]
    codes, _ = run_processes(
        [[sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
          str(work), str(rank)] for rank in range(WORLD)], ROOT, env, logs,
        timeout=600)
    errors = [(work / f"error_rank{r}.txt") for r in range(WORLD)]
    if any(codes):
        pytest.fail("world-2 run failed:\n" + "\n".join(
            e.read_text() for e in errors if e.exists()) + "\n".join(
            log.read_text()[-3000:] for log in logs))
    inputs["results"] = {
        name: [torch.load(work / f"{name}_rank{r}.pt", weights_only=False)
               for r in range(WORLD)]
        for name, _ in spec["scenarios"]}
    return inputs


@pytest.fixture(scope="module")
def jax_detect(world2):
    """JAX's detector over make_mesh(data=2): detect_fn(batch) -> numpy."""
    jc = world2["jc"]
    with jax.enable_x64():
        fn = jax_engines.make_detr_detect_fn(
            jc, jdetr.make_detr(jc), world2["detr_params"],
            mesh=jax_mesh.make_mesh(data=WORLD))

    def detect(batch):
        with jax.enable_x64():
            return jax.tree.map(np.asarray, fn(batch))

    return detect


def _assert_dets_close(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        if k in INT_FIELDS:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, atol=1e-8, rtol=0,
                                       err_msg=k)


def test_torch_mesh_detect_fn_matches_jax(world2, jax_detect):
    """Every field of the detections gathered over 2 ranks, on every rank
    and from a batch sharded ahead alike, against JAX's GSPMD-sharded
    detector; a batch of 3 raises naming the rows the axis does not
    divide, as JAX's device_put refuses it."""
    r0, r1 = world2["results"]["detect"]
    for i, batch in enumerate(world2["sg"]):
        want = jax_detect(batch)
        assert want["valid"].any() and want["cats"].shape == (4, N_MAX)
        for r in (r0, r1):
            _assert_dets_close(r["dets"][i], want)
            _assert_dets_close(r["presharded"][i], want)
    for r in (r0, r1):
        assert "does not divide" in r["odd"] and "3 rows" in r["odd"]
    with pytest.raises(ValueError):
        jax_detect({k: v[:3] for k, v in world2["sg"][0].items()})


def _jax_sg(world2, mode, top2=False, detect=None):
    jc = world2["jc"]
    if top2:
        jc = _with_top2(jc)
    dets = iter(world2["dets"])
    run = jax_engines.run_eval_sgc if mode == "sgc" \
        else jax_engines.run_eval_sgd
    with jax.enable_x64():
        return run(jc, make_jax_classifier(jc),
                   jax.tree.map(jnp.asarray, world2["rel_params"]),
                   [dict(b) for b in world2["sg"]],
                   detect or (lambda b: next(dets)),
                   artifacts=jax_load_artifacts(ARTIFACTS_DIR),
                   mesh=jax_mesh.make_mesh(data=WORLD))


@pytest.mark.parametrize("scenario", ["sgd", "sgc", "sgc_top2", "sgd_detr"])
def test_torch_mesh_sgcls_sgdet_match_jax(world2, jax_detect, scenario):
    """run_eval_sgc / run_eval_sgd over 2 ranks (SGCLS with and without the
    slot-expanded top-2 grid, whose capacity each shard takes its ceiling
    of; SGDET from given detections and from the sharded detector on
    batches sharded ahead) against JAX's mesh runs: the result dicts
    equal, and both ranks return rank 0's."""
    r0, r1 = world2["results"][scenario]
    mode = scenario[:3]
    want = _jax_sg(world2, mode, top2=scenario == "sgc_top2",
                   detect=jax_detect if scenario == "sgd_detr" else None)
    assert want["num_targets"] > 0 and "top3" not in r0
    _assert_results_equal(r0, want)
    _assert_results_equal(r1, want)


def _assert_graphs_close(got, want):
    assert len(got) == len(want)
    for g_img, w_img in zip(got, want):
        assert len(g_img) == len(w_img)
        for g, w in zip(g_img, w_img):
            assert g.keys() == w.keys()
            for k, v in w.items():
                if k == "confidence":
                    np.testing.assert_allclose(g[k], v, atol=1e-8, rtol=0)
                else:
                    assert g[k] == v, k


def test_torch_mesh_predictor_matches_jax(world2):
    """SceneGraphPredictor(mesh=) over 2 ranks: every rank returns JAX's
    mesh predictor's graphs of the whole request; from images each rank
    featurizes only its rows, and the graphs are the unsharded
    predictor's."""
    r0, r1 = world2["results"]["predictor"]
    jc = world2["jc"]
    with jax.enable_x64():
        want = JaxPredictor(
            jc, jax.tree.map(jnp.asarray, world2["rel_params"]),
            mesh=jax_mesh.make_mesh(data=WORLD)).predict(
            dict(world2["predict"]), top_k=TOP_K)
    assert sum(len(g) for g in want) > 0
    for r in (r0, r1):
        _assert_graphs_close(r["graphs"], want)
        assert r["featurized_rows"] == [1]
        assert sum(len(g) for g in r["single_image_graphs"]) > 0
        _assert_graphs_close(r["image_graphs"], r["single_image_graphs"])


def test_torch_predictor_refuses_an_undivided_batch_as_jax():
    """A request of 3 over a 2-rank axis raises JAX's ValueError, before
    any collective."""
    jc, tc = cfgs()
    params = flax_params()
    batch = {k: v[:3] for k, v in batches(1, with_aug=False)[0].items()}
    with jax.enable_x64(), pytest.raises(ValueError) as want:
        JaxPredictor(jc, jax.tree.map(jnp.asarray, params),
                     mesh=jax_mesh.make_mesh(data=WORLD)).predict(batch)
    sd = {k: v.to(torch.float64)
          for k, v in weights.from_flax(params).items()}
    model = make_relation_classifier(tc, device="cpu", state_dict=sd)
    mesh = mesh_lib.Mesh(WORLD, 1, 0, torch.device("cpu"))
    with pytest.raises(ValueError) as got:
        SceneGraphPredictor(tc, model.double(), mesh=mesh).predict(batch)
    assert str(got.value) == str(want.value)
    assert "batch size 3 does not divide the 'data' mesh axis" \
        in str(got.value)


def test_torch_mesh_cli_sgd(world2):
    """--eval_mode sgd on a mini-VG under two processes: the detector and
    the relation head sharded over the ranks, one result line, printed by
    rank 0; rank 1 prints nothing."""
    (r0,), (r1,) = world2["results"]["cli"]
    assert r0["exit"] is None and r1["exit"] is None, (r0, r1)
    assert r1["stdout"] == ""
    lines = r0["stdout"].strip().splitlines()
    res = json.loads(lines[-1])
    assert len(res["recall"]) == 3 and res["num_targets"] > 0
    assert all(0 <= r <= 1 for r in res["recall"]) and "top3" not in res
    assert sum(ln.startswith("{") for ln in lines) == 1
