"""The port's visualization dump (eval/visualization.py), run_eval_pc's
on_batch hook and the CLI's training.save_vis_results against the JAX
package's, on the CPU.

Tolerances: the JSON records equal (the same edges, ids, confidences and
image-space boxes) on the same Candidates / Targets; the hook's arguments
in float64 (JAX with x64 on) within 1e-8, integers and targets equal."""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, "tests")
from test_torch_tiny import (  # noqa: E402
    batches, cfgs, flax_params, one_thread, torch_model)

from scene_graph_commonsense_tpu.eval import engines as jax_engines  # noqa
from scene_graph_commonsense_tpu.eval import recall as jax_recall  # noqa
from scene_graph_commonsense_tpu.eval import (  # noqa: E402
    visualization as jax_vis)
from scene_graph_commonsense_tpu.models.relation_head import (  # noqa: E402
    make_relation_classifier as make_jax_classifier)
from scene_graph_commonsense_torch import __main__ as cli  # noqa: E402
from scene_graph_commonsense_torch.data.artifacts import (  # noqa: E402
    load_vg_artifacts)
from scene_graph_commonsense_torch.eval import engines  # noqa: E402
from scene_graph_commonsense_torch.eval import recall  # noqa: E402
from scene_graph_commonsense_torch.eval import visualization  # noqa: E402
from scene_graph_commonsense_torch.models.relation_head import (  # noqa
    make_relation_classifier)

ARTIFACTS_DIR = "datasets/artifacts"


def _random_cand_tgt(rng, n_img=3, n_cand=40, n_tgt=9):
    box = lambda n: np.sort(rng.integers(0, 32, (n, 4)), axis=1)  # noqa
    cand = dict(img=rng.integers(0, n_img, n_cand),
                conf=np.round(rng.normal(size=n_cand), 6),
                rel=rng.integers(0, 50, n_cand),
                sub_cat=rng.integers(0, 150, n_cand),
                obj_cat=rng.integers(0, 150, n_cand),
                sub_box=box(n_cand), obj_box=box(n_cand))
    cand["conf"][:4] = cand["conf"][4]          # ties keep their order
    tgt = dict(img=rng.integers(0, n_img, n_tgt),
               rel=np.where(rng.random(n_tgt) < 0.2, -1,
                            rng.integers(0, 50, n_tgt)),
               sub_cat=rng.integers(0, 150, n_tgt),
               obj_cat=rng.integers(0, 150, n_tgt),
               sub_box=box(n_tgt), obj_box=box(n_tgt))
    return cand, tgt


def _as_jax(cand, tgt):
    return (jax_recall.Candidates(**dataclasses.asdict(cand)),
            jax_recall.Targets(**dataclasses.asdict(tgt)))


@pytest.mark.parametrize("top_k,sizes", [(20, (600, 800)), (5, (32, 32))])
def test_torch_visualization_records_match_jax(tmp_path, top_k, sizes):
    """visualization_record per image and save_visualization_results'
    file: the same JSON as the JAX functions write, on non-square image
    sizes (x scales by width, y by height) and with image paths."""
    rng = np.random.default_rng(top_k)
    c, t = _random_cand_tgt(rng)
    cand, tgt = recall.Candidates(**c), recall.Targets(**t)
    jcand, jtgt = _as_jax(cand, tgt)
    h, w = sizes
    for image in range(3):
        got = visualization.visualization_record(
            cand, tgt, image, top_k, 32, h, w, image_path=f"im{image}.jpg")
        want = jax_vis.visualization_record(
            jcand, jtgt, image, top_k, 32, h, w, image_path=f"im{image}.jpg")
        assert got == want
        assert len(got["predicted_graph"]) == min(
            top_k, int((c["img"] == image).sum()))
    heights, widths = [h, w, h], [w, h, w]
    paths = ["a.jpg", "b.jpg", "c.jpg"]
    got = visualization.save_visualization_results(
        str(tmp_path / "torch"), 7, cand, tgt, heights, widths, paths,
        top_k=top_k)
    want = jax_vis.save_visualization_results(
        str(tmp_path / "jax"), 7, jcand, jtgt, heights, widths, paths,
        top_k=top_k)
    assert got.endswith("torch/7_vis_results.json")
    with open(got) as f, open(want) as g:
        assert f.read() == g.read()


def test_torch_run_eval_pc_on_batch_matches_jax():
    """run_eval_pc hands on_batch the same (i, out, cand, tgt) per batch as
    the JAX package's, after the batch's accumulation, and returns the
    same recall."""
    jc, tc = cfgs()
    params = flax_params()
    data = batches(2, seed=21, with_aug=False)
    arts = load_vg_artifacts(ARTIFACTS_DIR)
    got, want = [], []
    res = engines.run_eval_pc(
        tc, torch_model(tc, params), data, artifacts=arts, device="cpu",
        on_batch=lambda *a: got.append(a))
    with jax.enable_x64():
        from scene_graph_commonsense_tpu.data.artifacts import (
            load_vg_artifacts as jax_load_artifacts)
        jres = jax_engines.run_eval_pc(
            jc, make_jax_classifier(jc), jax.tree.map(jnp.asarray, params),
            data, artifacts=jax_load_artifacts(ARTIFACTS_DIR),
            on_batch=lambda *a: want.append(a))
    assert len(got) == len(want) == 2
    for (i, out, cand, tgt), (wi, wout, wcand, wtgt) in zip(got, want):
        assert i == wi
        assert out.keys() == wout.keys()
        for k, w in wout.items():
            np.testing.assert_allclose(out[k], w, atol=1e-8, rtol=0,
                                       err_msg=k)
        for f in dataclasses.fields(wcand):
            w = getattr(wcand, f.name)
            if w is None:
                assert getattr(cand, f.name) is None, f.name
            else:
                np.testing.assert_allclose(getattr(cand, f.name), w,
                                           atol=1e-8, rtol=0,
                                           err_msg=f.name)
        for f in dataclasses.fields(wtgt):
            np.testing.assert_array_equal(getattr(tgt, f.name),
                                          getattr(wtgt, f.name),
                                          err_msg=f.name)
    np.testing.assert_allclose(res["recall"], jres["recall"], atol=1e-12)


def test_torch_cli_save_vis_results_matches_jax(tmp_path, monkeypatch,
                                               one_thread):
    """The CLI's PredCLS eval with training.save_vis_results writes
    <result_path>/visualization/<i>_vis_results.json for every test batch,
    the files the JAX function writes for the same candidates (main.py's
    on_batch: square image_size, the model's feature size); with the knob
    off it writes none.  The candidates come from a second run of the same
    seeded model (on one CPU thread, so both runs are alike to the bit)."""
    model_cfg = {"feature_size": 16, "hidden_dim": 8, "num_img_feature": 16,
                 "compute_dtype": "float32"}
    for on in (False, True):
        res_dir = tmp_path / f"res_{on}"
        cfg_path = tmp_path / f"tiny_{on}.yaml"
        cfg_path.write_text(json.dumps({
            "model": model_cfg, "data": {"max_objects": 6},
            "training": {"batch_size": 2, "save_vis_results": on,
                         "checkpoint_path": str(tmp_path / "ck"),
                         "result_path": str(res_dir)}}))
        monkeypatch.setattr(sys, "argv", [
            "x", "--run_mode", "eval", "--eval_mode", "pc", "--hierar",
            "--synthetic", "8", "--config", str(cfg_path), "--device",
            "cpu"])
        cli.main()
        assert (res_dir / "visualization").exists() == on
    vis_dir = res_dir / "visualization"
    assert sorted(p.name for p in vis_dir.iterdir()) == [
        "0_vis_results.json", "1_vis_results.json"]
    # the same candidates: the CLI's seeded model over its test batches
    cfg = cli.build_cfg(cli.parse_args())
    model = make_relation_classifier(cfg, device="cpu")
    cands = []
    engines.run_eval_pc(
        cfg, model, cli.synthetic_batches(cfg, 2, seed=100),
        artifacts=load_vg_artifacts(ARTIFACTS_DIR), device="cpu",
        on_batch=lambda i, out, cand, tgt: cands.append((i, cand, tgt)))
    s = cfg.model.image_size
    for i, cand, tgt in cands:
        jcand, jtgt = _as_jax(cand, tgt)
        path = jax_vis.save_visualization_results(
            str(tmp_path / "jax"), i, jcand, jtgt, heights=[s] * 2,
            widths=[s] * 2, feature_size=cfg.model.feature_size)
        with open(path) as f:
            want = f.read()
        assert (vis_dir / f"{i}_vis_results.json").read_text() == want
        assert json.loads(want)[0]["predicted_graph"]
