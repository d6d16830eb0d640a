"""The port's plug-and-play engine (train/pnp_engine.py) against the JAX
package's on the CPU: pooling, the train step of every family (relation
NLL, connectivity, VCTree's structure loss, the object CE outside predcls,
the commonsense penalty), the eval step with and without TDE, the GloVe
init (fit_predictor and the CLI: tests/test_torch_pnp_cli.py).

Tolerances (float64, JAX with x64 on; one set of seeded flax weights in
both packages through weights.predictor_from_flax): every parameter after
each of 3 train steps within 1e-8; the float64 losses (relation,
commonsense) within 1e-8 in predcls mode.  The connectivity, structure and
object losses are computed in float32 by the JAX package (its casts of
those logits and scores), where XLA's float32 exp and log differ from
torch's in the last bit: they, and in sgcls mode everything downstream of
the float32 soft labels, are held at 1e-6.  Recall dicts with and without
TDE equal; pooling within 1e-12."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tiny import batches, cfgs, one_thread  # noqa: F401

from scene_graph_commonsense_tpu.models.predictors import (
    HierarchicalPredictor as JaxPredictor)
from scene_graph_commonsense_tpu.train import engine as jax_engine
from scene_graph_commonsense_tpu.train import pnp_engine as jax_pnp
from scene_graph_commonsense_torch.models import weights
from scene_graph_commonsense_torch.models.predictors import (
    HierarchicalPredictor)
from scene_graph_commonsense_torch.parallel import mesh as mesh_lib
from scene_graph_commonsense_torch.train import engine, pnp_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("motifs", "transformer", "vctree", "vtranse")
H, PD = 8, 16
# losses the JAX package computes in float32
F32_METRICS = ("loss", "loss_connectivity", "loss_structure")


def _predictors(jc, family, mode, seed=1):
    """The JAX predictor (float64) with seeded, perturbed float64 params,
    and the port's holding the same weights."""
    m = jc.model
    n, d, s = jc.data.max_objects, m.num_img_feature, m.feature_size
    kw = dict(family=family, hidden_dim=H, pair_dim=PD,
              num_classes=m.num_classes, mode=mode, box_scale=float(s))
    jm = JaxPredictor(dtype=jnp.float64, **kw)
    z = jnp.zeros
    with jax.enable_x64():
        params = jm.init(
            jax.random.PRNGKey(0), z((1, n, d)), z((1, n, 4)),
            z((1, n), jnp.int32), jnp.ones((1, n), bool),
            z((1, n * n), jnp.int32), z((1, n * n), jnp.int32),
            jnp.ones((1, n * n), bool), z((1, n * n, d)))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x, np.float64) + 0.05 * rng.randn(*x.shape),
        params)
    tm = HierarchicalPredictor(feature_dim=d, union_dim=d,
                               dtype=torch.float64, **kw).double()
    tm.load_state_dict(weights.predictor_from_flax(params))
    return jm, params, tm


def _jax_batch(b):
    return {k: jnp.asarray(b[k]) for k in pnp_engine.MODEL_KEYS}


def test_torch_pnp_pooling_matches_jax():
    b = batches(1, with_aug=False)[0]
    bs, n = b["cats"].shape
    with jax.enable_x64():
        jsub, jobj = jax_pnp.grid_pairs(bs, n)
        want_roi = jax_pnp.roi_pool_features(
            b["features"], b["boxes"], b["valid"])
        want_union = jax_pnp.union_pool_features(
            b["features"], b["boxes"], jsub, jobj)
    t = {k: torch.as_tensor(v) for k, v in b.items()}
    sub, obj = pnp_engine.grid_pairs(bs, n)
    np.testing.assert_array_equal(sub.numpy(), np.asarray(jsub))
    np.testing.assert_array_equal(obj.numpy(), np.asarray(jobj))
    np.testing.assert_allclose(
        pnp_engine.roi_pool_features(t["features"], t["boxes"],
                                     t["valid"]).numpy(),
        np.asarray(want_roi), atol=1e-12, rtol=0)
    np.testing.assert_allclose(
        pnp_engine.union_pool_features(t["features"], t["boxes"], sub,
                                       obj).numpy(),
        np.asarray(want_union), atol=1e-12, rtol=0)


@pytest.mark.parametrize("mode", ["predcls", "sgcls"])
@pytest.mark.parametrize("family", FAMILIES)
def test_torch_pnp_train_and_eval_match_jax(family, mode):
    """3 train steps (with the commonsense penalty) from one set of
    weights, then PredCLS eval of the trained weights with and without
    TDE, in both packages."""
    jc, tc = cfgs(training={"learning_rate": 1e-2, "grad_clip_norm": 5.0})
    jm, params, tm = _predictors(jc, family, mode)
    bs = batches(3, with_aug=False)
    rng = np.random.RandomState(0)
    n_ids = jc.model.num_classes * jc.model.num_relations \
        * jc.model.num_classes
    cs = (rng.rand(n_ids) < 0.3, rng.rand(n_ids) < 0.3)
    tcfg = jc.training
    opt_kw = dict(momentum=tcfg.momentum, weight_decay=tcfg.weight_decay,
                  grad_clip_norm=tcfg.grad_clip_norm)
    jopt = jax_engine.make_optimizer(tcfg.learning_rate, **opt_kw)
    topt = engine.make_optimizer(tcfg.learning_rate, **opt_kw)
    tstep = pnp_engine.make_pnp_train_step(tm, tc, topt, cs_tables=cs,
                                           device="cpu")
    tstate = engine.init_train_state(tm, topt)
    soft = mode != "predcls" and family != "vctree"
    with jax.enable_x64():
        jstep = jax_pnp.make_pnp_train_step(
            jm, jc, jopt, cs_tables=tuple(map(jnp.asarray, cs)))
        jstate = jax_engine.TrainState(
            jax.tree.map(jnp.asarray, params), jopt.init(params),
            jnp.int32(0))
        for b in bs:
            jstate, jmet = jstep(jstate, _jax_batch(b), jax.random.PRNGKey(0))
            tstate, tmet = tstep(tstate, b)
            assert set(tmet) == set(jmet)
            assert ("loss_structure" in tmet) == (family == "vctree")
            for k, w in jmet.items():
                tol = 1e-6 if soft or k in F32_METRICS else 1e-8
                np.testing.assert_allclose(float(tmet[k]), float(w),
                                           atol=tol, rtol=0, err_msg=k)
            got = weights.predictor_to_flax(tm.state_dict())
            for a, w in zip(jax.tree.leaves(got),
                            jax.tree.leaves(jstate.params)):
                np.testing.assert_allclose(a, np.asarray(w), atol=1e-8,
                                           rtol=0)
        assert float(tmet["loss_commonsense"]) > 0
        for tde in (False, True):
            want = jax_pnp.run_eval_pc_predictor(
                jc, jm, jstate.params, [dict(b) for b in bs], tde=tde)
            res = pnp_engine.run_eval_pc_predictor(
                tc, tm, [dict(b) for b in bs], tde=tde, device="cpu")
            for k in ("recall", "mean_recall", "recall_zs",
                      "mean_recall_zs"):
                np.testing.assert_array_equal(res[k], want[k], err_msg=k)


@pytest.mark.parametrize("tde", [False, True])
def test_torch_pnp_eval_step_outputs_match_jax(tde):
    """The eval step's outputs, TDE's factual-minus-counterfactual scores
    included (the counterfactual mean is global over the batch)."""
    jc, tc = cfgs()
    jm, params, tm = _predictors(jc, "motifs", "predcls", seed=2)
    b = batches(1, with_aug=False, seed=5)[0]
    with jax.enable_x64():
        want = jax_pnp.make_pnp_eval_step(jm, jc, tde=tde)(
            jax.tree.map(jnp.asarray, params), _jax_batch(b))
    got = pnp_engine.make_pnp_eval_step(tm, tc, tde=tde, device="cpu")(b)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[k].numpy(), w, atol=1e-8,
                                       rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_torch_pnp_apply_glove_init_matches_jax(tmp_path):
    """The label tables take the GloVe rows the JAX package gives them, the
    fallback to the committed .synthetic.npz and the log line when neither
    file exists."""
    jc, tc = cfgs()
    jm, params, tm = _predictors(jc, "vctree", "predcls")
    logs_j, logs_t = [], []
    cwd = os.getcwd()
    os.chdir(ROOT)         # the table path is relative to the working dir
    try:
        with jax.enable_x64():
            want = jax_pnp.apply_glove_init(jc, params,
                                            log_fn=logs_j.append)
        got = pnp_engine.apply_glove_init(tc, tm.state_dict(),
                                          log_fn=logs_t.append)
    finally:
        os.chdir(cwd)
    np.testing.assert_array_equal(
        got["context.label_embed.weight"].numpy(),
        np.asarray(want["params"]["context"]["label_embed"]["embedding"]))
    assert logs_t == logs_j and "synthetic" in logs_t[0]
    missing = str(tmp_path / "none.npz")
    jc2 = jc.replace(model=dataclasses.replace(jc.model,
                                               glove_embeddings=missing))
    tc2 = tc.replace(model=dataclasses.replace(tc.model,
                                               glove_embeddings=missing))
    logs_j, logs_t = [], []
    jax_pnp.apply_glove_init(jc2, params, log_fn=logs_j.append)
    sd = tm.state_dict()
    assert pnp_engine.apply_glove_init(tc2, sd, log_fn=logs_t.append) is sd
    assert logs_t == logs_j and "not found" in logs_t[0]


def test_torch_pnp_mesh_is_refused(tmp_path, one_thread):
    """The pnp steps take a mesh (tests/test_torch_mesh_pnp.py): over a
    mesh of one rank (gloo, this process) the train step, with every ratio
    of the loss over an all-reduced denominator (VCTree's structure term,
    sgcls's object CE, the commonsense penalty), and the eval step with and
    without TDE give the unsharded steps' parameters, metrics and outputs
    bit for bit.  One CPU thread, as two runs of a step are compared to the
    bit."""
    jc, tc = cfgs(training={"learning_rate": 1e-2, "grad_clip_norm": 5.0})
    rng = np.random.RandomState(0)
    n_ids = jc.model.num_classes * jc.model.num_relations \
        * jc.model.num_classes
    cs = (rng.rand(n_ids) < 0.3, rng.rand(n_ids) < 0.3)
    bs = batches(2, with_aug=False, seed=8)
    runs = []
    for use_mesh in (False, True):
        mesh = None
        if use_mesh:
            mesh_lib.init_multihost(f"file://{tmp_path / 'store'}", 1, 0,
                                    device="cpu")
        try:
            if use_mesh:
                mesh = mesh_lib.make_mesh(device="cpu")
            dev = None if mesh else "cpu"
            _, _, tm = _predictors(jc, "vctree", "sgcls")
            opt = engine.make_optimizer(1e-2, grad_clip_norm=5.0)
            state = engine.init_train_state(tm, opt)
            step = pnp_engine.make_pnp_train_step(
                tm, tc, opt, cs_tables=cs, mesh=mesh, device=dev)
            mets = []
            for b in bs:
                state, met = step(state, b)
                mets.append({k: float(v) for k, v in met.items()})
            outs = [{k: v.clone() for k, v in pnp_engine.make_pnp_eval_step(
                tm, tc, tde=tde, mesh=mesh, device=dev)(bs[0]).items()}
                for tde in (False, True)]
            runs.append((dict(tm.state_dict()), mets, outs))
        finally:
            if use_mesh:
                torch.distributed.destroy_process_group()
    (sd0, m0, o0), (sd1, m1, o1) = runs
    assert m0 == m1 and "loss_structure" in m0[0]
    assert m0[0]["loss_commonsense"] > 0
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    for a, b in zip(o0, o1):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
