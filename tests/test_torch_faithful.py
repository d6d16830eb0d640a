"""The port's reference-faithful training dynamics (train/losses.
faithful_losses, train/engine._scatter_grid, the faithful branch of
make_train_step) against the JAX package's on the CPU.

Tolerances: float64 (JAX with x64 on) atol 1e-8 on the losses, the metrics
and every parameter after each of 3 train steps; integer metrics equal;
the grid scatter and its gradient 1e-12.  Dropout is off in the step
parity runs (the two packages draw different masks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tiny import (assert_metrics_close, assert_trees_close,
                             batches, cfgs, flax_params, torch_model,
                             torch_params)

from scene_graph_commonsense_tpu.constants import (
    class_weights as jax_class_weights)
from scene_graph_commonsense_tpu.models.relation_head import (
    make_relation_classifier)
from scene_graph_commonsense_tpu.ops import pairs as jax_pairs
from scene_graph_commonsense_tpu.train import engine as jax_engine
from scene_graph_commonsense_tpu.train import losses as jax_losses
from scene_graph_commonsense_torch.constants import class_weights
from scene_graph_commonsense_torch.ops import pairs
from scene_graph_commonsense_torch.train import engine
from scene_graph_commonsense_torch.train import losses

NUM_TRIPLETS = 150 * 50 * 150


def _grids(rng, hier, b=4, n=6, r=50):
    """Random inputs of faithful_losses in float64: branch log-probs (or
    logits), super log-probs, connectivity logits, GT targets (-1 mostly),
    validity with varied object counts, categories, cs tables."""
    n_per = np.array([n, n - 1, 3, n])[:b]
    valid = np.arange(n)[None] < n_per[:, None]
    sup = rng.standard_normal((b, n, n, 3))
    sup = sup - np.log(np.exp(sup).sum(-1, keepdims=True))
    rel = rng.standard_normal((b, n, n, r))
    if hier:
        for k, (lo, hi) in enumerate(((0, 15), (15, 26), (26, r))):
            x = rel[..., lo:hi]
            rel[..., lo:hi] = x - np.log(np.exp(x).sum(-1, keepdims=True)) \
                + sup[..., k:k + 1]
    conn = rng.standard_normal((b, n, n)) * 2
    tgt = np.where(rng.random((b, n, n)) < 0.3,
                   rng.integers(0, r, (b, n, n)), -1)
    cats = rng.integers(0, 150, (b, n))
    aligned = rng.random(NUM_TRIPLETS) < 0.5
    violated = rng.random(NUM_TRIPLETS) < 0.5
    return dict(relation=rel, super_relation=sup if hier else None,
                conn_logits=conn, rel_targets=tgt, valid=valid,
                sub_cats=cats, obj_cats=cats), (aligned, violated)


@pytest.mark.parametrize("hier", [True, False])
@pytest.mark.parametrize("with_cs", [False, True])
def test_torch_faithful_losses_match_jax(hier, with_cs):
    """faithful_losses on the same float64 grids: total and every metric
    within 1e-8, integer counts equal."""
    rng = np.random.default_rng(7 + 2 * hier + with_cs)
    grids, tables = _grids(rng, hier)
    jc, tc = cfgs(hierar=hier)
    w = class_weights("vg", faithful=True)
    contrast = np.float32(0.4375)
    with jax.enable_x64():
        _, want = jax_losses.faithful_losses(
            jc.model, jc.training,
            **{k: None if v is None else jnp.asarray(v)
               for k, v in grids.items()},
            class_weights=jnp.asarray(jax_class_weights(
                "vg", faithful=True)),
            cs_tables=tuple(map(jnp.asarray, tables)) if with_cs else None,
            loss_contrast=jnp.float32(contrast))
        want = {k: float(v) for k, v in want.items()}
    total, got = losses.faithful_losses(
        tc.model, tc.training,
        **{k: None if v is None else torch.as_tensor(v)
           for k, v in grids.items()},
        class_weights=torch.as_tensor(w),
        cs_tables=tuple(map(torch.as_tensor, tables)) if with_cs else None,
        loss_contrast=torch.tensor(contrast))
    assert total is got["loss"] and total.dtype == torch.float64
    got = {k: float(v) for k, v in got.items()}
    assert_metrics_close(got, want, 1e-8)
    assert got["loss_relationship"] > 0 and got["loss_connectivity"] > 0
    assert (got["loss_commonsense"] > 0) == with_cs
    # two of the four images hold the batch-max object count
    assert got["lr_scale"] == pytest.approx(np.sqrt(0.5), abs=1e-15)


def test_torch_scatter_grid_matches_jax_with_gradient():
    """_scatter_grid of (P, R) values packed at a capacity with padding
    slots: the grid and the gradient of a weighted sum of it equal JAX's;
    padding adds nothing (cell (0, 0, 0) stays 0)."""
    rng = np.random.default_rng(11)
    b, n, r, cap = 3, 5, 7, 64
    valid = np.arange(n)[None] < np.array([5, 2, 4])[:, None]
    vals = rng.standard_normal((cap, r))
    wgrid = rng.standard_normal((b, n, n, r))
    with jax.enable_x64():
        jp = jax_pairs.pack_pairs(
            jax_pairs.pair_validity(jnp.asarray(valid)), cap)

        def jf(v):
            return jax_engine._scatter_grid(v, jp, b, n)

        want = np.asarray(jf(jnp.asarray(vals)))
        want_g = np.asarray(jax.grad(
            lambda v: (jf(v) * jnp.asarray(wgrid)).sum())(jnp.asarray(vals)))
    tp = pairs.pack_pairs(pairs.pair_validity(torch.as_tensor(valid)), cap)
    assert int(tp.count) < cap                    # padding slots present
    v = torch.as_tensor(vals).requires_grad_()
    grid = engine._scatter_grid(v, tp, b, n)
    (grid * torch.as_tensor(wgrid)).sum().backward()
    np.testing.assert_allclose(grid.detach().numpy(), want, atol=1e-12,
                               rtol=0)
    np.testing.assert_allclose(v.grad.numpy(), want_g, atol=1e-12, rtol=0)
    assert not grid[0, 0, 0].any()
    # a 1-D value per pair (the connectivity logits) keeps the grid shape
    assert engine._scatter_grid(v[:, 0], tp, b, n).shape == (b, n, n)


def _faithful_cfgs(hier, run_mode="train"):
    # pair_capacity 40 is below the faithful capacity B * N * (N - 1) = 120:
    # the faithful step must pack every valid pair whatever it says, and
    # size the augmented buffer from 120 (// 4 = 30), not from 40
    return cfgs(hierar=hier, training={
        "faithful_dynamics": True, "pair_capacity": 40,
        "grad_clip_norm": 0.05, "run_mode": run_mode})


def test_torch_faithful_capacities_follow_jax():
    _, tc = _faithful_cfgs(True)
    assert tc.pair_capacity == 40
    assert engine.train_pair_capacity(tc) == 4 * 6 * 5
    assert engine.aug_pair_capacity(tc) == 30
    explicit = tc.replace(training=tc.training.__class__(
        **{**tc.training.__dict__, "aug_pair_capacity": 17}))
    assert engine.aug_pair_capacity(explicit) == 17
    _, plain = cfgs(training={"pair_capacity": 40})
    assert engine.train_pair_capacity(plain) == 40
    assert engine.aug_pair_capacity(plain) == 10


@pytest.mark.parametrize("hier,with_cs", [(True, True), (False, False)])
def test_torch_faithful_train_steps_match_jax_f64(hier, with_cs):
    """3 faithful train steps (augmented view, clipping that fires, the
    dynamic learning rate): every parameter and metric after each step
    within 1e-8 of the JAX step's."""
    jc, tc = _faithful_cfgs(hier, "train_cs" if with_cs else "train")
    params = flax_params(hierar=hier)
    data = batches(3, seed=5)
    rng = np.random.default_rng(3)
    tables = None
    if with_cs:
        tables = (rng.random(NUM_TRIPLETS) < 0.5,
                  rng.random(NUM_TRIPLETS) < 0.5)
    w = jax_class_weights("vg", faithful=True)
    with jax.enable_x64():
        jparams = jax.tree.map(jnp.asarray, params)
        opt = jax_engine.make_optimizer(1e-3, grad_clip_norm=0.05)
        state = jax_engine.TrainState(jparams, opt.init(jparams),
                                      jnp.int32(0))
        step = jax_engine.make_train_step(
            make_relation_classifier(jc), jc, opt, w, cs_tables=tables,
            donate=False)
        want = []
        for bt in data:
            state, met = step(state, {k: jnp.asarray(v)
                                      for k, v in bt.items()},
                              jax.random.PRNGKey(0))
            want.append((jax.tree.map(np.array, state.params)["params"],
                         {k: float(v) for k, v in met.items()}))
    model = torch_model(tc, params)
    topt = engine.make_optimizer(1e-3, grad_clip_norm=0.05)
    tstate = engine.init_train_state(model, topt)
    tstep = engine.make_train_step(model, tc, topt,
                                   class_weights("vg", faithful=True),
                                   cs_tables=tables, device="cpu")
    scales = []
    for bt, (w_params, w_met) in zip(data, want):
        tstate, met = tstep(tstate, bt)
        got = {k: float(v) for k, v in met.items()}
        assert_trees_close(torch_params(model), w_params, 1e-8)
        assert_metrics_close(got, w_met, 1e-8)
        assert got["loss_contrast"] > 0 and got["num_connected"] > 0
        assert got["aug_pair_overflow"] == 0
        assert (got["loss_commonsense"] > 0) == with_cs
        scales.append(got["lr_scale"])
    assert all(0 < s <= 1 for s in scales) and min(scales) < 1
