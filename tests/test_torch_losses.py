"""The port's losses (train/losses.py) against the JAX package's
(train/losses.py) on the same float64 inputs, made with numpy from a seed:
each value and its gradient with respect to every float input within
1e-10."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scene_graph_commonsense_tpu.train import losses as JL
from scene_graph_commonsense_torch.train import losses as TL

ATOL = 1e-10
P, R, NG, NPOS = 40, 50, 15, 11


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64():
        yield


def _check(jax_fn, torch_fn, floats, others=()):
    """Value and gradients of jax_fn(*floats, *others) against torch_fn on
    the same numpy inputs (the gradient of the scalar output with respect
    to each float input)."""
    j_args = [jnp.asarray(x) for x in floats]
    j_other = [jnp.asarray(x) for x in others]
    want, want_g = jax.value_and_grad(
        lambda *f: jax_fn(*f, *j_other), argnums=tuple(range(len(floats))))(
        *j_args)
    t_args = [torch.from_numpy(np.array(x)).requires_grad_() for x in floats]
    got = torch_fn(*t_args, *[torch.from_numpy(np.array(x)) for x in others])
    got.backward()
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL, rtol=0)
    for t, g in zip(t_args, want_g):
        got_g = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(got_g.numpy(), np.asarray(g),
                                   atol=ATOL, rtol=0)
    return float(want)


def _log_probs(rng, n, k):
    x = rng.standard_normal((n, k))
    return x - np.log(np.exp(x).sum(1, keepdims=True))


def _targets(rng, connected_frac=0.4):
    t = rng.integers(0, R, P).astype(np.int32)
    t[rng.random(P) > connected_frac] = -1
    return t


@pytest.mark.parametrize("empty", [False, True])
def test_torch_masked_mean_matches_jax(rng, empty):
    v = rng.standard_normal(P)
    mask = np.zeros(P, bool) if empty else rng.random(P) < 0.5
    val = _check(JL._masked_mean, TL._masked_mean, [v], [mask])
    assert (val == 0.0) == empty


def test_torch_weighted_nll_matches_jax(rng):
    lp = _log_probs(rng, P, 7)
    t = rng.integers(-1, 9, P).astype(np.int32)       # out-of-range clipped
    w = rng.random(7)
    mask = rng.random(P) < 0.6
    _check(lambda lp, w, t, m: JL._weighted_nll(lp, t, w, m),
           lambda lp, w, t, m: TL._weighted_nll(lp, t, w, m),
           [lp, w], [t, mask])


@pytest.mark.parametrize("hierarchical", [True, False])
def test_torch_relation_loss_matches_jax(rng, hierarchical):
    rel = rng.standard_normal((P, R))
    if hierarchical:
        blocks = [(0, NG), (NG, NG + NPOS), (NG + NPOS, R)]
        rel = np.concatenate([_log_probs(rng, P, hi - lo)
                              for lo, hi in blocks], 1)
    sup = _log_probs(rng, P, 3)
    t = _targets(rng)
    connected = (t >= 0) & (rng.random(P) < 0.9)
    w = rng.random(R).astype(np.float32)     # class weights stay float32

    def jfn(rel, sup, t, connected, w):
        return JL.relation_loss(rel, sup if hierarchical else None, t,
                                connected, w, NG, NPOS, hierarchical)

    def tfn(rel, sup, t, connected, w):
        return TL.relation_loss(rel, sup if hierarchical else None, t,
                                connected, w, NG, NPOS, hierarchical)

    assert _check(jfn, tfn, [rel, sup], [t, connected, w]) > 0


def test_torch_connectivity_loss_matches_jax(rng):
    logits = 3 * rng.standard_normal(P)
    logits[:3] = [25.0, -30.0, 0.0]          # softplus tails, sigmoid 0.5
    valid = rng.random(P) < 0.8
    connected = rng.random(P) < 0.3
    lam = 0.7
    _check(lambda x, c, v: JL.connectivity_loss(x, c, v, lam).loss,
           lambda x, c, v: TL.connectivity_loss(x, c, v, lam).loss,
           [logits], [connected, valid])
    want = JL.connectivity_loss(jnp.asarray(logits), jnp.asarray(connected),
                                jnp.asarray(valid), lam)
    got = TL.connectivity_loss(torch.from_numpy(logits),
                               torch.from_numpy(connected),
                               torch.from_numpy(valid), lam)
    for field in ("num_connected", "num_not_connected",
                  "num_connected_pred", "precision_hits", "recall_hits"):
        assert int(getattr(got, field)) == int(getattr(want, field)), field


@pytest.mark.parametrize("hierarchical", [True, False])
def test_torch_commonsense_loss_matches_jax(rng, hierarchical):
    c = 150
    rel = rng.standard_normal((P, R))
    sub = rng.integers(0, c, P).astype(np.int32)
    obj = rng.integers(0, c, P).astype(np.int32)
    valid = rng.random(P) < 0.8
    aligned = rng.random(c * R * c) < 0.5
    violated = rng.random(c * R * c) < 0.2

    def jfn(rel, *rest):
        return JL.commonsense_loss(rel, *rest, NG, NPOS, c, 0.1, 10.0,
                                   hierarchical)

    def tfn(rel, *rest):
        return TL.commonsense_loss(rel, *rest, NG, NPOS, c, 0.1, 10.0,
                                   hierarchical)

    assert _check(jfn, tfn, [rel], [sub, obj, valid, aligned, violated]) > 0


@pytest.mark.parametrize("all_valid", [True, False])
def test_torch_supcon_hierar_loss_matches_jax(rng, all_valid):
    m, d = 12, 16
    feats = rng.standard_normal((m, 2, d)) * 0.3
    labels = rng.integers(0, R, m).astype(np.int32)
    labels[:4] = labels[4]                   # positives exist
    valid = np.ones(m, bool) if all_valid else rng.random(m) < 0.7
    _check(lambda f, lab, v: JL.supcon_hierar_loss(f, lab, v, NG, NPOS),
           lambda f, lab, v: TL.supcon_hierar_loss(f, lab, v, NG, NPOS),
           [feats], [labels, valid])
