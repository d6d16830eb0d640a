"""The port's plug-and-play contexts and predictors (models/context.py,
models/predictors.py, relation_head.BayesianHead, the weight converters)
against the JAX package's on the CPU, in float64 (JAX with x64 on), from
one set of seeded flax weights (weights.predictor_from_flax).

Tolerances: 1e-8 on every float64 output in predcls mode and on VCTree's
in sgcls mode; the two outputs the JAX package casts to float32 (the object
logits and the relatedness logit) equal there.  Motifs, Transformer and
VTransE in sgcls mode re-embed a softmax of the float32 logits, computed in
float32 as the JAX package computes it; XLA's float32 exp and torch's
differ in the last bit for about one value in ten, so what is downstream of
the soft labels is held at 1e-6, float32's resolution at these magnitudes
(the logits themselves stay equal).  Prim's parents and the tree depths are
exact, ties included; the weight round trip is exact.  Weights are loaded
after the module is cast to float64 (loading first would round them to
float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_graph_commonsense_tpu.models import context as jctx
from scene_graph_commonsense_tpu.models.predictors import (
    BiasedBayesHead as JaxBiasedBayesHead,
    FrequencyBias as JaxFrequencyBias,
    HierarchicalPredictor as JaxPredictor)
from scene_graph_commonsense_tpu.models.relation_head import (
    BayesianHead as JaxBayesianHead)
from scene_graph_commonsense_torch.models import context
from scene_graph_commonsense_torch.models import weights
from scene_graph_commonsense_torch.models.predictors import (
    BiasedBayesHead, FrequencyBias, HierarchicalPredictor)
from scene_graph_commonsense_torch.models.relation_head import BayesianHead

B, N, D, C, DU, H, PD = 3, 6, 16, 10, 12, 8, 16
FAMILIES = ("motifs", "transformer", "vctree", "vtranse")
# validity with a padded tail, a non-prefix mask and a full image
VALID = np.array([[1, 1, 1, 1, 0, 0], [1, 0, 1, 1, 0, 1],
                  [1, 1, 1, 1, 1, 1]], bool)


def _inputs(seed=0, valid=VALID):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, N, D)
    xy = rng.rand(B, N, 2) * 24
    wh = rng.rand(B, N, 2) * 10 + 1
    boxes = np.concatenate([xy[..., :1], xy[..., :1] + wh[..., :1],
                            xy[..., 1:], xy[..., 1:] + wh[..., 1:]], -1)
    labels = rng.randint(0, C, (B, N)).astype(np.int32)
    return feats, boxes, labels, valid


def _pairs():
    sub = np.repeat(np.arange(N), N)[None].repeat(B, 0).astype(np.int32)
    obj = np.tile(np.arange(N), N)[None].repeat(B, 0).astype(np.int32)
    mask = (VALID[:, :, None] & VALID[:, None, :]
            & ~np.eye(N, dtype=bool)).reshape(B, N * N)
    union = np.random.RandomState(3).randn(B, N * N, DU)
    return sub, obj, mask, union


def _perturbed(params, seed=1):
    """float64 copies of flax params, every leaf shifted by noise so that
    zero-initialized biases, LayerNorm and the frequency table matter."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float64) + 0.1 * rng.randn(*x.shape),
        params)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _close(got, want, atol, name=""):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), atol=atol, rtol=0, err_msg=name)


def _tol(family, mode):
    return 1e-8 if mode == "predcls" or family == "vctree" else 1e-6


@pytest.mark.parametrize("mode", ["predcls", "sgcls"])
@pytest.mark.parametrize("family", FAMILIES)
def test_torch_context_matches_jax(family, mode):
    feats, boxes, labels, valid = _inputs()
    jcls = {"motifs": jctx.MotifsContext,
            "transformer": jctx.TransformerContext,
            "vctree": jctx.VCTreeContext,
            "vtranse": jctx.VTransEContext}[family]
    jm = jcls(hidden_dim=H, num_classes=C, mode=mode, dtype=jnp.float64)
    with jax.enable_x64():
        params = _perturbed(jm.init(jax.random.PRNGKey(0), feats, boxes,
                                    labels, valid))
        (ctx, logits), inter = jm.apply(params, feats, boxes, labels, valid,
                                        mutable=["intermediates"])
    tm = context.__dict__[jcls.__name__](
        D, hidden_dim=H, num_classes=C, mode=mode, dtype=torch.float64)
    tm.double()
    tm.load_state_dict(weights.predictor_from_flax(params))
    out = tm(*_t(feats, boxes, labels, valid))
    tol = _tol(family, mode)
    _close(out[0], ctx, tol, "context")
    _close(out[1], logits, 0.0, "logits")            # float32 in JAX
    assert out[1].dtype == torch.float32             # the JAX cast
    if family == "vctree":
        _close(out[2], inter["intermediates"]["pair_scores"][0], 1e-8,
               "pair_scores")
    # padded objects carry no context
    assert not out[0][~torch.as_tensor(valid)].any()


def test_torch_masked_bilstm_non_prefix_masks():
    """The masked biLSTM under arbitrary masks equals JAX's, and garbage in
    masked steps changes nothing."""
    rng = np.random.RandomState(4)
    xs = rng.randn(4, 7, 5)
    valid = np.array([[1, 0, 1, 1, 0, 1, 0], [0, 0, 1, 0, 1, 1, 1],
                      [1, 1, 1, 1, 1, 1, 1], [0, 0, 0, 0, 0, 0, 0]], bool)
    jm = jctx.MaskedBiLSTM(3)
    with jax.enable_x64():
        params = _perturbed(jm.init(jax.random.PRNGKey(0), xs, valid))
        want = jm.apply(params, xs, valid)
    tm = context.MaskedBiLSTM(5, 3)
    tm.double()
    tm.load_state_dict(weights.predictor_from_flax(params))
    got = tm(*_t(xs, valid))
    _close(got, want, 1e-8)
    assert not got[~torch.as_tensor(valid)].any()
    poisoned = xs.copy()
    poisoned[~valid] = 1e6
    _close(tm(*_t(poisoned, valid)), got.detach().numpy(), 0.0)


def test_torch_prim_and_depths_exact_with_ties():
    """Prim's arborescence on integer scores full of ties, with invalid
    nodes, an image with one valid node and one with none: the parents and
    depths equal JAX's exactly (ties go to the first flat index)."""
    rng = np.random.RandomState(5)
    b, n = 6, 7
    scores = rng.randint(0, 3, (b, n, n)).astype(np.float64)
    scores[:, np.arange(n), np.arange(n)] = -np.inf
    valid = rng.rand(b, n) < 0.8
    valid[0] = True
    valid[1] = False
    valid[2] = np.arange(n) == 3
    root = np.array([0, 0, 3, 2, 6, 1])
    valid[np.arange(b), root] |= np.arange(b) != 1
    with jax.enable_x64():
        want_p = np.asarray(jax.vmap(jctx.prim_arborescence)(
            scores, valid, root))
        want_d = np.asarray(jax.vmap(jctx.tree_depths)(want_p))
    got_p = context.prim_arborescence(*_t(scores, valid, root))
    got_d = context.tree_depths(got_p)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    assert (got_d.numpy()[0] > 0).sum() == n - 1      # a spanning tree
    np.testing.assert_array_equal(got_p.numpy()[1], np.arange(n))


def test_torch_transformer_padded_rows_attend_uniformly():
    """An image whose objects are all padding: every logit masked, the rows
    attend uniformly (flax's finfo.min fill), the outputs stay finite and
    equal JAX's."""
    valid = VALID.copy()
    valid[0] = False
    feats, boxes, labels, _ = _inputs(6)
    jm = jctx.TransformerContext(hidden_dim=H, num_classes=C,
                                 dtype=jnp.float64)
    with jax.enable_x64():
        params = _perturbed(jm.init(jax.random.PRNGKey(0), feats, boxes,
                                    labels, valid))
        ctx, logits = jm.apply(params, feats, boxes, labels, valid)
    tm = context.TransformerContext(D, hidden_dim=H, num_classes=C,
                                    dtype=torch.float64)
    tm.double()
    tm.load_state_dict(weights.predictor_from_flax(params))
    got_ctx, got_logits = tm(*_t(feats, boxes, labels, valid))
    assert torch.isfinite(got_logits).all()
    _close(got_ctx, ctx, 1e-8)
    _close(got_logits, logits, 0.0)


@pytest.mark.parametrize("mode", ["predcls", "sgcls"])
@pytest.mark.parametrize("family", FAMILIES)
def test_torch_predictor_matches_jax(family, mode):
    """HierarchicalPredictor: the pair composition (VTransE's difference),
    the union branch, pair_norm, pair_mlp, the frequency bias (GT labels in
    predcls, decoded ones in sgcls), the head and rel_conf."""
    feats, boxes, labels, valid = _inputs(7)
    sub, obj, mask, union = _pairs()
    kw = dict(family=family, hidden_dim=H, pair_dim=PD, num_classes=C,
              mode=mode)
    jm = JaxPredictor(dtype=jnp.float64, **kw)
    args = (feats, boxes, labels, valid, sub, obj, mask, union)
    with jax.enable_x64():
        params = _perturbed(jm.init(jax.random.PRNGKey(0), *args))
        want = jm.apply(params, *args)
    tm = HierarchicalPredictor(feature_dim=D, union_dim=DU,
                               dtype=torch.float64, **kw)
    tm.double()
    tm.load_state_dict(weights.predictor_from_flax(params))
    got = tm(*_t(*args))
    tol = _tol(family, mode)
    for k in ("rel1", "rel2", "rel3", "super_relation", "relation"):
        _close(got[k], want[k], tol, k)
    # float32 in the JAX package: equal, unless downstream of the soft
    # labels
    _close(got["obj_logits"], want["obj_logits"], 0.0, "obj_logits")
    _close(got["connectivity"], want["connectivity"],
           0.0 if mode == "predcls" or family == "vctree" else tol,
           "connectivity")
    assert got["connectivity"].dtype == torch.float32
    np.testing.assert_array_equal(got["pair_mask"].numpy(),
                                  np.asarray(want["pair_mask"]))
    # the round trip of the weights is exact
    back = weights.predictor_to_flax(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_torch_predictor_without_union_or_bias():
    feats, boxes, labels, valid = _inputs(8)
    sub, obj, mask, _ = _pairs()
    kw = dict(family="motifs", hidden_dim=H, pair_dim=PD, num_classes=C,
              use_freq_bias=False)
    jm = JaxPredictor(dtype=jnp.float64, **kw)
    args = (feats, boxes, labels, valid, sub, obj, mask)
    with jax.enable_x64():
        params = _perturbed(jm.init(jax.random.PRNGKey(0), *args))
        want = jm.apply(params, *args)
    tm = HierarchicalPredictor(feature_dim=D, dtype=torch.float64, **kw)
    tm.double()
    tm.load_state_dict(weights.predictor_from_flax(params))
    got = tm(*_t(*args))
    _close(got["relation"], want["relation"], 1e-8)


def test_torch_bayesian_head_and_frequency_bias_match_jax():
    rng = np.random.RandomState(9)
    h = rng.randn(20, PD)
    bias = rng.randn(20, 50)
    jm = JaxBayesianHead(T1=0.5, T2=1.5, T3=2.0, dtype=jnp.float64)
    with jax.enable_x64():
        params = _perturbed(jm.init(jax.random.PRNGKey(0), h, bias))
        want_b = jm.apply(params, h, bias)
        want = jm.apply(params, h)
    tm = BayesianHead(PD, T1=0.5, T2=1.5, T3=2.0, dtype=torch.float64)
    tm.double()
    tm.load_state_dict(weights.predictor_from_flax(params))
    for got, w in ((tm(*_t(h, bias)), want_b), (tm(*_t(h)), want)):
        for g, x in zip(got, w):
            _close(g, x, 1e-8)
    sub = np.array([0, 3, -1, C - 1, C + 4], np.int32)
    obj = np.array([1, 4, 2, -7, 0], np.int32)
    jf = JaxFrequencyBias(num_classes=C)
    with jax.enable_x64():
        fp = _perturbed(jf.init(jax.random.PRNGKey(0), sub, obj))
        want = jf.apply(fp, sub, obj)
    tf = FrequencyBias(num_classes=C)
    tf.double()
    tf.load_state_dict(weights.predictor_from_flax(fp))
    _close(tf(*_t(sub, obj)), want, 0.0)


def test_torch_biased_bayes_head_is_the_bayesian_head():
    """models/predictors.BiasedBayesHead is the standalone BayesianHead in
    both packages (one implementation, the frequency bias its optional
    `bias`), so test_torch_bayesian_head_and_frequency_bias_match_jax holds
    it against JAX's."""
    assert JaxBiasedBayesHead is JaxBayesianHead
    assert BiasedBayesHead is BayesianHead
