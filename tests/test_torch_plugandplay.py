"""The port's plug-and-play components (plugandplay.py) and label transfer
(data/label_transfer.py) against the JAX package's on the CPU.

Tolerances: the heads and the loss within 1e-8 in float64 (JAX with x64
on) from one set of flax weights; the post-process's ids, pair indices and
order equal, its scores within 1e-12; the validator's votes and filtered
scores equal on one mock transport; IETrans and NICE give equal relation
grids and counts, and equal rewritten annotations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_graph_commonsense_tpu import plugandplay as jax_pnp
from scene_graph_commonsense_tpu.data import label_transfer as jax_lt
from scene_graph_commonsense_torch import plugandplay
from scene_graph_commonsense_torch.constants import rel_index_map
from scene_graph_commonsense_torch.data import label_transfer as lt
from scene_graph_commonsense_torch.models import weights


def _log_branches(rng, p, sizes=(15, 11, 24)):
    sup = rng.standard_normal((p, 3))
    sup = sup - np.log(np.exp(sup).sum(1, keepdims=True))
    out = []
    for i, n in enumerate(sizes):
        x = rng.standard_normal((p, n))
        out.append(x - np.log(np.exp(x).sum(1, keepdims=True))
                   + sup[:, i:i + 1])
    return out, sup


def test_torch_bayes_heads_match_jax():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((9, 32))
    kw = dict(num_geometric=5, num_possessive=4, num_semantic=3)
    for jcls, tcls in ((jax_pnp.BayesHead, plugandplay.BayesHead),
                       (jax_pnp.BayesHeadProd, plugandplay.BayesHeadProd)):
        jm = jcls(dtype=jnp.float64, **kw)
        with jax.enable_x64():
            params = jax.tree.map(
                lambda x: np.asarray(x, np.float64)
                + 0.1 * rng.standard_normal(x.shape),
                jm.init(jax.random.PRNGKey(0), h))
            want = jm.apply(params, h)
        tm = tcls(32, dtype=torch.float64, **kw).double()
        tm.load_state_dict(weights.predictor_from_flax(params))
        got = tm(torch.as_tensor(h))
        # the Prod head's softmaxes are float32 in both packages
        tol = 1e-8 if jcls is jax_pnp.BayesHead else 1e-6
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       atol=tol, rtol=0)


def test_torch_hierarchical_relation_loss_matches_jax():
    rng = np.random.default_rng(1)
    (r1, r2, r3), sup = _log_branches(rng, 40)
    targets = rng.integers(-1, 50, 40)
    connected = (targets >= 0) & (rng.random(40) < 0.8)
    weights_ = rng.random(50) + 0.5
    for cw in (None, weights_):
        with jax.enable_x64():
            want = jax_pnp.hierarchical_relation_loss(
                r1, r2, r3, sup, targets, connected,
                None if cw is None else jnp.asarray(cw))
        t = [torch.as_tensor(a) for a in (r1, r2, r3, sup, targets,
                                          connected)]
        got = plugandplay.hierarchical_relation_loss(
            *t, None if cw is None else torch.as_tensor(cw))
        np.testing.assert_allclose(float(got), float(want), atol=1e-8,
                                   rtol=0)


def test_torch_hierarchical_postprocess_matches_jax():
    rng = np.random.default_rng(2)
    (r1, r2, r3), _ = _log_branches(rng, 30, (5, 4, 3))
    r1[:4] = r1[4:8]                # ties between pairs
    pair_scores = rng.standard_normal(30)
    for ps in (None, pair_scores):
        with jax.enable_x64():
            want = jax_pnp.hierarchical_postprocess(r1, r2, r3, ps)
        got = plugandplay.hierarchical_postprocess(
            *map(torch.as_tensor, (r1, r2, r3)),
            None if ps is None else torch.as_tensor(ps))
        for i, (g, w) in enumerate(zip(got, want)):
            if i == 1:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=1e-12, rtol=0)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_torch_commonsense_validator_matches_jax():
    def transport(prompts):
        # a deterministic mock: approve edges mentioning 'man' or 'on'
        return ["Yes" if ("man" in p or " on " in p) else "No"
                for p in prompts]

    rng = np.random.default_rng(3)
    sub = rng.integers(0, 150, 40)
    rel = rng.integers(0, 50, 40)
    obj = rng.integers(0, 150, 40)
    scores = rng.standard_normal(40)
    scores[5] = -np.inf
    for top_k in (3, 20, 60):
        jv = jax_pnp.CommonsenseValidator(transport=transport, top_k=top_k)
        tv = plugandplay.CommonsenseValidator(transport=transport,
                                              top_k=top_k)
        np.testing.assert_array_equal(tv.query(sub, rel, obj),
                                      jv.query(sub, rel, obj))
        np.testing.assert_array_equal(
            tv.filter_scores(scores, sub, rel, obj),
            jv.filter_scores(scores, sub, rel, obj))


def _collection(seed, images=6, n=6, r=50):
    rng = np.random.default_rng(seed)
    rels, scores, conns, valid_pairs = {}, {}, {}, {}
    for i in range(images):
        k = int(rng.integers(2, n + 1))
        valid = np.arange(n) < k
        vp = valid[:, None] & valid[None, :] & ~np.eye(n, dtype=bool)
        rel = np.where(vp & (rng.random((n, n)) < 0.3),
                       rng.integers(0, r, (n, n)), -1).astype(np.int32)
        s = rng.standard_normal((n, n, r)).astype(np.float32)
        s[0, 1, 3] = -np.inf               # an unscored pair
        rels[i], scores[i], valid_pairs[i] = rel, s, vp
        conns[i] = rng.random((n, n)).astype(np.float32)
    return rels, scores, conns, valid_pairs


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_ietrans_and_nice_match_jax(seed):
    rels, scores, conns, vps = _collection(seed)
    for kw in ({}, {"internal_percent": 30.0, "external_percent": 10.0,
                    "external_min_conn": 0.8}):
        got, got_n = lt.ietrans(rels, scores, conns, vps, 50, **kw)
        want, want_n = jax_lt.ietrans(rels, scores, conns, vps, 50, **kw)
        assert got_n == want_n and got_n["relabeled"] + got_n["added"] > 0
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for pct in (30.0, 100.0):
        got, got_n = lt.nice(rels, scores, percent=pct)
        want, want_n = jax_lt.nice(rels, scores, percent=pct)
        assert got_n == want_n
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_torch_label_transfer_rewrite_matches_jax():
    rel_map = rel_index_map("motif")
    np.testing.assert_array_equal(lt.inverse_rel_map(rel_map),
                                  jax_lt.inverse_rel_map(rel_map))
    rels, scores, _, _ = _collection(4, images=1, n=5)
    rec = {"categories": np.arange(5), "bbox": np.zeros((5, 4), np.float32),
           "relationships": [], "subj_or_obj": []}
    new_rel = rels[0]
    got = lt.rewrite_annotation(rec, new_rel, rel_map)
    want = jax_lt.rewrite_annotation(rec, new_rel, rel_map)
    assert set(got) == set(want)
    for k in ("relationships", "subj_or_obj"):
        assert len(got[k]) == len(want[k]) == 4
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, w)
    freq = lt.predicate_frequencies(rels.values(), 50)
    np.testing.assert_array_equal(
        freq, jax_lt.predicate_frequencies(rels.values(), 50))
