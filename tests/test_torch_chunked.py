"""The port's chunked pair trunk (the `chunk_size` argument of
forward_pairs, make_eval_step, make_train_step and fit) against the JAX
package's `_chunked_pair_trunk` path on the CPU, and against the port's own
unchunked path.

Tolerances: float64 (JAX with x64 on) atol 1e-8 against JAX and 1e-12
against the unchunked port (the same sums, split over chunks); integer
outputs equal.  Dropout is off in the parity runs."""

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
from scene_graph_commonsense_tpu.train import engine as jax_engine
from scene_graph_commonsense_torch.constants import class_weights
from scene_graph_commonsense_torch.eval import engines
from scene_graph_commonsense_torch.ops import pair_pool
from scene_graph_commonsense_torch.train import engine

CAP = 4 * 6 * 5                       # tiny_cfg's worst-case pair capacity
CHUNKS = (1, 3, CAP - 1, CAP)
HEAD = ("relation", "super_relation", "connectivity", "hidden")


@pytest.fixture(scope="module")
def params():
    return flax_params()


def _jax_forward(jc, params, batch, chunk):
    model = make_relation_classifier(jc)

    @jax.jit
    def fwd(p, bt):
        out, packed = jax_engine.forward_pairs(
            model, p, bt, CAP, deterministic=True, chunk_size=chunk)
        return {k: out[k] for k in HEAD}, packed.count

    with jax.enable_x64():
        out, count = fwd(jax.tree.map(jnp.asarray, params),
                         {k: jnp.asarray(v) for k, v in batch.items()})
        return jax.tree.map(np.asarray, out), int(count)


def _torch_forward(tc, params, batch, chunk):
    model = torch_model(tc, params)
    bt = {k: torch.as_tensor(batch[k]) for k in engine.MODEL_KEYS}
    with torch.no_grad():
        out, packed = engine.forward_pairs(model, bt, CAP, chunk_size=chunk)
    return {k: out[k].numpy() for k in HEAD}, int(packed.count)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_torch_chunked_forward_pairs_matches_jax(params, chunk):
    jc, tc = cfgs()
    batch = batches(1, seed=9, with_aug=False)[0]
    want, want_count = _jax_forward(jc, params, batch, chunk)
    got, count = _torch_forward(tc, params, batch, chunk)
    whole, _ = _torch_forward(tc, params, batch, 0)
    assert count == want_count and 0 < count <= CAP
    for k in HEAD:
        np.testing.assert_allclose(got[k], want[k], atol=1e-8, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], whole[k], atol=1e-12, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_torch_chunked_eval_step_matches_jax(params, chunk, monkeypatch):
    """The eval step at chunk_size: every output against JAX's chunked step
    and the port's unchunked one; one pair-pool call per chunk (the
    forward without index: no gradient)."""
    jc, tc = cfgs()
    batch = batches(1, seed=10, with_aug=False)[0]
    with jax.enable_x64():
        jstep = jax_engine.make_eval_step(make_relation_classifier(jc), jc,
                                          chunk_size=chunk)
        want = jax.tree.map(np.asarray, jstep(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()}))
    calls = []
    plain = pair_pool.pair_pool_plain
    monkeypatch.setattr(pair_pool, "pair_pool_plain",
                        lambda *a: calls.append(a[2].shape[0]) or plain(*a))
    got = engines.to_numpy(engine.make_eval_step(
        torch_model(tc, params), tc, device="cpu", chunk_size=chunk)(batch))
    n_chunks = -(-CAP // chunk)
    assert calls == [min(chunk, CAP)] * n_chunks
    whole = engines.to_numpy(engine.make_eval_step(
        torch_model(tc, params), tc, device="cpu")(batch))
    assert got.keys() == want.keys() == whole.keys()
    for k, w in want.items():
        if got[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], w, atol=1e-8, rtol=0,
                                       err_msg=k)
            np.testing.assert_allclose(got[k], whole[k], atol=1e-12,
                                       rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
            np.testing.assert_array_equal(got[k], whole[k], err_msg=k)


def _torch_train(tc, params, data, chunk):
    model = torch_model(tc, params)
    opt = engine.make_optimizer(1e-3, grad_clip_norm=0.05)
    state = engine.init_train_state(model, opt)
    step = engine.make_train_step(model, tc, opt, class_weights("vg"),
                                  device="cpu", chunk_size=chunk)
    trail = []
    for bt in data:
        state, met = step(state, bt)
        trail.append((torch_params(model),
                      {k: float(v) for k, v in met.items()}))
    return trail


@pytest.mark.parametrize("chunk", CHUNKS)
def test_torch_chunked_train_step_matches_jax(params, chunk, monkeypatch):
    """2 train steps at chunk_size (augmented view at capacity 30,
    clipping that fires): parameters and metrics against JAX's chunked
    step and the port's unchunked one.  Per view the forward with index
    runs twice a chunk (forward, recompute) and the backward once; a view
    that fits in one chunk runs each once."""
    jc, tc = cfgs(training={"grad_clip_norm": 0.05})
    data = batches(2, seed=12)
    with jax.enable_x64():
        jparams = jax.tree.map(jnp.asarray, params)
        opt = jax_engine.make_optimizer(1e-3, grad_clip_norm=0.05)
        state = jax_engine.TrainState(jparams, opt.init(jparams),
                                      jnp.int32(0))
        step = jax_engine.make_train_step(
            make_relation_classifier(jc), jc, opt, jax_class_weights("vg"),
            chunk_size=chunk, donate=False)
        want = []
        for bt in data:
            state, met = step(state, {k: jnp.asarray(v)
                                      for k, v in bt.items()},
                              jax.random.PRNGKey(0))
            want.append((jax.tree.map(np.array, state.params)["params"],
                         {k: float(v) for k, v in met.items()}))
    calls = {"idx": 0, "bwd": 0}
    for name in ("idx", "bwd"):
        fn = getattr(pair_pool, f"pair_pool_{name}_plain")
        monkeypatch.setattr(
            pair_pool, f"pair_pool_{name}_plain",
            lambda *a, _n=name, _f=fn: calls.__setitem__(
                _n, calls[_n] + 1) or _f(*a))
    got = _torch_train(tc, params, data, chunk)
    chunks = sum(-(-c // chunk) if chunk < c else 1 for c in (CAP, 30))
    recomputed = sum(-(-c // chunk) for c in (CAP, 30) if chunk < c)
    assert calls == {"idx": len(data) * (chunks + recomputed),
                     "bwd": len(data) * chunks}
    whole = _torch_train(tc, params, data, 0)
    for (g_p, g_m), (w_p, w_m), (u_p, u_m) in zip(got, want, whole):
        assert_trees_close(g_p, w_p, 1e-8)
        assert_metrics_close(g_m, w_m, 1e-8)
        assert_trees_close(g_p, u_p, 1e-12)
        assert_metrics_close(g_m, u_m, 1e-12)


def test_torch_chunked_dropout_recompute_draws_same_mask(params,
                                                         monkeypatch):
    """With dropout on, each chunk's recompute in the backward draws the
    mask its forward drew (its generator is made inside the checkpointed
    chunk from the trunk stream's seed and the chunk index): the step
    equals the same step with the chunks' activations kept."""
    _, tc = cfgs(model={"dropout_rate": 0.5})
    data = batches(1, seed=13)
    got = _torch_train(tc, params, data, 7)

    def keep(fn, *args, use_reentrant, preserve_rng_state):
        return fn(*args)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", keep)
    kept = _torch_train(tc, params, data, 7)
    assert_trees_close(got[0][0], kept[0][0], 0.0)
    # dropout did act: the unchunked step (other streams) differs
    whole = _torch_train(tc, params, data, 0)
    assert not np.allclose(got[0][0]["fc1"]["kernel"],
                           whole[0][0]["fc1"]["kernel"], atol=1e-9)
