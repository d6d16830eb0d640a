"""The port's relation head and weight bridges against the JAX package.

Forward parity runs both under float64 (JAX with x64 on) on the same
float32 weights and numpy inputs, to atol 1e-8: the bar the JAX package held
against the living reference.  Weight conversions must be exact."""

import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, "tests")
from test_engine import tiny_cfg, init_params  # noqa: E402

from scene_graph_commonsense_tpu.data.synthetic import (  # noqa: E402
    synthetic_batch)
from scene_graph_commonsense_tpu.models.relation_head import (  # noqa: E402
    RelationClassifier as JaxRelationClassifier, assemble_object_stack,
    make_relation_classifier)
from scene_graph_commonsense_tpu.models.weights import (  # noqa: E402
    convert_relation_state_dict)
from scene_graph_commonsense_tpu.ops import boxes as jbox  # noqa: E402
from scene_graph_commonsense_torch import config as torch_config  # noqa: E402
from scene_graph_commonsense_torch.models import relation_head  # noqa
from scene_graph_commonsense_torch.models import weights  # noqa: E402
from scene_graph_commonsense_torch.models.relation_head import (  # noqa: E402
    make_relation_classifier as make_torch_classifier)

ATOL_F64 = 1e-8


def _cfgs(hierar=True, dtype="float64"):
    jc = tiny_cfg(hierar=hierar)
    jc = jc.replace(model=jc.model.__class__(
        **{**jc.model.__dict__, "compute_dtype": dtype}))
    tc = torch_config.derive(
        "vg", hierarchical_pred=hierar,
        model={**jc.model.__dict__}, data={"max_objects": 6},
        training={"batch_size": jc.training.batch_size})
    return jc, tc


@pytest.fixture(scope="module")
def flax_params():
    """float32 flax weights of the tiny hierarchical and flat heads, made
    once per module (JAX compiles each init op on first use)."""
    return {hierar: init_params(_cfgs(hierar, "float32")[0],
                                make_relation_classifier(
                                    _cfgs(hierar, "float32")[0]), None)
            for hierar in (True, False)}


def _models(flax_params, hierar=True):
    jc, tc = _cfgs(hierar)
    params = flax_params[hierar]
    tm = make_torch_classifier(tc, device="cpu",
                               state_dict=weights.from_flax(params))
    return jc, make_relation_classifier(jc), params, tm


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL_F64, rtol=0)


@pytest.mark.parametrize("part", ["object_streams_from_image",
                                  "pair_trunk_from_pooled", "pair_head",
                                  "reference_call", "reference_call_flat"])
def test_torch_relation_head_f64_parity(rng, flax_params, part):
    with jax.enable_x64():
        jc, jm, params, tm = _models(flax_params,
                                     hierar=part != "reference_call_flat")
        s, h = jc.model.feature_size, jc.model.hidden_dim
        nc, ns = jc.model.num_classes, jc.model.num_super_classes
        p = 7
        c1, c2 = rng.integers(0, nc, p), rng.integers(0, nc, p)
        s1 = (rng.random((p, ns)) < 0.3).astype(np.float32)
        s2 = (rng.random((p, ns)) < 0.3).astype(np.float32)
        if part == "object_streams_from_image":
            batch = synthetic_batch(
                rng, batch_size=2, max_objects=6, feature_size=s,
                num_channels=jc.model.num_img_feature, with_aug=False)
            masks = np.asarray(jbox.boxes_to_masks(batch["boxes"], s)) \
                * batch["valid"][:, :, None, None]
            args = (batch["features"], batch["depth"], masks)
            want = jm.apply(params, *(jnp.asarray(x) for x in args),
                            method=JaxRelationClassifier
                            .object_streams_from_image)
            got = tm.object_streams_from_image(*(_t(x) for x in args))
            for g, w in zip(got, want):
                _close(g, w)
            return
        if part == "pair_trunk_from_pooled":
            x = rng.standard_normal((p, s // 2, s // 2, 4 * h))
            want = jm.apply(params, jnp.asarray(x),
                            method=JaxRelationClassifier
                            .pair_trunk_from_pooled)
            _close(tm.pair_trunk_from_pooled(_t(x)), want)
            return
        if part == "pair_head":
            x = np.abs(rng.standard_normal((p, 4096)))
            args = (x, c1, c2, s1, s2)
            want = jm.apply(params, *(jnp.asarray(a) for a in args),
                            method=JaxRelationClassifier.pair_head)
            got = tm.pair_head(*(_t(a) for a in args))
        else:
            cin = jc.model.num_img_feature + 1
            xs = rng.standard_normal((p, s, s, cin))
            xo = rng.standard_normal((p, s, s, cin))
            args = (xs, xo, c1, c2, s1, s2)
            want = jm.apply(params, *(jnp.asarray(a) for a in args))
            got = tm(*(_t(a) for a in args))
        for key in ("relation", "connectivity", "hidden", "super_relation"):
            if want[key] is None:
                assert got[key] is None
                continue
            assert got[key].dtype == torch.float64, key
            _close(got[key], want[key])


def test_torch_weights_flax_round_trip(flax_params):
    params = flax_params[True]
    back = weights.to_flax(weights.from_flax(params))
    want = jax.tree.map(np.asarray, dict(params))
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for (path, got), w in zip(jax.tree_util.tree_leaves_with_path(back),
                              jax.tree.leaves(want)):
        np.testing.assert_array_equal(got, w, err_msg=str(path))


def _reference_state(rng, h, fs, nc, ns):
    st = {}

    def conv(name, cout, cin, k):
        st[f"module.{name}.weight"] = rng.standard_normal((cout, cin, k, k))
        st[f"module.{name}.bias"] = rng.standard_normal(cout)

    def dense(name, cout, cin):
        st[f"module.{name}.weight"] = rng.standard_normal((cout, cin))
        st[f"module.{name}.bias"] = rng.standard_normal(cout)

    conv("conv1_1", h, 2 * h + 1, 1)
    conv("conv1_2", h, 2 * h + 1, 1)
    conv("conv2_1", 4 * h, 2 * h, 3)
    conv("conv3_1", 8 * h, 4 * h, 3)
    dense("fc1", 4096, 8 * h * (fs // 4) ** 2)
    dense("fc2", 512, 4096 + 2 * (nc + ns))
    for name, n in (("fc3_1", 15), ("fc3_2", 11), ("fc3_3", 24), ("fc5", 3),
                    ("fc4", 1)):
        dense(name, n, 512)
    return st


def test_torch_reference_converter_matches_jax(rng):
    h, fs, nc, ns = 8, 16, 20, 5
    st = _reference_state(rng, h, fs, nc, ns)
    kw = dict(hierarchical=True, use_super=True, num_classes=nc,
              num_super_classes=ns, hidden_dim=h, feature_size=fs)
    want = weights.from_flax(convert_relation_state_dict(st, **kw))
    got = weights.from_reference_state_dict(
        {k: torch.from_numpy(v) for k, v in st.items()}, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_torch_init_params_matches_flax_layout(flax_params):
    _, tc = _cfgs(dtype="float32")
    sd = weights.init_params(tc, torch.Generator().manual_seed(1))
    mine = weights.to_flax(sd)["params"]
    want = flax_params[True]["params"]
    assert mine.keys() == want.keys()
    for name in want:
        for leaf in want[name]:
            assert mine[name][leaf].shape == want[name][leaf].shape
            assert mine[name][leaf].dtype == np.float32
    assert all(float(sd[k].abs().max()) == 0 for k in sd
               if k.endswith(".bias"))
    # lecun normal: variance 1/fan_in (fc1 is large enough to check)
    fan_in = sd["fc1.weight"].shape[1]
    assert abs(float(sd["fc1.weight"].std()) * np.sqrt(fan_in) - 1) < 0.02
    assert abs(float(sd["emb_c1.weight"].std()) * np.sqrt(512) - 1) < 0.05
    again = weights.init_params(tc, torch.Generator().manual_seed(1))
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_torch_assemble_object_stack_matches_jax(rng):
    """assemble_object_stack: each object's masked features and depth, as
    the JAX package stacks them (reference train_test.py:195-204)."""
    b, n, s_, c = 2, 3, 8, 5
    features = rng.standard_normal((b, s_, s_, c))
    depth = rng.random((b, s_, s_, 1))
    masks = (rng.random((b, n, s_, s_)) < 0.4).astype(np.float64)
    with jax.enable_x64():
        want = np.asarray(assemble_object_stack(
            jnp.asarray(features), jnp.asarray(depth), jnp.asarray(masks)))
    got = relation_head.assemble_object_stack(
        torch.from_numpy(features), torch.from_numpy(depth),
        torch.from_numpy(masks)).numpy()
    assert got.shape == want.shape == (b, n, s_, s_, c + 1)
    np.testing.assert_array_equal(got, want)
