"""Shared set-up of the port's slice-7 parity tests (faithful dynamics, the
chunked pair trunk, prepare_cs, observability): tests/test_engine.py's
tiny_cfg dims in both packages, numpy batches from a seed, and one set of
flax weights loaded into both."""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from test_engine import tiny_cfg, init_params  # noqa: E402

from scene_graph_commonsense_tpu.data.synthetic import (  # noqa: E402
    synthetic_batch)
from scene_graph_commonsense_tpu.models.relation_head import (  # noqa: E402
    make_relation_classifier as make_jax_classifier)
from scene_graph_commonsense_torch import config as torch_config  # noqa
from scene_graph_commonsense_torch.models import weights  # noqa: E402
from scene_graph_commonsense_torch.models.relation_head import (  # noqa
    make_relation_classifier as make_torch_classifier)

INT_METRICS = ("num_connected", "num_not_connected", "num_connected_pred",
               "connectivity_precision_hits", "connectivity_recall_hits",
               "num_pairs", "pair_overflow", "aug_pair_overflow")


def cfgs(hierar=True, dtype="float64", model=None, data=None,
         training=None):
    """(JAX config, port config) of tiny_cfg with dropout off and the
    given overrides per section."""
    jc = tiny_cfg(hierar=hierar)
    jc = jc.replace(
        model=dataclasses.replace(jc.model, **{
            "compute_dtype": dtype, "dropout_rate": 0.0, **(model or {})}),
        data=dataclasses.replace(jc.data, **(data or {})),
        training=dataclasses.replace(jc.training, **(training or {})))
    tc = torch_config.derive("vg", model=dict(jc.model.__dict__),
                             data={"max_objects": jc.data.max_objects,
                                   **(data or {})},
                             training=dict(jc.training.__dict__))
    return jc, tc


def batches(n, seed=3, with_aug=True, float64=True):
    """n synthetic batches at tiny_cfg's shapes, numpy."""
    jc = tiny_cfg()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = synthetic_batch(
            rng, batch_size=jc.training.batch_size,
            max_objects=jc.data.max_objects,
            feature_size=jc.model.feature_size,
            num_channels=jc.model.num_img_feature,
            num_classes=jc.model.num_classes, with_aug=with_aug)
        if float64:
            b = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                 for k, v in b.items()}
        out.append(b)
    return out


def flax_params(hierar=True, dtype=np.float64):
    """Seeded flax weights of tiny_cfg's classifier, as numpy."""
    jc, _ = cfgs(hierar=hierar, dtype="float32")
    params = init_params(jc, make_jax_classifier(jc), None)
    return jax.tree.map(lambda x: np.asarray(x, dtype), params)


def torch_model(tc, params, dtype=torch.float64):
    """The port's classifier on the CPU holding `params` (flax tree)."""
    sd = {k: v.to(dtype) for k, v in weights.from_flax(params).items()}
    return make_torch_classifier(tc, device="cpu", state_dict=sd).to(dtype)


def torch_params(model):
    """The port's parameters as a flax-named numpy tree."""
    return weights.to_flax(model.state_dict())["params"]


def assert_trees_close(got, want, atol):
    assert got.keys() == want.keys()
    for name, leaf in want.items():
        for kind, w in leaf.items():
            np.testing.assert_allclose(got[name][kind], w, atol=atol,
                                       rtol=0, err_msg=f"{name}.{kind}")


def assert_metrics_close(got, want, atol):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k in INT_METRICS:
            assert got[k] == w, k
        else:
            np.testing.assert_allclose(got[k], w, atol=atol, rtol=0,
                                       err_msg=k)


@pytest.fixture
def one_thread():
    """One CPU thread for the test: with several, the CPU's reductions may
    split differently between two runs of one computation, and a test that
    holds two runs equal to the bit needs them split alike."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
