"""The port's box and pair ops against the JAX package's, on the same numpy
inputs: integer and bool outputs must be equal, float IoU within 1e-6
(float32 division in both)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scene_graph_commonsense_tpu import config as jax_config
from scene_graph_commonsense_tpu.data.synthetic import synthetic_batch
from scene_graph_commonsense_tpu.ops import boxes as jbox
from scene_graph_commonsense_tpu.ops import pairs as jpairs
from scene_graph_commonsense_torch import config as torch_config
from scene_graph_commonsense_torch.data.synthetic import (
    synthetic_batch as torch_synthetic_batch)
from scene_graph_commonsense_torch.ops import boxes as tbox
from scene_graph_commonsense_torch.ops import pairs as tpairs


def _boxes(rng, shape, size):
    """Fractional and out-of-grid coordinates, plus empty boxes."""
    x0 = rng.uniform(-2, size, shape)
    y0 = rng.uniform(-2, size, shape)
    x1 = x0 + rng.uniform(-1, size / 2, shape)
    y1 = y0 + rng.uniform(-1, size / 2, shape)
    return np.stack([x0, x1, y0, y1], -1).astype(np.float32)


def test_torch_boxes_match_jax(rng):
    size = 16
    a = _boxes(rng, (5, 7), size)
    b = _boxes(rng, (5, 7), size)
    np.testing.assert_array_equal(
        tbox.boxes_to_masks(torch.from_numpy(a), size).numpy(),
        np.asarray(jbox.boxes_to_masks(jnp.asarray(a), size)))
    np.testing.assert_array_equal(
        tbox.mask_intersection(torch.from_numpy(a), torch.from_numpy(b),
                               size).numpy(),
        np.asarray(jbox.mask_intersection(a, b, size)))
    np.testing.assert_allclose(
        tbox.mask_iou(torch.from_numpy(a), torch.from_numpy(b), size).numpy(),
        np.asarray(jbox.mask_iou(a, b, size)), atol=1e-6)
    # the eval-time overlap filter over a whole (B, N, N) grid
    np.testing.assert_array_equal(
        tpairs.eval_pair_filter(torch.from_numpy(a), size).numpy(),
        np.asarray(jpairs.eval_pair_filter(jnp.asarray(a), size)))


def _valid(rng, b, n):
    counts = rng.integers(0, n + 1, b)
    return np.arange(n)[None, :] < counts[:, None]


@pytest.mark.parametrize("capacity", ["worst_case", "exact", "overflow",
                                      "one"])
def test_torch_pack_pairs_matches_jax(rng, capacity):
    b, n = 4, 6
    valid = _valid(rng, b, n)
    ok_j = jpairs.pair_validity(jnp.asarray(valid))
    ok_t = tpairs.pair_validity(torch.from_numpy(valid))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    live = int(np.asarray(ok_j).sum())
    cap = {"worst_case": b * n * (n - 1), "exact": max(live, 1),
           "overflow": max(live - 3, 1), "one": 1}[capacity]
    pj = jpairs.pack_pairs(ok_j, cap)
    pt = tpairs.pack_pairs(ok_t, cap)
    for field in jpairs.PackedPairs._fields:
        got = getattr(pt, field).numpy()
        want = np.asarray(getattr(pj, field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    # count may exceed capacity; padding parks on (img 0, sub 0, obj 1)
    assert int(pt.count) == live
    pad = ~pt.mask.numpy()
    assert (pt.img.numpy()[pad] == 0).all()
    assert (pt.sub.numpy()[pad] == 0).all()
    assert (pt.obj.numpy()[pad] == 1).all()
    assert (pt.flat_id.numpy()[pad] == -1).all()


def test_torch_config_and_synthetic_copies_match_jax():
    overrides = dict(model={"feature_size": 16}, data={"max_objects": 6},
                     training={"batch_size": 3})
    jc = jax_config.derive("vg", supcat_clustering="gpt2", **overrides)
    tc = torch_config.derive("vg", supcat_clustering="gpt2", **overrides)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert jc.pair_capacity == tc.pair_capacity == 3 * 6 * 5
    bj = synthetic_batch(np.random.default_rng(3), batch_size=3,
                         max_objects=6, feature_size=8, num_channels=4)
    bt = torch_synthetic_batch(np.random.default_rng(3), batch_size=3,
                               max_objects=6, feature_size=8, num_channels=4)
    assert bj.keys() == bt.keys()
    for k in bj:
        np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


def test_torch_gather_pair_box_area_and_mask_iou_oracle_match_jax(rng):
    """ops/pairs.gather_pair (both endpoints, per-object values of two
    ranks), ops/boxes.box_area and reference_mask_iou_numpy equal the JAX
    package's; the oracle agrees with the closed-form mask_iou."""
    b, n, size = 4, 6, 16
    ok = _valid(rng, b, n)
    pj = jpairs.pack_pairs(jpairs.pair_validity(jnp.asarray(ok)), 50)
    pt = tpairs.pack_pairs(tpairs.pair_validity(torch.from_numpy(ok)), 50)
    for values in (rng.standard_normal((b, n)).astype(np.float32),
                   rng.standard_normal((b, n, 3)).astype(np.float32)):
        for which in ("sub", "obj"):
            np.testing.assert_array_equal(
                tpairs.gather_pair(torch.from_numpy(values), pt,
                                   which).numpy(),
                np.asarray(jpairs.gather_pair(jnp.asarray(values), pj,
                                              which)), err_msg=which)
    boxes = _boxes(rng, (5, 7), size)
    np.testing.assert_array_equal(
        tbox.box_area(torch.from_numpy(boxes), size).numpy(),
        np.asarray(jbox.box_area(boxes, size)))
    a, c = boxes[0], boxes[1]
    iou = tbox.mask_iou(torch.from_numpy(a), torch.from_numpy(c),
                        size).numpy()
    for i in range(len(a)):
        got = tbox.reference_mask_iou_numpy(np.clip(a[i], 0, None),
                                            np.clip(c[i], 0, None), size)
        assert got == jbox.reference_mask_iou_numpy(
            np.clip(a[i], 0, None), np.clip(c[i], 0, None), size)
        np.testing.assert_allclose(got, iou[i], atol=1e-6)
