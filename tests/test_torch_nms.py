"""The port's static-shape class-aware NMS (ops/nms.py) against the JAX
package's, on the same numpy boxes, scores, classes and validity, on the
CPU.  The keep mask is exact; box IoU within 1e-12 in float64 and 1e-6 in
float32 (the same IEEE operations on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_graph_commonsense_tpu.ops import nms as jnms
from scene_graph_commonsense_torch.ops import nms as tnms


def _case(rng, b, m, dtype, n_classes=3, grid=8):
    """Boxes on a coarse grid (so that exact IoU ties and exact threshold
    hits occur), scores in few levels (exact ties), some invalid slots."""
    x1 = rng.integers(0, grid, (b, m, 2))
    size = rng.integers(1, grid // 2, (b, m, 2))
    boxes = np.concatenate([x1, x1 + size], axis=-1).astype(dtype)
    scores = rng.integers(0, 6, (b, m)).astype(dtype) / 6
    classes = rng.integers(0, n_classes, (b, m)).astype(np.int32)
    valid = rng.random((b, m)) > 0.2
    return boxes, scores, classes, valid


def _jax_keep(boxes, scores, classes, valid, thr):
    fn = jax.jit(jax.vmap(lambda bx, sc, cl, va: jnms.class_aware_nms(
        bx, sc, cl, va, thr)))
    return np.asarray(fn(jnp.asarray(boxes), jnp.asarray(scores),
                         jnp.asarray(classes), jnp.asarray(valid)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("thr", [0.5, 0.3])
def test_torch_class_aware_nms_matches_jax(dtype, thr):
    rng = np.random.default_rng(0)
    args = _case(rng, 4, 40, dtype)
    with jax.enable_x64(dtype == np.float64):
        want = _jax_keep(*args, thr)
    got = tnms.class_aware_nms(*(torch.from_numpy(a) for a in args),
                               iou_threshold=thr).numpy()
    assert got.dtype == np.bool_ and got.shape == (4, 40)
    np.testing.assert_array_equal(got, want)
    # something was suppressed and something kept, invalid slots never kept
    assert 0 < got.sum() < args[3].sum()
    assert not got[~args[3]].any()


def test_torch_class_aware_nms_ties_and_threshold():
    """Hand-made cases: an exact 0.5 IoU is not suppressed (strict >); of
    equal scores the lower index wins; another class is never suppressed;
    an invalid box suppresses nothing; a suppressed box suppresses
    nothing."""
    boxes = np.array([[0, 0, 2, 1],      # 0
                      [0, 0, 1, 1],      # 1: IoU 0.5 with 0: kept
                      [0, 0, 2, 1],      # 2: = 0, same score, later: gone
                      [0, 0, 2, 1],      # 3: = 0, another class: kept
                      [10, 10, 12, 12],  # 4: invalid
                      [10, 10, 12, 12],  # 5: kept (4 is invalid)
                      [3, 3, 5, 5],      # 6: kept
                      [3, 3, 5, 6],      # 7: IoU 2/3 with 6: gone
                      [3, 4, 5, 6.5]],   # 8: IoU .57 with 7, .29 with 6
                     np.float64)
    scores = np.array([.9, .8, .9, .9, .99, .5, .7, .6, .55])
    classes = np.array([1, 1, 1, 2, 0, 0, 3, 3, 3], np.int32)
    valid = np.array([1, 1, 1, 1, 0, 1, 1, 1, 1], bool)
    with jax.enable_x64():
        want = _jax_keep(boxes[None], scores[None], classes[None],
                         valid[None], 0.5)[0]
    got = tnms.class_aware_nms(
        *(torch.from_numpy(a[None]) for a in (boxes, scores, classes,
                                              valid)), 0.5)[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 1, 0, 1, 0, 1, 1, 0, 1])


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
def test_torch_box_iou_matches_jax(dtype, tol):
    rng = np.random.default_rng(1)
    a = (rng.random((5, 1, 4)) * 32).astype(dtype)
    b = (rng.random((1, 7, 4)) * 32).astype(dtype)
    a[..., 2:] += a[..., :2]
    b[..., 2:] += b[..., :2]
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jnms.box_iou_xyxy(jnp.asarray(a), jnp.asarray(b)))
    got = tnms.box_iou_xyxy(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (5, 7) and got.dtype == getattr(torch, a.dtype.name)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
