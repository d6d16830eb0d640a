"""The port's detection post-process (ops/detection.py) against the JAX
package's, on identical logits and boxes, on the CPU.  Integer and bool
outputs (cats, valid) are exact; cat_conf and boxes within 1e-6 in float32
(softmax in another order of operations) and 1e-12 in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_graph_commonsense_tpu.constants import OBJ_ALP2FRE as JAX_ALP2FRE
from scene_graph_commonsense_tpu.ops import detection as jdet
from scene_graph_commonsense_torch.constants import OBJ_ALP2FRE
from scene_graph_commonsense_torch.ops import detection as tdet


def test_torch_alp2fre_is_the_jax_table():
    np.testing.assert_array_equal(OBJ_ALP2FRE, JAX_ALP2FRE)
    assert OBJ_ALP2FRE.dtype == JAX_ALP2FRE.dtype


def _inputs(rng, b, q, c, dtype, p_none=0.25):
    """Random logits with: queries whose argmax is the no-object slot,
    queries whose second choice is it (a slot remapped to no-object),
    exact ties between the top two classes and between queries, and
    duplicate boxes (so that NMS suppresses); cxcywh boxes reaching past
    [0, 1] (so that the clamp acts)."""
    logits = rng.standard_normal((b, q, c + 1)) * 2
    no_obj = rng.random((b, q)) < p_none
    logits[no_obj, c] = 8.0
    second = (~no_obj) & (rng.random((b, q)) < 0.2)
    top = logits[..., :c].max(-1)
    logits[..., c] = np.where(second, top - 0.5, logits[..., c])
    tie = rng.random((b, q)) < 0.15
    arg = logits[..., :c].argmax(-1)
    partner = (arg + 7) % c
    bi, qi = np.nonzero(tie & ~no_obj & ~second)
    logits[bi, qi, partner[bi, qi]] = logits[bi, qi, arg[bi, qi]]
    logits[:, 1] = logits[:, 0]                   # two identical queries
    boxes = np.concatenate([rng.random((b, q, 2)) * 1.2 - 0.1,
                            rng.random((b, q, 2)) * 0.6 + 0.05], axis=-1)
    boxes[:, 1] = boxes[:, 0]
    dup = rng.random((b, q)) < 0.3
    boxes[dup] = np.roll(boxes, 1, axis=1)[dup]
    return logits.astype(dtype), boxes.astype(dtype)


def _compare(logits, boxes, alp2fre, tol, **kw):
    with jax.enable_x64(logits.dtype == np.float64):
        want = jax.tree.map(np.asarray, jax.jit(
            lambda lg, bx: jdet.postprocess_detections(lg, bx, alp2fre,
                                                       **kw))(
            jnp.asarray(logits), jnp.asarray(boxes)))
    got = {k: v.numpy() for k, v in tdet.postprocess_detections(
        torch.from_numpy(logits), torch.from_numpy(boxes), alp2fre,
        **kw).items()}
    assert got.keys() == want.keys()
    for k in ("cats", "valid"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("cat_conf", "boxes"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                   err_msg=k)
    return got


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
def test_torch_postprocess_detections_matches_jax(dtype, tol):
    """DETR's shapes: 100 queries (most of them no-object, as a trained
    detector gives), 151 logits, the VG remap, 20 slots."""
    rng = np.random.default_rng(0)
    logits, boxes = _inputs(rng, 3, 100, 150, dtype, p_none=0.92)
    got = _compare(logits, boxes, OBJ_ALP2FRE, tol)
    assert got["cats"].shape == (3, 20) and got["boxes"].shape == (3, 20, 4)
    assert got["valid"].any() and not got["valid"].all()
    assert (got["cats"][~got["valid"]] == 0).all()
    assert (got["boxes"] >= 0).all() and (got["boxes"] <= 32).all()


@pytest.mark.parametrize("topk,nms_iou", [(2, 0.5), (1, 0.3), (3, 0.7)])
def test_torch_postprocess_detections_remap_to_no_object(topk, nms_iou):
    """A remap sending a quarter of the classes to the no-object id drops
    those slots; fewer survivors than max_objects leaves padding slots."""
    rng = np.random.default_rng(1)
    c = 12
    logits, boxes = _inputs(rng, 4, 9, c, np.float32)
    remap = np.append(rng.permutation(c), c).astype(np.int32)
    remap[remap % 4 == 0] = c
    got = _compare(logits, boxes, remap, 1e-6, num_classes=c,
                   topk_cat=topk, feature_size=16, nms_iou=nms_iou,
                   max_objects=25 if topk == 3 else 10)
    assert not got["valid"].all()
    assert (got["cats"][got["valid"]] != c).all()
