"""The port reads the JAX package's flax DETR checkpoint without flax.

`flax.serialization.to_bytes` of seeded JAX DETR params (float64, reduced
depth: trunk blocks (1, 1, 1, 1), one encoder and one decoder layer, full
width) goes to a `.msgpack` file; the port's `load_detr_featurizer` reads
it with its own msgpack reader (models/flax_msgpack.py) and its
`encode_features` equals the JAX featurizer that `load_detr_featurizer` of
the JAX package builds from the same file, within 1e-8.  The reader itself
is held against flax's writer on the leaf kinds flax writes, and refuses
what it does not take with a ValueError."""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_graph_commonsense_tpu import config as jax_config
from scene_graph_commonsense_tpu.models import detr as jdetr
from scene_graph_commonsense_tpu.train import loop as jax_loop
from scene_graph_commonsense_torch import config as torch_config
from scene_graph_commonsense_torch.models import flax_msgpack
from scene_graph_commonsense_torch.models import weights
from scene_graph_commonsense_torch.train import loop

BLOCKS = (1, 1, 1, 1)


def _cfgs(path):
    kw = dict(model={"detr_blocks": BLOCKS, "detr_enc_layers": 1,
                     "detr_dec_layers": 1, "compute_dtype": "float64",
                     "detr_pretrained": str(path)})
    return jax_config.derive("vg", **kw), torch_config.derive("vg", **kw)


def _seeded_params(jc):
    """The JAX DETR's float64 params with every vector perturbed from a
    seed (frozen-BN statistics off the identity, running_var positive),
    so that each leaf's mapping shows in the features."""
    with jax.enable_x64():
        model = jdetr.make_detr(jc)
        params = jax.jit(model.init)(jax.random.PRNGKey(3),
                                     jnp.zeros((1, 64, 64, 3)),
                                     jnp.ones((1, 64, 64), bool))
    rng = np.random.default_rng(7)

    def perturb(path, a):
        a = np.asarray(a, np.float64)
        if a.ndim != 1:
            return a
        if path[-1].key == "running_var":
            return rng.uniform(0.5, 2.0, a.shape)
        return a + rng.normal(0.0, 0.1, a.shape)
    return jax.tree_util.tree_map_with_path(perturb, params)


def test_torch_flax_checkpoint_matches_jax_featurizer(tmp_path):
    path = tmp_path / "detr.msgpack"
    jc, tc = _cfgs(path)
    params = _seeded_params(jc)
    path.write_bytes(flax.serialization.to_bytes(params))
    image = np.random.default_rng(8).normal(size=(2, 64, 96, 3))
    with jax.enable_x64():
        featurize, _, jparams = jax_loop.load_detr_featurizer(
            jc, log_fn=pytest.fail)
        assert jax.tree.leaves(jparams)[0].dtype == np.float64
        want = np.asarray(featurize({"image": image})["features"])
    lines = []
    featurize, detr = loop.load_detr_featurizer(tc, device="cpu",
                                                log_fn=lines.append)
    assert not lines                                 # no random-weights warning
    got = featurize({"image": image})["features"].numpy()
    assert got.shape == want.shape == (2, 2, 3, 256)
    np.testing.assert_allclose(got, want, atol=1e-8, rtol=0)
    # the file holds the decoder too; the featurizer keeps the encode half
    want_sd = weights.detr_encode_half(weights.detr_from_flax(params))
    assert detr.state_dict().keys() == want_sd.keys()


def test_torch_flax_checkpoint_loads_the_detector(tmp_path):
    """The same file through load_detr(detection=True): every key of the
    tree, and the JAX detector's outputs on a padded canvas (float64,
    1e-8)."""
    path = tmp_path / "detr.msgpack"
    jc, tc = _cfgs(path)
    params = _seeded_params(jc)
    path.write_bytes(flax.serialization.to_bytes(params))
    image = np.random.default_rng(9).normal(size=(2, 64, 64, 3))
    mask = np.ones((2, 64, 64), bool)
    mask[1, :, 32:] = False
    with jax.enable_x64():
        want = jax.tree.map(np.asarray, jax.jit(jdetr.make_detr(jc).apply)(
            params, jnp.asarray(image), jnp.asarray(mask)))
    detector = loop.load_detr(tc, device="cpu", log_fn=pytest.fail,
                              detection=True)
    assert detector.state_dict().keys() == weights.detr_from_flax(
        params).keys()
    got = detector(torch.from_numpy(image), torch.from_numpy(mask))
    for k in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-8,
                                   rtol=0, err_msg=k)


def test_torch_flax_checkpoint_lacking_keys_raises(tmp_path):
    path = tmp_path / "detr.msgpack"
    jc, tc = _cfgs(path)
    params = _seeded_params(jc)
    del params["params"]["input_proj"]
    path.write_bytes(flax.serialization.to_bytes(params))
    with pytest.raises(ValueError, match="input_proj.weight"):
        loop.load_detr_featurizer(tc, device="cpu")


def test_torch_flax_msgpack_reads_flax_trees():
    tree = {"params": {
        "dense": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "bias": np.zeros(0, np.float64)},
        "half": jnp.asarray([1.5, -2.25, 3e38], jnp.bfloat16),
        "nested": {"deeper": {"ints": np.arange(-3, 3, dtype=np.int64),
                              "flags": np.array([True, False])}},
        "scalar": np.float32(3.5), "count": np.int32(-7)},
        "step": 5, "lr": 0.25, "name": "detr" * 10, "none": None}
    got = flax_msgpack.unpack(flax.serialization.to_bytes(tree))
    p = got["params"]
    assert torch.equal(p["dense"]["kernel"],
                       torch.arange(6, dtype=torch.float32).reshape(2, 3))
    assert p["dense"]["bias"].dtype == torch.float64 \
        and p["dense"]["bias"].shape == (0,)
    assert p["half"].dtype == torch.bfloat16
    assert torch.equal(p["half"], torch.tensor([1.5, -2.25, 3e38],
                                               dtype=torch.bfloat16))
    assert torch.equal(p["nested"]["deeper"]["ints"],
                       torch.arange(-3, 3, dtype=torch.int64))
    assert p["nested"]["deeper"]["flags"].tolist() == [True, False]
    # numpy scalars come back as 0-d tensors of their dtype
    assert p["scalar"].shape == () and p["scalar"].item() == 3.5
    assert p["count"].dtype == torch.int32 and p["count"].item() == -7
    assert (got["step"], got["lr"], got["name"], got["none"]) == (
        5, 0.25, "detr" * 10, None)


def _chunked(monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    return flax.serialization.to_bytes({"w": np.zeros(100, np.float32)})


@pytest.mark.parametrize("case, match", [
    ("complex", "ext type 2"),
    ("chunked", "chunked array"),
    ("uint16", "dtype 'uint16'"),
    ("truncated", "ends inside"),
    ("trailing", "after the msgpack value"),
])
def test_torch_flax_msgpack_refuses_what_it_does_not_take(monkeypatch, case,
                                                          match):
    good = flax.serialization.to_bytes({"w": np.ones(3, np.float32)})
    data = {"complex": lambda: flax.serialization.to_bytes({"c": 1 + 2j}),
            "chunked": lambda: _chunked(monkeypatch),
            "uint16": lambda: flax.serialization.to_bytes(
                {"u": np.ones(2, np.uint16)}),
            "truncated": lambda: good[:-2],
            "trailing": lambda: good + b"\x00"}[case]()
    with pytest.raises(ValueError, match=match):
        flax_msgpack.unpack(data)
