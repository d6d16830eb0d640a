"""The training half of the port's pair pool (ops/pair_pool.py): the forward
with winner index and the backward, against the JAX package's Pallas kernel
(`fused_pair_pool(with_idx=True)`, interpret mode), its custom VJP and the
XLA reference's gradient, on the CPU.

Tolerances: out and idx equal exactly (float32 and bfloat16); gradients
within 1e-12 in float64 (against jax.grad of the XLA reference), 1e-6 in
float32 (against both JAX gradients), one bfloat16 ulp in bfloat16 (against
the custom VJP, which sums in float32 and rounds once, as the port does;
the XLA reference's bfloat16 gradient rounds at every add of its scatter,
see test_torch_pair_pool_bwd_bf16_vs_xla_reference).

The bfloat16 comparisons run the JAX side in a subprocess with XLA's
excess precision off (--xla_allow_excess_precision=false).  With it on, as
by default, XLA on the CPU compares the window sums of the interpreted
kernel unrounded, so where two float32 sums round to one bfloat16 value the
JAX kernel picks the second slot while the JAX package's own XLA gradient,
the port and its CUDA kernel pick the first
(test_torch_pair_pool_idx_bf16_tie_takes_first_slot)."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scene_graph_commonsense_tpu.ops.pallas.pair_pool import (
    fused_pair_pool, pair_pool as jax_pair_pool, pair_pool_reference,
    rearrange_pool_groups)
from scene_graph_commonsense_torch.ops import pair_pool as tpp

# the JAX side of the bfloat16 cases: inputs and outputs through npz files
_JAX_SIDE = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from scene_graph_commonsense_tpu.ops.pallas.pair_pool import (
    fused_pair_pool, pair_pool, pair_pool_reference, rearrange_pool_groups)
src, dst, dtype = sys.argv[1], sys.argv[2], getattr(jnp, sys.argv[3])
x = dict(np.load(src))
a, b = jnp.asarray(x["a"], dtype), jnp.asarray(x["b"], dtype)
si, oj = jnp.asarray(x["si"]), jnp.asarray(x["oj"])
w = jnp.asarray(x["w"], dtype)
out, idx = fused_pair_pool(rearrange_pool_groups(a), rearrange_pool_groups(b),
                           si, oj, interpret=True, with_idx=True)
def vjp_loss(a, b):
    o = pair_pool(rearrange_pool_groups(a), rearrange_pool_groups(b), si, oj,
                  True, 0)
    return (o * w).astype(jnp.float32).sum()
def ref_loss(a, b):
    return (pair_pool_reference(a, b, si, oj) * w).astype(jnp.float32).sum()
ga_v, gb_v = jax.grad(vjp_loss, argnums=(0, 1))(a, b)
ga_r, gb_r = jax.grad(ref_loss, argnums=(0, 1))(a, b)
f = lambda v: np.asarray(v, np.float32)
np.savez(dst, out=f(out), idx=np.asarray(idx), ga_v=f(ga_v), gb_v=f(gb_v),
         ga_r=f(ga_r), gb_r=f(gb_r))
"""


def _inputs(rng, m=5, s=8, c=16, p=13):
    a = rng.standard_normal((m, s, s, c)).astype(np.float32)
    b = rng.standard_normal((m, s, s, c)).astype(np.float32)
    si = rng.integers(0, m, p).astype(np.int32)
    oj = rng.integers(0, m, p).astype(np.int32)
    w = rng.standard_normal((p, s // 2, s // 2, c)).astype(np.float32)
    return a, b, si, oj, w


def _jax_side(tmp_path, inputs, dtype):
    a, b, si, oj, w = inputs
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, a=a, b=b, si=si, oj=oj, w=w)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    res = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(src),
                          str(dst), dtype], env=env, cwd=os.getcwd(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(dst))


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The random inputs and the JAX outputs for them, per dtype (one
    subprocess each, shared by the tests)."""
    inputs = _inputs(np.random.default_rng(0))
    return inputs, {dtype: _jax_side(tmp_path_factory.mktemp(dtype), inputs,
                                     dtype)
                    for dtype in ("float32", "bfloat16")}


def _port_grads(inputs, dtype):
    """(out, idx, ga, gb) of the port on CPU tensors: the forward with
    index and the backward through pair_pool's autograd.Function."""
    a, b, si, oj, w = (torch.from_numpy(x) for x in inputs)
    a = a.to(dtype).requires_grad_()
    b = b.to(dtype).requires_grad_()
    out, idx = tpp.pair_pool_idx(a.detach(), b.detach(), si, oj)
    y = tpp.pair_pool(a, b, si, oj)
    assert torch.equal(y.detach(), out)
    (y * w.to(dtype)).float().sum().backward()
    return out, idx, a.grad, b.grad


def _ulp_bf16(x):
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1), e - 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_pair_pool_idx_matches_pallas_interpret(jax_side, dtype):
    inputs, wants = jax_side
    want = wants[dtype]
    out, idx, _, _ = _port_grads(inputs, getattr(torch, dtype))
    assert idx.dtype == torch.int8
    np.testing.assert_array_equal(out.float().numpy(), want["out"])
    np.testing.assert_array_equal(idx.numpy(), want["idx"])
    counts = np.bincount(idx.numpy().ravel() + 1, minlength=5)
    assert (counts > 0).all()        # every slot wins somewhere, and -1


def test_torch_pair_pool_idx_f32_in_process(rng):
    """float32 needs no flag: the same comparison in this process."""
    a, b, si, oj, _ = _inputs(rng, m=4, s=6, c=8, p=9)
    want_out, want_idx = fused_pair_pool(
        rearrange_pool_groups(jnp.asarray(a)),
        rearrange_pool_groups(jnp.asarray(b)), jnp.asarray(si),
        jnp.asarray(oj), interpret=True, with_idx=True)
    out, idx = tpp.pair_pool_idx_plain(*(torch.from_numpy(x)
                                         for x in (a, b, si, oj)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def _tie_inputs():
    """Window sums 1 + 2^-10, 1 + 2^-9, 1, 1 + 2^-11: distinct in float32,
    all 1.0 in bfloat16."""
    m, s, c = 2, 2, 16
    a = np.ones((m, s, s, c), np.float32)
    b = np.zeros((m, s, s, c), np.float32)
    b[:, 0, 0], b[:, 0, 1], b[:, 1, 1] = 2.0 ** -10, 2.0 ** -9, 2.0 ** -11
    si, oj = np.array([0, 1], np.int32), np.array([1, 0], np.int32)
    w = np.ones((2, 1, 1, c), np.float32)
    return a, b, si, oj, w


def test_torch_pair_pool_idx_bf16_tie_takes_first_slot(tmp_path):
    inputs = _tie_inputs()
    out, idx, ga, _ = _port_grads(inputs, torch.bfloat16)
    assert (idx == 0).all() and (out.float() == 1.0).all()
    assert ga[0].float()[..., 0].flatten().tolist() == [1.0, 0.0, 0.0, 0.0]
    want = _jax_side(tmp_path, inputs, "bfloat16")
    np.testing.assert_array_equal(idx.numpy(), want["idx"])
    np.testing.assert_array_equal(ga.float().numpy(), want["ga_r"])
    np.testing.assert_array_equal(ga.float().numpy(), want["ga_v"])
    # float32 keeps the sums apart: the second slot wins
    _, idx32, _, _ = _port_grads(inputs, torch.float32)
    assert (idx32 == 1).all()


def _exact_grads(inputs, idx):
    """ga, gb in float64 from the bfloat16 g: the exact sums."""
    _, _, si, oj, w = (torch.from_numpy(x) for x in inputs)
    g = w.to(torch.bfloat16).double()
    return tpp.pair_pool_bwd_plain(g, idx, si, oj, inputs[0].shape[0])


def test_torch_pair_pool_bwd_bf16_within_one_ulp(jax_side):
    """bfloat16: within one ulp of the custom VJP (float32 sums rounded
    once, as in the port) and within half an ulp of the exact sums."""
    inputs, wants = jax_side
    want = wants["bfloat16"]
    _, idx, ga, gb = _port_grads(inputs, torch.bfloat16)
    exact = _exact_grads(inputs, idx)
    for got, key, ex in ((ga, "ga", exact[0]), (gb, "gb", exact[1])):
        got, ex = got.float().numpy(), ex.numpy()
        ref = want[key + "_v"]
        ulp = _ulp_bf16(np.maximum(np.abs(got), np.abs(ref)))
        assert (np.abs(got - ref) <= ulp).all(), key
        assert (np.abs(got - ex) <= 0.5 * _ulp_bf16(ex)).all(), key


def test_torch_pair_pool_bwd_bf16_vs_xla_reference(jax_side):
    """The XLA reference's bfloat16 gradient (jax.grad of
    pair_pool_reference) scatter-adds in bfloat16, rounding at every add,
    so it lies many ulps from the exact sums where they cancel; the port
    rounds once.  Held: the port is nowhere farther from the exact sums
    than the XLA reference, and strictly closer somewhere."""
    inputs, wants = jax_side
    want = wants["bfloat16"]
    _, idx, ga, gb = _port_grads(inputs, torch.bfloat16)
    exact = _exact_grads(inputs, idx)
    closer = 0
    for got, key, ex in ((ga, "ga", exact[0]), (gb, "gb", exact[1])):
        ex = ex.numpy()
        port_err = np.abs(got.float().numpy() - ex)
        xla_err = np.abs(want[key + "_r"] - ex)
        assert (port_err <= np.maximum(xla_err, 0.5 * _ulp_bf16(ex))).all()
        closer += int((port_err < xla_err).sum())
    assert closer > 0


def test_torch_pair_pool_bwd_f32_matches_jax(rng):
    a, b, si, oj, w = _inputs(rng)
    ja, jb, jw = jnp.asarray(a), jnp.asarray(b), jnp.asarray(w)
    jsi, joj = jnp.asarray(si), jnp.asarray(oj)

    def vjp_loss(a, b):
        return (jax_pair_pool(rearrange_pool_groups(a),
                              rearrange_pool_groups(b), jsi, joj, True, 0)
                * jw).sum()

    def ref_loss(a, b):
        return (pair_pool_reference(a, b, jsi, joj) * jw).sum()

    _, _, ga, gb = _port_grads((a, b, si, oj, w), torch.float32)
    for loss in (vjp_loss, ref_loss):
        want_a, want_b = jax.grad(loss, argnums=(0, 1))(ja, jb)
        np.testing.assert_allclose(ga.numpy(), np.asarray(want_a),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(gb.numpy(), np.asarray(want_b),
                                   atol=1e-6, rtol=0)


def test_torch_pair_pool_bwd_f64_matches_xla_grad(rng):
    a, b, si, oj, w = _inputs(rng)
    with jax.enable_x64():
        want_a, want_b = jax.grad(
            lambda a, b: (pair_pool_reference(a, b, jnp.asarray(si),
                                              jnp.asarray(oj))
                          * jnp.asarray(w, jnp.float64)).sum(),
            argnums=(0, 1))(jnp.asarray(a, jnp.float64),
                            jnp.asarray(b, jnp.float64))
    _, _, ga, gb = _port_grads((a, b, si, oj, w), torch.float64)
    assert ga.dtype == torch.float64
    np.testing.assert_allclose(ga.numpy(), np.asarray(want_a), atol=1e-12,
                               rtol=0)
    np.testing.assert_allclose(gb.numpy(), np.asarray(want_b), atol=1e-12,
                               rtol=0)


def test_torch_pair_pool_grad_equals_autograd_of_plain(rng):
    """The autograd.Function's backward equals PyTorch's own autograd of
    the plain forward (float64: the same sums)."""
    a, b, si, oj, w = (torch.from_numpy(x) for x in _inputs(rng))
    grads = []
    for fn in (tpp.pair_pool, tpp.pair_pool_plain):
        x = a.double().requires_grad_()
        y = b.double().requires_grad_()
        (fn(x, y, si, oj) * w.double()).sum().backward()
        grads.append((x.grad, y.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


@pytest.mark.parametrize("grad_on", [False, True])
def test_torch_pair_pool_dispatch_by_grad(rng, monkeypatch, grad_on):
    """Without a gradient in flight pair_pool runs the index-free forward
    (the eval and serving path); with one, the forward with index and, in
    the backward, the backward."""
    calls = []
    before = (tpp.launches, tpp.idx_launches, tpp.bwd_launches)
    for name in ("pair_pool_plain", "pair_pool_idx_plain",
                 "pair_pool_bwd_plain"):
        fn = getattr(tpp, name)
        monkeypatch.setattr(tpp, name, lambda *args, _f=fn, _n=name: (
            calls.append(_n), _f(*args))[1])
    a, b, si, oj, _ = (torch.from_numpy(x) for x in _inputs(rng))
    a.requires_grad_()
    with torch.set_grad_enabled(grad_on):
        y = tpp.pair_pool(a, b, si, oj)
    if grad_on:
        y.sum().backward()
        assert calls == ["pair_pool_idx_plain", "pair_pool_bwd_plain"]
    else:
        assert calls == ["pair_pool_plain"] and y.grad_fn is None
    with torch.inference_mode():
        tpp.pair_pool(a, b, si, oj)
    assert calls[-1] == "pair_pool_plain"
    # CPU tensors launch nothing
    assert (tpp.launches, tpp.idx_launches, tpp.bwd_launches) == before


@pytest.mark.parametrize("case", ["g_dtype", "idx_dtype", "index_dtype",
                                  "shape", "strided", "cpu"])
def test_torch_pair_pool_bwd_kernel_checks_inputs(rng, case):
    a, b, si, oj, w = (torch.from_numpy(x) for x in _inputs(rng))
    _, idx = tpp.pair_pool_idx_plain(a, b, si, oj)
    g = w.clone()
    if case == "g_dtype":
        g = g.double()
    elif case == "idx_dtype":
        idx = idx.long()
    elif case == "index_dtype":
        si = si.long()
    elif case == "shape":
        idx = idx[:, :2].contiguous()
    elif case == "strided":
        g = g.permute(0, 2, 1, 3)
    with pytest.raises((TypeError, ValueError)):
        tpp.pair_pool_bwd_kernel(g, idx, si, oj, a.shape[0])
    with pytest.raises(ValueError):           # never handed CPU tensors
        tpp.pair_pool_idx_kernel(a, b, si.int(), oj)


def test_torch_pair_lists_group_pairs_by_object():
    si = torch.tensor([2, 0, 4, 4, 3, 3, 1, 4, 0], dtype=torch.int32)
    oj = torch.tensor([1, 2, 0, 2, 2, 4, 2, 1, 2], dtype=torch.int32)
    m = 5
    offsets, lists = tpp.pair_lists(si, oj, m)
    assert offsets.dtype == lists.dtype == torch.int32
    assert offsets[0] == 0 and offsets[-1] == 2 * len(si)
    for o in range(2 * m):
        run = lists[offsets[o]:offsets[o + 1]].tolist()
        owner = si if o < m else oj
        want = [q for q in range(len(si)) if owner[q] == o % m]
        assert run == want, o
