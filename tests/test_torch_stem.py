"""The port's ResNet stem (ops/stem.py: the plain versions of the
stem_conv_pool and stem_pool kernels, which the wrappers run for CPU
tensors) against the JAX package's Pallas kernels in interpret mode, on the
same numpy inputs.

Tolerances: float32 within 1e-5 of the output's scale (max |JAX|): conv
sums of 147 products in another order (stem_pool, which sums nothing,
within 1e-6); bfloat16 compute: the port's largest error against the JAX
kernel's float32 result on the same float32 inputs is at most 2x the JAX
bf16 kernel's own.

The bfloat16 CUDA kernel (stem_conv_pool_hopper) computes the TPU kernel's
space-to-depth product; its weight matrix is checked against the JAX
package's `_build_stem_weights` exactly, and its arrangement (planes, tap
offsets, the two-parity product, the pool over cells across chunk edges)
is emulated here in float64 against the plain version within 1e-8 (sums
of ~147 products in another order).  So is the stem-pool kernel's tile walk
(stem_pool_hopper: TMA boxes with zeros outside the image, BN + ReLU once a
staged element, 0 outside the image, the 3-row max written over the
patch, then the 3-column max), within 1e-12: it sums nothing."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_graph_commonsense_tpu.ops.pallas import stem as js
from scene_graph_commonsense_torch.ops import stem as ts


def _fold(rng, c):
    return np.stack([rng.uniform(0.5, 1.5, c),
                     rng.normal(0, 0.2, c)]).astype(np.float32)


def _check(got, want, truth, dtype, f32_tol):
    assert got.shape == want.shape
    if dtype == "float32":
        assert np.abs(got - want).max() <= f32_tol * np.abs(want).max()
    else:
        err = np.abs(got - truth).max()
        jax_err = np.abs(want - truth).max()
        assert err <= 2 * jax_err, (err, jax_err)


def _jax_conv_pool(images, w7, fold, dtype):
    fn = jax.jit(lambda x, w, s: js.stem_conv_pool(
        x.astype(jnp.dtype(dtype)), w, s, interpret=True))
    out = fn(jnp.asarray(images), jnp.asarray(w7), jnp.asarray(fold))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_stem_conv_pool_matches_jax(dtype):
    """(2, 32, 48, 3): 8 x 12 pool outputs, so the first and last rows and
    columns (conv zero padding, pool -inf padding) are a large share."""
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    w7 = (rng.standard_normal((7, 7, 3, 64)) / np.sqrt(147)).astype(
        np.float32)
    fold = _fold(rng, 64)
    want = _jax_conv_pool(images, w7, fold, dtype)
    truth = _jax_conv_pool(images, w7, fold, "float32")
    got = ts.stem_conv_pool(torch.from_numpy(images), torch.from_numpy(w7),
                            torch.from_numpy(fold),
                            compute_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, 8, 12, 64)
    _check(got.float().numpy(), want, truth, dtype, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 10, 14, 64), (1, 18, 6, 64)])
def test_torch_stem_pool_matches_jax(shape, dtype):
    """Conv outputs of images that are even but not divisible by 8 (the
    route that takes stem_pool): H/2 and W/2 odd, so the last pool window
    of a row or column reaches the bottom/right edge."""
    rng = np.random.default_rng(1)
    conv = rng.standard_normal(shape).astype(np.float32)
    fold = _fold(rng, shape[-1])
    fn = jax.jit(lambda x, s: js.stem_pool(x, s, interpret=True))

    def run_jax(dt):
        x = jnp.asarray(conv).astype(jnp.dtype(dt))
        return np.asarray(fn(x, jnp.asarray(fold)).astype(jnp.float32))

    want = run_jax(dtype)
    got = ts.stem_pool(torch.from_numpy(conv).to(getattr(torch, dtype)),
                       torch.from_numpy(fold))
    assert got.dtype == getattr(torch, dtype)
    _check(got.float().numpy(), want, run_jax("float32"), dtype, 1e-6)


def test_torch_stem_routes_by_device():
    """CPU tensors run the plain versions without touching the launch
    counters; the kernel entry points refuse CPU tensors."""
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.standard_normal((1, 16, 8, 3)).astype(
        np.float32))
    w7 = torch.zeros((7, 7, 3, 64))
    fold = torch.from_numpy(_fold(rng, 64))
    before = (ts.conv_pool_launches, ts.pool_launches)
    out = ts.stem_conv_pool(images, w7, fold, compute_dtype=torch.bfloat16)
    assert out.shape == (1, 4, 2, 64) and out.dtype == torch.bfloat16
    # a zero kernel: every output is relu(shift) rounded once
    want = torch.relu(fold[1]).to(torch.bfloat16)
    assert torch.equal(out, want.expand_as(out))
    assert (ts.conv_pool_launches, ts.pool_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        ts.stem_conv_pool_kernel(images, w7, fold)
    with pytest.raises(ValueError, match="CUDA"):
        ts.stem_pool_kernel(torch.zeros((1, 4, 4, 64)), fold)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_stem_weights_equal_jax(dtype):
    """The port's (288, 128) space-to-depth matrix is the JAX package's
    `_build_stem_weights`, bit for bit, and the kernel layout holds its
    rows in step order."""
    rng = np.random.default_rng(3)
    w7 = rng.standard_normal((7, 7, 3, 64)).astype(np.float32)
    want = np.asarray(js._build_stem_weights(
        jnp.asarray(w7), jnp.dtype(dtype)).astype(jnp.float32))
    got = ts.stem_weights(torch.from_numpy(w7), getattr(torch, dtype))
    assert got.shape == (288, 128) and got.dtype == getattr(torch, dtype)
    assert np.array_equal(got.float().numpy(), want)
    wk = ts.stem_kernel_weights(torch.from_numpy(w7))
    assert wk.shape == (18, 16, 2, 8, 8) and wk.dtype == torch.bfloat16
    steps = wk.permute(0, 2, 3, 1, 4).reshape(18, 16, 128)
    wb = np.asarray(js._build_stem_weights(
        jnp.asarray(w7), jnp.bfloat16).astype(jnp.float32))
    for d2 in range(2):
        for cs in range(3):
            for j in range(3):
                s = (d2 * 3 + cs) * 3 + j
                for half, du in enumerate((d2, d2 + 2)):
                    k0 = (du * 3 + cs) * 24 + 8 * j
                    assert np.array_equal(
                        steps[s, 8 * half:8 * half + 8].float().numpy(),
                        wb[k0:k0 + 8])


def _emulate_hopper(images, w7, fold):
    """stem_conv_pool_hopper's arrangement in float64 tensor indexing:
    bands of HOPPER_ROWS pool rows walked in chunks of HOPPER_CELLS cells;
    per chunk the staged planes (3, 2R + 4 s2d rows, 66 cells, 8 values),
    zero outside the image; per conv row the 18 k16 steps, each the A
    rows (chunk j of tap group (d2, cs) beside that of (d2 + 2, cs)) times
    the step's 16 x 128 block of `stem_kernel_weights`; BN, ReLU, -inf for
    conv row -1; vertical max over conv rows, then each cell's two parities
    and the previous cell's odd one, carried across chunks."""
    rr, tc = ts.HOPPER_ROWS, ts.HOPPER_CELLS
    f = torch.float64
    b, h, w, _ = images.shape
    hp, wp = h // 4, w // 4
    bands, chunks = math.ceil(hp / rr), math.ceil(wp / tc)
    s2d = images.to(f).reshape(b, h // 2, 2, w // 4, 4, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 4, 24)
    # s2d row u at u + 3, cell t at t + 1; zeros cover every patch
    pad = torch.zeros((b, 3 + bands * 2 * rr + 4, 2 + chunks * tc, 24),
                      dtype=f)
    pad[:, 3:3 + h // 2, 1:1 + w // 4] = s2d
    steps = ts._gather_taps(w7.to(f), ts._kernel_taps()).permute(
        0, 2, 3, 1, 4).reshape(ts.HOPPER_STEPS, 16, 128)
    sc = fold[0].to(f).repeat(2)
    sh = fold[1].to(f).repeat(2)
    neg = torch.tensor(float("-inf"), dtype=f)
    out = torch.full((b, hp, wp, 64), float("nan"), dtype=f)
    for bi in range(b):
        for band in range(bands):
            py0 = band * rr
            rows = min(rr, hp - py0)
            edge = None                     # previous chunk's last cell
            for c in range(chunks):
                c0 = c * tc
                u0 = 2 * py0 - 3
                planes = pad[bi, u0 + 3:u0 + 3 + 2 * rr + 4,
                             c0:c0 + tc + 2].reshape(
                    2 * rr + 4, tc + 2, 3, 8).permute(2, 0, 1, 3)
                conv = []
                for r in range(2 * rows + 1):
                    acc = torch.zeros((tc, 128), dtype=f)
                    for d2 in range(2):
                        for cs in range(3):
                            for j in range(3):
                                a = torch.cat(
                                    [planes[j, r + d2, cs:cs + tc],
                                     planes[j, r + d2 + 2, cs:cs + tc]], 1)
                                acc += a @ steps[(d2 * 3 + cs) * 3 + j]
                    v = torch.relu(acc * sc + sh)
                    conv.append(v if 2 * py0 - 1 + r >= 0
                                else torch.full_like(v, neg))
                new_edge = []
                for i in range(rows):
                    m = torch.maximum(torch.maximum(conv[2 * i],
                                                    conv[2 * i + 1]),
                                      conv[2 * i + 2])
                    even, odd = m[:, :64], m[:, 64:]
                    first = edge[i] if edge is not None \
                        else torch.full((1, 64), neg, dtype=f)
                    prev = torch.cat([first, odd[:-1]])
                    new_edge.append(odd[-1:])
                    pool = torch.maximum(torch.maximum(even, odd), prev)
                    n = min(tc, wp - c0)
                    out[bi, py0 + i, c0:c0 + n] = pool[:n]
                edge = new_edge
    return out


@pytest.mark.parametrize("shape", [(2, 40, 280, 3), (1, 8, 8, 3),
                                   (1, 24, 520, 3)])
def test_torch_stem_hopper_arrangement_matches_plain(shape):
    """(2, 40, 280): H/4 = 10 pool rows (bands of 4, the last partial) and
    W/4 = 70 cells (a full chunk and a partial one, the pool window of
    column 64 across the chunk edge); (1, 8, 8): one image smaller than a
    tile; (1, 24, 520): 6 pool rows and 130 cells, three chunks."""
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.standard_normal(shape))
    w7 = torch.from_numpy(rng.standard_normal((7, 7, 3, 64)) / np.sqrt(147))
    fold = torch.from_numpy(_fold(rng, 64).astype(np.float64))
    got = _emulate_hopper(images, w7, fold)
    want = ts.stem_conv_pool_plain(images, w7, fold,
                                   compute_dtype=torch.float64)
    assert got.shape == want.shape
    assert not torch.isnan(got).any()
    assert (got - want).abs().max().item() <= 1e-8


def _emulate_pool_tiles(conv, fold, itemsize):
    """stem_pool_hopper's tile walk in float64, for a compute dtype of
    `itemsize` bytes: tiles of POOL_ROWS x POOL_COLS pool outputs x a chunk
    of up to POOL_CHUNK_BYTES of channels, in the kernel's order (image,
    tile row, tile column, chunk); per tile the (2 R + 1) x (2 TW + 1)
    conv patch from one conv row and column before the tile, zero outside
    the tensor (TMA's fill); BN + ReLU per staged element, 0 outside the
    image; the 3-row max of rows 2 i .. 2 i + 2 written over patch row i
    in place, for the tile's rows; then the 3-column max of columns
    2 j .. 2 j + 2 of those rows, stored for the channels below C."""
    pr, pc = ts.POOL_ROWS, ts.POOL_COLS
    f = torch.float64
    b, h, w, c = conv.shape
    ho, wo = h // 2, w // 2
    cc = min(c, ts.POOL_CHUNK_BYTES // itemsize)
    chunks = math.ceil(c / cc)
    tiles_x, tiles_y = math.ceil(wo / pc), math.ceil(ho / pr)
    x = conv.to(f)
    out = torch.full((b, ho, wo, c), float("nan"), dtype=f)
    for tile in range(b * tiles_y * tiles_x * chunks):
        chunk, rest = tile % chunks, tile // chunks
        tx, rest = rest % tiles_x, rest // tiles_x
        ty, bi = rest % tiles_y, rest // tiles_y
        py0, px0, c0 = ty * pr, tx * pc, chunk * cc
        n = min(cc, c - c0)
        y0, x0 = 2 * py0 - 1, 2 * px0 - 1
        ys = range(max(y0, 0), min(y0 + 2 * pr + 1, h))
        xs = range(max(x0, 0), min(x0 + 2 * pc + 1, w))
        patch = torch.zeros((2 * pr + 1, 2 * pc + 1, cc), dtype=f)
        inside = torch.zeros((2 * pr + 1, 2 * pc + 1, 1), dtype=torch.bool)
        rows_in = slice(ys.start - y0, ys.stop - y0)
        cols_in = slice(xs.start - x0, xs.stop - x0)
        patch[rows_in, cols_in, :n] = x[bi, ys.start:ys.stop,
                                        xs.start:xs.stop, c0:c0 + n]
        inside[rows_in, cols_in] = True
        sc = torch.zeros(cc, dtype=f)
        sh = torch.zeros(cc, dtype=f)
        sc[:n], sh[:n] = fold[0, c0:c0 + n], fold[1, c0:c0 + n]
        val = torch.where(inside, torch.relu(patch * sc + sh), 0.0)
        rows, cols = min(pr, ho - py0), min(pc, wo - px0)
        for i in range(rows):
            val[i] = torch.maximum(torch.maximum(val[2 * i], val[2 * i + 1]),
                                   val[2 * i + 2])
        for i in range(rows):
            for j in range(cols):
                m = torch.maximum(torch.maximum(val[i, 2 * j],
                                                val[i, 2 * j + 1]),
                                  val[i, 2 * j + 2])
                out[bi, py0 + i, px0 + j, c0:c0 + n] = m[:n]
    return out


@pytest.mark.parametrize("shape,itemsize", [
    ((2, 18, 42, 64), 2), ((1, 2, 2, 64), 2), ((1, 10, 14, 5), 2),
    ((2, 12, 20, 24), 2), ((2, 12, 20, 24), 4), ((1, 10, 70, 40), 4)],
    ids=["partial_tiles", "lone_2x2", "c5", "c24_bf16", "c24_f32",
         "c40_two_chunks"])
def test_torch_stem_pool_tile_walk_matches_plain(shape, itemsize):
    """(2, 18, 42, 64): 9 x 21 pool outputs, a partial tile in both rows (1
    of 4) and columns (5 of 16); (1, 2, 2, 64): one pool output, its patch
    mostly outside the image; C = 5 (a 10-byte channel row, which takes
    stem_pool_kernel on the card, but the walk holds for it) and C = 24
    (3 vectors of a pixel in bf16, 6 in float32); (1, 10, 70, 40) in
    float32: chunks of 32 channels, the second partial, and 3 tile
    columns."""
    rng = np.random.default_rng(5)
    conv = torch.from_numpy(rng.standard_normal(shape))
    fold = torch.from_numpy(_fold(rng, shape[-1]).astype(np.float64))
    got = _emulate_pool_tiles(conv, fold, itemsize)
    want = ts.stem_pool_plain(conv, fold)
    assert got.shape == want.shape
    assert not torch.isnan(got).any()
    assert (got - want).abs().max().item() <= 1e-12
