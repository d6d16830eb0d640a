"""The ResNet stem of the DETR-101 trunk: 7x7/2 conv, frozen BN, ReLU and
the 3x3/2 max pool.

  stem_conv_pool_kernel / stem_conv_pool_plain  (`conv_pool_launches`)
      csrc/stem.cu `sgc_stem_conv_pool`, the port of the TPU kernel
      `_conv_pool_kernel` of scene_graph_commonsense_tpu/ops/pallas/stem.py
      (through `stem_conv_pool`): the whole stem in one pass, images
      (B, H, W, 3) with H and W divisible by 8 -> (B, H/4, W/4, 64).
      bfloat16 runs `stem_conv_pool_hopper` (wgmma over the TPU kernel's
      space-to-depth product; its weights are `stem_kernel_weights`),
      float32 the tile_gemm kernel on the 147 taps.
  stem_pool_kernel / stem_pool_plain  (`pool_launches`)
      csrc/stem.cu `sgc_stem_pool`, the port of the TPU `_kernel` of the
      same file (through `stem_pool`): BN + ReLU + pool over a stem conv
      output (B, H, W, C) with H and W even -> (B, H/2, W/2, C).  The C
      entry point chooses `stem_pool_hopper` (TMA-staged tiles of
      POOL_ROWS x POOL_COLS pool outputs, a separable max) where a pixel's
      channels fill whole 16-byte vectors and the tensors are 16-byte
      aligned, else the one-thread-per-output `stem_pool_kernel`; the
      launch records its choice in `last_pool_kernel`.

Rounding points (the TPU kernels'): the images and the weights are
rounded to the compute dtype and the conv sums their products in float32;
BN (a float32 multiply then add on the float32 sums, or on the conv output
widened to float32), ReLU and the pool (padding -inf) run in float32; one
rounding to the compute dtype at the end.  The kernel reads float32 images
and rounds each pixel as it reads it (the JAX caller casts the images in a
pass of its own: the same numbers).

`stem_conv_pool` and `stem_pool` are what callers use: the kernel for CUDA
tensors, the plain version for CPU tensors, an error anywhere else; never
a fallback.  w7 is the flax (7, 7, 3, 64) kernel; folds are float32
(2, C) from ops/bottleneck.fold_bn.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from scene_graph_commonsense_torch.ops import _build

conv_pool_launches = 0    # stem_conv_pool_kernel launches since the reset
pool_launches = 0         # stem_pool_kernel launches since the reset
last_pool_kernel = None   # the CUDA kernel the last stem-pool launch ran

STEM_CHANNELS = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# stem_conv_pool_hopper's tile (csrc/stem.cu kR, kCells, kWG): a band of
# HOPPER_ROWS pool rows walked in chunks of HOPPER_CELLS space-to-depth
# cells (pool columns), the wgmma's 64 rows, by one of the
# HOPPER_WARPGROUPS warpgroups of a block (at most one block per SM)
HOPPER_ROWS = 4
HOPPER_CELLS = 64
HOPPER_WARPGROUPS = 3
# its k16 steps: (d2, cs, j) for d2 < 2, cs < 3, j < 3, each pairing chunk j
# (8 of a cell's 24 values) of tap group (d2, cs) with that of (d2 + 2, cs)
HOPPER_STEPS = 18
# stem_pool_hopper's tile (csrc/stem.cu kPoolRows, kPoolCols, kChunkBytes):
# POOL_ROWS x POOL_COLS pool outputs x up to POOL_CHUNK_BYTES of a pixel's
# channels, staged as a (2 POOL_ROWS + 1) x (2 POOL_COLS + 1)-pixel conv
# patch
POOL_ROWS = 4
POOL_COLS = 16
POOL_CHUNK_BYTES = 128


@functools.lru_cache(maxsize=None)
def _stem_taps() -> torch.Tensor:
    """(288, 128): the flat (7, 7, 3, 64) index of w7 that each entry of
    `stem_weights` holds, -1 for a zero (the algebra of the JAX package's
    `_build_stem_weights`).

    K rows (du, cs, a, m, c): du the space-to-depth row tap, cs the cell
    column tap (cells t - 1, t, t + 1), (a, m) the raw pixel inside the
    2 x 4 cell, c RGB; N columns (pi, o): the output column's parity and
    channel.  Entry w7[ky, kx, c, o] with ky = 2 du + a - 1 and kx =
    4 (cs - 1) + m - 2 pi + 3, zero where the tap leaves the 7 x 7
    support."""
    idx = torch.full((4, 3, 2, 4, 3, 2, STEM_CHANNELS), -1, dtype=torch.long)
    co = torch.arange(3)[:, None] * STEM_CHANNELS \
        + torch.arange(STEM_CHANNELS)
    for du in range(4):
        for a in range(2):
            ky = 2 * du + a - 1
            if not 0 <= ky < 7:
                continue
            for cs in range(3):
                for m in range(4):
                    for pi in range(2):
                        kx = 4 * (cs - 1) + m - 2 * pi + 3
                        if 0 <= kx < 7:
                            idx[du, cs, a, m, :, pi, :] = \
                                (ky * 7 + kx) * 3 * STEM_CHANNELS + co
    return idx.reshape(288, 2 * STEM_CHANNELS)


def _gather_taps(w7: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    # index -1 reads the zero appended after w7's entries
    flat = torch.cat([w7.reshape(-1), w7.new_zeros(1)])
    return flat[idx.to(w7.device)]


def stem_weights(w7: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The (7, 7, 3, 64) stem kernel as the TPU kernel's (288, 128)
    space-to-depth matrix in `dtype` (`_stem_taps` has the layout)."""
    return _gather_taps(w7, _stem_taps()).to(dtype)


@functools.lru_cache(maxsize=None)
def _step_rows() -> torch.Tensor:
    """(18, 16): the rows of the (288, 128) matrix that k16 step
    s = (d2 * 3 + cs) * 3 + j reads, in order: values 8 j .. 8 j + 7 of tap
    group (d2, cs), then of (d2 + 2, cs)."""
    rows = [(du * 3 + cs) * 24 + 8 * j + k
            for d2 in range(2) for cs in range(3) for j in range(3)
            for du in (d2, d2 + 2) for k in range(8)]
    return torch.tensor(rows).reshape(HOPPER_STEPS, 16)


@functools.lru_cache(maxsize=None)
def _kernel_taps() -> torch.Tensor:
    # (step, N block, K half, K row, N column) of the step rows' taps
    return _stem_taps()[_step_rows()].reshape(
        HOPPER_STEPS, 2, 8, 16, 8).permute(0, 3, 1, 2, 4).contiguous()


def stem_kernel_weights(w7: torch.Tensor) -> torch.Tensor:
    """`stem_weights` in bfloat16 as stem_conv_pool_hopper keeps it in
    shared memory: per k16 step (`_step_rows`), wgmma's MN-major core
    matrices (8 K rows x 8 N columns, 128 contiguous bytes), the two K
    halves 128 bytes apart, the 16 column blocks 256 bytes apart.
    (18, 16, 2, 8, 8) = (step, N block, K half, K row, N column), 73,728
    bytes, built by one gather."""
    return _gather_taps(w7, _kernel_taps()).to(torch.bfloat16)


def _bn_relu_pool(v: torch.Tensor, fold: torch.Tensor) -> torch.Tensor:
    """float32 NCHW -> relu(v * scale + shift) max-pooled 3x3/2, pad -inf."""
    v = torch.relu(v * fold[0][:, None, None] + fold[1][:, None, None])
    return F.max_pool2d(v, 3, stride=2, padding=1)


def stem_conv_pool_plain(images: torch.Tensor, w7: torch.Tensor,
                         fold: torch.Tensor, *,
                         compute_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the stem kernel's math."""
    f32 = torch.promote_types(compute_dtype, torch.float32)
    x = images.to(compute_dtype).to(f32).permute(0, 3, 1, 2)
    conv = F.conv2d(x, w7.to(compute_dtype).to(f32).permute(3, 2, 0, 1),
                    stride=2, padding=3)
    out = _bn_relu_pool(conv, fold.to(f32))
    return out.to(compute_dtype).permute(0, 2, 3, 1).contiguous()


def stem_pool_plain(conv_out: torch.Tensor,
                    fold: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the stem-pool kernel's math."""
    f32 = torch.promote_types(conv_out.dtype, torch.float32)
    v = conv_out.to(f32).permute(0, 3, 1, 2)
    out = _bn_relu_pool(v, fold.to(f32))
    return out.to(conv_out.dtype).permute(0, 2, 3, 1).contiguous()


def _check_common(name, t, fold, channels) -> None:
    if fold.dtype != torch.float32 or fold.shape != (2, channels):
        raise ValueError(f"{name} takes a float32 (2, {channels}) BN fold, "
                         f"got {fold.dtype} {tuple(fold.shape)}")
    if fold.device != t.device:
        raise ValueError(f"{name} inputs lie on different devices")
    if not (t.is_contiguous() and fold.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def check_conv_pool_inputs(images, w7, fold, wk=None) -> None:
    """Raises on anything the stem kernel does not take.  Both compute
    dtypes take every shape accepted here: stem_conv_pool_hopper (bfloat16)
    masks partial bands, partial chunks and images smaller than one tile
    itself; wk is its weight matrix (`stem_kernel_weights`)."""
    if images.dtype != torch.float32 or w7.dtype not in _DTYPE_CODES:
        raise TypeError(f"stem_conv_pool takes float32 images and float32 "
                        f"or bfloat16 weights, got {images.dtype}, "
                        f"{w7.dtype}")
    if images.dim() != 4 or images.shape[3] != 3 or images.shape[0] < 1 \
            or images.shape[1] < 8 or images.shape[2] < 8 \
            or images.shape[1] % 8 or images.shape[2] % 8:
        raise ValueError(f"stem_conv_pool takes (B, H, W, 3) images with H "
                         f"and W divisible by 8, got {tuple(images.shape)}")
    if w7.shape != (7, 7, 3, STEM_CHANNELS):
        raise ValueError(f"stem_conv_pool takes a (7, 7, 3, 64) kernel, got "
                         f"{tuple(w7.shape)}")
    _check_common("stem_conv_pool", images, fold, STEM_CHANNELS)
    if w7.device != images.device or not w7.is_contiguous():
        raise ValueError("stem_conv_pool takes a contiguous kernel on the "
                         "images' device")
    if w7.data_ptr() % 16:
        raise ValueError("stem_conv_pool reads the kernel in 16-byte "
                         "vectors: its storage must be 16-byte aligned")
    if w7.dtype == torch.bfloat16:
        if images.data_ptr() % 16:
            raise ValueError("stem_conv_pool reads bfloat16-compute images "
                             "in 16-byte vectors: their storage must be "
                             "16-byte aligned")
        if wk is None or wk.dtype != torch.bfloat16 \
                or wk.shape != (HOPPER_STEPS, 16, 2, 8, 8) \
                or wk.device != images.device or not wk.is_contiguous() \
                or wk.data_ptr() % 16:
            raise ValueError("stem_conv_pool in bfloat16 takes wk, the "
                             "contiguous, 16-byte aligned "
                             "stem_kernel_weights on the images' device")


def check_pool_inputs(conv_out, fold) -> None:
    """Raises on anything the stem-pool kernel does not take."""
    if conv_out.dtype not in _DTYPE_CODES:
        raise TypeError(f"stem_pool takes float32 or bfloat16, got "
                        f"{conv_out.dtype}")
    if conv_out.dim() != 4 or min(conv_out.shape) < 1 \
            or conv_out.shape[1] % 2 or conv_out.shape[2] % 2:
        raise ValueError(f"stem_pool takes (B, H, W, C) with H and W even, "
                         f"got {tuple(conv_out.shape)}")
    _check_common("stem_pool", conv_out, fold, conv_out.shape[3])


def stem_conv_pool_kernel(images: torch.Tensor, w7: torch.Tensor,
                          fold: torch.Tensor,
                          wk: torch.Tensor = None) -> torch.Tensor:
    """Launches csrc/stem.cu's conv + pool on the current stream of the
    images' device and counts the launch; the compute dtype is w7's.  In
    bfloat16 the kernel reads wk, `stem_kernel_weights(w7)`, built here
    when not given (callers that launch often keep it: the fused trunk's
    `prepared`)."""
    global conv_pool_launches
    _build.need_cuda("stem_conv_pool_kernel", images)
    if wk is None and w7.dtype == torch.bfloat16:
        wk = stem_kernel_weights(w7)
    check_conv_pool_inputs(images, w7, fold, wk)
    b, h, w, _ = images.shape
    out = torch.empty((b, h // 4, w // 4, STEM_CHANNELS), dtype=w7.dtype,
                      device=images.device)
    fn = _build.load("stem").sgc_stem_conv_pool
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(images.device).cuda_stream
    wmat = wk if w7.dtype == torch.bfloat16 else w7
    _build.check_launch("stem_conv_pool", fn(
        images.data_ptr(), wmat.data_ptr(), fold.data_ptr(), out.data_ptr(),
        b, h, w, _DTYPE_CODES[w7.dtype], images.device.index, stream))
    conv_pool_launches += 1
    return out


def stem_pool_kernel(conv_out: torch.Tensor,
                     fold: torch.Tensor) -> torch.Tensor:
    """Launches csrc/stem.cu's BN + ReLU + pool and counts the launch
    (either of its two kernels: `last_pool_kernel` names the one that
    ran)."""
    global pool_launches, last_pool_kernel
    _build.need_cuda("stem_pool_kernel", conv_out)
    check_pool_inputs(conv_out, fold)
    b, h, w, c = conv_out.shape
    out = torch.empty((b, h // 2, w // 2, c), dtype=conv_out.dtype,
                      device=conv_out.device)
    fn = _build.load("stem").sgc_stem_pool
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    stream = torch.cuda.current_stream(conv_out.device).cuda_stream
    chosen = ctypes.c_int(-1)
    _build.check_launch("stem_pool", fn(
        conv_out.data_ptr(), fold.data_ptr(), out.data_ptr(), b, h, w, c,
        _DTYPE_CODES[conv_out.dtype], conv_out.device.index, stream,
        ctypes.byref(chosen)))
    pool_launches += 1
    last_pool_kernel = ("stem_pool_kernel", "stem_pool_hopper")[chosen.value]
    return out


def stem_conv_pool(images: torch.Tensor, w7: torch.Tensor, fold: torch.Tensor,
                   *, compute_dtype: torch.dtype,
                   wk: torch.Tensor = None) -> torch.Tensor:
    """The whole stem on the images' device: (B, H, W, 3), H and W divisible
    by 8 -> (B, H/4, W/4, 64) in the compute dtype.  The images are taken
    as float32 (a bfloat16 image widens exactly) and the kernel weights
    cast to the compute dtype, as the JAX caller casts them; wk, the
    bfloat16 kernel's `stem_kernel_weights(w7)`, is built per call when not
    given."""
    images = images.to(torch.float32).contiguous()
    w7 = w7.to(compute_dtype).contiguous()
    fold = fold.to(torch.float32).contiguous()
    kernel = functools.partial(stem_conv_pool_kernel, wk=wk)
    plain = functools.partial(stem_conv_pool_plain,
                              compute_dtype=compute_dtype)
    return _build.route("stem_conv_pool", images, kernel, plain)(
        images, w7, fold)


def stem_pool(conv_out: torch.Tensor, fold: torch.Tensor) -> torch.Tensor:
    """relu(BN(conv_out)) max-pooled 3x3/2 (pad 1) on conv_out's device:
    (B, H, W, C), H and W even -> (B, H/2, W/2, C) in conv_out's dtype."""
    return _build.route("stem_pool", conv_out, stem_pool_kernel,
                        stem_pool_plain)(conv_out.contiguous(),
                                         fold.to(torch.float32).contiguous())
