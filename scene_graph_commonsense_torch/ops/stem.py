"""The ResNet stem of the DETR-101 trunk: 7x7/2 conv, frozen BN, ReLU and
the 3x3/2 max pool.

  stem_conv_pool_kernel / stem_conv_pool_plain  (`conv_pool_launches`)
      csrc/stem.cu `sgc_stem_conv_pool`, the port of the TPU kernel
      `_conv_pool_kernel` of scene_graph_commonsense_tpu/ops/pallas/stem.py
      (through `stem_conv_pool`): the whole stem in one pass, images
      (B, H, W, 3) with H and W divisible by 8 -> (B, H/4, W/4, 64).
  stem_pool_kernel / stem_pool_plain  (`pool_launches`)
      csrc/stem.cu `sgc_stem_pool`, the port of the TPU `_kernel` of the
      same file (through `stem_pool`): BN + ReLU + pool over a stem conv
      output (B, H, W, C) with H and W even -> (B, H/2, W/2, C).

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

STEM_CHANNELS = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def check_conv_pool_inputs(images, w7, fold) -> None:
    """Raises on anything the stem kernel does not take."""
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
                          fold: torch.Tensor) -> torch.Tensor:
    """Launches csrc/stem.cu's conv + pool on the current stream of the
    images' device and counts the launch; the compute dtype is w7's."""
    global conv_pool_launches
    _build.need_cuda("stem_conv_pool_kernel", images)
    check_conv_pool_inputs(images, w7, fold)
    b, h, w, _ = images.shape
    out = torch.empty((b, h // 4, w // 4, STEM_CHANNELS), dtype=w7.dtype,
                      device=images.device)
    fn = _build.load("stem").sgc_stem_conv_pool
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(images.device).cuda_stream
    _build.check_launch("stem_conv_pool", fn(
        images.data_ptr(), w7.data_ptr(), fold.data_ptr(), out.data_ptr(),
        b, h, w, _DTYPE_CODES[w7.dtype], images.device.index, stream))
    conv_pool_launches += 1
    return out


def stem_pool_kernel(conv_out: torch.Tensor,
                     fold: torch.Tensor) -> torch.Tensor:
    """Launches csrc/stem.cu's BN + ReLU + pool and counts the launch."""
    global pool_launches
    _build.need_cuda("stem_pool_kernel", conv_out)
    check_pool_inputs(conv_out, fold)
    b, h, w, c = conv_out.shape
    out = torch.empty((b, h // 2, w // 2, c), dtype=conv_out.dtype,
                      device=conv_out.device)
    fn = _build.load("stem").sgc_stem_pool
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(conv_out.device).cuda_stream
    _build.check_launch("stem_pool", fn(
        conv_out.data_ptr(), fold.data_ptr(), out.data_ptr(), b, h, w, c,
        _DTYPE_CODES[conv_out.dtype], conv_out.device.index, stream))
    pool_launches += 1
    return out


def stem_conv_pool(images: torch.Tensor, w7: torch.Tensor, fold: torch.Tensor,
                   *, compute_dtype: torch.dtype) -> torch.Tensor:
    """The whole stem on the images' device: (B, H, W, 3), H and W divisible
    by 8 -> (B, H/4, W/4, 64) in the compute dtype.  The images are taken
    as float32 (a bfloat16 image widens exactly) and the kernel weights
    cast to the compute dtype, as the JAX caller casts them."""
    images = images.to(torch.float32).contiguous()
    w7 = w7.to(compute_dtype).contiguous()
    fold = fold.to(torch.float32).contiguous()
    plain = functools.partial(stem_conv_pool_plain,
                              compute_dtype=compute_dtype)
    return _build.route("stem_conv_pool", images, stem_conv_pool_kernel,
                        plain)(images, w7, fold)


def stem_pool(conv_out: torch.Tensor, fold: torch.Tensor) -> torch.Tensor:
    """relu(BN(conv_out)) max-pooled 3x3/2 (pad 1) on conv_out's device:
    (B, H, W, C), H and W even -> (B, H/2, W/2, C) in conv_out's dtype."""
    return _build.route("stem_pool", conv_out, stem_pool_kernel,
                        stem_pool_plain)(conv_out.contiguous(),
                                         fold.to(torch.float32).contiguous())
