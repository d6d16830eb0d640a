"""The CUDA attention kernel (csrc/attention.cu) against its plain PyTorch
version, on the card, at a small shape with a ragged query tile and at the
DETR encoder's (B = 12 and 24, L = 1024, H = 8, dh = 32), also with scores
of large magnitude and with the key mask of the 1000^2 detection canvas.

Imports neither JAX nor the repo's conftest, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_cuda.py

Where there is no card each test skips.  Tolerances: float32 within 1e-5
(absolute and relative) of the plain version, whose sums run in another
order; bfloat16: the kernel's largest error against a float64 truth on the
same inputs is at most 2x the plain version's (p is rounded to bf16 in both,
so one rounding that falls the other way moves an output by a bf16 ulp of
p)."""

import math

import numpy as np
import pytest
import torch

from scene_graph_commonsense_torch.ops import attention as tattn

SCALE = 1.0 / math.sqrt(32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dtype, b, l, h, mask, seed=0, qk_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, l, h, 32),
                                                    np.float32) * f)
               .to(device, dtype) for f in (qk_scale, qk_scale, 1.0))
    valid = None
    if mask == "random":                      # 80% of the keys masked
        valid = torch.from_numpy(rng.random((b, l)) < 0.2).to(device)
        valid[:, 0] = True
    elif mask == "one_image_masked":          # every key of image 0 masked
        valid = torch.ones((b, l), dtype=torch.bool, device=device)
        valid[0] = False
    return q, k, v, valid


def _truth(q, k, v, valid):
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * SCALE
    if valid is not None:
        s = torch.where(valid[:, None, None, :], s,
                        torch.tensor(-3.0e38, dtype=torch.float64,
                                     device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.double())


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["none", "random", "one_image_masked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 192, 3), (12, 1024, 8),
                                   (24, 1024, 8)])
def test_torch_attention_kernel_matches_plain(cuda_device, shape, dtype,
                                              mask):
    _check(*_inputs(cuda_device, getattr(torch, dtype), *shape, mask), mask)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["none", "random", "one_image_masked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_attention_kernel_large_scores(cuda_device, dtype, mask):
    """q and k x 30: |s - max| reaches the thousands, so the exponentials
    meet arguments far below -126 (flushed to 0) beside the -3e38 fill."""
    _check(*_inputs(cuda_device, getattr(torch, dtype), 12, 1024, 8, mask,
                    seed=1, qk_scale=30.0), mask)


def _check(q, k, v, valid, mask):
    dtype = str(q.dtype).split(".")[1]
    before = tattn.launches
    got = tattn.fused_attention(q, k, v, valid, scale=SCALE)
    torch.cuda.synchronize()
    assert tattn.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = tattn.attention_plain(q, k, v, valid, scale=SCALE)
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        truth = _truth(q, k, v, valid)
        err = (got.double() - truth).abs().max().item()
        plain_err = (want.double() - truth).abs().max().item()
        assert err <= 2 * plain_err, (err, plain_err)
    if mask == "one_image_masked":          # uniform over all keys
        uniform = v[0].float().mean(dim=0)
        torch.testing.assert_close(got[0].float(),
                                   uniform.expand_as(got[0]).to(got.dtype)
                                   .float(), atol=2e-2, rtol=0)


def _canvas_valid(device, b=12, side=32):
    """The key mask of the encoder at the 1000^2 detection canvas: 600 x
    800 and 800 x 600 valid regions in turn (4:3 images at min side 600,
    max side 1000), the last image full, downsampled by index to the 32 x
    32 grid: about half of the keys masked, in contiguous rows and
    columns."""
    idx = np.arange(side) * 1000 // side
    valid = np.ones((b, side, side), bool)
    for i in range(b - 1):
        h, w = (600, 800) if i % 2 == 0 else (800, 600)
        valid[i] = (idx[:, None] < h) & (idx[None, :] < w)
    return torch.from_numpy(valid.reshape(b, side * side)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_attention_kernel_canvas_mask(cuda_device, dtype):
    q, k, v, _ = _inputs(cuda_device, getattr(torch, dtype), 12, 1024, 8,
                         "none", seed=2)
    valid = _canvas_valid(cuda_device)
    assert 0.4 < 1 - valid[:-1].float().mean().item() < 0.6
    _check(q, k, v, valid, "canvas")


@pytest.mark.cuda
def test_torch_attention_kernel_float32_takes_any_length(cuda_device):
    q, k, v, valid = _inputs(cuda_device, torch.float32, 2, 200, 3,
                             "random")
    got = tattn.fused_attention(q, k, v, valid, scale=SCALE)
    want = tattn.attention_plain(q, k, v, valid, scale=SCALE)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_torch_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v, valid = _inputs(cuda_device, torch.float64, 1, 64, 1, "none")
    with pytest.raises(TypeError):
        tattn.fused_attention(q, k, v, scale=SCALE)
    q, k, v, _ = _inputs(cuda_device, torch.float32, 1, 64, 2, "none")
    with pytest.raises(ValueError, match="contiguous"):
        tattn.fused_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), scale=SCALE)
    q, k, v, _ = _inputs(cuda_device, torch.bfloat16, 1, 96, 2, "none")
    with pytest.raises(ValueError, match="multiple of 64"):
        tattn.fused_attention(q, k, v, scale=SCALE)
