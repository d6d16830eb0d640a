"""The CUDA stem kernels (csrc/stem.cu: stem_conv_pool and stem_pool)
against their plain PyTorch versions, on the card, at small shapes and at
the production shapes (12 images at 1024^2; a stem conv output of 1020^2
images, (12, 510, 510, 64)).

Imports neither JAX nor the repo's conftest, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_stem_cuda.py

Where there is no card each test skips.  Tolerances: stem_pool exact (BN
as a rounded multiply then a rounded add in both); stem_conv_pool float32
within 1e-5 of the output's scale (sums of 147 products in another
order), bfloat16: the kernel's largest error against a float64 truth (the
same bf16 images and weights, exact sums) at most 1.1x the plain
version's (the same roundings, only the sums' order differs).  The
bfloat16 kernel's tile is 4 pool rows x 64 pool columns:
(1, 8, 8) is smaller than one, (3, 264, 1048) has a partial band (66 pool
rows) and a partial chunk (262 columns), (2, 1024, 512) two full chunks a
band, (12, 1000, 1000) the detection canvas (250 pool columns: a partial
chunk of 58 a band, 250 pool rows: a partial band).  The stem-pool
kernel's shapes are named at its test."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scene_graph_commonsense_torch.ops import stem as ts


BF16_RATIO = 1.1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _fold(rng, c, device):
    return torch.from_numpy(np.stack([rng.uniform(0.5, 1.5, c),
                                      rng.normal(0, 0.2, c)]).astype(
        np.float32)).to(device)


def _conv_pool_truth(images, w7, fold, cd):
    f = torch.float64
    x = images.to(cd).to(f).permute(0, 3, 1, 2)
    conv = F.conv2d(x, w7.to(cd).to(f).permute(3, 2, 0, 1), stride=2,
                    padding=3)
    fold = fold.to(f)
    v = torch.relu(conv * fold[0][:, None, None] + fold[1][:, None, None])
    return F.max_pool2d(v, 3, 2, 1).permute(0, 2, 3, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 40, 24), (1, 16, 88),
                                   (12, 1024, 1024), (1, 8, 8),
                                   (3, 264, 1048), (2, 1024, 512),
                                   (12, 1000, 1000)])
def test_torch_stem_conv_pool_kernel_matches_plain(cuda_device, shape,
                                                   dtype):
    cd = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal((*shape, 3)).astype(
        np.float32)).to(cuda_device)
    w7 = torch.from_numpy((rng.standard_normal((7, 7, 3, 64)) / np.sqrt(
        147)).astype(np.float32)).to(cuda_device).to(cd)
    fold = _fold(rng, 64, cuda_device)
    before = ts.conv_pool_launches
    got = ts.stem_conv_pool(images, w7, fold, compute_dtype=cd)
    torch.cuda.synchronize()
    assert ts.conv_pool_launches == before + 1
    want = ts.stem_conv_pool_plain(images, w7, fold, compute_dtype=cd)
    assert got.shape == want.shape == (shape[0], shape[1] // 4,
                                       shape[2] // 4, 64)
    assert got.dtype == cd
    if dtype == "float32":
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err
    else:
        truth = _conv_pool_truth(images, w7, fold, cd)
        err = (got.double() - truth).abs().max().item()
        plain_err = (want.double() - truth).abs().max().item()
        assert err <= BF16_RATIO * plain_err + 1e-6, (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 10, 14, 64), (1, 6, 18, 128),
                                   (12, 510, 510, 64), (1, 2, 2, 64),
                                   (2, 18, 42, 64), (1, 10, 14, 5),
                                   (2, 12, 20, 24)])
def test_torch_stem_pool_kernel_equals_plain(cuda_device, shape, dtype):
    """stem_pool_hopper's tile is 4 x 16 pool outputs x 128 bytes of
    channels: (1, 2, 2, 64) is one pool output, (2, 18, 42, 64) has a
    partial tile in rows and columns, C = 128 (and C = 64 in float32) two
    channel chunks; C = 5 is not a whole 16-byte vector and takes
    stem_pool_kernel."""
    cd = getattr(torch, dtype)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda_device).to(cd)
    fold = _fold(rng, shape[-1], cuda_device)
    before = ts.pool_launches
    got = ts.stem_pool(x, fold)
    torch.cuda.synchronize()
    assert ts.pool_launches == before + 1
    tma = shape[-1] * x.element_size() % 16 == 0
    assert ts.last_pool_kernel == ("stem_pool_hopper" if tma
                                   else "stem_pool_kernel")
    assert torch.equal(got, ts.stem_pool_plain(x, fold))


@pytest.mark.cuda
def test_torch_stem_conv_pool_prepared_weights(cuda_device):
    """The bfloat16 kernel with its weight matrix built once beside it
    (the fused trunk's `prepared`) gives the same bits as with the matrix
    built per call; a matrix of another layout is refused."""
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.standard_normal((2, 72, 136, 3)).astype(
        np.float32)).to(cuda_device)
    w7 = torch.from_numpy(rng.standard_normal((7, 7, 3, 64)).astype(
        np.float32)).to(cuda_device).to(torch.bfloat16)
    fold = _fold(rng, 64, cuda_device)
    wk = ts.stem_kernel_weights(w7)
    got = ts.stem_conv_pool_kernel(images, w7, fold, wk)
    assert torch.equal(got, ts.stem_conv_pool_kernel(images, w7, fold))
    with pytest.raises(ValueError, match="stem_kernel_weights"):
        ts.stem_conv_pool_kernel(images, w7, fold,
                                 ts.stem_weights(w7, torch.bfloat16))


@pytest.mark.cuda
def test_torch_stem_kernels_reject_what_they_do_not_take(cuda_device):
    rng = np.random.default_rng(2)
    images = torch.zeros((1, 16, 16, 3), device=cuda_device)
    w7 = torch.zeros((7, 7, 3, 64), device=cuda_device,
                     dtype=torch.bfloat16)
    fold = _fold(rng, 64, cuda_device)
    with pytest.raises(TypeError):
        ts.stem_conv_pool_kernel(images.double(), w7, fold)
    with pytest.raises(TypeError):
        ts.stem_conv_pool_kernel(images, w7.double(), fold)
    with pytest.raises(ValueError, match="divisible by 8"):
        ts.stem_conv_pool_kernel(images[:, :12].contiguous(), w7, fold)
    with pytest.raises(ValueError, match="contiguous"):
        ts.stem_conv_pool_kernel(images.transpose(1, 2), w7, fold)
    with pytest.raises(ValueError, match="CUDA"):
        ts.stem_conv_pool_kernel(images.cpu(), w7.cpu(), fold.cpu())
    conv = torch.zeros((1, 8, 8, 64), device=cuda_device,
                       dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        ts.stem_pool_kernel(conv.double(), fold)
    with pytest.raises(ValueError, match="even"):
        ts.stem_pool_kernel(conv[:, :7].contiguous(), fold)
    with pytest.raises(ValueError, match="contiguous"):
        ts.stem_pool_kernel(conv.transpose(1, 2), fold)
    with pytest.raises(ValueError, match="CUDA"):
        ts.stem_pool_kernel(conv.cpu(), fold.cpu())
