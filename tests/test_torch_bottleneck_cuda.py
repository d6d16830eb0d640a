"""The CUDA bottleneck kernels (csrc/bottleneck.cu, stride 1 and 2) against
their plain PyTorch versions, on the card, at small shapes with ragged
tiles and at production shapes of the DETR-101 trunk (batch 12, 1024^2
images and the 1000^2 detection canvas).

Imports neither JAX nor the repo's conftest, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_bottleneck_cuda.py

Where there is no card each test skips.  Tolerances: float32 within 1e-5 of
the output's scale (max |plain|): sums of up to 9 * 512 float32 products in
another order; bfloat16 compute: the kernel's largest error against a
float64 truth (the same bf16 operands and roundings of a and b, exact sums)
is at most 2x the plain version's at stride 1 and 1.1x at stride 2 (the
same roundings of a and b, only the sums' order differs)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scene_graph_commonsense_torch.ops import bottleneck as tb


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _args(device, dtype, b, h, w, cin, m, co, proj, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to(device).to(dt)

    def fold(c):
        return t(np.stack([rng.uniform(0.5, 1.5, c), rng.normal(0, 0.2, c)]),
                 torch.float32)

    args = [t(rng.standard_normal((b, h, w, cin))),
            t(rng.standard_normal((cin, m)) / np.sqrt(cin)), fold(m),
            t(rng.standard_normal((3, 3, m, m)) / np.sqrt(9 * m)), fold(m),
            t(rng.standard_normal((m, co)) / np.sqrt(m)), fold(co)]
    if proj:
        args += [t(rng.standard_normal((cin, co)) / np.sqrt(cin)), fold(co)]
    else:
        args += [None, None]
    return args


def _truth(x, w1, s1, w2, s2, w3, s3, wd, sd, stride):
    """float64 block with the kernel's roundings of a and b to x's dtype."""
    cd, f = x.dtype, torch.float64
    s1, s2, s3 = s1.to(f), s2.to(f), s3.to(f)
    xf = x.to(f)
    a = torch.relu(xf @ w1.to(f) * s1[0] + s1[1]).to(cd).to(f)
    acc = F.conv2d(a.permute(0, 3, 1, 2), w2.to(f).permute(3, 2, 0, 1),
                   stride=stride, padding=1).permute(0, 2, 3, 1)
    b = torch.relu(acc * s2[0] + s2[1]).to(cd).to(f)
    c = b @ w3.to(f) * s3[0] + s3[1]
    if wd is None:
        idn = xf
    else:
        sd = sd.to(f)
        idn = xf[:, ::stride, ::stride] @ wd.to(f) * sd[0] + sd[1]
    return torch.relu(c + idn)


# the kernel's bf16 error against float64 over the plain version's, at most
BF16_RATIO = {1: 2.0, 2: 1.1}


def _check(args, stride):
    kernel = tb.bottleneck_kernel if stride == 1 else tb.bottleneck_s2_kernel
    plain = tb.fused_bottleneck_plain if stride == 1 \
        else tb.fused_bottleneck_s2_plain
    counter = "launches" if stride == 1 else "s2_launches"
    before = getattr(tb, counter)
    got = kernel(*args)
    torch.cuda.synchronize()
    assert getattr(tb, counter) == before + 1
    want = plain(*args)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.float32:
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err
    else:
        truth = _truth(*args, stride)
        err = (got.double() - truth).abs().max().item()
        plain_err = (want.double() - truth).abs().max().item()
        assert err <= BF16_RATIO[stride] * plain_err + 1e-6, (err, plain_err)


# (B, H, W, C_in, M, C_out, projection); odd H and W leave ragged tiles.
# The bfloat16 kernel's tiles (16 x 16 at M = 64, 16 x 8 at M = 128 and
# 256, 8 x 8 at M = 512) pair up in clusters of two: for each M there are
# images smaller than one tile (a lone tile, its partner past the image),
# an odd number of tiles per tile row, and batches above 1.
STRIDE1 = {"identity_m64": (2, 9, 13, 256, 64, 256, False),
           "identity_m64_3x3_tiles": (1, 40, 40, 256, 64, 256, False),
           "proj_m64": (2, 7, 5, 64, 64, 256, True),
           "proj_m64_2x3_tiles": (2, 20, 36, 64, 64, 256, True),
           "identity_m128": (1, 11, 6, 512, 128, 512, False),
           "identity_m128_2x3_tiles": (2, 20, 20, 512, 128, 512, False),
           "proj_m128": (1, 6, 10, 256, 128, 512, True),
           "identity_m256_small": (2, 5, 7, 1024, 256, 1024, False),
           "identity_m256_2x3_tiles": (3, 17, 20, 1024, 256, 1024, False),
           "proj_m256": (1, 10, 9, 512, 256, 1024, True),
           "identity_m512": (1, 3, 5, 2048, 512, 2048, False),
           "identity_m512_2x3_tiles": (2, 12, 20, 2048, 512, 2048, False),
           "proj_m512": (1, 5, 9, 1024, 512, 2048, True),
           "layer3_12x64x64": (12, 64, 64, 1024, 256, 1024, False),
           # the 1000^2 detection canvas: odd sides, partial tiles at the
           # right and bottom edge of every image
           "canvas_layer2_12x125x125": (12, 125, 125, 512, 128, 512, False),
           "canvas_layer3_12x63x63": (12, 63, 63, 1024, 256, 1024, False)}
# Stride 2 (bfloat16: conv1 over 128-row tiles of (B H W, C), then output
# tiles of 16 x 8 at M = 128 and 256, 8 x 8 at M = 512, both in clusters of
# two): for each M an image smaller than one output tile (its partner past
# the image), an odd number of output tiles (one cluster's partner on zero
# fill), H/2 and W/2 odd with B > 1, and a production shape.
STRIDE2 = {"m128": (2, 10, 14, 256, 128, 512),
           "m128_small": (1, 6, 10, 256, 128, 512),
           "m128_3_tiles": (2, 30, 46, 256, 128, 512),
           "m256_small": (2, 8, 12, 512, 256, 1024),
           "m256_3_tiles": (1, 32, 48, 512, 256, 1024),
           "m256_odd_halves": (3, 22, 18, 512, 256, 1024),
           "m512": (1, 6, 4, 1024, 512, 2048),
           "m512_3_tiles": (1, 16, 48, 1024, 512, 2048),
           "m512_odd_halves": (2, 18, 14, 1024, 512, 2048),
           "layer3_0_12x128x128": (12, 128, 128, 512, 256, 1024),
           "layer4_0_12x64x64": (12, 64, 64, 1024, 512, 2048),
           # the detection canvas's one transition on the kernel: 250^2 ->
           # 125^2 (an odd output side, a partial output tile)
           "canvas_layer2_0_12x250x250": (12, 250, 250, 256, 128, 512)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(STRIDE1))
def test_torch_bottleneck_kernel_matches_plain(cuda_device, case, dtype):
    _check(_args(cuda_device, getattr(torch, dtype), *STRIDE1[case]), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(STRIDE2))
def test_torch_bottleneck_s2_kernel_matches_plain(cuda_device, case, dtype):
    _check(_args(cuda_device, getattr(torch, dtype), *STRIDE2[case], True),
           2)


@pytest.mark.cuda
def test_torch_bottleneck_kernel_rejects_what_it_does_not_take(cuda_device):
    args = _args(cuda_device, torch.bfloat16, 1, 4, 6, 64, 64, 256, True)
    with pytest.raises(TypeError):
        tb.bottleneck_kernel(args[0].double(), *args[1:])
    with pytest.raises(TypeError):
        tb.bottleneck_kernel(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="even"):
        tb.bottleneck_s2_kernel(args[0][:, :3], *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        tb.bottleneck_kernel(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError, match="C == CO"):
        tb.bottleneck_kernel(*args[:7])
    with pytest.raises(ValueError, match="multiples"):
        odd = _args(cuda_device, torch.bfloat16, 1, 4, 4, 64, 48, 64, False)
        tb.bottleneck_kernel(*odd)
    with pytest.raises(ValueError, match="M in"):
        tb.bottleneck_s2_kernel(*args)         # M = 64 at stride 2
    with pytest.raises(ValueError, match="CUDA"):
        tb.bottleneck_kernel(*[None if a is None else a.cpu() for a in args])
