"""The plain PyTorch references that decide `correct`.  They import nothing
of the program under test and take nothing it made: the benchmark hands
both sides the same seeded weights and inputs."""

import torch


def full_float32() -> None:
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
