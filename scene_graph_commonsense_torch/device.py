"""Device resolution and numeric settings for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a missing
device argument means "cuda", and asking for CUDA where there is none raises
rather than silently falling back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> cuda.  Raises if CUDA is requested but absent; "cpu" is
    always honoured (the tests run there)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def disable_tf32() -> None:
    """float32 convolutions go through cuDNN in TF32 by default (about three
    decimal digits); the port computes float32 in full float32 like the JAX
    package on the CPU, so both TF32 switches are turned off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
