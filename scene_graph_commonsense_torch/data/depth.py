"""Monocular depth for the offline annotation cache (normalize_depth and
make_midas_depth_fn of scene_graph_commonsense_tpu/data/depth.py, copied so
that the port imports nothing of the JAX package).

The reference runs MiDaS DPT_Large from torch.hub during offline data
preparation and caches a min-max-normalized 32x32 depth map per image
(reference prepare_datasets.py:52-53, dataset_utils.py:102-109).  Depth is a
cached input channel, never trained through, so the estimator stays an
offline tool: `make_midas_depth_fn` wraps torch-hub MiDaS when its code and
weights are on disk, and callers fall back to zero depth otherwise (the
pipeline supports use_depth=False, reference dataloader.py:113-114).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np


def normalize_depth(depth: np.ndarray, feature_size: int = 32) -> np.ndarray:
    """Resize to the feature grid and min-max scale (reference
    dataset_utils.py:107-108 divides by (max - min))."""
    from PIL import Image
    d = np.asarray(depth, np.float32)
    img = Image.fromarray(d)
    img = img.resize((feature_size, feature_size), Image.BILINEAR)
    d = np.asarray(img, np.float32)
    span = float(d.max() - d.min())
    if span > 0:
        d = d / span
    return d


def make_midas_depth_fn(model_type: str = "DPT_Large",
                        feature_size: int = 32,
                        device=None) -> Optional[Callable]:
    """Returns depth_fn(image_rgb_uint8) -> (S, S) float32 running MiDaS on
    `device` (default cuda; raises where CUDA is absent unless
    device="cpu"), or None when MiDaS cannot be loaded.  The model comes
    from torch.hub's cache: the intel-isl/MiDaS code under
    torch.hub.get_dir() and its weights in the hub's checkpoint directory.
    Unlike the JAX package's, it never downloads: a load that would fetch
    the code or the weights gives None."""
    import torch

    from scene_graph_commonsense_torch.device import resolve_device
    dev = resolve_device(device)
    repo = os.path.join(torch.hub.get_dir(), "intel-isl_MiDaS_master")
    if not os.path.isdir(repo):
        return None

    def no_download(url, *args, **kwargs):
        raise RuntimeError(f"not downloading {url}")

    fetch = torch.hub.download_url_to_file
    torch.hub.download_url_to_file = no_download
    try:
        midas = torch.hub.load(repo, model_type, source="local",
                               trust_repo=True)
        transforms = torch.hub.load(repo, "transforms", source="local",
                                    trust_repo=True)
        transform = (transforms.dpt_transform if "DPT" in model_type
                     else transforms.small_transform)
    except Exception:               # absent weights, modules or model type
        return None
    finally:
        torch.hub.download_url_to_file = fetch
    midas.to(dev).eval()

    def depth_fn(image: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            pred = midas(transform(image).to(dev))
        return normalize_depth(pred.squeeze().cpu().numpy(), feature_size)

    return depth_fn
