"""The depth channel's normalisation (normalize_depth of
scene_graph_commonsense_tpu/data/depth.py, copied so that the port imports
nothing of the JAX package).

The reference runs MiDaS DPT_Large offline and caches a min-max-normalized
32x32 depth map per image in its annotation records (reference
prepare_datasets.py:52-53, dataset_utils.py:102-109).  The estimator stays an
offline tool of the JAX package; the port reads the cached maps.
"""

from __future__ import annotations

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
