"""Image preprocessing.  Counterpart of `satmvs_tpu/data/preprocess.py`
(its numpy path)."""

from __future__ import annotations

import numpy as np


def center_image(img: np.ndarray) -> np.ndarray:
    """Per-image, per-channel mean/std normalization over the spatial axes
    (H, W[, C]) → float32."""
    img = np.asarray(img, dtype=np.float32)
    mean = img.mean(axis=(0, 1), keepdims=True)
    var = img.var(axis=(0, 1), keepdims=True)
    return (img - mean) / (np.sqrt(var) + 1e-8)
