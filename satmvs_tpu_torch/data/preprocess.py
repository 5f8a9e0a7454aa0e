"""Image and ground-truth preprocessing.  Counterpart of
`satmvs_tpu/data/preprocess.py` (numpy paths)."""

from __future__ import annotations

import numpy as np


def center_image(img: np.ndarray) -> np.ndarray:
    """Per-image, per-channel mean/std normalization over the spatial axes
    (H, W[, C]) → float32."""
    img = np.asarray(img, dtype=np.float32)
    mean = img.mean(axis=(0, 1), keepdims=True)
    var = img.var(axis=(0, 1), keepdims=True)
    return (img - mean) / (np.sqrt(var) + 1e-8)


def build_pyramid(arr: np.ndarray, num_stage: int = 3) -> list[np.ndarray]:
    """Coarsest-first nearest-neighbour pyramid of an (H, W) map, stage i
    taking every 2^(num_stage − 1 − i)-th pixel: the per-stage GT depth and
    mask maps."""
    return [np.ascontiguousarray(arr[::2 ** (num_stage - 1 - i), ::2 ** (num_stage - 1 - i)])
            for i in range(num_stage)]
