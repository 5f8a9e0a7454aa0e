"""Image and ground-truth preprocessing.  Counterpart of
`satmvs_tpu/data/preprocess.py`; `center_image` takes the native library
where it is built, as JAX's does.  The colour jitter draws
from an explicit `np.random.Generator` with the JAX package's calls in its
order, so a train-mode sample is the JAX package's."""

from __future__ import annotations

import math

import numpy as np


def center_image(img: np.ndarray) -> np.ndarray:
    """Per-image, per-channel mean/std normalization over the spatial axes
    (H, W[, C]) → float32.  The native library (`native.center_image`,
    float64 moments) where it is built, else numpy's float32 moments: the
    two differ by a few 1e-6."""
    from .. import native

    if native.available():
        out = native.center_image(img)
        if out is not None:
            return out
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


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    return b + factor * (a - b)


_LUMA = np.array([0.299, 0.587, 0.114], np.float32)
_SMOOTH = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
_ROWS = 32  # rows a block: a block's temporaries stay in the cache


def color_factors(rng: np.random.Generator) -> tuple:
    """The four factors of `random_color`, drawn from `rng` in its order:
    saturation U{0.01..3.0}, brightness U{0.1..2.0}, contrast U{0.1..2.0},
    sharpness U{0.0..3.0}, in steps of 0.01."""
    return (rng.integers(1, 301) / 100.0, rng.integers(10, 201) / 100.0,
            rng.integers(10, 201) / 100.0, rng.integers(0, 301) / 100.0)


def random_color(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Saturation, brightness, contrast and sharpness jitter of an (H, W, 3)
    image in [0, 255], factors drawn from `rng` (`color_factors`)."""
    return jitter_color(img, color_factors(rng))


def jitter_color(img: np.ndarray, factors: tuple) -> np.ndarray:
    """`random_color` with its factors given.  Saturation blends with the
    per-pixel luma, brightness with black, contrast with the mean luma and
    sharpness with a 3×3 smoothing.  The image goes through in blocks of
    rows, each block the whole image's element operations in the same order
    (the same values), so that a block's temporaries stay in the cache."""
    img = np.asarray(img, dtype=np.float32)
    f_sat, f_bright, f_contrast, f_sharp = factors
    luma = (img @ _LUMA)[..., None]
    mean_luma = luma.mean()
    h, w = img.shape[:2]

    # saturation, brightness and contrast into the inside of an edge-padded
    # buffer, the input of the smoothing
    pad = None
    for r in range(0, h, _ROWS):
        x = _blend(img[r:r + _ROWS], luma[r:r + _ROWS], f_sat) * f_bright
        x = _blend(x, np.full_like(x, mean_luma), f_contrast)
        if pad is None:
            pad = np.empty((h + 2, w + 2, img.shape[2]), x.dtype)
        pad[r + 1:r + 1 + x.shape[0], 1:w + 1] = x
    pad[0, 1:w + 1], pad[h + 1, 1:w + 1] = pad[1, 1:w + 1], pad[h, 1:w + 1]
    pad[:, 0], pad[:, w + 1] = pad[:, 1], pad[:, w]

    out = np.empty((h, w, img.shape[2]), pad.dtype)
    smooth, term = np.empty_like(out[:_ROWS]), np.empty_like(out[:_ROWS])
    for r in range(0, h, _ROWS):
        n = min(_ROWS, h - r)
        acc, tmp = smooth[:n], term[:n]
        acc.fill(0)  # the taps added to 0 in order, as sum() adds them
        for i in range(3):
            for j in range(3):
                np.add(acc, np.multiply(_SMOOTH[i, j], pad[r + i:r + i + n, j:j + w], out=tmp),
                       out=acc)
        out[r:r + n] = np.clip(_blend(pad[r + 1:r + 1 + n, 1:w + 1], acc, f_sharp), 0.0, 255.0)
    return out


def crop_to_multiple(image, max_h: int = 384, max_w: int = 768, base: int = 32):
    """Centre-crop window (start_h, start_w, new_h, new_w) whose sizes are at
    most max_h × max_w (0: no cap) and multiples of `base`, rounded down.
    Apply it to the image and height map, and shift the camera with
    `geo.rpc.crop_rpc`."""
    h, w = image.shape[:2]
    new_h = (min(h, max_h) if max_h else h) // base * base
    new_w = (min(w, max_w) if max_w else w) // base * base
    if new_h <= 0 or new_w <= 0:
        raise ValueError(f"image {h}x{w} smaller than base {base}")
    return int(math.ceil((h - new_h) / 2)), int(math.ceil((w - new_w) / 2)), new_h, new_w
