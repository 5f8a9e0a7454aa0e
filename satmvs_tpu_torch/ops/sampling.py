"""Bilinear sampling of channels-last feature maps.

Counterpart of `satmvs_tpu/ops/sampling.py`.  Samples are taken at exact
pixel coordinates (x = 0 is the centre of the first column).  Each of the
four corners is valid on its own: an out-of-image corner contributes zero,
the others keep their weights (grid_sample's padding_mode='zeros').
"""

from __future__ import annotations

import torch


def bilinear_sample(feat: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """feat (H, W, C) sampled at x (column), y (row) of any common shape S
    → (S..., C), zero outside the image."""
    h, w, c = feat.shape
    shape = x.shape
    x = x.reshape(-1)
    y = y.reshape(-1)

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0

    # clamp before the float → int cast (undefined out of range); values
    # below -1 or above w keep both corners invalid, so validity is unchanged
    x0i = x0.clamp(-2, w).to(torch.int64)
    y0i = y0.clamp(-2, h).to(torch.int64)
    x1i = x0i + 1
    y1i = y0i + 1

    flat = feat.reshape(h * w, c)

    def corner(yi, xi, weight):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = flat.index_select(0, idx)  # (N, C)
        return vals * (weight * valid.to(feat.dtype))[:, None]

    out = (
        corner(y0i, x0i, (1 - wy) * (1 - wx))
        + corner(y0i, x1i, (1 - wy) * wx)
        + corner(y1i, x0i, wy * (1 - wx))
        + corner(y1i, x1i, wy * wx)
    )
    return out.reshape(*shape, c)
