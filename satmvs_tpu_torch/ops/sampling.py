"""Bilinear sampling of channels-last feature maps.

Counterpart of `satmvs_tpu/ops/sampling.py`.  Samples are taken at exact
pixel coordinates (x = 0 is the centre of the first column).  Each of the
four corners is valid on its own: an out-of-image corner contributes zero,
the others keep their weights (grid_sample's padding_mode='zeros').
`torch_grid_coords` maps exact coordinates to the reference's stretched
ones (the `torch_compat` mode).
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


def torch_grid_coords(x: torch.Tensor, y: torch.Tensor, height: int, width: int):
    """Exact pixel coordinates → the positions the reference samples: it
    normalizes by (W − 1)/2 and calls grid_sample(align_corners=False),
    which reads the input at x·W/(W − 1) − 0.5 (`satmvs_tpu/ops/sampling.py:
    67-78`).  height and width are the sampled (source) map's.  The
    `torch_compat` mode's sampling, so converted reference checkpoints see
    the geometry they were trained under."""
    return (x * (width / (width - 1.0)) - 0.5, y * (height / (height - 1.0)) - 0.5)


def bilinear_sample_scalar(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                           fill: float = 0.0) -> torch.Tensor:
    """Bilinear sample of a single-channel (H, W) image at x, y (any common
    shape), `fill` where the point lies outside [0, W − 1] × [0, H − 1]
    (cv2.remap with a constant border, the fusion filter's sampling)."""
    sampled = bilinear_sample(img[..., None], x, y)[..., 0]
    h, w = img.shape
    inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    return torch.where(inside, sampled, torch.full_like(sampled, fill))
