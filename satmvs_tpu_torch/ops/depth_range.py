"""Height-hypothesis samplers of the cascade.

Counterpart of `satmvs_tpu/ops/depth_range.py`.  Unbatched: maps (H, W),
sample volumes (D, H, W).  Stage 1 sweeps the scene's height range
uniformly; later stages sweep a per-pixel window around the upsampled
previous estimate, computed directly at the stage's resolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def uniform_samples(d_min: torch.Tensor, d_max: torch.Tensor, ndepth: int,
                    height: int, width: int) -> torch.Tensor:
    """Uniform sweep of [d_min, d_max] (float32 scalars): (D, H, W)."""
    steps = torch.arange(ndepth, dtype=torch.float32, device=d_min.device)
    vals = d_min + steps * ((d_max - d_min) / (ndepth - 1))
    return vals[:, None, None].expand(ndepth, height, width)


def window_samples(cur_depth: torch.Tensor, ndepth: int, interval) -> torch.Tensor:
    """Per-pixel window of ±(ndepth/2)·interval around cur_depth (H, W):
    (D, H, W); the step is ndepth·interval/(ndepth − 1)."""
    low = cur_depth - (ndepth / 2.0) * interval
    high = cur_depth + (ndepth / 2.0) * interval
    step = (high - low) / (ndepth - 1)
    steps = torch.arange(ndepth, dtype=cur_depth.dtype, device=cur_depth.device)
    return low[None] + steps[:, None, None] * step[None]


def upsample_map(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W) maps to (..., height, width), half-pixel
    centres, edge samples clamped: equal to jax.image.resize(..., "bilinear")
    when upsampling, which is how the cascade uses it."""
    lead = x.shape[:-2]
    out = F.interpolate(x.reshape(-1, 1, *x.shape[-2:]), size=(height, width),
                        mode="bilinear", align_corners=False, antialias=False)
    return out.reshape(*lead, height, width)


def uncertainty_samples(cur_depth: torch.Tensor, exp_var: torch.Tensor, ndepth: int,
                        d_min: torch.Tensor, d_max: torch.Tensor) -> torch.Tensor:
    """UCSNet's window: cur_depth ± the predicted spread exp_var (H, W),
    clamped to the scene range [d_min, d_max], in ndepth uniform steps, plus
    1e-12 (as in JAX): (D, H, W)."""
    eps = 1e-12
    low = torch.maximum(cur_depth - exp_var, d_min)
    high = torch.minimum(cur_depth + exp_var, d_max)
    step = (high - low) / (float(ndepth) - 1.0)
    steps = torch.arange(ndepth, dtype=cur_depth.dtype, device=cur_depth.device)
    return low[None] + steps[:, None, None] * step[None] + eps
