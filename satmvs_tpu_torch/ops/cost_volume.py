"""Variance cost volume from per-view feature moments.

Counterpart of `satmvs_tpu/ops/cost_volume.py` (single device: the
cross-device moment all-reduce comes with the multi-GPU port).
Features (H, W, C), volumes (D, H, W, C).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def variance_from_moments(vol_sum, vol_sq_sum, num_views):
    """var = Σf²/V − (Σf/V)²."""
    mean = vol_sum / num_views
    return vol_sq_sum / num_views - mean * mean


def variance_cost_volume(ref_feat: torch.Tensor,
                         warped_srcs: Sequence[torch.Tensor] | torch.Tensor) -> torch.Tensor:
    """Variance volume over {ref, warped srcs}: ref (H, W, C), warped srcs a
    list of (D, H, W, C) volumes or one stacked (S, D, H, W, C) tensor."""
    vol_sum = 0.0
    vol_sq = 0.0
    count = 0
    for wv in warped_srcs:
        w32 = wv.to(torch.float32)
        vol_sum = vol_sum + w32
        vol_sq = vol_sq + w32 * w32
        count += 1
    vol_sum = vol_sum + ref_feat[None]
    vol_sq = vol_sq + (ref_feat * ref_feat)[None]
    count += 1
    return variance_from_moments(vol_sum, vol_sq, count)


def sweep_variance_volume(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                          warp_one: Callable[[torch.Tensor, int], torch.Tensor]) -> torch.Tensor:
    """Warp every source view with `warp_one(src_feat, s)` → (D, H, W, C)
    and aggregate by variance.  ref (H, W, C), src_feats (S, H, W, C)."""
    warped = [warp_one(src_feats[s], s) for s in range(src_feats.shape[0])]
    return variance_cost_volume(ref_feat, warped)
