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


class _Moments(torch.autograd.Function):
    """(w, w²) in float32 of a bf16 volume, saving the bf16 volume (not its
    float32 upcast) and upcasting it again in the backward; the cotangent
    g_w + 2·w·g_w² is rounded to bf16, as JAX's convert_element_type
    transpose rounds it."""

    @staticmethod
    def forward(ctx, wv):
        ctx.save_for_backward(wv)
        w32 = wv.to(torch.float32)
        return w32, w32 * w32

    @staticmethod
    def backward(ctx, g_sum, g_sq):
        (wv,) = ctx.saved_tensors
        w32 = wv.to(torch.float32)
        return (g_sum + (g_sq * w32 + g_sq * w32)).to(wv.dtype)


def view_moments(wv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A warped view's first two moments (w, w²) in float32.  A float32
    view is used as it is; a lower-precision one (bf16 volume transport)
    upcasts at the read, and autograd keeps only the stored view."""
    if wv.dtype == torch.float32:
        return wv, wv * wv
    return _Moments.apply(wv)


def variance_cost_volume(ref_feat: torch.Tensor,
                         warped_srcs: Sequence[torch.Tensor] | torch.Tensor) -> torch.Tensor:
    """Variance volume over {ref, warped srcs}: ref (H, W, C), warped srcs a
    list of (D, H, W, C) volumes or one stacked (S, D, H, W, C) tensor, in
    float32 or bfloat16 (the moments are float32 either way)."""
    vol_sum = 0.0
    vol_sq = 0.0
    count = 0
    for wv in warped_srcs:
        w32, sq = view_moments(wv)
        vol_sum = vol_sum + w32
        vol_sq = vol_sq + sq
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
