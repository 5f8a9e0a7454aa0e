"""Variance cost volume from per-view feature moments.

Counterpart of `satmvs_tpu/ops/cost_volume.py`, with its view-sharded
form: when the views of a sweep live on several ranks, each rank sums the
moments (Σf, Σf²) of its own views, a differentiable all-reduce over the
view group adds them (JAX psums them over a mesh axis), and every rank
forms the same variance.  No model path shards views, in JAX either; the
model's data-parallel path keeps a sample's views on one rank.
Features (H, W, C), volumes (D, H, W, C).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..dist.collectives import all_reduce_sum


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


def variance_cost_volume(ref_feat: Optional[torch.Tensor],
                         warped_srcs: Sequence[torch.Tensor] | torch.Tensor,
                         num_views: Optional[int] = None, group=None) -> torch.Tensor:
    """Variance volume over {ref, warped srcs}: ref (H, W, C), warped srcs a
    list of (D, H, W, C) volumes or one stacked (S, D, H, W, C) tensor, in
    float32 or bfloat16 (the moments are float32 either way).

    num_views: the views of the sweep, the reference included, over all
    ranks; by default this call's count.  group: the views are sharded over
    this group's ranks: each rank passes its own warped sources (at least
    one) and only the rank that owns the reference passes ref_feat (None on
    the others); the moments are summed over the group, differentiably, and
    num_views is required."""
    if group is not None and num_views is None:
        raise ValueError("num_views is required when view-sharded")
    vol_sum = 0.0
    vol_sq = 0.0
    count = 0
    for wv in warped_srcs:
        w32, sq = view_moments(wv)
        vol_sum = vol_sum + w32
        vol_sq = vol_sq + sq
        count += 1
    if ref_feat is not None:
        vol_sum = vol_sum + ref_feat[None]
        vol_sq = vol_sq + (ref_feat * ref_feat)[None]
        count += 1
    if group is not None:
        vol_sum, vol_sq = all_reduce_sum(torch.stack([vol_sum, vol_sq]), group).unbind(0)
    return variance_from_moments(vol_sum, vol_sq, count if num_views is None else num_views)


def sweep_variance_volume(ref_feat: Optional[torch.Tensor], src_feats: torch.Tensor,
                          warp_one: Callable[[torch.Tensor, int], torch.Tensor],
                          num_views: Optional[int] = None, group=None) -> torch.Tensor:
    """Warp every source view with `warp_one(src_feat, s)` → (D, H, W, C)
    and aggregate by variance.  ref (H, W, C), src_feats (S, H, W, C);
    num_views and group as `variance_cost_volume`'s."""
    warped = [warp_one(src_feats[s], s) for s in range(src_feats.shape[0])]
    return variance_cost_volume(ref_feat, warped, num_views, group)
