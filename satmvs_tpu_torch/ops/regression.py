"""Probability volume → depth map and confidence.

Counterpart of `satmvs_tpu/ops/regression.py`.  prob (..., D, H, W): the
JAX functions' unbatched (D, H, W), or the cascade's batched (B, D, H, W).

Under depth-slab sharding (`shard`, a `dist.halo.Shard` of the depth axis)
each rank holds the planes [shard.lo, shard.hi) of a volume; the sums over
D are then the rank's partial sums, added over the group by a
differentiable all-reduce, so every rank gets the whole volume's map.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.collectives import all_reduce_sum
from ..dist.halo import group_max


def _over_depth(partial: torch.Tensor, shard) -> torch.Tensor:
    return partial if shard is None else all_reduce_sum(partial, shard.group)


def softmax_depth(logits: torch.Tensor, shard=None) -> torch.Tensor:
    """Softmax over D of (B, D, H, W) logits; under a depth shard over the
    group's planes: shifted by the group's largest logit, divided by the
    group's Σ exp."""
    if shard is None:
        return torch.softmax(logits, dim=1)
    top = group_max(logits.detach().amax(dim=1, keepdim=True), shard)
    e = torch.exp(logits - top)
    return e / all_reduce_sum(e.sum(dim=1, keepdim=True), shard.group)


def depth_regression(prob: torch.Tensor, depth_values: torch.Tensor,
                     shard=None) -> torch.Tensor:
    """Soft-argmax Σ_d p·depth → (..., H, W); depth_values (D,) or shaped
    like prob (under a depth shard, the rank's planes of both)."""
    if depth_values.ndim == 1:
        depth_values = depth_values[:, None, None]
    return _over_depth(torch.sum(prob * depth_values, dim=-3), shard)


def max_prob_confidence(prob: torch.Tensor, shard=None) -> torch.Tensor:
    """Confidence = the largest probability over depth (RED models);
    without a gradient under a depth shard."""
    top = torch.amax(prob, dim=-3)
    return top if shard is None else group_max(top, shard)


def _sharded_window(prob: torch.Tensor, window: int, shard) -> torch.Tensor:
    """`window_prob_confidence` of the rank's planes [lo, hi) of (B, D, H,
    W) probabilities: the soft-argmax index summed over the group, then each
    rank's probabilities in the band that fall in its planes, summed over
    the group."""
    lo, n, d = shard.lo, prob.shape[-3], shard.extent
    index = torch.arange(lo, lo + n, dtype=prob.dtype, device=prob.device)
    idx_f = depth_regression(prob, index, shard)
    first = idx_f.to(torch.int32).clamp(0, d - 1).long() - (window // 2 - 1)
    csum = F.pad(torch.cumsum(prob, dim=-3), (0, 0, 0, 0, 1, 0))
    a = (first - lo).clamp(0, n).unsqueeze(-3)
    b = (first + window - lo).clamp(0, n).unsqueeze(-3)
    part = (torch.gather(csum, -3, b) - torch.gather(csum, -3, a)).squeeze(-3)
    return all_reduce_sum(part, shard.group)


def window_prob_confidence(prob: torch.Tensor, window: int = 4, shard=None) -> torch.Tensor:
    """Confidence = the probability mass of a `window`-plane band around the
    regressed depth index (CasMVS/UCS): prob padded along D by window//2 − 1
    planes before and window − window//2 + 1 after (1 and 3 for window 4),
    band sums of `window` planes by cumulative sums, taken at the
    soft-argmax index Σ_d p·d truncated to an integer (JAX's astype(int32))
    and clipped to [0, D − 1].  prob (..., D, H, W) → (..., H, W); under a
    depth shard, (B, D', H, W) planes of the group's volume."""
    if shard is not None:
        return _sharded_window(prob, window, shard)
    d = prob.shape[-3]
    pad_front, pad_back = window // 2 - 1, window - window // 2 + 1
    csum = torch.cumsum(F.pad(prob, (0, 0, 0, 0, pad_front, pad_back)), dim=-3)
    csum = F.pad(csum, (0, 0, 0, 0, 1, 0))
    band = csum[..., window:, :, :] - csum[..., :-window, :, :]
    idx_f = depth_regression(prob, torch.arange(d, dtype=prob.dtype, device=prob.device))
    idx = idx_f.to(torch.int32).clamp(0, d - 1).long()
    return torch.gather(band, -3, idx.unsqueeze(-3)).squeeze(-3)


def expected_variance(prob: torch.Tensor, depth_values: torch.Tensor, depth: torch.Tensor,
                      lamb: float, shard=None) -> torch.Tensor:
    """UCSNet's uncertainty λ·sqrt(Σ_d p·(d − d̂)²): prob and depth_values
    (..., D, H, W) (or depth_values (D,)), depth d̂ (..., H, W) → (..., H, W);
    the sum over the group's planes under a depth shard."""
    if depth_values.ndim == 1:
        depth_values = depth_values[:, None, None]
    var = torch.sum(prob * (depth_values - depth.unsqueeze(-3)) ** 2, dim=-3)
    return lamb * torch.sqrt(_over_depth(var, shard))
