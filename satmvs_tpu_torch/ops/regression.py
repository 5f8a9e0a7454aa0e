"""Probability volume → depth map and confidence.

Counterpart of `satmvs_tpu/ops/regression.py`.  prob (..., D, H, W): the
JAX functions' unbatched (D, H, W), or the cascade's batched (B, D, H, W).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def depth_regression(prob: torch.Tensor, depth_values: torch.Tensor) -> torch.Tensor:
    """Soft-argmax Σ_d p·depth → (..., H, W); depth_values (D,) or shaped
    like prob."""
    if depth_values.ndim == 1:
        depth_values = depth_values[:, None, None]
    return torch.sum(prob * depth_values, dim=-3)


def max_prob_confidence(prob: torch.Tensor) -> torch.Tensor:
    """Confidence = the largest probability over depth (RED models)."""
    return torch.amax(prob, dim=-3)


def window_prob_confidence(prob: torch.Tensor, window: int = 4) -> torch.Tensor:
    """Confidence = the probability mass of a `window`-plane band around the
    regressed depth index (CasMVS/UCS): prob padded along D by window//2 − 1
    planes before and window − window//2 + 1 after (1 and 3 for window 4),
    band sums of `window` planes by cumulative sums, taken at the
    soft-argmax index Σ_d p·d truncated to an integer (JAX's astype(int32))
    and clipped to [0, D − 1].  prob (..., D, H, W) → (..., H, W)."""
    d = prob.shape[-3]
    pad_front, pad_back = window // 2 - 1, window - window // 2 + 1
    csum = torch.cumsum(F.pad(prob, (0, 0, 0, 0, pad_front, pad_back)), dim=-3)
    csum = F.pad(csum, (0, 0, 0, 0, 1, 0))
    band = csum[..., window:, :, :] - csum[..., :-window, :, :]
    idx_f = depth_regression(prob, torch.arange(d, dtype=prob.dtype, device=prob.device))
    idx = idx_f.to(torch.int32).clamp(0, d - 1).long()
    return torch.gather(band, -3, idx.unsqueeze(-3)).squeeze(-3)


def expected_variance(prob: torch.Tensor, depth_values: torch.Tensor, depth: torch.Tensor,
                      lamb: float) -> torch.Tensor:
    """UCSNet's uncertainty λ·sqrt(Σ_d p·(d − d̂)²): prob and depth_values
    (..., D, H, W) (or depth_values (D,)), depth d̂ (..., H, W) → (..., H, W)."""
    if depth_values.ndim == 1:
        depth_values = depth_values[:, None, None]
    var = torch.sum(prob * (depth_values - depth.unsqueeze(-3)) ** 2, dim=-3)
    return lamb * torch.sqrt(var)
