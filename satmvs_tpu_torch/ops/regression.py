"""Probability volume → depth map and confidence.

Counterpart of `satmvs_tpu/ops/regression.py`.  prob (..., D, H, W): the
JAX functions' unbatched (D, H, W), or the cascade's batched (B, D, H, W).
"""

from __future__ import annotations

import torch


def depth_regression(prob: torch.Tensor, depth_values: torch.Tensor) -> torch.Tensor:
    """Soft-argmax Σ_d p·depth → (..., H, W); depth_values (D,) or shaped
    like prob."""
    if depth_values.ndim == 1:
        depth_values = depth_values[:, None, None]
    return torch.sum(prob * depth_values, dim=-3)


def max_prob_confidence(prob: torch.Tensor) -> torch.Tensor:
    """Confidence = the largest probability over depth (RED models)."""
    return torch.amax(prob, dim=-3)
