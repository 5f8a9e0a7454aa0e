"""Multi-stage masked smooth-L1 loss.  Counterpart of
`satmvs_tpu/models/losses.py`: per-stage smooth-L1 over valid pixels,
weighted by dlossw (0.5/1.0/2.0 coarse → fine by default)."""

from __future__ import annotations

from typing import Mapping, Sequence

import torch


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Huber with delta 1, elementwise."""
    diff = torch.abs(pred - target)
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def cascade_loss(outputs: Mapping[str, Mapping[str, torch.Tensor]],
                 depth_gt_stages: Sequence[torch.Tensor], mask_stages: Sequence[torch.Tensor],
                 dlossw: Sequence[float] | None = (0.5, 1.0, 2.0)):
    """(total weighted loss, final-stage depth loss); depth_gt_stages and
    mask_stages are per-stage (B, h, w) maps, coarsest first (index i pairs
    with outputs["stage{i+1}"])."""
    total = 0.0
    depth_loss = 0.0
    for i, (gt, mask) in enumerate(zip(depth_gt_stages, mask_stages)):
        est = outputs[f"stage{i + 1}"]["depth"]
        depth_loss = masked_mean(smooth_l1(est, gt), mask > 0.5)
        total = total + (dlossw[i] if dlossw is not None else 1.0) * depth_loss
    return total, depth_loss
