"""Multi-stage masked smooth-L1 loss.  Counterpart of
`satmvs_tpu/models/losses.py`: per-stage smooth-L1 over valid pixels,
weighted by dlossw (0.5/1.0/2.0 coarse → fine by default).

Under a data group (`group`) each rank holds a share of the global batch:
a stage's loss is this rank's sum over its valid pixels divided by the
valid-pixel count of the global batch (all-reduced, no gradient through
it).  The ranks' losses then sum to JAX's loss of the global batch, and so
do their gradients; an average of per-rank means would be another loss
wherever the ranks hold different mask counts.  Without a group the same
formula runs on the whole batch.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from ..dist.collectives import all_reduce_sum


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Huber with delta 1, elementwise."""
    diff = torch.abs(pred - target)
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """Σ x·mask / max(Σ mask, 1), the count over the group's global batch
    under a group."""
    m = mask.to(x.dtype)
    count = torch.sum(m)
    if group is not None:
        count = all_reduce_sum(count.detach(), group)
    return torch.sum(x * m) / torch.clamp(count, min=1.0)


def cascade_loss(outputs: Mapping[str, Mapping[str, torch.Tensor]],
                 depth_gt_stages: Sequence[torch.Tensor], mask_stages: Sequence[torch.Tensor],
                 dlossw: Sequence[float] | None = (0.5, 1.0, 2.0), group=None):
    """(total weighted loss, final-stage depth loss); depth_gt_stages and
    mask_stages are per-stage (B, h, w) maps, coarsest first (index i pairs
    with outputs["stage{i+1}"]).  Under a data group both are this rank's
    shares of the global batch's (see the module docstring): sum them over
    the group for the global values."""
    total = 0.0
    depth_loss = 0.0
    for i, (gt, mask) in enumerate(zip(depth_gt_stages, mask_stages)):
        est = outputs[f"stage{i + 1}"]["depth"]
        depth_loss = masked_mean(smooth_l1(est, gt), mask > 0.5, group)
        total = total + (dlossw[i] if dlossw is not None else 1.0) * depth_loss
    return total, depth_loss
