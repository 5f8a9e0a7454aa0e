"""Evaluation metrics, masked means per image averaged over the batch.
Counterpart of `satmvs_tpu/train/metrics.py`."""

from __future__ import annotations

import torch


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-image mask-weighted mean of (B, H, W) values → (B,)."""
    m = mask.to(values.dtype)
    return torch.sum(values * m, dim=(-2, -1)) / torch.clamp(torch.sum(m, dim=(-2, -1)), min=1.0)


def threshold_accuracy(depth_est, depth_gt, mask, thres: float) -> torch.Tensor:
    """Share of valid pixels with |err| < thres, (B, H, W) → scalar."""
    err = torch.abs(depth_est - depth_gt)
    return torch.mean(_masked_mean((err < thres).to(torch.float32), mask))


def abs_depth_error(depth_est, depth_gt, mask, outlier_cut: float = 250.0) -> torch.Tensor:
    """Mean |err| over valid pixels, those with |err| ≥ outlier_cut left out."""
    err = torch.abs(depth_est - depth_gt)
    keep = mask.to(torch.float32) * (err < outlier_cut).to(torch.float32)
    return torch.mean(_masked_mean(err, keep))


def interval_accuracy(depth_est, depth_gt, interval, mask, thres: float) -> torch.Tensor:
    """Share of valid pixels with |err| / interval < thres; interval is a
    scalar or per image (B,)."""
    itv = torch.as_tensor(interval, dtype=depth_est.dtype, device=depth_est.device)
    itv = torch.broadcast_to(itv, (depth_est.shape[0],))[:, None, None]
    err = torch.abs(depth_est - depth_gt) / itv
    return torch.mean(_masked_mean((err < thres).to(torch.float32), mask))


def standard_metrics(depth_est, depth_gt, mask, min_interval: float = 2.5) -> dict:
    """The evaluation bundle: MAE with the 250 m cut, accuracy within 1, 2.5
    and 7.5 m, and within 3 intervals."""
    m = mask > 0.5
    return {
        "abs_depth_acc": abs_depth_error(depth_est, depth_gt, m, 250.0),
        "1.0m_acc": threshold_accuracy(depth_est, depth_gt, m, 1.0),
        "2.5m_acc": threshold_accuracy(depth_est, depth_gt, m, 2.5),
        "7.5m_acc": threshold_accuracy(depth_est, depth_gt, m, 7.5),
        "3interval_acc": interval_accuracy(depth_est, depth_gt, min_interval, m, 3.0),
    }


class DictAverageMeter:
    """Running mean of scalar dicts."""

    def __init__(self):
        self.data: dict[str, float] = {}
        self.count = 0

    def update(self, new: dict):
        self.count += 1
        for k, v in new.items():
            self.data[k] = self.data.get(k, 0.0) + float(v)

    def mean(self) -> dict:
        return {k: v / max(self.count, 1) for k, v in self.data.items()}
