"""Evaluation metrics, masked means per image averaged over the batch.
Counterpart of `satmvs_tpu/train/metrics.py`.

Under a data group (`group`, taken by `abs_depth_error` and
`standard_metrics`, the train and eval steps' metrics) each rank holds a
share of the global batch: the per-image values are summed over the ranks
and divided by the global batch size, so every rank gets the global batch's
metric.  Without a group the same formula, Σ per-image / B, runs on the
whole batch.
"""

from __future__ import annotations

import torch

from ..dist.collectives import all_reduce_sum


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-image mask-weighted mean of (B, H, W) values → (B,)."""
    m = mask.to(values.dtype)
    return torch.sum(values * m, dim=(-2, -1)) / torch.clamp(torch.sum(m, dim=(-2, -1)), min=1.0)


def _batch_means(per_image: list[torch.Tensor], group=None) -> list[torch.Tensor]:
    """Each (B,) per-image vector's mean over the global batch: one
    all-reduce of the sums and the count under a group."""
    b = per_image[0].shape[0]
    sums = torch.stack([v.sum() for v in per_image] + [per_image[0].new_full((), float(b))])
    if group is not None:
        sums = all_reduce_sum(sums, group)
    return list((sums[:-1] / sums[-1]).unbind())


def _threshold(depth_est, depth_gt, mask, thres: float) -> torch.Tensor:
    err = torch.abs(depth_est - depth_gt)
    return _masked_mean((err < thres).to(torch.float32), mask)


def _abs_error(depth_est, depth_gt, mask, outlier_cut: float) -> torch.Tensor:
    err = torch.abs(depth_est - depth_gt)
    keep = mask.to(torch.float32) * (err < outlier_cut).to(torch.float32)
    return _masked_mean(err, keep)


def _interval(depth_est, depth_gt, interval, mask, thres: float) -> torch.Tensor:
    itv = torch.as_tensor(interval, dtype=depth_est.dtype, device=depth_est.device)
    itv = torch.broadcast_to(itv, (depth_est.shape[0],))[:, None, None]
    err = torch.abs(depth_est - depth_gt) / itv
    return _masked_mean((err < thres).to(torch.float32), mask)


def threshold_accuracy(depth_est, depth_gt, mask, thres: float) -> torch.Tensor:
    """Share of valid pixels with |err| < thres, (B, H, W) → scalar."""
    return torch.mean(_threshold(depth_est, depth_gt, mask, thres))


def abs_depth_error(depth_est, depth_gt, mask, outlier_cut: float = 250.0,
                    group=None) -> torch.Tensor:
    """Mean |err| over valid pixels, those with |err| ≥ outlier_cut left out."""
    return _batch_means([_abs_error(depth_est, depth_gt, mask, outlier_cut)], group)[0]


def interval_accuracy(depth_est, depth_gt, interval, mask, thres: float) -> torch.Tensor:
    """Share of valid pixels with |err| / interval < thres; interval is a
    scalar or per image (B,)."""
    return torch.mean(_interval(depth_est, depth_gt, interval, mask, thres))


def standard_metrics(depth_est, depth_gt, mask, min_interval: float = 2.5,
                     group=None) -> dict:
    """The evaluation bundle: MAE with the 250 m cut, accuracy within 1, 2.5
    and 7.5 m, and within 3 intervals (one all-reduce under a group)."""
    m = mask > 0.5
    names = ("abs_depth_acc", "1.0m_acc", "2.5m_acc", "7.5m_acc", "3interval_acc")
    per_image = [_abs_error(depth_est, depth_gt, m, 250.0),
                 *(_threshold(depth_est, depth_gt, m, t) for t in (1.0, 2.5, 7.5)),
                 _interval(depth_est, depth_gt, min_interval, m, 3.0)]
    return dict(zip(names, _batch_means(per_image, group)))


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
