"""Coarse-to-fine cascade: CascadeREDNet under RPC geometry, inference.

Counterpart of `satmvs_tpu/models/cascade.py` with regularizer="red",
geo_model="rpc", sampler="window", confidence="max" and the JAX model's
default fused RED regularizer (fused_red=True).  The cost volume of every
stage comes from the `sweep_variance` kernel, and its RED regularizer runs
the `conv_dn`, `red_recur`, `deconv_up` and `conv_head` kernels
(`nn/red.py`).

Input (channels-last, view 0 = reference view):
  imgs          (B, V, H, W, 3)
  cams          per-stage tuple of batched RpcWarpCams, coarsest first
  depth_values  (B, 2) = [h_min, h_max] scene height range
Output: {"stage{i}": {"depth", "photometric_confidence"}} (stage1 the
coarsest) plus the final stage's entries at the top level.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..nn.featurenet import FeatureNet
from ..nn.red import REDRegularizer
from ..ops import depth_range, regression
from ..ops.kernels.sweep_variance import sweep_variance
from ..ops.warp import RpcWarpCams, rpc_sweep_coords


def stage_hypotheses(nd: int, sh: int, sw: int, d_min: torch.Tensor, d_max: torch.Tensor,
                     interval: float, depth: torch.Tensor | None = None) -> torch.Tensor:
    """Height hypotheses (B, D, sh, sw) of one stage: a uniform sweep of the
    scene range at the first stage (depth None), else a per-pixel window
    around the previous stage's depth (B, h, w) upsampled to (sh, sw)."""
    if depth is None:
        return torch.stack([depth_range.uniform_samples(lo, hi, nd, sh, sw)
                            for lo, hi in zip(d_min, d_max)])
    cur = depth_range.upsample_map(depth, sh, sw)
    return torch.stack([depth_range.window_samples(c, nd, interval) for c in cur])


def build_stage_volume(feats: torch.Tensor, cams: RpcWarpCams,
                       hyps: torch.Tensor) -> torch.Tensor:
    """(B, V, h, w, C) features + batched cameras + (B, D, h, w) hypotheses
    → (B, D, h, w, C) variance cost volume, one `sweep_variance` per sample."""
    b, v, sh, sw, _ = feats.shape
    vols = []
    for i in range(b):
        cams_b = cams[i]
        coords = [rpc_sweep_coords(cams_b, s, hyps[i], sh, sw) for s in range(v - 1)]
        xs = torch.stack([c[0] for c in coords])
        ys = torch.stack([c[1] for c in coords])
        vols.append(sweep_variance(feats[i, 0], feats[i, 1:], xs, ys))
    return torch.stack(vols)


class CascadeModel(nn.Module):
    """Three-stage cascade (1/4, 1/2, full resolution) with RED regularizers."""

    def __init__(self, ndepths: Sequence[int] = (64, 32, 8),
                 depth_intervals_ratio: Sequence[float] = (4.0, 2.0, 1.0),
                 min_interval: float = 2.5, cr_base_chs: Sequence[int] = (8, 8, 8)):
        super().__init__()
        if not len(ndepths) == len(depth_intervals_ratio) == len(cr_base_chs) == 3:
            raise ValueError("the port runs three cascade stages")
        self.ndepths = tuple(ndepths)
        self.depth_intervals_ratio = tuple(depth_intervals_ratio)
        self.min_interval = min_interval
        self.feature = FeatureNet(8)
        self.regs = nn.ModuleList(
            REDRegularizer(c, cr) for c, cr in zip(self.feature.out_channels, cr_base_chs)
        )

    def stage_intervals(self) -> list[float]:
        """Hypothesis interval of each stage (m), before the window stretch."""
        return [r * self.min_interval for r in self.depth_intervals_ratio]

    @torch.no_grad()
    def features(self, imgs: torch.Tensor) -> list[torch.Tensor]:
        """(B, V, H, W, 3) → per-stage features (B, V, h, w, C), coarsest first."""
        b, v, height, width, c = imgs.shape
        return [f.reshape(b, v, *f.shape[1:])
                for f in self.feature(imgs.reshape(b * v, height, width, c))]

    @torch.no_grad()
    def stage(self, i: int, feats: torch.Tensor, cams: RpcWarpCams, d_min: torch.Tensor,
              d_max: torch.Tensor, depth: torch.Tensor | None = None) -> dict:
        """Cascade stage i (0-based) on its features (B, V, h, w, C); `depth`
        (B, h', w') is the previous stage's estimate (None at stage 0)."""
        sh, sw = feats.shape[2:4]
        hyps = stage_hypotheses(self.ndepths[i], sh, sw, d_min, d_max,
                                self.stage_intervals()[i], depth)
        volume = build_stage_volume(feats, cams, hyps)
        prob = torch.softmax(self.regs[i](volume), dim=1)  # (B, D, h, w)
        return {"depth": regression.depth_regression(prob, hyps),
                "photometric_confidence": regression.max_prob_confidence(prob)}

    @torch.no_grad()
    def forward(self, imgs: torch.Tensor, cams: Sequence[RpcWarpCams],
                depth_values: torch.Tensor) -> dict:
        d_min, d_max = depth_values[:, 0], depth_values[:, -1]
        outputs = {}
        depth = None
        for i, feats in enumerate(self.features(imgs)):
            out = self.stage(i, feats, cams[i], d_min, d_max, depth)
            depth = out["depth"]
            outputs[f"stage{i + 1}"] = out
        outputs.update(outputs[f"stage{len(self.ndepths)}"])
        return outputs
