"""Coarse-to-fine cascade: CascadeREDNet under RPC geometry.

Counterpart of `satmvs_tpu/models/cascade.py` with regularizer="red",
geo_model="rpc", sampler="window", confidence="max", grad_method="through"
and exact per-pixel coordinates.  Two paths, chosen by whether autograd
records:

  inference (no gradient): the cost volume of every stage comes from the
    `sweep_variance` kernel;
  training (gradients): per source view the `sweep_gather` kernel
    (`ops.warp.rpc_warp`, backward `sweep_scatter`) and the variance of the
    warped views.
On both, the RED regularizer is the fused pipeline of the `conv_dn`,
`red_recur`, `deconv_up` and `conv_head` kernels (`nn/red.py`; under
autograd their backward kernels run too) when fused_red is None or True, on
every device, and its scan path (torch built-ins) when fused_red=False.

The gradient reaches a stage's depth through the next stage's window
hypotheses (JAX's grad_method="through"); only the sweep coordinates are
cut from the graph.

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
from ..ops.cost_volume import sweep_variance_volume
from ..ops.kernels.sweep_variance import sweep_variance
from ..ops.warp import RpcWarpCams, rpc_sweep_coords, rpc_warp


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


def build_train_volume(feats: torch.Tensor, cams: RpcWarpCams,
                       hyps: torch.Tensor) -> torch.Tensor:
    """`build_stage_volume`'s function, differentiable in the features: per
    sample the variance over the reference view and each source view warped
    by `rpc_warp` (one `sweep_gather` per source view)."""
    vols = []
    for i in range(feats.shape[0]):
        cams_b = cams[i]
        vols.append(sweep_variance_volume(
            feats[i, 0], feats[i, 1:], lambda src, s: rpc_warp(src, cams_b, s, hyps[i])))
    return torch.stack(vols)


class CascadeModel(nn.Module):
    """Three-stage cascade (1/4, 1/2, full resolution) with RED regularizers.

    fused_red: the RED path, None (the default) or True for the fused
    pipeline, False for the scan, with or without gradients (JAX resolves
    None by its backend, `satmvs_tpu/models/cascade.py:306-307`; the port's
    kernels run on every device, so None is the fused pipeline everywhere).
    train_fused_sweep=True (training on the fused sweep, whose backward is
    not ported) raises.
    """

    def __init__(self, ndepths: Sequence[int] = (64, 32, 8),
                 depth_intervals_ratio: Sequence[float] = (4.0, 2.0, 1.0),
                 min_interval: float = 2.5, cr_base_chs: Sequence[int] = (8, 8, 8),
                 fused_red: bool | None = None, train_fused_sweep: bool = False):
        super().__init__()
        if not len(ndepths) == len(depth_intervals_ratio) == len(cr_base_chs) == 3:
            raise ValueError("the port runs three cascade stages")
        if train_fused_sweep:
            raise NotImplementedError("train_fused_sweep=True: the backward of the fused sweep "
                                      "is not ported; training takes the per-view sweep_gather")
        self.ndepths = tuple(ndepths)
        self.depth_intervals_ratio = tuple(depth_intervals_ratio)
        self.min_interval = min_interval
        self.fused_red = fused_red
        self.train_fused_sweep = train_fused_sweep
        self.feature = FeatureNet(8)
        self.regs = nn.ModuleList(
            REDRegularizer(c, cr) for c, cr in zip(self.feature.out_channels, cr_base_chs)
        )

    def stage_intervals(self) -> list[float]:
        """Hypothesis interval of each stage (m), before the window stretch."""
        return [r * self.min_interval for r in self.depth_intervals_ratio]

    def _features(self, imgs: torch.Tensor, train: bool) -> list[torch.Tensor]:
        b, v, height, width, c = imgs.shape
        return [f.reshape(b, v, *f.shape[1:])
                for f in self.feature(imgs.reshape(b * v, height, width, c), train)]

    @torch.no_grad()
    def features(self, imgs: torch.Tensor) -> list[torch.Tensor]:
        """(B, V, H, W, 3) → per-stage features (B, V, h, w, C), coarsest first."""
        return self._features(imgs, False)

    def _stage(self, i: int, feats: torch.Tensor, cams: RpcWarpCams, d_min: torch.Tensor,
               d_max: torch.Tensor, depth: torch.Tensor | None) -> dict:
        sh, sw = feats.shape[2:4]
        hyps = stage_hypotheses(self.ndepths[i], sh, sw, d_min, d_max,
                                self.stage_intervals()[i], depth)
        if torch.is_grad_enabled():
            volume = build_train_volume(feats, cams, hyps)
        else:
            volume = build_stage_volume(feats, cams, hyps)
        prob = torch.softmax(self.regs[i](volume, self.fused_red is not False), dim=1)
        return {"depth": regression.depth_regression(prob, hyps),
                "photometric_confidence": regression.max_prob_confidence(prob)}

    @torch.no_grad()
    def stage(self, i: int, feats: torch.Tensor, cams: RpcWarpCams, d_min: torch.Tensor,
              d_max: torch.Tensor, depth: torch.Tensor | None = None) -> dict:
        """Cascade stage i (0-based) on its features (B, V, h, w, C); `depth`
        (B, h', w') is the previous stage's estimate (None at stage 0)."""
        return self._stage(i, feats, cams, d_min, d_max, depth)

    def run_cascade(self, imgs: torch.Tensor, cams: Sequence[RpcWarpCams],
                    depth_values: torch.Tensor, train: bool) -> dict:
        """The cascade under the caller's autograd mode (the module
        docstring's two paths).  train: the BatchNorms normalize with batch
        statistics and update their running ones (flax's train=True); with
        train=False and gradients, this is JAX's eval-mode gradient."""
        d_min, d_max = depth_values[:, 0], depth_values[:, -1]
        outputs = {}
        depth = None
        for i, feats in enumerate(self._features(imgs, train)):
            out = self._stage(i, feats, cams[i], d_min, d_max, depth)
            depth = out["depth"]
            outputs[f"stage{i + 1}"] = out
        outputs.update(outputs[f"stage{len(self.ndepths)}"])
        return outputs

    def forward(self, imgs: torch.Tensor, cams: Sequence[RpcWarpCams],
                depth_values: torch.Tensor, train: bool = False) -> dict:
        """train=False: inference, without gradients.  train=True: the
        training forward (flax's train=True), differentiable."""
        if train:
            return self.run_cascade(imgs, cams, depth_values, True)
        with torch.no_grad():
            return self.run_cascade(imgs, cams, depth_values, False)
