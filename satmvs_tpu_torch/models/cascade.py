"""Coarse-to-fine cascade of the three model families under RPC geometry.

Counterpart of `satmvs_tpu/models/cascade.py` with geo_model="rpc" and
exact per-pixel coordinates.  The family knobs are JAX's: regularizer
("red" or "costreg"), sampler ("window" or "uncertainty"), confidence
("max" or "window4"), grad_method ("through" or "detach"), share_cr, lamb,
feat_base_chs and arch_mode ("unet" or "fpn"); `models/__init__.py` sets
them per family.  Two paths, chosen by whether autograd records:

  inference (no gradient): the cost volume of every stage comes from the
    `sweep_variance` kernel, one launch for the whole batch;
  training (gradients): per source view the `sweep_gather` kernel
    (`ops.warp.rpc_warp`, backward `sweep_scatter`) and the variance of the
    warped views.
On both, the RED regularizer is the fused pipeline of the `conv_dn`,
`red_recur`, `deconv_up` and `conv_head` kernels (`nn/red.py`; under
autograd their backward kernels run too) when fused_red is None or True, on
every device, and its scan path (torch built-ins) when fused_red=False.
The costreg regularizer (`nn/costreg.py`) runs packed on the plane-conv
kernels at inference and as 3-D convolutions under autograd; its volume is
`build_stage_volume`'s (B, D, h, w, C), JAX's "nhwc" layout for costreg.

With grad_method="through" the gradient reaches a stage's depth through the
next stage's hypotheses; "detach" cuts it there.  The sweep coordinates are
always cut from the graph.

Input (channels-last, view 0 = reference view):
  imgs          (B, V, H, W, 3)
  cams          per-stage tuple of batched RpcWarpCams, coarsest first
  depth_values  (B, 2) = [h_min, h_max] scene height range
Output: {"stage{i}": {"depth", "photometric_confidence"}, and "variance"
with sampler="uncertainty"} (stage1 the coarsest) plus the final stage's
entries at the top level.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..nn.costreg import CostRegNet
from ..nn.featurenet import FeatureNet
from ..nn.red import REDRegularizer
from ..ops import depth_range, regression
from ..ops.cost_volume import sweep_variance_volume
from ..ops.kernels.sweep_variance import sweep_variance_batched
from ..ops.warp import RpcWarpCams, rpc_sweep_coords, rpc_warp


def stage_hypotheses(nd: int, sh: int, sw: int, d_min: torch.Tensor, d_max: torch.Tensor,
                     interval: float, depth: torch.Tensor | None = None,
                     exp_var: torch.Tensor | None = None, sampler: str = "window",
                     detach: bool = False) -> torch.Tensor:
    """Height hypotheses (B, D, sh, sw) of one stage: a uniform sweep of the
    scene range at the first stage (depth None), else a per-pixel window
    around the previous stage's depth (B, h, w) upsampled to (sh, sw): of
    ±(nd/2)·interval (sampler "window"), or of ± the previous stage's
    upsampled spread exp_var (B, h, w) clamped to the scene range
    ("uncertainty", UCSNet).  detach: no gradient through depth and exp_var."""
    if depth is None:
        return torch.stack([depth_range.uniform_samples(lo, hi, nd, sh, sw)
                            for lo, hi in zip(d_min, d_max)])
    cur = depth_range.upsample_map(depth.detach() if detach else depth, sh, sw)
    if sampler == "uncertainty":
        ev = depth_range.upsample_map(exp_var.detach() if detach else exp_var, sh, sw)
        return torch.stack([depth_range.uncertainty_samples(c, e, nd, lo, hi)
                            for c, e, lo, hi in zip(cur, ev, d_min, d_max)])
    return torch.stack([depth_range.window_samples(c, nd, interval) for c in cur])


def build_stage_volume(feats: torch.Tensor, cams: RpcWarpCams,
                       hyps: torch.Tensor) -> torch.Tensor:
    """(B, V, h, w, C) features + batched cameras + (B, D, h, w) hypotheses
    → (B, D, h, w, C) variance cost volume: every sample's sweep
    coordinates in one stack, then one `sweep_variance_batched` for the
    batch."""
    b, v, sh, sw, _ = feats.shape
    per_sample = [cams[i] for i in range(b)]
    coords = [rpc_sweep_coords(per_sample[i], s, hyps[i], sh, sw)
              for i in range(b) for s in range(v - 1)]
    xs, ys = torch.stack([c[k] for k in (0, 1) for c in coords]).view(
        2, b, v - 1, *hyps.shape[1:]).unbind(0)
    return sweep_variance_batched(feats, xs, ys)


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


_KNOBS = {"regularizer": ("red", "costreg"), "sampler": ("window", "uncertainty"),
          "confidence": ("max", "window4"), "grad_method": ("through", "detach"),
          "arch_mode": ("unet", "fpn")}


class CascadeModel(nn.Module):
    """Three-stage cascade (1/4, 1/2, full resolution); the knobs as in the
    module docstring, JAX's defaults (CascadeREDNet's).

    fused_red: the RED path, None (the default) or True for the fused
    pipeline, False for the scan, with or without gradients (JAX resolves
    None by its backend, `satmvs_tpu/models/cascade.py:306-307`; the port's
    kernels run on every device, so None is the fused pipeline everywhere).
    train_fused_sweep=True (training on the fused sweep, whose backward is
    not ported) raises.  share_cr=True (one regularizer for every stage)
    raises: the stages' features have 4b, 2b and b channels, which one
    regularizer's first convolution cannot take (JAX's fails the same way,
    on the parameter's shape).
    """

    def __init__(self, ndepths: Sequence[int] = (64, 32, 8),
                 depth_intervals_ratio: Sequence[float] = (4.0, 2.0, 1.0),
                 min_interval: float = 2.5, cr_base_chs: Sequence[int] = (8, 8, 8),
                 fused_red: bool | None = None, train_fused_sweep: bool = False,
                 regularizer: str = "red", sampler: str = "window", confidence: str = "max",
                 grad_method: str = "through", share_cr: bool = False, lamb: float = 1.5,
                 feat_base_chs: int = 8, arch_mode: str = "unet"):
        super().__init__()
        if not len(ndepths) == len(depth_intervals_ratio) == len(cr_base_chs) == 3:
            raise ValueError("the port runs three cascade stages")
        if train_fused_sweep:
            raise NotImplementedError("train_fused_sweep=True: the backward of the fused sweep "
                                      "is not ported; training takes the per-view sweep_gather")
        for knob, value in (("regularizer", regularizer), ("sampler", sampler),
                            ("confidence", confidence), ("grad_method", grad_method),
                            ("arch_mode", arch_mode)):
            if value not in _KNOBS[knob]:
                raise ValueError(f"{knob}={value!r}: want one of {_KNOBS[knob]}")
        self.ndepths = tuple(ndepths)
        self.depth_intervals_ratio = tuple(depth_intervals_ratio)
        self.min_interval = min_interval
        self.fused_red = fused_red
        self.train_fused_sweep = train_fused_sweep
        self.regularizer, self.sampler, self.confidence = regularizer, sampler, confidence
        self.grad_method, self.lamb = grad_method, lamb
        if share_cr:
            raise ValueError("share_cr=True: one regularizer cannot take the stages' "
                             "4b, 2b and b feature channels")
        self.feature = FeatureNet(feat_base_chs, arch_mode)
        reg = REDRegularizer if regularizer == "red" else CostRegNet
        self.regs = nn.ModuleList(
            reg(c, cr) for c, cr in zip(self.feature.out_channels, cr_base_chs))

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

    def hypotheses(self, i: int, sh: int, sw: int, d_min: torch.Tensor, d_max: torch.Tensor,
                   depth: torch.Tensor | None, exp_var: torch.Tensor | None) -> torch.Tensor:
        """Stage i's hypotheses (`stage_hypotheses` under this model's knobs)."""
        return stage_hypotheses(self.ndepths[i], sh, sw, d_min, d_max,
                                self.stage_intervals()[i], depth, exp_var, self.sampler,
                                self.grad_method == "detach")

    def _stage(self, i: int, feats: torch.Tensor, cams: RpcWarpCams, d_min: torch.Tensor,
               d_max: torch.Tensor, depth: torch.Tensor | None,
               exp_var: torch.Tensor | None = None, train: bool = False) -> dict:
        sh, sw = feats.shape[2:4]
        hyps = self.hypotheses(i, sh, sw, d_min, d_max, depth, exp_var)
        if torch.is_grad_enabled():
            volume = build_train_volume(feats, cams, hyps)
        else:
            volume = build_stage_volume(feats, cams, hyps)
        if self.regularizer == "red":
            logits = self.regs[i](volume, self.fused_red is not False)
        else:
            logits = self.regs[i](volume, train)
        prob = torch.softmax(logits, dim=1)
        depth = regression.depth_regression(prob, hyps)
        if self.confidence == "window4":
            conf = regression.window_prob_confidence(prob, 4)
        else:
            conf = regression.max_prob_confidence(prob)
        out = {"depth": depth, "photometric_confidence": conf}
        if self.sampler == "uncertainty":
            out["variance"] = regression.expected_variance(prob, hyps, depth, self.lamb)
        return out

    @torch.no_grad()
    def stage(self, i: int, feats: torch.Tensor, cams: RpcWarpCams, d_min: torch.Tensor,
              d_max: torch.Tensor, depth: torch.Tensor | None = None,
              exp_var: torch.Tensor | None = None) -> dict:
        """Cascade stage i (0-based) on its features (B, V, h, w, C); `depth`
        (B, h', w') is the previous stage's estimate and `exp_var` its
        "variance" output (None at stage 0, and exp_var None unless
        sampler="uncertainty")."""
        return self._stage(i, feats, cams, d_min, d_max, depth, exp_var)

    def run_cascade(self, imgs: torch.Tensor, cams: Sequence[RpcWarpCams],
                    depth_values: torch.Tensor, train: bool) -> dict:
        """The cascade under the caller's autograd mode (the module
        docstring's two paths).  train: the BatchNorms normalize with batch
        statistics and update their running ones (flax's train=True); with
        train=False and gradients, this is JAX's eval-mode gradient."""
        d_min, d_max = depth_values[:, 0], depth_values[:, -1]
        outputs = {}
        depth = exp_var = None
        for i, feats in enumerate(self._features(imgs, train)):
            out = self._stage(i, feats, cams[i], d_min, d_max, depth, exp_var, train)
            depth, exp_var = out["depth"], out.get("variance")
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
