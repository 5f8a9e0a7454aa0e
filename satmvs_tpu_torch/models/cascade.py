"""Coarse-to-fine cascade of the three model families.

Counterpart of `satmvs_tpu/models/cascade.py` with exact per-pixel
coordinates, under either camera model: geo_model="rpc" takes per-stage
`RpcWarpCams`, or `QcWarpCams` (the `use_qc` variant, recognised by its
type as JAX recognises it), and geo_model="pinhole" takes per-stage
(B, V, 4, 4) projection matrices.  `ops.warp.sweep_coords` picks each
sample's coordinate chain by that type.  The family knobs are JAX's:
regularizer ("red" or "costreg"), sampler ("window" or "uncertainty"),
confidence ("max" or "window4"), grad_method ("through" or "detach"),
share_cr, lamb, feat_base_chs and arch_mode ("unet" or "fpn");
`models/__init__.py` sets them per family.  Two sweeps build each stage's
cost volume, chosen as JAX chooses them
(`satmvs_tpu/models/cascade.py:310-318`), with "training" meaning that
autograd records a graph:

  the fused sweep: the `sweep_variance` kernel, one launch for the whole
    batch (under autograd its backward is one `sweep_variance_backward`
    launch for the batch, which scatters as it goes); taken at
    inference, and in training with train_fused_sweep=True, unless
    fused_sweep=False;
  the per-view sweep: per source view the `sweep_gather` kernel
    (`ops.warp.rpc_warp` or `homo_warp`, backward `sweep_scatter`) and the
    variance of the warped views, stored in volume_dtype (float32, or
    bfloat16 for half the volume's bytes; the moments stay float32); taken
    in training by default, and always with fused_sweep=False (which also turns
    train_fused_sweep off, as in JAX).  volume_dtype acts on this path only.
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

Sharded cost volumes (`volume_partition`, JAX's field of the same name,
and `mesh`; set by `train.loop` under a mesh with a spatial or depth axis):
a per-stage tuple of axis names from `dist.stage_volume_specs`.  Where a
stage names "depth", each rank of the mesh's depth group takes its slab of
the hypotheses (`dist.mesh.slab_bounds`), builds that slab of the volume
and regularizes it with halo exchanges (`nn/costreg.py`); the softmax, the
regression and the confidence sum over the group (`ops/regression.py`).
Where it names "spatial", each rank of the spatial group builds the
volume of a band of reference rows (the sweep reads any source row, so the
features stay whole) and the CostRegNet regularizes the band with row
halos; the stage's maps are then gathered over the group
(`dist.halo.slab_gather`, differentiable), since the next stage's
hypotheses read them across band edges.  RED gathers the banded volume
before its pipeline instead and runs whole on each rank (the ConvGRU would
need fresh row halos at every plane of one cooperative launch, and
GroupNorm(1) normalizes whole planes: XLA's answer around a Pallas call it
cannot partition).  Stages without a sharded axis run alike on every rank.
A sharding constraint changes no value in JAX, and a rank's share here
changes none either: every rank gets the maps of the serial forward.

Four knobs of JAX's `CascadeModel` (`satmvs_tpu/models/cascade.py:
241-253,320-332`, the `torch_compat` chain at 273-292):

  coords ("exact", the default, or "coarse"): the RPC basis cameras'
    sweep coordinates exact per pixel, or on the coarse grid of
    `ops/coarse_coords.py` (JAX's default on its accelerator; ≤ 0.02 px
    from exact).  QC and pinhole cameras take their exact chain either
    way.  The first stage's uniform planes go to the coarse chain as one
    height each, which it evaluates exactly per plane (JAX hands them to
    its per-pixel quadratic fit over the whole height range: 4.7e-3 and
    1.0e-2 px from exact on the two source views at 384×768 where per
    plane is 8.2e-4 and 1.7e-3, measured on an H100); under a band or slab
    of a sharded stage the coarse fit is centred on the whole stage's
    hypotheses, so the ranks' coordinates are the serial run's.  As in
    JAX, no `Config` field or CLI flag.
  compute_dtype (None or torch.float32, or torch.bfloat16): the compute
    dtype of FeatureNet's convolutions, the RED scan path's encoder,
    decoder and head, and the CostRegNet's 3-D convolutions (`nn/`); the
    parameters, BatchNorm, the fused RED pipeline and every CUDA kernel,
    the variance moments and the geometry stay float32.  Under bf16 the
    CostRegNet takes its conv3d path (cuDNN) also at inference.
  remat: each stage's regularizer runs under `torch.utils.checkpoint`
    (non-reentrant) when autograd records: its activations are recomputed
    in the backward instead of kept.  The recompute leaves the BatchNorms'
    running statistics alone, so a train step moves them once.  JAX's
    remat calls `mdl(v)`, and `REDRegularizer.__call__` defaults to
    fused=False (`satmvs_tpu/nn/red.py:329`), so JAX's remat also sends
    RED to its scan path; that is a path choice, not another function,
    and the port checkpoints whichever RED path fused_red picks (the fused
    pipeline and its backward kernels by default), under a mesh as without
    one.  Under a mesh the regularizer holds collectives (the BatchNorms'
    group moments, the halo exchanges of a sharded stage; RED's row gather
    and the depth group's regression sums stay outside the checkpoint), so
    every rank must issue the recompute's in the same order, and the order
    is fixed, not left to autograd's scheduling: the recompute runs the
    whole regularizer (no early stop, whatever each rank saved) at once, in
    its forward's program order, and a stage's regularizer enters the
    backward only after the next stage's has left it (`_after`: the next
    stage's volume depends on this stage's depth in the graph, with no
    value and no gradient).  The gradients and running statistics are the
    bits of the step without remat, on a mesh as serially.
  torch_compat: the reference's numerics for converted checkpoints
    (`train/convert.py`): both sweeps sample where the reference's
    grid_sample reads (`ops.sampling.torch_grid_coords`, stretched by the
    source map's own height), and the window sampler takes the reference's
    chain (`stage_hypotheses(full=)`); grad_method's detach holds there
    too.

Both sweeps take coordinates from any of the three chains.  JAX on the TPU
sends pinhole cameras to the per-view sweep always
(`satmvs_tpu/models/cascade.py:137-148`, "pinhole warp has no native-hcw
path"): a layout limit of its Mosaic kernels, not part of the math.  The
port's `sweep_variance` kernel samples at whatever coordinates it is given
and computes the same variance, so a pinhole stage takes the sweep the
knobs choose, as an RPC stage does.

Input (channels-last, view 0 = reference view):
  imgs          (B, V, H, W, 3)
  cams          per-stage tuple, coarsest first: batched RpcWarpCams or
                QcWarpCams (rpc), or (B, V, 4, 4) projection matrices
                (pinhole)
  depth_values  (B, 2) = [d_min, d_max]: the scene's height range (rpc)
                or depth range along the reference camera's axis (pinhole)
Output: {"stage{i}": {"depth", "photometric_confidence"}, and "variance"
with sampler="uncertainty"} (stage1 the coarsest) plus the final stage's
entries at the top level.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..dist.halo import slab_gather
from ..nn.blocks import frozen_running_stats
from ..nn.costreg import CostRegNet
from ..nn.featurenet import FeatureNet
from ..nn.red import REDRegularizer
from ..ops import depth_range, regression
from ..ops.cost_volume import sweep_variance_volume
from ..ops.kernels.sweep_variance import sweep_variance_batched
from ..ops.warp import COORDS, homo_warp, rpc_warp, sample_coords

# each stage's downscale of the image, by stage count (JAX's, `satmvs_tpu/models/cascade.py:40`)
STAGE_SCALES = {3: (4, 2, 1), 2: (4, 1), 1: (4,)}


def stage_hypotheses(nd: int, sh: int, sw: int, d_min: torch.Tensor, d_max: torch.Tensor,
                     interval: float, depth: torch.Tensor | None = None,
                     exp_var: torch.Tensor | None = None, sampler: str = "window",
                     detach: bool = False, full: tuple[int, int] | None = None) -> torch.Tensor:
    """Height hypotheses (B, D, sh, sw) of one stage: a uniform sweep of the
    scene range at the first stage (depth None), else a per-pixel window
    around the previous stage's depth (B, h, w) upsampled to (sh, sw): of
    ±(nd/2)·interval (sampler "window"), or of ± the previous stage's
    upsampled spread exp_var (B, h, w) clamped to the scene range
    ("uncertainty", UCSNet).  detach: no gradient through depth and exp_var.

    full: the image's (H, W) for the reference's window chain (the
    torch_compat mode, `satmvs_tpu/models/cascade.py:273-292`): the previous
    depth upsampled to full resolution, the window taken there, and the
    hypotheses brought down to (sh, sw) by a linear resize with half-pixel
    centres and no antialiasing (jax.image.resize "trilinear" with D kept),
    which slightly smooths them against the direct window.  The window
    sampler only; None: the direct window."""
    if depth is None:
        return torch.stack([depth_range.uniform_samples(lo, hi, nd, sh, sw)
                            for lo, hi in zip(d_min, d_max)])
    depth = depth.detach() if detach else depth
    if full is not None and sampler == "window":
        cur = depth_range.upsample_map(depth, *full)
        hyps = torch.stack([depth_range.window_samples(c, nd, interval) for c in cur])
        return F.interpolate(hyps, size=(sh, sw), mode="bilinear", align_corners=False,
                             antialias=False)
    cur = depth_range.upsample_map(depth, sh, sw)
    if sampler == "uncertainty":
        ev = depth_range.upsample_map(exp_var.detach() if detach else exp_var, sh, sw)
        return torch.stack([depth_range.uncertainty_samples(c, e, nd, lo, hi)
                            for c, e, lo, hi in zip(cur, ev, d_min, d_max)])
    return torch.stack([depth_range.window_samples(c, nd, interval) for c in cur])


def _stage_coords(feats: torch.Tensor, cams, hyps: torch.Tensor, row0: int, coords: str,
                  convention: str, window: torch.Tensor | None):
    """xs, ys (B, S, D, h', w) of every sample and source view, as the sweep
    kernels sample them (`ops.warp.sample_coords`)."""
    b, v, h, w, _ = feats.shape
    hb = hyps.shape[2]
    cs = [sample_coords(cams[i], s, hyps[i], hb, w, (h, w), row0, coords, convention,
                        None if window is None else window[i])
          for i in range(b) for s in range(v - 1)]
    return torch.stack([c[k] for k in (0, 1) for c in cs]).view(
        2, b, v - 1, *hyps.shape[1:]).unbind(0)


def build_stage_volume(feats: torch.Tensor, cams, hyps: torch.Tensor, row0: int = 0,
                       coords: str = "exact", convention: str = "exact",
                       window: torch.Tensor | None = None) -> torch.Tensor:
    """(B, V, h, w, C) features + batched cameras (of any of the three
    types) + (B, D, h', w) hypotheses of the reference rows row0 .. row0 +
    h' − 1 (all h rows, or a rank's band) → (B, D, h', w, C) variance cost
    volume: every sample's sweep coordinates (`ops.warp.sample_coords`:
    coords "exact" or "coarse", convention "exact" or "torch"; window
    (B, D, h, w), the whole stage's hypotheses a coarse fit is centred on
    when hyps are a band or slab of them, or (B, D) heights when hyps are
    planes of one height each) in one stack, then one
    `sweep_variance_batched` for the batch (the fused sweep;
    differentiable in the features)."""
    xs, ys = _stage_coords(feats, cams, hyps, row0, coords, convention, window)
    return sweep_variance_batched(feats, xs, ys, row0)


def build_train_volume(feats: torch.Tensor, cams, hyps: torch.Tensor,
                       volume_dtype: torch.dtype | None = None, row0: int = 0,
                       coords: str = "exact", convention: str = "exact",
                       window: torch.Tensor | None = None) -> torch.Tensor:
    """`build_stage_volume`'s function on the per-view sweep: per sample the
    variance over the reference view and each source view warped by
    `rpc_warp` (either RPC form) or `homo_warp` (pinhole): one
    `sweep_gather` per source view, its volume stored in volume_dtype
    (None: float32); a band of rows, coords, convention and window as
    there."""
    vols = []
    hb = hyps.shape[2]
    for i in range(feats.shape[0]):
        cams_b = cams[i]
        if isinstance(cams_b, torch.Tensor):
            def warp(src, s):
                return homo_warp(src, cams_b[s + 1], cams_b[0], hyps[i], convention,
                                 volume_dtype, row0)
        else:
            win = None if window is None else window[i]

            def warp(src, s):
                return rpc_warp(src, cams_b, s, hyps[i], convention, volume_dtype, row0, coords,
                                win)
        vols.append(sweep_variance_volume(feats[i, 0, row0:row0 + hb], feats[i, 1:], warp))
    return torch.stack(vols)


def _remat_contexts():
    """The forward runs as it is; its recompute in the backward leaves the
    BatchNorms' running statistics alone, so a train-mode step moves them
    once, as flax's `nn.remat` does."""
    return contextlib.nullcontext(), frozen_running_stats()


class _After(torch.autograd.Function):
    """x as it is, its graph node depending on `before` with no value and no
    gradient: the backward reaches `before` only after x's cotangent is
    complete."""

    @staticmethod
    def forward(ctx, x, before):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _after(x: torch.Tensor, before: torch.Tensor | None) -> torch.Tensor:
    """x, ordered in the backward before `before` (when it has a graph)."""
    if before is None or not before.requires_grad:
        return x
    return _After.apply(x, before)


_KNOBS = {"geo_model": ("rpc", "pinhole"), "regularizer": ("red", "costreg"),
          "sampler": ("window", "uncertainty"), "confidence": ("max", "window4"),
          "grad_method": ("through", "detach"), "arch_mode": ("unet", "fpn")}


class CascadeModel(nn.Module):
    """The cascade of len(ndepths) stages, as JAX counts them: three (1/4,
    1/2 and full resolution), or one (1/4 alone; the top-level maps are
    stage 1's); two raise in FeatureNet (JAX fails on the shapes), before
    any weight is built.  depth_intervals_ratio and
    cr_base_chs give one entry a stage and may be longer: JAX indexes them
    by stage, so its CLI defaults serve `--ndepths 64`; a shorter one
    raises.  The knobs as in the module docstring, JAX's defaults
    (CascadeREDNet's).  geo_model ("rpc"
    or "pinhole") names the cameras the model takes; cameras of the other
    model raise.

    fused_red: the RED path, None (the default) or True for the fused
    pipeline, False for the scan, with or without gradients (JAX resolves
    None by its backend, `satmvs_tpu/models/cascade.py:306-307`; the port's
    kernels run on every device, so None is the fused pipeline everywhere).
    train_fused_sweep, fused_sweep (None: True) and volume_dtype (None or
    torch.float32, or torch.bfloat16) choose the sweep as the module
    docstring says.  share_cr=True (one regularizer for every stage)
    raises: the stages' features have 4b, 2b and b channels, which one
    regularizer's first convolution cannot take (JAX's fails the same way,
    on the parameter's shape).  volume_partition and mesh: the sharded
    cost volumes of the module docstring (None: every stage whole); a
    "depth" stage of the RED regularizer raises, as JAX's trainer refuses
    it.  coords, compute_dtype, remat and torch_compat: the module
    docstring's four knobs (defaults: exact coordinates, float32, no
    remat, native sampling).
    """

    def __init__(self, ndepths: Sequence[int] = (64, 32, 8),
                 depth_intervals_ratio: Sequence[float] = (4.0, 2.0, 1.0),
                 min_interval: float = 2.5, cr_base_chs: Sequence[int] = (8, 8, 8),
                 fused_red: bool | None = None, train_fused_sweep: bool = False,
                 fused_sweep: bool | None = None, volume_dtype: torch.dtype | None = None,
                 regularizer: str = "red", sampler: str = "window", confidence: str = "max",
                 grad_method: str = "through", share_cr: bool = False, lamb: float = 1.5,
                 feat_base_chs: int = 8, arch_mode: str = "unet", geo_model: str = "rpc",
                 volume_partition=None, mesh=None, coords: str = "exact",
                 compute_dtype: torch.dtype | None = None, remat: bool = False,
                 torch_compat: bool = False):
        super().__init__()
        num_stage = len(ndepths)
        for knob, values in (("depth_intervals_ratio", depth_intervals_ratio),
                             ("cr_base_chs", cr_base_chs)):
            if len(values) < num_stage:
                raise ValueError(f"{knob}={tuple(values)}: {len(values)} entries for "
                                 f"{num_stage} stages (ndepths={tuple(ndepths)})")
        for knob, value in (("geo_model", geo_model), ("regularizer", regularizer),
                            ("sampler", sampler), ("confidence", confidence),
                            ("grad_method", grad_method), ("arch_mode", arch_mode)):
            if value not in _KNOBS[knob]:
                raise ValueError(f"{knob}={value!r}: want one of {_KNOBS[knob]}")
        self.geo_model = geo_model
        self.ndepths = tuple(ndepths)
        self.depth_intervals_ratio = tuple(depth_intervals_ratio[:num_stage])
        self.min_interval = min_interval
        self.fused_red = fused_red
        self.train_fused_sweep = train_fused_sweep
        self.fused_sweep = fused_sweep
        if volume_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"volume_dtype={volume_dtype!r}: want None, torch.float32 or "
                             f"torch.bfloat16")
        self.volume_dtype = None if volume_dtype == torch.float32 else volume_dtype
        self.regularizer, self.sampler, self.confidence = regularizer, sampler, confidence
        self.grad_method, self.lamb = grad_method, lamb
        if share_cr:
            raise ValueError("share_cr=True: one regularizer cannot take the stages' "
                             "4b, 2b and b feature channels")
        if coords not in COORDS:
            raise ValueError(f"coords={coords!r}: want one of {COORDS}")
        if compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype={compute_dtype!r}: want None, torch.float32 or "
                             f"torch.bfloat16")
        self.coords, self.remat, self.torch_compat = coords, remat, torch_compat
        self.compute_dtype = dt = None if compute_dtype == torch.float32 else compute_dtype
        self.feature = FeatureNet(feat_base_chs, arch_mode, dt, num_stage)
        self.regs = nn.ModuleList(
            REDRegularizer(c, cr, dt) if regularizer == "red" else CostRegNet(c, cr, dtype=dt)
            for c, cr in zip(self.feature.out_channels, cr_base_chs))
        self.partition(volume_partition, mesh)

    def partition(self, volume_partition, mesh) -> None:
        """Set the sharded cost volumes (module docstring): a per-stage
        tuple of volume axis-name tuples (`dist.stage_volume_specs`) or
        None, and the mesh whose groups split them."""
        if volume_partition is not None:
            volume_partition = tuple(tuple(spec) for spec in volume_partition)
            if len(volume_partition) != len(self.ndepths):
                raise ValueError(f"volume_partition: {len(volume_partition)} specs for "
                                 f"{len(self.ndepths)} stages")
            if self.regularizer == "red" and any(spec[1] for spec in volume_partition):
                raise ValueError("depth-slab sharding applies to the 3-D conv regularizers "
                                 "(casmvs/ucs); the RED recurrence scans depth sequentially")
        self.volume_partition, self.mesh = volume_partition, mesh

    def stage_shard(self, i: int, height: int):
        """Stage i's `dist.halo.Shard` on this rank (its volume's extent
        along the sharded axis: ndepths[i] planes or `height` rows), or
        None when the stage is whole."""
        if self.volume_partition is None or self.mesh is None:
            return None
        _, depth, spatial, *_ = self.volume_partition[i]
        if depth:
            return self.mesh.shard("depth", self.ndepths[i])
        if spatial:
            return self.mesh.shard("spatial", height)
        return None

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
        """Stage i's hypotheses (`stage_hypotheses` under this model's knobs;
        with torch_compat the reference's window chain at the image's size,
        the stage's times its scale: 4, 2 or 1 of three stages, 4 of one)."""
        scale = STAGE_SCALES[len(self.ndepths)][i]
        return stage_hypotheses(self.ndepths[i], sh, sw, d_min, d_max,
                                self.stage_intervals()[i], depth, exp_var, self.sampler,
                                self.grad_method == "detach",
                                (sh * scale, sw * scale) if self.torch_compat else None)

    @property
    def convention(self) -> str:
        """The sweeps' sampling convention: "torch" under torch_compat."""
        return "torch" if self.torch_compat else "exact"

    def _stage(self, i: int, feats: torch.Tensor, cams, d_min: torch.Tensor,
               d_max: torch.Tensor, depth: torch.Tensor | None,
               exp_var: torch.Tensor | None = None, train: bool = False) -> dict:
        if isinstance(cams, torch.Tensor) != (self.geo_model == "pinhole"):
            raise ValueError(f"a geo_model={self.geo_model!r} model was given "
                             f"{type(cams).__name__} cameras")
        sh, sw = feats.shape[2:4]
        hyps = self.hypotheses(i, sh, sw, d_min, d_max, depth, exp_var)
        shard = self.stage_shard(i, sh)
        row0, whole = 0, hyps
        if shard is not None:  # this rank's slab of hypothesis planes or band of rows
            hyps = (hyps[:, shard.lo:shard.hi] if shard.axis == "depth" else
                    hyps[:, :, shard.lo:shard.hi])
            row0 = shard.lo if shard.axis == "spatial" else 0
        window = None  # coarse: the first stage's planes, else the whole stage's window
        if self.coords == "coarse":
            window = hyps[:, :, 0, 0] if depth is None else whole
        if self.fused_sweep is not False and (self.train_fused_sweep
                                              or not torch.is_grad_enabled()):
            volume = build_stage_volume(feats, cams, hyps, row0, self.coords, self.convention,
                                        window)
        else:
            volume = build_train_volume(feats, cams, hyps, self.volume_dtype, row0, self.coords,
                                        self.convention, window)
        if self.regularizer == "red":
            if shard is not None:  # the whole volume on every rank (module docstring)
                volume, hyps, shard = slab_gather(volume, 2, shard), whole, None

            def regularize(v):
                return self.regs[i](v, self.fused_red is not False)
        else:
            def regularize(v):
                return self.regs[i](v, train, shard)
        if self.remat and torch.is_grad_enabled():
            # recomputed whole, after the next stage's regularizer (module docstring)
            with set_checkpoint_early_stop(False):
                logits = checkpoint(regularize, _after(volume, depth), use_reentrant=False,
                                    preserve_rng_state=False, context_fn=_remat_contexts)
        else:
            logits = regularize(volume)
        dshard = shard if shard is not None and shard.axis == "depth" else None
        prob = regression.softmax_depth(logits, dshard)
        depth = regression.depth_regression(prob, hyps, dshard)
        if self.confidence == "window4":
            conf = regression.window_prob_confidence(prob, 4, dshard)
        else:
            conf = regression.max_prob_confidence(prob, dshard)
        out = {"depth": depth, "photometric_confidence": conf}
        if self.sampler == "uncertainty":
            out["variance"] = regression.expected_variance(prob, hyps, depth, self.lamb, dshard)
        if shard is not None and shard.axis == "spatial":  # every rank the whole maps
            out = {k: slab_gather(v, 1, shard) for k, v in out.items()}
        return out

    @torch.no_grad()
    def stage(self, i: int, feats: torch.Tensor, cams, d_min: torch.Tensor,
              d_max: torch.Tensor, depth: torch.Tensor | None = None,
              exp_var: torch.Tensor | None = None) -> dict:
        """Cascade stage i (0-based) on its features (B, V, h, w, C); `depth`
        (B, h', w') is the previous stage's estimate and `exp_var` its
        "variance" output (None at stage 0, and exp_var None unless
        sampler="uncertainty")."""
        return self._stage(i, feats, cams, d_min, d_max, depth, exp_var)

    def run_cascade(self, imgs: torch.Tensor, cams: Sequence,
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

    def forward(self, imgs: torch.Tensor, cams: Sequence,
                depth_values: torch.Tensor, train: bool = False) -> dict:
        """train=False: inference, without gradients.  train=True: the
        training forward (flax's train=True), differentiable."""
        if train:
            return self.run_cascade(imgs, cams, depth_values, True)
        with torch.no_grad():
            return self.run_cascade(imgs, cams, depth_values, False)
