"""Training and evaluation: the train and eval steps, RMSprop with an LR
stepped at epoch boundaries, the epoch loop with logging and checkpoints.

Counterpart of `satmvs_tpu/train/loop.py`, on one GPU or over the ranks of
a mesh (`dist`, JAX's mesh path `satmvs_tpu/train/loop.py:203-265`): every
rank holds the whole state, replicated from rank 0, runs the step on its
data-axis share of each global batch with BatchNorm's moments, the loss's
mask counts and the metrics taken over the global batch, and sums the
gradients over the ranks before the update, so the replicas stay identical
and the step is JAX's step on the global batch.  Under a spatial or depth
axis the ranks of a group share a batch and split each sharded stage's
cost volume (`models.cascade`, JAX's `volume_partition` from
`stage_volume_specs` with the height of the first batch): a map that every
rank of a group computes alike enters each rank's loss at 1/G of its
weight, which the mask count over the whole mesh gives (`models.losses`),
so the ranks' losses and gradients still sum to the serial ones; the
FeatureNet's BatchNorms take their moments over the data group (their
input is alike on a group's ranks), a sharded stage's CostRegNet over the
whole mesh (each rank holds another slab).  A mesh of one rank gives the
serial step's bits.  JAX's
functional state becomes tensors updated in place: a `TrainState` holds the
model's own parameter and running-statistic tensors by name, the
optimizer's state and the step count; `train_step(state, batch)` updates
them all and returns the same state.  The BatchNorm running statistics are
kept apart from the parameters, as flax keeps `batch_stats` apart: the
optimizer never touches them, the train-mode forward moves them.

Batches are `data.synthetic.make_batch(..., with_gt=True)` dicts on the
model's device: imgs, cams, depth_values, depth_stages, mask_stages.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Optional

import torch

from ..dist import (all_reduce_grads, all_reduce_sum, make_mesh, replicate, shard_batch,
                    stage_volume_specs)
from ..models import build_model
from ..models.losses import cascade_loss
from ..nn.blocks import sync_batch_norm
from ..params import load_jax_variables
from . import checkpoints as ckpt_lib
from . import metrics as metrics_lib
from .config import Config
from .logging import MetricLogger


@dataclasses.dataclass
class TrainState:
    params: dict        # name → the model's parameter tensor (optimised in place)
    batch_stats: dict   # name → the model's BatchNorm running mean / var buffer
    opt_state: dict     # {"nu": {name: tensor}, "count": updates applied}
    step: int

    def to_dict(self) -> dict:
        """The state as a plain dict of its own tensors (not copies)."""
        return {"params": self.params, "batch_stats": self.batch_stats,
                "opt_state": self.opt_state, "step": self.step}

    @torch.no_grad()
    def load_dict(self, saved: dict) -> None:
        """Copy a `to_dict()` (e.g. a checkpoint) into these tensors in place."""
        for group in ("params", "batch_stats"):
            _copy_into(getattr(self, group), saved[group], group)
        _copy_into(self.opt_state["nu"], saved["opt_state"]["nu"], "opt_state/nu")
        self.opt_state["count"] = int(saved["opt_state"]["count"])
        self.step = int(saved["step"])


def _copy_into(dst: dict, src: dict, what: str) -> None:
    if set(dst) != set(src):
        raise KeyError(f"{what}: saved keys differ: {sorted(set(dst) ^ set(src))}")
    for k, t in dst.items():
        t.copy_(src[k])


class RMSprop:
    """`optax.chain(add_decayed_weights(wd), rmsprop(lr_schedule, decay=0.9,
    eps=1e-8))` of the JAX loop, written out on the parameter tensors:

        u = g + wd·p;   ν ← decay·ν + (1 − decay)·u²;   p ← p − lr(k)·u / √(ν + eps)

    with eps inside the square root as in optax (torch.optim.RMSprop adds it
    outside, which changes every update of a parameter whose ν is small).
    Update k (0-based) uses lr(k) = lr · γ^#{m : k ≥ m·steps_per_epoch}, the
    piecewise-constant schedule over the epoch milestones.
    """

    def __init__(self, lr: float, boundaries: dict, wd: float = 0.0, decay: float = 0.9,
                 eps: float = 1e-8):
        self.lr, self.boundaries, self.wd, self.decay, self.eps = lr, boundaries, wd, decay, eps

    def learning_rate(self, count: int) -> float:
        return self.lr * math.prod(s for b, s in self.boundaries.items() if count >= b)

    def init(self, params: dict) -> dict:
        return {"nu": {k: torch.zeros_like(p) for k, p in params.items()}, "count": 0}

    @torch.no_grad()
    def update(self, grads: dict, opt_state: dict, params: dict) -> None:
        """One update of `params` and `opt_state`, in place."""
        names = list(params)
        p = [params[k] for k in names]
        nu = [opt_state["nu"][k] for k in names]
        u = [grads[k] for k in names]
        if self.wd > 0:
            u = torch._foreach_add(u, p, alpha=self.wd)
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, u, u, value=1.0 - self.decay)
        step = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(step)
        torch._foreach_mul_(step, u)
        torch._foreach_add_(p, step, alpha=-self.learning_rate(opt_state["count"]))
        opt_state["count"] += 1


def make_optimizer(cfg: Config, steps_per_epoch: int) -> RMSprop:
    """RMSprop (decay 0.9) with the LR multiplied by lr_gamma at each epoch
    milestone."""
    boundaries = {int(m) * steps_per_epoch: cfg.lr_gamma for m in cfg.lr_milestones}
    return RMSprop(cfg.lr, boundaries, cfg.wd)


def _dtype(name: str):
    """A Config dtype name → the model's dtype knob (None: float32)."""
    return torch.bfloat16 if name == "bfloat16" else None


def create_model(cfg: Config, device, variables: Optional[dict] = None,
                 train_fused_sweep: bool = False):
    """The configured model on `device`, in eval mode, with cfg's fused_red,
    fused_sweep, volume_dtype, compute_dtype and torch_compat and the given
    train_fused_sweep (as `satmvs_tpu/train/loop.py:92-94`).  Weights:
    numpy-seeded from cfg.seed (`params.init_from_seed`; not the JAX
    package's PRNG draws), or a flax variables tree `variables` loaded with
    `params.load_jax_variables`.  As in JAX, CascadeREDNet and CascadeMVSNet
    take min_interval and depth_inter_r, UCSNet takes lamb instead."""
    spacing = ({"min_interval": cfg.min_interval, "depth_intervals_ratio": tuple(cfg.depth_inter_r)}
               if cfg.model in ("red", "casmvs") else {"lamb": cfg.lamb})
    model = build_model(cfg.model, cfg.geo_model, ndepths=tuple(cfg.ndepths),
                        cr_base_chs=tuple(cfg.cr_base_chs), fused_red=cfg.fused_red,
                        fused_sweep=cfg.fused_sweep, train_fused_sweep=train_fused_sweep,
                        volume_dtype=_dtype(cfg.volume_dtype),
                        compute_dtype=_dtype(cfg.compute_dtype), torch_compat=cfg.torch_compat,
                        device=device, seed=cfg.seed, **spacing)
    if variables is not None:
        load_jax_variables(model, variables)
    return model


def state_of(model, tx: RMSprop) -> TrainState:
    """A TrainState over the model's own parameter and running-statistic
    tensors, the optimizer's state fresh."""
    params = dict(model.named_parameters())
    batch_stats = {n: b for n, b in model.named_buffers()
                   if n.endswith(("running_mean", "running_var"))}
    return TrainState(params, batch_stats, tx.init(params), 0)


def partition_model(model, mesh, height: int) -> None:
    """Under a mesh with a spatial or depth axis, set the model's sharded
    cost volumes as JAX's `fit` sets them (`satmvs_tpu/train/loop.py:
    230-242`): `stage_volume_specs` of the model's ndepths with the mesh's
    extents and the image `height` (the guards shard a stage only where
    every level of the strided pyramid keeps ≥ shards·8 planes or rows)."""
    if mesh is None or (mesh.shape["spatial"] == 1 and mesh.shape["depth"] == 1):
        return
    specs = stage_volume_specs(model.ndepths, spatial=mesh.shape["spatial"] > 1,
                               depth_shards=mesh.shape["depth"],
                               spatial_shards=mesh.shape["spatial"], height=height)
    model.partition(specs, mesh)


def create_model_and_state(cfg: Config, sample_batch: dict, steps_per_epoch: int,
                           variables: Optional[dict] = None, mesh=None):
    """The configured model on the sample batch's device (`create_model`),
    its TrainState and optimizer, for training.  cfg.fused_red None and True
    take the fused RED pipeline, False its scan path.  train_fused_sweep is
    read from the environment once, here, as the JAX package reads it
    (SATMVS_TRAIN_FUSED_SWEEP=1: train on the fused sweep).  The CostRegNet
    families (model "casmvs", "ucs") train their CostRegNet as 3-D
    convolutions with train-mode BatchNorm.  Under a `mesh` with a spatial
    or depth axis the model's volumes are sharded (`partition_model`, the
    height the sample batch's)."""
    model = create_model(cfg, sample_batch["imgs"].device, variables,
                         train_fused_sweep=os.environ.get("SATMVS_TRAIN_FUSED_SWEEP") == "1")
    if mesh is not None:
        partition_model(model, mesh, int(sample_batch["imgs"].shape[2]))
    tx = make_optimizer(cfg, steps_per_epoch)
    return model, state_of(model, tx), tx


def _group(mesh):
    return None if mesh is None else mesh.group


def sync_norms(model, mesh) -> None:
    """Every BatchNorm of the model takes its train-mode moments over the
    mesh's data group, those of a sharded stage's regularizer over the
    whole mesh (each rank holds another slab of its volume); without a
    mesh, over this rank's batch."""
    sync_batch_norm(model, None if mesh is None else mesh.data_group)
    if mesh is None or getattr(model, "volume_partition", None) is None:
        return
    for reg, (_, depth, spatial, *_) in zip(model.regs, model.volume_partition):
        if depth or spatial:
            sync_batch_norm(reg, mesh.group)


def _global(values, group) -> list[torch.Tensor]:
    """Detached scalars summed over the group (as they are without one)."""
    stacked = torch.stack([v.detach() for v in values])
    return list((stacked if group is None else all_reduce_sum(stacked, group)).unbind())


def loss_and_grads(model, state: TrainState, batch: dict, dlossw, train: bool = True,
                   mesh=None):
    """The differentiable forward (train-mode BatchNorm with train; without,
    the eval-mode gradients the parity checks compare), the loss and its
    gradient in every parameter.  Under a mesh, batch is this rank's share
    and the gradients, summed over the mesh, are those of the global
    batch's loss.  Returns (outputs, loss, depth_loss, {name: gradient}):
    loss and depth_loss are the global batch's, detached."""
    names = list(state.params)
    group = _group(mesh)
    with torch.enable_grad():
        out = model.run_cascade(batch["imgs"], batch["cams"], batch["depth_values"], train)
        loss, depth_loss = cascade_loss(out, batch["depth_stages"], batch["mask_stages"],
                                        dlossw, group)
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
    if group is not None:
        grads = all_reduce_grads(grads, group)
    loss, depth_loss = _global([loss, depth_loss], group)
    return out, loss, depth_loss, dict(zip(names, grads))


def make_train_step(model, tx: RMSprop, dlossw, mesh=None) -> Callable:
    """(state, batch) → (state, scalars): the train-mode forward, the loss,
    its gradient, one optimizer update; scalars are device tensors (loss,
    depth_loss and the final stage's abs_depth_error).  Under a mesh (one
    of `dist.make_mesh`) the batch is this rank's share (`dist.shard_batch`),
    the model's BatchNorms take their moments as `sync_norms` says, the
    gradients are summed over the mesh before the update, and the scalars
    are the global batch's."""
    dlossw = tuple(dlossw)
    group = _group(mesh)
    sync_norms(model, mesh)

    def train_step(state: TrainState, batch: dict):
        out, loss, depth_loss, grads = loss_and_grads(model, state, batch, dlossw, True, mesh)
        tx.update(grads, state.opt_state, state.params)
        state.step += 1
        final = out["depth"].detach()
        scalars = {"loss": loss, "depth_loss": depth_loss,
                   "abs_depth_error": metrics_lib.abs_depth_error(
                       final, batch["depth_stages"][-1], batch["mask_stages"][-1] > 0.5,
                       group=group)}
        return state, scalars

    return train_step


def make_eval_step(model, dlossw, min_interval: float, mesh=None) -> Callable:
    """(state, batch) → (scalars, final depth, final confidence), inference
    mode (the model holds the state's tensors).  Under a mesh the batch is
    this rank's share, the maps are this share's and the scalars the global
    batch's."""
    dlossw = tuple(dlossw)
    group = _group(mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        out = model(batch["imgs"], batch["cams"], batch["depth_values"], train=False)
        loss, depth_loss = _global(cascade_loss(out, batch["depth_stages"],
                                                batch["mask_stages"], dlossw, group), group)
        final = out["depth"]
        scalars = {"loss": loss, "depth_loss": depth_loss}
        scalars.update(metrics_lib.standard_metrics(final, batch["depth_stages"][-1],
                                                    batch["mask_stages"][-1], min_interval,
                                                    group))
        return scalars, final, out["photometric_confidence"]

    return eval_step


def _check_mesh(cfg: Config) -> None:
    """JAX's refusals of a mesh, in JAX's order and words
    (`satmvs_tpu/train/loop.py:212-229`)."""
    if cfg.mesh_depth > 1 and cfg.model == "red":
        raise ValueError("depth-slab sharding (--mesh_depth) applies to the 3-D conv "
                         "regularizers (casmvs/ucs); the RED recurrence scans depth "
                         "sequentially on-chip by design")
    if cfg.mesh_depth > 1 and cfg.mesh_spatial > 1:
        raise ValueError("combined depth+spatial sharding of the same cost volume "
                         "miscomputes gradients through XLA GSPMD's strided-conv backward; "
                         "use --mesh_depth or --mesh_spatial, not both")
    if cfg.batch_size % cfg.mesh_data:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by mesh_data {cfg.mesh_data}")


def fit(cfg: Config, train_loader, test_loader, workdir: str,
        log_fn: Optional[Callable[[str], None]] = print, variables: Optional[dict] = None,
        mesh=None):
    """A training run: epochs of train steps and a test pass each, the
    per-epoch record `train_record.txt`, `metrics.jsonl`, a checkpoint every
    `save_freq` epochs; with cfg.resume it continues after the latest one.
    Loaders are re-iterable sequences of batches.  Returns (model, state,
    timing): timing lists the epochs run and, per epoch, its steps and the
    seconds of its train steps and of its test pass, the card synchronized
    at both ends.

    Over a mesh when cfg.mesh_data, mesh_spatial or mesh_depth is above 1
    (the mesh of their product of ranks, made here; every rank of the
    process group calls fit) or when a `mesh` is passed (its extents
    cfg's).  Every rank iterates the same loaders (same seed, so the same
    order) and trains on its data-axis share of each global batch
    (`dist.shard_batch`; a batch the data ranks do not divide raises), its
    slabs of the sharded stages' volumes under a spatial or depth axis
    (`partition_model`, the height the first batch's, as JAX's fit takes
    it); the state is replicated from rank 0; only rank 0 logs and writes
    the record files, images and checkpoints, and the ranks wait for each
    other after a save; a resume restores on every rank."""
    if mesh is not None or cfg.mesh_data * cfg.mesh_spatial * cfg.mesh_depth > 1:
        _check_mesh(cfg)
        if mesh is None:
            mesh = make_mesh(cfg.mesh_data, cfg.mesh_spatial, cfg.mesh_depth)
        want = {"data": cfg.mesh_data, "spatial": cfg.mesh_spatial, "depth": cfg.mesh_depth}
        if mesh.shape != want:
            raise ValueError(f"a mesh of {mesh.shape} for the config's {want}")
    steps_per_epoch = max(len(train_loader), 1)
    first = next(iter(train_loader))
    shard = (lambda b: b) if mesh is None else (lambda b: shard_batch(b, mesh))
    model, state, tx = create_model_and_state(cfg, shard(first), steps_per_epoch, variables,
                                              mesh)
    writer = mesh is None or mesh.rank == 0
    if mesh is not None:
        replicate(state.to_dict(), mesh)
        log_fn = log_fn if writer else None

    start_epoch = 1
    if cfg.resume:
        restored, ep = ckpt_lib.restore_checkpoint(workdir, state)
        if restored is not None:
            start_epoch = ep + 1
            if log_fn:
                log_fn(f"resumed from epoch {ep}")

    train_step = make_train_step(model, tx, cfg.dlossw, mesh)
    eval_step = make_eval_step(model, cfg.dlossw, cfg.min_interval, mesh)
    logger = MetricLogger(workdir) if writer else None
    keeper = ckpt_lib.CheckpointKeeper(workdir) if writer else None
    timing = {"epochs": [], "train_s": [], "steps": [], "test_s": []}
    try:
        _fit_epochs(cfg, train_loader, test_loader, workdir, log_fn, state, train_step,
                    eval_step, logger, keeper, steps_per_epoch, start_epoch, timing, shard,
                    mesh)
    finally:
        if writer:
            keeper.close()
            logger.close()
    if mesh is not None:
        mesh.barrier()  # every checkpoint committed before any rank returns
    return model, state, timing


def _clock(state) -> float:
    """The host clock once the card has finished the queued work."""
    if next(iter(state.params.values())).is_cuda:
        torch.cuda.synchronize()
    return time.perf_counter()


def _fit_epochs(cfg, train_loader, test_loader, workdir, log_fn, state, train_step,
                eval_step, logger, keeper, steps_per_epoch, start_epoch, timing, shard, mesh):
    writer = logger is not None
    for epoch in range(start_epoch, cfg.epochs + 1):
        t_train, steps = _clock(state), 0
        for it, batch in enumerate(train_loader):
            t0 = time.time()
            state, scalars = train_step(state, shard(batch))
            gstep = (epoch - 1) * steps_per_epoch + it
            if writer and gstep % cfg.summary_freq == 0:
                scal = {k: float(v) for k, v in scalars.items()}
                logger.scalars("train", scal, gstep)
                if log_fn:
                    log_fn(f"epoch {epoch}/{cfg.epochs} iter {it}/{steps_per_epoch} "
                           f"loss={scal['loss']:.3f} time={time.time() - t0:.3f}s")
            steps += 1
        t_test = _clock(state)
        timing["epochs"].append(epoch)
        timing["train_s"].append(t_test - t_train)
        timing["steps"].append(steps)

        meter = metrics_lib.DictAverageMeter()
        logged_images = not writer
        for batch in test_loader:
            batch = shard(batch)
            scalars, depth_est, _conf = eval_step(state, batch)
            meter.update({k: float(v) for k, v in scalars.items()})
            if not logged_images:
                # once per test pass, the first sample (rank 0's share holds it)
                step_i = epoch * steps_per_epoch
                de = depth_est[0].cpu().numpy()
                gt = batch["depth_stages"][-1][0].cpu().numpy()
                mk = batch["mask_stages"][-1][0].cpu().numpy() > 0.5
                logger.image("fulltest", "depth_est", de, step_i)
                logger.image("fulltest", "depth_gt", gt, step_i)
                logger.image("fulltest", "ref_img",
                             batch["imgs"][0, 0].cpu().numpy().transpose(2, 0, 1), step_i)
                logger.image("fulltest", "mask", mk.astype("float32"), step_i)
                logger.image("fulltest", "errormap", abs(de - gt) * mk, step_i)
                logged_images = True
        means = meter.mean()
        timing["test_s"].append(_clock(state) - t_test)
        if writer:
            logger.scalars("fulltest", means, epoch * steps_per_epoch)
            if log_fn:
                log_fn(f"epoch {epoch} test: {means}")
            with open(os.path.join(workdir, "train_record.txt"), "a") as f:
                f.write(f"{epoch} {means}\n")

        if epoch % cfg.save_freq == 0:
            if writer:
                keeper.save(epoch, state)
            if mesh is not None:
                mesh.barrier()
