"""Training and evaluation: the train and eval steps, RMSprop with an LR
stepped at epoch boundaries, the epoch loop with logging and checkpoints.

Counterpart of `satmvs_tpu/train/loop.py` on one device (no mesh).  JAX's
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

from ..models import build_model
from ..models.losses import cascade_loss
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


def create_model(cfg: Config, device, variables: Optional[dict] = None):
    """The configured model on `device`, in eval mode.  Weights:
    numpy-seeded from cfg.seed (`params.init_from_seed`; not the JAX
    package's PRNG draws), or a flax variables tree `variables` loaded with
    `params.load_jax_variables`.  As in JAX, CascadeREDNet and CascadeMVSNet
    take min_interval and depth_inter_r, UCSNet takes lamb instead."""
    spacing = ({"min_interval": cfg.min_interval, "depth_intervals_ratio": tuple(cfg.depth_inter_r)}
               if cfg.model in ("red", "casmvs") else {"lamb": cfg.lamb})
    model = build_model(cfg.model, cfg.geo_model, ndepths=tuple(cfg.ndepths),
                        cr_base_chs=tuple(cfg.cr_base_chs), fused_red=cfg.fused_red,
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


def create_model_and_state(cfg: Config, sample_batch: dict, steps_per_epoch: int,
                           variables: Optional[dict] = None):
    """The configured model on the sample batch's device (`create_model`),
    its TrainState and optimizer, for training.  cfg.fused_red None and True
    take the fused RED pipeline, False its scan path.  The CostRegNet
    families (model "casmvs", "ucs") raise: their training is not ported
    (ROADMAP A7); they evaluate and predict through `create_model`."""
    if cfg.model != "red":
        raise ValueError(f"model={cfg.model!r}: training the CostRegNet families is not ported "
                         f"(ROADMAP A7); the port evaluates and predicts them")
    model = create_model(cfg, sample_batch["imgs"].device, variables)
    tx = make_optimizer(cfg, steps_per_epoch)
    return model, state_of(model, tx), tx


def make_train_step(model, tx: RMSprop, dlossw) -> Callable:
    """(state, batch) → (state, scalars): the train-mode forward, the loss,
    its gradient, one optimizer update; scalars are device tensors (loss,
    depth_loss and the final stage's abs_depth_error)."""
    dlossw = tuple(dlossw)

    def train_step(state: TrainState, batch: dict):
        names = list(state.params)
        with torch.enable_grad():
            out = model(batch["imgs"], batch["cams"], batch["depth_values"], train=True)
            loss, depth_loss = cascade_loss(out, batch["depth_stages"], batch["mask_stages"],
                                            dlossw)
            grads = torch.autograd.grad(loss, [state.params[n] for n in names])
        tx.update(dict(zip(names, grads)), state.opt_state, state.params)
        state.step += 1
        final = out["depth"].detach()
        scalars = {"loss": loss.detach(), "depth_loss": depth_loss.detach(),
                   "abs_depth_error": metrics_lib.abs_depth_error(
                       final, batch["depth_stages"][-1], batch["mask_stages"][-1] > 0.5)}
        return state, scalars

    return train_step


def make_eval_step(model, dlossw, min_interval: float) -> Callable:
    """(state, batch) → (scalars, final depth, final confidence), inference
    mode (the model holds the state's tensors)."""
    dlossw = tuple(dlossw)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        out = model(batch["imgs"], batch["cams"], batch["depth_values"], train=False)
        loss, depth_loss = cascade_loss(out, batch["depth_stages"], batch["mask_stages"], dlossw)
        final = out["depth"]
        scalars = {"loss": loss, "depth_loss": depth_loss}
        scalars.update(metrics_lib.standard_metrics(final, batch["depth_stages"][-1],
                                                    batch["mask_stages"][-1], min_interval))
        return scalars, final, out["photometric_confidence"]

    return eval_step


def fit(cfg: Config, train_loader, test_loader, workdir: str,
        log_fn: Optional[Callable[[str], None]] = print, variables: Optional[dict] = None):
    """A training run: epochs of train steps and a test pass each, the
    per-epoch record `train_record.txt`, `metrics.jsonl`, a checkpoint every
    `save_freq` epochs; with cfg.resume it continues after the latest one.
    Loaders are re-iterable sequences of batches.  Returns (model, state,
    timing): timing lists the epochs run and, per epoch, its steps and the
    seconds of its train steps and of its test pass, the card synchronized
    at both ends."""
    steps_per_epoch = max(len(train_loader), 1)
    first = next(iter(train_loader))
    model, state, tx = create_model_and_state(cfg, first, steps_per_epoch, variables)

    start_epoch = 1
    if cfg.resume:
        restored, ep = ckpt_lib.restore_checkpoint(workdir, state)
        if restored is not None:
            start_epoch = ep + 1
            if log_fn:
                log_fn(f"resumed from epoch {ep}")

    train_step = make_train_step(model, tx, cfg.dlossw)
    eval_step = make_eval_step(model, cfg.dlossw, cfg.min_interval)
    logger = MetricLogger(workdir)
    keeper = ckpt_lib.CheckpointKeeper(workdir)
    timing = {"epochs": [], "train_s": [], "steps": [], "test_s": []}
    try:
        _fit_epochs(cfg, train_loader, test_loader, workdir, log_fn, state, train_step,
                    eval_step, logger, keeper, steps_per_epoch, start_epoch, timing)
    finally:
        keeper.close()
        logger.close()
    return model, state, timing


def _clock(state) -> float:
    """The host clock once the card has finished the queued work."""
    if next(iter(state.params.values())).is_cuda:
        torch.cuda.synchronize()
    return time.perf_counter()


def _fit_epochs(cfg, train_loader, test_loader, workdir, log_fn, state, train_step,
                eval_step, logger, keeper, steps_per_epoch, start_epoch, timing):
    for epoch in range(start_epoch, cfg.epochs + 1):
        t_train, steps = _clock(state), 0
        for it, batch in enumerate(train_loader):
            t0 = time.time()
            state, scalars = train_step(state, batch)
            gstep = (epoch - 1) * steps_per_epoch + it
            if gstep % cfg.summary_freq == 0:
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
        logged_images = False
        for batch in test_loader:
            scalars, depth_est, _conf = eval_step(state, batch)
            meter.update({k: float(v) for k, v in scalars.items()})
            if not logged_images:
                # once per test pass, the first sample
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
        logger.scalars("fulltest", means, epoch * steps_per_epoch)
        if log_fn:
            log_fn(f"epoch {epoch} test: {means}")
        with open(os.path.join(workdir, "train_record.txt"), "a") as f:
            f.write(f"{epoch} {means}\n")

        if epoch % cfg.save_freq == 0:
            keeper.save(epoch, state)
