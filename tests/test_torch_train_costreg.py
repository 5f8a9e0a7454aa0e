"""Training the CostRegNet families: the port's CascadeMVSNet and UCSNet train
step (the CostRegNet as 3-D convolutions under autograd, train-mode
BatchNorm, the per-view sweep) against JAX `make_train_step(Config(model=...))`
on the CPU at 32×64, B = 1, 3 views, ndepths (8, 8, 8), from the same
weights and batch: the loss, the eval-mode gradients against `jax.grad` of
`apply(train=False)`, the update and the running statistics after one
step; and `cli.train --mode=train --model casmvs|ucs` through an epoch and
its resume.

The weights are a flax variables tree drawn from a numpy seed in the shape
of `jax.eval_shape(model.init)` (no JAX init compiles), at the scales of
tests/test_torch_model_costreg.py: LeCun-scale kernels, scale 1 ± 0.2, bias
and mean ± 0.1, var in [0.5, 1.5], the CostRegNet logit heads ×10."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.models import build_model as jbuild
from satmvs_tpu.models import cascade_loss as jcascade_loss
from satmvs_tpu.train.config import Config as JConfig
from satmvs_tpu.train.loop import TrainState as JState
from satmvs_tpu.train.loop import make_optimizer as jmake_optimizer
from satmvs_tpu.train.loop import make_train_step as jmake_train_step
from satmvs_tpu.train.loop import numeric_batch
from satmvs_tpu_torch.cli import train as cli_train
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.models import build_model
from satmvs_tpu_torch.models.losses import cascade_loss
from satmvs_tpu_torch.ops.kernels import plane_conv
from satmvs_tpu_torch.params import load_jax_variables
from satmvs_tpu_torch.train import Config, create_model_and_state, make_train_step

H, W = 32, 64
NDEPTHS = (8, 8, 8)
HEAD_GAIN = 1.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small ops, run beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_variables(shapes, seed: int) -> dict:
    """A flax variables tree in `shapes` drawn from numpy seed `seed` (the
    module docstring's scales)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        keys = [getattr(p, "key", None) for p in path]
        name = keys[-1]
        if name == "kernel":
            k = rng.normal(0.0, 1.0 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
            head = keys[-2] == "Conv_0" and str(keys[-3]).startswith("CostRegNet")
            return k * HEAD_GAIN if head else k
        if name == "scale":
            return 1.0 + 0.2 * rng.normal(size=s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.normal(size=s.shape)  # bias, mean

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(draw(p, s), np.float32), shapes)


def step_runs(name: str, seed: int, jax_knobs: dict, cfg: Config) -> dict:
    """One train step of each package from the same weights and batch, each
    one's eval-mode loss and gradients, and the port model's parameter and
    buffer names for flax trees (`named`)."""
    jb = numeric_batch(jsyn.make_batch(1, W, H, seed=0))
    jcfg = JConfig(model=name, ndepths=cfg.ndepths, volume_dtype=cfg.volume_dtype,
                   fused_red=cfg.fused_red)
    jm = jbuild(name, "rpc", ndepths=tuple(cfg.ndepths), **jax_knobs)
    args = (jb["imgs"], jb["cams"], jb["depth_values"])
    v = seeded_variables(jax.eval_shape(functools.partial(jm.init, train=False),
                                        jax.random.PRNGKey(0), *args), seed)
    jtx = jmake_optimizer(jcfg, 2)
    jstate = JState(params=v["params"], batch_stats=v["batch_stats"],
                    opt_state=jtx.init(v["params"]), step=jnp.zeros((), jnp.int32))

    def eval_loss(params):
        out = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, *args, train=False)
        return jcascade_loss(out, jb["depth_stages"], jb["mask_stages"], jcfg.dlossw)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(eval_loss))(v["params"])
    jnew, jscalars = jmake_train_step(jm, jtx, tuple(jcfg.dlossw))(jstate, jb)

    tb = tsyn.make_batch(1, W, H, seed=0, device="cpu")
    model, state, tx = create_model_and_state(cfg, tb, 2, variables=v)
    out = model.run_cascade(tb["imgs"], tb["cams"], tb["depth_values"], False)
    loss = cascade_loss(out, tb["depth_stages"], tb["mask_stages"], cfg.dlossw)[0]
    names = list(state.params)
    grads = dict(zip(names, torch.autograd.grad(loss, [state.params[n] for n in names])))
    launches = plane_conv.conv_dn.launches
    state, scalars = make_train_step(model, tx, cfg.dlossw)(state, tb)
    assert plane_conv.conv_dn.launches == launches  # CPU tensors launch nothing

    def named(tree):
        m = load_jax_variables(build_model(name, "rpc", ndepths=tuple(cfg.ndepths),
                                           device="cpu"), tree)
        return dict(m.named_parameters()), dict(m.named_buffers())

    return {"v": v, "jloss": float(jloss), "jgrads": jax.tree.map(np.asarray, jgrads),
            "jnew": named({"params": jax.tree.map(np.asarray, jnew.params),
                           "batch_stats": jax.tree.map(np.asarray, jnew.batch_stats)}),
            "jscalars": {k: float(x) for k, x in jscalars.items()}, "loss": loss.item(),
            "grads": grads, "state": state, "named": named,
            "scalars": {k: float(x) for k, x in scalars.items()}}


def check_loss(r, eval_tol: float, step_tol: float, what: str):
    """The eval-mode loss within `eval_tol` relative; the train step's loss,
    depth_loss and abs_depth_error within `step_tol` relative."""
    pairs = [("eval loss", r["loss"], r["jloss"], eval_tol)] + [
        (k, r["scalars"][k], r["jscalars"][k], step_tol)
        for k in ("loss", "depth_loss", "abs_depth_error")]
    for name, got, want, t in pairs:
        print(f"[parity] {what} {name}: {got:.6f} vs {want:.6f}, "
              f"{abs(got - want) / abs(want):.2e} relative (tol {t:.0e})")
        assert abs(got - want) <= t * abs(want), name


def check_gradients(r, tol: float, what: str):
    """Eval-mode gradients of every parameter tensor within a relative norm
    of `tol`; the logit heads' biases, whose gradient is 0 up to rounding (a
    softmax ignores a shift of all logits), within 1e-6 of the largest
    gradient element."""
    want, _ = r["named"]({"params": r["jgrads"], "batch_stats": r["v"]["batch_stats"]})
    scale = max(w.abs().max().item() for w in want.values())
    worst = 0.0
    for n, g in r["grads"].items():
        diff = (g - want[n]).norm().item()
        if n.endswith("head.bias"):
            assert diff <= 1e-6 * scale, n
        else:
            worst = max(worst, diff / want[n].norm().item())
    print(f"[parity] {what} eval-mode gradients: max relative norm {worst:.2e} over "
          f"{len(r['grads'])} tensors (tol {tol})")
    assert worst <= tol


def check_update(r, per_tensor, over_all: float, stats_tols: tuple, what: str):
    """Parameters after one train-mode step by the update each made (new −
    old) against JAX's: the relative norm of each tensor's difference within
    `per_tensor` (None: not gated) and over all within `over_all` (the logit
    heads' biases, pure rounding, left out); the running statistics within
    stats_tols = (the FeatureNet's, the regularizers') of each tensor's
    largest value."""
    old, _ = r["named"](r["v"])
    want, want_bufs = r["jnew"]
    num = den = worst = 0.0
    for n, p in r["state"].params.items():
        if n.endswith("head.bias"):
            continue
        d_got, d_want = p.detach() - old[n], want[n] - old[n]
        num += (d_got - d_want).norm().item() ** 2
        den += d_want.norm().item() ** 2
        worst = max(worst, (d_got - d_want).norm().item() / d_want.norm().item())
    total = (num / den) ** 0.5
    stats = [0.0, 0.0]
    for n, b in r["state"].batch_stats.items():
        k = 0 if n.startswith("feature.") else 1
        stats[k] = max(stats[k], (b - want_bufs[n]).abs().max().item()
                       / want_bufs[n].abs().max().item())
    print(f"[parity] {what} after one step: update relative norm max {worst:.2e} per tensor "
          f"(tol {per_tensor}), {total:.2e} over all (tol {over_all}); batch_stats FeatureNet "
          f"{stats[0]:.2e} (tol {stats_tols[0]}), regularizers {stats[1]:.2e} (tol "
          f"{stats_tols[1]})")
    assert per_tensor is None or worst <= per_tensor
    assert total <= over_all and all(x <= t for x, t in zip(stats, stats_tols))
    assert r["state"].step == 1 and r["state"].opt_state["count"] == 1


# name → (model, weight seed, knobs of JAX's build_model, port Config fields, gates:
# eval-mode loss, train-step scalars, eval-mode gradients, update per tensor
# and over all, running statistics of the FeatureNet and of the regularizers).  The
# reasons are in the tests' docstrings.
COSTREG_GATES = (1e-5, 1e-3, 1e-3, None, 0.5, (1e-5, 3e-3))
CASES = {
    "casmvs": ("casmvs", 7, {}, {"model": "casmvs", "ndepths": NDEPTHS}, COSTREG_GATES),
    "ucs": ("ucs", 7, {}, {"model": "ucs", "ndepths": NDEPTHS}, COSTREG_GATES),
    "red_bf16": ("red", 6, {"fused_red": False, "volume_dtype": jnp.bfloat16},
                 {"ndepths": (8, 4, 4), "fused_red": False, "volume_dtype": "bfloat16"},
                 (1e-4, 1e-4, 1e-2, 0.5, 0.1, (1e-5, 1e-5))),
}


@pytest.fixture(scope="module", params=[
    "casmvs", pytest.param("red_bf16", marks=pytest.mark.slow), "ucs"])
def runs(request):
    """One case of CASES.  red_bf16 is `slow` (its JAX compiles take ~2
    minutes in the 6-worker suite); its fast counterpart is
    tests/test_torch_sweep_train.py's bf16 step against the fp32 one, beside
    the bf16 forward and VJP against JAX there."""
    name, seed, knobs, fields, gates = CASES[request.param]
    return request.param, gates, step_runs(name, seed, knobs, Config(**fields))


def test_train_step_loss_matches_jax(runs):
    """The eval-mode loss: 1e-5 relative for the CostRegNet families, 1e-4
    with bf16 volumes (the packages round to bf16 fp32 samples ~1e-6 apart,
    so a few volume values land one bf16 ulp apart; measured 2e-7).  The
    train step's loss, depth_loss and abs_depth_error: 1e-4 with bf16
    volumes (measured 5e-6); 1e-3 for the CostRegNet families (measured
    2.4e-4), whose train-mode forward is ill-conditioned at B = 1: the
    CostRegNet's coarsest train-mode BatchNorms take their statistics over
    2 values a channel, and stages 2-3 centre their hypotheses on the
    previous stage's train-mode depth; a 1e-6 relative perturbation of the
    images moves JAX's own UCSNet depth_loss by up to 6.3e-4
    (`train_sensitivity.py --only jax`)."""
    what, gates, r = runs
    check_loss(r, gates[0], gates[1], what)


def test_eval_mode_gradients_match_jax(runs):
    """Eval-mode gradients against jax.grad of apply(train=False): relative
    norm 1e-3 per tensor for the CostRegNet families (measured 6e-5), 1e-2
    with bf16 volumes (measured 1.3e-3: their cotangents are rounded to
    bf16 too)."""
    what, gates, r = runs
    check_gradients(r, gates[2], what)


def test_train_step_update_matches_jax(runs):
    """The update and the running statistics after one train-mode step.
    bf16 volumes: 0.5 per tensor (measured 0.27; RMSprop's first step is
    ±lr·√10 where |g| ≫ 1e-4, so small-gradient elements carry rounding
    into the update), 0.1 over all (measured 0.044), statistics 1e-5.  The
    CostRegNet families (test_train_step_loss_matches_jax's conditioning):
    0.5 over all (measured 0.16 and 0.29; JAX's own step moves by up to
    0.42 under a 1e-6 perturbation of the images, `train_sensitivity.py
    --only jax`, and a wrong sign would give 2), per tensor not gated (it
    reaches 1.0 under that perturbation); the FeatureNet's running
    statistics, ahead of the ill-conditioned part, 1e-5, the CostRegNets'
    3e-3 (measured 9e-4; JAX's own move by up to 2.7e-3 under that
    perturbation)."""
    what, gates, r = runs
    check_update(r, gates[3], gates[4], gates[5], what)
