"""The port's training path against the JAX package on the CPU: BatchNorm
and FeatureNet in train mode against flax, the RED scan path and its
gradient against JAX `REDRegularizer(fused=False)`, and one whole
`train_step` against JAX `make_train_step` with fused_red=False (loss,
eval-mode gradients, parameters and batch_stats after the update); plus
what the port refuses.  Weights and inputs come from numpy seeds, kernels
at the scale of flax's LeCun init; they reach the port through
`params.load_jax_variables`, and gradient and parameter trees come back
the same way."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.models import build_model as jbuild
from satmvs_tpu.models import cascade_loss as jcascade_loss
from satmvs_tpu.nn.featurenet import FeatureNet as JFeatureNet
from satmvs_tpu.nn.red import REDRegularizer as JRED
from satmvs_tpu.train.config import Config as JConfig
from satmvs_tpu.train.loop import TrainState as JState
from satmvs_tpu.train.loop import make_optimizer as jmake_optimizer
from satmvs_tpu.train.loop import make_train_step as jmake_train_step
from satmvs_tpu.train.loop import numeric_batch
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.models import CascadeREDNet
from satmvs_tpu_torch.models.cascade import CascadeModel
from satmvs_tpu_torch.models.losses import cascade_loss
from satmvs_tpu_torch.nn.blocks import BatchNorm
from satmvs_tpu_torch.nn.featurenet import FeatureNet as TFeatureNet
from satmvs_tpu_torch.nn.red import REDRegularizer as TRED
from satmvs_tpu_torch.params import load_jax_variables
from satmvs_tpu_torch.train import Config, create_model_and_state, make_train_step

H, W = 32, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NDEPTHS = (8, 4, 4)


def seeded(tree, seed):
    """Numpy values for a tree of shapes: kernels N(0, 1/fan_in), scales
    1 + 0.2·N, biases and BatchNorm means 0.1·N, variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def fill(t):
        out = {}
        for k, x in t.items():
            if isinstance(x, dict):
                out[k] = fill(x)
            elif k == "kernel":
                fan_in = int(np.prod(x.shape[:-1]))
                out[k] = rng.normal(0.0, np.sqrt(1.0 / fan_in), x.shape).astype(np.float32)
            elif k == "scale":
                out[k] = (1.0 + 0.2 * rng.normal(size=x.shape)).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = (0.1 * rng.normal(size=x.shape)).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            else:
                raise KeyError(f"no seeded value for {k!r}")
        return out

    return fill(dict(tree))


def _input(shape, seed, shift=0.0):
    return (shift + np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _named(variables, **kw):
    """A port CascadeREDNet loaded from a flax tree: {name: tensor} of its
    parameters and its buffers."""
    m = load_jax_variables(CascadeREDNet(ndepths=NDEPTHS, device="cpu", **kw), variables)
    return dict(m.named_parameters()), dict(m.named_buffers())


def test_batchnorm_train_mode_matches_flax():
    """Output and running statistics against flax nn.BatchNorm(momentum=0.9)
    with batch statistics: 1e-5 and 1e-6.  torch's BatchNorm2d, which moves
    the running variance to the unbiased batch variance, misses by
    ~var/(N·H·W − 1), far past that."""
    x = _input((3, 6, 8, 5), 0, shift=0.5) * 2.0
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = seeded(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    want, upd = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(5, eps=1e-5)
    with torch.no_grad():
        for t, a in ((bn.weight, v["params"]["scale"]), (bn.bias, v["params"]["bias"]),
                     (bn.running_mean, v["batch_stats"]["mean"]),
                     (bn.running_var, v["batch_stats"]["var"])):
            t.copy_(torch.from_numpy(a))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = bn(tx, train=True).permute(0, 2, 3, 1).detach().numpy()
    errs = [np.abs(got - np.asarray(want)).max(),
            np.abs(bn.running_mean.numpy() - np.asarray(upd["batch_stats"]["mean"])).max(),
            np.abs(bn.running_var.numpy() - np.asarray(upd["batch_stats"]["var"])).max()]
    print(f"[parity] BatchNorm train: out {errs[0]:.2e} (tol 1e-5), mean {errs[1]:.2e}, "
          f"var {errs[2]:.2e} (tol 1e-6)")
    assert errs[0] <= 1e-5 and errs[1] <= 1e-6 and errs[2] <= 1e-6
    tbn = torch.nn.BatchNorm2d(5, eps=1e-5, momentum=0.1)
    tbn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    tbn.train()(tx)
    assert np.abs(tbn.running_var.numpy() - np.asarray(upd["batch_stats"]["var"])).max() > 1e-4
    # eval mode: the running statistics, untouched
    before = bn.running_var.clone()
    bn(tx)
    torch.testing.assert_close(bn.running_var, before, rtol=0, atol=0)


def test_featurenet_train_mode_matches_flax():
    """unet FeatureNet with train=True: the three outputs (1e-4 on features
    of magnitude ~1-10 after 12 conv layers) and every updated batch_stats
    entry (1e-5)."""
    x = _input((2, 16, 24, 3), 2)
    jm = JFeatureNet(8, 3, "unet")
    v = seeded(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    want, upd = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    tm = load_jax_variables(TFeatureNet(8), v)
    got = tm(torch.from_numpy(x), train=True)
    out_err = max(np.abs(g.detach().numpy() - np.asarray(w)).max() for g, w in zip(got, want))
    ref = load_jax_variables(TFeatureNet(8), {"params": v["params"],
                                              "batch_stats": jax.tree.map(np.asarray,
                                                                          upd["batch_stats"])})
    want_bufs = dict(ref.named_buffers())
    stat_err = max((b - want_bufs[n]).abs().max().item() for n, b in tm.named_buffers()
                   if not n.endswith("num_batches_tracked"))
    print(f"[parity] FeatureNet train: outputs {out_err:.2e} (tol 1e-4), "
          f"batch_stats {stat_err:.2e} (tol 1e-5)")
    assert out_err <= 1e-4 and stat_err <= 1e-5


def test_red_scan_and_its_gradient_match_jax():
    """REDRegularizer(volume, fused=False) against JAX's scan path: logits
    (1e-5) and the gradient of Σ sin(logits) in the volume and in every
    parameter (relative norm 1e-4 per tensor)."""
    vol = np.abs(_input((2, 4, 16, 24, 8), 4))
    jm = JRED(8)
    v = seeded(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(vol)), 5)

    def f(params, x):
        return jnp.sum(jnp.sin(jm.apply({"params": params}, x, False)))

    want = np.asarray(jm.apply(v, jnp.asarray(vol), False))
    jg_p, jg_v = jax.grad(f, argnums=(0, 1))(v["params"], jnp.asarray(vol))
    tm = load_jax_variables(TRED(8, 8), v)
    tv = torch.from_numpy(vol).requires_grad_(True)
    logits = tm(tv, fused=False)
    grads = torch.autograd.grad(torch.sum(torch.sin(logits)), [tv, *tm.parameters()])
    lerr = np.abs(logits.detach().numpy() - want).max()
    gm = load_jax_variables(TRED(8, 8), {"params": jax.tree.map(np.asarray, jg_p)})
    rel = [(g - w).norm().item() / w.norm().item()
           for g, w in zip(grads, [torch.from_numpy(np.asarray(jg_v)), *gm.parameters()])]
    print(f"[parity] RED scan: logits {lerr:.2e} (tol 1e-5), gradients max relative norm "
          f"{max(rel):.2e} (tol 1e-4)")
    assert lerr <= 1e-5 and max(rel) <= 1e-4
    with torch.no_grad():  # the fused pipeline computes the same logits
        torch.testing.assert_close(tm(tv), logits.detach(), rtol=0, atol=1e-5)


def _step_runs(cr_base_chs=(8, 8, 8), fused_red=False):
    """One train step of each package from the same weights and batch, and
    each one's eval-mode loss and gradients, the regularizers at base widths
    cr_base_chs (JAX on its scan path, the port on its fused pipeline when
    fused_red)."""
    jb = numeric_batch(jsyn.make_batch(1, W, H, seed=0))
    jcfg = JConfig(ndepths=NDEPTHS, fused_red=False, cr_base_chs=cr_base_chs)
    jm = jbuild("red", "rpc", ndepths=NDEPTHS, fused_red=False, cr_base_chs=cr_base_chs)
    args = (jb["imgs"], jb["cams"], jb["depth_values"])
    v = seeded(jax.eval_shape(functools.partial(jm.init, train=False),
                              jax.random.PRNGKey(0), *args), 6)
    jtx = jmake_optimizer(jcfg, 2)
    jstate = JState(params=v["params"], batch_stats=v["batch_stats"],
                    opt_state=jtx.init(v["params"]), step=jnp.zeros((), jnp.int32))

    def eval_loss(params):
        out = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, *args, train=False)
        return jcascade_loss(out, jb["depth_stages"], jb["mask_stages"], jcfg.dlossw)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(eval_loss))(v["params"])
    jnew, jscalars = jmake_train_step(jm, jtx, tuple(jcfg.dlossw))(jstate, jb)

    tb = tsyn.make_batch(1, W, H, seed=0, device="cpu")
    cfg = Config(ndepths=NDEPTHS, fused_red=fused_red, cr_base_chs=cr_base_chs)
    model, state, tx = create_model_and_state(cfg, tb, 2, variables=v)
    out = model.run_cascade(tb["imgs"], tb["cams"], tb["depth_values"], False)
    loss = cascade_loss(out, tb["depth_stages"], tb["mask_stages"], cfg.dlossw)[0]
    names = list(state.params)
    grads = dict(zip(names, torch.autograd.grad(loss, [state.params[n] for n in names])))
    state, scalars = make_train_step(model, tx, cfg.dlossw)(state, tb)
    return {"v": v, "jloss": float(jloss), "jgrads": jax.tree.map(np.asarray, jgrads),
            "jnew": jnew, "jscalars": {k: float(x) for k, x in jscalars.items()},
            "loss": loss.item(), "grads": grads, "state": state,
            "scalars": {k: float(x) for k, x in scalars.items()}}


@pytest.fixture(scope="module")
def train_step_runs():
    return _step_runs()


def _check_losses(r, what="train step"):
    pairs = [("eval loss", r["loss"], r["jloss"])] + [
        (k, r["scalars"][k], r["jscalars"][k]) for k in ("loss", "depth_loss", "abs_depth_error")]
    for name, got, want in pairs:
        print(f"[parity] {what} {name}: {got:.6f} vs {want:.6f}, "
              f"{abs(got - want) / abs(want):.2e} relative (tol 1e-5)")
        assert abs(got - want) <= 1e-5 * abs(want), name


def test_train_step_loss_matches_jax(train_step_runs):
    """Eval-mode loss and the train step's loss, depth_loss and
    abs_depth_error: 1e-5 relative."""
    _check_losses(train_step_runs)


@pytest.mark.slow
def test_train_step_loss_at_base_width_129_matches_jax():
    """`cr_base_chs` (129, 8, 8), stage 1's deepest cell 1032 channels
    (past the 1024 where the card's ConvGRU kernels walk more than one
    group a thread), the port on its fused pipeline (on the CPU its plain
    versions) against JAX's scan path: the eval-mode loss and the train
    step's loss, depth_loss and abs_depth_error, 1e-5 relative.  Slow: JAX's
    jit of the step at these widths takes most of a minute."""
    _check_losses(_step_runs((129, 8, 8), fused_red=None), "train step at base 129")


def test_eval_mode_gradients_match_jax(train_step_runs):
    """Eval-mode gradients against JAX value_and_grad of apply(train=False),
    every parameter tensor: relative norm 1e-3, or, for the logit heads'
    biases, whose gradient is 0 up to rounding (a softmax ignores a shift of
    all logits), an absolute norm of 1e-6 of the largest gradient element."""
    r = train_step_runs
    want, _ = _named({"params": r["jgrads"], "batch_stats": r["v"]["batch_stats"]})
    scale = max(w.abs().max().item() for w in want.values())
    worst = 0.0
    for n, g in r["grads"].items():
        diff = (g - want[n]).norm().item()
        if n.endswith("head.bias"):
            assert diff <= 1e-6 * scale, n
        else:
            worst = max(worst, diff / want[n].norm().item())
    print(f"[parity] eval-mode gradients: max relative norm {worst:.2e} over "
          f"{len(r['grads'])} tensors (tol 1e-3)")
    assert worst <= 1e-3


def test_train_step_update_matches_jax(train_step_runs):
    """Parameters and batch_stats after one train-mode step.  batch_stats:
    1e-5 of each tensor's largest value.  Parameters, by the update each
    made (new − old): train-mode BatchNorm gradients amplify rounding
    (tests/test_dist.py:126-130), and RMSprop's first step is ±lr·√10 where
    |g| ≫ 1e-4 but ∝ g below, so small-gradient elements carry that noise
    into the update.  Relative norm of the update difference 0.25 per tensor,
    0.05 over all parameters (the head biases, pure rounding, left out)."""
    r = train_step_runs
    old, _ = _named(r["v"])
    new, new_bufs = _named({"params": jax.tree.map(np.asarray, r["jnew"].params),
                            "batch_stats": jax.tree.map(np.asarray, r["jnew"].batch_stats)})
    num = den = worst = 0.0
    for n, p in r["state"].params.items():
        if n.endswith("head.bias"):
            continue
        d_got, d_want = p.detach() - old[n], new[n] - old[n]
        num += (d_got - d_want).norm().item() ** 2
        den += d_want.norm().item() ** 2
        worst = max(worst, (d_got - d_want).norm().item() / d_want.norm().item())
    stat = max((b - new_bufs[n]).abs().max().item() / new_bufs[n].abs().max().item()
               for n, b in r["state"].batch_stats.items())
    total = (num / den) ** 0.5
    print(f"[parity] after one step: update relative norm max {worst:.2e} per tensor "
          f"(tol 0.25), {total:.2e} over all (tol 0.05); batch_stats {stat:.2e} (tol 1e-5)")
    assert worst <= 0.25 and total <= 0.05 and stat <= 1e-5
    assert r["state"].step == 1 and r["state"].opt_state["count"] == 1


def test_fused_red_trains_on_the_cpu():
    """fused_red=True trains on the CPU: the train-mode forward runs the
    fused RED pipeline under autograd (its plain versions here) and its
    backward reaches every parameter; without gradients it runs too."""
    model = CascadeREDNet(ndepths=NDEPTHS, fused_red=True, device="cpu")
    b = tsyn.make_batch(1, 32, 32, seed=0, device="cpu")
    out = model(b["imgs"], b["cams"], b["depth_values"], train=True)
    assert out["depth"].shape == (1, 32, 32) and out["depth"].requires_grad
    loss = cascade_loss(out, b["depth_stages"], b["mask_stages"], (0.5, 1.0, 2.0))[0]
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    reg = {n for n, _ in model.named_parameters() if n.startswith("regs.")}
    got = {n for (n, _), g in zip(model.named_parameters(), grads)
           if g is not None and bool(torch.isfinite(g).all())}
    assert reg <= got
    inf = model(b["imgs"], b["cams"], b["depth_values"])
    assert inf["depth"].shape == (1, 32, 32) and not inf["depth"].requires_grad


def test_train_fused_sweep_raises():
    """train_fused_sweep=True trains on the fused sweep: the train-mode
    forward builds each stage's volume with sweep_variance (its plain
    versions here, forward and backward) and the backward reaches every
    parameter with finite gradients; fused_sweep=False turns it off (the
    per-view sweep), as in JAX."""
    model = CascadeModel(NDEPTHS, train_fused_sweep=True).eval()
    b = tsyn.make_batch(1, 32, 32, seed=0, device="cpu")
    out = model(b["imgs"], b["cams"], b["depth_values"], train=True)
    loss = cascade_loss(out, b["depth_stages"], b["mask_stages"], (0.5, 1.0, 2.0))[0]
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
    assert model.train_fused_sweep and CascadeModel(NDEPTHS, train_fused_sweep=True,
                                                    fused_sweep=False).fused_sweep is False


@pytest.mark.parametrize("field,value", [
    ("mesh_data", 0), ("mesh_spatial", 0), ("mesh_depth", 0)])
def test_config_refuses_what_the_port_lacks(field, value):
    with pytest.raises(ValueError, match=field):
        Config(**{field: value})


@pytest.mark.parametrize("field,value,knob,want", [
    ("compute_dtype", "bfloat16", "compute_dtype", torch.bfloat16),
    ("torch_compat", True, "torch_compat", True)])
def test_config_takes_the_model_knobs(field, value, knob, want):
    """The two knobs the port once refused construct, and the model they
    configure is built with them (tests/test_torch_knobs.py holds them to
    JAX)."""
    from satmvs_tpu_torch.train.loop import create_model

    cfg = Config(**{field: value})
    assert getattr(cfg, field) == value
    assert getattr(create_model(cfg, "cpu"), knob) == want


@pytest.mark.parametrize("field,value", [("geo_model", "pinhole"), ("use_qc", True)])
def test_config_takes_the_camera_models(field, value):
    """The two camera models the port runs construct, and the model they
    configure is built with them."""
    from satmvs_tpu_torch.train.loop import create_model

    cfg = Config(**{field: value})
    assert getattr(cfg, field) == value
    assert create_model(cfg, "cpu").geo_model == cfg.geo_model
