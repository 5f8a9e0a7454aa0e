"""The port's training step on the fused RED pipeline (fused_red None, the
default, or True), on the CPU: against its own fused_red=False step, which
computes the same function through the RED scan (loss, eval-mode gradients,
the update and the running statistics), which path `Config()` takes and
which backwards it runs; and, marked slow, against JAX `make_train_step`
with fused_red=True (its Pallas kernels and their custom VJPs in interpret
mode).  Weights come from numpy seeds at flax's LeCun scale
(`test_torch_train.seeded`) through `params.load_jax_variables`."""

import functools

import numpy as np
import jax
import pytest
import torch

from satmvs_tpu.models import build_model as jbuild
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.models.losses import cascade_loss
from satmvs_tpu_torch.nn.red import REDRegularizer as TRED
from satmvs_tpu_torch.ops.kernels import plane_conv as tpc
from satmvs_tpu_torch.ops.kernels import red_recur as trr
from satmvs_tpu_torch.train import Config, create_model_and_state, make_train_step

from test_torch_train import H, NDEPTHS, W, seeded

# fused against scan, the same function in another order of fp32 sums:
# the losses to 1e-5 relative; eval-mode gradients to a relative norm of
# 1e-4 per tensor, the logit heads' biases (a softmax ignores a shift of
# all logits: their gradient is 0 up to rounding) to 1e-6 of the largest
# gradient element; the train-mode update (new − old) to 5e-2 per tensor
# and 1e-2 over all, a fifth of the gates against JAX in test_torch_train
# (train-mode BatchNorm gradients amplify rounding, and RMSprop's first
# step, ±lr·√10 where |g| ≫ 1e-4 and ∝ g below, carries it through
# small-gradient elements); running statistics to 1e-6 of each tensor's
# largest value
LOSS, GRAD, HEAD, UPDATE, UPDATE_ALL, STATS = 1e-5, 1e-4, 1e-6, 5e-2, 1e-2, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def variables():
    jm = jbuild("red", "rpc", ndepths=NDEPTHS, fused_red=False)
    from satmvs_tpu.data import synthetic as jsyn
    from satmvs_tpu.train.loop import numeric_batch

    jb = numeric_batch(jsyn.make_batch(1, W, H, seed=0))
    args = (jb["imgs"], jb["cams"], jb["depth_values"])
    return seeded(jax.eval_shape(functools.partial(jm.init, train=False),
                                 jax.random.PRNGKey(0), *args), 6)


def _run(variables, fused_red):
    batch = tsyn.make_batch(1, W, H, seed=0, device="cpu")
    cfg = Config(ndepths=NDEPTHS, fused_red=fused_red)
    model, state, tx = create_model_and_state(cfg, batch, 2, variables=variables)
    old = {k: v.detach().clone() for k, v in state.params.items()}
    out = model.run_cascade(batch["imgs"], batch["cams"], batch["depth_values"], False)
    loss = cascade_loss(out, batch["depth_stages"], batch["mask_stages"], cfg.dlossw)[0]
    names = list(state.params)
    grads = dict(zip(names, torch.autograd.grad(loss, [state.params[n] for n in names])))
    state, scalars = make_train_step(model, tx, cfg.dlossw)(state, batch)
    return {"loss": loss.item(), "step_loss": scalars["loss"].item(), "grads": grads, "old": old,
            "params": {k: v.detach() for k, v in state.params.items()},
            "stats": dict(state.batch_stats)}


@pytest.fixture(scope="module")
def runs(variables):
    return {fr: _run(variables, fr) for fr in (None, False)}


def test_fused_step_loss_matches_the_scan_step(runs):
    fused, scan = runs[None], runs[False]
    for name in ("loss", "step_loss"):
        rel = abs(fused[name] - scan[name]) / abs(scan[name])
        print(f"[parity] fused vs scan {name}: {fused[name]:.6f} vs {scan[name]:.6f}, "
              f"{rel:.2e} relative (tol {LOSS})")
        assert rel <= LOSS, name


def test_fused_eval_gradients_match_the_scan_step(runs):
    fused, scan = runs[None]["grads"], runs[False]["grads"]
    scale = max(g.abs().max().item() for g in scan.values())
    worst = head = 0.0
    for n, g in fused.items():
        diff = (g - scan[n]).norm().item()
        if n.endswith("head.bias"):
            head = max(head, diff / scale)
        else:
            worst = max(worst, diff / scan[n].norm().item())
    print(f"[parity] fused vs scan eval-mode gradients: max relative norm {worst:.2e} over "
          f"{len(fused)} tensors (tol {GRAD}), head biases {head:.2e} (tol {HEAD})")
    assert worst <= GRAD and head <= HEAD


def test_fused_update_matches_the_scan_step(runs):
    fused, scan = runs[None], runs[False]
    num = den = worst = 0.0
    for n, p in fused["params"].items():
        if n.endswith("head.bias"):
            continue
        d_f, d_s = p - fused["old"][n], scan["params"][n] - scan["old"][n]
        num += (d_f - d_s).norm().item() ** 2
        den += d_s.norm().item() ** 2
        worst = max(worst, (d_f - d_s).norm().item() / d_s.norm().item())
    stats = max((b - scan["stats"][n]).abs().max().item() / scan["stats"][n].abs().max().item()
                for n, b in fused["stats"].items())
    total = (num / den) ** 0.5
    print(f"[parity] fused vs scan update: relative norm max {worst:.2e} per tensor (tol "
          f"{UPDATE}), {total:.2e} over all (tol {UPDATE_ALL}); running statistics "
          f"{stats:.2e} (tol {STATS})")
    assert worst <= UPDATE and total <= UPDATE_ALL and stats <= STATS


def test_default_config_trains_on_the_fused_pipeline(monkeypatch):
    """Config() defaults (fused_red None): the train step runs
    REDRegularizer.pipeline once per stage and never the scan, and each RED
    backward as often as its forward (3 stages × conv_dn 3, red_recur 4,
    deconv_up 3, conv_head 1); on the CPU no kernel launches."""
    calls = {"pipeline": 0, "scan": 0}
    for name in calls:
        orig = getattr(TRED, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(TRED, name, spy)
    backs = {}
    for mod, name in ((tpc, "conv_dn_backward"), (tpc, "deconv_up_backward"),
                      (tpc, "conv_head_backward"), (trr, "red_recur_backward")):
        orig = getattr(mod, name)
        backs[name] = 0

        def bspy(*a, _orig=orig, _name=name, **k):
            backs[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, bspy)
    counters = [tpc.conv_dn, tpc.deconv_up, tpc.conv_head, trr.red_recur]
    before = [f.launches for f in counters]
    batch = tsyn.make_batch(1, W, H, seed=0, device="cpu")
    cfg = Config(ndepths=NDEPTHS)
    assert cfg.fused_red is None
    model, state, tx = create_model_and_state(cfg, batch, 1)
    assert model.fused_red is None
    state, scalars = make_train_step(model, tx, cfg.dlossw)(state, batch)
    assert bool(torch.isfinite(scalars["loss"]))
    assert calls == {"pipeline": 3, "scan": 0}
    assert backs == {"conv_dn_backward": 9, "deconv_up_backward": 9, "conv_head_backward": 3,
                     "red_recur_backward": 12}
    assert [f.launches for f in counters] == before


@pytest.mark.slow
def test_fused_step_matches_jax_fused_train_step(variables):
    """Against JAX make_train_step(fused_red=True): its Pallas pipeline and
    custom VJPs in interpret mode, compiled for the whole cascade, take
    minutes on the CPU, hence `slow`.  Loss to 1e-5 relative, the update to
    the gates of test_torch_train's fused_red=False comparison."""
    import jax.numpy as jnp

    from satmvs_tpu.data import synthetic as jsyn
    from satmvs_tpu.train.config import Config as JConfig
    from satmvs_tpu.train.loop import TrainState as JState
    from satmvs_tpu.train.loop import make_optimizer as jmake_optimizer
    from satmvs_tpu.train.loop import make_train_step as jmake_train_step
    from satmvs_tpu.train.loop import numeric_batch
    from test_torch_train import _named

    jb = numeric_batch(jsyn.make_batch(1, W, H, seed=0))
    jcfg = JConfig(ndepths=NDEPTHS, fused_red=True)
    jm = jbuild("red", "rpc", ndepths=NDEPTHS, fused_red=True)
    jtx = jmake_optimizer(jcfg, 2)
    v = variables
    jstate = JState(params=v["params"], batch_stats=v["batch_stats"],
                    opt_state=jtx.init(v["params"]), step=jnp.zeros((), jnp.int32))
    jnew, jscalars = jmake_train_step(jm, jtx, tuple(jcfg.dlossw))(jstate, jb)
    got = _run(v, True)
    rel = abs(got["step_loss"] - float(jscalars["loss"])) / abs(float(jscalars["loss"]))
    old, _ = _named(v)
    new, _ = _named({"params": jax.tree.map(np.asarray, jnew.params),
                     "batch_stats": jax.tree.map(np.asarray, jnew.batch_stats)})
    num = den = 0.0
    for n, p in got["params"].items():
        if not n.endswith("head.bias"):
            num += ((p - old[n]) - (new[n] - old[n])).norm().item() ** 2
            den += (new[n] - old[n]).norm().item() ** 2
    print(f"[parity] fused step vs JAX fused step: loss {rel:.2e} relative (tol 1e-5), update "
          f"{(num / den) ** 0.5:.2e} over all (tol 0.05)")
    assert rel <= 1e-5 and (num / den) ** 0.5 <= 0.05
