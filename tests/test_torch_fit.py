"""The port's training loop pieces on the CPU: the optimizer against optax,
the losses and metrics against the JAX package, the Config CLI against the
JAX Config, and `fit` with checkpoints and resume."""

import json
import os

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from satmvs_tpu.models import cascade_loss as jcascade_loss
from satmvs_tpu.train import metrics as jmetrics
from satmvs_tpu.train.config import Config as JConfig
from satmvs_tpu.train.loop import make_optimizer as jmake_optimizer
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.models.losses import cascade_loss
from satmvs_tpu_torch.train import Config, fit, make_optimizer
from satmvs_tpu_torch.train import checkpoints as ckpt
from satmvs_tpu_torch.train import metrics as tmetrics


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REFERENCE_CLI = ["--mode=train", "--model=red", "--geo_model=rpc", "--ndepths", "48,32,8",
                 "--depth_inter_r", "4,2,1", "--lrepochs", "10,12,14:2", "--min_interval", "5.0"]


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def test_optimizer_matches_optax_across_a_milestone():
    """Five updates with wd > 0, steps_per_epoch 2 and milestones at epochs
    1 and 2 (LR halved after updates 2 and 4), gradients spanning 1e-6..1 so
    that eps inside the square root matters: parameters and ν within 1e-6
    relative of optax's rmsprop chain."""
    cfg_kw = dict(lr=1e-2, lr_milestones=(1, 2), lr_gamma=0.5, wd=1e-2)
    shapes = {"a": (3, 4), "b": (7,)}
    params = {k: _rand(s, i) for i, (k, s) in enumerate(shapes.items())}
    jtx = jmake_optimizer(JConfig(**cfg_kw), 2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tx = make_optimizer(Config(**cfg_kw), 2)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = tx.init(tp)
    for step in range(5):
        grads = {k: _rand(s, 10 + step + i) * 10.0 ** -(step + i) for i, (k, s)
                 in enumerate(shapes.items())}
        upd, jstate = jtx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tx.update({k: torch.from_numpy(g) for k, g in grads.items()}, tstate, tp)
    assert tstate["count"] == 5 and tx.learning_rate(4) == pytest.approx(2.5e-3)
    nu = jstate[1][0].nu  # chain(add_decayed_weights, rmsprop): rmsprop's scale_by_rms
    for k in shapes:
        err = np.abs(tp[k].numpy() - np.asarray(jp[k])).max() / np.abs(np.asarray(jp[k])).max()
        nerr = np.abs(tstate["nu"][k].numpy() - np.asarray(nu[k])).max() / np.asarray(nu[k]).max()
        print(f"[parity] RMSprop {k}: params {err:.2e}, nu {nerr:.2e} relative (tol 1e-6)")
        assert err <= 1e-6 and nerr <= 1e-6


def test_losses_and_metrics_match_jax():
    """cascade_loss (total and final-stage depth loss) and standard_metrics,
    with a partial mask and errors past the 250 m cut: 1e-6 relative."""
    shapes = [(2, 4, 6), (2, 8, 12), (2, 16, 24)]
    est = [_rand(s, i, 3.0) for i, s in enumerate(shapes)]
    est[-1].reshape(-1)[::17] += 400.0
    gt = [_rand(s, 10 + i) for i, s in enumerate(shapes)]
    mask = [(np.random.default_rng(20 + i).uniform(size=s) > 0.3).astype(np.float32)
            for i, s in enumerate(shapes)]
    outs = {f"stage{i + 1}": {"depth": torch.from_numpy(e)} for i, e in enumerate(est)}
    jouts = {f"stage{i + 1}": {"depth": jnp.asarray(e)} for i, e in enumerate(est)}
    T = [torch.from_numpy(a) for a in gt], [torch.from_numpy(a) for a in mask]
    got = cascade_loss(outs, *T)
    want = jcascade_loss(jouts, [jnp.asarray(a) for a in gt], [jnp.asarray(a) for a in mask])
    got_m = tmetrics.standard_metrics(outs["stage3"]["depth"], T[0][-1], T[1][-1], 2.5)
    want_m = jmetrics.standard_metrics(jouts["stage3"]["depth"], jnp.asarray(gt[-1]),
                                       jnp.asarray(mask[-1]), 2.5)
    pairs = [("loss", got[0], want[0]), ("depth_loss", got[1], want[1])] + [
        (k, got_m[k], want_m[k]) for k in want_m]
    for name, g, w in pairs:
        print(f"[parity] {name}: {float(g):.6f} vs {float(w):.6f}")
        assert float(g) == pytest.approx(float(w), rel=1e-6, abs=1e-7), name
    meter = tmetrics.DictAverageMeter()
    meter.update({"a": 1.0})
    meter.update({"a": torch.tensor(3.0)})
    assert meter.mean() == {"a": 2.0}


def test_config_from_args_matches_jax():
    """The reference CLI parses to the same values in both packages, every
    field; the port's default fused_red is auto (None)."""
    got, want = Config.from_args(REFERENCE_CLI), JConfig.from_args(REFERENCE_CLI)
    import dataclasses

    for f in dataclasses.fields(JConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert {f.name for f in dataclasses.fields(Config)} == {
        f.name for f in dataclasses.fields(JConfig)}
    assert got.ndepths == (48, 32, 8) and got.lr_gamma == 0.5 and got.num_stage == 3
    assert got.fused_red is None
    assert Config.from_args(["--fused_red", "off", "--sweep_stencil", "4"]).fused_red is False
    for argv in (["--geo_model", "pinhole"], ["--use_qc"]):
        got, want = Config.from_args(argv), JConfig.from_args(argv)
        assert (got.geo_model, got.use_qc) == (want.geo_model, want.use_qc)
    assert Config.from_args(["--mesh_data", "2"]).mesh_data == 2
    got = Config.from_args(["--mesh_spatial", "2", "--mesh_depth", "4"])
    assert (got.mesh_spatial, got.mesh_depth) == (2, 4)


def test_fit_checkpoints_and_resume(tmp_path):
    """fit for 2 epochs of 2 steps at 32×32, ndepths (8, 4, 4), save_freq 1:
    both epochs checkpointed, the record files written; then a resumed fit
    with epochs=2 restores epoch 2 exactly and trains no further, and a
    third epoch continues from it."""
    batches = [tsyn.make_batch(1, 32, 32, seed=s, device="cpu") for s in (0, 1)]
    cfg = Config(ndepths=(8, 4, 4), epochs=2, save_freq=1, summary_freq=1, seed=3)
    workdir = str(tmp_path)
    logs = []
    model, state, _ = fit(cfg, batches, batches[:1], workdir, log_fn=logs.append)
    assert ckpt.latest_epoch(workdir) == 2 and state.step == 4
    assert {"1", "2", "metrics.jsonl", "train_record.txt"} <= set(os.listdir(workdir))
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["mode"] for r in records].count("train") == 4
    assert [r["mode"] for r in records].count("fulltest") == 2
    assert all(np.isfinite(r["loss"]) for r in records)
    assert len(open(tmp_path / "train_record.txt").read().splitlines()) == 2
    saved = {k: v.detach().clone() for k, v in state.params.items()}

    cfg_resume = Config(ndepths=(8, 4, 4), epochs=2, resume=True, seed=4)
    _, resumed, _ = fit(cfg_resume, batches, batches[:1], workdir, log_fn=logs.append)
    assert "resumed from epoch 2" in logs
    assert resumed.step == 4 and resumed.opt_state["count"] == 4
    for k, v in resumed.params.items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)
    for k, v in resumed.batch_stats.items():
        torch.testing.assert_close(v, state.batch_stats[k], rtol=0, atol=0)

    cfg_more = Config(ndepths=(8, 4, 4), epochs=3, resume=True, seed=4)
    _, more, _ = fit(cfg_more, batches, batches[:1], workdir, log_fn=None)
    assert more.step == 6 and ckpt.latest_epoch(workdir) == 3
    assert any(not torch.equal(v, saved[k]) for k, v in more.params.items())


def test_checkpoint_restore_picks_the_epoch_and_refuses_a_mismatch(tmp_path):
    """restore_checkpoint(epoch=k) takes epoch k, the latest by default;
    nothing saved gives (None, None); a state with other tensors raises."""
    from satmvs_tpu_torch.train.loop import TrainState

    def state_of(value):
        p = {"w": torch.full((2, 3), value)}
        return TrainState(p, {"bn.running_mean": torch.zeros(3)},
                          {"nu": {"w": torch.zeros(2, 3)}, "count": 0}, 0)

    assert ckpt.restore_checkpoint(str(tmp_path), state_of(0.0)) == (None, None)
    for epoch in (1, 2):
        s = state_of(float(epoch))
        s.step = 10 * epoch
        ckpt.save_checkpoint(str(tmp_path), epoch, s)
    os.makedirs(tmp_path / "7")  # a save that never finished: no state file
    target = state_of(0.0)
    _, ep = ckpt.restore_checkpoint(str(tmp_path), target)
    assert ep == 2 and target.step == 20 and target.params["w"].eq(2.0).all()
    _, ep = ckpt.restore_checkpoint(str(tmp_path), target, epoch=1)
    assert ep == 1 and target.step == 10 and target.params["w"].eq(1.0).all()
    other = state_of(0.0)
    other.params["v"] = torch.zeros(1)
    with pytest.raises(KeyError, match="params"):
        ckpt.restore_checkpoint(str(tmp_path), other)
