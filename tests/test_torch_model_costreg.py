"""The CostRegNet families: the port's CascadeMVSNet and UCSNet (RPC,
inference; the packed CostRegNet on the plane convs' plain versions on the
CPU) against `satmvs_tpu.models.CascadeMVSNet` / `UCSNet` (`model.apply`,
train=False, XLA's 3-D convolutions on the CPU) on the same synthetic batch
and bridged weights, at 32×64, 3 views, ndepths (8, 8, 8).

The weights are a flax variables tree drawn from a numpy seed in the shape
of `jax.eval_shape(model.init)`: LeCun-scale kernels, perturbed norms and
BatchNorm statistics (scale 1 ± 0.2, bias and mean ± 0.1, var in
[0.5, 1.5]), the CostRegNet logit heads ×10 so the window confidence spans
most of [0, 1].  Gates: per-stage depth within a mean of 1 % and a p99 of
10 % of the stage's hypothesis step (UCSNet's windows: each pixel's own
step), confidence within 2e-3, UCSNet's variance within 1e-3 relative.
Also: a B = 2 forward against two B = 1 forwards, the bridge's coverage,
and the predict and train CLIs on the two families."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.models import CascadeMVSNet as JMVS
from satmvs_tpu.models import UCSNet as JUCS
from satmvs_tpu_torch.cli import predict as cli_predict
from satmvs_tpu_torch.cli import restore_model
from satmvs_tpu_torch.cli import train as cli_train
from satmvs_tpu_torch.data import formats
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.data.dataset import MVSDataset
from satmvs_tpu_torch.data.loader import Loader
from satmvs_tpu_torch.models import CascadeMVSNet, UCSNet, build_model
from satmvs_tpu_torch.models.cascade import stage_hypotheses
from satmvs_tpu_torch.ops.kernels.plane_conv import conv_dn, conv_head, deconv_up
from satmvs_tpu_torch.ops.kernels.red_recur import red_recur
from satmvs_tpu_torch.ops.kernels.sweep_variance import sweep_variance
from satmvs_tpu_torch.params import load_jax_variables
from satmvs_tpu_torch.train import Config, create_model, create_model_and_state
from satmvs_tpu_torch.train.checkpoints import save_checkpoint
from satmvs_tpu_torch.train.loop import make_optimizer, state_of

H, W = 32, 64
NDEPTHS = (8, 8, 8)
INTERVALS = (10.0, 5.0, 2.5)  # depth_intervals_ratio (4, 2, 1) × min_interval 2.5
FAMILIES = {"casmvs": (JMVS, CascadeMVSNet), "ucs": (JUCS, UCSNet)}
HEAD_GAIN = 10.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small ops, run beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_variables(model, args, seed: int) -> dict:
    """A flax variables tree of `model` drawn from numpy seed `seed` (the
    module docstring's scales)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
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


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """One family's JAX apply and the port's forward on the same batch."""
    name = request.param
    jcls, tcls = FAMILIES[name]
    jb = jsyn.make_batch(1, W, H, seed=0, with_gt=False)
    jm = jcls(geo_model="rpc", ndepths=NDEPTHS)
    args = (jnp.asarray(jb["imgs"]), jb["cams"], jnp.asarray(jb["depth_values"]))
    variables = seeded_variables(jm, args, seed=3)
    want = jax.tree.map(np.asarray, jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
        variables, *args))

    tb = tsyn.make_batch(1, W, H, seed=0, device="cpu")
    tm = load_jax_variables(tcls(ndepths=NDEPTHS, device="cpu"), variables)
    wrappers = (sweep_variance, conv_dn, red_recur, deconv_up, conv_head)
    launches = [fn.launches for fn in wrappers]
    got = tm(tb["imgs"], tb["cams"], tb["depth_values"])
    assert [fn.launches for fn in wrappers] == launches  # CPU tensors: the plain versions
    return {"name": name, "want": want, "got": got, "dv": jb["depth_values"][0],
            "variables": variables, "model": tm}


def _steps(fam, i: int) -> np.ndarray:
    """Stage i's (1-based) hypothesis step at each pixel, from JAX's own
    previous stage: the height range / (D − 1) at stage 1, D·interval /
    (D − 1) in CasMVS's windows, each pixel's clamped window / (D − 1) in
    UCSNet's."""
    lo, hi = (float(x) for x in fam["dv"])
    if i == 1:
        return np.full((1, H // 4, W // 4), (hi - lo) / (NDEPTHS[0] - 1))
    if fam["name"] == "casmvs":
        nd = NDEPTHS[i - 1]
        return np.full((1,), nd * INTERVALS[i - 1] / (nd - 1))
    prev = fam["want"][f"stage{i - 1}"]
    scale = (4, 2, 1)[i - 1]
    hyps = stage_hypotheses(NDEPTHS[i - 1], H // scale, W // scale, torch.tensor([lo]),
                            torch.tensor([hi]), 0.0, torch.tensor(prev["depth"]),
                            torch.tensor(prev["variance"]), "uncertainty")
    return (hyps[:, 1] - hyps[:, 0]).numpy()


def test_family_depth_matches_jax(family):
    """Per-stage depth: mean ≤ 1 %, p99 ≤ 10 % of the stage's step."""
    for i in (1, 2, 3):
        w = family["want"][f"stage{i}"]["depth"]
        g = family["got"][f"stage{i}"]["depth"].numpy()
        scale = (4, 2, 1)[i - 1]
        assert g.shape == w.shape == (1, H // scale, W // scale)
        err = np.abs(g - w) / _steps(family, i)
        print(f"[parity] {family['name']} stage{i} depth: mean {err.mean():.2e}, p99 "
              f"{np.quantile(err, 0.99):.2e}, max {err.max():.2e} of step (tol 0.01, 0.1)")
        assert err.mean() <= 0.01 and np.quantile(err, 0.99) <= 0.1, f"stage{i}"
    np.testing.assert_array_equal(family["got"]["depth"].numpy(),
                                  family["got"]["stage3"]["depth"].numpy())


def test_family_confidence_and_variance_match_jax(family):
    """The 4-plane window confidence within 2e-3 (it spans most of [0, 1]
    with the sharpened heads); UCSNet's variance within 1e-3 relative."""
    for i in (1, 2, 3):
        w, g = family["want"][f"stage{i}"], family["got"][f"stage{i}"]
        cerr = np.abs(g["photometric_confidence"].numpy() - w["photometric_confidence"]).max()
        print(f"[parity] {family['name']} stage{i} confidence: {cerr:.2e} (tol 2e-3), range "
              f"[{w['photometric_confidence'].min():.3f}, {w['photometric_confidence'].max():.3f}]")
        assert cerr <= 2e-3, f"stage{i}"
        assert sorted(g) == sorted(w)
        if family["name"] == "ucs":
            verr = np.abs(g["variance"].numpy() - w["variance"]) / np.abs(w["variance"]).max()
            print(f"[parity] ucs stage{i} variance: {verr.max():.2e} relative (tol 1e-3)")
            assert verr.max() <= 1e-3
    spread = family["want"]["stage3"]["photometric_confidence"]
    assert spread.max() - spread.min() > 0.3


def test_batch_of_two_is_two_batches_of_one(family):
    """A B = 2 forward against the two B = 1 forwards: depth and variance
    within 1e-5 of the height range, confidence within 1e-5, on the CPU,
    whose plain convolutions may sum a batch of 2·D planes in another order
    than one of D (on the card the CostRegNet kernels give the same bits:
    tests/test_torch_kernels.py, `cuda`)."""
    tm, tb = family["model"], tsyn.make_batch(2, W, H, seed=1, device="cpu")
    both = tm(tb["imgs"], tb["cams"], tb["depth_values"])
    lo, hi = (float(x) for x in tb["depth_values"][0])
    for b in range(2):
        one = tm(tb["imgs"][b:b + 1], tuple(c[b:b + 1] for c in tb["cams"]),
                 tb["depth_values"][b:b + 1])
        for key in sorted(one["stage3"]):
            for i in (1, 2, 3):
                got, want = both[f"stage{i}"][key][b], one[f"stage{i}"][key][0]
                scale = (hi - lo) if key != "photometric_confidence" else 1.0
                assert torch.allclose(got, want, rtol=0, atol=1e-5 * scale), (b, key, i)


def test_bridge_fills_every_parameter(family):
    """load_jax_variables filled every parameter and running statistic (it
    raises otherwise), left no key over, and one more key raises."""
    tm, v = family["model"], family["variables"]
    n_flax = sum(x.size for x in jax.tree_util.tree_leaves(v))
    n_port = sum(p.numel() for p in tm.parameters()) + sum(
        b.numel() for n, b in tm.named_buffers() if n.endswith(("running_mean", "running_var")))
    assert n_port == n_flax
    extra = jax.tree.map(lambda x: x, v)
    extra["params"]["CostRegNet_0"]["Extra_0"] = {"kernel": np.zeros((1,), np.float32)}
    with pytest.raises(KeyError, match="Extra_0"):
        load_jax_variables(tm, extra)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A 32² WHU-TLC tree (1 train, 1 test block) written by the port."""
    root = str(tmp_path_factory.mktemp("costreg_cli") / "WHU_TLC")
    tsyn.write_whu_tlc_tree(root, num_train=1, num_test=1, width=32, height=32, h_amp=40.0,
                            h_scale=120.0)
    return root


def _checkpoint(model_name: str, workdir: str) -> Config:
    cfg = Config(model=model_name, ndepths=NDEPTHS)
    model = create_model(cfg, torch.device("cpu"))
    save_checkpoint(workdir, 1, state_of(model, make_optimizer(cfg, 1)))
    return cfg


@pytest.mark.parametrize("name,flags", [("casmvs", []), ("ucs", ["--streaming"])])
def test_predict_cli_runs_a_costreg_family(tree, tmp_path, monkeypatch, capsys, name, flags):
    """`cli.predict --model casmvs|ucs` from a port checkpoint: its maps are a
    direct forward of the restored model on the same batches, bit for bit;
    --streaming warns and takes the full-volume forward."""
    monkeypatch.setenv("SATMVS_PLATFORM", "cpu")
    testpath = os.path.join(tree, "open_dataset_rpc", "test")
    ckpt = str(tmp_path / "ckpt")
    cfg = _checkpoint(name, ckpt)
    out = cli_predict.main([f"--dataset_root={testpath}", f"--loadckpt={ckpt}", "--model", name,
                            "--ndepths", ",".join(map(str, NDEPTHS)), *flags])
    assert ("--streaming is red-only" in capsys.readouterr().err) == bool(flags)
    model, _, _ = restore_model(cfg, ckpt, torch.device("cpu"))
    assert model.regularizer == "costreg" and model.sampler == (
        "uncertainty" if name == "ucs" else "window")
    for batch in Loader(MVSDataset(testpath, "pred"), 1, device="cpu"):
        want = model(batch["imgs"], batch["cams"], batch["depth_values"])
        view, block = batch["out_view"][0], batch["out_name"][0]
        assert out["written"][(view, block)]
        for sub, key in (("init", "depth"), ("prob", "photometric_confidence")):
            got = formats.load_pfm(os.path.join(testpath, "mvs_results", view, sub,
                                                f"{block}.pfm"))
            np.testing.assert_array_equal(got, want[key][0].numpy())


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_train_cli_tests_and_does_not_train_a_costreg_family(tree, tmp_path, monkeypatch, name):
    """`cli.train --mode=train` trains a costreg family for an epoch (a
    finite loss, a checkpoint) and `--resume` continues with the second;
    `--mode=test` evaluates it from that checkpoint; share_cr=True raises
    (one regularizer cannot take the stages' feature widths)."""
    monkeypatch.setenv("SATMVS_PLATFORM", "cpu")
    logdir = str(tmp_path / "logs")
    common = [f"--dataset_root={tree}", f"--logdir={logdir}", "--model", name, "--ndepths",
              ",".join(map(str, NDEPTHS))]
    out = cli_train.main(["--mode=train", *common, "--epochs", "1"])
    assert out["timing"]["epochs"] == [1] and out["timing"]["steps"] == [1]
    out = cli_train.main(["--mode=train", *common, "--epochs", "2", "--resume"])
    assert out["timing"]["epochs"] == [2]
    workdir = os.path.join(logdir, name, "rpc")
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        losses = [r["loss"] for r in map(json.loads, f) if r["mode"] == "train"]
    assert losses and all(np.isfinite(losses))
    out = cli_train.main(["--mode=test", *common])
    assert out["epoch"] == 2 and all(np.isfinite(v) for v in out["metrics"].values())
    assert os.path.isfile(os.path.join(out["out_dir"], "block0000_2_prob.pfm"))
    model, state, _ = create_model_and_state(Config(model=name, ndepths=NDEPTHS),
                                             {"imgs": torch.empty(0)}, 1)
    assert model.regularizer == "costreg" and state.batch_stats
    assert build_model(name, "rpc", ndepths=NDEPTHS, device="cpu").regularizer == "costreg"
    with pytest.raises(ValueError, match="share_cr"):
        build_model(name, "rpc", share_cr=True, device="cpu")
