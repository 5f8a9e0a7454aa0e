"""The one-stage cascade (`--ndepths 64`, stage 1 alone at 1/4 resolution)
against the JAX package on the CPU, at 32×32 with ndepths (8,) and the
CLI's three-entry depth_intervals_ratio / cr_base_chs (JAX indexes them by
stage, so the first entries serve): FeatureNet(num_stage=1) in both
decoder modes, the forward of the three families, the RED scan, RED's
eval-mode loss and gradients, streaming against the full volume, a
converted one-stage reference checkpoint, `cli.predict --ndepths 64`, and
the refusals that mirror where JAX fails at one stage or two.

Weights are flax variables trees drawn from numpy seeds in the shapes of
`jax.eval_shape(model.init)` (LeCun-scale kernels, perturbed norms and
BatchNorm statistics; the logit heads ×40 for RED and ×10 for the
CostRegNets, as `tests/test_torch_model.py` and
`tests/test_torch_model_costreg.py` sharpen them), carried over by
`params.load_jax_variables`.  Gates: FeatureNet 1e-5; depth within 1 % of
the stage's hypothesis step (the height range / (D − 1)) and confidence
within 2e-3 (`tests/test_torch_model.py`); UCSNet's variance 1e-3
relative; eval-mode gradients 1e-3 relative norm a tensor
(`tests/test_torch_train.py`); the fused DSM at `tests/test_torch_fuse.py`'s
gates."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.infer import fuse as jfuse
from satmvs_tpu.infer.scene import predict_scene as jpredict_scene
from satmvs_tpu.models import build_model as jbuild
from satmvs_tpu.models import cascade_loss as jcascade_loss
from satmvs_tpu.nn.featurenet import FeatureNet as JFeatureNet
from satmvs_tpu.train import convert as jconvert
from satmvs_tpu.train.config import Config as JConfig
from satmvs_tpu.train.loop import TrainState as JState
from satmvs_tpu.train.loop import make_eval_step as jmake_eval_step
from satmvs_tpu.train.loop import make_optimizer as jmake_optimizer
from satmvs_tpu.train.loop import make_train_step as jmake_train_step
from satmvs_tpu.train.loop import numeric_batch
from satmvs_tpu_torch.cli import predict as cli_predict
from satmvs_tpu_torch.data import formats
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.infer import fuse as tfuse
from satmvs_tpu_torch.infer.predict import streaming_red_forward
from satmvs_tpu_torch.infer.scene import predict_scene
from satmvs_tpu_torch.models import build_model
from satmvs_tpu_torch.models.losses import cascade_loss
from satmvs_tpu_torch.nn.featurenet import FeatureNet
from satmvs_tpu_torch.params import init_from_seed, load_jax_variables
from satmvs_tpu_torch.train import Config, create_model, create_model_and_state
from satmvs_tpu_torch.train import convert as tconvert
from satmvs_tpu_torch.train import make_eval_step, make_train_step
from satmvs_tpu_torch.train.checkpoints import save_checkpoint
from satmvs_tpu_torch.train.loop import make_optimizer, state_of

from test_torch_convert import reference_state_dict
from test_torch_train import seeded

H = W = 32
NDEPTHS = (8,)
FAMILIES = ("red", "casmvs", "ucs")
HEAD_GAIN = {"red": 40.0, "casmvs": 10.0, "ucs": 10.0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small ops, run beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_args(batch) -> tuple:
    return jnp.asarray(batch["imgs"]), batch["cams"], jnp.asarray(batch["depth_values"])


@functools.lru_cache(maxsize=None)
def jax_model(family: str, ndepths: tuple = NDEPTHS):
    """JAX's family at `ndepths` (the CLI's three-entry ratio and widths)."""
    return jbuild(family, "rpc", ndepths=ndepths, fused_red=False)


@functools.lru_cache(maxsize=None)
def jax_run(family: str) -> dict:
    """The seeded one-stage variables of `family` (heads sharpened), JAX's
    jitted eval-mode apply and its outputs on the 32² batch."""
    jm = jax_model(family)
    args = _jax_args(jsyn.make_batch(1, W, H, seed=0, num_stage=1, with_gt=False))
    v = seeded(jax.eval_shape(functools.partial(jm.init, train=False),
                              jax.random.PRNGKey(0), *args), 11)
    head = (v["params"]["REDRegularizer_0"]["ScanREDStep_0"] if family == "red" else
            v["params"]["CostRegNet_0"])["Conv_0"]
    for k in head:  # the kernel, and RED's bias
        head[k] = head[k] * HEAD_GAIN[family]
    apply = jax.jit(lambda var, *a: jm.apply(var, *a, train=False))
    want = jax.tree.map(np.asarray, apply(v, *args))
    return {"v": v, "apply": apply, "want": want}


def port_batch(with_gt: bool = False) -> dict:
    return tsyn.make_batch(1, W, H, seed=0, device="cpu", with_gt=with_gt, num_stage=1)


def port_model(family: str, variables: dict, **knobs):
    return load_jax_variables(build_model(family, "rpc", ndepths=NDEPTHS, device="cpu", **knobs),
                              variables)


def hold_to_jax(batch: dict, got: dict, want: dict, what: str) -> None:
    """Stage 1 (the top level too) against JAX: depth 1 % of the step,
    confidence 2e-3, UCSNet's variance 1e-3 relative."""
    lo, hi = batch["depth_values"][0].tolist()
    step = (hi - lo) / (NDEPTHS[0] - 1)
    assert sorted(got) == sorted(want)
    for key in ("depth", "photometric_confidence"):
        np.testing.assert_array_equal(got[key].numpy(), got["stage1"][key].numpy())
    g, w = got["stage1"], want["stage1"]
    assert g["depth"].shape == w["depth"].shape == (1, H // 4, W // 4)
    derr = np.abs(g["depth"].numpy() - w["depth"]).max()
    cerr = np.abs(g["photometric_confidence"].numpy() - w["photometric_confidence"]).max()
    print(f"[one stage] {what}: depth {derr:.2e} m = {derr / step:.2e} of step (tol 0.01), "
          f"confidence {cerr:.2e} (tol 2e-3)")
    assert derr <= 0.01 * step and cerr <= 2e-3
    if "variance" in w:
        verr = np.abs(g["variance"].numpy() - w["variance"]).max() / np.abs(w["variance"]).max()
        print(f"[one stage] {what}: variance {verr:.2e} relative (tol 1e-3)")
        assert verr <= 1e-3


@pytest.mark.parametrize("arch_mode", ["unet", "fpn"])
def test_featurenet_one_stage_matches_jax(arch_mode):
    """FeatureNet(num_stage=1): the encoder and the 1/4-resolution head
    alone, holding exactly the flax tree's leaves (ConvBlock_0-7, Conv_0),
    against flax's FeatureNet(num_stage=1) to 1e-5; two stages raise."""
    jm = JFeatureNet(8, num_stage=1, arch_mode=arch_mode)
    x = np.random.default_rng(1).normal(size=(2, H, W, 3)).astype(np.float32)
    v = seeded(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 2)
    assert sorted(v["params"]) == [*(f"ConvBlock_{i}" for i in range(8)), "Conv_0"]
    want = jm.apply(v, x)
    tm = FeatureNet(8, arch_mode, num_stage=1)
    n_leaves = len(jax.tree.leaves(v))
    n_port = sum(1 for n, _ in tm.state_dict().items() if not n.endswith("num_batches_tracked"))
    assert n_port == n_leaves and tm.out_channels == JFeatureNet(8, num_stage=1).out_channels
    load_jax_variables(tm, v)
    got = tm.eval()(torch.from_numpy(x))
    assert len(got) == len(want) == 1 and got[0].shape == (2, H // 4, W // 4, 32)
    err = np.abs(got[0].detach().numpy() - np.asarray(want[0])).max()
    print(f"[one stage] FeatureNet {arch_mode}: {err:.2e} (tol 1e-5)")
    assert err <= 1e-5
    with pytest.raises(ValueError, match="two-stage"):
        FeatureNet(8, arch_mode, num_stage=2)


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_one_stage_matches_jax(family):
    """Each family's one-stage forward (the fused RED pipeline or the packed
    CostRegNet, their plain versions on CPU tensors) against JAX's; the
    model built with the CLI's three-entry ratio and widths keeps their
    first entries."""
    r = jax_run(family)
    tm = port_model(family, r["v"])
    assert len(tm.regs) == 1 and tm.depth_intervals_ratio == (4.0,)
    b = port_batch()
    hold_to_jax(b, tm(b["imgs"], b["cams"], b["depth_values"]), r["want"],
                f"{family} forward")


def test_red_scan_one_stage_matches_jax():
    """The RED scan path (`fused_red=False`, torch built-ins) at one stage."""
    r = jax_run("red")
    tm = port_model("red", r["v"], fused_red=False)
    b = port_batch()
    hold_to_jax(b, tm(b["imgs"], b["cams"], b["depth_values"]), r["want"], "red scan")


def test_red_loss_and_eval_mode_gradients_match_jax():
    """RED's differentiable forward at one stage with stage-scale ground
    truth built here (the full-resolution map at every fourth pixel), each
    package's loss function called directly: loss 1e-5 relative, eval-mode
    gradients 1e-3 relative norm a tensor (the head's bias, whose gradient
    is 0 up to rounding, 1e-6 of the largest gradient element)."""
    r = jax_run("red")
    jm = jax_model("red")
    jb = jsyn.make_batch(1, W, H, seed=0, num_stage=1)
    gt = [jnp.asarray(jb["depth_stages"][0][:, ::4, ::4])]
    mask = [jnp.ones_like(gt[0])]
    args = _jax_args(jb)

    def eval_loss(params):
        out = jm.apply({"params": params, "batch_stats": r["v"]["batch_stats"]}, *args,
                       train=False)
        return jcascade_loss(out, gt, mask)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(eval_loss))(r["v"]["params"])
    tm = port_model("red", r["v"])
    b = port_batch(with_gt=True)
    tgt = [b["depth_stages"][0][:, ::4, ::4]]
    with torch.enable_grad():
        out = tm.run_cascade(b["imgs"], b["cams"], b["depth_values"], False)
        loss = cascade_loss(out, tgt, [torch.ones_like(tgt[0])])[0]
        names = [n for n, _ in tm.named_parameters()]
        grads = dict(zip(names, torch.autograd.grad(loss, list(tm.parameters()))))
    lerr = abs(loss.item() - float(jloss)) / abs(float(jloss))
    want = dict(port_model("red", {"params": jax.tree.map(np.asarray, jgrads),
                                   "batch_stats": r["v"]["batch_stats"]}).named_parameters())
    scale = max(w.abs().max().item() for w in want.values())
    worst = 0.0
    for n, g in grads.items():
        diff = (g - want[n]).norm().item()
        if n.endswith("head.bias"):
            assert diff <= 1e-6 * scale, n
        else:
            worst = max(worst, diff / want[n].norm().item())
    print(f"[one stage] RED loss {loss.item():.6f} vs {float(jloss):.6f}, {lerr:.2e} relative "
          f"(tol 1e-5); eval-mode gradients max relative norm {worst:.2e} over {len(grads)} "
          f"tensors (tol 1e-3)")
    assert lerr <= 1e-5 and worst <= 1e-3


@pytest.mark.parametrize("slab", [8, 16])
def test_streaming_matches_full_volume(slab):
    """`streaming_red_forward` at one stage, slab 8 (= D) and 16 (≥ D: the
    stage in one slab), against the full-volume forward: 1e-3 of a step
    and confidence 1e-4; regularizers that do not match ndepths raise."""
    r = jax_run("red")
    tm = port_model("red", r["v"])
    b = port_batch()
    full = tm(b["imgs"], b["cams"], b["depth_values"])
    got = streaming_red_forward(tm, b["imgs"], b["cams"], b["depth_values"], slab=slab)
    lo, hi = b["depth_values"][0].tolist()
    step = (hi - lo) / (NDEPTHS[0] - 1)
    derr = (got["depth"] - full["depth"]).abs().max().item()
    cerr = (got["photometric_confidence"] - full["photometric_confidence"]).abs().max().item()
    print(f"[one stage] streaming slab {slab}: depth {derr / step:.2e} of step, confidence "
          f"{cerr:.2e}")
    assert sorted(got) == ["depth", "photometric_confidence", "stage1"]
    assert derr <= 1e-3 * step and cerr <= 1e-4
    tm.ndepths = (8, 8, 8)
    with pytest.raises(ValueError, match="1 RED stages"):
        streaming_red_forward(tm, b["imgs"], b["cams"], b["depth_values"], slab=slab)


@pytest.mark.parametrize("family", FAMILIES)
def test_converted_reference_checkpoint_matches_jax(family):
    """A synthetic one-stage reference state dict (`chip_smoke.
    reference_state_dict` of the one-stage tree) through the port's and
    JAX's `convert_reference_checkpoint(num_stage=1)`: the same tree bit for
    bit, which loads with every port tensor filled into a model whose
    forward holds JAX's gates."""
    r = jax_run(family)
    sd = reference_state_dict(r["v"], family)
    got = tconvert.convert_reference_checkpoint(sd, family, num_stage=1)
    want = jconvert.convert_reference_checkpoint(sd, family, num_stage=1)
    for a, b in zip(got, want):
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    tm = port_model(family, {"params": got[0], "batch_stats": got[1]})
    b = port_batch()
    hold_to_jax(b, tm(b["imgs"], b["cams"], b["depth_values"]), r["want"],
                f"{family} converted")


@pytest.mark.parametrize("family", FAMILIES)
def test_two_stages_raise_as_jax_fails(family):
    """ndepths (8, 4): JAX fails on the shapes (its second feature map is at
    1/2 resolution, STAGE_SCALES[2] puts stage 2 at full resolution); the
    port raises before any weight is built, naming the cause, as it does
    for a ratio or widths list shorter than ndepths."""
    args = _jax_args(jsyn.make_batch(1, W, H, seed=0, num_stage=2, with_gt=False))
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(functools.partial(jax_model(family, (8, 4)).init, train=False),
                       jax.random.PRNGKey(0), *args)
    with pytest.raises(ValueError, match="STAGE_SCALES"):
        build_model(family, "rpc", ndepths=(8, 4), device="cpu")
    with pytest.raises(ValueError, match="cr_base_chs"):
        build_model(family, "rpc", ndepths=(8, 8, 8), cr_base_chs=(8,), device="cpu")


@pytest.mark.parametrize("step", ["train", "eval"])
def test_one_stage_train_and_eval_steps_raise_as_jax_fails(step):
    """At one stage the dataset's ground truth is at full resolution
    (`build_pyramid`) while stage 1 is at 1/4: JAX's train and eval steps
    fail on the broadcast, the port's loss raises naming the cause."""
    jb = numeric_batch(jsyn.make_batch(1, W, H, seed=0, num_stage=1))
    jcfg = JConfig(ndepths=NDEPTHS, fused_red=False)
    jm, v = jax_model("red"), jax_run("red")["v"]
    if step == "train":
        jtx = jmake_optimizer(jcfg, 1)
        jstate = JState(params=v["params"], batch_stats=v["batch_stats"],
                        opt_state=jtx.init(v["params"]), step=jnp.zeros((), jnp.int32))
        jfn = functools.partial(jmake_train_step(jm, jtx, tuple(jcfg.dlossw)), jstate)
    else:
        jstate = JState(params=v["params"], batch_stats=v["batch_stats"], opt_state=None,
                        step=jnp.zeros((), jnp.int32))
        jfn = functools.partial(jmake_eval_step(jm, tuple(jcfg.dlossw), 2.5), jstate)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jfn(jb)

    tb = port_batch(with_gt=True)
    assert tb["depth_stages"][0].shape == (1, H, W)
    cfg = Config(ndepths=NDEPTHS)
    model, state, tx = create_model_and_state(cfg, tb, 1, variables=v)
    fn = (make_train_step(model, tx, cfg.dlossw) if step == "train" else
          make_eval_step(model, cfg.dlossw, cfg.min_interval))
    with pytest.raises(ValueError, match=r"stage1: estimate \(1, 8, 8\) against ground truth "
                                         r"\(1, 32, 32\).*build_pyramid"):
        fn(state, tb)


def test_one_stage_scene_raises_as_jax_fails():
    """`predict_scene(num_stage=1)` on a 64² triplet in 32² tiles: JAX's
    fails at the stitch (an 8×8 map cannot fill a 32² tile's interior), the
    port's raises when it reads its first chunk back, naming the cause."""
    scene = jsyn.make_scene(64, 64, seed=2, h_amp=40.0)
    order = [2, 0, 1]
    images, rpcs = scene["images"][order], scene["rpcs"][order]
    r = jax_run("red")
    with pytest.raises(ValueError, match="could not broadcast"):
        jpredict_scene(lambda i, c, d: r["apply"](r["v"], i, c, d), images, rpcs, tile=32,
                       halo=0, num_stage=1)
    tm = port_model("red", r["v"])
    calls = []

    def forward(i, c, d):
        calls.append(len(c))
        return tm(i, c, d)

    with pytest.raises(ValueError, match="1/4 of the tile"):
        predict_scene(forward, images, rpcs, tile=32, halo=0, num_stage=1, device="cpu")
    # one stage's cameras; the first chunk is read once the second is queued, of four
    assert calls == [1, 1]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One 32² scene of three views in the WHU-TLC layout, written by the port."""
    root = str(tmp_path_factory.mktemp("one_stage") / "ds")
    tsyn.write_synthetic_dataset(root, num_scenes=1, width=W, height=H, h_amp=40.0,
                                 h_scale=120.0)
    return root


@pytest.mark.parametrize("family,flags", [("red", ["--fuse", "--geo_consist_num", "1",
                                                    "--d_ratio", "50", "--p_ratio", "5",
                                                    "--confidence_ratio", "0.0"]),
                                          ("red", ["--streaming", "--slab", "8"]),
                                          ("casmvs", []), ("ucs", [])])
def test_predict_cli_at_ndepths_64(family, flags, tree, tmp_path, monkeypatch):
    """`cli.predict --ndepths 64` (the CLI's other stage lists at their
    three-entry defaults) from a one-stage port checkpoint writes
    1/4-resolution init and prob maps for every view.  --fuse: JAX's
    script fuses such maps with the full-resolution RPCs into a DSM (with
    the filter settings of tests/test_cli.py; at its defaults the seeded
    weights leave it no point to rasterize, and it raises); the port's DSM
    matches JAX's fusion of the same maps at tests/test_torch_fuse.py's
    gates, its grid's origin within 1e-3 m (the extent of fused points
    whose heights the filters round apart by up to 1e-3 m; the maps here
    are a model's, not exact heights, and move it by ~1e-5 m)."""
    monkeypatch.setenv("SATMVS_PLATFORM", "cpu")
    root = str(tmp_path / "ds")
    os.symlink(tree, root)
    ckpt = str(tmp_path / "ckpt")
    cfg = Config(model=family, ndepths=(64,))
    model = create_model(cfg, torch.device("cpu"))
    assert len(model.regs) == 1
    save_checkpoint(ckpt, 1, state_of(model, make_optimizer(cfg, 1)))
    out = cli_predict.main([f"--dataset_root={root}", f"--loadckpt={ckpt}", "--model", family,
                            "--ndepths", "64", *flags])
    assert len(out["written"]) == 3
    for path in out["written"].values():
        for sub in ("init", "prob"):
            arr = formats.load_pfm(path.replace(os.sep + "init" + os.sep,
                                                os.sep + sub + os.sep))
            assert arr.shape == (H // 4, W // 4) and np.isfinite(arr).all()
    if "--fuse" not in flags:
        return
    (name, (tpath, _)), = out["fused"].items()
    views = sorted(v for v, n in out["written"] if n == name)
    mvs = os.path.join(root, "mvs_results")
    depths = np.stack([formats.load_pfm(os.path.join(mvs, v, "init", f"{name}.pfm"))
                       for v in views])
    prob = formats.load_pfm(os.path.join(mvs, views[0], "prob", f"{name}.pfm"))
    rpcs = np.stack([formats.load_rpc(os.path.join(root, "rpc", v, f"{name}.rpc"))[0]
                     for v in views])
    jpath, _, _ = jfuse.fuse_scene_to_dsm(depths, rpcs, str(tmp_path / "j_dsm.tif"),
                                          grid_res=5.0, prob=prob, p_ratio=5.0, d_ratio=50.0,
                                          geo_consist_num=1, confidence_ratio=0.0)
    got, gtfw = formats.read_dsm(tpath)
    want, wtfw = formats.read_dsm(jpath)
    assert got.shape == want.shape
    # the grid: its origin is the fused points' extent, whose heights the two
    # filters round apart (within 1e-3 m, tests/test_torch_fuse.py)
    np.testing.assert_allclose(gtfw, wtfw, rtol=0, atol=1e-3)
    valid, jvalid = got != tfuse.INVALID_DEPTH, want != tfuse.INVALID_DEPTH
    both = valid & jvalid
    mean_err = np.abs(got[both] - want[both]).mean()
    print(f"[one stage] --fuse DSM {got.shape}: valid {valid.mean():.4f} vs JAX's fusion "
          f"{jvalid.mean():.4f}; mean |dh| {mean_err:.2e} m")
    assert abs(valid.mean() - jvalid.mean()) <= 0.005 and valid.mean() > 0.2
    assert mean_err <= 0.05


def test_init_from_seed_fills_a_one_stage_model():
    """`params.init_from_seed` at one stage: every tensor drawn, the
    decoder absent, the same weights from the same seed."""
    a = init_from_seed(build_model("ucs", "rpc", ndepths=(8,), device="cpu"), 4)
    b = init_from_seed(build_model("ucs", "rpc", ndepths=(8,), device="cpu"), 4)
    assert not any(n.startswith(("feature.deconv", "feature.out2", "feature.inner"))
                   for n in a.state_dict())
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=n)
