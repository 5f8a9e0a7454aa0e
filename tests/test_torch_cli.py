"""The port's CLIs (satmvs_tpu_torch/cli/{train,predict,predict_scene}.py) on
the CPU (SATMVS_PLATFORM=cpu), in-process `main(argv)`, 32² trees,
ndepths 8,4,4.

The journey of tests/test_cli.py on a tree the port's writer wrote: train
(and resume), test (its `final:` metrics are those of the height_result
maps it writes), predict with --fuse and --color.  The predict CLI's
`init`/`prob` maps against JAX `model.apply` with the same weights (a flax
variables tree drawn from a numpy seed, loaded with
`params.load_jax_variables` into a port checkpoint), full volume and
streaming: depth within a mean of 1 % and a p99 of 10 % of the final
stage's hypothesis step, confidence within 2e-3.  The scene CLI equals
`predict_scene` called directly, and fuses a DSM.  The JAX CLI against the
port CLI, each in its own process, is `slow`."""

import glob
import importlib.util
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satmvs_tpu.data import dataset as jds
from satmvs_tpu.data import loader as jld
from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.models import CascadeREDNet as JNet
from satmvs_tpu.train.loop import numeric_batch
from satmvs_tpu_torch.cli import predict as cli_predict
from satmvs_tpu_torch.cli import predict_scene as cli_scene
from satmvs_tpu_torch.cli import train as cli_train
from satmvs_tpu_torch.data import formats, png
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.train import Config, create_model_and_state, metrics
from satmvs_tpu_torch.train.checkpoints import save_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NDEPTHS = "8,4,4"
FINAL_STEP = 4 * 2.5 / 3  # final stage: D·interval / (D − 1), interval 1 × min_interval


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SATMVS_PLATFORM", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the CLIs run many small ops, which slow down
    many times over when several test processes each spread them over
    every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_test_predict_journey(tmp_path, capsys):
    root = str(tmp_path / "WHU_TLC")
    tsyn.write_whu_tlc_tree(root, num_train=2, num_test=1, width=32, height=32, h_amp=40.0,
                            h_scale=120.0)
    logdir, workdir = str(tmp_path / "logs"), str(tmp_path / "logs" / "red" / "rpc")
    common = [f"--dataset_root={root}", f"--logdir={logdir}", "--ndepths", NDEPTHS]
    out = cli_train.main(["--mode=train", *common, "--epochs", "1", "--summary_freq", "1"])
    assert out["timing"]["epochs"] == [1] and out["timing"]["steps"] == [2]
    assert out["train_loader"]["batches"] == 2 and out["test_loader"]["batches"] == 1
    assert os.path.isfile(os.path.join(workdir, "1", "state.pt"))
    assert os.path.isfile(os.path.join(workdir, "train_record.txt"))
    out = cli_train.main(["--mode=train", *common, "--epochs", "2", "--resume"])
    assert out["timing"]["epochs"] == [2]
    assert "resumed from epoch 1" in capsys.readouterr().out

    out = cli_train.main(["--mode=test", *common])
    assert out["epoch"] == 2 and "final:" in capsys.readouterr().out
    testpath = os.path.join(root, "open_dataset_rpc", "test")
    depth = formats.load_pfm(os.path.join(out["out_dir"], "block0000_2.pfm"))
    err = formats.load_pfm(os.path.join(out["out_dir"], "block0000_2_err.pfm"))
    prob = formats.load_pfm(os.path.join(out["out_dir"], "block0000_2_prob.pfm"))
    gt = formats.load_pfm(os.path.join(testpath, "height", "2", "block0000.pfm"))
    mask = err != -999.0
    np.testing.assert_array_equal(err[mask], (depth - gt)[mask])
    assert 0 <= prob.min() and prob.max() <= 1
    again = metrics.standard_metrics(torch.from_numpy(depth)[None], torch.from_numpy(gt)[None],
                                     torch.from_numpy(mask.astype(np.float32))[None])
    for key, value in again.items():
        assert math.isclose(out["metrics"][key], float(value), rel_tol=1e-6, abs_tol=1e-6), key

    out = cli_predict.main([f"--dataset_root={testpath}", f"--loadckpt={workdir}", "--ndepths",
                            NDEPTHS, "--fuse", "--d_ratio", "50", "--p_ratio", "5",
                            "--confidence_ratio", "0.0", "--color"])
    assert sorted(out["written"]) == [(v, "block0000") for v in "012"]
    for v in "012":
        for sub in ("init", "prob"):
            arr = formats.load_pfm(os.path.join(testpath, "mvs_results", v, sub, "block0000.pfm"))
            assert arr.shape == (32, 32) and np.isfinite(arr).all()
        assert png.png_size(os.path.join(testpath, "mvs_results", v, "init", "color",
                                         "block0000.png")) == (32, 32)
    path, valid = out["fused"]["block0000"]
    assert path.endswith("block0000_dsm.pfm") and os.path.isfile(path[:-4] + ".tfw")
    assert 0.0 < valid <= 1.0


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A flax variables tree drawn from a numpy seed (LeCun-scale kernels,
    perturbed norms and statistics, logit heads ×40), a port checkpoint of
    it, and a JAX-written 32² tree."""
    tmp = tmp_path_factory.mktemp("seeded")
    root = str(tmp / "ds")
    jsyn.write_synthetic_dataset(root, num_scenes=1, width=32, height=32, h_amp=40.0,
                                 h_scale=120.0)
    ndepths = tuple(int(x) for x in NDEPTHS.split(","))
    jb = jsyn.make_batch(1, 32, 32, seed=0, with_gt=False)
    jm = JNet(geo_model="rpc", ndepths=ndepths, fused_red=False)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(jb["imgs"]), jb["cams"],
                            jnp.asarray(jb["depth_values"]))
    rng = np.random.default_rng(11)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0.0, 1.0 / math.sqrt(np.prod(s.shape[:-1])), s.shape)
        if name == "scale":
            return 1.0 + 0.2 * rng.normal(size=s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.normal(size=s.shape)  # bias, mean

    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(draw(p, s), np.float32), shapes)
    for i in range(3):
        head = variables["params"][f"REDRegularizer_{i}"]["ScanREDStep_0"]["Conv_0"]
        head["kernel"] = head["kernel"] * 40.0
        head["bias"] = head["bias"] * 40.0
    cfg = Config(ndepths=ndepths)
    _, state, _ = create_model_and_state(cfg, {"imgs": torch.empty(0)}, 1, variables=variables)
    ckpt = str(tmp / "ckpt")
    save_checkpoint(ckpt, 1, state)
    return {"root": root, "ckpt": ckpt, "variables": variables, "model": jm}


@pytest.fixture(scope="module")
def jax_predictions(seeded) -> dict:
    """JAX model.apply on each pred-mode sample: {(view, name): (depth, prob)}."""
    ds = jds.MVSDataset(seeded["root"], "pred", 3)
    run = jax.jit(lambda v, i, c, d: seeded["model"].apply(v, i, c, d, train=False))
    out = {}
    for batch in jld.Loader(ds, 1, prefetch=0):
        nb = numeric_batch(batch)
        res = run(seeded["variables"], nb["imgs"], nb["cams"], nb["depth_values"])
        out[(batch["out_view"][0], batch["out_name"][0])] = (
            np.asarray(res["depth"][0]), np.asarray(res["photometric_confidence"][0]))
    return out


@pytest.mark.parametrize("mode", [[], ["--streaming", "--slab", "2"]])
def test_predict_cli_matches_jax_model_apply(seeded, jax_predictions, mode):
    root = seeded["root"]
    out = cli_predict.main([f"--dataset_root={root}", f"--loadckpt={seeded['ckpt']}",
                            "--ndepths", NDEPTHS, *mode])
    assert out["epoch"] == 1 and sorted(out["written"]) == sorted(jax_predictions)
    for (view, name), (want, want_prob) in jax_predictions.items():
        depth = formats.load_pfm(os.path.join(root, "mvs_results", view, "init", f"{name}.pfm"))
        prob = formats.load_pfm(os.path.join(root, "mvs_results", view, "prob", f"{name}.pfm"))
        err = np.abs(depth - want) / FINAL_STEP
        print(f"[cli] predict {mode} view {view}: depth err mean {err.mean():.2e}, p99 "
              f"{np.quantile(err, 0.99):.2e} of step; prob {np.abs(prob - want_prob).max():.2e}")
        assert err.mean() <= 0.01 and np.quantile(err, 0.99) <= 0.1
        assert np.abs(prob - want_prob).max() <= 2e-3


def test_scene_cli_is_predict_scene_and_fuses(seeded, tmp_path):
    from satmvs_tpu_torch.cli import restore_model
    from satmvs_tpu_torch.infer.predict import streaming_red_forward
    from satmvs_tpu_torch.infer.scene import predict_scene

    scene = tsyn.make_scene(96, 96, seed=2, h_amp=60.0)
    images, rpcs = [], []
    for v in range(3):
        png.write_png(str(tmp_path / f"v{v}.png"), scene["images"][v].astype(np.uint8))
        formats.save_rpc(str(tmp_path / f"v{v}.rpc"), scene["rpcs"][v])
        images.append(str(tmp_path / f"v{v}.png"))
        rpcs.append(str(tmp_path / f"v{v}.rpc"))
    out = cli_scene.main(["--images", *images, "--rpcs", *rpcs, f"--loadckpt={seeded['ckpt']}",
                          f"--out={tmp_path / 'h.pfm'}", "--ndepths", NDEPTHS, "--ref_index", "2",
                          "--tile", "64", "--halo", "32", "--streaming", "--slab", "2",
                          "--batch_tiles", "2", f"--dsm={tmp_path / 'dsm.tif'}",
                          "--d_ratio", "50", "--p_ratio", "5"])
    cfg = Config(ndepths=(8, 4, 4), view_num=3)
    model, _, _ = restore_model(cfg, seeded["ckpt"], torch.device("cpu"))
    imgs = np.stack([formats.read_scene_image(p) for p in images])
    want, _ = predict_scene(lambda i, c, d: streaming_red_forward(model, i, c, d, slab=2), imgs,
                            scene["rpcs"], tile=64, halo=32, ref_index=2, batch_tiles=2,
                            device="cpu")
    np.testing.assert_array_equal(formats.load_pfm(str(tmp_path / "h.pfm")), want)
    np.testing.assert_array_equal(out["depth"], want)
    assert out["stats"]["n_tiles"] == 4 and out["n_chunks"] == 3 * 2
    for v in range(3):
        assert formats.load_pfm(str(tmp_path / f"h_view{v}.pfm")).shape == (96, 96)
    path, valid = out["dsm"]
    assert path == str(tmp_path / "dsm.pfm") and valid > 0.0


def test_clis_refuse_what_the_port_lacks(seeded, jax_predictions, tmp_path, monkeypatch):
    """The flags the port once refused run: cli.train --compute_dtype
    bfloat16 trains a step (finite loss, a checkpoint) and cli.predict
    --torch_compat writes its maps (tests/test_torch_knobs.py and
    tests/test_torch_convert.py hold both to JAX).  The two camera flags
    run: with --use_qc the test mode evaluates and predict's maps are JAX's
    basis-form predictions under the predict gates above; with
    --geo_model=pinhole both run on a pinhole tree
    (tests/test_torch_pinhole.py holds them to JAX)."""
    base = [f"--dataset_root={seeded['root']}", f"--logdir={tmp_path}", "--ndepths", NDEPTHS]
    out = cli_train.main(["--mode=train", *base, "--compute_dtype=bfloat16", "--epochs", "1"])
    assert out["timing"]["epochs"] == [1] and out["timing"]["steps"][0] >= 1
    assert os.path.isfile(os.path.join(str(tmp_path), "red", "rpc", "1", "state.pt"))
    pbase = [f"--dataset_root={seeded['root']}", f"--loadckpt={seeded['ckpt']}"]
    out = cli_predict.main([*pbase, "--ndepths", NDEPTHS, "--torch_compat"])
    assert sorted(out["written"]) == sorted(jax_predictions)
    assert all(np.isfinite(formats.load_pfm(p)).all() for p in out["written"].values())
    out = cli_train.main(["--mode=test", *base, f"--loadckpt={seeded['ckpt']}", "--use_qc"])
    assert out["epoch"] == 1 and np.isfinite(out["metrics"]["loss"])
    out = cli_predict.main([*pbase, "--ndepths", NDEPTHS, "--use_qc"])
    assert sorted(out["written"]) == sorted(jax_predictions)
    for key, (want, _) in jax_predictions.items():
        err = np.abs(formats.load_pfm(out["written"][key]) - want) / FINAL_STEP
        assert err.mean() <= 0.01 and np.quantile(err, 0.99) <= 0.1, key
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    pin = chip_smoke.write_pinhole_tree(str(tmp_path / "pin"), 0, 1, width=32, height=32)
    out = cli_train.main(["--mode=test", f"--dataset_root={pin}", f"--logdir={tmp_path}",
                          "--ndepths", NDEPTHS, f"--loadckpt={seeded['ckpt']}",
                          "--geo_model=pinhole"])
    assert out["epoch"] == 1 and np.isfinite(out["metrics"]["loss"])
    out = cli_predict.main([f"--dataset_root={pin}/open_dataset_pinhole/test",
                            f"--loadckpt={seeded['ckpt']}", "--ndepths", NDEPTHS,
                            "--geo_model=pinhole"])
    assert len(out["written"]) == 3
    assert all(np.isfinite(formats.load_pfm(p)).all() for p in out["written"].values())
    with pytest.raises(SystemExit, match="no checkpoint"):
        cli_predict.main([f"--dataset_root={seeded['root']}", f"--loadckpt={tmp_path}",
                          "--ndepths", NDEPTHS])
    monkeypatch.delenv("SATMVS_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_predict.main([*pbase, "--ndepths", NDEPTHS])


def _run(args, timeout=900):
    env = dict(os.environ, SATMVS_PLATFORM="cpu", PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.slow
def test_jax_cli_and_port_cli_agree(seeded, tmp_path):
    """scripts/predict.py on an Orbax checkpoint of the seeded variables and
    `python -m satmvs_tpu_torch.cli.predict` on the port's, each in its own
    process on copies of one tree, with --fuse: the same maps (the depth
    gates above) and DSM valid fractions within 0.5 percentage points."""
    import shutil

    from satmvs_tpu.train import checkpoints as jckpt
    from satmvs_tpu.train.config import Config as JConfig
    from satmvs_tpu.train.loop import create_model_and_state as jcreate

    ds = jds.MVSDataset(seeded["root"], "pred", 3)
    first = next(iter(jld.Loader(ds, 1, prefetch=0)))
    _, jstate, _ = jcreate(JConfig(ndepths=(8, 4, 4)), first, 1, abstract_init=True)
    jstate = jstate.replace(params=seeded["variables"]["params"],
                            batch_stats=seeded["variables"]["batch_stats"])
    jckpt.save_checkpoint(str(tmp_path / "jckpt"), 1, jstate)
    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    for r in roots.values():
        shutil.copytree(seeded["root"], r, ignore=shutil.ignore_patterns("mvs_results"))
    fuse = ["--ndepths", NDEPTHS, "--fuse", "--d_ratio", "50", "--p_ratio", "5"]
    r = _run(["scripts/predict.py", f"--dataset_root={roots['jax']}",
              f"--loadckpt={tmp_path / 'jckpt'}", *fuse])
    assert r.returncode == 0, r.stderr[-3000:]
    r = _run(["-m", "satmvs_tpu_torch.cli.predict", f"--dataset_root={roots['port']}",
              f"--loadckpt={seeded['ckpt']}", *fuse])
    assert r.returncode == 0, r.stderr[-3000:]
    for path in glob.glob(os.path.join(roots["jax"], "mvs_results", "*", "init", "*.pfm")):
        rel = os.path.relpath(path, roots["jax"])
        err = np.abs(formats.load_pfm(os.path.join(roots["port"], rel))
                     - formats.load_pfm(path)) / FINAL_STEP
        assert err.mean() <= 0.01 and np.quantile(err, 0.99) <= 0.1, rel
    for k in ("jax", "port"):
        (dsm_path,) = glob.glob(os.path.join(roots[k], "mvs_results", "*_dsm.pfm"))
        roots[k] = (formats.load_pfm(dsm_path) != -999.0).mean()
    assert abs(roots["jax"] - roots["port"]) <= 0.005
