"""The port's data axis on torch.distributed (satmvs_tpu_torch/dist/), on the
CPU over gloo.

Ranks are separate processes (`tests/_torch_dist_ranks.py`), one world of
one rank and one of two, started once each for the module and side by side
with the serial references this process computes; they rendezvous through
a FileStore under the test's temporary directory.  What they hold:

  - one rank under a gloo group gives the serial port's bits: the train
    step (scalars, eval-mode gradients, parameters, statistics), the eval
    step and `predict_scene(mesh=)`;
  - two ranks, global batch 2 (one sample a rank), against the serial port
    at batch 2: the RED and CasMVS train steps, their eval-mode gradients at
    JAX's gate (tests/test_dist.py), the replicas bit for bit, the eval
    step, a batch whose halves hold different mask counts, `fit`, and the
    tile-parallel scene at JAX's gates (tests/test_scene.py);
  - view-sharded variance moments against JAX's serial volume;
  - the mesh's shapes, rank layout, refusals and volume specs against
    JAX's, and `shard_batch`.  The spatial and depth axes are
    tests/test_torch_dist_shard.py's.

The serial port is held to JAX's `make_train_step` by tests/test_torch_train.py
and tests/test_torch_train_costreg.py.  The gates of the train steps: the
serial step itself moves when only the order of its batch changes (the same
math, other sums): swapping the two samples moves the second step's loss by
6e-6 relative (RED) and 1.2e-4 (CasMVS), and the running statistics after
the first step by 1.7e-6 and 2.1e-5 of each tensor's largest value
(RMSprop's first update is near lr·√10·sign(g), so gradient elements that
are 0 up to rounding, such as the logit heads' biases, move by ±3e-3 either
way; the CostRegNet's coarsest BatchNorms see a few values a channel).  RED
keeps the gates of the data-parallel contract, the loss to 2e-4 and the
statistics to 1e-5; CasMVS is held to 3e-4 (2.5 times its loss spread;
the data-parallel step reads 1.77e-4) and 1e-4 (its statistics read 2.73e-5,
about four times their spread).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from satmvs_tpu.dist import make_mesh as jmake_mesh
from satmvs_tpu.dist import stage_volume_specs as jstage_volume_specs
from satmvs_tpu.dist import volume_spec as jvolume_spec
from satmvs_tpu.ops import cost_volume as jcost_volume
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.dist import (Mesh, batch_spec, make_mesh, shard_batch,
                                   stage_volume_specs, volume_spec)
from satmvs_tpu_torch.ops import cost_volume as tcost_volume
from satmvs_tpu_torch.train import Config, fit

import _torch_dist_ranks as ranks

ROOT = Path(__file__).resolve().parents[1]
WORLDS = {1: ["bits"], 2: ["red", "casmvs", "eval", "ragged", "variance", "scene", "fit"]}
STEP_GATES = {"red": {"loss": 2e-4, "stats": 1e-5}, "casmvs": {"loss": 3e-4, "stats": 1e-4}}
RANK_TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _launch(world: int, jobs: list, out: Path) -> list:
    out.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}  # the parent's threading too
    procs = []
    for r in range(world):
        with open(out / f"log{r}", "w") as log:  # the rank keeps its own descriptor
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_dist_ranks.py"), "--world",
                 str(world), "--rank", str(r), "--init", f"file://{out / 'init'}", "--out",
                 str(out), "--jobs", *jobs], env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def _collect(procs: list, out: Path) -> list:
    try:
        for p in procs:
            p.wait(timeout=RANK_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (out / f"log{r}").read_text()[-4000:]
    # the ranks' own files, written by this test's processes
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [rank results]}, the serial references, the ranks' folder."""
    base = tmp_path_factory.mktemp("dist")
    procs = {w: _launch(w, jobs, base / f"world{w}") for w, jobs in WORLDS.items()}
    try:
        batch = ranks.global_batch()
        serial = {"red": ranks.train_run("red", batch),
                  "casmvs": ranks.train_run("casmvs", batch),
                  "eval": ranks.eval_run(batch), "ragged": ranks.ragged_run(),
                  "scene": ranks.scene_run()}
    finally:
        got = {w: _collect(p, base / f"world{w}") for w, p in procs.items()}
    return got, serial, base


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _assert_grads_close(got: dict, want: dict):
    """JAX's gate for sharded against serial gradients (tests/test_dist.py):
    atol 5e-4 of the largest element, rtol 5e-3."""
    scale = max(g.abs().max().item() for g in want.values())
    assert got.keys() == want.keys()
    for k, g in want.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), atol=5e-4 * scale, rtol=5e-3,
                                   err_msg=k)


# ---- the mesh, without ranks


def test_make_mesh_matches_jax():
    """Shapes, rank layout and refusals against JAX's make_mesh on the 8
    virtual CPU devices: the port lays out the same extents, rank r at the
    place of device r in JAX's (data, spatial, depth) array, and refuses
    the same oversized meshes (ValueError); without a process group the
    world is one rank and there are no groups."""
    for data, spatial, depth in ((1, 1, 1), (2, 1, 1), (4, 1, 1), (8, 1, 1), (2, 4, 1),
                                 (2, 1, 4), (1, 2, 1), (1, 1, 2), (2, 2, 2), (16, 16, 1),
                                 (9, 1, 1)):
        try:
            jmesh = jmake_mesh(data=data, spatial=spatial, depth=depth)
        except ValueError:
            with pytest.raises(ValueError, match="devices"):
                make_mesh(data, spatial, depth, world_size=8)
            continue
        mesh = make_mesh(data, spatial, depth, world_size=8)
        assert mesh.shape == dict(jmesh.shape) and mesh.rank == 0 and mesh.group is None
        ids = np.vectorize(lambda d: d.id)(jmesh.devices)
        for r in range(data * spatial * depth):
            place = Mesh(mesh.shape, r, data * spatial * depth).coords
            assert ids[place] == ids.reshape(-1)[r], (data, spatial, depth, r)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(data=2)
    assert make_mesh().shape == {"data": 1, "spatial": 1, "depth": 1}


def test_stage_volume_specs_match_jax():
    """The volume specs, axis-name tuples in the port, against JAX's
    PartitionSpecs over a grid of stage depths, shard counts and heights."""
    n = 0
    for ndepths in ((64, 32, 8), (8, 8, 8), (32, 8, 8), (48, 32, 8), (16, 8), (64,)):
        for spatial in (False, True):
            for depth_shards in (1, 2, 4, 8):
                for spatial_shards, height in ((0, 0), (2, 64), (4, 384), (8, 128)):
                    got = stage_volume_specs(ndepths, spatial=spatial, depth_shards=depth_shards,
                                             spatial_shards=spatial_shards, height=height)
                    want = jstage_volume_specs(ndepths, spatial=spatial,
                                               depth_shards=depth_shards,
                                               spatial_shards=spatial_shards, height=height)
                    assert got == tuple(tuple(s) for s in want)
                    n += 1
    for sp in (False, True):
        for dp in (False, True):
            assert volume_spec(sp, dp) == tuple(jvolume_spec(sp, dp))
    assert batch_spec() == ("data",)
    assert n == 192


def test_shard_batch_cuts_every_leading_axis():
    """Each rank's share of a batch of 4 over 2 ranks is the global batch's
    contiguous half on every leading axis: images, depth range, ground truth
    and masks, RPC and QC camera bundles, pinhole matrices, names; a batch of
    3 raises."""
    rpc = tsyn.make_batch(4, 32, 32, seed=0, device="cpu")
    qc = tsyn.make_batch(4, 32, 32, seed=0, device="cpu", use_qc=True)
    pinhole = dict(rpc, cams=tuple(torch.randn(4, 3, 4, 4) for _ in range(3)),
                   out_name=["a", "b", "c", "d"])
    for batch in (rpc, qc, pinhole):
        for r in (0, 1):
            mesh = Mesh({"data": 2, "spatial": 1, "depth": 1}, r, 2)
            got = shard_batch(batch, mesh)
            half = slice(2 * r, 2 * r + 2)
            assert torch.equal(got["imgs"], batch["imgs"][half])
            assert torch.equal(got["depth_values"], batch["depth_values"][half])
            for key in ("depth_stages", "mask_stages"):
                assert all(torch.equal(g, w[half]) for g, w in zip(got[key], batch[key]))
            for g, w in zip(got["cams"], batch["cams"]):
                if isinstance(w, torch.Tensor):
                    assert torch.equal(g, w[half])
                else:
                    assert type(g) is type(w)
                    assert all(torch.equal(getattr(g, f), getattr(w, f)[half])
                               for f in w.__dataclass_fields__)
            if "out_name" in batch:
                assert got["out_name"] == batch["out_name"][half]
    odd = tsyn.make_batch(3, 32, 32, seed=0, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(odd, Mesh({"data": 2, "spatial": 1, "depth": 1}, 0, 2))


def test_config_takes_mesh_data_and_refuses_a10b():
    """The three mesh extents are accepted (the spatial and depth axes,
    ROADMAP A10b, run since); an extent below 1 raises."""
    assert Config(mesh_data=4, batch_size=4).mesh_data == 4
    for field in ("mesh_spatial", "mesh_depth"):
        assert getattr(Config(**{field: 2}), field) == 2
    for field in ("mesh_data", "mesh_spatial", "mesh_depth"):
        with pytest.raises(ValueError, match=field):
            Config(**{field: 0})


def test_fit_refuses_what_jax_refuses(tmp_path):
    """fit refuses a batch_size the data extent does not divide (JAX's
    words), and a mesh larger than the world, before any training."""
    batch = tsyn.make_batch(1, 32, 32, seed=0, device="cpu")
    with pytest.raises(ValueError, match="batch_size 3 not divisible by mesh_data 2"):
        fit(Config(ndepths=(8, 4, 4), mesh_data=2, batch_size=3), [batch], [batch],
            str(tmp_path), log_fn=None)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        fit(Config(ndepths=(8, 4, 4), mesh_data=2, batch_size=2), [batch], [batch],
            str(tmp_path), log_fn=None)


# ---- one rank: the serial bits


@pytest.mark.parametrize("path", ["train", "eval", "scene"])
def test_one_rank_gives_the_serial_bits(runs, path):
    """A gloo group of one rank: the data-parallel train step (two steps:
    scalars, eval-mode gradients, parameters, running statistics), the eval
    step and predict_scene(mesh=) give the serial port's bits in the same
    process."""
    got, _, _ = runs
    assert got[1][0]["bits"][path] is True


# ---- two ranks against the serial port


@pytest.mark.parametrize("model", ["red", "casmvs"])
def test_two_ranks_train_steps_match_serial(runs, model):
    """Two train steps at global batch 2 over two ranks against the serial
    step at batch 2 from the same weights: the first step's loss, depth_loss
    and abs_depth_error to 2e-4 relative, the second's to the model's gate,
    and the running statistics after the first step to the model's gate of
    each tensor's largest value (the module docstring's spreads)."""
    got, serial, _ = runs
    gate = STEP_GATES[model]
    dp, want = got[2][0][model], serial[model]
    for k, (g, w) in enumerate(zip(dp["scalars"], want["scalars"])):
        for key in ("loss", "depth_loss", "abs_depth_error"):
            rel = _rel(g[key], w[key])
            print(f"[dist] {model} step {k + 1} {key}: {rel:.2e} relative")
            assert rel <= (2e-4 if k == 0 else gate["loss"]), (model, k, key, rel)
    worst = max(((dp["stats_1"][n] - s).abs().max() / s.abs().max()).item()
                for n, s in want["stats_1"].items())
    print(f"[dist] {model} running statistics after a step: {worst:.2e} (tol {gate['stats']})")
    assert worst <= gate["stats"]


@pytest.mark.parametrize("model", ["red", "casmvs"])
def test_two_ranks_eval_mode_gradients_match_serial(runs, model):
    """The first step's eval-mode loss and gradients, summed over the two
    ranks, against the serial port's at batch 2, at JAX's gate for sharded
    against serial gradients (tests/test_dist.py); both ranks hold the
    same."""
    got, serial, _ = runs
    r0, r1 = got[2][0][model], got[2][1][model]
    assert _rel(r0["eval_loss"], serial[model]["eval_loss"]) <= 2e-4
    _assert_grads_close(r0["eval_grads"], serial[model]["eval_grads"])
    assert all(torch.equal(r0["eval_grads"][k], r1["eval_grads"][k]) for k in r0["eval_grads"])


@pytest.mark.parametrize("model", ["red", "casmvs"])
def test_two_rank_replicas_stay_bit_identical(runs, model):
    """After two steps the two ranks' parameters and running statistics are
    the same bits, and so are the scalars they report."""
    got, _, _ = runs
    r0, r1 = got[2][0][model], got[2][1][model]
    for group in ("params", "stats"):
        assert all(torch.equal(r0[group][k], r1[group][k]) for k in r0[group]), group
    assert r0["scalars"] == r1["scalars"]


def test_two_ranks_eval_step_matches_serial(runs):
    """The eval step over two ranks: the global batch's loss and metrics
    against the serial eval step (1e-5 relative), and each rank's maps the
    serial maps of its sample."""
    got, serial, _ = runs
    want = serial["eval"]
    for r, rank in enumerate(got[2]):
        dp = rank["eval"]
        for key, w in want["scalars"].items():
            assert abs(dp["scalars"][key] - w) <= 1e-5 * max(abs(w), 1.0), (key, r)
        np.testing.assert_allclose(dp["depth"].numpy(), want["depth"][r:r + 1].numpy(),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(dp["conf"].numpy(), want["conf"][r:r + 1].numpy(), atol=1e-4)


def test_loss_counts_the_global_batchs_mask(runs):
    """A global batch whose second sample keeps a quarter of its valid
    pixels: the two ranks' loss (each rank's sum over the global count) and
    gradients match the serial loss (2e-4) and gradients (JAX's gate), while
    the mean of the two ranks' own masked means misses the loss gate by far."""
    got, serial, _ = runs
    want = serial["ragged"]
    r0, r1 = got[2][0]["ragged"], got[2][1]["ragged"]
    assert _rel(r0["loss"], want["loss"]) <= 2e-4 and r0["loss"] == r1["loss"]
    _assert_grads_close(r0["grads"], want["grads"])
    averaged = (r0["own_mean"] + r1["own_mean"]) / 2
    print(f"[dist] ragged masks: loss {r0['loss']:.6f}, serial {want['loss']:.6f}, mean of "
          f"per-rank means {averaged:.6f}")
    assert _rel(averaged, want["loss"]) > 10 * 2e-4


def test_view_sharded_variance_matches_jax(runs):
    """Two ranks each hold one source view, rank 0 also the reference; the
    all-reduced moments give JAX's serial variance volume (atol 1e-5, as
    tests/test_ops.py:139), on both ranks, and the gradient of the ranks'
    losses (each Σ sin(volume)/2) in each rank's inputs is the serial port's
    gradient of Σ sin(volume) (1e-5)."""
    got, _, _ = runs
    ref, srcs = ranks.variance_inputs()
    want = np.asarray(jcost_volume.variance_cost_volume(jnp.asarray(ref),
                                                        [jnp.asarray(s) for s in srcs]))
    ref_t = torch.from_numpy(ref).requires_grad_(True)
    src_t = [torch.from_numpy(s).requires_grad_(True) for s in srcs]
    vol = tcost_volume.variance_cost_volume(ref_t, src_t)
    g_ref, *g_src = torch.autograd.grad(torch.sin(vol).sum(), [ref_t, *src_t])
    for r, rank in enumerate(got[2]):
        out = rank["variance"]
        np.testing.assert_allclose(out["vol"].numpy(), want, atol=1e-5)
        np.testing.assert_allclose(out["grad_src"].numpy(), g_src[r].numpy(), atol=1e-5)
    np.testing.assert_allclose(got[2][0]["variance"]["grad_ref"].numpy(), g_ref.numpy(),
                               atol=1e-5)


def test_view_sharded_variance_needs_num_views():
    """Under a group, num_views is required (JAX's error), before any
    collective runs."""
    ref, srcs = ranks.variance_inputs()
    with pytest.raises(ValueError, match="num_views is required when view-sharded"):
        tcost_volume.variance_cost_volume(torch.from_numpy(ref), [torch.from_numpy(srcs[0])],
                                          group=object())


def test_two_ranks_predict_scene_matches_serial(runs):
    """The 96² triplet (tile 64, halo 32: four tiles, one chunk of
    batch_tiles 4, slab-4 streaming) over two ranks, two tiles a rank: every
    rank returns the same stitched maps, within JAX's sharded-scene gates of
    the serial port's (tests/test_scene.py: depth atol 1e-3 rtol 1e-5,
    confidence 1e-4)."""
    got, serial, _ = runs
    want = serial["scene"]
    r0, r1 = got[2][0]["scene"], got[2][1]["scene"]
    assert r0["calls"] == r1["calls"] == [2] and want["calls"] == [4]
    assert r0["stats"]["local_tiles"] == 2 and r1["stats"]["rank"] == 1
    assert np.array_equal(r0["depth"], r1["depth"]) and np.array_equal(r0["conf"], r1["conf"])
    np.testing.assert_allclose(r0["depth"], want["depth"], atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(r0["conf"], want["conf"], atol=1e-4)


def test_fit_trains_data_parallel(runs):
    """fit with Config(mesh_data=2) on two ranks: one epoch of two global
    batches; the replicas end the same bits, only rank 0 logs and writes the
    record, metrics and checkpoint (once each)."""
    got, _, base = runs
    r0, r1 = got[2][0]["fit"], got[2][1]["fit"]
    for group in ("params", "stats"):
        assert all(torch.equal(r0[group][k], r1[group][k]) for k in r0[group])
    assert r0["steps"] == r1["steps"] == [2]
    assert r0["logs"] and not r1["logs"]
    workdir = base / "world2" / "fit"
    assert len((workdir / "train_record.txt").read_text().splitlines()) == 1
    assert len((workdir / "metrics.jsonl").read_text().splitlines()) == 3  # 2 train, 1 test
    assert (workdir / "1" / "state.pt").is_file()


# ---- against JAX's own sharded step, and the CLI under torchrun (slow)


@pytest.mark.slow
def test_two_rank_step_matches_jax_sharded_step(tmp_path):
    """Two port ranks against JAX's step on a make_mesh(data=2) virtual mesh
    (tests/test_dist.py's configuration: CascadeMVSNet, ndepths 8/8/8, B =
    2, here at 32×64) from the same numpy-seeded weights: the first train
    step's loss (2e-4 relative), and the eval-mode loss and gradients (JAX's
    sharded-gradient gate)."""
    import functools

    from satmvs_tpu.data import synthetic as jsyn
    from satmvs_tpu.dist import replicate as jreplicate
    from satmvs_tpu.dist import shard_batch as jshard_batch
    from satmvs_tpu.models import build_model as jbuild
    from satmvs_tpu.models import cascade_loss as jcascade_loss
    from satmvs_tpu.train.config import Config as JConfig
    from satmvs_tpu.train.loop import TrainState as JState
    from satmvs_tpu.train.loop import make_optimizer as jmake_optimizer
    from satmvs_tpu.train.loop import make_train_step as jmake_train_step
    from satmvs_tpu.train.loop import numeric_batch
    from satmvs_tpu_torch.train.loop import create_model
    from test_torch_train import seeded

    h, w = ranks.HW
    jb = numeric_batch(jsyn.make_batch(ranks.GLOBAL_B, w, h, seed=0))
    jcfg = JConfig(model="casmvs", ndepths=ranks.NDEPTHS)
    jm = jbuild("casmvs", "rpc", ndepths=ranks.NDEPTHS)
    args = (jb["imgs"], jb["cams"], jb["depth_values"])
    v = seeded(jax.eval_shape(functools.partial(jm.init, train=False),
                              jax.random.PRNGKey(0), *args), 6)
    (tmp_path / "world2").mkdir()
    torch.save(v, tmp_path / "world2" / "vars.pt")
    procs = _launch(2, ["jax"], tmp_path / "world2")
    try:
        jtx = jmake_optimizer(jcfg, 1)
        jstate = JState(params=v["params"], batch_stats=v["batch_stats"],
                        opt_state=jtx.init(v["params"]), step=jnp.zeros((), jnp.int32))

        def eval_loss(params, batch):
            out = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, batch["imgs"],
                           batch["cams"], batch["depth_values"], train=False)
            return jcascade_loss(out, batch["depth_stages"], batch["mask_stages"],
                                 jcfg.dlossw)[0]

        mesh = jmake_mesh(data=2)
        with jax.set_mesh(mesh):
            sharded = jshard_batch(jb, mesh)
            jloss, jgrads = jax.jit(jax.value_and_grad(eval_loss))(
                jreplicate(v["params"], mesh), sharded)
            _, jscalars = jmake_train_step(jm, jtx, tuple(jcfg.dlossw))(
                jreplicate(jstate, mesh), sharded)
    finally:
        got = _collect(procs, tmp_path / "world2")
    r0 = got[0]["jax"]
    named = create_model(ranks.config("casmvs"), "cpu", {
        "params": jax.tree.map(np.asarray, jgrads), "batch_stats": v["batch_stats"]})
    assert _rel(r0["eval_loss"], float(jloss)) <= 2e-4
    _assert_grads_close(r0["eval_grads"], {k: p.detach() for k, p in named.named_parameters()})
    assert _rel(r0["scalars"][0]["loss"], float(jscalars["loss"])) <= 2e-4


@pytest.mark.slow
def test_cli_train_under_torchrun_matches_the_serial_cli(tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 2 -m
    satmvs_tpu_torch.cli.train --mesh_data 2 --batch_size 2` on the CPU
    (gloo) against the serial CLI at --batch_size 2 on the same 32² tree:
    one epoch; from metrics.jsonl, written once, the first step's train
    loss (2e-4 relative) and the test pass's loss, depth loss and error
    (1e-4 relative); its accuracies, shares of the 2048 pixels of the test
    batch, may differ by a pixel either side of a threshold."""
    import json

    root = str(tmp_path / "tree")
    tsyn.write_whu_tlc_tree(root, num_train=2, num_test=2, width=32, height=32, h_amp=40.0)
    common = ["-m", "satmvs_tpu_torch.cli.train", "--mode=train", f"--dataset_root={root}",
              "--ndepths", "8,4,4", "--epochs", "1", "--batch_size", "2", "--summary_freq", "1"]
    env = {**os.environ, "PYTHONPATH": str(ROOT), "SATMVS_PLATFORM": "cpu"}
    runs = {}
    for name, launcher in (("serial", []), ("torchrun", [
            "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2"])):
        logdir = tmp_path / name
        extra = ["--mesh_data", "2"] if launcher else []
        out = subprocess.run([sys.executable, *launcher, *common, f"--logdir={logdir}", *extra],
                             env=env, cwd=str(ROOT), capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        lines = (logdir / "red" / "rpc" / "metrics.jsonl").read_text().splitlines()
        runs[name] = [json.loads(ln) for ln in lines]
    serial, dp = runs["serial"], runs["torchrun"]
    assert [r["mode"] for r in dp] == [r["mode"] for r in serial] == ["train", "fulltest"]
    assert _rel(dp[0]["loss"], serial[0]["loss"]) <= 2e-4
    for key in ("loss", "depth_loss", "abs_depth_acc"):
        assert _rel(dp[1][key], serial[1][key]) <= 1e-4, key
    for key in ("1.0m_acc", "2.5m_acc", "7.5m_acc", "3interval_acc"):
        assert abs(dp[1][key] - serial[1][key]) <= 1 / 2048, key
