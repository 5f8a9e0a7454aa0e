"""The port's spatial and depth mesh axes (satmvs_tpu_torch/dist/, the
sharded cost volumes of models/cascade.py) on the CPU over gloo, against
JAX's serial model and the port's serial step.

Ranks are `tests/_torch_dist_ranks.py` subprocesses: one world of two and
one of four, started once each for the module beside the references this
process computes (JAX's serial loss and eval-mode gradients, the port's
serial steps and eval steps); each world lays out several meshes in turn.
What they hold, after JAX's own tests/test_dist.py:

  - a halo exchange through each kind of 3-D conv (stride 1, stride 2,
    transposed) of a slab against the whole conv, values and gradients, on
    either axis; the slab gather and the group max;
  - depth-slab sharding of CasMVS and UCS on 2 and 4 ranks and height
    sharding of CasMVS and RED on 2: the loss (rtol 2e-4) and eval-mode
    gradients (atol 5e-4 of the largest, rtol 5e-3) against JAX's serial
    model from the same numpy-seeded flax weights, ndepths (32, 8, 8) for
    the CostRegNet families (stage 1 shards D on 2 and 4 ranks, rows shard
    at stages 2 and 3 of a 32-row image) and (8, 8, 8) for RED, 32×32,
    B = 2;
  - train-mode steps under data 2 × depth 2 (CasMVS, ndepths (16, 8, 8),
    32×32, lr 1e-4) and data 2 × spatial 2 (RED, 32×64, lr 1e-3) against
    the port's serial B = 2 step at tests/test_torch_dist.py's gates.  The
    serial step moves by itself when only its batch's order changes
    (`_torch_dist_ranks.reorder_spread`): RMSprop's first update,
    ~lr·√10·sign(g), turns the rounding of another summation order into
    whole steps.  At lr 1e-3 the CasMVS second step's loss moves 9.1e-5 to
    1.5e-3 relative over five configurations of these sizes (seeds 0 and
    1, 32×32 and 32×64, ndepths (16, 8, 8) and (32, 8, 8)), the order of
    its 3e-4 gate (the ranks read 2.98e-4, their depth loss 3.50e-4); at
    1e-4, 8.4e-8 to 2.9e-5, so this check runs there.  RED's moves 1.2e-5
    at 1e-3;
  - the eval step, the packed CostRegNet on slabs and the fused sweep on a
    band or slab, against the serial eval step;
  - `fit` under Config(mesh_depth=2), and its refusals in JAX's words.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from satmvs_tpu_torch.dist import slab_bounds
from satmvs_tpu_torch.train import Config, fit

import _torch_dist_ranks as ranks

ROOT = Path(__file__).resolve().parents[1]
WORLDS = {2: ["ops_depth", "ops_spatial", "casmvs_d2", "ucs_d2", "casmvs_s2", "red_s2",
              "eval_casmvs_d2", "eval_ucs_d2", "eval_casmvs_s2", "eval_red_s2", "fit_shard"],
          4: ["casmvs_d4", "ucs_d4", "casmvs_dp2_d2", "red_dp2_s2"]}
STEP_GATES = {"red": {"loss": 2e-4, "stats": 1e-5}, "casmvs": {"loss": 3e-4, "stats": 1e-4}}
RANK_TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the ranks run (tests/test_torch_dist.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _launch(world: int, jobs: list, out: Path) -> list:
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = []
    for r in range(world):
        with open(out / f"log{r}", "w") as log:
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
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def _jax_model(model: str):
    from satmvs_tpu.data import synthetic as jsyn
    from satmvs_tpu.models import build_model as jbuild
    from satmvs_tpu.train.loop import numeric_batch

    h, w = ranks.SHARD_HW
    jb = numeric_batch(jsyn.make_batch(ranks.GLOBAL_B, w, h, seed=0))
    kw = {"fused_red": False} if model == "red" else {}
    return jbuild(model, "rpc", ndepths=ranks.SHARD_NDEPTHS[model], **kw), jb


def _jax_variables(model: str) -> dict:
    """Numpy-seeded flax weights in the shapes of `jax.eval_shape(init)`."""
    from test_torch_train import seeded

    jm, jb = _jax_model(model)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False), jax.random.PRNGKey(0),
                            jb["imgs"], jb["cams"], jb["depth_values"])
    return seeded(shapes, 6)


def _jax_loss_and_grads(model: str, variables: dict):
    """JAX's serial eval-mode loss and gradients, the gradients as the port
    names its parameters."""
    from satmvs_tpu.models import cascade_loss as jcascade_loss
    from satmvs_tpu_torch.train.loop import create_model

    jm, jb = _jax_model(model)

    def loss_fn(params, batch):
        out = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                       batch["imgs"], batch["cams"], batch["depth_values"], train=False)
        return jcascade_loss(out, batch["depth_stages"], batch["mask_stages"])[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"], jb)
    named = create_model(ranks.config(model, ranks.SHARD_NDEPTHS[model]), "cpu", {
        "params": jax.tree.map(np.asarray, grads), "batch_stats": variables["batch_stats"]})
    return float(loss), {k: p.detach() for k, p in named.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [rank results]}, the references, the ranks' folder."""
    base = tmp_path_factory.mktemp("shard")
    variables = {m: _jax_variables(m) for m in ("casmvs", "ucs", "red")}
    procs = {}
    for world, jobs in WORLDS.items():
        out = base / f"world{world}"
        out.mkdir()
        for m, v in variables.items():
            torch.save(v, out / f"vars_{m}.pt")
        procs[world] = _launch(world, jobs, out)
    try:
        refs = {"jax": {m: _jax_loss_and_grads(m, v) for m, v in variables.items()},
                "steps": {job: ranks.steps_run(job, serial=True) for job in ranks.SHARD_STEPS},
                "eval": {m: ranks.shard_eval_run(m) for m in ("casmvs", "ucs", "red")}}
    finally:
        got = {w: _collect(p, base / f"world{w}") for w, p in procs.items()}
    return got, refs, base


def _job(got: dict, job: str) -> list:
    """Every rank's result of `job`."""
    world = next(w for w, jobs in WORLDS.items() if job in jobs)
    return [rank[job] for rank in got[world]]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _assert_grads_close(got: dict, want: dict):
    """JAX's gate for sharded against serial gradients (tests/test_dist.py)."""
    scale = max(g.abs().max().item() for g in want.values())
    assert got.keys() == want.keys()
    for k, g in want.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), atol=5e-4 * scale, rtol=5e-3,
                                   err_msg=k)


# ---- the exchanges


@pytest.mark.parametrize("kind", ["s1", "s2", "up"])
@pytest.mark.parametrize("axis", ["depth", "spatial"])
def test_sharded_conv3d_matches_whole(runs, axis, kind):
    """A Conv3d of stride 1, a Conv3d of stride 2 and a ConvTranspose3d of
    stride 2 on each rank's half of a (2, 3, 16, 16, 8) volume along D or H,
    its halos exchanged: the output slab, the slab's gradient (its halos'
    cotangents sent back to their owners) and the weight gradient summed
    over the ranks against the whole conv (1e-5, of the largest weight
    gradient for the weights)."""
    got, _, _ = runs
    x, cots, _, blocks = ranks.ops_inputs()
    xw = x.clone().requires_grad_(True)
    y = blocks[kind](xw)
    gx, gw, gb = torch.autograd.grad((y * cots[kind]).sum(),
                                     [xw, blocks[kind].weight, blocks[kind].bias])
    dim = 2 if axis == "depth" else 3
    per_rank = _job(got, f"ops_{axis}")
    bounds = slab_bounds(ranks.OPS_SHAPE[dim], 2)
    for (lo, hi), rank in zip(bounds, per_rank):
        out = rank[kind]
        n = out["y"].shape[dim]
        np.testing.assert_allclose(out["y"].numpy(), y.detach().narrow(dim, out["lo"], n).numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(out["gx"].numpy(), gx.narrow(dim, lo, hi - lo).numpy(),
                                   atol=1e-5)
    assert sum(r[kind]["y"].shape[dim] for r in per_rank) == y.shape[dim]
    for name, want in (("gw", gw), ("gb", gb)):  # sums of ~10⁴ products: 1e-5 of the largest
        np.testing.assert_allclose(sum(r[kind][name] for r in per_rank).numpy(), want.numpy(),
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("axis", ["depth", "spatial"])
def test_slab_gather_and_group_max(runs, axis):
    """slab_gather gives every rank the whole volume, and the gradient of
    Σ gathered·(rank r's cotangent) in a rank's slab is the ranks' summed
    cotangent at its bounds; group_max is the elementwise largest."""
    got, _, _ = runs
    x, _, gathers, _ = ranks.ops_inputs()
    dim = 2 if axis == "depth" else 3
    for rank in _job(got, f"ops_{axis}"):
        out = rank["gather"]
        assert torch.equal(out["full"], x)
        n = out["gx"].shape[dim]
        np.testing.assert_allclose(out["gx"].numpy(),
                                   (gathers[0] + gathers[1]).narrow(dim, out["lo"], n).numpy(),
                                   atol=1e-6)
        assert torch.equal(rank["max"], torch.maximum(gathers[0], gathers[1]))


def test_slab_bounds():
    """Slabs at multiples of 8 that cover the extent in order, as even as
    those allow; an extent of fewer units than ranks raises."""
    assert slab_bounds(64, 2) == ((0, 32), (32, 64))
    assert slab_bounds(32, 4) == ((0, 8), (8, 16), (16, 24), (24, 32))
    assert slab_bounds(40, 4) == ((0, 8), (8, 16), (16, 24), (24, 40))
    assert slab_bounds(96, 8)[-1] == (80, 96)
    with pytest.raises(ValueError, match="does not cut into 4 slabs"):
        slab_bounds(24, 4)


# ---- against JAX's serial model


@pytest.mark.parametrize("job", ["casmvs_d2", "ucs_d2", "casmvs_d4", "ucs_d4"])
def test_depth_sharded_matches_jax(runs, job):
    """Depth-slab sharding (tests/test_dist.py::
    test_depth_axis_sharded_volume_matches_serial and
    ::test_depth_axis_sharded_train_grads): stage 1 (32 planes) is cut into
    slabs on every rank, stages 2 and 3 (8 planes, below the guard) run
    whole; the loss (2e-4) and the eval-mode gradients summed over the
    ranks (JAX's gate) against JAX's serial model; every rank holds the
    same."""
    got, refs, _ = runs
    model, shape = ranks.SHARD_GRADS[job]
    jloss, jgrads = refs["jax"][model]
    per_rank = _job(got, job)
    r0 = per_rank[0]
    assert [spec[1] for spec in r0["partition"]] == ["depth", None, None]
    assert r0["exchanges"]["halo"] > 0
    print(f"[shard] {job}: loss {r0['loss']:.6f}, JAX {jloss:.6f}, "
          f"{_rel(r0['loss'], jloss):.2e} relative; exchanges {r0['exchanges']}")
    assert _rel(r0["loss"], jloss) <= 2e-4
    _assert_grads_close(r0["grads"], jgrads)
    for rank in per_rank[1:]:
        assert rank["loss"] == r0["loss"]
        assert all(torch.equal(rank["grads"][k], g) for k, g in r0["grads"].items())


@pytest.mark.parametrize("job", ["casmvs_s2", "red_s2"])
def test_spatial_sharded_matches_jax(runs, job):
    """Height sharding (tests/test_dist.py::
    test_sharded_loss_matches_single_device): stages 2 and 3 (16 and 32
    rows) cut into bands, stage 1 (8 rows, below the guard) whole; RED
    gathers each band's volume before its pipeline; the loss (2e-4) and the
    eval-mode gradients (JAX's gate) against JAX's serial model."""
    got, refs, _ = runs
    model, _ = ranks.SHARD_GRADS[job]
    jloss, jgrads = refs["jax"][model]
    r0, r1 = _job(got, job)
    assert [spec[2] for spec in r0["partition"]] == [None, "spatial", "spatial"]
    assert r0["exchanges"]["gather"] > 0
    assert (r0["exchanges"]["halo"] > 0) == (model != "red")
    print(f"[shard] {job}: loss {r0['loss']:.6f}, JAX {jloss:.6f}, "
          f"{_rel(r0['loss'], jloss):.2e} relative; exchanges {r0['exchanges']}")
    assert _rel(r0["loss"], jloss) <= 2e-4
    _assert_grads_close(r0["grads"], jgrads)
    assert r1["loss"] == r0["loss"]


@pytest.mark.slow
def test_jax_mesh_data2_depth4_matches_jax(tmp_path):
    """JAX's own configuration of tests/test_dist.py::
    test_depth_axis_sharded_train_grads: data 2 × depth 4, eight ranks
    (each holds one sample and a slab of 8 of stage 1's 32 planes), the
    loss (2e-4) and eval-mode gradients (JAX's gate) against JAX's serial
    model; test_depth_sharded_matches_jax holds the same check on four."""
    variables = _jax_variables("casmvs")
    torch.save(variables, tmp_path / "vars_casmvs.pt")
    procs = _launch(8, ["casmvs_dp2_d4"], tmp_path)
    try:
        jloss, jgrads = _jax_loss_and_grads("casmvs", variables)
    finally:
        got = _collect(procs, tmp_path)
    r0 = got[0]["casmvs_dp2_d4"]
    assert [spec[1] for spec in r0["partition"]] == ["depth", None, None]
    assert _rel(r0["loss"], jloss) <= 2e-4
    _assert_grads_close(r0["grads"], jgrads)


# ---- against the port's serial step


@pytest.mark.parametrize("job", ["casmvs_dp2_d2", "red_dp2_s2"])
def test_train_mode_steps_match_serial(runs, job):
    """Two train steps under data 2 × depth 2 (CasMVS) and data 2 ×
    spatial 2 (RED) against the serial step at B = 2 from the same weights:
    the first step's scalars to 2e-4, the second's to the model's gate,
    the running statistics after the first step to the model's gate of each
    tensor's largest value (the module docstring's spreads), the eval-mode
    gradients at JAX's gate; the four replicas the same bits."""
    got, refs, _ = runs
    model = ranks.SHARD_STEPS[job][0]
    gate = STEP_GATES[model]
    per_rank = _job(got, job)
    r0, want = per_rank[0], refs["steps"][job]
    for k, (g, w) in enumerate(zip(r0["scalars"], want["scalars"])):
        for key in ("loss", "depth_loss", "abs_depth_error"):
            rel = _rel(g[key], w[key])
            print(f"[shard] {job} step {k + 1} {key}: {rel:.2e} relative")
            assert rel <= (2e-4 if k == 0 else gate["loss"]), (k, key, rel)
    worst = max(((r0["stats_1"][n] - s).abs().max() / s.abs().max()).item()
                for n, s in want["stats_1"].items())
    print(f"[shard] {job} running statistics after a step: {worst:.2e} (tol {gate['stats']})")
    assert worst <= gate["stats"]
    assert _rel(r0["eval_loss"], want["eval_loss"]) <= 2e-4
    _assert_grads_close(r0["eval_grads"], want["eval_grads"])
    for rank in per_rank[1:]:
        for group in ("params", "stats"):
            assert all(torch.equal(rank[group][k], v) for k, v in r0[group].items()), group
        assert rank["scalars"] == r0["scalars"]


@pytest.mark.parametrize("job", ["eval_casmvs_d2", "eval_ucs_d2", "eval_casmvs_s2",
                                 "eval_red_s2"])
def test_sharded_eval_step_matches_serial(runs, job):
    """The eval step under a depth or spatial mesh of two ranks (no
    gradient: the fused sweep on a slab or band, the packed CostRegNet on
    slabs with halos, RED after the gather) against the serial eval step:
    the loss and metrics (1e-5 relative) and the maps (depth 1e-3 m,
    confidence 1e-4) on every rank."""
    got, refs, _ = runs
    model = ranks.SHARD_EVALS[job][0]
    want = refs["eval"][model]
    for rank in _job(got, job):
        for key, w in want["scalars"].items():
            assert abs(rank["scalars"][key] - w) <= 1e-5 * max(abs(w), 1.0), key
        np.testing.assert_allclose(rank["depth"].numpy(), want["depth"].numpy(), rtol=1e-5,
                                   atol=1e-3)
        np.testing.assert_allclose(rank["conf"].numpy(), want["conf"].numpy(), atol=1e-4)


# ---- fit


def test_fit_trains_depth_sharded(runs):
    """fit with Config(model="casmvs", mesh_depth=2) on two ranks: stage 1
    sharded over depth, one epoch of two batches; the replicas end the same
    bits; only rank 0 logs, writes the record and the checkpoint."""
    got, _, base = runs
    r0, r1 = _job(got, "fit_shard")
    assert [spec[1] for spec in r0["partition"]] == ["depth", None, None]
    for group in ("params", "stats"):
        assert all(torch.equal(r0[group][k], r1[group][k]) for k in r0[group])
    assert r0["steps"] == r1["steps"] == [2]
    assert r0["logs"] and not r1["logs"]
    workdir = base / "world2" / "fit_shard"
    assert len((workdir / "train_record.txt").read_text().splitlines()) == 1
    assert (workdir / "1" / "state.pt").is_file()


@pytest.mark.parametrize("kw,words", [
    ({"model": "red", "mesh_depth": 2},
     "depth-slab sharding \\(--mesh_depth\\) applies to the 3-D conv regularizers"),
    ({"model": "casmvs", "mesh_depth": 2, "mesh_spatial": 2},
     "combined depth\\+spatial sharding of the same cost volume")])
def test_fit_refuses_what_jax_refuses(tmp_path, kw, words):
    """RED with depth > 1, and depth with spatial together, refused by fit
    before any rank is needed, in JAX's words
    (satmvs_tpu/train/loop.py:212-225)."""
    from satmvs_tpu_torch.data import synthetic

    batch = synthetic.make_batch(1, 32, 64, seed=0, device="cpu")
    with pytest.raises(ValueError, match=words):
        fit(Config(ndepths=(32, 8, 8), **kw), [batch], [batch], str(tmp_path), log_fn=None)
