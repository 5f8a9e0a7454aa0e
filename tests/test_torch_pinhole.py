"""The pinhole camera model (`geo_model="pinhole"`) of the port against the
JAX package on the CPU: the DLT tooling of `geo/pinhole.py` on host numpy;
`ops.warp.homo_sweep_coords` on toy and on fitted cameras (and a float64
oracle); the stage volumes of both sweeps and their feature gradient
against JAX `build_stage_volume("pinhole", ...)` and `jax.vjp`; the pinhole
`MVSDataset`, `gen_list` and collate; CascadeREDNet against JAX
`model.apply` (jitted) and streaming against full volume; one train step
against JAX `make_train_step` (`slow`); the three builders; fusion against
JAX `filter_depth_pinhole`; and `cli.train` / `cli.predict --geo_model
pinhole`.  Trees come from `chip_smoke.write_pinhole_tree` (the port's
writers), fitted cameras from `chip_smoke.pinhole_batch`; every tolerance
is stated in its test."""

import importlib.util
import math
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satmvs_tpu import native
from satmvs_tpu_torch import native as tnative
from satmvs_tpu.data import dataset as jds
from satmvs_tpu.data import samples as jsamples
from satmvs_tpu.geo import pinhole as jpin
from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.infer import fuse as jfuse
from satmvs_tpu.models import CascadeREDNet as JNet
from satmvs_tpu.models.cascade import build_stage_volume as jbuild_stage_volume
from satmvs_tpu.ops import warp as jwarp
from satmvs_tpu_torch.cli import predict as cli_predict
from satmvs_tpu_torch.cli import train as cli_train
from satmvs_tpu_torch.data import dataset as tds
from satmvs_tpu_torch.data import formats
from satmvs_tpu_torch.data import loader as tld
from satmvs_tpu_torch.data import samples as tsamples
from satmvs_tpu_torch.geo import pinhole as tpin
from satmvs_tpu_torch.infer import fuse as tfuse
from satmvs_tpu_torch.infer.predict import streaming_red_forward
from satmvs_tpu_torch.models import CascadeREDNet, build_model
from satmvs_tpu_torch.models.cascade import build_stage_volume, build_train_volume
from satmvs_tpu_torch.ops import warp as twarp
from satmvs_tpu_torch.params import load_jax_variables

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

T = torch.from_numpy
H, W = 32, 64
NDEPTHS = (8, 4, 4)
INTERVALS = (10.0, 5.0, 2.5)  # depth_intervals_ratio (4, 2, 1) × min_interval 2.5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small ops, run beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _jax_numpy_center_image(monkeypatch):
    """Both packages' datasets normalize images on their numpy paths
    (see tests/test_torch_data.py)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _toy_projs(w=W, h=H):
    """The cameras of tests/test_models.py: K (f = 100, centred) · [I | t],
    baselines 0, 2 and −2 m; (V, 4, 4) float64."""
    k = np.array([[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1]])
    projs = []
    for tx in (0.0, 2.0, -2.0):
        e = np.eye(4)
        e[0, 3] = tx
        projs.append(jpin.compose_proj_matrix(k, e))
    return np.stack(projs)


def _report(name, err, tol):
    print(f"[parity] {name}: {err:.3e} (tol {tol})")
    assert err <= tol, f"{name}: {err} > {tol}"


# ---------------------------------------------------------------------------
# geometry tooling, host numpy
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fit_inputs():
    rpc = jsyn.make_synthetic_rpc(128, 128, off_nadir_deg=22.0, seed=8)
    k, r, t, _, _ = jpin.fit_pinhole_from_rpc(rpc, 128, 128)
    rng = np.random.default_rng(3)
    pts = rng.uniform([-400, -400, 0], [400, 400, 300], (200, 3))
    proj = (k @ np.hstack([r, t]) @ np.hstack([pts, np.ones((200, 1))]).T).T
    return {"rpc": rpc, "k": k, "r": r, "t": t, "pts": pts,
            "col": proj[:, 0] / proj[:, 2], "row": proj[:, 1] / proj[:, 2]}


def _close(got, want, rtol=1e-10):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w, rtol)
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", ["factorize", "solve_perspective", "check_perspective_error",
                                  "remap_skew", "fit_pinhole_from_rpc", "compose_proj_matrix",
                                  "scale_proj_matrix"])
def test_pinhole_tooling_matches_jax(fit_inputs, name):
    """Each function of geo/pinhole.py on the same float64 inputs: JAX's
    values to 1e-10 relative (of the largest magnitude of each output)."""
    f = fit_inputs
    xx, yy, zz = f["pts"].T
    args = {
        "factorize": (f["k"] @ np.hstack([f["r"], f["t"]]) * -3.0,),
        "solve_perspective": (xx, yy, zz, f["col"], f["row"]),
        "check_perspective_error": (xx, yy, zz, f["col"] + 0.3, f["row"] - 0.2, f["k"], f["r"],
                                    f["t"]),
        "remap_skew": (np.random.default_rng(0).uniform(0, 255, (40, 48, 3)).astype(np.float32),
                       np.array([[500.0, 25.0, 24.0], [0.0, 480.0, 20.0], [0.0, 0.0, 1.0]])),
        "fit_pinhole_from_rpc": (f["rpc"], 128, 128),
        "compose_proj_matrix": (f["k"], np.vstack([np.hstack([f["r"], f["t"]]), [0, 0, 0, 1]])),
        "scale_proj_matrix": (np.stack([_toy_projs(), _toy_projs(48, 40)]), 0.25),
    }[name]
    got, want = getattr(tpin, name)(*args), getattr(jpin, name)(*args)
    _close(got, want)


def test_local_frame_composition_matches_the_jax_dataset():
    """local_proj_matrices: the K·E the JAX dataset composes around the mean
    camera centre (satmvs_tpu/data/dataset.py), bit for bit."""
    rng = np.random.default_rng(5)
    ks = np.stack([np.array([[f, s, 30.0], [0, f * 1.1, 20.0], [0, 0, 1]])
                   for f, s in rng.uniform([90, -5], [110, 5], (3, 2))])
    es = []
    for _ in range(3):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        e = np.eye(4)
        e[:3, :3], e[:3, 3] = q * np.sign(np.linalg.det(q)), rng.normal(size=3) * 1e5
        es.append(e)
    es = np.stack(es)
    centers = np.stack([-e[:3, :3].T @ e[:3, 3] for e in es])
    want = []
    for e, k in zip(es, ks):
        e_local = e.copy()
        e_local[:3, 3] = e[:3, 3] + e[:3, :3] @ centers.mean(axis=0)
        want.append(jpin.compose_proj_matrix(k, e_local))
    np.testing.assert_array_equal(tpin.local_proj_matrices(ks, es), np.stack(want))


# ---------------------------------------------------------------------------
# coordinates
# ---------------------------------------------------------------------------
_jhomo = jax.jit(jwarp.homo_sweep_coords, static_argnums=(3, 4))


def test_homo_coordinates_match_jax_on_toy_cameras():
    """homo_sweep_coords on the toy cameras at the three stage scales, per-
    pixel depths over 30-60 m: within 1e-3 px of JAX's."""
    projs = _toy_projs()
    rng = np.random.default_rng(2)
    for scale in (0.25, 0.5, 1.0):
        p = tpin.scale_proj_matrix(projs, scale).astype(np.float32)
        h, w = int(H * scale), int(W * scale)
        hyps = rng.uniform(30, 60, (4, h, w)).astype(np.float32)
        for s in (1, 2):
            gx, gy = twarp.homo_sweep_coords(T(p[s]), T(p[0]), T(hyps), h, w)
            jx, jy = _jhomo(jnp.asarray(p[s]), jnp.asarray(p[0]), jnp.asarray(hyps), h, w)
            err = max(np.abs(gx.numpy() - np.asarray(jx)).max(),
                      np.abs(gy.numpy() - np.asarray(jy)).max())
            _report(f"toy pinhole coordinates scale {scale} view {s}", err, 1e-3)


def test_homo_coordinates_on_fitted_cameras():
    """homo_sweep_coords on pinhole cameras fitted to a 96×192 synthetic
    triplet (skewed K, condition ~1e14, scene at camera z ~ −1.4e5 m), over
    the depth range at each stage: within 0.05 px of JAX's and of a float64
    oracle on the same float32 inputs (the fp32 chain's own error)."""
    batch, _ = chip_smoke.pinhole_batch(192, 96, seed=0, device="cpu", with_gt=False)
    lo, hi = batch["depth_values"][0].tolist()
    for i, (sc, nd) in enumerate(zip((4, 2, 1), (8, 4, 4))):
        h, w = 96 // sc, 192 // sc
        projs = batch["cams"][i][0]
        hyps = chip_smoke.uniform_hyps(lo, hi, nd, h, w, "cpu")
        for s in (1, 2):
            gx, gy = twarp.homo_sweep_coords(projs[s], projs[0], hyps, h, w)
            jx, jy = _jhomo(jnp.asarray(projs[s].numpy()), jnp.asarray(projs[0].numpy()),
                            jnp.asarray(hyps.numpy()), h, w)
            ox, oy = chip_smoke.pinhole_oracle(projs[s], projs[0], hyps)
            gx, gy = gx.double().numpy(), gy.double().numpy()
            vs_jax = max(np.abs(gx - np.asarray(jx)).max(), np.abs(gy - np.asarray(jy)).max())
            vs_oracle = max(np.abs(gx - ox).max(), np.abs(gy - oy).max())
            _report(f"fitted pinhole coordinates stage{i + 1} view {s} vs JAX", vs_jax, 0.05)
            _report(f"fitted pinhole coordinates stage{i + 1} view {s} vs float64", vs_oracle,
                    0.05)


# ---------------------------------------------------------------------------
# stage volumes
# ---------------------------------------------------------------------------
def _volume_inputs(h=16, w=24, d=4, c=8, seed=3):
    rng = np.random.default_rng(seed)
    projs = tpin.scale_proj_matrix(_toy_projs(), 0.5).astype(np.float32)[None]
    feats = rng.normal(size=(1, 3, h, w, c)).astype(np.float32)
    hyps = rng.uniform(30, 60, (1, d, h, w)).astype(np.float32)
    return feats, hyps, projs


def test_pinhole_stage_volumes_and_gradient_match_jax():
    """Both sweeps' volumes on pinhole cameras (the fused `sweep_variance`
    and the per-view `sweep_gather` pair, their plain versions here; JAX
    sends pinhole to its per-view path) against JAX
    `build_stage_volume("pinhole", ...)`, and the feature gradient of each
    for a seeded cotangent against jax.vjp: 1e-5 of each one's largest
    magnitude."""
    feats, hyps, projs = _volume_inputs()
    want, vjp = jax.vjp(jax.jit(lambda f: jbuild_stage_volume("pinhole", f, jnp.asarray(projs),
                                                              jnp.asarray(hyps))),
                        jnp.asarray(feats))
    g = np.random.default_rng(9).normal(size=want.shape).astype(np.float32)
    (dwant,) = vjp(jnp.asarray(g))
    want, dwant = np.asarray(want), np.asarray(dwant)
    tol, dtol = 1e-5 * np.abs(want).max(), 1e-5 * np.abs(dwant).max()
    for name, build in (("fused", build_stage_volume), ("per-view", build_train_volume)):
        f = T(feats).requires_grad_(True)
        got = build(f, T(projs), T(hyps))
        (dgot,) = torch.autograd.grad(got, f, T(g))
        assert got.shape == want.shape
        _report(f"pinhole {name} stage volume", np.abs(got.detach().numpy() - want).max(), tol)
        _report(f"pinhole {name} feature gradient", np.abs(dgot.numpy() - dwant).max(), dtol)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place of each value (x's values are bf16)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8).astype(np.float32)


def test_pinhole_bf16_volumes_match_jax():
    """With bf16 volume transport: each warped view (`homo_warp`, out_dtype
    bfloat16) within one bf16 ulp of JAX `homo_warp(..., out_dtype=bfloat16)`
    plus 1e-5; the per-view stage volume against JAX's bf16
    `build_stage_volume` within 1e-5 plus, per element, what one-ulp
    differences of its views can move the variance: (2/V)·Σ ulp(w)·|w − mean|."""
    feats, hyps, projs = _volume_inputs(seed=4)
    views = [feats[0, 0]]
    for s in (1, 2):
        got = twarp.homo_warp(T(feats[0, s]), T(projs[0, s]), T(projs[0, 0]), T(hyps[0]),
                              out_dtype=torch.bfloat16)
        want = jax.jit(lambda *a: jwarp.homo_warp(*a, method="xla", out_dtype=jnp.bfloat16))(
            jnp.asarray(feats[0, s]), jnp.asarray(projs[0, s]), jnp.asarray(projs[0, 0]),
            jnp.asarray(hyps[0]))
        w32 = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - w32)
        print(f"[parity] pinhole bf16 warp view {s}: {(err > 0).mean():.2e} of the values apart")
        assert got.dtype == torch.bfloat16 and bool((err <= _bf16_ulp(w32) + 1e-5).all())
        views.append(w32)
    want = np.asarray(jax.jit(lambda *a: jbuild_stage_volume("pinhole", *a,
                                                             volume_dtype=jnp.bfloat16))(
        jnp.asarray(feats), jnp.asarray(projs), jnp.asarray(hyps)))
    mean = (views[0][None] + views[1] + views[2]) / 3
    bound = sum(_bf16_ulp(v) * np.abs(v - mean) for v in views[1:]) * 2 / 3
    got = build_train_volume(T(feats), T(projs), T(hyps), torch.bfloat16).numpy()
    err = np.abs(got - want)
    print(f"[parity] pinhole bf16 stage volume: {err.max():.2e}, beyond the bound "
          f"{(err - bound[None]).max():.2e} (tol 1e-5)")
    assert bool((err <= bound[None] + 1e-5).all())


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pin_tree(tmp_path_factory):
    """Pinhole trees written by the port's writers: 32×64 (one train and one
    test block) and 40×72 (cropped to 32×64, the principal point shifted)."""
    tmp = tmp_path_factory.mktemp("pinhole")
    even = chip_smoke.write_pinhole_tree(str(tmp / "even"), 1, 1, width=W, height=H, seed=0)
    odd = chip_smoke.write_pinhole_tree(str(tmp / "odd"), 1, 1, width=72, height=40, seed=5)
    split = lambda root, s: os.path.join(root, "open_dataset_pinhole", s)  # noqa: E731
    return {"root": even, "train": split(even, "train"), "test": split(even, "test"),
            "odd": split(odd, "test")}


def test_pinhole_sample_lists_match_jax(pin_tree):
    for ref_view in (2, 0, -1):
        got = tsamples.gen_list(pin_tree["test"], 3, ref_view, "pinhole")
        assert got == jsamples.gen_list(pin_tree["test"], 3, ref_view, "pinhole")
    assert got[0][1].endswith("camera/0/block0000.txt") and got[0][-1].endswith(
        "depth/0/block0000.pfm")
    with pytest.raises(ValueError, match="geo_model"):
        tsamples.gen_list(pin_tree["test"], 3, 2, "affine")


@pytest.mark.parametrize("mode", ["train", "test", "pred"])
def test_pinhole_dataset_matches_jax(pin_tree, mode):
    """MVSDataset(geo_model="pinhole") against JAX's on the 40×72 tree
    (every view cropped to 32×64 around its centre, the principal point
    shifted by the crop), in each mode: images bit for bit (train mode's
    jitter from the same seed), the float32 projection matrices of every
    stage (both compose them in float64 and round once) and the depth range
    exactly, the GT pyramids and masks exactly; then the collate of two
    samples and its move."""
    tset = tds.MVSDataset(pin_tree["odd"], mode, 3, 2, geo_model="pinhole", seed=7)
    jset = jds.MVSDataset(pin_tree["odd"], mode, 3, 2, geo_model="pinhole", seed=7)
    assert len(tset) == len(jset) == (3 if mode == "pred" else 1)
    for i in range(len(tset)):
        got, want = tset[i], jset[i]
        assert got["imgs"].shape == (3, H, W, 3)
        np.testing.assert_array_equal(got["imgs"], want["imgs"])
        np.testing.assert_array_equal(got["depth_values"], want["depth_values"])
        assert (got["out_view"], got["out_name"]) == (want["out_view"], want["out_name"])
        for gc, wc in zip(got["cams"], want["cams"]):
            assert gc.dtype == torch.float32 and gc.shape == (3, 4, 4)
            np.testing.assert_array_equal(gc.numpy(), wc)
        for key in ("depth_stages", "mask_stages"):
            for g, w in zip(got.get(key, []), want.get(key, [])):
                np.testing.assert_array_equal(g, w)
    cam = formats.load_camera_nn(os.path.join(pin_tree["odd"], "camera", "2", "block0000.txt"))
    assert cam[1, 0, 2] == 36.0 and cam[1, 1, 2] == 20.0  # the crop starts at (4, 4)
    batch = tld.to_device(tld.collate([tset[0], tset[0]]), "cpu")
    assert [c.shape for c in batch["cams"]] == [(2, 3, 4, 4)] * 3
    assert torch.equal(batch["cams"][2][1], T(np.asarray(jset[0]["cams"][2])))


def test_camera_text_round_trip_matches_jax(tmp_path):
    """save_camera writes JAX's bytes; load_camera / load_camera_nn read
    JAX's values."""
    from satmvs_tpu.data import formats as jfmt

    k = np.array([[1200.5, 0.0, 384.25], [0.0, 1200.5, 191.75], [0.0, 0.0, 1.0]])
    r, t = np.linalg.qr(np.random.default_rng(1).normal(size=(3, 3)))[0], np.array([1.5, -2, 3])
    args = (k, r, t, 30.0, 60.0, 0.5, 2, 768, 384)
    formats.save_camera(str(tmp_path / "t.txt"), *args)
    jfmt.save_camera(str(tmp_path / "j.txt"), *args)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    for got, want in zip(formats.load_camera(str(tmp_path / "j.txt")),
                         jfmt.load_camera(str(tmp_path / "j.txt"))):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(formats.load_camera_nn(str(tmp_path / "j.txt")),
                                  jfmt.load_camera_nn(str(tmp_path / "j.txt")))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _numpy_tree(shapes, seed):
    """Numpy values for a tree of shapes: kernels N(0, 1/fan_in), scales
    1 + 0.2·N, variances U(0.5, 1.5), biases and means 0.1·N."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0.0, 1.0 / math.sqrt(np.prod(s.shape[:-1])), s.shape)
        if name == "scale":
            return 1.0 + 0.2 * rng.normal(size=s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.normal(size=s.shape)

    return jax.tree_util.tree_map_with_path(lambda p, s: np.asarray(draw(p, s), np.float32),
                                            shapes)


@pytest.fixture(scope="module")
def model_runs(pin_tree):
    """CascadeREDNet (pinhole, ndepths (8, 4, 4), fused_red=False in JAX) on
    the 32×64 test block: JAX `apply` jitted, weights a numpy-seeded tree in
    the shapes of `jax.eval_shape(init)`, the logit heads ×40; the port
    with the same tree (`load_jax_variables`) on the port's sample."""
    jsample = jds.MVSDataset(pin_tree["test"], "test", geo_model="pinhole")[0]
    args = (jnp.asarray(jsample["imgs"][None]), tuple(jnp.asarray(c[None]) for c in jsample["cams"]),
            jnp.asarray(jsample["depth_values"][None]))
    jm = JNet(geo_model="pinhole", ndepths=NDEPTHS, fused_red=False)
    v = _numpy_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args), 21)
    for i in range(3):
        head = v["params"][f"REDRegularizer_{i}"]["ScanREDStep_0"]["Conv_0"]
        head["kernel"], head["bias"] = head["kernel"] * 40.0, head["bias"] * 40.0
    want = jax.tree.map(np.asarray, jax.jit(lambda vv, *a: jm.apply(vv, *a, train=False))(v, *args))
    tb = tld.collate([tds.MVSDataset(pin_tree["test"], "test", geo_model="pinhole")[0]])
    tm = load_jax_variables(CascadeREDNet(geo_model="pinhole", ndepths=NDEPTHS, device="cpu"), v)
    got = tm(tb["imgs"], tb["cams"], tb["depth_values"])
    return {"want": want, "got": got, "model": tm, "batch": tb, "v": v}


def test_pinhole_model_matches_jax(model_runs):
    """Per-stage depth within 1 % of the stage's hypothesis step (the range
    / (D − 1) at stage 1, D·interval / (D − 1) in the windows) and the
    max-prob confidence within 2e-3."""
    want, got = model_runs["want"], model_runs["got"]
    lo, hi = model_runs["batch"]["depth_values"][0].tolist()
    steps = [(hi - lo) / (NDEPTHS[0] - 1)]
    steps += [nd * iv / (nd - 1) for nd, iv in zip(NDEPTHS[1:], INTERVALS[1:])]
    for i, step in enumerate(steps, start=1):
        g, w = got[f"stage{i}"]["depth"].numpy(), want[f"stage{i}"]["depth"]
        assert g.shape == w.shape
        _report(f"pinhole model stage{i} depth, of step", np.abs(g - w).max() / step, 0.01)
        _report(f"pinhole model stage{i} confidence",
                np.abs(got[f"stage{i}"]["photometric_confidence"].numpy()
                       - want[f"stage{i}"]["photometric_confidence"]).max(), 2e-3)
    assert want["stage3"]["photometric_confidence"].max() > 0.5


def test_pinhole_streaming_matches_full_volume(model_runs):
    """streaming_red_forward (slab 2, the same kernels' plain versions) on
    pinhole cameras against the full-volume forward, stage by stage (each
    full-volume stage centred on the streaming run's previous depth): depth
    within 1e-4 of the stage's step, confidence within 1e-5."""
    m, b = model_runs["model"], model_runs["batch"]
    out = streaming_red_forward(m, b["imgs"], b["cams"], b["depth_values"], slab=2)
    feats = m.features(b["imgs"])
    lo, hi = b["depth_values"][:, 0], b["depth_values"][:, 1]
    steps = [(hi - lo).item() / (NDEPTHS[0] - 1)]
    steps += [nd * iv / (nd - 1) for nd, iv in zip(NDEPTHS[1:], INTERVALS[1:])]
    for i, step in enumerate(steps):
        prev = None if i == 0 else out[f"stage{i}"]["depth"]
        full = m.stage(i, feats[i], b["cams"][i], lo, hi, prev)
        got = out[f"stage{i + 1}"]
        _report(f"pinhole streaming stage{i + 1} depth, of step",
                (got["depth"] - full["depth"]).abs().max().item() / step, 1e-4)
        _report(f"pinhole streaming stage{i + 1} confidence",
                (got["photometric_confidence"] - full["photometric_confidence"]).abs().max().item(),
                1e-5)


@pytest.mark.parametrize("name", ["red", "casmvs", "ucs"])
def test_builders_take_pinhole_cameras(name):
    """Each family built with geo_model="pinhole" on the toy cameras at
    32×32: finite depth inside the range (widened by the windows); RPC
    cameras given to it, and pinhole cameras given to an RPC model, raise."""
    projs = _toy_projs(32, 32)
    cams = tuple(T(tpin.scale_proj_matrix(projs, s).astype(np.float32)[None])
                 for s in (0.25, 0.5, 1.0))
    imgs = T(np.random.default_rng(0).normal(size=(1, 3, 32, 32, 3)).astype(np.float32))
    dv = torch.tensor([[30.0, 60.0]])
    model = build_model(name, "pinhole", ndepths=(8, 8, 8), device="cpu")
    assert model.geo_model == "pinhole"
    depth = model(imgs, cams, dv)["depth"]
    assert bool(torch.isfinite(depth).all()) and 0.0 < depth.min() and depth.max() < 90.0
    with pytest.raises(ValueError, match="geo_model"):
        build_model(name, "rpc", ndepths=(8, 8, 8), device="cpu")(imgs, cams, dv)
    with pytest.raises(ValueError, match="geo_model"):
        build_model(name, "affine", device="cpu")


@pytest.mark.slow
def test_pinhole_train_step_loss_matches_jax(pin_tree, model_runs):
    """One train step (fused_red=False in both) on the 32×64 test block:
    its loss, depth_loss and abs_depth_error against JAX `make_train_step`,
    1e-5 relative.  `slow`: JAX's train-step compile takes ~40 s here."""
    from satmvs_tpu.train.config import Config as JConfig
    from satmvs_tpu.train.loop import TrainState as JState
    from satmvs_tpu.train.loop import make_optimizer as jmake_optimizer
    from satmvs_tpu.train.loop import make_train_step as jmake_train_step
    from satmvs_tpu_torch.train import Config, create_model_and_state, make_train_step

    v, tb = model_runs["v"], model_runs["batch"]
    jsample = jds.MVSDataset(pin_tree["test"], "test", geo_model="pinhole")[0]
    jb = {"imgs": jnp.asarray(jsample["imgs"][None]),
          "cams": tuple(jnp.asarray(c[None]) for c in jsample["cams"]),
          "depth_values": jnp.asarray(jsample["depth_values"][None]),
          "depth_stages": [jnp.asarray(d[None]) for d in jsample["depth_stages"]],
          "mask_stages": [jnp.asarray(m[None]) for m in jsample["mask_stages"]]}
    jcfg = JConfig(ndepths=NDEPTHS, fused_red=False, geo_model="pinhole")
    jm = JNet(geo_model="pinhole", ndepths=NDEPTHS, fused_red=False)
    jtx = jmake_optimizer(jcfg, 2)
    jstate = JState(params=v["params"], batch_stats=v["batch_stats"],
                    opt_state=jtx.init(v["params"]), step=jnp.zeros((), jnp.int32))
    _, jscalars = jmake_train_step(jm, jtx, tuple(jcfg.dlossw))(jstate, jb)
    cfg = Config(ndepths=NDEPTHS, fused_red=False, geo_model="pinhole")
    model, state, tx = create_model_and_state(cfg, tb, 2, variables=v)
    _, scalars = make_train_step(model, tx, cfg.dlossw)(state, tb)
    for key in ("loss", "depth_loss", "abs_depth_error"):
        got, want = float(scalars[key]), float(jscalars[key])
        _report(f"pinhole train step {key}, relative", abs(got - want) / abs(want), 1e-5)


# ---------------------------------------------------------------------------
# fusion and the CLIs
# ---------------------------------------------------------------------------
def _plane_depths(projs_tx, f, h, w, z0=45.0, a=0.3, c=-0.2):
    """Each camera K·[I | (tx, 0, 0)]'s exact depth map of the plane
    z = z0 + a·X + c·Y (as chip_smoke.write_pinhole_tree draws them)."""
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    u, v = (xs - w / 2) / f, (ys - h / 2) / f
    return np.stack([(z0 - a * tx) / (1.0 - a * u - c * v) for tx in projs_tx]).astype(np.float32)


def test_filter_depth_pinhole_matches_jax():
    """filter_depth_pinhole against JAX's on the identity pair of
    tests/test_infer.py (random depths, the same camera twice) and on a
    tilted plane seen from cameras 2 m apart, with a low-confidence band:
    the same mask, the fused depth within 1e-5 relative."""
    rng = np.random.default_rng(0)
    depth = rng.uniform(40, 60, (32, 32)).astype(np.float32)
    k = np.array([[100.0, 0, 16.0], [0, 100.0, 16.0], [0, 0, 1]])
    p = np.eye(4)
    p[:3, :4] = k @ np.eye(4)[:3, :4]
    cases = {"identity": (np.stack([depth, depth]), np.stack([p, p]), None)}
    projs = _toy_projs(32, 32)
    planes = _plane_depths((0.0, 2.0, -2.0), 100.0, 32, 32)
    prob = np.where(np.arange(32)[:, None] < 24, 0.9, 0.1).repeat(32, 1).astype(np.float32)
    cases["translated"] = (planes, projs, prob)
    for name, (depths, pr, pb) in cases.items():
        got_m, got_f = tfuse.filter_depth_pinhole(depths, pr, p_thre=1.0, rel_d_thre=0.01,
                                                  prob=pb, confidence_ratio=0.5, device="cpu")
        want_m, want_f = jfuse.filter_depth_pinhole(depths, pr, p_thre=1.0, rel_d_thre=0.01,
                                                    prob=pb, confidence_ratio=0.5)
        print(f"[parity] pinhole fusion {name}: valid {got_m.mean():.4f} (JAX "
              f"{np.asarray(want_m).mean():.4f})")
        np.testing.assert_array_equal(got_m, want_m)
        np.testing.assert_allclose(got_f, want_f, rtol=1e-5, atol=0)
        assert got_m[1:-1, 1:-1].mean() > 0.5
    assert not got_m[24:].any()  # the low-confidence band


def test_pinhole_train_and_predict_clis(tmp_path, monkeypatch, capsys):
    """`cli.train --geo_model pinhole` for one epoch (one train step and a
    test forward) and `cli.predict --geo_model pinhole --fuse` from its
    checkpoint, at 32² on the CPU: the checkpoint, the three views' finite
    maps within the range (widened by the windows), and fusion declined in
    one line."""
    monkeypatch.setenv("SATMVS_PLATFORM", "cpu")
    root = chip_smoke.write_pinhole_tree(str(tmp_path / "tree"), 1, 1, width=32, height=32)
    logdir = str(tmp_path / "logs")
    out = cli_train.main(["--mode=train", f"--dataset_root={root}", f"--logdir={logdir}",
                          "--ndepths", "8,4,4", "--epochs", "1", "--geo_model", "pinhole"])
    workdir = os.path.join(logdir, "red", "pinhole")
    assert out["timing"]["steps"] == [1] and os.path.isfile(os.path.join(workdir, "1", "state.pt"))
    testpath = os.path.join(root, "open_dataset_pinhole", "test")
    out = cli_predict.main([f"--dataset_root={testpath}", f"--loadckpt={workdir}", "--ndepths",
                            "8,4,4", "--geo_model", "pinhole", "--fuse"])
    assert sorted(out["written"]) == [(v, "block0000") for v in "012"] and out["fused"] == {}
    for path in out["written"].values():
        depth = formats.load_pfm(path)
        assert np.isfinite(depth).all() and 30 - 15 < depth.min() and depth.max() < 60 + 15
    assert "RPC scenes only" in capsys.readouterr().err
