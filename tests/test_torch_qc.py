"""The QC-form RPC camera model (`use_qc`) of the port against the JAX
package on the CPU: `geo.rpc.to_qc_tensor`, `qc_eval`, `refit_direct_rpc`
and `check_rpc` on host numpy; `ops.warp.build_qc_warp_cams` and
`rpc_sweep_coords_qc`; the stage volumes of both sweeps and their feature
gradient against JAX `build_stage_volume("rpc", QcWarpCams ...)` and
`jax.vjp`; `MVSDataset(use_qc=True)` samples and their collate; the QC
forward against the basis-form forward; `make_batch(use_qc=True)`; and
`cli.train --use_qc` / `cli.predict --use_qc`.  Inputs come from numpy
seeds and the synthetic RPC triplets; every tolerance is stated in its
test."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satmvs_tpu import native
from satmvs_tpu.data import dataset as jds
from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.geo import rpc as jrpc
from satmvs_tpu.models.cascade import build_stage_volume as jbuild_stage_volume
from satmvs_tpu.ops import warp as jwarp
from satmvs_tpu_torch.cli import predict as cli_predict
from satmvs_tpu_torch.cli import train as cli_train
from satmvs_tpu_torch.data import dataset as tds
from satmvs_tpu_torch.data import formats
from satmvs_tpu_torch.data import loader as tld
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.geo import rpc as trpc
from satmvs_tpu_torch.models import CascadeREDNet
from satmvs_tpu_torch.models.cascade import build_stage_volume, build_train_volume
from satmvs_tpu_torch.ops import warp as twarp

T = torch.from_numpy
QC_FIELDS = ("ref_inv_qc", "ref_norm", "src_fwd_qc", "src_denorm", "renorm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small ops, run beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _jax_numpy_center_image(monkeypatch):
    """JAX's datasets normalize images on its numpy path, the port's
    arithmetic (see tests/test_torch_data.py)."""
    monkeypatch.setattr(native, "available", lambda: False)


@pytest.fixture(scope="module")
def rpc170():
    return jsyn.make_rpc_triplet(96, 96, seed=6)[0]


def test_qc_tensor_and_eval_match_jax(rpc170):
    """to_qc_tensor of each of the 8 polynomials: JAX's bits; qc_eval on
    numpy (float64) equals JAX's to 1e-12 relative and the 20-term basis to
    1e-12; on torch float32 tensors it is within 1e-6 of the float64 value
    (fp32 sums of 64 terms of magnitude ≤ ~1)."""
    x = np.random.default_rng(0).uniform(-1, 1, (257, 3))
    pts = np.concatenate([np.ones((257, 1)), x], axis=1)  # (1, L, P, H)
    for sl in (trpc.LNUM, trpc.LDEM, trpc.SNUM, trpc.SDEM, trpc.LATNUM, trpc.LATDEM,
               trpc.LONNUM, trpc.LONDEM):
        got, want = trpc.to_qc_tensor(rpc170[sl]), jrpc.to_qc_tensor(rpc170[sl])
        np.testing.assert_array_equal(got, want)
        value = trpc.qc_eval(got, pts)
        np.testing.assert_allclose(value, jrpc.qc_eval(want, pts), rtol=1e-12, atol=1e-12)
        basis = trpc.poly_basis(x[:, 1], x[:, 0], x[:, 2]) @ rpc170[sl]  # P, L, H
        np.testing.assert_allclose(value, basis, rtol=1e-12, atol=1e-12)
        f32 = trpc.qc_eval(got, T(pts.astype(np.float32))).double().numpy()
        assert np.abs(f32 - value).max() <= 1e-6
    with pytest.raises(ValueError, match="20"):
        trpc.to_qc_tensor(np.zeros(19))


def test_refit_direct_rpc_and_check_rpc_match_jax(rpc170):
    """refit_direct_rpc on the virtual grid and check_rpc's round trip:
    JAX's values to 1e-10 relative (the same float64 numpy on both sides)."""
    grid = trpc.create_virtual_grid(rpc170, 12, 6)
    got, want = trpc.refit_direct_rpc(rpc170, grid), jrpc.refit_direct_rpc(rpc170, grid)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    err, jerr = trpc.check_rpc(rpc170, 96, 96), jrpc.check_rpc(rpc170, 96, 96)
    np.testing.assert_allclose(err, jerr, rtol=1e-10, atol=1e-12)
    assert err.max() < 0.01


def _qc_cams(h, w, seed=6, scale=0.25):
    """The port's and JAX's QC bundles of a triplet's (nadir, fwd, bwd)."""
    rpcs = jsyn.make_rpc_triplet(int(w / scale), int(h / scale), seed=seed)
    rpcs = np.stack([rpcs[2], rpcs[0], rpcs[1]])
    return (twarp.build_qc_warp_cams(rpcs, 0, scale, device="cpu"),
            jwarp.build_qc_warp_cams(rpcs, 0, scale), rpcs)


def test_qc_cams_and_coordinates_match_jax():
    """build_qc_warp_cams: JAX's float32 bundle exactly; rpc_sweep_coords_qc
    on per-pixel heights: within 1e-3 px of JAX's, and within 2e-2 px of the
    port's basis form (tests/test_parity_extras.py's gate)."""
    h, w, d = 24, 32, 5
    got, want, rpcs = _qc_cams(h, w)
    for f in QC_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    lo, hi = jrpc.height_range(rpcs[0])
    hyps = np.random.default_rng(1).uniform(lo, hi, (d, h, w)).astype(np.float32)
    basis = twarp.build_rpc_warp_cams(rpcs, 0, 0.25, device="cpu")
    for s in range(2):
        gx, gy = twarp.rpc_sweep_coords_qc(got, s, T(hyps), h, w)
        jx, jy = jwarp.rpc_sweep_coords_qc(want, s, jnp.asarray(hyps), h, w)
        err = max(np.abs(gx.numpy() - np.asarray(jx)).max(),
                  np.abs(gy.numpy() - np.asarray(jy)).max())
        bx, by = twarp.rpc_sweep_coords(basis, s, T(hyps), h, w)
        gap = max((gx - bx).abs().max().item(), (gy - by).abs().max().item())
        print(f"[parity] QC coordinates view {s}: {err:.2e} px vs JAX (tol 1e-3), "
              f"{gap:.2e} px vs the basis form (tol 2e-2)")
        assert err <= 1e-3 and gap <= 2e-2
        assert torch.equal(twarp.sweep_coords(got, s, T(hyps), h, w)[0], gx)


def _volume_inputs(h=16, w=24, d=4, c=8, seed=3):
    cams_t, cams_j, rpcs = _qc_cams(h, w, seed=seed)
    lo, hi = jrpc.height_range(rpcs[0])
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(1, 3, h, w, c)).astype(np.float32)
    hyps = rng.uniform(lo, hi, (1, d, h, w)).astype(np.float32)
    return (feats, hyps, twarp.stack_cams([cams_t]), jwarp.stack_cams([cams_j]))


def test_qc_stage_volumes_and_gradient_match_jax():
    """Both sweeps' volumes on QC cameras (the fused `sweep_variance` and the
    per-view `sweep_gather` pair, their plain versions here) against JAX
    `build_stage_volume("rpc", feats, QcWarpCams...)`, and the feature
    gradient of each for a seeded cotangent against jax.vjp: 1e-5 of each
    one's largest magnitude (~5 and ~7).  On JAX's own coordinates the
    volume is JAX's bits; the gap is the two fp32 coordinate chains' ~1e-5
    px, on white-noise features."""
    feats, hyps, cams_t, cams_j = _volume_inputs()
    want, vjp = jax.vjp(jax.jit(lambda f: jbuild_stage_volume("rpc", f, cams_j,
                                                              jnp.asarray(hyps))),
                        jnp.asarray(feats))
    g = np.random.default_rng(9).normal(size=want.shape).astype(np.float32)
    (dwant,) = vjp(jnp.asarray(g))
    want, dwant = np.asarray(want), np.asarray(dwant)
    tol, dtol = 1e-5 * np.abs(want).max(), 1e-5 * np.abs(dwant).max()
    for name, build in (("fused", build_stage_volume), ("per-view", build_train_volume)):
        f = T(feats).requires_grad_(True)
        got = build(f, cams_t, T(hyps))
        (dgot,) = torch.autograd.grad(got, f, T(g))
        err = np.abs(got.detach().numpy() - want).max()
        derr = np.abs(dgot.numpy() - dwant).max()
        print(f"[parity] QC {name} stage volume {err:.2e} (tol {tol:.2e}), feature gradient "
              f"{derr:.2e} (tol {dtol:.2e})")
        assert got.shape == want.shape and err <= tol and derr <= dtol


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place of each value (x's values are bf16)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8).astype(np.float32)


def test_qc_bf16_volumes_match_jax():
    """With bf16 volume transport: each warped view (`rpc_warp` on QC cameras,
    out_dtype bfloat16) within one bf16 ulp of JAX `rpc_warp(...,
    out_dtype=bfloat16)` plus 1e-5 (both round an fp32 sample once); the
    per-view stage volume against JAX's bf16 `build_stage_volume` within
    1e-5 plus, per element, what one-ulp differences of its views can move
    the variance: (2/V)·Σ ulp(w)·|w − mean|."""
    feats, hyps, cams_t, cams_j = _volume_inputs(seed=4)
    views, bound = [jnp.asarray(feats[0, 0])], 0.0
    for s in range(2):
        got = twarp.rpc_warp(T(feats[0, s + 1]), cams_t[0], s, T(hyps[0]), out_dtype=torch.bfloat16)
        want = jax.jit(lambda f, c, h, s=s: jwarp.rpc_warp(
            f, c, s, h, method="xla", coords="exact", out_dtype=jnp.bfloat16))(
            jnp.asarray(feats[0, s + 1]), jax.tree.map(lambda x: x[0], cams_j),
            jnp.asarray(hyps[0]))
        w32 = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - w32)
        print(f"[parity] QC bf16 warp view {s}: {(err > 0).mean():.2e} of the values apart")
        assert got.dtype == torch.bfloat16 and bool((err <= _bf16_ulp(w32) + 1e-5).all())
        views.append(w32)
    want = np.asarray(jax.jit(lambda *a: jbuild_stage_volume("rpc", *a,
                                                             volume_dtype=jnp.bfloat16))(
        jnp.asarray(feats), cams_j, jnp.asarray(hyps)))
    mean = (np.asarray(views[0])[None] + views[1] + views[2]) / 3
    bound = sum(_bf16_ulp(v) * np.abs(v - mean) for v in views[1:]) * 2 / 3
    got = build_train_volume(T(feats), cams_t, T(hyps), torch.bfloat16).numpy()
    err = np.abs(got - want)
    print(f"[parity] QC bf16 stage volume: {err.max():.2e}, beyond the bound "
          f"{(err - bound[None]).max():.2e} (tol 1e-5)")
    assert bool((err <= bound[None] + 1e-5).all())


@pytest.fixture(scope="module")
def odd_tree(tmp_path_factory):
    """A 70×90 scene (cropped to 64²) written by the JAX writer."""
    root = str(tmp_path_factory.mktemp("qc") / "odd")
    jsyn.write_synthetic_dataset(root, num_scenes=1, width=90, height=70, h_amp=40.0,
                                 h_scale=120.0)
    return root


@pytest.mark.parametrize("mode", ["train", "test", "pred"])
def test_qc_dataset_matches_jax(odd_tree, mode):
    """MVSDataset(use_qc=True) on an odd-size view (the crop shifts the RPC's
    image offsets) against JAX's, in each mode: images bit for bit (the
    jitter from the same seed in train mode), the QC bundles' float32 bits,
    depth range and GT pyramids exactly; QcWarpCams at every stage."""
    tset = tds.MVSDataset(odd_tree, mode, 3, 2, seed=7, use_qc=True)
    jset = jds.MVSDataset(odd_tree, mode, 3, 2, seed=7, use_qc=True)
    assert len(tset) == len(jset)
    for i in range(len(tset)):
        got, want = tset[i], jset[i]
        assert got["imgs"].shape == (3, 64, 64, 3)
        np.testing.assert_array_equal(got["imgs"], want["imgs"])
        np.testing.assert_array_equal(got["depth_values"], want["depth_values"])
        for gc, wc in zip(got["cams"], want["cams"]):
            assert isinstance(gc, twarp.QcWarpCams)
            for f in QC_FIELDS:
                np.testing.assert_array_equal(getattr(gc, f).numpy(), np.asarray(getattr(wc, f)))
        for key in ("depth_stages", "mask_stages"):
            for g, w in zip(got.get(key, []), want.get(key, [])):
                np.testing.assert_array_equal(g, w)
    batch = tld.collate([tset[0], tset[0]])
    assert batch["cams"][0].src_fwd_qc.shape == (2, 2, 4, 4, 4, 4)
    moved = tld.to_device(batch, "cpu")
    assert isinstance(moved["cams"][2], twarp.QcWarpCams)
    assert torch.equal(moved["cams"][2].ref_inv_qc[1], batch["cams"][2].ref_inv_qc[0])


def test_qc_make_batch_matches_jax():
    """make_batch(use_qc=True): JAX's QC bundles' bits and the same images."""
    got = tsyn.make_batch(1, 32, 32, seed=2, device="cpu", use_qc=True)
    want = jsyn.make_batch(1, 32, 32, seed=2, use_qc=True)
    np.testing.assert_array_equal(got["imgs"].numpy(), want["imgs"])
    for gc, wc in zip(got["cams"], want["cams"]):
        for f in QC_FIELDS:
            np.testing.assert_array_equal(getattr(gc, f).numpy(), np.asarray(getattr(wc, f)))


def test_qc_forward_matches_the_basis_forward():
    """CascadeREDNet (numpy-seeded weights) on QC bundles against the same
    model on the basis form of the same views: each stage's depth within
    0.3 m (JAX's own gate, tests/test_parity_extras.py), the confidence
    within 1e-3."""
    model = CascadeREDNet(ndepths=(8, 4, 4), device="cpu")
    basis = tsyn.make_batch(1, 64, 32, seed=4, device="cpu")
    qc = tsyn.make_batch(1, 64, 32, seed=4, device="cpu", use_qc=True)
    out_b = model(basis["imgs"], basis["cams"], basis["depth_values"])
    out_q = model(qc["imgs"], qc["cams"], qc["depth_values"])
    for s in (1, 2, 3):
        dh = (out_q[f"stage{s}"]["depth"] - out_b[f"stage{s}"]["depth"]).abs().max().item()
        dc = (out_q[f"stage{s}"]["photometric_confidence"]
              - out_b[f"stage{s}"]["photometric_confidence"]).abs().max().item()
        print(f"[parity] QC vs basis forward stage{s}: depth {dh:.2e} m (tol 0.3), "
              f"confidence {dc:.2e} (tol 1e-3)")
        assert dh < 0.3 and dc < 1e-3


def test_qc_train_and_predict_clis(tmp_path, monkeypatch):
    """`cli.train --use_qc` for one epoch (one train step, one test forward)
    and `cli.predict --use_qc` from its checkpoint, at 32², on the CPU: the
    checkpoint and the three views' finite maps written."""
    monkeypatch.setenv("SATMVS_PLATFORM", "cpu")
    root = str(tmp_path / "tree")
    tsyn.write_whu_tlc_tree(root, num_train=1, num_test=1, width=32, height=32, h_amp=40.0,
                            h_scale=120.0)
    logdir = str(tmp_path / "logs")
    out = cli_train.main(["--mode=train", f"--dataset_root={root}", f"--logdir={logdir}",
                          "--ndepths", "8,4,4", "--epochs", "1", "--use_qc"])
    workdir = os.path.join(logdir, "red", "rpc")
    assert out["timing"]["steps"] == [1] and os.path.isfile(os.path.join(workdir, "1", "state.pt"))
    testpath = os.path.join(root, "open_dataset_rpc", "test")
    out = cli_predict.main([f"--dataset_root={testpath}", f"--loadckpt={workdir}", "--ndepths",
                            "8,4,4", "--use_qc"])
    assert sorted(out["written"]) == [(v, "block0000") for v in "012"]
    for path in out["written"].values():
        assert np.isfinite(formats.load_pfm(path)).all()
