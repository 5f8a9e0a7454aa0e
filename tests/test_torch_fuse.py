"""Fusion and the DSM against the JAX package, on the CPU:
satmvs_tpu_torch/ops/sampling.bilinear_sample_scalar, geo/tmerc.py and
infer/fuse.py.

Tolerances.  `bilinear_sample_scalar`: 1e-5 m on ~500 m heights (float32
lerps in another order).  TransverseMercator: 1e-6 m and 1e-12° (both
numpy float64, the same formulas).  `filter_depth_rpc`: the same valid
mask except at boundary pixels, those within 1e-3 px of p_ratio or 1e-3 m
of d_ratio in some view (float32 reprojection through XLA and through
torch rounds apart by ~1e-4 px), and fused heights within 1e-3 m where both
keep a pixel.  `rasterize_dsm` on the same points: equal (float64 numpy
in both).  `fuse_scene_to_dsm`: the same grid, the valid fraction within
0.5 percentage points and the DSM within a mean |Δ| of 0.05 m on cells
valid in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.geo import rpc as jrpc
from satmvs_tpu.geo.tmerc import TransverseMercator as JTM
from satmvs_tpu.infer import fuse as jfuse
from satmvs_tpu.ops.sampling import bilinear_sample_scalar as jsample
from satmvs_tpu_torch.data import formats
from satmvs_tpu_torch.geo.tmerc import TransverseMercator as TTM
from satmvs_tpu_torch.infer import fuse as tfuse
from satmvs_tpu_torch.ops.sampling import bilinear_sample_scalar as tsample
from satmvs_tpu_torch.ops.warp import build_rpc_warp_cams, rpc_transform_points


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ORDER = [2, 0, 1]  # the nadir view is the reference


@pytest.fixture(scope="module")
def scene():
    s = jsyn.make_scene(64, 48, seed=3, h_amp=60.0)
    return {"depths": s["gt_heights"][ORDER].astype(np.float32), "rpcs": s["rpcs"][ORDER]}


def test_bilinear_sample_scalar_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(400, 600, (9, 13)).astype(np.float32)
    x = rng.uniform(-2, 14, (7, 11)).astype(np.float32)
    y = rng.uniform(-2, 10, (7, 11)).astype(np.float32)
    x[0, :4] = [0.0, 12.0, -1e-6, 12.000001]
    y[0, :4] = [0.0, 8.0, 3.0, 3.0]
    for fill in (0.0, -999.0):
        got = tsample(torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y), fill)
        want = np.asarray(jsample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), fill))
        assert got.shape == (7, 11) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        assert (got.numpy() == fill).sum() == (want == fill).sum() > 0


def test_transverse_mercator_matches_jax():
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(25, 35, 50), rng.uniform(121, 125, 50)], -1)
    for jtm, ttm in ((JTM.utm_for(120.0), TTM.utm_for(120.0)), (JTM.whu_tlc(), TTM.whu_tlc())):
        assert ttm.lon_origin == jtm.lon_origin
        en = ttm.proj(pts)
        np.testing.assert_allclose(en, jtm.proj(pts), rtol=0, atol=1e-6)
        np.testing.assert_allclose(ttm.proj(en, reverse=True), jtm.proj(en, reverse=True),
                                   rtol=0, atol=1e-12)
    back = TTM.utm_for(120.0).proj(TTM.utm_for(120.0).proj(pts), reverse=True)
    np.testing.assert_allclose(back, pts, rtol=0, atol=1e-7)  # round trip within 2° of the meridian


def _near_thresholds(depths, rpcs, p_ratio, d_ratio) -> np.ndarray:
    """Pixels within 1e-3 px of p_ratio or 1e-3 m of d_ratio in some view,
    by the port's reprojection chain."""
    h, w = depths.shape[1:]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    ref = torch.from_numpy(depths[0])
    near = np.zeros((h, w), bool)
    for v in range(1, len(depths)):
        pair = np.stack([rpcs[0], rpcs[v]])
        rs = build_rpc_warp_cams(pair, 0, device="cpu")
        sr = build_rpc_warp_cams(pair[::-1], 0, device="cpu")
        x1, y1 = rpc_transform_points(rs, 0, xs, ys, ref)
        sampled = tsample(torch.from_numpy(depths[v]), x1, y1, tfuse.INVALID_DEPTH)
        x2, y2 = rpc_transform_points(sr, 0, x1, y1, sampled)
        dist = torch.hypot(x2 - xs, y2 - ys).numpy()
        gap = (sampled - ref).abs().numpy()
        near |= (np.abs(dist - p_ratio) < 1e-3) | (np.abs(gap - d_ratio) < 1e-3)
    return near


@pytest.mark.parametrize("case", ["consistent", "inconsistent", "photometric"])
def test_filter_depth_rpc_matches_jax(scene, case):
    depths, rpcs = scene["depths"].copy(), scene["rpcs"]
    kw = dict(p_ratio=1.0, d_ratio=2.5, geo_consist_num=1)
    if case == "inconsistent":  # view 1 off by 30 m: only view 2 agrees
        depths[1] += 30.0
    if case == "photometric":
        kw["prob"] = np.random.default_rng(2).uniform(0, 1, depths.shape[1:]).astype(np.float32)
        kw["confidence_ratio"] = 0.5
    mask, fused = tfuse.filter_depth_rpc(depths, rpcs, device="cpu", **kw)
    jmask, jfused = jfuse.filter_depth_rpc(depths, rpcs, **kw)
    assert mask.dtype == bool and mask.shape == jmask.shape == depths.shape[1:]
    assert fused.dtype == np.float32
    differ = mask != np.asarray(jmask)
    near = _near_thresholds(depths, rpcs, kw["p_ratio"], kw["d_ratio"])
    print(f"[fuse] {case}: valid {mask.mean():.4f} (JAX {np.asarray(jmask).mean():.4f}), "
          f"{differ.sum()} pixels differ, all at thresholds: {bool((near | ~differ).all())}")
    assert (near | ~differ).all()
    both = mask & np.asarray(jmask)
    assert both.mean() > 0.3
    np.testing.assert_allclose(fused[both], np.asarray(jfused)[both], rtol=0, atol=1e-3)
    if case == "inconsistent":  # requiring both views keeps nothing, in both
        kw["geo_consist_num"] = 2
        assert not tfuse.filter_depth_rpc(depths, rpcs, device="cpu", **kw)[0].any()
        assert not np.asarray(jfuse.filter_depth_rpc(depths, rpcs, **kw)[0]).any()


def test_rasterize_dsm_matches_jax(scene):
    rng = np.random.default_rng(4)
    rpc = scene["rpcs"][0]
    h, w = scene["depths"].shape[1:]
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    heights = scene["depths"][0].astype(np.float64).ravel()
    lat, lon = jrpc.photo_to_obj(rpc, xs.ravel(), ys.ravel(), heights)
    mask = rng.uniform(size=lat.shape) > 0.3
    tm = TTM.utm_for(float(rpc[3]))
    got = tfuse.rasterize_dsm(lat, lon, heights, mask, tm, 2.5)
    want = jfuse.rasterize_dsm(lat, lon, heights, mask, JTM.utm_for(float(rpc[3])), 2.5)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert (got[0] != tfuse.INVALID_DEPTH).any() and (got[0] == tfuse.INVALID_DEPTH).any()
    with pytest.raises(ValueError, match="no valid points"):
        tfuse.rasterize_dsm(lat, lon, heights, np.zeros_like(mask), tm)


def test_fuse_scene_to_dsm_matches_jax(scene, tmp_path):
    kw = dict(grid_res=2.5, p_ratio=2.0, d_ratio=7.5)
    tpath, tmask, _ = tfuse.fuse_scene_to_dsm(scene["depths"], scene["rpcs"],
                                              str(tmp_path / "t_dsm.tif"), device="cpu", **kw)
    jpath, jmask, _ = jfuse.fuse_scene_to_dsm(scene["depths"], scene["rpcs"],
                                              str(tmp_path / "j_dsm.tif"), **kw)
    assert tpath.endswith("t_dsm.pfm")  # no GDAL here: the PFM + TFW fallback
    got, gtfw = formats.read_dsm(tpath)
    want, wtfw = formats.read_dsm(jpath)
    assert got.shape == want.shape
    np.testing.assert_allclose(gtfw, wtfw, rtol=0, atol=1e-6)
    valid, jvalid = got != tfuse.INVALID_DEPTH, want != tfuse.INVALID_DEPTH
    both = valid & jvalid
    mean_err = np.abs(got[both] - want[both]).mean()
    print(f"[fuse] DSM {got.shape}: valid {valid.mean():.4f} vs JAX {jvalid.mean():.4f}; "
          f"filter valid {tmask.mean():.4f} vs {np.asarray(jmask).mean():.4f}; mean |dh| "
          f"{mean_err:.2e} m")
    assert abs(valid.mean() - jvalid.mean()) <= 0.005 and valid.mean() > 0.2
    assert mean_err <= 0.05


def test_fusion_needs_cuda_unless_cpu_is_asked(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfuse.filter_depth_rpc(scene["depths"], scene["rpcs"])
