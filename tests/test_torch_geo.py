"""Port geometry (satmvs_tpu_torch.geo / ops.warp / data.synthetic) against
the JAX package and the float64 oracle, on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.geo import rpc as jrpc
from satmvs_tpu.ops import warp as jwarp
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.ops import warp as twarp

CAM_FIELDS = ("ref_inv", "ref_norm", "src_fwd", "src_denorm", "renorm")


@pytest.fixture(scope="module")
def triplet():
    """Ref-first (nadir, forward, backward) RPCs of a 256×256 scene."""
    rpcs = jsyn.make_rpc_triplet(256, 256, seed=1)
    return np.stack([rpcs[2], rpcs[0], rpcs[1]])


@pytest.mark.parametrize("stage_scale", [0.25, 0.5, 1.0])
def test_rpc_sweep_coords_match_jax(triplet, stage_scale):
    """Exact per-pixel sweep coordinates at each stage scale: within 1e-3 px
    of the JAX chain (both fp32; they differ only in summation order)."""
    size = int(256 * stage_scale)
    jc = jwarp.build_rpc_warp_cams(triplet, 0, stage_scale)
    tc = twarp.build_rpc_warp_cams(triplet, 0, stage_scale, device="cpu")
    h_min, h_max = jrpc.height_range(triplet[0])
    rng = np.random.default_rng(0)
    depths = rng.uniform(h_min, h_max, (8, size, size)).astype(np.float32)
    for s in range(2):
        jx, jy = jwarp.rpc_sweep_coords(jc, s, jnp.asarray(depths), size, size)
        tx, ty = twarp.rpc_sweep_coords(tc, s, torch.from_numpy(depths), size, size)
        err = max(np.abs(np.asarray(jx) - tx.numpy()).max(),
                  np.abs(np.asarray(jy) - ty.numpy()).max())
        print(f"[parity] sweep coords scale {stage_scale} view {s}: {err:.2e} px (tol 1e-3)")
        assert err < 1e-3, f"view {s}: {err} px"


def test_rpc_transform_points_vs_fp64_oracle(triplet):
    """The port's fp32 normalized chain within 0.01 px of the absolute-
    coordinate float64 projection (the gate of tests/test_geo.py)."""
    ref, src = triplet[0], triplet[1]
    rng = np.random.default_rng(1)
    n = 4096
    x = rng.uniform(0, 255, n)
    y = rng.uniform(0, 255, n)
    h = rng.uniform(*jrpc.height_range(ref), n)
    lat, lon = jrpc.photo_to_obj(ref, x, y, h)
    samp64, line64 = jrpc.obj_to_photo(src, lat, lon, h)

    cams = twarp.build_rpc_warp_cams(np.stack([ref, src]), 0, 1.0, device="cpu")
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    xs, ys = twarp.rpc_transform_points(cams, 0, f32(x), f32(y), f32(h))
    err = np.hypot(xs.numpy().astype(np.float64) - samp64,
                   ys.numpy().astype(np.float64) - line64)
    print(f"[parity] transform vs fp64 oracle: {err.max():.2e} px (tol 0.01)")
    assert err.max() < 0.01, err.max()


def test_build_rpc_warp_cams_fields_equal(triplet):
    """Same host float64 math, same float32 cast: every field bit-equal,
    batched (stack_cams) and per stage (build_stage_cams)."""
    jst = jwarp.build_stage_cams(triplet, 0, 3)
    tst = twarp.build_stage_cams(triplet, 0, device="cpu")
    for jc, tc in zip(jst, tst):
        jb = jwarp.stack_cams([jc, jc])
        tb = twarp.stack_cams([tc, tc])
        for f in CAM_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(jc, f)), getattr(tc, f).numpy())
            np.testing.assert_array_equal(np.asarray(getattr(jb, f)), getattr(tb, f).numpy())
            np.testing.assert_array_equal(getattr(tb[1], f).numpy(), getattr(tc, f).numpy())


def test_synthetic_batch_matches_jax():
    """The port's numpy copy of the scene generator gives the JAX package's
    images, cameras and height range for the same seed."""
    jb = jsyn.make_batch(1, 64, 32, seed=3, with_gt=False)
    tb = tsyn.make_batch(1, 64, 32, seed=3, device="cpu")
    np.testing.assert_allclose(tb["imgs"].numpy(), jb["imgs"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tb["depth_values"].numpy(), jb["depth_values"])
    for jc, tc in zip(jb["cams"], tb["cams"]):
        for f in CAM_FIELDS:
            np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                       rtol=1e-6, atol=0)
