"""The port's whole-scene prediction and the host-side pieces it uses
(satmvs_tpu_torch/infer/{tiling,scene}.py, geo/rpc.crop_rpc,
data/preprocess.center_image) against the JAX package's on the CPU.  The
scene runs take the weights of tests/test_torch_infer.py (numpy-seeded,
heads ×40) and hold depth to 1 % of the final stage's hypothesis step."""

import functools

import numpy as np
import jax
import pytest
import torch

from satmvs_tpu.data import preprocess as jpre
from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.geo import rpc as jrpc
from satmvs_tpu.infer import scene as jscene
from satmvs_tpu.infer import tiling as jtiling
from satmvs_tpu.infer.predict import streaming_red_forward as jstream
from satmvs_tpu_torch.data import preprocess as tpre
from satmvs_tpu_torch.geo import rpc as trpc
from satmvs_tpu_torch.infer import scene as tscene
from satmvs_tpu_torch.infer import tiling as ttiling
from satmvs_tpu_torch.infer.predict import streaming_red_forward as tstream
from test_torch_infer import NDEPTHS, _steps, seeded_weights


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_plan_tiles_and_stitch_match_jax():
    """Tiles (origins, extents, interiors) equal JAX's exactly, for square,
    ragged and small scenes; stitching an identity prediction returns the
    scene exactly."""
    rng = np.random.default_rng(0)
    for sh, sw, tile, halo in ((1152, 1152, 384, 32), (200, 300, 96, 32), (2000, 1500, 384, 32),
                               (96, 96, 64, 32), (40, 70, 32, 0)):
        want = jtiling.plan_tiles(sh, sw, tile=tile, halo=halo)
        got = ttiling.plan_tiles(sh, sw, tile=tile, halo=halo)
        assert [tuple(vars(t).values()) for t in got] == [tuple(vars(t).values()) for t in want]
        scene = rng.normal(size=(sh, sw)).astype(np.float32)
        outs = [ttiling.extract(scene, t) for t in got]
        np.testing.assert_array_equal(ttiling.stitch(got, outs, sh, sw), scene)
        np.testing.assert_array_equal(ttiling.stitch(got, outs, sh, sw),
                                      jtiling.stitch(want, outs, sh, sw))
    assert {(t.height, t.width) for t in ttiling.plan_tiles(1152, 1152)} == {(448, 448)}
    with pytest.raises(ValueError):
        ttiling.plan_tiles(100, 100, tile=48)


def test_crop_rpc_matches_jax():
    rpc = jsyn.make_synthetic_rpc(128, 128, off_nadir_deg=22.0, seed=2)
    for w0, h0 in ((32.0, 48.0), (-38, -45), (0, 0)):
        np.testing.assert_array_equal(trpc.crop_rpc(rpc, w0, h0), jrpc.crop_rpc(rpc, w0, h0))
    assert trpc.crop_rpc(rpc, 1, 2) is not rpc


def test_center_image_matches_jax(monkeypatch):
    """Like with like: the port's numpy path against JAX's numpy path to
    1e-6 on unit-variance outputs (the same float32 arithmetic), and, where
    the native libraries are built, the port's native path against JAX's
    bit for bit (the same C++ arithmetic, float64 moments)."""
    from satmvs_tpu import native as jnative
    from satmvs_tpu_torch import native as tnative

    both_native = tnative.available() and jnative.available()
    rng = np.random.default_rng(1)
    for shape in ((64, 48), (64, 48, 3)):
        img = rng.uniform(40.0, 230.0, shape).astype(np.float32)
        if both_native:
            got, want = tpre.center_image(img), jpre.center_image(img)
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        with monkeypatch.context() as m:
            m.setattr(jnative, "available", lambda: False)
            m.setattr(tnative, "available", lambda: False)
            got, want = tpre.center_image(img), jpre.center_image(img)
        assert got.dtype == np.float32 and got.shape == want.shape
        print(f"[parity] center_image {shape}: numpy paths {np.abs(got - want).max():.2e} "
              f"(tol 1e-6), native paths bit for bit: {both_native}")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_source_window_matches_jax():
    """Source windows of views whose pixel grids are shifted off the
    reference's, at interior and edge tiles: equal integers."""
    size = 192
    rpcs = np.stack(jsyn.make_rpc_triplet(size, size, seed=13, h_scale=100.0))[[2, 0, 1]]
    rpcs[1] = jrpc.crop_rpc(rpcs[1], 41, 27)
    rpcs[2] = jrpc.crop_rpc(rpcs[2], -38, -45)
    h_min, h_max = jrpc.height_range(rpcs[0])
    for row0, col0 in ((48, 48), (0, 96), (96, 0), (96, 96)):
        for view in range(3):
            args = (rpcs, 0, view, row0, col0, 96, 96, h_min, h_max, size, size)
            assert tscene.source_window(*args) == jscene.source_window(*args)


@pytest.fixture(scope="module")
def scene_runs():
    """A 96² synthetic triplet, tile 64 and halo 32 (four 96² tiles), each
    package with its own slab-4 streaming forward: JAX's one tile at a time,
    the port's at batch_tiles 1 and 2."""
    v, model = seeded_weights()
    scene = jsyn.make_scene(96, 96, seed=9, h_amp=50.0)
    images, rpcs = scene["images"][[2, 0, 1]], scene["rpcs"][[2, 0, 1]]
    jfwd = jax.jit(functools.partial(jstream, v, geo_model="rpc", ndepths=NDEPTHS, slab=4))
    want = jscene.predict_scene(jfwd, images, rpcs, tile=64, halo=32, num_stage=3)
    tfwd = functools.partial(tstream, model, slab=4)
    got = {}
    for batch_tiles in (1, 2):
        stats = {}
        got[batch_tiles] = tscene.predict_scene(tfwd, images, rpcs, tile=64, halo=32,
                                                batch_tiles=batch_tiles, stats=stats,
                                                device="cpu")
        assert stats["n_tiles"] == 4 and stats["n_chunks"] == 4 // batch_tiles
        assert len(stats["chunk_s"]) == stats["n_chunks"]
    return want, got, jrpc.height_range(rpcs[0])


@pytest.mark.parametrize("batch_tiles", [1, 2])
def test_predict_scene_matches_jax(scene_runs, batch_tiles):
    """The stitched scene depth within 1 % of the final stage's step of
    JAX's, and the confidence within 2e-3, at batch_tiles 1 and 2."""
    want, got, (h_min, h_max) = scene_runs
    step = _steps(h_min, h_max)[-1]
    depth, conf = got[batch_tiles]
    assert depth.shape == conf.shape == (96, 96) and depth.dtype == np.float32
    assert np.isfinite(depth).all() and conf.min() >= 0.0
    err = np.abs(depth - want[0]).max()
    cerr = np.abs(conf - want[1]).max()
    print(f"[parity] predict_scene batch_tiles {batch_tiles}: depth {err / step:.2e} of step "
          f"(tol 0.01), confidence {cerr:.2e} (tol 2e-3)")
    assert err < 0.01 * step
    assert cerr < 2e-3
