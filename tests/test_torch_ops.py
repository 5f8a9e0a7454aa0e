"""Port ops (sampling, cost volume, depth range, regression) against the JAX
package on the CPU, on the same numpy inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.geo import rpc as jrpc
from satmvs_tpu.ops import depth_range as jdr
from satmvs_tpu.ops import regression as jreg
from satmvs_tpu.ops import warp as jwarp
from satmvs_tpu.ops.cost_volume import sweep_variance_volume
from satmvs_tpu.ops.pallas import sweep_gather as sg
from satmvs_tpu.ops.pallas.sweep_variance import sweep_variance as pallas_sweep_variance
from satmvs_tpu.ops.sampling import bilinear_sample as jbilinear
from satmvs_tpu_torch.ops import depth_range as tdr
from satmvs_tpu_torch.ops import regression as treg
from satmvs_tpu_torch.ops import warp as twarp
from satmvs_tpu_torch.ops.kernels.sweep_variance import (
    sweep_variance_batched_reference, sweep_variance_reference)
from satmvs_tpu_torch.ops.sampling import bilinear_sample as tbilinear


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


T = torch.from_numpy


def test_bilinear_sample_matches_jax_off_image_and_border():
    """Random points over and beyond the image, plus the border cases where
    single corners fall off (x ∈ (−1, 0), x ∈ (W−1, W)) and far-off points:
    equal to JAX within 1e-6."""
    h, w, c = 12, 20, 5
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(h, w, c)).astype(np.float32)
    x = rng.uniform(-3, w + 2, 500)
    y = rng.uniform(-3, h + 2, 500)
    edge_x = [-1.0, -0.5, -0.01, 0.0, w - 1.0, w - 0.5, w - 0.01, w, 1e9, -1e9, 3.5]
    edge_y = [3.0, -0.5, h - 0.5, h - 1.0, 0.0, -1.0, h, 2.25, 2.0, 5.0, -1e9]
    x = np.concatenate([x, edge_x]).astype(np.float32).reshape(-1, 7)
    y = np.concatenate([y, edge_y]).astype(np.float32).reshape(-1, 7)
    want = np.asarray(jbilinear(jnp.asarray(feat), jnp.asarray(x), jnp.asarray(y)))
    got = tbilinear(T(feat), T(x), T(y)).numpy()
    assert got.shape == want.shape == (*x.shape, c)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def rpc_sweep():
    """Stage-1 geometry of a 256×256 triplet (64×64, D = 8, C = 8, S = 2):
    JAX cams, port cams, hypotheses and features."""
    rpcs = jsyn.make_rpc_triplet(256, 256, seed=1)
    rpcs = np.stack([rpcs[2], rpcs[0], rpcs[1]])
    h = w = 64
    d, c = 8, 8
    h_min, h_max = jrpc.height_range(rpcs[0])
    depths = np.linspace(h_min, h_max, d, dtype=np.float32)
    rng = np.random.default_rng(2)
    return {
        "jcams": jwarp.build_rpc_warp_cams(rpcs, 0, 0.25),
        "tcams": twarp.build_rpc_warp_cams(rpcs, 0, 0.25, device="cpu"),
        "depths": depths, "h": h, "w": w,
        "ref": rng.normal(size=(h, w, c)).astype(np.float32),
        "srcs": rng.normal(size=(2, h, w, c)).astype(np.float32),
    }


def _port_coords(g):
    coords = [twarp.rpc_sweep_coords(g["tcams"], s, T(g["depths"]), g["h"], g["w"])
              for s in range(2)]
    return torch.stack([c[0] for c in coords]), torch.stack([c[1] for c in coords])


def test_sweep_variance_reference_matches_jax_xla_path(rpc_sweep):
    """Plain sweep_variance against the JAX CPU path (sweep_variance_volume
    over rpc_warp(method="xla"), exact coords).  On JAX's coordinates:
    within 1e-5 on O(1) variances.  End to end with the port's coordinates
    (≤ 2.3e-5 px apart): within 5e-4, since a shift Δx moves a variance by
    up to ~2·|f|·|∇f|·Δx on these unit-normal random features."""
    g = rpc_sweep
    depths = jnp.asarray(g["depths"])
    want = np.asarray(sweep_variance_volume(
        jnp.asarray(g["ref"]), jnp.asarray(g["srcs"]),
        lambda sf, s: jwarp.rpc_warp(sf, g["jcams"], s, depths, method="xla",
                                     coords="exact")))
    jcoords = [jwarp.rpc_sweep_coords(g["jcams"], s, depths, g["h"], g["w"]) for s in range(2)]
    jxs, jys = (torch.from_numpy(np.array(np.stack([c[k] for c in jcoords]))) for k in (0, 1))
    same = sweep_variance_reference(T(g["ref"]), T(g["srcs"]), jxs, jys).numpy()
    got = sweep_variance_reference(T(g["ref"]), T(g["srcs"]), *_port_coords(g)).numpy()
    assert got.shape == same.shape == want.shape == (8, g["h"], g["w"], 8)
    print(f"[parity] sweep vs JAX XLA path: {np.abs(same - want).max():.2e} on JAX coords "
          f"(tol 1e-5), {np.abs(got - want).max():.2e} end to end (tol 5e-4)")
    np.testing.assert_allclose(same, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


def test_sweep_variance_batched_reference_matches_jax_per_sample(rpc_sweep):
    """The batched plain version (B = 2: the fixture's sample, and seeded
    features with the source views' coordinates swapped) against the JAX
    package's sweep_variance_volume over its bilinear_sample, sample by
    sample, on JAX's coordinates: within 1e-5 on O(1) variances."""
    g = rpc_sweep
    depths = jnp.asarray(g["depths"])
    jcoords = [jwarp.rpc_sweep_coords(g["jcams"], s, depths, g["h"], g["w"]) for s in range(2)]
    jxs, jys = (np.stack([np.asarray(c[k]) for c in jcoords]) for k in (0, 1))
    rng = np.random.default_rng(5)
    feats = np.stack([np.concatenate([g["ref"][None], g["srcs"]]),
                      rng.normal(size=(3, g["h"], g["w"], 8)).astype(np.float32)])
    xs, ys = np.stack([jxs, jxs[::-1]]), np.stack([jys, jys[::-1]])
    got = sweep_variance_batched_reference(T(feats), T(xs), T(ys)).numpy()
    assert got.shape == (2, 8, g["h"], g["w"], 8)
    for i in range(2):
        want = np.asarray(sweep_variance_volume(
            jnp.asarray(feats[i, 0]), jnp.asarray(feats[i, 1:]),
            lambda sf, s: jbilinear(sf, jnp.asarray(xs[i, s]), jnp.asarray(ys[i, s]))))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5)


def test_sweep_variance_reference_matches_pallas_kernel(rpc_sweep):
    """On the same coordinates, where the TPU kernel's coverage contract
    holds (count_misses == 0), the plain version equals the Pallas kernel
    run in interpret mode within 1e-5."""
    g = rpc_sweep
    xs, ys = _port_coords(g)
    for s in range(2):
        assert int(sg.count_misses(jnp.asarray(xs[s].numpy()), jnp.asarray(ys[s].numpy()),
                                   g["h"], g["w"]).sum()) == 0
    want = pallas_sweep_variance(jnp.asarray(g["ref"]), jnp.asarray(g["srcs"]),
                                 jnp.asarray(xs.numpy()), jnp.asarray(ys.numpy()),
                                 8, 8, True)
    got = sweep_variance_reference(T(g["ref"]), T(g["srcs"]), xs, ys)
    print(f"[parity] sweep vs Pallas interpret: {np.abs(got.numpy() - want).max():.2e} (tol 1e-5)")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_uniform_and_window_samples_match_jax():
    rng = np.random.default_rng(3)
    lo, hi = np.float32(50.0), np.float32(950.0)
    want = jdr.uniform_samples(jnp.float32(lo), jnp.float32(hi), 8, 5, 7)
    got = tdr.uniform_samples(T(np.array(lo)), T(np.array(hi)), 8, 5, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7, atol=0)
    cur = rng.uniform(100, 900, (5, 7)).astype(np.float32)
    for nd, interval in ((4, 5.0), (8, 2.5), (3, 10.0)):
        want = jdr.window_samples(jnp.asarray(cur), nd, interval)
        got = tdr.window_samples(T(cur), nd, interval)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7, atol=0)


@pytest.mark.parametrize("src,dst", [((8, 16), (16, 32)), ((5, 7), (10, 14)),
                                     ((5, 7), (13, 9)), ((6, 10), (11, 17))])
def test_upsample_map_matches_jax_image_resize(src, dst):
    """F.interpolate(bilinear, align_corners=False) equals
    jax.image.resize(bilinear) on 2×, odd and non-square upsampling,
    edges included, within 4 float32 ulps (relative 5e-7): the two
    interpolate in different operation orders."""
    rng = np.random.default_rng(4)
    x = rng.uniform(100, 900, src).astype(np.float32)
    want = np.asarray(jdr.upsample_map(jnp.asarray(x), *dst))
    got = tdr.upsample_map(T(x), *dst).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)
    batched = tdr.upsample_map(T(np.stack([x, 2 * x])), *dst).numpy()
    np.testing.assert_allclose(batched[1], 2 * want, rtol=5e-7, atol=0)


def test_regression_and_confidence_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(6, 4, 5)).astype(np.float32) * 3
    prob = np.array(jax.nn.softmax(jnp.asarray(logits), axis=0))
    hyps = rng.uniform(100, 900, (6, 4, 5)).astype(np.float32)
    for dv in (hyps, hyps[:, 0, 0].copy()):
        np.testing.assert_allclose(
            treg.depth_regression(T(prob), T(dv)).numpy(),
            np.asarray(jreg.depth_regression(jnp.asarray(prob), jnp.asarray(dv))),
            rtol=1e-6, atol=0)
    np.testing.assert_array_equal(treg.max_prob_confidence(T(prob)).numpy(),
                                  np.asarray(jreg.max_prob_confidence(jnp.asarray(prob))))
    # batched (B, D, H, W), as the cascade calls them: JAX's per sample
    probs, hyps2 = np.stack([prob, prob[::-1]]), np.stack([hyps, hyps * 0.5])
    want = [jreg.depth_regression(jnp.asarray(p), jnp.asarray(h)) for p, h in zip(probs, hyps2)]
    np.testing.assert_allclose(treg.depth_regression(T(probs), T(hyps2)).numpy(),
                               np.stack(want), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        treg.max_prob_confidence(T(probs)).numpy(),
        np.stack([jreg.max_prob_confidence(jnp.asarray(p)) for p in probs]))
