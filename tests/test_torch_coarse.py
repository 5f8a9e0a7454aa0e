"""Coarse-grid sweep coordinates (`ops/coarse_coords.py`) on the CPU:
against JAX's `rpc_sweep_coords_coarse` on the same cameras (per plane and
per pixel, at a size that is not a multiple of the factor; ≤ 1e-3 px, the
two packages' fp32 chains are ~2e-5 px apart, tests/test_torch_ops.py),
against the port's exact chain (the gates of tests/test_coarse_coords.py:
5e-3 px per plane, 2e-2 px per pixel, BASELINE.md's ≤ 0.02 px), a band of
rows against the serial coordinates' rows bit for bit, the warp and the
model's coords knob, and streaming with coarse coordinates."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.geo import rpc as jrpc
from satmvs_tpu.ops import warp as jwarp
from satmvs_tpu.ops.coarse_coords import rpc_sweep_coords_coarse as jcoarse
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.infer.predict import streaming_red_forward
from satmvs_tpu_torch.models import CascadeMVSNet, CascadeREDNet
from satmvs_tpu_torch.models.cascade import build_stage_volume, build_train_volume
from satmvs_tpu_torch.ops import warp as twarp
from satmvs_tpu_torch.ops.coarse_coords import _lerp_upsample_axis, rpc_sweep_coords_coarse
from satmvs_tpu_torch.ops.depth_range import window_samples

H, W = 90, 93  # not multiples of the factor 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cams():
    """Stage-1 cameras of a synthetic pair (JAX's and the port's), the
    reference RPC."""
    rpcs = jsyn.make_rpc_triplet(4 * 96, 4 * 96, seed=3)
    pair = np.stack([rpcs[2], rpcs[0]])
    return (jwarp.build_stage_cams(pair, 0, 3)[0],
            twarp.build_stage_cams(pair, 0, "cpu", 3)[0], rpcs[2])


def _hyps(ref, kind: str) -> np.ndarray:
    if kind == "plane":
        lo, hi = jrpc.height_range(ref)
        return np.linspace(lo, hi, 8, dtype=np.float32)
    terrain = ref[jrpc.HEI_OFF] + 80.0 * np.random.default_rng(0).standard_normal(
        (H, W)).astype(np.float32)
    return window_samples(torch.from_numpy(terrain), 8, 5.0).numpy()


def test_lerp_upsample_is_exact_on_a_linear_field():
    c = torch.arange(0, 36, 4, dtype=torch.float32)[None]
    np.testing.assert_allclose(_lerp_upsample_axis(c, 4, -1, 32)[0].numpy(),
                               np.arange(32, dtype=np.float32), atol=1e-5)


@pytest.mark.parametrize("kind,exact_tol", [("plane", 5e-3), ("pixel", 2e-2)])
def test_coarse_matches_jax_and_the_exact_chain(cams, kind, exact_tol):
    """Per-plane heights (exact per plane) and per-pixel windows (the
    quadratic height fit) at 90×93: against JAX ≤ 1e-3 px, against the
    port's exact chain ≤ exact_tol."""
    jc, tc, ref = cams
    hyps = _hyps(ref, kind)
    got = rpc_sweep_coords_coarse(tc, 0, torch.from_numpy(hyps), H, W)
    want = jcoarse(jc, 0, jnp.asarray(hyps), H, W)
    exact = twarp.rpc_sweep_coords(tc, 0, torch.from_numpy(hyps), H, W)
    to_jax = max(np.abs(g.numpy() - np.asarray(w)).max() for g, w in zip(got, want))
    to_exact = torch.hypot(got[0] - exact[0], got[1] - exact[1]).max().item()
    print(f"[parity] coarse coordinates ({kind}): vs JAX {to_jax:.2e} px (tol 1e-3), vs exact "
          f"{to_exact:.2e} px (tol {exact_tol})")
    assert got[0].shape == (8, H, W) and got[0].dtype == torch.float32
    assert to_jax <= 1e-3 and to_exact <= exact_tol


def test_a_band_of_rows_gives_the_serial_rows(cams):
    """A band at row0 = 20 (a multiple of the factor) with the whole
    stage's hypotheses as its fit's window: the serial coordinates' rows,
    bit for bit; a row0 off the coarse grid raises."""
    _, tc, ref = cams
    hyps = torch.from_numpy(_hyps(ref, "pixel"))
    whole = rpc_sweep_coords_coarse(tc, 0, hyps, H, W)
    band = rpc_sweep_coords_coarse(tc, 0, hyps[:, 20:61], 41, W, row0=20, window=hyps)
    assert all(torch.equal(b, w[:, 20:61]) for b, w in zip(band, whole))
    with pytest.raises(ValueError, match="row0"):
        rpc_sweep_coords_coarse(tc, 0, hyps[:, 2:40], 38, W, row0=2, window=hyps)


def test_a_planes_window_evaluates_per_plane(cams):
    """(D, H, W) hypotheses of one height a plane with those heights as a
    (D,) window: the per-plane path's bits, closer to the exact chain than
    the quadratic fit over the whole height range (8.6e-4 against 3.4e-3
    px, measured; the model's first stage takes this path)."""
    _, tc, ref = cams
    planes = torch.from_numpy(_hyps(ref, "plane"))
    hyps = planes[:, None, None].expand(8, H, W).contiguous()
    got = rpc_sweep_coords_coarse(tc, 0, hyps, H, W, window=planes)
    want = rpc_sweep_coords_coarse(tc, 0, planes, H, W)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    exact = twarp.rpc_sweep_coords(tc, 0, planes, H, W)
    fit = rpc_sweep_coords_coarse(tc, 0, hyps, H, W)
    err = [torch.hypot(c[0] - exact[0], c[1] - exact[1]).max().item() for c in (got, fit)]
    print(f"[parity] coarse coordinates of planes: per plane {err[0]:.2e} px, quadratic fit "
          f"{err[1]:.2e} px from exact")
    assert err[0] < err[1]


def test_coarse_warp_matches_jax(cams):
    """rpc_warp(coords="coarse") against JAX's rpc_warp(method="xla",
    coords="coarse"): 2e-4 (the coordinates ~4e-5 px apart, a sample moves
    by up to ~8 × that on unit-normal features); an unknown coords
    raises."""
    jc, tc, ref = cams
    hyps = _hyps(ref, "pixel")[:, :48, :64]
    src = np.random.default_rng(2).normal(size=(48, 64, 8)).astype(np.float32)
    want = jwarp.rpc_warp(jnp.asarray(src), jc, 0, jnp.asarray(hyps), method="xla",
                          coords="coarse")
    got = twarp.rpc_warp(torch.from_numpy(src), tc, 0, torch.from_numpy(hyps), coords="coarse")
    err = np.abs(got.numpy() - np.asarray(want)).max()
    print(f"[parity] coarse rpc_warp vs JAX: {err:.2e} (tol 2e-4)")
    assert err <= 2e-4
    with pytest.raises(ValueError, match="coords"):
        twarp.rpc_warp(torch.from_numpy(src), tc, 0, torch.from_numpy(hyps), coords="fine")


@pytest.fixture(scope="module")
def batch():
    return tsyn.make_batch(1, 64, 32, seed=0, device="cpu")


def test_model_coords_knob(batch):
    """CascadeREDNet(coords="coarse") against the exact forward stage by
    stage, each coarse stage centred on the exact forward's previous depth,
    within the depth gates (mean ≤ 1 %, p99 ≤ 10 % of a step); both
    sweeps take the knob, a band of a stage's rows is the whole volume's,
    and QC cameras ignore it (the same bits as exact)."""
    a = (batch["imgs"], batch["cams"], batch["depth_values"])
    exact = CascadeREDNet(ndepths=(8, 4, 4), device="cpu", seed=1)
    coarse = CascadeREDNet(ndepths=(8, 4, 4), coords="coarse", device="cpu", seed=1)
    want = exact(*a)
    dv = batch["depth_values"]
    lo, hi = (float(x) for x in dv[0])
    steps = [(hi - lo) / 7, 4 * 5.0 / 3, 4 * 2.5 / 3]
    feats = coarse.features(batch["imgs"])
    for i, step in enumerate(steps, 1):
        prev = None if i == 1 else want[f"stage{i - 1}"]["depth"]
        got = coarse.stage(i - 1, feats[i - 1], batch["cams"][i - 1], dv[:, 0], dv[:, -1], prev)
        err = (got["depth"] - want[f"stage{i}"]["depth"]).abs() / step
        print(f"[parity] coarse forward stage{i} vs exact: mean {err.mean().item():.2e}, p99 "
              f"{torch.quantile(err, 0.99).item():.2e} of step (tol 0.01, 0.1)")
        assert err.mean() <= 0.01 and torch.quantile(err, 0.99) <= 0.1
    feats = feats[1]
    hyps = coarse.hypotheses(1, 16, 32, dv[:, 0], dv[:, -1], want["stage1"]["depth"], None)
    for build in (build_stage_volume, build_train_volume):
        extra = (None,) if build is build_train_volume else ()
        whole = build(feats, batch["cams"][1], hyps, *extra, coords="coarse")
        band = build(feats, batch["cams"][1], hyps[:, :, 8:], *extra, row0=8, coords="coarse",
                     window=hyps)
        assert torch.equal(band, whole[:, :, 8:])
    qc = tsyn.make_batch(1, 64, 32, seed=0, device="cpu", use_qc=True)
    qa = (qc["imgs"], qc["cams"], qc["depth_values"])
    assert torch.equal(exact(*qa)["depth"], coarse(*qa)["depth"])


def test_coarse_streaming_and_costreg(batch):
    """Streaming with coarse coordinates (each slab's hypotheses centre
    their own height fit, as JAX's slab calls do) against the coarse
    full-volume forward within the depth gates, and the coords argument
    overriding the model's; a CasMVS forward takes the knob too."""
    a = (batch["imgs"], batch["cams"], batch["depth_values"])
    model = CascadeREDNet(ndepths=(8, 4, 4), coords="coarse", device="cpu", seed=1)
    full = model(*a)
    lo, hi = (float(x) for x in batch["depth_values"][0])
    steps = [(hi - lo) / 7, 4 * 5.0 / 3, 4 * 2.5 / 3]
    for slab in (0, 4):
        out = streaming_red_forward(model, *a, slab=slab)
        for i, step in enumerate(steps, 1):
            err = (out[f"stage{i}"]["depth"] - full[f"stage{i}"]["depth"]).abs() / step
            assert err.mean() <= 0.01 and torch.quantile(err, 0.99) <= 0.1, (slab, i)
    exact = CascadeREDNet(ndepths=(8, 4, 4), device="cpu", seed=1)
    assert torch.equal(streaming_red_forward(model, *a, slab=4, coords="exact")["depth"],
                       streaming_red_forward(exact, *a, slab=4)["depth"])
    mvs = CascadeMVSNet(ndepths=(8, 8, 8), coords="coarse", device="cpu", seed=1)
    assert mvs.coords == "coarse" and bool(torch.isfinite(mvs(*a)["depth"]).all())
