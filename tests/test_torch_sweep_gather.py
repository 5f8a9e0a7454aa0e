"""The port's per-view sweep gather and its scatter adjoint
(satmvs_tpu_torch/ops/kernels/sweep_gather.py: the plain versions, which CPU
tensors take, and the autograd wiring) and its training warp
(`ops.warp.rpc_warp`) against the JAX package on the CPU: the Pallas
`sweep_gather` and `_sweep_scatter_impl_hcw` in interpret mode where the
stencil covers every tap, XLA `bilinear_sample` and `_bilinear_scatter`
everywhere, and `jax.vjp`.  Inputs come from numpy seeds."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.geo import rpc as jrpc
from satmvs_tpu.ops import warp as jwarp
from satmvs_tpu.ops.pallas import sweep_gather as sg
from satmvs_tpu.ops.sampling import bilinear_sample as jbilinear
from satmvs_tpu_torch.ops import warp as twarp
from satmvs_tpu_torch.ops.kernels.sweep_gather import (
    sweep_gather, sweep_gather_reference, sweep_scatter, sweep_scatter_reference)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


T = torch.from_numpy


def _rpc_coords(h, w, d, seed=1):
    """Smooth RPC sweep coordinates (S = 2, D, h, w) of a synthetic triplet,
    nadir reference, and the two views' JAX cameras."""
    rpcs = jsyn.make_rpc_triplet(4 * w, 4 * h, seed=seed)
    cams = jwarp.build_rpc_warp_cams(np.stack([rpcs[2], rpcs[0], rpcs[1]]), 0, stage_scale=0.25)
    lo, hi = jrpc.height_range(rpcs[2])
    depths = jnp.linspace(lo, hi, d, dtype=jnp.float32)
    coords = [jwarp.rpc_sweep_coords(cams, s, depths, h, w) for s in range(2)]
    return (np.stack([np.asarray(c[0]) for c in coords]),
            np.stack([np.asarray(c[1]) for c in coords]), cams, depths)


def _scattered(h, w, d, spread, seed):
    """Coordinates spread `spread` px past every edge, with far-off points."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-spread, w - 1 + spread, (d, h, w)).astype(np.float32)
    ys = rng.uniform(-spread, h - 1 + spread, (d, h, w)).astype(np.float32)
    xs.reshape(-1)[::37] = 1e9
    ys.reshape(-1)[::41] = -1e9
    return xs, ys


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _report(name, got, want, tol):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    print(f"[parity] {name}: {err:.2e} (tol {tol})")
    assert np.asarray(got).shape == np.asarray(want).shape
    assert err <= tol, f"{name}: {err} > {tol}"


def test_gather_matches_pallas_on_rpc_geometry():
    """Where the TPU stencil covers every tap (count_misses == 0, checked),
    the plain gather equals the Pallas kernel in interpret mode: 1e-5 on
    unit-normal features."""
    h, w, c, d = 32, 48, 8, 6
    xs, ys, _, _ = _rpc_coords(h, w, d)
    src = _rand((h, w, c), 2)
    for s in range(2):
        assert int(sg.count_misses(jnp.asarray(xs[s]), jnp.asarray(ys[s]), h, w).sum()) == 0
        want = sg.sweep_gather(jnp.asarray(src), jnp.asarray(xs[s]), jnp.asarray(ys[s]),
                               interpret=True)
        _report(f"gather vs Pallas view {s}", sweep_gather(T(src), T(xs[s]), T(ys[s])), want, 1e-5)


def test_gather_matches_bilinear_sample_everywhere():
    """Off-image and far-off samples included, where the TPU kernel's
    stencil would miss taps: equal to JAX bilinear_sample within 1e-6."""
    h, w, c, d = 10, 14, 6, 3
    xs, ys = _scattered(h, w, d, 4.0, 3)
    src = _rand((h, w, c), 4)
    want = jbilinear(jnp.asarray(src), jnp.asarray(xs), jnp.asarray(ys))
    before = sweep_gather.launches
    got = sweep_gather(T(src), T(xs), T(ys))
    assert sweep_gather.launches == before  # CPU tensors: the plain version
    _report("gather vs bilinear_sample", got, want, 1e-6)
    torch.testing.assert_close(got, sweep_gather_reference(T(src), T(xs), T(ys)), rtol=0, atol=0)


def test_gather_backward_matches_jax_vjp():
    """The autograd backward (the scatter) against jax.vjp of bilinear_sample,
    out-of-image samples included: 1e-5 on sums of O(10) unit terms."""
    h, w, c, d = 12, 16, 4, 5
    xs, ys = _scattered(h, w, d, 3.0, 5)
    src, g = _rand((h, w, c), 6), _rand((d, h, w, c), 7)
    _, vjp = jax.vjp(lambda s: jbilinear(s, jnp.asarray(xs), jnp.asarray(ys)), jnp.asarray(src))
    (want,) = vjp(jnp.asarray(g))
    src_t = T(src).requires_grad_(True)
    before = sweep_scatter.launches
    out = sweep_gather(src_t, T(xs), T(ys))
    (got,) = torch.autograd.grad(out, src_t, T(g))
    assert sweep_scatter.launches == before  # CPU tensors: the plain scatter
    _report("gather backward vs jax.vjp", got, want, 1e-5)


def test_scatter_matches_jax_scatters():
    """The plain scatter against `_bilinear_scatter` everywhere (1e-5) and,
    on covered RPC geometry, the Pallas scatter in interpret mode (1e-4:
    its sums run in window order)."""
    h, w, c, d = 32, 48, 8, 6
    xs, ys, _, _ = _rpc_coords(h, w, d, seed=2)
    g = _rand((d, h, w, c), 8)
    got = sweep_scatter(T(g), T(xs[0]), T(ys[0]))
    want = sg._sweep_scatter_impl(jnp.asarray(g), jnp.asarray(xs[0]), jnp.asarray(ys[0]), h, w,
                                  interpret=True)
    _report("scatter vs Pallas", got, want, 1e-4)
    xo, yo = _scattered(h, w, d, 4.0, 9)
    want = sg._bilinear_scatter(jnp.asarray(g), jnp.asarray(xo), jnp.asarray(yo), h, w)
    _report("scatter vs _bilinear_scatter", sweep_scatter(T(g), T(xo), T(yo)), want, 1e-5)
    torch.testing.assert_close(sweep_scatter(T(g), T(xo), T(yo)),
                               sweep_scatter_reference(T(g), T(xo), T(yo), h, w), rtol=0, atol=0)


@pytest.mark.parametrize("spread", [0.0, 5.0])
def test_scatter_is_the_adjoint_of_the_gather(spread):
    """<g, gather(src)> = <scatter(g), src> to 1e-5 relative (fp32 sums)."""
    h, w, c, d = 9, 13, 5, 4
    xs, ys = _scattered(h, w, d, spread, 10)
    src, g = T(_rand((h, w, c), 11)), T(_rand((d, h, w, c), 12))
    lhs = torch.sum(g.double() * sweep_gather(src, T(xs), T(ys)).double()).item()
    rhs = torch.sum(sweep_scatter(g, T(xs), T(ys)).double() * src.double()).item()
    print(f"[parity] adjoint spread {spread}: {abs(lhs - rhs) / abs(lhs):.2e} (tol 1e-5)")
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_wrappers_reject_what_the_kernels_do_not_take():
    src, xs, ys = T(_rand((6, 8, 4), 0)), T(_rand((2, 6, 8), 1)), T(_rand((2, 6, 8), 2))
    with pytest.raises(TypeError):
        sweep_gather(src.double(), xs, ys)
    with pytest.raises(ValueError):  # the grid is the source's extent
        sweep_gather(src[:5], xs, ys)
    with pytest.raises(ValueError):
        sweep_gather(src, xs, ys[:1])
    with pytest.raises(ValueError):
        sweep_scatter(T(_rand((2, 6, 8, 4), 3))[:, :5], xs, ys)


def test_rpc_warp_matches_jax():
    """The training warp against JAX rpc_warp(method="xla", coords="exact"),
    depth given as per-pixel hypotheses (D, h, w), and no gradient reaches
    the hypotheses through the coordinates.  The two packages' fp32
    coordinates are ~2e-5 px apart (tests/test_torch_ops.py), and a sample
    moves by up to (neighbour difference ≤ ~8 on unit-normal features) × the
    shift: 2e-4.  With out_dtype=bfloat16 both round their sample once to
    bf16: within 2e-4 plus one bf16 ulp of JAX's."""
    h, w, c, d = 16, 24, 8, 5
    _, _, cams, depths = _rpc_coords(h, w, d, seed=3)
    hyps = np.asarray(depths)[:, None, None] + _rand((d, h, w), 13)
    src = _rand((h, w, c), 14)
    tcams = twarp.RpcWarpCams(*(T(np.array(f)) for f in cams))
    for s in range(2):
        want = jwarp.rpc_warp(jnp.asarray(src), cams, s, jnp.asarray(hyps), method="xla",
                              coords="exact")
        hyp_t = T(hyps).requires_grad_(True)
        got = twarp.rpc_warp(T(src), tcams, s, hyp_t)
        _report(f"rpc_warp view {s}", got.detach(), want, 2e-4)
        assert not got.requires_grad
    for s in range(2):  # the reference's grid_sample stretch (torch_compat)
        want = jwarp.rpc_warp(jnp.asarray(src), cams, s, jnp.asarray(hyps), method="xla",
                              coords="exact", convention="torch")
        _report(f"rpc_warp convention=torch view {s}",
                twarp.rpc_warp(T(src), tcams, s, T(hyps), convention="torch"), want, 2e-4)
    for s in range(2):  # bf16 volumes: the same samples, each rounded once
        want = jwarp.rpc_warp(jnp.asarray(src), cams, s, jnp.asarray(hyps), method="xla",
                              coords="exact", out_dtype=jnp.bfloat16)
        got = twarp.rpc_warp(T(src), tcams, s, T(hyps), out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        _, e = np.frexp(np.abs(want))
        err = np.abs(got.float().numpy() - want) - np.ldexp(1.0, e - 8)
        print(f"[parity] rpc_warp bf16 view {s}: {err.max():.2e} beyond one bf16 ulp (tol 2e-4)")
        assert err.max() <= 2e-4
