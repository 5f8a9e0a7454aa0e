"""The training sweeps against the JAX package on the CPU: the fused sweep's
backward (`sweep_variance` under autograd: `sweep_variance_backward`'s plain
version, its cotangent volumes then `sweep_scatter_reference`) against
`jax.vjp` of the Pallas `sweep_variance` (interpret mode) where its stencil
covers every tap and of the per-view path everywhere; bf16 volume
transport (`sweep_gather` and `rpc_warp` with out_dtype=bfloat16, its VJP,
and what autograd saves); `train_fused_sweep=True` against the default
step; the per-view inference sweep (`fused_sweep=False`) of each family
against its default forward and, with bf16 volumes, against JAX
`model.apply`; and the CLIs' sweep flags.  Inputs come from numpy seeds;
every tolerance is stated in its test."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.geo import rpc as jrpc
from satmvs_tpu.models import build_model as jbuild
from satmvs_tpu.ops import warp as jwarp
from satmvs_tpu.ops.cost_volume import sweep_variance_volume as jsweep_variance_volume
from satmvs_tpu.ops.pallas import sweep_gather as jsg
from satmvs_tpu.ops.pallas.sweep_variance import sweep_variance as jsweep_variance
from satmvs_tpu.ops.sampling import bilinear_sample as jbilinear
from satmvs_tpu_torch.cli import predict as cli_predict
from satmvs_tpu_torch.cli import train as cli_train
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.models import build_model, cascade
from satmvs_tpu_torch.models.losses import cascade_loss
from satmvs_tpu_torch.ops import cost_volume
from satmvs_tpu_torch.ops.kernels import sweep_gather as sg
from satmvs_tpu_torch.ops.kernels import sweep_variance as sv
from satmvs_tpu_torch.params import load_jax_variables
from satmvs_tpu_torch.train import Config, create_model_and_state, make_train_step

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small ops, run beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rpc_coords(h, w, d, s=2, seed=1):
    """RPC sweep coordinates (S, D, h, w) of synthetic triplets, nadir
    reference: the two looks of seed's triplet, then those of seed + 17, ...
    (as chip_smoke's sweep inputs take more views)."""
    trips = [jsyn.make_rpc_triplet(4 * w, 4 * h, seed=seed + 17 * k) for k in range(-(-s // 2))]
    rpcs = np.stack([trips[0][2]] + [trips[k // 2][k % 2] for k in range(s)])
    cams = jwarp.build_rpc_warp_cams(rpcs, 0, stage_scale=0.25)
    lo, hi = jrpc.height_range(rpcs[0])
    depths = jnp.linspace(lo, hi, d, dtype=jnp.float32)
    coords = [jwarp.rpc_sweep_coords(cams, i, depths, h, w) for i in range(s)]
    return (np.stack([np.asarray(c[0]) for c in coords]),
            np.stack([np.asarray(c[1]) for c in coords]))


def _scattered(s, d, h, w, seed):
    """Coordinates over and 3 px beyond every edge, some far off."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-3, w + 2, (s, d, h, w)).astype(np.float32)
    ys = rng.uniform(-3, h + 2, (s, d, h, w)).astype(np.float32)
    xs.reshape(-1)[::37] = 1e9
    ys.reshape(-1)[::41] = -1e9
    return xs, ys


def _port_vjp(ref, srcs, xs, ys, g):
    """The port's fused sweep under autograd (CPU: the plain backward):
    (dref, dsrcs) for the cotangent g."""
    r, s = T(ref).requires_grad_(True), T(srcs).requires_grad_(True)
    before = (sv.sweep_variance_backward.launches, sg.sweep_scatter.launches)
    out = sv.sweep_variance(r, s, T(xs), T(ys))
    grads = torch.autograd.grad(out, [r, s], T(g))
    assert (sv.sweep_variance_backward.launches, sg.sweep_scatter.launches) == before
    return [x.numpy() for x in grads]


def _report(name, got, want, tol):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    print(f"[parity] {name}: {err:.2e} (tol {tol})")
    assert np.asarray(got).shape == np.asarray(want).shape
    assert err <= tol, f"{name}: {err} > {tol}"


def test_fused_backward_matches_pallas_vjp():
    """On RPC geometry the TPU stencil covers (count_misses == 0, checked;
    h a multiple of 8): the plain backward against jax.vjp of the Pallas
    `sweep_variance` in interpret mode (layout "nhwc": its VJP re-gathers
    with row 2's kernel and scatters with row 3's), S = 2, 16×32, D 4, C 8:
    1e-4 (the Pallas scatter sums in window order, test_torch_sweep_gather)."""
    h, w, d, c = 16, 32, 4, 8
    xs, ys = _rpc_coords(h, w, d)
    for s in range(2):
        assert int(jsg.count_misses(jnp.asarray(xs[s]), jnp.asarray(ys[s]), h, w).sum()) == 0
    ref, srcs, g = _rand((h, w, c), 1), _rand((2, h, w, c), 2), _rand((d, h, w, c), 3)
    _, vjp = jax.vjp(lambda r, s: jsweep_variance(r, s, jnp.asarray(xs), jnp.asarray(ys), 8, 8,
                                                  True), jnp.asarray(ref), jnp.asarray(srcs))
    want = vjp(jnp.asarray(g))
    got = _port_vjp(ref, srcs, xs, ys, g)
    _report("fused backward dref vs Pallas vjp", got[0], want[0], 1e-4)
    _report("fused backward dsrcs vs Pallas vjp", got[1], want[1], 1e-4)


@pytest.mark.parametrize("s", [2, 5])
def test_fused_backward_matches_per_view_vjp(s):
    """Everywhere, off-image and far-off samples included: against jax.vjp of
    JAX's per-view path (`sweep_variance_volume` over `bilinear_sample`, what
    rpc_warp(method="xla", coords="exact") samples with) on the same
    coordinates, at S = 2 and at S = 5 (more views than the kernel unrolls):
    1e-5 on sums of up to 4·D O(1) terms."""
    h, w, d, c = 9, 13, 4, 6
    xs, ys = _scattered(s, d, h, w, 10 + s)
    ref, srcs, g = _rand((h, w, c), 4), _rand((s, h, w, c), 5), _rand((d, h, w, c), 6)

    def per_view(r, srcs_):
        return jsweep_variance_volume(
            r, srcs_, lambda sf, i: jbilinear(sf, jnp.asarray(xs[i]), jnp.asarray(ys[i])))

    _, vjp = jax.vjp(per_view, jnp.asarray(ref), jnp.asarray(srcs))
    want = vjp(jnp.asarray(g))
    got = _port_vjp(ref, srcs, xs, ys, g)
    _report(f"fused backward S={s} dref vs per-view vjp", got[0], want[0], 1e-5)
    _report(f"fused backward S={s} dsrcs vs per-view vjp", got[1], want[1], 1e-5)


def test_batched_backward_is_per_sample_and_coordinates_get_none():
    """sweep_variance_batched's gradient at B = 2 is each sample's alone, bit
    for bit; the coordinates get no gradient (as in JAX); the backward
    kernel's wrapper takes its plain version for CPU tensors, which is the
    whole VJP: its cotangent volumes scattered by sweep_scatter."""
    b, s, d, h, w, c = 2, 2, 3, 7, 11, 4
    feats = T(_rand((b, s + 1, h, w, c), 8))
    xs, ys = (T(np.stack([_scattered(s, d, h, w, 20 + i)[k] for i in range(b)]))
              for k in (0, 1))
    g = T(_rand((b, d, h, w, c), 9))
    f = feats.clone().requires_grad_(True)
    xs_g = xs.clone().requires_grad_(True)
    out = sv.sweep_variance_batched(f, xs_g, ys)
    got, gx = torch.autograd.grad(out, [f, xs_g], g, allow_unused=True)
    assert gx is None or not bool(gx.any())
    for i in range(b):
        fi = feats[i].clone().requires_grad_(True)
        (want,) = torch.autograd.grad(sv.sweep_variance(fi[0], fi[1:], xs[i], ys[i]), fi, g[i])
        assert torch.equal(got[i], want)
    dref, dsrcs = sv.sweep_variance_backward(feats, xs, ys, g)
    wdref, wdsrcs = sv.sweep_variance_backward_reference(feats, xs, ys, g)
    assert torch.equal(dref, wdref) and torch.equal(dsrcs, wdsrcs)
    assert torch.equal(got[:, 0], dref)
    gs, _ = sv._backward_reference(feats[:, 0], feats[:, 1:], xs, ys, g)
    dsrc = torch.stack([torch.stack([sg.sweep_scatter_reference(gs[i, k], xs[i, k], ys[i, k], h, w)
                                     for k in range(s)]) for i in range(b)])
    assert torch.equal(got[:, 1:], dsrc) and torch.equal(dsrcs, dsrc)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place of each value (x's values are bf16)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8).astype(np.float32)


def _ulps(name, got: torch.Tensor, want, f32_tol: float) -> None:
    """got (bf16) within one bf16 ulp of want (a JAX bf16 array) plus the
    fp32 samples' own tolerance `f32_tol` (where a sample cancels to near 0,
    that is many of its ulps)."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = np.abs(got.float().numpy() - want)
    frac = float((err > 0).mean())
    print(f"[parity] {name}: {frac:.2e} of the values apart, the largest "
          f"{float((err - _bf16_ulp(want)).max()):.2e} beyond one bf16 ulp (tol {f32_tol})")
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool((err <= _bf16_ulp(want) + f32_tol).all()), name


def test_bf16_gather_matches_jax_xla_and_pallas():
    """sweep_gather(out_dtype=bfloat16) on JAX's RPC coordinates against JAX
    rpc_warp(..., out_dtype=bfloat16, method="xla") and, where the stencil
    covers every tap (count_misses == 0), the Pallas sweep_gather(out_dtype=
    bfloat16, interpret=True): each within one bf16 ulp (both round an fp32
    sample once; a value near a rounding boundary may round the other way)
    plus the fp32 gathers' own tolerances of tests/test_torch_sweep_gather.py,
    1e-6 against bilinear_sample and 1e-5 against the Pallas kernel."""
    h, w, d, c = 16, 24, 5, 8
    rpcs = jsyn.make_rpc_triplet(4 * w, 4 * h, seed=3)
    cams = jwarp.build_rpc_warp_cams(np.stack([rpcs[2], rpcs[0], rpcs[1]]), 0, 0.25)
    lo, hi = jrpc.height_range(rpcs[2])
    depths = jnp.linspace(lo, hi, d, dtype=jnp.float32)
    src = _rand((h, w, c), 11)
    for s in range(2):
        xs, ys = (np.array(a) for a in jwarp.rpc_sweep_coords(cams, s, depths, h, w))
        got = sg.sweep_gather(T(src), T(xs), T(ys), torch.bfloat16)
        want = jwarp.rpc_warp(jnp.asarray(src), cams, s, depths, method="xla", coords="exact",
                              out_dtype=jnp.bfloat16)
        _ulps(f"bf16 gather view {s} vs JAX rpc_warp", got, want, 1e-6)
        assert int(jsg.count_misses(jnp.asarray(xs), jnp.asarray(ys), h, w).sum()) == 0
        want = jsg.sweep_gather(jnp.asarray(src), jnp.asarray(xs), jnp.asarray(ys),
                                interpret=True, out_dtype=jnp.bfloat16)
        _ulps(f"bf16 gather view {s} vs Pallas", got, want, 1e-5)


def test_bf16_gather_vjp_matches_jax():
    """The VJP with a bf16 cotangent (the bf16 scatter's plain version: the
    cotangent widened exactly, then scattered in fp32) against jax.vjp of
    bilinear_sample cast to bf16, off-image samples included: 1e-5; the
    source's cotangent is fp32, the coordinates get none."""
    h, w, d, c = 12, 16, 5, 4
    xs, ys = _scattered(1, d, h, w, 12)
    xs, ys = xs[0], ys[0]
    src = _rand((h, w, c), 13)
    g = jnp.asarray(_rand((d, h, w, c), 14)).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda s: jbilinear(s, jnp.asarray(xs), jnp.asarray(ys)).astype(jnp.bfloat16),
                     jnp.asarray(src))
    (want,) = vjp(g)
    src_t = T(src).requires_grad_(True)
    out = sg.sweep_gather(src_t, T(xs), T(ys), torch.bfloat16)
    gt = T(np.array(g.astype(jnp.float32))).to(torch.bfloat16)
    (got,) = torch.autograd.grad(out, src_t, gt)
    assert got.dtype == torch.float32
    _report("bf16 gather vjp vs jax.vjp", got, want, 1e-5)


def test_bf16_per_view_sweep_saves_the_bf16_views():
    """Autograd keeps the per-view sweep's bf16 views, not fp32 copies of
    them: of the distinct volume-sized tensors (D, h, w, C) that one stage's
    bf16 sweep saves for its backward, the S warped views are bf16 and the
    only fp32 one is the mean (which the fp32 sweep keeps too); the fp32
    sweep saves its S fp32 views and the mean.  The bf16 volume's cotangent
    reaches the views rounded to bf16 (JAX's convert_element_type
    transpose)."""
    b = tsyn.make_batch(1, 64, 32, seed=0, device="cpu")
    feats = torch.randn((1, 3, 8, 16, 8), generator=torch.Generator().manual_seed(0),
                        requires_grad=True)
    hyps = cascade.stage_hypotheses(8, 8, 16, b["depth_values"][:, 0], b["depth_values"][:, 1],
                                    10.0)
    saved = {}
    for dtype in (torch.bfloat16, None):
        seen = []

        def pack(t, seen=seen):
            if t.shape[-4:] == (8, 8, 16, 8) and all(t.data_ptr() != p for _, p in seen):
                seen.append((t.dtype, t.data_ptr()))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            vol = cascade.build_train_volume(feats, b["cams"][0], hyps, dtype)
        saved[dtype] = sorted(str(dt) for dt, _ in seen)
        assert vol.dtype == torch.float32
        torch.autograd.grad(vol.sum(), feats)
    assert saved[torch.bfloat16] == ["torch.bfloat16", "torch.bfloat16", "torch.float32"]
    assert saved[None] == ["torch.float32"] * 3
    wv = torch.tensor([[1.5, -2.0]], dtype=torch.bfloat16, requires_grad=True)
    w32, sq = cost_volume.view_moments(wv)
    (gw,) = torch.autograd.grad((w32 * 1e-3 + sq * 1.0001).sum(), wv)
    assert gw.dtype == torch.bfloat16
    assert torch.equal(gw, (1e-3 + 2 * 1.0001 * wv.float()).to(torch.bfloat16))


def test_train_fused_sweep_step_equals_the_default_step(monkeypatch):
    """SATMVS_TRAIN_FUSED_SWEEP=1, read once when the model is built, trains
    on the fused sweep; its train step against the default (per-view) step
    from the same weights and batch at 32×64, ndepths (8, 4, 4): the same
    function (on the CPU both sample with bilinear_sample; the backwards
    differ: the fused one's plain backward against autograd through the
    per-view sweep): the eval-mode loss and the step's loss the same bits
    (the same forward), every eval-mode gradient and every parameter after
    the step within 5e-5 relative (norm per tensor; measured 1.3e-5 in a
    FeatureNet weight's gradient: the fused backward forms the variance's
    adjoint as (2/V)(f − m)·g, as JAX's does, autograd differentiates
    Σf²/V − m², and the rounding apart is carried back through three stages
    into the FeatureNet)."""
    batch = tsyn.make_batch(1, 64, 32, seed=0, device="cpu")
    cfg = Config(ndepths=(8, 4, 4), fused_red=False)
    runs = {}
    for env in ("1", "0"):
        monkeypatch.setenv("SATMVS_TRAIN_FUSED_SWEEP", env)
        model, state, tx = create_model_and_state(cfg, batch, 2)
        assert model.train_fused_sweep == (env == "1")
        names = list(state.params)
        out = model.run_cascade(batch["imgs"], batch["cams"], batch["depth_values"], False)
        loss = cascade_loss(out, batch["depth_stages"], batch["mask_stages"], cfg.dlossw)[0]
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
        state, scalars = make_train_step(model, tx, cfg.dlossw)(state, batch)
        runs[env] = (loss.item(), scalars["loss"].item(), dict(zip(names, grads)),
                     {k: v.detach().clone() for k, v in state.params.items()})
    fused, default = runs["1"], runs["0"]
    assert fused[:2] == default[:2]
    worst, where = 0.0, None
    for k in (2, 3):
        for n, want in default[k].items():
            rel = (fused[k][n] - want).norm().item() / max(want.norm().item(), 1e-30)
            if rel > worst:
                worst, where = rel, n
    print(f"[parity] train_fused_sweep step vs default: gradients and parameters max relative "
          f"norm {worst:.2e} ({where}) (tol 5e-5)")
    assert worst <= 5e-5


def test_bf16_volume_step_tracks_the_fp32_step():
    """Config(volume_dtype="bfloat16") trains (the fast counterpart of
    tests/test_torch_train_costreg.py's `slow` comparison with JAX's bf16
    step): from the same weights and batch at 32×64, ndepths (8, 4, 4), its
    eval-mode loss within 1e-3 relative of the fp32 step's (measured
    1.6e-4) and its eval-mode gradients within 5e-2 relative norm over all
    parameters (measured 1.3e-2: the views and their cotangents rounded to
    bf16); the train step's scalars finite."""
    b = tsyn.make_batch(1, 64, 32, seed=0, device="cpu")
    runs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = Config(ndepths=(8, 4, 4), fused_red=False, volume_dtype=dtype)
        model, state, tx = create_model_and_state(cfg, b, 2)
        assert model.volume_dtype == (torch.bfloat16 if dtype == "bfloat16" else None)
        out = model.run_cascade(b["imgs"], b["cams"], b["depth_values"], False)
        loss = cascade_loss(out, b["depth_stages"], b["mask_stages"], cfg.dlossw)[0]
        names = [n for n in state.params if not n.endswith("head.bias")]
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
        _, scalars = make_train_step(model, tx, cfg.dlossw)(state, b)
        assert all(bool(torch.isfinite(v)) for v in scalars.values())
        runs[dtype] = (loss.item(), grads)
    (l32, g32), (l16, g16) = runs["float32"], runs["bfloat16"]
    num = sum((a - w).norm().item() ** 2 for a, w in zip(g16, g32))
    rel = (num / sum(w.norm().item() ** 2 for w in g32)) ** 0.5
    print(f"[parity] bf16 step vs fp32 step: loss {abs(l16 - l32) / abs(l32):.2e} relative "
          f"(tol 1e-3), eval-mode gradients {rel:.2e} over all (tol 5e-2)")
    assert abs(l16 - l32) <= 1e-3 * abs(l32) and rel <= 5e-2


@pytest.mark.parametrize("name", ["red", "casmvs", "ucs"])
def test_per_view_inference_sweep_equals_the_fused_one(name):
    """fused_sweep=False at inference builds every stage's volume with the
    per-view sweep (build_train_volume, no graph); on the CPU both sweeps are
    bilinear_sample and the same moments, so each family's forward equals
    its default forward bit for bit, B = 2."""
    model = build_model(name, "rpc", ndepths=(8, 8, 8), device="cpu", seed=2)
    b = tsyn.make_batch(2, 64, 32, seed=1, device="cpu")
    want = model(b["imgs"], b["cams"], b["depth_values"])
    calls = []
    model.fused_sweep = False
    orig = cascade.build_train_volume
    try:
        cascade.build_train_volume = lambda *a: calls.append(1) or orig(*a)
        got = model(b["imgs"], b["cams"], b["depth_values"])
    finally:
        cascade.build_train_volume = orig
    assert len(calls) == 3
    for key in want:
        if isinstance(want[key], dict):
            for k, v in want[key].items():
                assert torch.equal(got[key][k], v), (key, k)


def test_per_view_bf16_forward_matches_jax():
    """fused_sweep=False with bf16 volumes against JAX `model.apply` of
    CascadeREDNet(volume_dtype=bfloat16) (on the CPU JAX takes the per-view
    path), the same numpy-seeded flax weights at 32×64, ndepths (8, 4, 4):
    each stage's depth within a mean of 1 % and a p99 of 10 % of its
    hypothesis step (the depth gates of the other forward parity tests)."""
    jb = jsyn.make_batch(1, 64, 32, seed=0, with_gt=False)
    jm = jbuild("red", "rpc", ndepths=(8, 4, 4), volume_dtype=jnp.bfloat16, fused_red=False)
    args = (jnp.asarray(jb["imgs"]), jb["cams"], jnp.asarray(jb["depth_values"]))
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a, train=False), *args)
    rng = np.random.default_rng(4)

    def draw(path, s):
        name = getattr(path[-1], "key", None)
        if name == "kernel":
            return rng.normal(0.0, 1.0 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        if name in ("scale", "var"):
            return 1.0 + 0.2 * rng.uniform(-1, 1, s.shape)
        return 0.1 * rng.normal(size=s.shape)

    v = jax.tree_util.tree_map_with_path(lambda p, s: np.asarray(draw(p, s), np.float32), shapes)
    want = jax.tree.map(np.asarray, jax.jit(lambda vv, *a: jm.apply(vv, *a, train=False))(
        v, *args))
    model = load_jax_variables(build_model("red", "rpc", ndepths=(8, 4, 4), fused_sweep=False,
                                           volume_dtype=torch.bfloat16, device="cpu"), v)
    tb = tsyn.make_batch(1, 64, 32, seed=0, device="cpu")
    got = model(tb["imgs"], tb["cams"], tb["depth_values"])
    lo, hi = (float(x) for x in jb["depth_values"][0])
    steps = [(hi - lo) / 7, 4 * 5.0 / 3, 4 * 2.5 / 3]
    for i, step in enumerate(steps, start=1):
        err = np.abs(got[f"stage{i}"]["depth"].numpy() - want[f"stage{i}"]["depth"]) / step
        mean, p99 = float(err.mean()), float(np.quantile(err, 0.99))
        print(f"[parity] per-view bf16 forward stage{i}: depth err mean {mean:.2e}, p99 "
              f"{p99:.2e} of a step (tol 0.01, 0.1)")
        assert mean <= 0.01 and p99 <= 0.1


def test_clis_pass_the_sweep_flags_on(tmp_path, monkeypatch):
    """`cli.train --volume_dtype bfloat16 --fused_sweep=off` trains an epoch
    on a model with both knobs set (the per-view sweep with bf16 volumes),
    and `cli.predict --fused_sweep=off` predicts through the per-view sweep
    (every stage's volume from build_train_volume), its maps a direct
    forward of the restored model bit for bit."""
    from satmvs_tpu_torch.cli import restore_model
    from satmvs_tpu_torch.data import formats
    from satmvs_tpu_torch.data.dataset import MVSDataset
    from satmvs_tpu_torch.data.loader import Loader
    from satmvs_tpu_torch.train import loop

    monkeypatch.setenv("SATMVS_PLATFORM", "cpu")
    root = str(tmp_path / "WHU_TLC")
    tsyn.write_whu_tlc_tree(root, num_train=1, num_test=1, width=32, height=32, h_amp=40.0,
                            h_scale=120.0)
    built = []
    orig = loop.create_model

    def spy(*a, **k):
        model = orig(*a, **k)
        built.append(model)
        return model

    monkeypatch.setattr(loop, "create_model", spy)
    logdir = str(tmp_path / "logs")
    out = cli_train.main(["--mode=train", f"--dataset_root={root}", f"--logdir={logdir}",
                          "--ndepths", "8,4,4", "--epochs", "1", "--volume_dtype", "bfloat16",
                          "--fused_sweep=off"])
    assert out["timing"]["epochs"] == [1]
    assert built[-1].volume_dtype == torch.bfloat16 and built[-1].fused_sweep is False
    testpath = os.path.join(root, "open_dataset_rpc", "test")
    ckpt = os.path.join(logdir, "red", "rpc")
    calls = []
    per_view = cascade.build_train_volume
    monkeypatch.setattr(cascade, "build_train_volume", lambda *a: calls.append(1) or per_view(*a))
    res = cli_predict.main([f"--dataset_root={testpath}", f"--loadckpt={ckpt}", "--ndepths",
                            "8,4,4", "--fused_sweep=off"])
    assert len(calls) == 3 * len(res["written"]) and built[-1].fused_sweep is False
    cfg = Config(ndepths=(8, 4, 4), fused_sweep=False)
    model, _, _ = restore_model(cfg, ckpt, torch.device("cpu"))
    for batch in Loader(MVSDataset(testpath, "pred"), 1, device="cpu"):
        want = model(batch["imgs"], batch["cams"], batch["depth_values"])
        view, block = batch["out_view"][0], batch["out_name"][0]
        got = formats.load_pfm(os.path.join(testpath, "mvs_results", view, "init",
                                            f"{block}.pfm"))
        np.testing.assert_array_equal(got, want["depth"][0].numpy())
