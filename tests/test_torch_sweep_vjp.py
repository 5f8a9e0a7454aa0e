"""The fused sweep's VJP as one kernel (csrc/sweep_variance.cu
`sweep_variance_backward_kernel` and `sweep_variance_backward_groups_kernel`)
through a torch emulation of its accumulation, on the CPU without a
compiler or a card.

The emulation follows a thread of the kernel, vectorised over pixels and
channels: it walks the D planes in order, samples every view, forms the
mean, the reference's term and each carried view's cotangent, and holds the
four corner sums of each view's floor corner.  When the corner stays it
adds to them; when it moves one column with the same row it flushes the
column that leaves and shifts the shared column into place; on any other
move it flushes all four, and at the end what is left; corners off the
image are skipped.  Up to four views are carried in one walk; beyond four,
one walk a pair of views, the mean recomputed each walk and dref summed on
the first.  Its terms are the plain VJP's (`_backward_reference`'s
cotangents times the scatter's weights), so against the port's plain VJP
it differs only in the order of each dsrcs element's sum: the summation
bound of csrc/sweep_gather.cu, 2·(4·D − 1)·2⁻²⁴ × the sum of the
magnitudes of its terms.  Against JAX (`jax.vjp` of the Pallas
`sweep_variance` in interpret mode, and of the per-view path) it is held to
the tolerances of tests/test_torch_sweep_train.py.  The emulation also
counts the kernel's float4 atomics: at the three stage shapes of a 384×768
train step (chip_smoke.py's RPC coordinates) the column carry issues about
half the atomics of the fp32 scatter's runs of planes, which flush all four
corners whenever the corner moves."""

import ctypes
import functools
import importlib.util
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satmvs_tpu.ops.cost_volume import sweep_variance_volume as jsweep_variance_volume
from satmvs_tpu.ops.pallas import sweep_gather as jsg
from satmvs_tpu.ops.pallas.sweep_variance import sweep_variance as jsweep_variance
from satmvs_tpu.ops.sampling import bilinear_sample as jbilinear
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.geo import rpc as trpc
from satmvs_tpu_torch.ops import warp as twarp
from satmvs_tpu_torch.ops.kernels import sweep_gather as sg
from satmvs_tpu_torch.ops.kernels import sweep_variance as sv
from satmvs_tpu_torch.ops.sampling import bilinear_sample

T = torch.from_numpy
ROOT = Path(__file__).resolve().parents[1]
UNROLLED = 4  # views the kernel carries in one walk; beyond, a walk a pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small ops, run beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def taps(x, y, hs, w):
    """bilinear.cuh `Taps` of one plane's samples: floor corners (clamped as
    the kernel clamps them) and the four weights in Taps order."""
    fx, fy = torch.floor(x), torch.floor(y)
    wx, wy = x - fx, y - fy
    x0 = fx.clamp(-2, w).to(torch.int64)
    y0 = fy.clamp(-2, hs).to(torch.int64)
    return x0, y0, torch.stack([(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx], -1)


LEFT, RIGHT, ALL = (0, 2), (1, 3), (0, 1, 2, 3)  # corners of a column, in Taps order


def flush(dsrc, x0, y0, sums, moved, corners, hs, w):
    """Adds sums[p, k] (P, 4, C) of the pixels `moved` into dsrc (hs·w, C) at
    corner k of (x0, y0) for k in `corners` where it lies in the image, and
    zeroes them; returns the corners added (the kernel's float4 atomics a
    group of four channels)."""
    added = 0
    for k in corners:
        x, y = x0 + (k & 1), y0 + (k >> 1)
        ok = moved & (x >= 0) & (x < w) & (y >= 0) & (y < hs)
        dsrc.index_add_(0, (y * w + x)[ok], sums[ok, k])
        sums[moved, k] = 0.0
        added += int(ok.sum())
    return added


class Carry:
    """One view's carried state for all pixels of a sample: the floor corner
    of its last sample (−3: none) and the sums of its four corners."""

    def __init__(self, p, c):
        self.x0 = torch.full((p,), -3, dtype=torch.int64)
        self.y0 = torch.full((p,), -3, dtype=torch.int64)
        self.sums = torch.zeros((p, 4, c))
        self.moves = {"stay": 0, "column": 0, "other": 0}

    def move_to(self, x0, y0, dsrc, hs, w):
        """The kernel's `move_to`: returns the atomics it issues."""
        same_row = y0 == self.y0
        right = same_row & (x0 == self.x0 + 1)
        left = same_row & (x0 == self.x0 - 1)
        stay = same_row & (x0 == self.x0)
        other = ~(stay | right | left)
        added = flush(dsrc, self.x0, self.y0, self.sums, right, LEFT, hs, w)
        added += flush(dsrc, self.x0, self.y0, self.sums, left, RIGHT, hs, w)
        added += flush(dsrc, self.x0, self.y0, self.sums, other, ALL, hs, w)
        for to, frm, sel in ((0, 1, right), (1, 0, left)):  # the shared column shifts
            for r in (0, 2):
                self.sums[sel, r + to] = self.sums[sel, r + frm]
                self.sums[sel, r + frm] = 0.0
        self.x0, self.y0 = x0, y0
        self.moves["stay"] += int(stay.sum())
        self.moves["column"] += int((right | left).sum())
        self.moves["other"] += int(other.sum())
        return added


def walks(s, unrolled=UNROLLED):
    """The carried views of each walk over the planes: all of them up to
    `unrolled`, else pairs (the last alone when S is odd)."""
    if s <= unrolled:
        return [list(range(s))]
    return [list(range(s0, min(s0 + 2, s))) for s0 in range(0, s, 2)]


def emulate(feats, xs, ys, g, row0=0, unrolled=UNROLLED):
    """The kernel's VJP of feats (B, V, Hs, W, C) (view 0 the reference; its
    rows row0 .. row0 + H − 1 the band of the grid) at xs/ys (B, S, D, H, W)
    for the volume's cotangent g (B, D, H, W, C) → dref (B, H, W, C), dsrcs
    (B, S, Hs, W, C), the float4 atomics a group of four channels, and the
    corner moves {stay, column, other} over all samples; `unrolled`: the
    most views one walk carries."""
    b, v, hs, w, c = feats.shape
    s, d, h = xs.shape[1], xs.shape[2], xs.shape[3]
    scale = 2.0 / v
    dref = torch.zeros((b, h * w, c))
    dsrcs = torch.zeros((b, s, hs * w, c))
    atomics, moves = 0, {"stay": 0, "column": 0, "other": 0}
    for i in range(b):
        r = feats[i, 0, row0:row0 + h].reshape(h * w, c)
        for n, carried in enumerate(walks(s, unrolled)):
            carry = {k: Carry(h * w, c) for k in carried}
            for p in range(d):
                gv = g[i, p].reshape(h * w, c)
                samples = [bilinear_sample(feats[i, 1 + k], xs[i, k, p], ys[i, k, p]).reshape(
                    h * w, c) for k in range(s)]
                mean = r
                for smp in samples:  # the plain version's order: the reference, then each view
                    mean = mean + smp
                mean = mean / v
                if n == 0:
                    dref[i] += gv * (scale * (r - mean))
                for k in carried:
                    x0, y0, wt = taps(xs[i, k, p].reshape(-1), ys[i, k, p].reshape(-1), hs, w)
                    atomics += carry[k].move_to(x0, y0, dsrcs[i, k], hs, w)
                    cot = gv * (scale * (samples[k] - mean))
                    carry[k].sums += wt[:, :, None] * cot[:, None, :]
            for k in carried:
                every = torch.ones(h * w, dtype=torch.bool)
                atomics += flush(dsrcs[i, k], carry[k].x0, carry[k].y0, carry[k].sums, every,
                                 ALL, hs, w)
                moves = {m: moves[m] + carry[k].moves[m] for m in moves}
    return dref.reshape(b, h, w, c), dsrcs.reshape(b, s, hs, w, c), atomics, moves


def bound(feats, xs, ys, g, row0=0):
    """The summation bound of each dsrcs element, from the plain cotangent
    volumes."""
    gs, _ = sv._backward_reference(feats[:, 0, row0:row0 + xs.shape[3]], feats[:, 1:], xs, ys, g)
    return _chip_smoke().summation_bound(gs, xs, ys, feats.shape[2]) + 1e-30


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _coords(mode, b, s, d, h, w, hs=None, seed=0):
    """xs, ys (B, S, D, H, W) over an hs-row source: "window", planes 0.45 px
    apart along a row (left or right by view) around a random shift of each
    pixel, with a slow drift down the rows, so the floor corner stays, moves
    one column or moves a row; "off-image", uniform over and beyond the
    image, some far off."""
    rng = np.random.default_rng(seed)
    hs = hs or h
    if mode == "window":
        gx, gy = np.meshgrid(np.arange(w), np.arange(h))
        step = 0.45 * np.arange(d)[:, None, None] * rng.choice([-1, 1], (b, s, 1, 1, 1))
        xs = gx + rng.uniform(-3, 3, (b, s, 1, h, w)) + step
        ys = gy + rng.uniform(-0.5, 0.5, (b, s, 1, h, w)) + 0.3 * np.arange(d)[:, None, None] / d
        xs, ys = np.broadcast_arrays(xs, ys)
    else:
        xs = rng.uniform(-2, w + 1, (b, s, d, h, w))
        ys = rng.uniform(-2, hs + 1, (b, s, d, h, w))
        xs.reshape(-1)[::37] = 1e9
        ys.reshape(-1)[::41] = -1e9
    return (np.ascontiguousarray(xs, dtype=np.float32), np.ascontiguousarray(ys, dtype=np.float32))


def _held(name, got, want, tol):
    err = (got - want).abs()
    t_max = tol.max().item() if isinstance(tol, torch.Tensor) else tol
    print(f"[vjp] {name}: max abs err {err.max().item():.3e} (tol up to {t_max:.3e})")
    assert got.shape == want.shape
    assert bool((err <= tol).all()), name


def _per_view_vjp(feats, xs, ys, g, row0=0):
    """jax.vjp of JAX's per-view path (`sweep_variance_volume` over
    `bilinear_sample`) for one sample: feats (V, Hs, W, C), xs/ys (S, D, H,
    W), g (D, H, W, C) → (dref (H, W, C), dsrcs (S, Hs, W, C))."""
    h = xs.shape[2]

    def per_view(r, srcs):
        return jsweep_variance_volume(
            r, srcs, lambda sf, i: jbilinear(sf, jnp.asarray(xs[i]), jnp.asarray(ys[i])))

    _, vjp = jax.vjp(per_view, jnp.asarray(feats[0, row0:row0 + h]), jnp.asarray(feats[1:]))
    return [T(np.array(a)) for a in vjp(jnp.asarray(g))]


def test_emulation_matches_pallas_vjp():
    """On RPC geometry the TPU stencil covers (count_misses == 0, checked;
    16×32, D 4, C 8, S = 2): the emulated kernel against jax.vjp of the
    Pallas `sweep_variance` in interpret mode (its VJP re-gathers with row
    2's kernel and scatters with row 3's; jitted, one compile instead of an
    interpreted grid step by step), 1e-4 (the Pallas scatter sums in window
    order)."""
    h, w, d, c = 16, 32, 4, 8
    trip = tsyn.make_rpc_triplet(4 * w, 4 * h, seed=1)
    cams = twarp.build_rpc_warp_cams(np.stack([trip[2], trip[0], trip[1]]), 0, 0.25, device="cpu")
    lo, hi = trpc.height_range(trip[2])
    coords = [twarp.rpc_sweep_coords(cams, i, torch.linspace(lo, hi, d), h, w) for i in range(2)]
    xs = np.stack([q[0].numpy() for q in coords])
    ys = np.stack([q[1].numpy() for q in coords])
    misses = jax.jit(jsg.count_misses, static_argnums=(2, 3))
    for k in range(2):
        assert int(misses(jnp.asarray(xs[k]), jnp.asarray(ys[k]), h, w).sum()) == 0
    feats, g = _rand((3, h, w, c), 1), _rand((d, h, w, c), 3)

    @jax.jit
    def pallas_vjp(feats, xs, ys, g):
        _, vjp = jax.vjp(lambda r, s: jsweep_variance(r, s, xs, ys, 8, 8, True), feats[0],
                         feats[1:])
        return vjp(g)

    want = [T(np.array(a)) for a in pallas_vjp(*map(jnp.asarray, (feats, xs, ys, g)))]
    dref, dsrcs, atomics, moves = emulate(T(feats)[None], T(xs)[None], T(ys)[None], T(g)[None])
    _held("dref vs Pallas vjp", dref[0], want[0], 1e-4)
    _held("dsrcs vs Pallas vjp", dsrcs[0], want[1], 1e-4)
    print(f"[vjp] RPC geometry: {atomics} float4 atomics a channel group, moves {moves}")


# (S, mode): one view, the pair off the image, five views (a walk a pair);
# each at every width of WIDTHS, one JAX call for all of them (channels are
# independent: the widths' channels side by side)
PER_VIEW = [(1, "window"), (2, "off-image"), (5, "window")]
WIDTHS = (3, 8, 16, 32)  # C of each emulated kernel; 3 takes the kernel's vec 1


def _widths(*arrays):
    """Each width of WIDTHS' slice of the channels (the last axis) of arrays."""
    c0 = 0
    for c in WIDTHS:
        yield c, [T(np.ascontiguousarray(a[..., c0:c0 + c])) for a in arrays]
        c0 += c


@pytest.mark.parametrize("s,mode", PER_VIEW)
def test_emulation_matches_per_view_vjp(s, mode):
    """Everywhere, off-image and far-off samples included: the emulated
    kernel at C = 3, 8, 16 and 32 against jax.vjp of JAX's per-view path on
    the same coordinates (1e-5 on sums of up to 4·D O(1) terms), and
    against the port's plain VJP within the summation bound (the same terms
    in another order)."""
    d, h, w = 5, 9, 13
    xs, ys = _coords(mode, 1, s, d, h, w, seed=10 + s)
    feats, g = _rand((1, s + 1, h, w, sum(WIDTHS)), 4 + s), _rand((1, d, h, w, sum(WIDTHS)), 6)
    want = _per_view_vjp(feats[0], xs[0], ys[0], g[0])
    for c, (f, gc, wdref, wdsrcs) in _widths(feats, g, want[0][None], want[1][None]):
        dref, dsrcs, _, moves = emulate(f, T(xs), T(ys), gc)
        _held(f"S={s} C={c} {mode} dref vs per-view vjp", dref, wdref, 1e-5)
        _held(f"S={s} C={c} {mode} dsrcs vs per-view vjp", dsrcs, wdsrcs, 1e-5)
        plain = sv.sweep_variance_backward_reference(f, T(xs), T(ys), gc)
        _held(f"S={s} C={c} {mode} dref vs plain", dref, plain[0], 1e-6)
        _held(f"S={s} C={c} {mode} dsrcs vs plain", dsrcs, plain[1],
              bound(f, T(xs), T(ys), gc))
        if mode == "window":  # every rule of the carry ran
            assert min(moves.values()) > 0, moves


def test_batch_of_two_is_per_sample():
    """At B = 2 each sample's dref and dsrcs are the emulation of that sample
    alone, bit for bit (a thread never crosses samples), and the port's
    batched plain VJP within the bound."""
    b, s, d, h, w, c = 2, 2, 6, 7, 11, 8
    xs, ys = (T(a) for a in _coords("window", b, s, d, h, w, seed=3))
    feats, g = T(_rand((b, s + 1, h, w, c), 7)), T(_rand((b, d, h, w, c), 8))
    dref, dsrcs, atomics, _ = emulate(feats, xs, ys, g)
    total = 0
    for i in range(b):
        one = emulate(feats[i:i + 1], xs[i:i + 1], ys[i:i + 1], g[i:i + 1])
        assert torch.equal(one[0][0], dref[i]) and torch.equal(one[1][0], dsrcs[i])
        total += one[2]
    assert total == atomics
    plain = sv.sweep_variance_backward_reference(feats, xs, ys, g)
    _held("B=2 dsrcs vs plain", dsrcs, plain[1], bound(feats, xs, ys, g))
    _held("B=2 dref vs plain", dref, plain[0], 1e-6)


@pytest.mark.parametrize("row0", [5, 0, 8])
def test_band_of_reference_rows(row0):
    """A rank's band of reference rows (rows row0 .. row0 + 5 of a 14-row
    source, the sources whole, `Hs` > H in the kernel) at C = 3, 8, 16 and
    32: dref on the band and dsrcs over the whole sources against jax.vjp of
    the per-view path on the band (1e-5) and the port's plain band VJP
    (`_plain_vjp`, within the bound)."""
    hs, h, w, s, d = 14, 6, 12, 2, 5
    xs, ys = _coords("window", 1, s, d, h, w, seed=row0)
    ys = ys + row0  # the band's own rows of the source
    feats = _rand((1, s + 1, hs, w, sum(WIDTHS)), 11 + row0)
    g = _rand((1, d, h, w, sum(WIDTHS)), 12)
    want = _per_view_vjp(feats[0], xs[0], ys[0], g[0], row0)
    for c, (f, gc, wdref, wdsrcs) in _widths(feats, g, want[0][None], want[1][None]):
        dref, dsrcs, _, _ = emulate(f, T(xs), T(ys), gc, row0)
        assert dsrcs.shape == (1, s, hs, w, c)
        _held(f"band {row0}+{h} C={c} dref vs per-view vjp", dref, wdref, 1e-5)
        _held(f"band {row0}+{h} C={c} dsrcs vs per-view vjp", dsrcs, wdsrcs, 1e-5)
        plain = sv._plain_vjp(f[:, 0, row0:row0 + h], f[:, 1:], T(xs), T(ys), gc)
        _held(f"band {row0}+{h} C={c} dsrcs vs plain", dsrcs, plain[1],
              bound(f, T(xs), T(ys), gc, row0))


def test_carry_rule_by_hand():
    """One pixel, one view, 3 channels, eight planes scripted through every
    move of the rule: stay, one column right, stay, one column left, a row
    down (all four flushed), far off the image (the flush of the last
    in-image corner, nothing added there), back in.  The grid is one row of
    a 4×6 source; its other five pixels sample far left of the image
    (corners clamped to x0 = −2, never in it).  The atomics are counted by
    hand, and the sums are the plain scatter's."""
    script = ((2.2, 1.5), (2.7, 1.4), (3.1, 1.6), (3.6, 1.2), (2.9, 1.3), (2.4, 2.1),
              (1e9, 1.0), (1.5, 0.5))
    d, w = len(script), 6
    xs = np.full((1, 1, d, 1, w), -1e9, np.float32)
    ys = np.ones((1, 1, d, 1, w), np.float32)
    xs[0, 0, :, 0, 0], ys[0, 0, :, 0, 0] = zip(*script)
    xs, ys = T(xs), T(ys)
    feats, g = T(_rand((1, 2, 4, w, 3), 13)), T(_rand((1, d, 1, w, 3), 14))
    dref, dsrcs, atomics, moves = emulate(feats, xs, ys, g)
    # (2,1) stays; → (3,1): the left column out (2); stays; → (2,1): the right
    # column out (2); → (2,2): all four of (2,1) out (4); → (W,1): all four of
    # (2,2) out (4); → (1,0): none of (W,1) lies in the image; the end: the
    # four of (1,0) (4).  The other pixels: a first move and seven stays each
    assert moves == {"stay": 2 + 5 * 7, "column": 2, "other": 4 + 5}
    assert atomics == 2 + 2 + 4 + 4 + 4
    plain = sv._plain_vjp(feats[:, 0, :1], feats[:, 1:], xs, ys, g)
    _held("by hand dsrcs vs plain", dsrcs, plain[1], bound(feats, xs, ys, g))
    _held("by hand dref vs plain", dref, plain[0], 1e-6)


def test_more_than_four_views_walk_in_pairs():
    """S = 5 walks (0, 1), (2, 3), (4): the same corner moves and atomics as
    one walk carrying all five (what a walk carries changes the order of
    the flushes, not which), dref summed once, dsrcs within the bound of
    the plain VJP."""
    b, s, d, h, w, c = 1, 5, 4, 6, 9, 4
    xs, ys = (T(a) for a in _coords("window", b, s, d, h, w, seed=21))
    feats, g = T(_rand((b, s + 1, h, w, c), 22)), T(_rand((b, d, h, w, c), 23))
    assert walks(s) == [[0, 1], [2, 3], [4]]
    pairs = emulate(feats, xs, ys, g)
    together = emulate(feats, xs, ys, g, unrolled=s)
    assert pairs[2:] == together[2:]
    assert torch.equal(pairs[0], together[0])
    plain = sv.sweep_variance_backward_reference(feats, xs, ys, g)
    _held("S=5 pairs dsrcs vs plain", pairs[1], plain[1], bound(feats, xs, ys, g))


@functools.lru_cache(maxsize=1)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def corner_atomics(xs, ys, hs, w):
    """The float4 atomics a sample (a thread, view and plane) of the column
    carry and of the runs of planes (flush all four corners when the floor
    corner moves) over xs/ys (S, D, H, W), every thread walking all D
    planes: the corners in the image each rule adds, floor corners alone."""
    x0, y0, _ = taps(xs, ys, hs, w)

    def inside(x, y, corners):
        return sum(((x + (k & 1) >= 0) & (x + (k & 1) < w) & (y + (k >> 1) >= 0)
                    & (y + (k >> 1) < hs)).sum().item() for k in corners)

    px, py, nx, ny = x0[:, :-1], y0[:, :-1], x0[:, 1:], y0[:, 1:]
    moved = (px != nx) | (py != ny)
    right = (py == ny) & (nx == px + 1)
    left = (py == ny) & (nx == px - 1)
    other = moved & ~right & ~left
    end = inside(x0[:, -1], y0[:, -1], ALL)
    runs = inside(px[moved], py[moved], ALL) + end
    carry = (inside(px[right], py[right], LEFT) + inside(px[left], py[left], RIGHT)
             + inside(px[other], py[other], ALL) + end)
    return carry / xs.numel(), runs / xs.numel()


def test_atomics_at_the_train_stage_shapes():
    """At the three stage shapes of a 384×768 train step (chip_smoke.py's
    `sweep_inputs` on the CPU: a synthetic RPC triplet, stage 1 uniform,
    stages 2-3 windows around a seeded previous depth, S = 2) the column
    carry issues about half the float4 atomics a sample of the fp32
    scatter's runs of planes (the least a thread can issue alone: motion
    along the epipolar line is monotone, a column that leaves is not
    visited again), ~51 M a step against ~93 M."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    total = [0.0, 0.0]
    threads = torch.get_num_threads()
    torch.set_num_threads(8)  # the RPC polynomials of 15 M samples: seconds, not tens
    try:
        coords = [cs.sweep_inputs(i, 1, cs.HEIGHT // cs.STAGE_SCALES[i],
                                  cs.WIDTH // cs.STAGE_SCALES[i], gen, device="cpu")[1:]
                  for i in range(3)]
    finally:
        torch.set_num_threads(threads)
    for i, (xs, ys) in enumerate(coords):
        h, w = xs.shape[-2:]
        carry, runs = corner_atomics(xs[0], ys[0], h, w)
        groups = cs.FEAT_CH[i] // 4
        total[0] += carry * xs.numel() * groups
        total[1] += runs * xs.numel() * groups
        print(f"[vjp] stage{i + 1} {tuple(xs.shape)}: float4 atomics a sample, column carry "
              f"{carry:.3f}, runs of planes {runs:.3f}")
        assert 0.5 * runs <= carry <= 0.7 * runs
        assert 0.8 <= carry <= 1.5
    print(f"[vjp] a step's float4 atomics: column carry {total[0] / 1e6:.1f} M, runs of planes "
          f"{total[1] / 1e6:.1f} M")
    assert total[0] < 0.6 * total[1]


@pytest.mark.parametrize("mode", ["window", "off-image"])
def test_counted_atomics_are_the_emulated_ones(mode):
    """`corner_atomics`, which reads floor corners alone, counts the atomics
    the whole emulation issues (the count the stage-shape test relies on),
    and the column carry never issues more than the runs of planes."""
    b, s, d, h, w, c = 1, 2, 7, 8, 12, 4
    xs, ys = (T(a) for a in _coords(mode, b, s, d, h, w, seed=31))
    feats, g = T(_rand((b, s + 1, h, w, c), 32)), T(_rand((b, d, h, w, c), 33))
    _, _, atomics, _ = emulate(feats, xs, ys, g)
    carry, runs = corner_atomics(xs[0], ys[0], h, w)
    assert round(carry * xs.numel()) == atomics
    assert carry <= runs


# ---- The shipped kernel source, built for the host ----
#
# csrc/sweep_variance.cu uses no shared memory and no barriers, so g++ builds
# it unchanged but for its launches, beside a stand-in for the CUDA runtime
# header: each launch runs the blocks and their threads one after another,
# the intrinsics round as the card's do (with -ffp-contract=off no multiply
# and add are fused unless the source asks), and an atomic add is a plain
# add that is counted.

HOST_CUDA_RUNTIME = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 threadIdx, blockIdx, blockDim, gridDim;
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcs(const T* p) { return *p; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __frcp_rn(float a) { return 1.0f / a; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline long long host_atomics[2] = {0, 0};  // float4 and float atomic adds
extern "C" long long host_atomic_count(int scalar) { return host_atomics[scalar]; }
extern "C" void host_atomic_reset() { host_atomics[0] = host_atomics[1] = 0; }
inline float4 atomicAdd(float4* p, float4 v) {
  ++host_atomics[0];
  const float4 o = *p;
  p->x += v.x; p->y += v.y; p->z += v.z; p->w += v.w;
  return o;
}
inline float atomicAdd(float* p, float v) { ++host_atomics[1]; const float o = *p; *p += v; return o; }
template <class K, class... A>
void host_launch(dim3 g, int threads, K kernel, A... args) {
  gridDim = g;
  blockDim = dim3(threads);
  for (unsigned z = 0; z < g.z; ++z)
    for (unsigned y = 0; y < g.y; ++y)
      for (unsigned x = 0; x < g.x; ++x)
        for (int t = 0; t < threads; ++t) {
          blockIdx = dim3(x, y, z);
          threadIdx = dim3(t);
          kernel(args...);
        }
}
"""
# kernel<<<grid, threads, 0, stream>>>(  →  host_launch(grid, threads, kernel,
LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),\s*0,\s*\w+>>>\(")


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/sweep_variance.cu built by g++ for the host (above): its
    `sweep_variance_backward_f32`, and the library for its atomics count."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of csrc/sweep_variance.cu needs it")
    csrc = ROOT / "satmvs_tpu_torch" / "csrc"
    out = tmp_path_factory.mktemp("host_sweep_variance")
    (out / "cuda_runtime.h").write_text(HOST_CUDA_RUNTIME)
    src, n = LAUNCH.subn(r"host_launch(\2, \3, \1, ", (csrc / "sweep_variance.cu").read_text())
    assert n > 0 and "<<<" not in src
    (out / "sweep_variance.cpp").write_text(src)
    lib = out / "libsweep_variance.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{out}", f"-I{csrc}", str(out / "sweep_variance.cpp"), "-o", str(lib)],
                   check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(lib))
    fn = lib.sweep_variance_backward_f32
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.host_atomic_count.restype = ctypes.c_longlong
    lib.host_atomic_count.argtypes = [ctypes.c_int]
    return lib


def host_vjp(lib, feats, xs, ys, g, row0=0):
    """The shipped kernel's VJP on the host, launched as the wrapper
    launches it (`sweep_variance_backward_plan`; view 0's rows row0 .. row0 +
    H − 1 the reference band) → dref, dsrcs and its (float4, float) atomics."""
    b, v, hs, w, c = feats.shape
    s, d, h = xs.shape[1], xs.shape[2], xs.shape[3]
    ref = feats[:, 0, row0:row0 + h]
    plan = sv.sweep_variance_backward_plan(b, s, d, h, w, c, c % 4 == 0)
    dref = torch.empty((b, h, w, c))
    dsrcs = torch.zeros((b, s, hs, w, c))
    lib.host_atomic_reset()
    rc = lib.sweep_variance_backward_f32(ref.data_ptr(), feats[:, 1:].data_ptr(), v * hs * w * c,
                                         xs.data_ptr(), ys.data_ptr(), g.data_ptr(),
                                         dsrcs.data_ptr(), dref.data_ptr(), b, s, d, h, w, c,
                                         plan["vec"], plan["tx"], plan["ty"], hs, None)
    assert rc == 0, rc
    return dref, dsrcs, (lib.host_atomic_count(0), lib.host_atomic_count(1))


# (B, S, D, H, W, C, mode, Hs, row0): one to seven views (up to four
# unrolled, corners kept for two; past four a walk a pair), vec 4 and vec 1
# (C = 3, 6), off-image and far-off samples, B = 2, and bands of reference
# rows (Hs > H)
HOST_CASES = [(1, 1, 5, 6, 11, 8, "window", None, 0), (1, 2, 6, 9, 17, 8, "window", None, 0),
              (2, 2, 5, 7, 13, 16, "window", None, 0), (1, 2, 5, 8, 12, 32, "off-image", None, 0),
              (1, 2, 4, 6, 11, 6, "window", None, 0), (2, 3, 4, 5, 9, 8, "window", None, 0),
              (1, 4, 4, 5, 9, 4, "off-image", None, 0), (2, 5, 4, 5, 9, 8, "window", None, 0),
              (1, 5, 3, 5, 7, 3, "off-image", None, 0), (1, 7, 3, 4, 9, 8, "window", None, 0),
              (1, 2, 5, 6, 12, 8, "window", 14, 5), (1, 2, 5, 4, 12, 3, "window", 9, 3)]


@pytest.mark.parametrize("b,s,d,h,w,c,mode,hs,row0", HOST_CASES)
def test_host_build_of_the_kernel_is_the_vjp(host_kernel, b, s, d, h, w, c, mode, hs, row0):
    """The shipped kernel source, built for the host and launched under the
    wrapper's plan: dref and dsrcs against the port's plain VJP and dsrcs
    against the emulation above, to 1e-5 × max(1, max |plain|) (the card
    tests' tolerance: the kernel rounds its samples by FMAs, so its terms
    are not the plain VJP's bit for bit, and sums them in another order),
    and the same float4 (vec 4) or float (vec 1) atomics as the emulation
    counts: the emulation's rule is the source's."""
    xs, ys = (T(a) for a in _coords(mode, b, s, d, h, w, hs, seed=b + s + d + c))
    ys = ys + row0
    feats = T(_rand((b, s + 1, hs or h, w, c), 40 + s))
    g = T(_rand((b, d, h, w, c), 41 + c))
    dref, dsrcs, (vec4, vec1) = host_vjp(host_kernel, feats, xs, ys, g, row0)
    plain = sv._plain_vjp(feats[:, 0, row0:row0 + h], feats[:, 1:], xs, ys, g)
    _, edsrcs, atomics, _ = emulate(feats, xs, ys, g, row0)
    what = f"host kernel {b, s, d, h, w, c} {mode} row0 {row0}"
    for name, got, want in (("dref vs plain", dref, plain[0]), ("dsrcs vs plain", dsrcs, plain[1]),
                            ("dsrcs vs emulation", dsrcs, edsrcs)):
        _held(f"{what} {name}", got, want, 1e-5 * max(1.0, want.abs().max().item()))
    assert (vec4, vec1) == ((atomics * c // 4, 0) if c % 4 == 0 else (0, atomics * c))
