"""The bf16 scatter's launch plan (`sweep_gather.scatter_window_plan`) and a
torch emulation of the windowed kernel it launches (csrc/sweep_gather.cu
`sweep_scatter_bf16_kernel`), on the CPU without a compiler or a card.

The emulation follows the kernel block by block: the box of image pixels a
block's samples touch, the budget test of its sort by floor corner, the
sums of each touched pixel and their flush into dsrc, or the per-pixel path
for a block whose window does not fit, with the kernel's block counts.  It is held to
the JAX package: `jax.vjp` of `bilinear_sample` cast to bf16 (the bf16
cotangent widened exactly, as the port's kernel reads it) and, on RPC
geometry the TPU stencil covers, the Pallas scatter in interpret mode.  The
tolerance is the kernel's summation bound, 2·(4·D − 1)·2⁻²⁴ × the sum of
each element's term magnitudes: both sides form the same products and sum
them in other orders.  The plan is checked at the phase-6 train shapes of
chip_smoke.py (both source views of every stage of a 384×768 train step):
its thread map covers every plane, pixel and channel once, and at least 95 %
of its blocks keep their window on the step's coordinates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.geo import rpc as jrpc
from satmvs_tpu.ops import warp as jwarp
from satmvs_tpu.ops.pallas import sweep_gather as jsg
from satmvs_tpu.ops.sampling import bilinear_sample as jbilinear
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.geo import rpc as trpc
from satmvs_tpu_torch.ops import warp as twarp
from satmvs_tpu_torch.ops.kernels import sweep_gather as sg

T = torch.from_numpy
KERNEL_BYTES = 232448  # shared memory an H100 SM gives its blocks (hopper-kernels guide)
TRAIN = ((64, 96, 192, 32), (32, 192, 384, 16), (8, 384, 768, 8))  # chip_smoke's stages


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small ops, run beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def taps(xs, ys, hs, w):
    """bilinear.cuh `Taps`: floor corners (clamped as the kernel clamps them)
    and the four weights in Taps order."""
    fx, fy = torch.floor(xs), torch.floor(ys)
    wx, wy = xs - fx, ys - fy
    x0 = fx.clamp(-2, w).to(torch.int64)
    y0 = fy.clamp(-2, hs).to(torch.int64)
    return x0, y0, ((1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx)


def block_windows(xs, ys, hs, plan):
    """Per block (tile row, tile column, chunk), as the kernel reduces them:
    whether any sample touches the image, the box (x0, x1, y0, y1) of the
    pixels touched, and whether its window fits the budget: its floor
    corners (the box and one more row and column) + 1 + SCATTER_SORT × its
    samples, and its chunk's offsets under 2³¹.  Padding samples lie far off the
    image."""
    d, h, w = xs.shape
    ty, tx, p = plan["ty"], plan["tx"], plan["planes"]
    nty, ntx, nch = -(-h // ty), -(-w // tx), -(-d // p)
    pad = (0, ntx * tx - w, 0, nty * ty - h, 0, nch * p - d)
    x0, y0, _ = taps(torch.nn.functional.pad(xs, pad, value=-1e9),
                     torch.nn.functional.pad(ys, pad, value=-1e9), hs, w)
    lo_x, hi_x = x0.clamp(min=0), (x0 + 1).clamp(max=w - 1)
    lo_y, hi_y = y0.clamp(min=0), (y0 + 1).clamp(max=hs - 1)
    touched = (lo_x <= hi_x) & (lo_y <= hi_y)
    big = 1 << 40

    def per_block(t, fill, reduce):
        t = torch.where(touched, t, torch.full_like(t, fill))
        t = t.reshape(nch, p, nty, ty, ntx, tx).permute(2, 4, 0, 1, 3, 5).reshape(
            nty, ntx, nch, -1)
        return reduce(t, dim=-1).values

    box = (per_block(lo_x, big, torch.min), per_block(hi_x, -big, torch.max),
           per_block(lo_y, big, torch.min), per_block(hi_y, -big, torch.max))
    any_ = box[0] <= box[1]
    corners = torch.where(any_, (box[1] - box[0] + 2) * (box[3] - box[2] + 2),
                          torch.zeros_like(box[0]))
    planes = (d - torch.arange(nch) * p).clamp(max=p).view(1, 1, nch)
    fits = ((corners + 1 + sg.SCATTER_SORT * ty * tx * planes <= plan["budget"])
            & (planes * h * w < 2 ** 31))
    return any_, box, ~any_ | fits


def emulate(g, xs, ys, hs, plan):
    """The windowed bf16 scatter of g (D, H, W, C) into (hs, W, C) fp32,
    block by block as the kernel runs it: products w·g in fp32 (the
    kernel's __fmul_rn), a fitting block's sums per touched pixel of its
    window, then one add each into dsrc; another block's products straight
    into dsrc.  Returns dsrc and [blocks, blocks whose window did not
    fit]."""
    d, h, w, c = g.shape
    ty, tx, p, cg = plan["ty"], plan["tx"], plan["planes"], plan["cg"]
    any_, box, fits = block_windows(xs, ys, hs, plan)
    x0, y0, wts = taps(xs, ys, hs, w)
    gf = g.float()
    dsrc = torch.zeros((hs * w, c))
    counts = [0, 0]
    for bi, bj, ch, cgi in np.ndindex(*any_.shape, -(-c // cg)):
        counts[0] += 1
        if not any_[bi, bj, ch]:
            continue
        counts[1] += int(not fits[bi, bj, ch])
        sl = (slice(ch * p, (ch + 1) * p), slice(bi * ty, (bi + 1) * ty),
              slice(bj * tx, (bj + 1) * tx))
        cb, ce = cgi * cg, min(c, (cgi + 1) * cg)
        gb = gf[sl][..., cb:ce].reshape(-1, ce - cb)
        bx, by = x0[sl].reshape(-1), y0[sl].reshape(-1)
        out = dsrc[:, cb:ce]
        wx0, wx1, wy0, wy1 = (int(b[bi, bj, ch]) for b in box)
        ww = wx1 - wx0 + 1
        win = torch.zeros(((wy1 - wy0 + 1) * ww, ce - cb))
        for k, wt in enumerate(wts):
            xi, yi = bx + (k & 1), by + (k >> 1)
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < hs)
            prod = wt[sl].reshape(-1, 1)[ok] * gb[ok]
            if fits[bi, bj, ch]:
                win.index_add_(0, (yi[ok] - wy0) * ww + xi[ok] - wx0, prod)
            else:
                out.index_add_(0, yi[ok] * w + xi[ok], prod)
        if fits[bi, bj, ch]:
            cell = torch.arange(win.shape[0])
            out.index_add_(0, (wy0 + cell // ww) * w + wx0 + cell % ww, win)
    return dsrc.reshape(hs, w, c), counts


def bound(g, xs, ys, hs):
    """The summation bound of each dsrc element."""
    d, _, w, _ = g.shape
    return 2 * (4 * d - 1) * 2.0 ** -24 * sg.sweep_scatter_reference(g.float().abs(), xs, ys,
                                                                      hs, w)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rpc_coords(h, w, d, view=0, seed=2):
    """Smooth RPC sweep coordinates (D, h, w) of a synthetic triplet's view,
    nadir reference, uniform planes over the height range."""
    rpcs = jsyn.make_rpc_triplet(4 * w, 4 * h, seed=seed)
    cams = jwarp.build_rpc_warp_cams(np.stack([rpcs[2], rpcs[0], rpcs[1]]), 0, stage_scale=0.25)
    lo, hi = jrpc.height_range(rpcs[2])
    depths = jnp.linspace(lo, hi, d, dtype=jnp.float32)
    return tuple(np.array(a) for a in jwarp.rpc_sweep_coords(cams, view, depths, h, w))


def _coords(kind, d, h, w, seed):
    """(xs, ys) (D, h, w): "rpc" smooth RPC geometry; "wide" uniform over
    the whole image, a footprint past any window; "off" over and 3 px past
    every edge, some far off."""
    if kind == "rpc":
        return _rpc_coords(h, w, d, seed=seed)
    rng = np.random.default_rng(seed)
    spread = 0.0 if kind == "wide" else 3.0
    xs = rng.uniform(-spread, w - 1 + spread, (d, h, w)).astype(np.float32)
    ys = rng.uniform(-spread, h - 1 + spread, (d, h, w)).astype(np.float32)
    if kind == "off":
        xs.reshape(-1)[::37] = 1e9
        ys.reshape(-1)[::41] = -1e9
    return xs, ys


def _held(name, got, want, tol):
    err = (got - want).abs()
    print(f"[parity] {name}: max abs err {err.max().item():.3e}, max bound "
          f"{tol.max().item():.3e}")
    assert got.shape == want.shape
    assert bool((err <= tol + 1e-30).all()), name


# (kind, d, h, w, c, row0 and hs of a band (None: the whole source), planes
# a block (None: the plan's), blocks that must keep / leave the window)
CASES = [
    ("rpc", 6, 32, 48, 8, None, None, "all in"),
    ("rpc", 6, 32, 48, 32, None, 3, "all in"),
    ("wide", 5, 96, 128, 8, None, 5, "some out"),
    ("wide", 4, 96, 128, 32, None, 4, "some out"),
    ("off", 5, 12, 16, 12, None, 2, None),
    ("off", 4, 12, 16, 3, (8, 24), 4, None),
    ("rpc", 6, 16, 48, 8, (8, 32), 3, "all in"),
]


@pytest.mark.parametrize("kind,d,h,w,c,band,planes,window", CASES)
def test_emulated_window_scatter_matches_jax_vjp(kind, d, h, w, c, band, planes, window):
    """The emulated kernel of a bf16 cotangent against jax.vjp of
    bilinear_sample cast to bf16 (a band: the rows row0 .. row0 + h − 1 of
    an hs-row source, sampled at the source's own coordinates), within the
    summation bound; a smooth sweep keeps every block in its window, a
    footprint over the whole image sends some blocks to the per-pixel
    path, and a budget of 0 sends them all there with the same sums."""
    row0, hs = band or (0, h)
    xs, ys = _coords(kind, d, hs, w, seed=h + c)
    xs, ys = xs[:, row0:row0 + h], ys[:, row0:row0 + h]
    src = _rand((hs, w, c), 3)
    g = jnp.asarray(_rand((d, h, w, c), 4)).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda s: jbilinear(s, jnp.asarray(xs), jnp.asarray(ys)).astype(jnp.bfloat16),
                     jnp.asarray(src))
    (want,) = vjp(g)
    gt = T(np.array(g.astype(jnp.float32))).to(torch.bfloat16)
    plan = sg.scatter_window_plan(d, h, w, c, hs, planes=planes)
    got, counts = emulate(gt, T(xs), T(ys), hs, plan)
    tol = bound(gt, T(xs), T(ys), hs)
    _held(f"window scatter {kind} {(d, h, w, c)} band {band}", got, T(np.array(want)), tol)
    print(f"[plan] {plan}: {counts[1]} of {counts[0]} blocks outside their window")
    assert counts[0] == np.prod(plan["grid"])
    if window == "all in":
        assert counts[1] == 0
    elif window == "some out":
        assert counts[1] > 0
    none, counts = emulate(gt, T(xs), T(ys), hs, {**plan, "budget": 0})
    assert counts[1] > 0
    _held(f"per-pixel path {kind}", none, T(np.array(want)), tol)


@pytest.mark.parametrize("c,planes", [(8, None), (32, 3)])
def test_emulated_window_scatter_matches_pallas(c, planes):
    """On RPC geometry the TPU stencil covers (count_misses == 0, checked),
    the emulated kernel against the Pallas scatter of the bf16 cotangent in
    interpret mode (it widens the cotangent at the read, as the kernel
    does), within the summation bound."""
    d, h, w = 6, 32, 48
    xs, ys = _rpc_coords(h, w, d, view=1, seed=5)
    assert int(jsg.count_misses(jnp.asarray(xs), jnp.asarray(ys), h, w).sum()) == 0
    g = jnp.asarray(_rand((d, h, w, c), 6)).astype(jnp.bfloat16)
    want = jsg._sweep_scatter_impl(g, jnp.asarray(xs), jnp.asarray(ys), h, w, interpret=True)
    gt = T(np.array(g.astype(jnp.float32))).to(torch.bfloat16)
    got, counts = emulate(gt, T(xs), T(ys), h, sg.scatter_window_plan(d, h, w, c,
                                                                       planes=planes))
    assert counts[1] == 0
    _held(f"window scatter vs Pallas C={c}", got, T(np.array(want)),
          bound(gt, T(xs), T(ys), h))


def _thread_map(plan, d, h, w, c):
    """The kernel's (block, thread item) → (planes, pixel, channels) map
    written out: counts of each (pixel, channel) over the tiles' items, and
    of each plane over the chunks, and of each channel over the groups."""
    ty, tx, lanes, vec, cg, p = (plan[k] for k in ("ty", "tx", "lanes", "vec", "cg", "planes"))
    tiles_x = -(-w // tx)
    blk, it = np.meshgrid(np.arange(plan["grid"][0]), np.arange(ty * tx * lanes), indexing="ij")
    q, lane = it // lanes, it % lanes
    i, j = blk // tiles_x * ty + q // tx, blk % tiles_x * tx + q % tx
    keep = (i < h) & (j < w)
    pix = np.zeros((h, w, cg), np.int64)
    for k in range(vec):
        np.add.at(pix, (i[keep], j[keep], (lane * vec + k)[keep]), 1)
    planes = np.zeros(d, np.int64)
    for z in range(plan["grid"][1]):
        planes[z * p:min(d, z * p + p)] += 1
    chans = np.zeros(c, np.int64)
    for z in range(plan["grid"][2]):
        for lc in range(cg):
            if z * cg + lc < c:
                chans[z * cg + lc] += 1
    return pix, planes, chans


@pytest.mark.parametrize("d,h,w,c,hs", [*((*s, None) for s in TRAIN), (5, 12, 20, 3, None),
                                        (5, 12, 20, 12, None), (7, 9, 40, 8, 20),
                                        (4, 16, 24, 48, None)])
def test_plan_covers_every_plane_pixel_and_channel_once(d, h, w, c, hs):
    """At the train shapes, C = 3, 12, a band of 9 of 20 rows and C = 48
    (two channel groups, the second half full): every (pixel, channel of
    the group) is one thread item's, every plane one chunk's, every channel
    one group's; threads a multiple of 32, at most 256; a window and the
    kernel's 144 static bytes within 48 KB, so SCATTER_RESIDENT blocks fit
    an SM's shared memory."""
    plan = sg.scatter_window_plan(d, h, w, c, hs)
    assert plan["vec"] == (8 if c % 8 == 0 else 4 if c % 4 == 0 else 1)
    assert plan["cg"] % plan["vec"] == 0 and plan["cg"] == plan["lanes"] * plan["vec"]
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 256
    assert plan["threads"] >= min(256, plan["ty"] * plan["tx"] * plan["lanes"]) - 31
    assert 4 * plan["budget"] + 144 <= 48 * 1024
    assert sg.SCATTER_RESIDENT * (4 * sg.SCATTER_WINDOW + 144) <= KERNEL_BYTES
    pix, planes, chans = _thread_map(plan, d, h, w, c)
    assert (pix == 1).all() and (planes == 1).all() and (chans == 1).all()
    assert plan["grid"][1] <= 65535 and plan["grid"][2] <= 65535


def test_plan_refusals_and_options():
    """What the plan refuses, and the options it passes through."""
    with pytest.raises(ValueError):
        sg.scatter_window_plan(0, 8, 8, 8)
    with pytest.raises(ValueError):
        sg.scatter_window_plan(4, 8, 8, 8, hs=4)  # fewer source rows than samples
    with pytest.raises(ValueError):
        sg.scatter_window_plan(4, 8, 8, 12, vec=8)
    with pytest.raises(ValueError):
        sg.scatter_window_plan(4, 8, 8, 8, budget=sg.SCATTER_WINDOW + 1)
    with pytest.raises(ValueError):
        sg.scatter_window_plan(4, 8, 8, 8, planes=0)
    plan = sg.scatter_window_plan(16, 8, 64, 16, planes=5, budget=100, vec=1)
    assert (plan["planes"], plan["budget"], plan["vec"], plan["grid"][1]) == (5, 100, 1, 4)
    assert plan == sg.scatter_window_plan(16, 8, 64, 16, 8, 132, 1, 5, 100)
    plan = sg.scatter_window_plan(16, 8, 64, 16, planes=5, vec=1)
    assert plan["budget"] == sg.SCATTER_SORT * 16 * 5 + sg.SCATTER_CORNERS  # 16 pixels a tile
    assert sg.scatter_window_plan(64, 96, 192, 32, planes=64)["budget"] == sg.SCATTER_WINDOW


def _train_cases():
    """chip_smoke.gather_cases on the CPU, one source view a stage (the
    other is the triplet's mirror look; chip_smoke.py reads both on the
    card): view 0 of every stage of a 384×768 train step (uniform planes
    over the height range), then the first case pushed off the image."""
    rpcs = tsyn.make_rpc_triplet(768, 384, seed=0)
    rpcs = np.stack([rpcs[2], rpcs[0], rpcs[1]])
    stage_cams = twarp.build_stage_cams(rpcs, 0, device="cpu")
    lo, hi = trpc.height_range(rpcs[0])
    cases = []
    for cams, (d, h, w, c) in zip(stage_cams, TRAIN):
        xs, ys = twarp.rpc_sweep_coords(cams, 0, torch.linspace(lo, hi, d), h, w)
        cases.append((f"{(d, h, w, c)} view0", xs.contiguous(), ys.contiguous(), c))
    _, xs, ys, c = cases[0]
    h, w = xs.shape[1:]
    xo, yo = xs * 1.5 - 0.25 * w, ys * 1.5 - 0.25 * h
    xo.view(-1)[::97] = 1e9
    yo.view(-1)[::89] = -1e9
    return cases + [("off-image", xo, yo, c)]


def test_train_shapes_keep_their_windows():
    """At the phase-6 shapes (a view of each of the step's three stages and
    the off-image case) at least 95 % of the plan's blocks keep their window on an H100's 132
    SMs: the kernel's windowed path is the one the step runs."""
    for label, xs, ys, c in _train_cases():
        d, h, w = xs.shape
        plan = sg.scatter_window_plan(d, h, w, c)
        any_, _, fits = block_windows(xs, ys, h, plan)
        share = fits.float().mean().item()
        print(f"[plan] {label}: tile {plan['ty']}x{plan['tx']}, {plan['planes']} planes, "
              f"{fits.numel()} blocks, {share:.4f} in their window")
        assert share >= 0.95, label
