"""The launch plans of three kernels on the CPU: the ConvGRU adjoint's
(satmvs_tpu_torch/ops/kernels/red_recur.py `red_recur_bwd_plan`, CUDA
`red_recur_bwd_kernel`) at every call shape of a 384×768 train step, at
B = 1 and 2 and at the card tests' shapes; the forward recurrence's
(`red_recur_plan`, CUDA `red_recur_kernel`: the adjoint's first two convs
and its blocks) at the train step's shapes, at the 4-tile scene chunk's
and at the card tests'; the layout of its transposed
weights against autograd through the cell's convolutions; and the grid of
the sweep gather (sweep_gather.cu `sweep_grid`, `GATHER_PLANES`), with the
kernel's thread-to-output map written out, covering every output once.  The
kernels themselves run only on the card (tests/test_torch_kernels.py,
`cuda`)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from satmvs_tpu_torch.nn.blocks import ConvGRUCell
from satmvs_tpu_torch.ops.kernels import red_recur as rr
from satmvs_tpu_torch.ops.kernels import sweep_gather as sg
from satmvs_tpu_torch.params import init_from_seed

ROOT = Path(__file__).resolve().parents[1]
RESIDENT = 2 * 132  # an H100: 132 SMs, two backward blocks an SM
CARD_SHAPES = [  # (B, H, W, Cin, C) of the `cuda` backward tests
    (1, 16, 24, 8, 8), (2, 7, 9, 6, 4), (1, 6, 12, 64, 64), (2, 12, 24, 64, 64),
    (2, 32, 160, 16, 8), (1, 10, 36, 12, 12), (2, 9, 20, 24, 24)]
FWD_CARD_SHAPES = [  # (B, H, W, Cin, C) of the `cuda` forward tests
    (1, 16, 24, 8, 8), (1, 7, 9, 6, 4), (1, 6, 12, 64, 64), (1, 10, 36, 12, 12),
    (1, 9, 20, 24, 24), (3, 7, 9, 6, 4), (2, 6, 12, 64, 64), (4, 16, 24, 8, 8),
    (4, 20, 28, 16, 16), (2, 8, 8, 4, 4), (2, 32, 160, 16, 8), (4, 12, 24, 64, 64)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _train_shapes():
    """(H, W, Cin, C) of the 12 red_recur calls of a 384×768 train step."""
    cs = _chip_smoke()
    shapes = [(h // s, w // s, ci, c) for _, _, h, w, cin in cs.red_shapes()
              for s, ci, c in cs.red_scales(cin)]
    assert len(shapes) == 12
    return shapes


def _chunk_shapes():
    """(H, W, Cin, C) of the 12 batched red_recur calls of a 4-tile scene
    chunk: 448² tiles, each stage's four scales."""
    cs = _chip_smoke()
    shapes = [(cs.TILE_HW // scale // s, cs.TILE_HW // scale // s, ci, c)
              for scale, cin in zip(cs.STAGE_SCALES, cs.FEAT_CH) for s, ci, c in cs.red_scales(cin)]
    assert len(shapes) == 12 and cs.BATCH_TILES == 4 and cs.SLAB == 8
    return shapes


def _check_convs(convs, h, w, cin, c):
    """Each conv's plan: 8 warps, coverage, and its shared-memory buffers,
    at the width the kernels run a C-channel cell at."""
    c = rr.padded_width(c)
    couts = (2 * c, c, c, c + cin)
    for conv, cout, nraw in zip(convs, couts, rr._NRAW):
        px, wr, wc, wk, ck = (conv[k] for k in ("px", "wr", "wc", "wk", "ck"))
        assert px in (1, 2) and wr * wc * wk * 32 == rr.RED_BWD_THREADS
        assert all(v & (v - 1) == 0 for v in (wr, wc, wk))
        tr, slab = conv["tile_rows"], conv["slab"]
        assert tr == wr * px <= 16 and slab == 8 * wc <= 64
        # the staged chunk and its weights fit their shared-memory buffers
        assert ck in (8, 16, 32, 64) and wk <= ck
        assert nraw * ck * rr._staged_plane(tr, ck) <= rr._IN_WORDS
        assert 9 * ck * slab <= rr._W_WORDS
        ps = rr._staged_plane(tr, ck)
        assert ps >= (tr + 2) * 34 and ps % 32 == 32 // min(ck, 32)
        assert slab <= -(-cout // 8) * 8, "no slab wider than the output"
        ny, nx, ns = -(-h // tr), -(-w // 32), -(-cout // slab)
        # the tiles cover every pixel and the slabs every channel, none idle
        assert ny * tr >= h > (ny - 1) * tr and nx * 32 >= w > (nx - 1) * 32
        assert ns * slab >= cout > (ns - 1) * slab
        assert conv["items"] == ny * nx * ns


def _sum_order(plan):
    """(wk, ck) of each conv: all that decides the order of an output's sum."""
    return [(p["wk"], p["ck"]) for p in plan["convs"]]


def _check_plan(b, h, w, cin, c, resident):
    plan = rr.red_recur_bwd_plan(b, h, w, cin, c, resident)
    per = plan["per_element"]
    assert plan["blocks"] == b * per and 1 <= per and plan["blocks"] <= resident
    _check_convs(plan["convs"], h, w, cin, c)
    # an element's sums are taken in the order it would take alone
    assert _sum_order(plan) == _sum_order(rr.red_recur_bwd_plan(1, h, w, cin, c, resident))
    # the own-pixel passes cover the plane, four channels a thread
    lanes = rr.RED_BWD_THREADS // (rr.padded_width(c) // 4)
    assert lanes >= 1 and per * lanes >= min(h * w, per * lanes)
    return plan


@pytest.mark.parametrize("b", [1, 2])
def test_plan_at_every_call_of_a_train_step(b):
    """Coverage, shared memory and threads at every shape of a train step;
    the grid is the most blocks a pass of the element can use (at most its
    share of the card), and the 288-pixel planes of stage 1 scale 8 still
    spread over many blocks."""
    assert rr.RED_BWD_SMEM <= rr.RED_BWD_MAX_SMEM
    assert 2 * (rr.RED_BWD_SMEM + 1024) <= 233472  # two blocks an SM (1 KB reserved each)
    for h, w, cin, c in _train_shapes():
        plan = _check_plan(b, h, w, cin, c, RESIDENT)
        own = -(-h * w // (rr.RED_BWD_THREADS // (c // 4)))
        most = max(own, *(p["items"] for p in plan["convs"]))
        assert plan["per_element"] == min(RESIDENT // b, most), (h, w, plan)
        assert plan["per_element"] >= 64 // b, (h, w, plan["per_element"])


@pytest.mark.parametrize("resident", [RESIDENT, 8])
def test_plan_at_the_card_tests_shapes(resident):
    for b, h, w, cin, c in CARD_SHAPES:
        _check_plan(b, h, w, cin, c, resident)


def test_plan_refuses_what_the_kernel_cannot_run():
    for c in (0, 4 * rr.RED_BWD_THREADS + 1, 4 * rr.RED_BWD_THREADS + 4):
        with pytest.raises(ValueError, match="1 ≤ C ≤ 1024"):
            rr.red_recur_bwd_plan(1, 8, 8, 4, c, RESIDENT)
    with pytest.raises(ValueError, match="cooperative grid"):
        rr.red_recur_bwd_plan(300, 8, 8, 4, 8, RESIDENT)
    with pytest.raises(ValueError, match="32-bit"):
        rr.red_recur_bwd_plan(1, 8192, 8192, 64, 64, RESIDENT)
    with pytest.raises(ValueError):
        rr.red_recur_bwd_plan(1, 0, 8, 4, 8, RESIDENT)


def _conv(inp, w):
    """out[p, co] = Σ_t Σ_c in[p + shift(t), c] · w[t, c, co], the kernel's
    conv of a (H, W, Cin) plane with w (9, Cin, Cout)."""
    weight = w.reshape(3, 3, w.shape[1], w.shape[2]).permute(3, 2, 0, 1)
    return F.conv2d(inp.permute(2, 0, 1)[None], weight, padding=1)[0].permute(1, 2, 0)


@pytest.mark.parametrize("cin,c", [(6, 4), (8, 12), (5, 8)])
def test_transposed_weights_give_the_convs_vjps(cin, c):
    """Through the kernel's conv, wcT maps the candidate's cotangent to the
    VJP of conv_c in m, and weT maps [dgr | dgu | dy_lin] to the VJPs of the
    gates' convs in h (the first C outputs) and of all three x convs in x
    (the next Cin), its padding outputs zero."""
    cell = init_from_seed(ConvGRUCell(cin, c), 3).double()
    wa, _, wb, _, _ = rr.cell_kernel_args(cell)
    wcT, weT = rr.cell_backward_weights(wa, wb, cin)
    assert wcT.shape == (9, c, c) and weT.shape == (9, 3 * c, -(-(c + cin) // 4) * 4)
    rng = np.random.default_rng(4)
    hh, ww = 5, 7
    x = torch.from_numpy(rng.normal(size=(hh, ww, cin))).requires_grad_(True)
    h = torch.from_numpy(rng.normal(size=(hh, ww, c))).requires_grad_(True)
    m = torch.from_numpy(rng.normal(size=(hh, ww, c))).requires_grad_(True)
    dg = torch.from_numpy(rng.normal(size=(hh, ww, 2 * c)))
    dyl = torch.from_numpy(rng.normal(size=(hh, ww, c)))
    gates = _conv(torch.cat([x, h], -1), wa)
    cand = _conv(torch.cat([x, m], -1), wb)
    dx, dh, dm = torch.autograd.grad(gates, (x, h, m), dg, retain_graph=True,
                                     allow_unused=True)
    dx2, dm = torch.autograd.grad(cand, (x, m), dyl)
    got = _conv(torch.cat([dg, dyl], -1), weT)
    torch.testing.assert_close(got[..., :c], dh, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got[..., c:c + cin], dx + dx2, rtol=1e-12, atol=1e-12)
    assert (got[..., c + cin:] == 0).all()
    torch.testing.assert_close(_conv(dyl, wcT), dm, rtol=1e-12, atol=1e-12)


def _kernel_planes(x, wa, ba, wb, bb, gn, c):
    """The kernels' recurrence over the planes of x (D, H, W, Cin) from a
    zero state, written out at the weights' width C4 with c real channels:
    GroupNorm(1) statistics as one pass of sums over every channel (a pad
    channel's raw values are 0) divided by the H·W·c real values."""
    c4 = wb.shape[-1]
    n = x.shape[1] * x.shape[2] * c

    def norm(v, k):
        mean = v.sum() / n
        inv = torch.rsqrt((v * v).sum() / n - mean * mean + 1e-5)
        return (v - mean) * inv * gn[2 * k] + gn[2 * k + 1]

    h = x.new_zeros((*x.shape[1:3], c4))
    outs = []
    for xd in x:
        g = _conv(torch.cat([xd, h], -1), wa) + ba
        r, u = torch.sigmoid(norm(g[..., :c4], 0)), torch.sigmoid(norm(g[..., c4:], 1))
        y = torch.tanh(norm(_conv(torch.cat([xd, r * h], -1), wb) + bb, 2))
        h = u * h + (1 - u) * y
        outs.append(h)
    return torch.stack(outs)


@pytest.mark.parametrize("cin,c", [(5, 6), (3, 2), (4, 1)])
def test_padded_cell_computes_the_cell(cin, c):
    """The kernels' padded arguments (`cell_kernel_args(cell, C4)`) run the
    cell: written out at C4 with the statistics over the c real channels,
    the states are the plain recurrence's (1e-12 in float64) and the pad
    channels stay exactly 0; their cotangents, cut back by `_param_grads`
    from the kernels' layout, are autograd's through the plain version."""
    cell = init_from_seed(ConvGRUCell(cin, c), 5).double()
    with torch.no_grad():
        for norm in (cell.gn_r, cell.gn_u, cell.gn_y):
            norm.weight.add_(0.3)
            norm.bias.add_(0.1)
    c4 = rr.padded_width(c)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(3, 5, 7, cin)))
    g = torch.from_numpy(rng.normal(size=(3, 5, 7, c)))
    args = [t.clone().requires_grad_(True) for t in rr.cell_kernel_args(cell, c4)]
    got = _kernel_planes(x, *args, c)
    want = rr.red_recur_reference(x, cell)
    torch.testing.assert_close(got[..., :c], want, rtol=0, atol=1e-12)
    assert (got[..., c:] == 0).all()
    dwa, dba, dwb, dbb, dgn = torch.autograd.grad((got[..., :c] * g).sum(), args)
    dps = rr._param_grads(cell, dwa.reshape(3, 3, *dwa.shape[1:]), dba,
                          dwb.reshape(3, 3, *dwb.shape[1:]), dbb, dgn)
    wants = torch.autograd.grad((rr.red_recur_reference(x, cell) * g).sum(),
                                list(cell.parameters()))
    for (name, _), a, e in zip(cell.named_parameters(), dps, wants):
        torch.testing.assert_close(a, e, rtol=0, atol=1e-12, msg=name)


@pytest.mark.parametrize("d,h,w,c,vec", [(64, 96, 192, 32, 4), (32, 192, 384, 16, 4),
                                         (8, 384, 768, 8, 4), (5, 7, 9, 6, 1),
                                         (3, 2, 300, 8, 4)])
def test_gather_grid_covers_every_output_once(d, h, w, c, vec):
    """sweep_gather_kernel's map, written out: thread t of block (x, y, z)
    takes pixel j = t / groups, channels (t % groups)·vec, row y and planes
    [z·P, z·P + P) (two a step, the last alone); over the grid at the
    wrapper's planes a thread every (d, i, j, channel) is written once."""
    groups = c // vec
    planes = sg.GATHER_PLANES
    # sweep_gather.cu `sweep_grid`: blocks of 256 threads over the W·groups
    # threads of a row, H rows, the chunks of `planes` planes
    gx, gy, gz = -(-w * groups // 256), h, -(-d // planes)
    assert gx * 256 >= w * groups > (gx - 1) * 256
    t = np.arange(gx * 256)
    t = t[t < w * groups]
    j, c0 = t // groups, (t % groups) * vec
    row_cols = (j[:, None] * c + c0[:, None] + np.arange(vec)).ravel()  # (j, channel) of a row
    count = np.zeros(d * h * w * c, dtype=np.int64)
    for z in range(gz):
        d0, d1 = z * planes, min(z * planes + planes, d)
        steps = list(range(d0, d1 - 1, 2))
        dd = [p for s in steps for p in (s, s + 1)] + ([d1 - 1] if (d1 - d0) % 2 else [])
        assert sorted(dd) == list(range(d0, d1))
        for p in dd:
            for i in range(h) if h * w * c <= 2 ** 22 else (0, h - 1):
                np.add.at(count, (p * h + i) * w * c + row_cols, 1)
    if h * w * c <= 2 ** 22:
        assert (count == 1).all()
    else:  # the first and last rows of every plane, once each
        rows = count.reshape(d, h, w * c)
        assert (rows[:, 0] == 1).all() and (rows[:, -1] == 1).all()


def _check_forward_plan(b, h, w, cin, c, resident):
    """The forward's plan is the adjoint's gates and candidate and its
    blocks (so the recompute repeats the forward's sums), its convs cover
    the plane and fit their buffers, its grid is B groups within the card."""
    plan = rr.red_recur_plan(b, h, w, cin, c, resident)
    bwd = rr.red_recur_bwd_plan(b, h, w, cin, c, resident)
    assert plan["convs"] == bwd["convs"][:2] and len(plan["convs"]) == 2
    assert plan["per_element"] == bwd["per_element"] and plan["blocks"] == bwd["blocks"]
    per = plan["per_element"]
    assert plan["blocks"] == b * per and 1 <= per and plan["blocks"] <= resident
    _check_convs(plan["convs"], h, w, cin, c)
    return plan


def test_forward_plan_at_every_call_of_a_train_step():
    """B = 1 at the 12 shapes of a 384×768 forward (and train step); the
    forward's blocks fit two an SM beside the backward's."""
    assert rr.RED_FWD_SMEM + 4 * 24 * rr.RED_BWD_THREADS == rr.RED_BWD_SMEM
    assert 2 * (rr.RED_FWD_SMEM + 1024) <= 233472
    for h, w, cin, c in _train_shapes():
        plan = _check_forward_plan(1, h, w, cin, c, RESIDENT)
        assert plan["per_element"] >= 64, (h, w, plan["per_element"])


def test_forward_plan_at_every_call_of_a_scene_chunk():
    """B = 4 tiles at the 12 shapes of a 4-tile chunk of 448² tiles: the grid
    is split four ways, each element at least 32 blocks, and each conv sums
    in the order of a B = 1 launch, so a tile's states do not depend on the
    tiles batched with it."""
    for h, w, cin, c in _chunk_shapes():
        plan = _check_forward_plan(4, h, w, cin, c, RESIDENT)
        assert plan["per_element"] >= 32, (h, w, plan["per_element"])
        assert _sum_order(plan) == _sum_order(rr.red_recur_plan(1, h, w, cin, c, RESIDENT))


@pytest.mark.parametrize("resident", [RESIDENT, 8])
def test_forward_plan_at_the_card_tests_shapes(resident):
    for b, h, w, cin, c in FWD_CARD_SHAPES:
        _check_forward_plan(b, h, w, cin, c, resident)


@pytest.mark.parametrize("c", [6, 2, 10, 1])
def test_plans_take_widths_that_are_not_a_multiple_of_4(c):
    """A width C that is not a multiple of 4 runs at C rounded up to 4: its
    forward and backward plans are that width's, cover it and fit their
    buffers, and an element of a B = 4 scene chunk or a B = 2 step sums in
    the order of its B = 1 launch."""
    c4 = rr.padded_width(c)
    assert c4 % 4 == 0 and c <= c4 < c + 4
    for b, h, w, cin in ((1, 8, 8, 4), (4, 112, 112, 16), (2, 96, 192, 8), (1, 384, 768, 8)):
        plan = _check_forward_plan(b, h, w, cin, c, RESIDENT)
        assert plan == rr.red_recur_plan(b, h, w, cin, c4, RESIDENT)
        assert _sum_order(plan) == _sum_order(rr.red_recur_plan(1, h, w, cin, c, RESIDENT))
        assert _check_plan(b, h, w, cin, c, RESIDENT) == rr.red_recur_bwd_plan(
            b, h, w, cin, c4, RESIDENT)


def test_forward_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="1 ≤ C ≤ 1024, got C = 1025"):
        rr.red_recur_plan(1, 8, 8, 4, 1025, RESIDENT)
    with pytest.raises(ValueError, match="32-bit"):
        rr.red_recur_plan(1, 4096, 8192, 64, 64, RESIDENT)
    with pytest.raises(ValueError, match="cooperative grid"):
        rr.red_recur_plan(RESIDENT + 1, 8, 8, 4, 8, RESIDENT)
    with pytest.raises(ValueError, match="cooperative grid"):
        rr.red_recur_plan(20000, 1, 4, 4, 4, RESIDENT)
