"""The launch plans of two kernels on the CPU: the ConvGRU adjoint's
(satmvs_tpu_torch/ops/kernels/red_recur.py `red_recur_bwd_plan`, CUDA
`red_recur_bwd_kernel`) at every call shape of a 384×768 train step, at
B = 1 and 2 and at the card tests' shapes; the layout of its transposed
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


def _train_shapes():
    """(H, W, Cin, C) of the 12 red_recur calls of a 384×768 train step."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    shapes = [(h // s, w // s, ci, c) for _, _, h, w, cin in cs.red_shapes()
              for s, ci, c in cs.red_scales(cin)]
    assert len(shapes) == 12
    return shapes


def _check_plan(b, h, w, cin, c, resident):
    plan = rr.red_recur_bwd_plan(b, h, w, cin, c, resident)
    per = plan["per_element"]
    assert plan["blocks"] == b * per and 1 <= per and plan["blocks"] <= resident
    couts = (2 * c, c, c, c + cin)
    for conv, cout, nraw in zip(plan["convs"], couts, rr._NRAW):
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
    # the own-pixel passes cover the plane, four channels a thread
    lanes = rr.RED_BWD_THREADS // (c // 4)
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
    for c in (6, 0, 2, 4 * rr.RED_BWD_THREADS + 4):
        with pytest.raises(ValueError):
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
