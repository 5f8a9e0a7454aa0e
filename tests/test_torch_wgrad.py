"""The shared 3×3 weight reduction of the port's backward kernels
(satmvs_tpu_torch/ops/kernels/plane_conv.py `wgrad3x3`, CUDA `wgrad3x3_f32`)
on the CPU: its plain version `wgrad3x3_reference` against the weight and
bias cotangents of the four plain backwards (themselves held against JAX's
Pallas VJPs by tests/test_torch_plane_conv_bwd.py and
tests/test_torch_red_recur_bwd.py) and against a direct sum over taps, in
float64 to 1e-10; and the launch plan `wgrad3x3_plan` at every call shape of
a 384×768 train step.  The kernel itself runs only on the card
(tests/test_torch_kernels.py, `cuda`)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from satmvs_tpu_torch.nn.blocks import ConvGRUCell
from satmvs_tpu_torch.ops.kernels import plane_conv as pc
from satmvs_tpu_torch.ops.kernels import red_recur as rr
from satmvs_tpu_torch.ops.kernels.sweep_gather import scatter_planes
from satmvs_tpu_torch.params import init_from_seed

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-10


def _rand(shape, seed, scale=1.0):
    return torch.from_numpy(scale * np.random.default_rng(seed).normal(size=shape))


def _close(got, want, what):
    err = (got - want).abs().max().item()
    assert got.shape == want.shape, (what, tuple(got.shape), tuple(want.shape))
    assert err <= TOL * max(1.0, want.abs().max().item()), (what, err)


def _direct(a, b, stride):
    """dw[dy, dx, ca, cb] as a sum over taps of shifted channel products."""
    n, ha, wa, _ = a.shape
    _, hb, wb, _ = b.shape
    pad = torch.nn.functional.pad(a, (0, 0, 1, 1 + stride * hb, 1, 1 + stride * wb))
    out = []
    for dy in range(3):
        for dx in range(3):
            win = pad[:, dy:dy + stride * hb:stride, dx:dx + stride * wb:stride]
            out.append(torch.einsum("nyxa,nyxb->ab", win, b))
    return torch.stack(out).reshape(3, 3, a.shape[-1], b.shape[-1])


@pytest.mark.parametrize("which", ["conv_dn", "deconv_up", "conv_head"])
def test_reference_matches_the_conv_backwards(which):
    """The weight (and bias) cotangents of the plain conv backwards, with
    the operands their CUDA backwards hand to `wgrad3x3`."""
    x = _rand((2, 8, 12, 6), 1)
    if which == "conv_dn":
        wt = _rand((5, 6, 3, 3), 2, 0.3)
        y = pc.conv_dn_reference(x, wt)
        g = _rand(tuple(y.shape), 3)
        _, want = pc.conv_dn_backward_reference(x, wt, y, g)
        dw, db = pc.wgrad3x3_reference(x, g, 2, bmask=y)
    elif which == "deconv_up":
        wt = _rand((6, 5, 3, 3), 4, 0.3)
        act = pc.deconv_up_reference(x, wt)
        g = _rand(tuple(act.shape), 5)
        _, want = pc.deconv_up_backward_reference(x, wt, act, g)
        dw, db = pc.wgrad3x3_reference(g, x, 2, amask=act)
    else:
        wt = _rand((1, 6, 3, 3), 6, 0.3)
        g = _rand((2, 8, 12, 1), 7)
        _, want, want_b = pc.conv_head_backward_reference(x, wt, g)
        dw, db = pc.wgrad3x3_reference(x, g, 1, bias=True)
        _close(db, want_b, "conv_head dbias")
    if which != "conv_head":
        assert db is None
    _close(pc.torch_weight(dw), want, f"{which} dweight")


def test_reference_matches_the_red_recur_backward():
    """red_recur's CUDA backward reduces the per-plane cotangents of the
    gates (dg, over [x | h_prev]) and of the candidate (dyl, over
    [x | r·h_prev]); from a traced plain forward they give the conv
    cotangents of `red_recur_backward_reference`."""
    d, h, w, cin, c = 3, 6, 8, 4, 4
    cell = init_from_seed(ConvGRUCell(cin, c), 8).double()
    x = _rand((1, d, h, w, cin), 9)
    with torch.no_grad():
        out = rr.red_recur_reference(x, cell)
    g = _rand(tuple(out.shape), 10)
    _, want = rr.red_recur_backward_reference(x, out, g, cell)

    # the cell's step written out, keeping the pre-norm gate and candidate sums
    xc = cell.x_contrib(x[0].permute(0, 3, 1, 2))
    hs, gates, cands, ms = [torch.zeros((1, c, h, w), dtype=torch.float64)], [], [], []
    for i in range(d):
        hp = hs[-1]
        gt = xc[i:i + 1, :2 * c] + cell.conv_h(hp)
        r = torch.sigmoid(cell.gn_r(gt[:, :c]))
        u = torch.sigmoid(cell.gn_u(gt[:, c:]))
        m = r * hp
        cd = xc[i:i + 1, 2 * c:] + cell.conv_c(m)
        hs.append(u * hp + (1 - u) * torch.tanh(cell.gn_y(cd)))
        gates.append(gt)
        cands.append(cd)
        ms.append(m)
    states = torch.cat(hs[1:]).permute(0, 2, 3, 1)
    _close(states, out[0], "traced forward")
    dgs = torch.autograd.grad(states, gates + cands, g[0])
    nhwc = lambda ts: torch.cat(ts).permute(0, 2, 3, 1).contiguous()  # noqa: E731
    dg, dyl = nhwc(dgs[:d]), nhwc(dgs[d:])
    hprev = nhwc(hs[:-1]).detach()
    dwa, dba = pc.wgrad3x3_reference(x[0], dg, 1, a2=hprev, bias=True)
    dwb, dbb = pc.wgrad3x3_reference(x[0], dyl, 1, a2=nhwc(ms).detach(), bias=True)
    got = rr._param_grads(cell, dwa, dba, dwb, dbb, torch.zeros((6, c), dtype=torch.float64))
    for (name, _), a, b in zip(cell.named_parameters(), got, want):
        if name.startswith("conv"):
            _close(a, b, name)


@pytest.mark.parametrize("n,ha,wa,ca1,ca2,cb,stride,amask,bmask,bias", [
    (2, 7, 9, 3, 0, 5, 1, True, True, True),     # odd sizes and channels, both masks
    (1, 10, 6, 4, 8, 1, 1, False, False, True),  # the concat, CB = 1, bias
    (2, 8, 12, 6, 0, 3, 2, False, True, False),  # stride 2, bmask, odd CB
    (1, 6, 10, 5, 0, 4, 2, True, False, False),  # stride 2, amask
    (1, 5, 7, 4, 4, 7, 1, False, True, True),    # the concat with bmask, odd CB
])
def test_reference_cases(n, ha, wa, ca1, ca2, cb, stride, amask, bmask, bias):
    """Against a direct sum over the nine taps of the masked, concatenated
    operands: masks, the concat a2, strides 1 and 2, odd CB and CB = 1."""
    hb, wb = (ha - 1) // stride + 1, (wa - 1) // stride + 1
    a1, b = _rand((n, ha, wa, ca1), 11), _rand((n, hb, wb, cb), 12)
    a2 = _rand((n, ha, wa, ca2), 13) if ca2 else None
    am = _rand((n, ha, wa, ca1), 14) if amask else None
    bm = _rand((n, hb, wb, cb), 15) if bmask else None
    dw, db = pc.wgrad3x3_reference(a1, b, stride, a2=a2, amask=am, bmask=bm, bias=bias)
    a = a1 if am is None else a1 * (am > 0)
    a = a if a2 is None else torch.cat([a, a2], dim=-1)
    bb = b if bm is None else b * (bm > 0)
    _close(dw, _direct(a, bb, stride), "dweight")
    assert (db is None) != bias
    if bias:
        _close(db, bb.sum((0, 1, 2)), "dbias")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _step_calls():
    """(label, n, hb, wb, ca, cb, stride) of every weight reduction of a
    384×768, B = 1 train step: the convs' 9 + 9 + 3 and red_recur's 24."""
    cs = _chip_smoke()
    b = cs.RED_BASE
    calls = []
    for stage, d, h, w, cin in cs.red_shapes():
        for s, ci, co in ((1, cin, 2 * b), (2, 2 * b, 4 * b), (4, 4 * b, 8 * b)):
            calls.append((f"{stage} dn{s}", d, h // s // 2, w // s // 2, ci, co, 2))
        for s, ci, c in cs.red_scales(cin):
            calls.append((f"{stage} gates{s}", d, h // s, w // s, ci + c, 2 * c, 1))
            calls.append((f"{stage} cand{s}", d, h // s, w // s, ci + c, c, 1))
        for s, ci, co in ((8, 8 * b, 4 * b), (4, 4 * b, 2 * b), (2, 2 * b, b)):
            calls.append((f"{stage} up{s}", d, h // s, w // s, co, ci, 2))
        calls.append((f"{stage} head", d, h, w, b, 1, 1))
    assert len(calls) == 45
    return calls


def test_plan_covers_every_call_of_a_train_step():
    """At every call shape: the launch covers every pixel and every output,
    no block is empty, shared memory and the thread count stay in the card's
    limits, the register tile far under 255, and fp32 runs of ~10³ pixels."""
    for label, n, hb, wb, ca, cb, stride in _step_calls():
        p = pc.wgrad3x3_plan(n, hb, wb, ca, cb, stride)
        nxt = -(-wb // p["tp"])
        assert nxt * p["tp"] >= wb > (nxt - 1) * p["tp"], label
        assert p["tiles"] == n * hb * nxt, label
        assert p["gx"] * p["tiles_per_block"] >= p["tiles"] > (p["gx"] - 1) * p["tiles_per_block"]
        assert p["gy"] == -(-ca // p["ca_t"]) * -(-cb // p["cb_t"]), label
        assert p["ca_t"] % 4 == 0 and p["cb_t"] % 4 == 0 and p["ca_t"] <= 32, label
        assert p["threads"] == p["lanes"] * 3 * (p["ca_t"] // 4) * (p["cb_t"] // 4)
        assert p["threads"] <= pc.WGRAD_THREADS <= 256, label
        assert p["lanes"] <= p["tp"], label
        want_smem = 16 * (3 * (stride * p["tp"] + 2) * (p["ca_t"] // 4)
                          + p["tp"] * (p["cb_t"] // 4))
        assert p["smem"] == want_smem <= 232448, label
        assert pc.WGRAD_TILE + 4 <= 255
        assert p["run"] * p["tp"] // p["lanes"] <= 2 * pc.WGRAD_RUN, label
        assert p["gx"] * p["gy"] >= min(132, p["tiles"] * p["gy"]), label


def test_plan_raises_for_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        pc.wgrad3x3_plan(1, 8, 8, 4, 4, 3)
    with pytest.raises(ValueError):
        pc.wgrad3x3_plan(1, 8, 8, 0, 4, 1)
    with pytest.raises(ValueError):
        pc.wgrad3x3_plan(0, 8, 8, 4, 4, 1)
    with pytest.raises(ValueError):  # 9·CA·CB outputs past a 32-bit index
        pc.wgrad3x3_plan(1, 8, 8, 20000, 20000, 1)
    with pytest.raises(ValueError):  # the kernel is for CUDA tensors
        pc.wgrad3x3("test", torch.zeros((1, 4, 4, 4)), torch.zeros((1, 4, 4, 4)), 1)


def test_scatter_planes_cut_the_sweep_into_equal_chunks():
    for d, h, w, groups in ((64, 96, 192, 8), (32, 192, 384, 4), (8, 384, 768, 2),
                            (3, 7, 9, 6), (1, 1, 1, 1)):
        p = scatter_planes(d, h, w, groups)
        chunks = -(-d // p)
        assert 1 <= p <= d and chunks * p >= d > (chunks - 1) * p
