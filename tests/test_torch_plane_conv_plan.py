"""The launch plan of the plane convolutions on the CPU
(satmvs_tpu_torch/ops/kernels/plane_conv.py `plane_conv_plan`, CUDA
`conv3x3_kernel` and `deconv3x3_s2_kernel` of csrc/plane_conv.cu) at the 42
calls of a 384×768 train step (21 forwards, 21 dx), at the 33 call shapes of
the packed CostRegNet of a 384×768 forward (B = 1 and 2) and at the `cuda`
tests' shapes: the kernels' thread-to-output maps, written out here, cover every
output pixel and channel exactly once; the staged window holds every input a
tile reads; the window and the slab's weights fit the shared memory; and the
refusals.  The kernels themselves run only on the card
(tests/test_torch_kernels.py, `cuda`)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from satmvs_tpu_torch.ops.kernels import plane_conv as pc

ROOT = Path(__file__).resolve().parents[1]
# (stride, transposed, N, H, W, Cin, Cout, gated) of the `cuda` tests
CARD_SHAPES = [
    (2, False, 3, 16, 24, 8, 16, False), (2, False, 2, 7, 9, 6, 5, False),
    (2, False, 2, 12, 6, 32, 64, False), (2, True, 3, 8, 12, 16, 8, False),
    (2, True, 2, 5, 7, 6, 3, False), (2, True, 1, 3, 6, 64, 32, False),
    (1, False, 3, 16, 24, 8, 1, False), (1, False, 2, 7, 9, 6, 5, False),
    (2, True, 3, 8, 12, 16, 8, True), (2, True, 2, 4, 3, 5, 6, True),
    (2, False, 3, 8, 12, 8, 16, True), (2, False, 2, 10, 14, 3, 6, True),
    (1, False, 3, 16, 24, 1, 8, False), (1, False, 2, 7, 9, 5, 6, False),
    (2, False, 2, 37, 1, 64, 16, False), (2, False, 1, 5, 2, 8, 1, False),
    (2, True, 2, 9, 1, 64, 32, True), (2, True, 1, 2, 2, 16, 64, False),
    (1, False, 4, 33, 35, 8, 1, False), (1, False, 4, 33, 35, 1, 8, False),
    (2, False, 2, 66, 98, 64, 32, True), (2, True, 2, 33, 49, 64, 32, False)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _train_calls():
    calls = [c[2:] for c in _chip_smoke().plane_calls()]
    assert len(calls) == 42 and sum(c[1] for c in calls) == 18  # 9 deconv_up, 9 conv_dn dx
    return calls


def _costreg_calls(b: int):
    """The 33 call shapes of a 384×768 CostRegNet forward at B = b (each
    run once per depth tap): 12 conv_head (Cout 1-64), 9 conv_dn, 9
    deconv_up per family."""
    calls = [c[2:] for c in _chip_smoke().costreg_calls(b)]
    assert len(calls) == 33 and sum(c[1] for c in calls) == 9
    return calls


def _outputs(plan, transposed, stride, h, w, cout):
    """Every (row, column, channel) one image's blocks write, from the
    kernels' index arithmetic: block (tile, slab), thread (lc, txi, tyi),
    lc fastest; a conv thread writes rows y0 + 4·tyi + p of column x0 + txi,
    a transposed-conv thread the quads (2i + a, 2j + b) of input rows
    i0 + 2·tyi + q of column j0 + txi; each co_t channels from co0 + co_t·lc;
    nothing past the plane or Cout."""
    co_t, co_s, tx, ty = plan["co_t"], plan["slab"], plan["tx"], plan["ty"]
    lcn = co_s // co_t
    assert plan["threads"] == lcn * tx * ty
    rows = plan["tile_rows"]
    rows_in, cols_in = (h, w) if transposed else ((h - 1) // stride + 1, (w - 1) // stride + 1)
    ntx = -(-cols_in // tx)
    tiles, slabs, _ = plan["grid"]
    assert tiles == -(-rows_in // rows) * ntx and slabs == -(-cout // co_s)
    t = np.arange(plan["threads"])
    lc, txi, tyi = t % lcn, (t // lcn) % tx, t // (lcn * tx)
    bx, by = np.meshgrid(np.arange(tiles), np.arange(slabs), indexing="ij")
    y0 = (bx // ntx * rows).reshape(-1, 1, 1, 1)
    x0 = (bx % ntx * tx).reshape(-1, 1, 1, 1)
    co = (by * co_s).reshape(-1, 1, 1, 1) + (co_t * lc)[None, :, None, None] \
        + np.arange(co_t)[None, None, None, :]
    per = pc.QUAD_ROWS if transposed else pc.CONV_ROWS
    r = y0 + (per * tyi)[None, :, None, None] + np.arange(per)[None, None, :, None]
    c = x0 + txi[None, :, None, None] + 0 * r
    r, c, co = np.broadcast_arrays(r, c, co)
    ok = (r < rows_in) & (c < cols_in) & (co < cout)
    r, c, co = r[ok], c[ok], co[ok]
    if transposed:  # each input pixel writes its four output phases
        r = np.concatenate([2 * r + a for a in (0, 1) for b in (0, 1)])
        c = np.concatenate([2 * c + b for a in (0, 1) for b in (0, 1)])
        co = np.tile(co, 4)
        return r, c, co, 2 * h, 2 * w
    return r, c, co, rows_in, cols_in


def _check_plan(stride, transposed, n, h, w, cin, cout, gated):
    plan = pc.plane_conv_plan(stride, transposed, n, h, w, cin, cout, gated)
    assert plan in [{**o, "grid": plan["grid"]}
                    for o in pc.plane_conv_plan_options(stride, transposed, cin, cout, gated)]
    assert plan["grid"][2] == n
    # every output pixel and channel exactly once
    r, c, co, ho, wo = _outputs(plan, transposed, stride, h, w, cout)
    count = np.bincount((r * wo + c) * cout + co, minlength=ho * wo * cout)
    assert count.shape == (ho * wo * cout,) and (count == 1).all(), (plan, count.max())
    # the staged window holds every input a tile's outputs read
    rows, tx = plan["tile_rows"], plan["tx"]
    if transposed:  # input rows i .. i + 1 of the tile's rows, columns j .. j + 1
        need_r, need_c = rows + 1, tx + 1
    else:  # rows S·y + dy − 1 from the origin S·y0 − 1
        need_r, need_c = stride * (rows - 1) + 3, stride * (tx - 1) + 3
    smem = pc.plane_conv_smem(transposed, stride, gated, rows, tx, plan["ck"], plan["slab"])
    words = -(-plan["ck"] * need_r * need_c // 4) * 4
    assert smem == plan["smem"] == 4 * (words * (1 + gated) + 9 * plan["ck"] * plan["slab"])
    assert plan["smem"] <= pc.PLANE_SM_SMEM // 2 - 1024 <= pc.PLANE_MAX_SMEM == 232448
    # the plan's operands: vec, co_t, a slab of whole co_t, chunks of whole vec
    assert plan["vec"] == (4 if cin % 4 == 0 else 1) and plan["co_t"] == (1 if cout == 1 else 8)
    assert plan["slab"] % plan["co_t"] == 0 and plan["slab"] <= pc.PLANE_MAX_SLAB
    assert plan["ck"] % plan["vec"] == 0 and plan["ck"] <= -(-cin // plan["vec"]) * plan["vec"]
    lanes = plan["slab"] // plan["co_t"] * tx
    assert lanes >= 32 and plan["threads"] == lanes * plan["ty"] <= 256
    assert plan["threads"] % 32 == 0
    return plan


@pytest.mark.parametrize("half", [0, 1])
def test_plan_at_every_call_of_a_train_step(half):
    """The 42 calls: coverage, window and shared memory; each keeps 16 warps
    resident on an SM (two blocks of 256 or four of 128 threads)."""
    for call in _train_calls()[half::2]:
        plan = _check_plan(*call)
        assert pc._plane_resident(plan) * plan["threads"] >= 32 * pc.PLANE_WARPS, (call, plan)


@pytest.mark.parametrize("base", [6, 10, 12, 2])
def test_plan_at_every_call_of_other_base_widths(base):
    """The 42 calls of a train step at RED base widths the JAX package
    takes past the default 8 (`--cr_base_chs`): slabs of 3, 5 or 6 groups of
    8 channels (24, 40, 48) take thread rows that make whole warps, and the
    plans cover every output once."""
    calls = [c[2:] for c in _chip_smoke().plane_calls(base)]
    assert len(calls) == 42
    for call in calls:
        _check_plan(*call)


@pytest.mark.parametrize("b", [1, 2])
def test_plan_at_every_costreg_call(b):
    """The packed CostRegNet's calls at B = 1 and 2 (B·D planes in one
    call): coverage, window and shared memory under the chosen plan, from
    Cin = Cout = 64 at h/8 × w/8 to the 8 → 1 head at 384×768."""
    for call in _costreg_calls(b):
        _check_plan(*call)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_every_option_at_the_costreg_calls(stage):
    """Every plan the kernels may run at a stage's eleven CostRegNet call
    shapes (B = 1) covers each output once and fits the shared memory."""
    for stride, transposed, n, h, w, cin, cout, gated in _costreg_calls(1)[11 * (stage - 1):
                                                                         11 * stage]:
        for o in pc.plane_conv_plan_options(stride, transposed, cin, cout, gated):
            rows_in, cols_in = (h, w) if transposed else (-(-h // stride), -(-w // stride))
            plan = {**o, "grid": (-(-rows_in // o["tile_rows"]) * -(-cols_in // o["tx"]),
                                  -(-cout // o["slab"]), n)}
            r, c, co, ho, wo = _outputs(plan, transposed, stride, h, w, cout)
            count = np.bincount((r * wo + c) * cout + co, minlength=ho * wo * cout)
            assert (count == 1).all(), (h, w, cin, cout, o)
            assert o["smem"] <= pc.PLANE_SM_SMEM // 2 - 1024


def test_plan_at_the_card_tests_shapes():
    for shape in CARD_SHAPES:
        _check_plan(*shape)


@pytest.mark.parametrize("transposed,stride", [(False, 1), (False, 2), (True, 2)])
def test_every_option_covers_every_output(transposed, stride):
    """Every plan the kernels may run (`plane_conv_plan_options`, which the
    `cuda` tests and `kernel_ab.py --sweep` launch) at an odd shape and at
    Cout = 1 covers each output once and fits the shared memory."""
    for n, h, w, cin, cout, gated in ((2, 9, 13, 12, 24, transposed), (1, 7, 5, 8, 1, False)):
        for o in pc.plane_conv_plan_options(stride, transposed, cin, cout, gated):
            rows_in, cols_in = (h, w) if transposed else (-(-h // stride), -(-w // stride))
            plan = {**o, "grid": (-(-rows_in // o["tile_rows"]) * -(-cols_in // o["tx"]),
                                  -(-cout // o["slab"]), n)}
            r, c, co, ho, wo = _outputs(plan, transposed, stride, h, w, cout)
            count = np.bincount((r * wo + c) * cout + co, minlength=ho * wo * cout)
            assert (count == 1).all(), o
            assert o["smem"] <= pc.PLANE_SM_SMEM // 2 - 1024


def test_stride2_window_columns_split_even_then_odd():
    """A stride-2 window keeps its even columns, then its odd ones
    (plane_conv.cu `win_col`): a bijection, and the three taps of output
    column x read columns x, half + x and x + 1 of the split."""
    for wc in (3, 17, 33, 65):
        half = (wc + 1) // 2
        split = [c // 2 if c % 2 == 0 else half + c // 2 for c in range(wc)]
        assert sorted(split) == list(range(wc))
        for x in range((wc - 3) // 2 + 1):
            assert [split[2 * x + dx] for dx in range(3)] == [x, half + x, x + 1]


def test_plan_refuses_what_the_kernels_cannot_run():
    with pytest.raises(ValueError, match="stride"):
        pc.plane_conv_plan(3, False, 1, 8, 8, 4, 4)
    with pytest.raises(ValueError, match="stride"):
        pc.plane_conv_plan(1, True, 1, 8, 8, 4, 4)
    for shape in ((0, 8, 8, 4, 4), (1, 0, 8, 4, 4), (1, 8, 8, 0, 4), (1, 8, 8, 4, 0)):
        with pytest.raises(ValueError, match="empty"):
            pc.plane_conv_plan(2, False, *shape)
    with pytest.raises(ValueError, match="65535"):
        pc.plane_conv_plan(2, True, 70000, 4, 4, 8, 8)
    with pytest.raises(ValueError, match="too large"):
        pc.plane_conv_plan(1, False, 1, 2 ** 26, 2 ** 26, 8, 8)
