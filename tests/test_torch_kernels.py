"""The kernel wrappers (sweep_variance and sweep_variance_batched and their
backward sweep_variance_backward, conv_dn, deconv_up, conv_head, red_recur,
sweep_gather and sweep_scatter in fp32 and bf16, the backwards of conv_dn,
deconv_up, conv_head and red_recur, and the CostRegNet's whole-block
conv3d_block and deconv3d_block): CPU tensors take the plain
version, CUDA tensors the CUDA kernel (tests marked `cuda` need a GPU and
nvcc and skip without them), every wrapper but the forward-only
CostRegNet forms carries an autograd graph on both, and the modules import
without nvcc."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from satmvs_tpu_torch.ops.kernels import build
from satmvs_tpu_torch.ops.kernels.sweep_variance import (
    sweep_variance, sweep_variance_reference)

ROOT = Path(__file__).resolve().parents[1]


def _inputs(s=2, d=3, h=10, w=14, c=8, spread=2.0, seed=0, device="cpu"):
    """Features and sample coordinates, a share of them off the image."""
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=(h, w, c)).astype(np.float32)
    srcs = rng.normal(size=(s, h, w, c)).astype(np.float32)
    xs = rng.uniform(-spread, w - 1 + spread, (s, d, h, w)).astype(np.float32)
    ys = rng.uniform(-spread, h - 1 + spread, (s, d, h, w)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (ref, srcs, xs, ys)]


def test_cpu_tensors_take_the_plain_version():
    before = sweep_variance.launches
    args = _inputs()
    out = sweep_variance(*args)
    assert sweep_variance.launches == before == 0
    assert out.shape == (3, 10, 14, 8) and out.dtype == torch.float32
    torch.testing.assert_close(out, sweep_variance_reference(*args), rtol=0, atol=0)
    assert (out >= -1e-5).all()  # a variance


def test_wrapper_rejects_what_the_kernel_does_not_take():
    ref, srcs, xs, ys = _inputs()
    with pytest.raises(TypeError):
        sweep_variance(ref.double(), srcs, xs, ys)
    with pytest.raises(ValueError):
        sweep_variance(ref, srcs[:1], xs, ys)
    with pytest.raises(ValueError):
        sweep_variance(ref, srcs, xs, ys[:, :2])
    with pytest.raises(ValueError):
        sweep_variance(ref[None], srcs, xs, ys)


def test_kernel_module_imports_without_nvcc(tmp_path, monkeypatch):
    """Importing the kernel modules needs no compiler; only a build does."""
    env = {**os.environ, "PATH": str(tmp_path), "CUDA_HOME": str(tmp_path),
           "PYTHONPATH": str(ROOT)}
    code = ("import satmvs_tpu_torch.ops.kernels.sweep_variance, "
            "satmvs_tpu_torch.ops.kernels.plane_conv, "
            "satmvs_tpu_torch.ops.kernels.red_recur, "
            "satmvs_tpu_torch.ops.kernels.sweep_gather, "
            "satmvs_tpu_torch.ops.kernels.conv3d_block, "
            "satmvs_tpu_torch.models.cascade, satmvs_tpu_torch.infer.scene, "
            "satmvs_tpu_torch.infer.predict, satmvs_tpu_torch.train")
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()
    assert {"sweep_variance", "plane_conv", "red_recur", "sweep_gather",
            "conv3d_block"} <= set(build.sources())


@pytest.mark.cuda
@pytest.mark.parametrize("c,spread", [(8, 0.0), (32, 3.0), (6, 3.0)])
def test_cuda_kernel_matches_plain_version(c, spread):
    """The CUDA kernel (float4 path for C % 4 == 0, scalar path otherwise)
    against the plain version on the card, coordinates partly off-image:
    1e-5 on O(1) variances (FMA contraction and summation order differ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _inputs(c=c, spread=spread, device="cuda")
    before = sweep_variance.launches
    out = sweep_variance(*args)
    torch.cuda.synchronize()
    assert sweep_variance.launches == before + 1
    torch.testing.assert_close(out, sweep_variance_reference(*args), rtol=0, atol=1e-5)


def _batched_inputs(b, s, d, h, w, c, mode, seed=0, device="cuda"):
    """Features (B, S + 1, H, W, C) and coordinates xs, ys (B, S, D, H, W):
    "window", planes a fraction of a pixel apart around a random shift of
    each pixel (corners kept from plane to plane, some off the image), or
    "off-image", uniform over and beyond the image, some far off."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, s + 1, h, w, c))
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    if mode == "window":
        shift = rng.uniform(-3, 3, (b, s, 1, h, w)) + 0.3 * np.arange(d)[:, None, None]
        xs = np.broadcast_to(gx + shift, (b, s, d, h, w))
        ys = np.broadcast_to(gy + 0.5 * shift + rng.uniform(-0.5, 0.5, (b, s, 1, h, w)), xs.shape)
    else:
        xs = rng.uniform(-2, w + 1, (b, s, d, h, w))
        ys = rng.uniform(-2, h + 1, (b, s, d, h, w))
        xs.reshape(-1)[::37] = 1e9
        ys.reshape(-1)[::41] = -1e9
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
            for a in (feats, xs, ys)]


# (B, S, D, H, W, C): C = 6 (scalar path), 8, 16, 32, three source views, one pixel
BATCHED_CARD_SHAPES = [(3, 2, 5, 12, 20, 6), (2, 2, 8, 16, 24, 8), (2, 2, 4, 9, 13, 16),
                       (4, 2, 3, 7, 33, 32), (2, 3, 5, 7, 9, 12), (1, 2, 1, 1, 1, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["window", "off-image"])
@pytest.mark.parametrize("shape", BATCHED_CARD_SHAPES)
def test_cuda_batched_sweep_matches_plain_version(shape, mode):
    """One launch for the batch, against the plain version (1e-5 × max(1,
    max |plain|), as the B = 1 test) and, sample by sample, against a B = 1
    `sweep_variance` call (the same bits)."""
    from satmvs_tpu_torch.ops.kernels.sweep_variance import (
        sweep_variance_batched, sweep_variance_batched_reference)

    _cuda()
    feats, xs, ys = _batched_inputs(*shape, mode)
    before = sweep_variance.launches
    out = sweep_variance_batched(feats, xs, ys)
    torch.cuda.synchronize()
    assert sweep_variance.launches == before + 1
    _close(out, sweep_variance_batched_reference(feats, xs, ys), f"batched sweep {shape} {mode}")
    for i in range(shape[0]):
        assert torch.equal(out[i], sweep_variance(feats[i, 0], feats[i, 1:], xs[i], ys[i]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2, 32, 24, 48, 32), (2, 2, 8, 40, 200, 8)])
def test_cuda_sweep_under_every_plan(shape):
    """Every plan of `sweep_variance_plan_options` (tile, channel groups and
    planes a thread) at a coarse and a wide shape gives the chosen plan's
    bits, which are the plain version's within 1e-5."""
    from satmvs_tpu_torch.ops.kernels import sweep_variance as sv

    _cuda()
    feats, xs, ys = _batched_inputs(*shape, "window", seed=1)
    want = sv._batched(feats, xs, ys)
    _close(want, sv.sweep_variance_batched_reference(feats, xs, ys), f"sweep {shape}")
    options = sv.sweep_variance_plan_options(*shape)
    assert len(options) > 10
    for plan in options:
        assert torch.equal(sv._batched(feats, xs, ys, plan), want), plan


@pytest.mark.cuda
def test_cuda_sweep_same_bits_in_a_second_run():
    from satmvs_tpu_torch.ops.kernels.sweep_variance import sweep_variance_batched

    _cuda()
    feats, xs, ys = _batched_inputs(4, 2, 8, 56, 56, 32, "window", seed=2)
    assert torch.equal(sweep_variance_batched(feats, xs, ys), sweep_variance_batched(feats, xs, ys))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 6])
@pytest.mark.parametrize("s", [5, 7])
def test_cuda_sweep_more_than_four_views(s, c):
    """Five and seven source views (six and eight views; the kernel walks
    them in groups of four): against the plain version (1e-5 × max(1, max
    |plain|)), the same bits in a second run, under every plan, and each
    of B = 2 samples the same bits as its B = 1 call."""
    from satmvs_tpu_torch.ops.kernels import sweep_variance as sv

    _cuda()
    shape = (2, s, 6, 14, 40, c)
    for mode in ("window", "off-image"):
        feats, xs, ys = _batched_inputs(*shape, mode, seed=s)
        before = sweep_variance.launches
        out = sv.sweep_variance_batched(feats, xs, ys)
        torch.cuda.synchronize()
        assert sweep_variance.launches == before + 1
        _close(out, sv.sweep_variance_batched_reference(feats, xs, ys), f"sweep S={s} {mode}")
        assert torch.equal(out, sv.sweep_variance_batched(feats, xs, ys))
        for i in range(2):
            assert torch.equal(out[i], sweep_variance(feats[i, 0], feats[i, 1:], xs[i], ys[i]))
        for plan in sv.sweep_variance_plan_options(*shape):
            assert torch.equal(sv._batched(feats, xs, ys, plan), out), plan


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False  # the plain versions in full fp32


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).cuda()


def _close(got, want, what):
    """1e-5 × max(1, max |plain|): fp32 sums in another order than cuDNN's."""
    torch.cuda.synchronize()
    tol = 1e-5 * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert got.shape == want.shape, what
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", [(3, 16, 24, 8, 16), (2, 7, 9, 6, 5),
                                            (2, 12, 6, 32, 64), (2, 12, 20, 12, 24),
                                            (2, 8, 10, 20, 40)])
def test_cuda_conv_dn_matches_plain_version(n, h, w, cin, cout):
    """Even and odd sizes, Cin and Cout with and without C % 4 == 0, slabs
    of 3 and 5 groups of 8 channels (`cr_base_chs` 6 and 10)."""
    from satmvs_tpu_torch.ops.kernels.plane_conv import conv_dn, conv_dn_reference

    _cuda()
    x, wt = _rand((n, h, w, cin), 0), _rand((cout, cin, 3, 3), 1, 0.2)
    before = conv_dn.launches
    out = conv_dn(x, wt)
    assert conv_dn.launches == before + 1
    _close(out, conv_dn_reference(x, wt), "conv_dn")


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,skip", [(3, 8, 12, 16, 8, True), (2, 5, 7, 6, 3, False),
                                                 (1, 3, 6, 64, 32, True),
                                                 (2, 6, 10, 48, 24, True),
                                                 (1, 4, 6, 80, 40, False)])
def test_cuda_deconv_up_matches_plain_version(n, h, w, cin, cout, skip):
    """Transposed conv with the torch-exact index map, odd edges included,
    with and without the fused skip add."""
    from satmvs_tpu_torch.ops.kernels.plane_conv import deconv_up, deconv_up_reference

    _cuda()
    x, wt = _rand((n, h, w, cin), 2), _rand((cin, cout, 3, 3), 3, 0.2)
    s = _rand((n, 2 * h, 2 * w, cout), 4) if skip else None
    before = deconv_up.launches
    out = deconv_up(x, wt, s)
    assert deconv_up.launches == before + 1
    _close(out, deconv_up_reference(x, wt, s), "deconv_up")


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", [(3, 16, 24, 8, 1), (2, 7, 9, 6, 5)])
def test_cuda_conv_head_matches_plain_version(n, h, w, cin, cout):
    from satmvs_tpu_torch.ops.kernels.plane_conv import conv_head, conv_head_reference

    _cuda()
    x, wt, b = _rand((n, h, w, cin), 5), _rand((cout, cin, 3, 3), 6, 0.2), _rand((cout,), 7)
    before = conv_head.launches
    out = conv_head(x, wt, b)
    assert conv_head.launches == before + 1
    _close(out, conv_head_reference(x, wt, b), "conv_head")


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,w,cin,c,seeded", [(5, 16, 24, 8, 8, False), (4, 7, 9, 6, 4, True),
                                                (3, 6, 12, 64, 64, True),
                                                (3, 10, 36, 12, 12, True),
                                                (2, 9, 20, 24, 24, False),
                                                (4, 9, 20, 6, 6, True), (3, 8, 12, 5, 2, False),
                                                (3, 7, 16, 10, 10, True), (2, 5, 7, 3, 1, True),
                                                (3, 6, 10, 20, 1032, True),
                                                (2, 5, 7, 9, 1030, False),
                                                (2, 4, 6, 12, 2056, True)])
def test_cuda_red_recur_matches_plain_version(d, h, w, cin, c, seeded):
    """Odd sizes, Cin % 4 != 0, C = 64, C = 12 and 24 (the cells
    `cr_base_chs` 12 gives), C = 6, 2, 10 and 1 (run padded to a multiple
    of 4), C = 1032, 1030 (run at 1032) and 2056, past the 1024 channels
    where a thread of the own-pixel passes walks more than one group, zero
    and seeded start states: 1e-4 on states in (−1, 1) (GroupNorm
    statistics in float64 against torch's fp32)."""
    from satmvs_tpu_torch.nn.blocks import ConvGRUCell
    from satmvs_tpu_torch.ops.kernels.red_recur import red_recur, red_recur_reference

    _cuda()
    torch.manual_seed(c)
    cell = ConvGRUCell(cin, c).cuda()
    with torch.no_grad():
        for norm in (cell.gn_r, cell.gn_u, cell.gn_y):
            norm.weight.copy_(_rand((c,), 8, 0.3) + 1.0)
            norm.bias.copy_(_rand((c,), 9, 0.2))
        x = _rand((d, h, w, cin), 10)
        h0 = torch.tanh(_rand((h, w, c), 11)) if seeded else None
        before = red_recur.launches
        out = red_recur(x, cell, h0)
        assert red_recur.launches == before + 1
        torch.cuda.synchronize()
        err = (out - red_recur_reference(x, cell, h0)).abs().max().item()
    assert err <= 1e-4, f"red_recur: max abs err {err}"


def _red_cell(cin, c, seed):
    from satmvs_tpu_torch.nn.blocks import ConvGRUCell

    torch.manual_seed(seed)
    cell = ConvGRUCell(cin, c).cuda()
    with torch.no_grad():
        for norm in (cell.gn_r, cell.gn_u, cell.gn_y):
            norm.weight.copy_(_rand((c,), seed + 1, 0.3) + 1.0)
            norm.bias.copy_(_rand((c,), seed + 2, 0.2))
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,h,w,cin,c", [(3, 4, 7, 9, 6, 4), (2, 3, 6, 12, 64, 64),
                                           (4, 5, 16, 24, 8, 8), (2, 3, 8, 12, 6, 6),
                                           (3, 2, 9, 11, 5, 10)])
def test_cuda_batched_red_recur_matches_plain_version(b, d, h, w, cin, c):
    """B elements in one launch, each from its own seeded h0, against the
    plain version applied to each element: 1e-4 on states in (−1, 1)."""
    from satmvs_tpu_torch.ops.kernels.red_recur import red_recur, red_recur_reference

    _cuda()
    cell = _red_cell(cin, c, 20)
    with torch.no_grad():
        x = _rand((b, d, h, w, cin), 23)
        h0 = torch.tanh(_rand((b, h, w, c), 24))
        before = red_recur.launches
        out = red_recur(x, cell, h0)
        assert red_recur.launches == before + 1
        torch.cuda.synchronize()
        err = (out - red_recur_reference(x, cell, h0)).abs().max().item()
    assert out.shape == (b, d, h, w, c)
    assert err <= 1e-4, f"batched red_recur: max abs err {err}"


@pytest.mark.cuda
def test_cuda_batched_red_recur_elements_are_independent():
    """Each element of a B = 4 launch against a B = 1 launch on that element
    alone: the same per-pixel arithmetic, the GroupNorm sums split over
    other block counts (1e-4)."""
    from satmvs_tpu_torch.ops.kernels.red_recur import red_recur

    _cuda()
    cell = _red_cell(16, 16, 30)
    with torch.no_grad():
        x = _rand((4, 6, 20, 28, 16), 33)
        h0 = torch.tanh(_rand((4, 20, 28, 16), 34))
        out = red_recur(x, cell, h0)
        for b in range(4):
            err = (out[b] - red_recur(x[b], cell, h0[b])).abs().max().item()
            assert err <= 1e-4, f"element {b}: max abs err {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,h,w,cin,c", [(1, 3, 6, 12, 64, 64), (2, 2, 32, 160, 16, 8)])
def test_cuda_red_recur_under_every_plan(b, d, h, w, cin, c):
    """The forward with each of its two convs (the gates, the candidate)
    under every (px, wr, wc, wk, ck) the kernels run, the other conv at the
    plan's own, against the plain version (1e-4 on states in (−1, 1)): a
    coarse plane at C = 64, a few column tiles (the plan splits input
    channels over warps), and a wide one at C = 8, B = 2."""
    from satmvs_tpu_torch.ops.kernels import red_recur as rr

    _cuda()
    assert rr._lib().red_recur_smem() == rr.RED_FWD_SMEM
    cell = _red_cell(cin, c, 90 + c)
    with torch.no_grad():
        x = _rand((b, d, h, w, cin), 91)
        h0 = torch.tanh(_rand((b, h, w, c), 92))
        want = rr.red_recur_reference(x, cell, h0)
        base = rr.red_recur_plan(b, h, w, cin, c, rr.resident())
        for i, cout in enumerate((2 * c, c)):
            for conv in rr.conv_plan_options(cout, rr._NRAW[i]):
                plan = {**base, "convs": [conv if j == i else p
                                          for j, p in enumerate(base["convs"])]}
                err = (rr._launch(x, cell, h0, plan) - want).abs().max().item()
                assert err <= 1e-4, (i, conv, err)


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,h,w,cin,c", [(4, 3, 12, 24, 64, 64), (4, 2, 56, 56, 8, 8),
                                           (2, 3, 24, 40, 6, 6)])
def test_cuda_red_recur_same_bits_in_a_second_run(b, d, h, w, cin, c):
    """B = 4 seeded elements at a coarse and a wide shape: a second launch
    gives the same bits (statistics in a fixed order, no atomics)."""
    from satmvs_tpu_torch.ops.kernels import red_recur as rr

    _cuda()
    cell = _red_cell(cin, c, 95)
    with torch.no_grad():
        x = _rand((b, d, h, w, cin), 96)
        h0 = torch.tanh(_rand((b, h, w, c), 97))
        assert torch.equal(rr.red_recur(x, cell, h0), rr.red_recur(x, cell, h0))


@pytest.mark.cuda
def test_cuda_red_recur_refused_grid_raises(monkeypatch):
    """A grid the card cannot hold raises and launches nothing: more
    elements than resident blocks (the launch plan refuses it), and a grid
    cudaLaunchCooperativeKernel refuses; a launch after either still runs."""
    from satmvs_tpu_torch.ops.kernels import red_recur as rr

    _cuda()
    cell = _red_cell(4, 4, 40)
    before = rr.red_recur.launches
    with torch.no_grad():
        with pytest.raises(ValueError, match="no cooperative grid"):
            rr.red_recur(_rand((20000, 1, 4, 4, 4), 41), cell)
        x = _rand((2, 3, 8, 8, 4), 42)
        plan = rr.red_recur_plan(2, 8, 8, 4, 4, rr.resident())
        monkeypatch.setattr(rr, "red_recur_plan",
                            lambda *args: {**plan, "blocks": 2 * 4000, "per_element": 4000})
        with pytest.raises(RuntimeError, match="launch failed"):
            rr.red_recur(x, cell)
        assert rr.red_recur.launches == before
        monkeypatch.undo()
        out = rr.red_recur(x, cell)
        torch.cuda.synchronize()
    assert rr.red_recur.launches == before + 1
    assert (out - rr.red_recur_reference(x, cell)).abs().max().item() <= 1e-4


def _graph_cases(device):
    """(wrapper name, call) of the five forward wrappers, on small seeded
    inputs with x (and the weights) requiring a gradient."""
    from satmvs_tpu_torch.nn.blocks import ConvGRUCell
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc
    from satmvs_tpu_torch.ops.kernels.red_recur import red_recur

    def t(shape, seed, scale=1.0):
        rng = np.random.default_rng(seed)
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).to(
            device).requires_grad_(True)

    ref, srcs, xs, ys = _inputs(device=device)
    torch.manual_seed(0)
    cell = ConvGRUCell(4, 4).to(device)
    return [
        ("sweep_variance", lambda: sweep_variance(ref.requires_grad_(True), srcs, xs, ys)),
        ("conv_dn", lambda: pc.conv_dn(t((2, 8, 8, 4), 1), t((8, 4, 3, 3), 2, 0.2))),
        ("deconv_up", lambda: pc.deconv_up(t((2, 4, 4, 8), 3), t((8, 4, 3, 3), 4, 0.2))),
        ("conv_head", lambda: pc.conv_head(t((2, 8, 8, 8), 5), t((1, 8, 3, 3), 6, 0.2),
                                           t((1,), 7))),
        ("red_recur", lambda: red_recur(t((3, 6, 8, 4), 8), cell)),
    ]


@pytest.mark.parametrize("i", range(5))
def test_cpu_plain_versions_differentiate(i):
    """The plain versions (CPU tensors) carry the graph: the output requires
    a gradient and its backward reaches the inputs."""
    name, call = _graph_cases("cpu")[i]
    out = call()
    assert out.requires_grad, name
    (out * out).sum().backward()


@pytest.mark.cuda
def test_cuda_wrappers_refuse_a_graph_they_cannot_carry():
    """On the card every forward wrapper carries the graph (none refuses
    one): sweep_variance's backward is one sweep_variance_backward launch
    and no sweep_scatter, and equals the plain backward's (the CPU run of
    the same wrapper) within 1e-5 × max(1, max |plain|) (samples rounded
    by FMAs, sums in another order); the four RED wrappers' outputs require
    a gradient."""
    from satmvs_tpu_torch.ops.kernels.sweep_gather import sweep_scatter
    from satmvs_tpu_torch.ops.kernels.sweep_variance import sweep_variance_backward

    _cuda()
    cases = _graph_cases("cuda")
    ref, srcs, xs, ys = _inputs(device="cuda")
    ref.requires_grad_(True)
    srcs.requires_grad_(True)
    out = sweep_variance(ref, srcs, xs, ys)
    before = (sweep_variance_backward.launches, sweep_scatter.launches)
    dref, dsrcs = torch.autograd.grad((out * out).sum(), [ref, srcs])
    torch.cuda.synchronize()
    assert (sweep_variance_backward.launches, sweep_scatter.launches) == (before[0] + 1,
                                                                          before[1])
    cpu = [t.detach().cpu().requires_grad_(True) for t in (ref, srcs)]
    out_cpu = sweep_variance(cpu[0], cpu[1], xs.cpu(), ys.cpu())
    want = torch.autograd.grad((out_cpu * out_cpu).sum(), cpu)
    _close(dref.cpu(), want[0], "sweep_variance dref")
    _close(dsrcs.cpu(), want[1], "sweep_variance dsrcs")
    with torch.no_grad():
        assert not cases[0][1]().requires_grad
    for name, call in cases[1:]:
        assert call().requires_grad, name
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["window", "off-image"])
@pytest.mark.parametrize("s", [1, 2, 5])
@pytest.mark.parametrize("c", [6, 8, 16, 32])
def test_cuda_sweep_variance_backward_matches_plain_version(c, s, mode):
    """The fused VJP kernel at B = 2 against its plain version (dref and
    dsrcs, 1e-5 × max(1, max |plain|): samples rounded by FMAs, sums in
    another order); one sweep_variance_backward launch and no
    sweep_scatter; dref the same bits in a second run and dsrcs within the
    summation bound of the first (float atomics in another order, the same
    terms); each sample of B = 2 its B = 1 call, dref bit for bit and dsrcs
    within the bound."""
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg
    from satmvs_tpu_torch.ops.kernels import sweep_variance as sv

    _cuda()
    shape = (2, s, 7, 13, 21, c)
    feats, xs, ys = _batched_inputs(*shape, mode, seed=10 + c + s)
    g = _rand((2, 7, 13, 21, c), 20 + c)
    before = (sv.sweep_variance_backward.launches, sg.sweep_scatter.launches)
    dref, dsrcs = sv.sweep_variance_backward(feats, xs, ys, g)
    torch.cuda.synchronize()
    assert (sv.sweep_variance_backward.launches, sg.sweep_scatter.launches) == (before[0] + 1,
                                                                                before[1])
    assert dref.shape == (2, 13, 21, c) and dsrcs.shape == (2, s, 13, 21, c)
    want = sv.sweep_variance_backward_reference(feats, xs, ys, g)
    _close(dref, want[0], f"sweep_variance_backward dref {shape} {mode}")
    _close(dsrcs, want[1], f"sweep_variance_backward dsrcs {shape} {mode}")
    bound = _chip_smoke().summation_bound(sv._backward_reference(feats[:, 0], feats[:, 1:], xs,
                                                                 ys, g)[0], xs, ys, 13) + 1e-30
    again = sv.sweep_variance_backward(feats, xs, ys, g)
    assert torch.equal(dref, again[0])
    assert bool(((dsrcs - again[1]).abs() <= bound).all())
    for i in range(2):
        one = sv.sweep_variance_backward(feats[i:i + 1].contiguous(), xs[i:i + 1].contiguous(),
                                         ys[i:i + 1].contiguous(), g[i:i + 1].contiguous())
        assert torch.equal(one[0][0], dref[i])
        assert bool(((one[1][0] - dsrcs[i]).abs() <= bound[i]).all())


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place of each value of x (x itself bf16)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,w,c,spread", [(4, 16, 24, 8, 0.0), (3, 7, 9, 6, 3.0),
                                            (5, 12, 20, 32, 4.0)])
def test_cuda_bf16_gather_and_scatter_match_plain_versions(d, h, w, c, spread):
    """The bf16 instances: the gather within one bf16 ulp of the plain
    version's rounding (the fp32 samples differ by FMA contraction, and a
    value near a rounding boundary may round the other way) plus the fp32
    gather's 1e-5 × max(1, max |plain|) (where a sample cancels to near 0,
    that fp32 difference is many of its ulps), the same bits in a second
    run, counted in launches_bf16; the scatter of a bf16
    cotangent within the summation bound of the plain scatter of its fp32
    widening; the autograd backward of a bf16 gather is one bf16 scatter."""
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg

    _cuda()
    src, xs, ys, g = _sweep_case(d, h, w, c, spread, 70 + c)
    before = (sg.sweep_gather.launches, sg.sweep_gather.launches_bf16)
    out = sg.sweep_gather(src, xs, ys, torch.bfloat16)
    torch.cuda.synchronize()
    assert (sg.sweep_gather.launches, sg.sweep_gather.launches_bf16) == (before[0], before[1] + 1)
    want = sg.sweep_gather_reference(src, xs, ys, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    tol = _bf16_ulp(want) + 1e-5 * max(1.0, want.float().abs().max().item())
    assert bool(((out.float() - want.float()).abs() <= tol).all())
    assert torch.equal(out, sg.sweep_gather(src, xs, ys, torch.bfloat16))
    gb = g.to(torch.bfloat16)
    got = sg.sweep_scatter(gb, xs, ys)
    bound = 2 * (4 * d - 1) * 2.0 ** -24 * sg.sweep_scatter_reference(gb.abs(), xs, ys, h, w)
    assert bool(((got - sg.sweep_scatter_reference(gb, xs, ys, h, w)).abs() <= bound + 1e-30)
                .all())
    src.requires_grad_(True)
    vol = sg.sweep_gather(src, xs, ys, torch.bfloat16)
    before = sg.sweep_scatter.launches_bf16
    (grad,) = torch.autograd.grad(vol, src, gb)
    assert sg.sweep_scatter.launches_bf16 == before + 1
    assert bool(((grad - sg.sweep_scatter_reference(gb, xs, ys, h, w)).abs() <= bound + 1e-30)
                .all())


@functools.lru_cache(maxsize=1)
def _train_sweeps():
    """chip_smoke.gather_cases(): the sweep pair's phase-6 shapes."""
    return _chip_smoke().gather_cases()


def _bf16_pair(src, xs, ys, g, hs, what, plan=None, planes=None):
    """The bf16 gather against its plain version (one bf16 ulp + 1e-5 ×
    max(1, max |plain|)) and the same bits twice (through `_launch` with
    `planes` planes a thread when given); the bf16 scatter of g (under
    `plan` when given) against the plain scatter and a second run within
    the summation bound.  Returns the scatter's [blocks, blocks outside
    their window]."""
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg

    d, h, w = xs.shape
    c = src.shape[-1]
    if planes is None:
        out, again = (sg.sweep_gather(src, xs, ys, torch.bfloat16) for _ in range(2))
    else:
        out, again = (torch.empty((d, h, w, c), dtype=torch.bfloat16, device="cuda")
                      for _ in range(2))
        for t in (out, again):
            sg._launch("sweep_gather", src, xs, ys, t, d, h, w, c, planes, hs)
    want = sg.sweep_gather_reference(src, xs, ys, torch.bfloat16)
    tol = _bf16_ulp(want) + 1e-5 * max(1.0, want.float().abs().max().item())
    assert bool(((out.float() - want.float()).abs() <= tol).all()), what
    assert torch.equal(out, again), what
    gb = g.to(torch.bfloat16)
    counts = sg.window_blocks("cuda").clone()

    def scatter():
        if plan is None:
            return sg.sweep_scatter(gb, xs, ys, hs)
        dsrc = torch.zeros((hs, w, c), device="cuda")
        sg._launch_window(gb, xs, ys, dsrc, plan, hs)
        return dsrc

    got, second = scatter(), scatter()
    bound = 2 * (4 * d - 1) * 2.0 ** -24 * sg.sweep_scatter_reference(gb.abs(), xs, ys, hs, w)
    torch.cuda.synchronize()
    for other in (sg.sweep_scatter_reference(gb, xs, ys, hs, w), second):
        err = (got - other).abs()
        assert bool((err <= bound + 1e-30).all()), f"{what}: {err.max().item()}"
    return ((sg.window_blocks("cuda") - counts) // 2).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(7))
def test_cuda_bf16_pair_at_the_train_shapes(case):
    """The bf16 kernels at chip_smoke's phase-6 shapes (both source views of
    every stage of a 384×768 train step, then coordinates pushed off the
    image): `_bf16_pair`; the smooth sweeps keep at least 95 % of their
    scatter blocks in the shared-memory window."""
    _cuda()
    label, src, xs, ys, g = _train_sweeps()[case]
    blocks, outside = _bf16_pair(src, xs, ys, g, xs.shape[1], label)
    print(f"[bf16] {label}: {outside} of {blocks} scatter blocks outside their window")
    if label != "off-image":
        assert outside <= 0.05 * blocks


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 12, 8, 32])
@pytest.mark.parametrize("row0,hb", [(0, 16), (5, 9)])
def test_cuda_bf16_pair_at_odd_widths_and_a_band(c, row0, hb):
    """C = 3 (one channel a thread), 12 (four), 8 and 32 (eight), on the
    whole 16-row source and on a band of 9 of its rows (height sharding),
    coordinates partly off the image: `_bf16_pair` with the wrappers' own
    launches, the gather at 1, 3 and 8 planes a thread and the scatter at
    1, 3 and all planes a block."""
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg

    _cuda()
    d, h, w = 7, 16, 40
    src, xs, ys, g = _sweep_case(d, h, w, c, 3.0, 110 + c)
    xs, ys, g = (t[:, row0:row0 + hb].contiguous() for t in (xs, ys, g))
    _bf16_pair(src, xs, ys, g, h, f"C={c} band {row0}+{hb}")
    for planes in (1, 3, d):
        plan = sg.scatter_window_plan(d, hb, w, c, h, planes=planes)
        _bf16_pair(src, xs, ys, g, h, f"C={c} {planes} planes", plan, planes=min(planes, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 32])
def test_cuda_bf16_scatter_counts_blocks_outside_the_window(c):
    """Samples spread over the whole 128×160 image give every block a window
    past its budget: the kernel counts them outside and sums them on its
    per-pixel path, within the summation bound; a smooth shift keeps every
    block in its window; a budget of 0 sends every block outside."""
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg

    _cuda()
    d, h, w = 6, 128, 160
    src, xs, ys, g = _sweep_case(d, h, w, c, 0.0, 130 + c)
    blocks, outside = _bf16_pair(src, xs, ys, g, h, f"wide C={c}")
    assert blocks == np.prod(sg.scatter_window_plan(d, h, w, c)["grid"]) and outside == blocks
    jj, ii = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    shift = 0.4 * np.arange(d, dtype=np.float32)[:, None, None]
    xs = torch.from_numpy(np.ascontiguousarray(jj[None] + shift - 2.3)).cuda()
    ys = torch.from_numpy(np.ascontiguousarray(ii[None] - 0.3 * shift + 0.7)).cuda()
    assert _bf16_pair(src, xs, ys, g, h, f"smooth C={c}")[1] == 0
    plan = {**sg.scatter_window_plan(d, h, w, c, planes=3), "budget": 0}
    blocks, outside = _bf16_pair(src, xs, ys, g, h, f"budget 0 C={c}", plan)
    assert outside == blocks == np.prod(plan["grid"])


def _sweep_case(d, h, w, c, spread, seed, device="cuda"):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(h, w, c)).astype(np.float32)
    xs = rng.uniform(-spread, w - 1 + spread, (d, h, w)).astype(np.float32)
    ys = rng.uniform(-spread, h - 1 + spread, (d, h, w)).astype(np.float32)
    xs.reshape(-1)[::31] = 1e9
    g = rng.normal(size=(d, h, w, c)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (src, xs, ys, g)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,w,c,spread", [(4, 16, 24, 8, 0.0), (3, 7, 9, 6, 3.0),
                                            (5, 12, 20, 32, 4.0)])
def test_cuda_sweep_gather_and_scatter_match_plain_versions(d, h, w, c, spread):
    """float4 (C % 4 == 0) and scalar paths, off-image and far-off samples.
    Gather: 1e-5 × max(1, max |plain|) (FMA contraction).  Scatter: each
    element within 2·(4·D − 1)·2⁻²⁴ × the sum of its terms' magnitudes
    (atomics add in any order) of the plain version, and of a second run."""
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg

    _cuda()
    src, xs, ys, g = _sweep_case(d, h, w, c, spread, d + c)
    before = (sg.sweep_gather.launches, sg.sweep_scatter.launches)
    out = sg.sweep_gather(src, xs, ys)
    dsrc, again = sg.sweep_scatter(g, xs, ys), sg.sweep_scatter(g, xs, ys)
    assert (sg.sweep_gather.launches, sg.sweep_scatter.launches) == (before[0] + 1, before[1] + 2)
    _close(out, sg.sweep_gather_reference(src, xs, ys), "sweep_gather")
    bound = 2 * (4 * d - 1) * 2.0 ** -24 * sg.sweep_scatter_reference(g.abs(), xs, ys, h, w)
    torch.cuda.synchronize()
    for other in (sg.sweep_scatter_reference(g, xs, ys, h, w), again):
        assert bool(((dsrc - other).abs() <= bound + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c,planes", [(8, 8), (6, 3), (16, 5)])
def test_cuda_sweep_scatter_runs_of_planes(c, planes):
    """Threads that walk several planes of a sweep-like motion (the corner
    moves every few planes, some samples off the image): equal to the plain
    scatter within the summation bound, float4 and scalar atomics."""
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg

    _cuda()
    d, h, w = 16, 24, 40
    rng = np.random.default_rng(c)
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    shift = 0.37 * np.arange(d)[:, None, None]
    xs = (jj[None] + shift - 3 + 0.1 * rng.uniform(size=(d, h, w))).astype(np.float32)
    ys = (ii[None] - 0.5 * shift + 0.1 * rng.uniform(size=(d, h, w))).astype(np.float32)
    g = rng.normal(size=(d, h, w, c)).astype(np.float32)
    g, xs, ys = (torch.from_numpy(a).cuda() for a in (g, xs, ys))
    dsrc = torch.zeros((h, w, c), device="cuda")
    sg._launch("sweep_scatter", g, xs, ys, dsrc, d, h, w, c, planes)
    bound = 2 * (4 * d - 1) * 2.0 ** -24 * sg.sweep_scatter_reference(g.abs(), xs, ys, h, w)
    torch.cuda.synchronize()
    err = (dsrc - sg.sweep_scatter_reference(g, xs, ys, h, w)).abs()
    assert bool((err <= bound + 1e-30).all()), err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("row0,hb,c", [(0, 8, 8), (8, 8, 6), (5, 11, 16)])
def test_cuda_sweep_kernels_on_a_band_of_rows(row0, hb, c):
    """A rank's band of reference rows under height sharding (rows row0 ..
    row0 + hb − 1 of 16; the source views whole): the gather and its
    scatter into the whole source, the fused sweep and its VJP (dref, and
    dsrcs into the whole sources) against their plain versions (1e-5 ×
    max(1, max |plain|); the scatter within its float-atomics bound)."""
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg
    from satmvs_tpu_torch.ops.kernels import sweep_variance as sv

    _cuda()
    d, h, w = 5, 16, 20
    src, xs, ys, g = _sweep_case(d, h, w, c, 3.0, 70 + row0)
    xs, ys, g = (t[:, :hb].contiguous() for t in (xs, ys, g))
    _close(sg.sweep_gather(src, xs, ys), sg.sweep_gather_reference(src, xs, ys), "gather")
    bound = 2 * (4 * d - 1) * 2.0 ** -24 * sg.sweep_scatter_reference(g.abs(), xs, ys, h, w)
    err = (sg.sweep_scatter(g, xs, ys, h) - sg.sweep_scatter_reference(g, xs, ys, h, w)).abs()
    assert bool((err <= bound + 1e-30).all()), err.max().item()
    feats = _rand((1, 3, h, w, c), 80 + row0)
    xs2 = torch.stack([xs, xs.flip(0)])[None].contiguous()
    ys2 = torch.stack([ys, ys.flip(0)])[None].contiguous()
    ref = feats[:, 0, row0:row0 + hb]
    _close(sv.sweep_variance_batched(feats, xs2, ys2, row0),
           sv.sweep_variance_reference(ref[0], feats[0, 1:], xs2[0], ys2[0])[None], "sweep")
    gv = _rand((1, d, hb, w, c), 90 + row0)
    dref, dsrcs = sv._cotangents(ref, feats[:, 1:], 3 * h * w * c, xs2, ys2, gv)
    wdref, wdsrcs = sv._plain_vjp(ref, feats[:, 1:], xs2, ys2, gv)
    assert dsrcs.shape == (1, 2, h, w, c)
    _close(dsrcs, wdsrcs, "source cotangents")
    _close(dref, wdref, "reference cotangent")


@pytest.mark.cuda
@pytest.mark.parametrize("c,planes", [(8, 8), (6, 3), (16, 5), (32, 2)])
def test_cuda_sweep_gather_runs_of_planes(c, planes):
    """Gather threads that walk several planes, two at a time and an odd
    one last, float4 and scalar, off-image samples included: equal to the
    plain gather (1e-5 × max(1, max |plain|), FMA contraction)."""
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg

    _cuda()
    d, h, w = 11, 24, 40
    src, xs, ys, _ = _sweep_case(d, h, w, c, 3.0, 90 + c)
    out = torch.empty((d, h, w, c), device="cuda")
    sg._launch("sweep_gather", src, xs, ys, out, d, h, w, c, planes)
    _close(out, sg.sweep_gather_reference(src, xs, ys), "sweep_gather")


@pytest.mark.cuda
def test_cuda_sweep_gather_backward_launches_the_scatter():
    """The autograd backward of the gather is one scatter launch, equal to
    the plain scatter within the summation bound; coordinates get none."""
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg

    _cuda()
    src, xs, ys, g = _sweep_case(4, 16, 24, 8, 2.0, 50)
    src.requires_grad_(True)
    out = sg.sweep_gather(src, xs, ys)
    before = sg.sweep_scatter.launches
    (grad,) = torch.autograd.grad(out, src, g)
    assert sg.sweep_scatter.launches == before + 1
    bound = 2 * 15 * 2.0 ** -24 * sg.sweep_scatter_reference(g.abs(), xs, ys, 16, 24)
    assert bool(((grad - sg.sweep_scatter_reference(g, xs, ys, 16, 24)).abs() <= bound + 1e-30)
                .all())


def _all_wrappers():
    """name → (wrapper, the attribute that counts its launches)."""
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc
    from satmvs_tpu_torch.ops.kernels import red_recur as rr
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg
    from satmvs_tpu_torch.ops.kernels.conv3d_block import conv3d_block, deconv3d_block
    from satmvs_tpu_torch.ops.kernels.sweep_variance import sweep_variance_backward

    fns = {"conv3d_block": conv3d_block, "deconv3d_block": deconv3d_block,
           "sweep_gather": sg.sweep_gather, "sweep_scatter": sg.sweep_scatter,
           "sweep_variance": sweep_variance, "sweep_variance_backward": sweep_variance_backward,
           "conv_dn": pc.conv_dn, "red_recur": rr.red_recur, "deconv_up": pc.deconv_up,
           "conv_head": pc.conv_head, "conv_dn_backward": pc.conv_dn_backward,
           "red_recur_backward": rr.red_recur_backward,
           "deconv_up_backward": pc.deconv_up_backward,
           "conv_head_backward": pc.conv_head_backward, "wgrad3x3": pc.wgrad3x3}
    out = {k: (f, "launches") for k, f in fns.items()}
    out.update({f"{k}_bf16": (fns[k], "launches_bf16") for k in ("sweep_gather", "sweep_scatter")})
    return out


# launches per train step and per eval step at B = 1 with the fused RED
# pipeline (fused_red None, the default): per stage 2 gathers and 2
# scatters, 3 conv_dn, 4 red_recur, 3 deconv_up, 1 conv_head, each RED kernel
# once forward and once backward, and the weight reduction once per conv
# backward and twice per red_recur backward; the eval step without gradients
FUSED_TRAIN = {"sweep_gather": 6, "sweep_scatter": 6, "conv_dn": 9, "red_recur": 12,
               "deconv_up": 9, "conv_head": 3, "conv_dn_backward": 9, "red_recur_backward": 12,
               "deconv_up_backward": 9, "conv_head_backward": 3, "wgrad3x3": 45}
FUSED_EVAL = {"sweep_variance": 3, "conv_dn": 9, "red_recur": 12, "deconv_up": 9, "conv_head": 3}


def _step_launches(cfg, want_train, want_eval):
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.train import create_model_and_state, make_eval_step, make_train_step

    wrappers = _all_wrappers()
    batch = synthetic.make_batch(1, 64, 32, seed=0, device="cuda")
    model, state, tx = create_model_and_state(cfg, batch, 1)
    for step, want in ((make_train_step(model, tx, cfg.dlossw), want_train),
                       (make_eval_step(model, cfg.dlossw, cfg.min_interval), want_eval)):
        before = {k: getattr(f, a) for k, (f, a) in wrappers.items()}
        result = step(state, batch)
        torch.cuda.synchronize()
        got = {k: getattr(f, a) - before[k] for k, (f, a) in wrappers.items()}
        assert got == {k: want.get(k, 0) for k in wrappers}
    assert bool(torch.isfinite(result[0]["loss"]))


@pytest.mark.cuda
def test_cuda_train_step_launches():
    """A train step at 32×64, ndepths (8, 4, 4), B = 1, `Config()` defaults
    (the fused RED pipeline): per stage and source view one sweep_gather and
    one sweep_scatter, per stage conv_dn ×3, red_recur ×4, deconv_up ×3,
    conv_head ×1 forward and each of their backward kernels as often, the
    weight reduction 9 + 9 + 3 + 2·12 times, no sweep_variance; an eval step: 3 sweep_variance and the fused pipeline's
    forward kernels.  The loss is finite."""
    from satmvs_tpu_torch.train import Config

    _cuda()
    _step_launches(Config(ndepths=(8, 4, 4)), FUSED_TRAIN, FUSED_EVAL)


@pytest.mark.cuda
def test_cuda_fused_sweep_and_bf16_train_step_launches(monkeypatch):
    """SATMVS_TRAIN_FUSED_SWEEP=1: the train step's sweep is per stage one
    sweep_variance and one sweep_variance_backward, no sweep_gather and no
    sweep_scatter; volume_dtype="bfloat16": the per-view
    sweep's bf16 instances (6 + 6) instead of the fp32 ones.  The eval
    steps launch a forward's kernels."""
    from satmvs_tpu_torch.train import Config

    _cuda()
    red = {k: v for k, v in FUSED_TRAIN.items() if not k.startswith("sweep_")}
    monkeypatch.setenv("SATMVS_TRAIN_FUSED_SWEEP", "1")
    _step_launches(Config(ndepths=(8, 4, 4)), {**red, "sweep_variance": 3,
                                               "sweep_variance_backward": 3}, FUSED_EVAL)
    monkeypatch.delenv("SATMVS_TRAIN_FUSED_SWEEP")
    _step_launches(Config(ndepths=(8, 4, 4), volume_dtype="bfloat16"),
                   {**red, "sweep_gather_bf16": 6, "sweep_scatter_bf16": 6}, FUSED_EVAL)


@pytest.mark.cuda
def test_cuda_scan_train_step_launches():
    """fused_red=False: the train step launches the sweep pair only (6 + 6),
    the eval step 3 sweep_variance only: the scan RED is torch built-ins."""
    from satmvs_tpu_torch.train import Config

    _cuda()
    _step_launches(Config(ndepths=(8, 4, 4), fused_red=False),
                   {"sweep_gather": 6, "sweep_scatter": 6}, {"sweep_variance": 3})


def _rel(got, want):
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", [(3, 16, 24, 8, 16), (2, 8, 6, 6, 5),
                                            (2, 12, 8, 32, 64), (2, 8, 12, 24, 48)])
def test_cuda_conv_dn_backward_matches_plain_version(n, h, w, cin, cout):
    """dx (the gated transposed conv) and dweight (the two-pass reduction)
    against the plain backward on the card: 1e-5 × max(1, max |plain|) each,
    and the same bits in a second run (no atomics)."""
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc

    _cuda()
    x, wt = _rand((n, h, w, cin), 60), _rand((cout, cin, 3, 3), 61, 0.2)
    y = pc.conv_dn_reference(x, wt)
    g = _rand(tuple(y.shape), 62)
    before = pc.conv_dn_backward.launches
    got = pc.conv_dn_backward(x, wt, y, g)
    assert pc.conv_dn_backward.launches == before + 1
    for a, b, what in zip(got, pc.conv_dn_backward_reference(x, wt, y, g), ("dx", "dw")):
        _close(a, b, f"conv_dn backward {what}")
    for a, b in zip(got, pc.conv_dn_backward(x, wt, y, g)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", [(3, 8, 12, 16, 8), (2, 5, 7, 6, 3),
                                            (1, 3, 6, 64, 32), (2, 6, 10, 48, 24)])
def test_cuda_deconv_up_backward_matches_plain_version(n, h, w, cin, cout):
    """dx (the gated stride-2 conv) and dweight, odd sizes included, with
    pre-activations pushed to ±1e-7 on a share of the outputs so the mask
    read from relu(z) matters: 1e-5 × max(1, max |plain|)."""
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc

    _cuda()
    x, wt = _rand((n, h, w, cin), 63), _rand((cin, cout, 3, 3), 64, 0.2)
    act = pc.deconv_up_reference(x, wt)
    act.view(-1)[::3] = 1e-7
    act.view(-1)[1::7] = 0.0
    g = _rand(tuple(act.shape), 65)
    before = pc.deconv_up_backward.launches
    got = pc.deconv_up_backward(x, wt, act, g)
    assert pc.deconv_up_backward.launches == before + 1
    for a, b, what in zip(got, pc.deconv_up_backward_reference(x, wt, act, g), ("dx", "dw")):
        _close(a, b, f"deconv_up backward {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", [(3, 16, 24, 8, 1), (2, 7, 9, 6, 5)])
def test_cuda_conv_head_backward_matches_plain_version(n, h, w, cin, cout):
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc

    _cuda()
    x, wt = _rand((n, h, w, cin), 66), _rand((cout, cin, 3, 3), 67, 0.2)
    g = _rand((n, h, w, cout), 68)
    before = pc.conv_head_backward.launches
    got = pc.conv_head_backward(x, wt, g)
    assert pc.conv_head_backward.launches == before + 1
    for a, b, what in zip(got, pc.conv_head_backward_reference(x, wt, g), ("dx", "dw", "db")):
        _close(a, b, f"conv_head backward {what}")


@pytest.mark.cuda
def test_cuda_conv_head_backward_reduces_a_training_plane():
    """At stage 3 of a 384×768 train step (8 planes, 2.4 M pixels), with a
    cotangent of mean 1 so Σ g does not cancel: dweight and dbias against
    the plain backward in float64, each element to 1e-6 × Σ |terms| of its
    sum, a bound under 1e-2 of the largest value (a zeroed or sign-flipped
    reduction fails)."""
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc

    _cuda()
    x, wt = _rand((8, 384, 768, 8), 69), _rand((1, 8, 3, 3), 70, 0.2)
    g = _rand((8, 384, 768, 1), 71) + 1.0
    _, dw, db = pc.conv_head_backward(x, wt, g)
    torch.cuda.synchronize()
    want = pc.conv_head_backward_reference(x.double(), wt.double(), g.double())[1:]
    mags = pc.conv_head_backward_reference(x.abs().double(), wt.double(), g.abs().double())[1:]
    for got, exact, mag, what in zip((dw, db), want, mags, ("dweight", "dbias")):
        bound = 1e-6 * mag
        assert bound.max() <= 1e-2 * exact.abs().max(), what
        assert bool(((got - exact).abs() <= bound).all()), f"{what}: {(got - exact).abs().max()}"


def _plane_uses(n, h, w, cin, cout, seed):
    """(name, kernel, plain) of each use of the two plane-conv kernels at x
    (n, h, w, cin) → cout channels: conv_dn, deconv_up (with skip) and
    conv_head forward, and the three backwards (conv_dn's only at even h
    and w); each call returns a tuple of tensors."""
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc

    x = _rand((n, h, w, cin), seed)
    wd, wu = _rand((cout, cin, 3, 3), seed + 1, 0.2), _rand((cin, cout, 3, 3), seed + 2, 0.2)
    wh, b = _rand((cout, cin, 3, 3), seed + 3, 0.2), _rand((cout,), seed + 4)
    skip = _rand((n, 2 * h, 2 * w, cout), seed + 5)
    y = pc.conv_dn_reference(x, wd)
    act = pc.deconv_up_reference(x, wu)
    act.view(-1)[::3] = 1e-7  # the mask read from relu(z) must matter
    gd, gu = _rand(tuple(y.shape), seed + 6), _rand(tuple(act.shape), seed + 7)
    gh = _rand((n, h, w, cout), seed + 8)
    uses = [("conv_dn", lambda: (pc.conv_dn(x, wd),), lambda: (pc.conv_dn_reference(x, wd),)),
            ("deconv_up", lambda: (pc.deconv_up(x, wu, skip),),
             lambda: (pc.deconv_up_reference(x, wu, skip),)),
            ("conv_head", lambda: (pc.conv_head(x, wh, b),),
             lambda: (pc.conv_head_reference(x, wh, b),)),
            ("deconv_up backward", lambda: pc.deconv_up_backward(x, wu, act, gu),
             lambda: pc.deconv_up_backward_reference(x, wu, act, gu)),
            ("conv_head backward", lambda: pc.conv_head_backward(x, wh, gh),
             lambda: pc.conv_head_backward_reference(x, wh, gh))]
    if h % 2 == 0 and w % 2 == 0:
        uses.append(("conv_dn backward", lambda: pc.conv_dn_backward(x, wd, y, gd),
                     lambda: pc.conv_dn_backward_reference(x, wd, y, gd)))
    return uses


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 37, 1, 64, 16), (1, 5, 2, 8, 1), (1, 6, 2, 4, 8),
                                            (4, 33, 35, 8, 1), (3, 10, 14, 3, 6),
                                            (1, 2, 2, 16, 64), (2, 66, 98, 64, 32),
                                            (2, 34, 130, 1, 8)])
def test_cuda_plane_convs_across_tile_edges(n, h, w, cin, cout):
    """conv_dn, deconv_up and conv_head and their backwards against the
    plain versions where tiles overhang the plane: W of 1 and 2, odd H and
    W, N > 1, Cin = 64 staged in chunks, Cin % 4 != 0, Cout = 1 (conv_head's,
    whose dx then runs from one channel) and Cin = 1; 1e-5 × max(1, max
    |plain|), and the same bits in a second run, forwards and backwards."""
    _cuda()
    for name, kernel, plain in _plane_uses(n, h, w, cin, cout, 100):
        got, again, want = kernel(), kernel(), plain()
        for i, (a, a2, ref) in enumerate(zip(got, again, want)):
            if ref is not None:
                _close(a, ref, f"{name}[{i}] {(n, h, w, cin, cout)}")
            assert torch.equal(a, a2), f"{name}[{i}]: a second run differs"


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 12, 24, 64, 32), (1, 40, 200, 8, 16)])
def test_cuda_plane_convs_under_every_plan(n, h, w, cin, cout):
    """Each kernel under every plan `plane_conv_plan_options` offers, at a
    coarse (64 → 32) and a wide (8 → 16) shape, in each of its uses (conv
    stride 2, gated stride 2, stride 1 from Cin and from Cout; the
    transposed conv plain and gated): within 1e-5 of the plain version,
    and the same bits as `plane_conv_plan`'s plan (each output's sum runs in
    one order whatever the tiles)."""
    import torch.nn.functional as F

    from satmvs_tpu_torch.ops.kernels import plane_conv as pc

    _cuda()
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    x, gate = _rand((n, h, w, cin), 110), _rand((n, h, w, cin), 111)
    wk = _rand((3, 3, cin, cout), 112, 0.2)
    wt = wk.permute(3, 2, 0, 1)  # Conv2d's (Cout, Cin, 3, 3)
    dz = torch.where(gate > 0, x, torch.zeros_like(x))
    convs = {"stride 2": (2, None, lambda: F.conv2d(nchw(x), wt, stride=2, padding=1)),
             "stride 2 gated": (2, gate, lambda: F.conv2d(nchw(dz), wt, stride=2, padding=1)),
             "stride 1": (1, None, lambda: F.conv2d(nchw(x), wt, padding=1))}
    for what, (stride, g, plain) in convs.items():
        want, base = nhwc(plain()), pc._conv3x3("test", x, g, wk, None, stride, False)
        for o in pc.plane_conv_plan_options(stride, False, cin, cout, g is not None):
            got = pc._conv3x3("test", x, g, wk, None, stride, False, o)
            _close(got, want, f"conv {what} {o}")
            assert torch.equal(got, base), f"conv {what} {o}: other bits than the plan's"
    wu = wk.permute(2, 3, 0, 1)  # ConvTranspose2d's (Cin, Cout, 3, 3)
    for what, g in (("", None), (" gated", gate)):
        want = nhwc(F.conv_transpose2d(nchw(x if g is None else dz), wu, stride=2, padding=1,
                                       output_padding=1))
        base = pc._deconv3x3("test", x, g, wk, None, None, False)
        for o in pc.plane_conv_plan_options(2, True, cin, cout, g is not None):
            got = pc._deconv3x3("test", x, g, wk, None, None, False, o)
            _close(got, want, f"deconv{what} {o}")
            assert torch.equal(got, base), f"deconv{what} {o}: other bits than the plan's"


@functools.lru_cache(maxsize=1)
def _chip_smoke():
    """chip_smoke.py, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _costreg_calls(stage: int):
    """`chip_smoke.costreg_calls(1)` of one stage: the per-tap CostRegNet
    forms' eleven call shapes of a 384×768 forward."""
    return _chip_smoke().costreg_calls(1)[11 * (stage - 1):11 * stage]


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_cuda_costreg_forms_at_every_call(stage):
    """The CostRegNet forms (conv_dn and deconv_up with relu off, conv_head
    with Cout up to 64 and a zero bias) at a stage's call shapes of a
    384×768 forward: within 1e-5 × max(1, max |plain|) of the plain
    version, the same bits in a second run and under every plan the
    kernels take, and a call on B = 2 elements' planes the bits of the two
    B = 1 calls."""
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc

    _cuda()
    for label, op, stride, transposed, n, h, w, cin, cout, _ in _costreg_calls(stage):
        x, x2 = _rand((n, h, w, cin), 120), _rand((n, h, w, cin), 121)
        scale = (1.0 / (9 * cin)) ** 0.5
        if op == "deconv_up":
            wt = _rand((cin, cout, 3, 3), 122, scale)
            wk, bias = wt.permute(2, 3, 0, 1), None

            def kernel(t):
                return pc.deconv_up(t, wt, relu=False)

            def by_plan(o):
                return pc._deconv3x3("test", x, None, wk, None, None, False, o)

            want = pc.deconv_up_reference(x, wt, relu=False)
        else:
            wt = _rand((cout, cin, 3, 3), 123, scale)
            wk, zb = wt.permute(2, 3, 1, 0), torch.zeros(cout, device="cuda")
            bias = None if op == "conv_dn" else zb

            def kernel(t):
                return pc.conv_dn(t, wt, relu=False) if op == "conv_dn" else pc.conv_head(t, wt, zb)

            def by_plan(o):
                return pc._conv3x3("test", x, None, wk, bias, stride, False, o)

            want = (pc.conv_dn_reference(x, wt, relu=False) if op == "conv_dn"
                    else pc.conv_head_reference(x, wt, zb))
        with torch.no_grad():
            got = kernel(x)
            _close(got, want, label)
            assert (want < 0).any(), f"{label}: no negative output (relu off)"
            assert torch.equal(kernel(x), got), f"{label}: a second run differs"
            for o in pc.plane_conv_plan_options(stride, transposed, cin, cout):
                assert torch.equal(by_plan(o), got), f"{label} {o}: other bits than the plan's"
            both = kernel(torch.cat([x, x2]))
            assert torch.equal(both[:n], got), f"{label}: B = 2 element 0 differs from B = 1"
            assert torch.equal(both[n:], kernel(x2)), f"{label}: B = 2 element 1 differs"


@pytest.mark.cuda
def test_cuda_costreg_network_packed():
    """CostRegNet's packed path on the card: one kernel launch per 3-D block
    (conv3d_block 8, deconv3d_block 3 per forward, whatever B is; no plane
    conv), within 1e-4 × max(1, max |logit|) of the plain versions' run on
    the CPU, and an element of a B = 2 volume the bits of its B = 1
    forward."""
    from satmvs_tpu_torch.nn.costreg import CostRegNet
    from satmvs_tpu_torch.ops.kernels import conv3d_block as cb
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc
    from satmvs_tpu_torch.params import init_from_seed

    _cuda()
    net = init_from_seed(CostRegNet(16, 8), 5).eval()
    with torch.no_grad():
        for m in [*net.convs, *net.deconvs]:
            m.bn.running_mean.uniform_(-0.1, 0.1)
            m.bn.running_var.uniform_(0.5, 1.5)
            m.conv.weight.mul_(0.5 ** 0.5)
    vol = _rand((2, 16, 24, 40, 16), 130).abs()
    want = net(vol[:1].cpu())
    net.cuda()
    wrappers = (cb.conv3d_block, cb.deconv3d_block, pc.conv_head, pc.conv_dn, pc.deconv_up)
    before = [f.launches for f in wrappers]
    with torch.no_grad():
        both = net(vol)
        one = net(vol[:1])
    assert [f.launches - b for f, b in zip(wrappers, before)] == [16, 6, 0, 0, 0]
    assert torch.equal(both[:1], one)
    err = (one.cpu() - want).abs().max().item()
    assert err <= 1e-4 * max(1.0, want.abs().max().item()), err


def _block_case(op, n, h, w, ci, co, head, seed, b=1):
    """A 3-D block of `costreg_blocks` on the card: (kernel(x[, skip]),
    plain(x[, skip]), x, a second input, the skip pair or None)."""
    from satmvs_tpu_torch.ops.kernels import conv3d_block as cb

    d_in = 2 * n if op == "conv_dn" else n
    x, x2 = (_rand((b, d_in, h, w, ci), seed + k).abs() for k in (0, 1))
    scale = (1.0 / (27 * ci)) ** 0.5
    bias = None if head else _rand((co,), seed + 2, 0.1)
    if op == "deconv_up":
        wt = _rand((ci, co, 3, 3, 3), seed + 3, scale)
        skips = tuple(_rand((b, 2 * n, 2 * h, 2 * w, co), seed + k) for k in (4, 5))
        return (lambda t, s: cb.deconv3d_block(t, wt, bias, s),
                lambda t, s: cb.deconv3d_block_reference(t, wt, bias, s), x, x2, skips)
    wt = _rand((co, ci, 3, 3, 3), seed + 3, scale)
    stride = 2 if op == "conv_dn" else 1
    return (lambda t: cb.conv3d_block(t, wt, bias, stride, not head),
            lambda t: cb.conv3d_block_reference(t, wt, bias, stride, not head), x, x2, None)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_cuda_conv3d_block_at_every_block_shape(stage):
    """conv3d_block and deconv3d_block at a stage's eleven 3-D blocks of a
    384×768 CostRegNet forward (`chip_smoke.costreg_blocks`): within 1e-5 ×
    max(1, max |plain|) of the plain version, the same bits in a second
    run, and a B = 2 call each element the bits of its B = 1 call."""
    _cuda()
    blocks = _chip_smoke().costreg_blocks(1)[11 * (stage - 1):11 * stage]
    with torch.no_grad():
        for _, block, op, n, h, w, ci, co in blocks:
            kernel, plain, x, x2, skips = _block_case(op, n, h, w, ci, co, block == "Conv_0",
                                                      140)
            extra = (lambda k: (skips[k],)) if skips else (lambda k: ())
            got = kernel(x, *extra(0))
            _close(got, plain(x, *extra(0)), block)
            assert torch.equal(kernel(x, *extra(0)), got), f"{block}: a second run differs"
            pair = kernel(torch.cat([x, x2]), *((torch.cat(skips),) if skips else ()))
            assert torch.equal(pair[:1], got), f"{block}: B = 2 element 0 differs from B = 1"
            assert torch.equal(pair[1:], kernel(x2, *extra(1))), f"{block}: B = 2 element 1"


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,h,w,cin,cout,op", [
    (3, 5, 9, 21, 5, 1, "conv_head"), (1, 4, 7, 17, 12, 24, "conv_dn"),
    (2, 3, 8, 16, 64, 64, "conv_head"), (1, 2, 5, 33, 8, 3, "deconv_up"),
    (2, 2, 9, 18, 6, 40, "deconv_up"), (1, 6, 11, 5, 16, 16, "conv_dn"),
    (1, 3, 6, 10, 8, 1, "deconv_up")])
def test_cuda_conv3d_block_across_tile_edges(n, d, h, w, cin, cout, op):
    """Shapes off the main path: odd extents that cut 8 × 16 tiles, Cin not
    a multiple of 4 (single-channel copies) or 8, Cout of 1 (the FMA
    instance), 3, 24 and 40 (padded to 8, 32 and 64), N > 1, the convs with
    and without bias and ReLU;
    the plain version's tolerance and the same bits twice."""
    from satmvs_tpu_torch.ops.kernels import conv3d_block as cb

    _cuda()
    x = _rand((n, d, h, w, cin), 150)
    bias = _rand((cout,), 151, 0.1)
    with torch.no_grad():
        if op == "deconv_up":
            wt = _rand((cin, cout, 3, 3, 3), 152, 0.2)
            skip = _rand((n, 2 * d, 2 * h, 2 * w, cout), 153)
            got = cb.deconv3d_block(x, wt, bias, skip)
            _close(got, cb.deconv3d_block_reference(x, wt, bias, skip), op)
            assert torch.equal(cb.deconv3d_block(x, wt, bias, skip), got)
            return
        wt = _rand((cout, cin, 3, 3, 3), 152, 0.2)
        stride = 2 if op == "conv_dn" else 1
        for b, relu in ((None, False), (bias, True)):
            got = cb.conv3d_block(x, wt, b, stride, relu)
            _close(got, cb.conv3d_block_reference(x, wt, b, stride, relu), f"{op} {relu}")
            assert torch.equal(cb.conv3d_block(x, wt, b, stride, relu), got)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["s1", "s2", "deconv"])
@pytest.mark.parametrize("dim", [1, 2])
def test_cuda_conv3d_block_slab_bits_match_the_whole_volume(kind, dim):
    """A D-slab (dim 1) or H-band (dim 2) with its halo joined (zeros past
    the volume) and no zero pad on that axis gives the bits of the matching
    slice of the whole-volume call: each output's sum runs in one fixed
    order whatever the slab."""
    from satmvs_tpu_torch.ops.kernels import conv3d_block as cb

    _cuda()
    x = _rand((2, 16, 24, 40, 16), 160).abs()
    bias = _rand((32,), 161, 0.1)

    def halo(lo, hi, before, after):
        n = x.shape[dim]
        parts = [x.narrow(dim, i, 1) if 0 <= i < n else torch.zeros_like(x.narrow(dim, 0, 1))
                 for i in range(lo - before, hi + after)]
        return torch.cat(parts, dim).contiguous()

    with torch.no_grad():
        if kind == "deconv":
            wt = _rand((16, 32, 3, 3, 3), 162, 0.1)
            skip = _rand((2, 32, 48, 80, 32), 163)
            whole = cb.deconv3d_block(x, wt, bias, skip)
        else:
            stride = 1 if kind == "s1" else 2
            wt = _rand((32, 16, 3, 3, 3), 162, 0.1)
            whole = cb.conv3d_block(x, wt, bias, stride, True)
        for lo, hi in ((0, 8), (8, 16)):
            if kind == "deconv":
                back = [1, 1, 1]
                back[dim - 1] = 0
                got = cb.deconv3d_block(halo(lo, hi, 0, 1), wt, bias,
                                        skip.narrow(dim, 2 * lo, 2 * (hi - lo)).contiguous(),
                                        back=tuple(back))
                want = whole.narrow(dim, 2 * lo, 2 * (hi - lo))
            else:
                pads = list(cb.PAD1)
                pads[dim - 1] = (0, 0)
                got = cb.conv3d_block(halo(lo, hi, 1, 2 - stride), wt, bias, stride, True,
                                      tuple(pads))
                want = whole.narrow(dim, lo // stride, (hi - lo) // stride)
            assert torch.equal(got, want), f"{kind} slab {lo}:{hi} along {dim}"


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,h,w,cin,cout,op", [
    (1, 4, 12, 24, 128, 128, "conv_head"), (2, 3, 8, 16, 64, 128, "conv_dn"),
    (1, 4, 6, 20, 128, 96, "conv_head"), (1, 4, 6, 12, 128, 64, "deconv_up"),
    (2, 3, 5, 9, 96, 80, "deconv_up"), (1, 3, 7, 17, 8, 200, "conv_head")])
def test_cuda_conv3d_block_past_64_output_channels(n, d, h, w, cin, cout, op):
    """Output and input channels past 64, as CostRegNet's deepest blocks at
    base width 16 have them (128 → 128, 64 → 128, the 128 → 64 transposed
    block), a last slab part-filled (96, 80, 200): one launch a block, the
    plain version's tolerance, the same bits twice, and each slab of 64
    channels the bits of a call with only its weights (a slab's sums do not
    depend on the others)."""
    from satmvs_tpu_torch.ops.kernels import conv3d_block as cb

    _cuda()
    x = _rand((n, d, h, w, cin), 170)
    bias = _rand((cout,), 171, 0.1)
    scale = (1.0 / (27 * cin)) ** 0.5
    with torch.no_grad():
        if op == "deconv_up":
            wt = _rand((cin, cout, 3, 3, 3), 172, scale)
            skip = _rand((n, 2 * d, 2 * h, 2 * w, cout), 173)
            run = lambda wt, b, s: cb.deconv3d_block(x, wt, b, s)  # noqa: E731
            plain = cb.deconv3d_block_reference(x, wt, bias, skip)
            cut = lambda lo, hi: (wt[:, lo:hi], bias[lo:hi],  # noqa: E731
                                  skip[..., lo:hi].contiguous())
            args = (wt, bias, skip)
        else:
            wt = _rand((cout, cin, 3, 3, 3), 172, scale)
            stride = 2 if op == "conv_dn" else 1
            run = lambda wt, b: cb.conv3d_block(x, wt, b, stride, True)  # noqa: E731
            plain = cb.conv3d_block_reference(x, wt, bias, stride, True)
            cut = lambda lo, hi: (wt[lo:hi], bias[lo:hi])  # noqa: E731
            args = (wt, bias)
        wrapper = cb.deconv3d_block if op == "deconv_up" else cb.conv3d_block
        before = wrapper.launches
        got = run(*args)
        assert wrapper.launches == before + 1
        _close(got, plain, op)
        assert torch.equal(run(*args), got)
        for lo in range(0, cout, 64):
            hi = min(lo + 64, cout)
            assert torch.equal(run(*cut(lo, hi)), got[..., lo:hi]), (lo, hi)


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,h,w,cin,c,seeded", [(1, 5, 16, 24, 8, 8, False),
                                                  (2, 4, 7, 9, 6, 4, True),
                                                  (1, 3, 6, 12, 64, 64, False),
                                                  (2, 3, 12, 24, 64, 64, True),
                                                  (2, 2, 32, 160, 16, 8, True),
                                                  (1, 3, 10, 36, 12, 12, True),
                                                  (2, 2, 9, 20, 24, 24, False),
                                                  (2, 3, 9, 20, 6, 6, True),
                                                  (1, 3, 8, 12, 5, 2, False),
                                                  (2, 2, 7, 16, 10, 10, True),
                                                  (1, 3, 6, 10, 20, 1032, True),
                                                  (1, 2, 5, 7, 9, 1030, False),
                                                  (2, 2, 4, 6, 12, 2056, False)])
def test_cuda_red_recur_backward_matches_plain_version(b, d, h, w, cin, c, seeded):
    """The adjoint kernel and its weight reductions against the plain
    reverse-plane backward on the card, on states in (−1, 1): dx and every
    parameter's cotangent to a relative norm of 1e-4 (GroupNorm statistics
    in float64 against torch's fp32 moments), and the same bits in a second
    run (no atomics).  Shapes: a coarse plane at C = 64 and a wide one at
    C = 8 (stage 1 scale 8 and stage 3 in small), C = 12 and 24, the
    cells `cr_base_chs` 12 gives, C = 6, 2 and 10, run padded to a
    multiple of 4, and C = 1032, 1030 and 2056, past 1024 channels (the
    GroupNorm parameter sums of a thread's later groups in device
    memory)."""
    from satmvs_tpu_torch.ops.kernels import red_recur as rr

    _cuda()
    cell = _red_cell(cin, c, 70 + c)
    x = _rand((b, d, h, w, cin), 71)
    h0 = torch.tanh(_rand((b, h, w, c), 72)) if seeded else None
    with torch.no_grad():
        out = rr.red_recur_reference(x, cell, h0)
    g = _rand(tuple(out.shape), 73)
    before = rr.red_recur_backward.launches
    dx, dps = rr.red_recur_backward(x, out, g, cell, h0)
    assert rr.red_recur_backward.launches == before + 1
    torch.cuda.synchronize()
    want_dx, want_dps = rr.red_recur_backward_reference(x, out, g, cell, h0)
    errs = [_rel(dx, want_dx)] + [_rel(a, e) for a, e in zip(dps, want_dps)]
    assert max(errs) <= 1e-4, errs
    dx2, dps2 = rr.red_recur_backward(x, out, g, cell, h0)
    assert torch.equal(dx, dx2) and all(torch.equal(p, q) for p, q in zip(dps, dps2))


@pytest.mark.cuda
def test_cuda_red_recur_adjoint_under_every_plan():
    """Each conv of the adjoint under every (px, wc, wk, ck) the plan may pick,
    the other convs at the plan's own: the same cotangents as the plan's
    launch to a relative norm of 1e-5 (the shares of wk > 1 sum in another
    order), and the kernel's shared memory is the plan's."""
    from satmvs_tpu_torch.ops.kernels import red_recur as rr

    _cuda()
    assert rr._lib().red_recur_bwd_smem() == rr.RED_BWD_SMEM
    b, d, h, w, cin, c = 2, 3, 13, 40, 12, 12
    cell = _red_cell(cin, c, 80)
    x = _rand((b, d, h, w, cin), 81)
    h0 = torch.tanh(_rand((b, h, w, c), 82))
    with torch.no_grad():
        out = rr.red_recur_reference(x, cell, h0)
    g = _rand(tuple(out.shape), 83)
    base = rr.red_recur_bwd_plan(b, h, w, cin, c, rr.resident())
    want = rr._adjoint(x, out, g, cell, h0)
    for i, cout in enumerate((2 * c, c, c, c + cin)):
        for conv in rr.conv_plan_options(cout, rr._NRAW[i]):
            plan = {**base, "convs": [conv if j == i else p
                                      for j, p in enumerate(base["convs"])]}
            got = rr._adjoint(x, out, g, cell, h0, plan)
            errs = [_rel(a, e) for a, e in zip(got, want)]
            assert max(errs) <= 1e-5, (i, conv, errs)


@pytest.mark.cuda
def test_cuda_red_autograd_runs_the_backward_kernels():
    """REDRegularizer.pipeline under autograd on the card: one launch of each
    backward kernel per forward launch, and the volume's and parameters'
    gradients equal the same module's plain run on the CPU (relative norm
    1e-3 per tensor)."""
    from satmvs_tpu_torch.nn.red import REDRegularizer
    from satmvs_tpu_torch.params import init_from_seed

    _cuda()
    tm = init_from_seed(REDRegularizer(8, 8), 3)
    vol = torch.rand((1, 4, 16, 32, 8), generator=torch.Generator().manual_seed(0))
    grads = {}
    for dev in ("cuda", "cpu"):
        m = tm.to(dev)
        v = vol.to(dev).requires_grad_(True)
        wrappers = _all_wrappers()
        before = {k: getattr(f, a) for k, (f, a) in wrappers.items()}
        logits = m(v)
        gs = torch.autograd.grad(torch.sin(logits).sum(), [v, *m.parameters()])
        got = {k: getattr(f, a) - before[k] for k, (f, a) in wrappers.items()}
        if dev == "cuda":
            torch.cuda.synchronize()
            assert got == {k: {"conv_dn": 3, "red_recur": 4, "deconv_up": 3, "conv_head": 1,
                               "conv_dn_backward": 3, "red_recur_backward": 4,
                               "deconv_up_backward": 3, "conv_head_backward": 1,
                               "wgrad3x3": 15}.get(k, 0)
                           for k in wrappers}
        grads[dev] = [t.cpu() for t in gs]
    errs = [_rel(a, b) for a, b in zip(grads["cuda"], grads["cpu"])]
    assert max(errs) <= 1e-3, errs


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["concat_bias", "bmask_s2", "amask_s2", "odd", "past_tile"])
def test_cuda_wgrad3x3_reduces_a_training_plane(case):
    """The weight reduction at stage 3 of a 384×768 train step (8 planes,
    2.4 M pixels of B), with masks, the concat and the bias, against
    `wgrad3x3_reference` in float64: each element to 1e-6 × Σ |terms| of its
    sum (chip_smoke.py's REDUCE_TOL), a bound under 1e-2 of the largest
    value, and the same bits in a second run.  "odd": CA and CB not
    multiples of 4 (the scalar loads) at a smaller size.  "past_tile": the
    gates of `cr_base_chs` 129's first cell (32 planes of 96×192, [x | h]
    32 + 132 channels, CB = 264 in tiles of 32, so the last tile reaches
    past CB): its float4 loads stop at CB, where they once read past the end
    of B (CUDA error 700: B is a whole number of the allocator's 2 MiB
    pages)."""
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc

    _cuda()
    n, h, w = 8, 384, 768
    kw, a_abs = {}, {}
    if case == "concat_bias":  # red_recur's gates over [x | h_prev]
        a1, b, s = _rand((n, h, w, 8), 80), _rand((n, h, w, 16), 81) + 0.5, 1
        kw = {"a2": _rand((n, h, w, 8), 82), "bias": True}
        a_abs = {"a2": kw["a2"].abs()}
    elif case == "past_tile":
        a1, b, s = _rand((32, 96, 192, 32), 92), _rand((32, 96, 192, 264), 93) + 0.5, 1
        kw = {"a2": _rand((32, 96, 192, 132), 94), "bias": True}
        a_abs = {"a2": kw["a2"].abs()}
        assert pc.wgrad3x3_plan(32, 96, 192, 164, 264, 1)["cb_t"] == 32
    elif case == "bmask_s2":  # conv_dn's: B is the cotangent, masked by y
        a1, b, s = _rand((n, h, w, 8), 83), _rand((n, h // 2, w // 2, 16), 84), 2
        kw = {"bmask": _rand((n, h // 2, w // 2, 16), 85)}
    elif case == "amask_s2":  # deconv_up's: A is the cotangent, masked by relu(z)
        a1, b, s = _rand((n, h, w, 8), 86), _rand((n, h // 2, w // 2, 16), 87), 2
        kw = {"amask": _rand((n, h, w, 8), 88)}
    else:
        a1, b, s = _rand((3, 97, 131, 5), 89), _rand((3, 97, 131, 3), 90) + 0.5, 1
        kw = {"a2": _rand((3, 97, 131, 6), 91), "bias": True}
        a_abs = {"a2": kw["a2"].abs()}
    before = pc.wgrad3x3.launches
    dw, db = pc.wgrad3x3("test", a1, b, s, **kw)
    assert pc.wgrad3x3.launches == before + 1
    dw2, db2 = pc.wgrad3x3("test", a1, b, s, **kw)
    torch.cuda.synchronize()
    f64 = {k: (v.double() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
    want = pc.wgrad3x3_reference(a1.double(), b.double(), s, **f64)
    mags = pc.wgrad3x3_reference(a1.abs().double(), b.abs().double(), s,
                                 **{**f64, **{k: v.double() for k, v in a_abs.items()}})
    for got, again, exact, mag, what in zip((dw, db), (dw2, db2), want, mags, ("dw", "db")):
        if got is None:
            continue
        bound = 1e-6 * mag
        assert bound.max() <= 1e-2 * exact.abs().max(), what
        err = (got.double() - exact).abs()
        assert bool((err <= bound).all()), f"{what}: {err.max().item()}"
        assert torch.equal(got, again), what
