"""The kernel wrappers (sweep_variance, conv_dn, deconv_up, conv_head,
red_recur): CPU tensors take the plain version, CUDA tensors the CUDA kernel
(tests marked `cuda` need a GPU and nvcc and skip without them), and the
modules import without nvcc."""

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
            "satmvs_tpu_torch.models.cascade, satmvs_tpu_torch.infer.scene, "
            "satmvs_tpu_torch.infer.predict")
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()
    assert {"sweep_variance", "plane_conv", "red_recur"} <= set(build.sources())


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
                                            (2, 12, 6, 32, 64)])
def test_cuda_conv_dn_matches_plain_version(n, h, w, cin, cout):
    """Even and odd sizes, Cin and Cout with and without C % 4 == 0."""
    from satmvs_tpu_torch.ops.kernels.plane_conv import conv_dn, conv_dn_reference

    _cuda()
    x, wt = _rand((n, h, w, cin), 0), _rand((cout, cin, 3, 3), 1, 0.2)
    before = conv_dn.launches
    out = conv_dn(x, wt)
    assert conv_dn.launches == before + 1
    _close(out, conv_dn_reference(x, wt), "conv_dn")


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,skip", [(3, 8, 12, 16, 8, True), (2, 5, 7, 6, 3, False),
                                                 (1, 3, 6, 64, 32, True)])
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
                                                (3, 6, 12, 64, 64, True)])
def test_cuda_red_recur_matches_plain_version(d, h, w, cin, c, seeded):
    """Odd sizes, Cin % 4 != 0, C = 64, zero and seeded start states: 1e-4 on
    states in (−1, 1) (GroupNorm statistics in float64 against torch's fp32)."""
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
                                           (4, 5, 16, 24, 8, 8)])
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
def test_cuda_red_recur_refused_grid_raises(monkeypatch):
    """A grid the card cannot hold raises and launches nothing: more
    elements than resident blocks, and a grid cudaLaunchCooperativeKernel
    refuses; a launch after either still runs."""
    from satmvs_tpu_torch.ops.kernels import red_recur as rr

    _cuda()
    cell = _red_cell(4, 4, 40)
    before = rr.red_recur.launches
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="no cooperative grid"):
            rr.red_recur(_rand((20000, 1, 4, 4, 4), 41), cell)
        x = _rand((2, 3, 8, 8, 4), 42)
        monkeypatch.setattr(rr, "grid_blocks", lambda b, h, w, c: 2 * 4000)
        with pytest.raises(RuntimeError, match="launch failed"):
            rr.red_recur(x, cell)
        assert rr.red_recur.launches == before
        monkeypatch.undo()
        out = rr.red_recur(x, cell)
        torch.cuda.synchronize()
    assert rr.red_recur.launches == before + 1
    assert (out - rr.red_recur_reference(x, cell)).abs().max().item() <= 1e-4
