"""The sweep_variance wrapper: CPU tensors take the plain version, CUDA
tensors the CUDA kernel (tests marked `cuda` need a GPU and nvcc and skip
without them), and the module imports without nvcc."""

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
            "satmvs_tpu_torch.models.cascade")
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()
    assert "sweep_variance" in build.sources()


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
