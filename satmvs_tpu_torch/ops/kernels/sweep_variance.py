"""Fused plane-sweep variance cost volume: CUDA kernel and its plain version.

Replaces the TPU kernel `satmvs_tpu/ops/pallas/sweep_variance.py`
(`_sweep_variance_impl_hcw`, pallas_call at :161).  The CUDA source is
`satmvs_tpu_torch/csrc/sweep_variance.cu`; its header comment gives the
design and the memory bound.

`sweep_variance` launches the kernel for CUDA tensors and counts each launch
in `sweep_variance.launches`.  For CPU tensors, and only for them, it
computes the plain version `sweep_variance_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from ..cost_volume import sweep_variance_volume
from ..sampling import bilinear_sample
from . import build, refuse_graph


def sweep_variance_reference(ref: torch.Tensor, srcs: torch.Tensor, xs: torch.Tensor,
                             ys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: bilinear_sample of each source view, then the
    variance over {ref, warped srcs}.  ref (H, W, C), srcs (S, H, W, C),
    xs/ys (S, D, H, W) → (D, H, W, C) float32."""
    return sweep_variance_volume(ref, srcs, lambda feat, s: bilinear_sample(feat, xs[s], ys[s]))


def _c_fn():
    fn = build.load("sweep_variance").sweep_variance_f32
    # pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(ref, srcs, xs, ys):
    tensors = {"ref": ref, "srcs": srcs, "xs": xs, "ys": ys}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"sweep_variance: {name} must be float32, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"sweep_variance: {name} is on {t.device}, ref on {ref.device}")
    if ref.ndim != 3 or srcs.ndim != 4 or xs.ndim != 4:
        raise ValueError("sweep_variance: want ref (H, W, C), srcs (S, H, W, C), "
                         f"xs/ys (S, D, H, W); got {tuple(ref.shape)}, "
                         f"{tuple(srcs.shape)}, {tuple(xs.shape)}")
    h, w, c = ref.shape
    n_src, d = xs.shape[0], xs.shape[1]
    if tuple(srcs.shape) != (n_src, h, w, c):
        raise ValueError(f"sweep_variance: srcs {tuple(srcs.shape)} != {(n_src, h, w, c)}")
    if tuple(xs.shape) != (n_src, d, h, w) or ys.shape != xs.shape:
        raise ValueError(f"sweep_variance: xs {tuple(xs.shape)} / ys {tuple(ys.shape)} "
                         f"!= {(n_src, d, h, w)}")


def sweep_variance(ref: torch.Tensor, srcs: torch.Tensor, xs: torch.Tensor,
                   ys: torch.Tensor) -> torch.Tensor:
    """Variance cost volume over {ref, srcs warped at (xs, ys)}.

    ref (H, W, C), srcs (S, H, W, C), xs/ys (S, D, H, W), all float32 on one
    device → (D, H, W, C) float32.  CUDA tensors go to the CUDA kernel (the
    inputs must be contiguous); CPU tensors to `sweep_variance_reference`.
    On CUDA tensors it raises where autograd would record a graph
    (`refuse_graph`).
    """
    _check(ref, srcs, xs, ys)
    if ref.device.type == "cpu":
        return sweep_variance_reference(ref, srcs, xs, ys)
    if ref.device.type != "cuda":
        raise ValueError(f"sweep_variance: unsupported device {ref.device}")
    refuse_graph("sweep_variance", "its backward composes sweep_gather and sweep_scatter and is "
                 "not written yet; training takes the per-view sweep_gather instead",
                 ref, srcs, xs, ys)
    for name, t in (("ref", ref), ("srcs", srcs), ("xs", xs), ("ys", ys)):
        if not t.is_contiguous():
            raise ValueError(f"sweep_variance: {name} must be contiguous")
    h, w, c = ref.shape
    n_src, d = xs.shape[0], xs.shape[1]
    out = torch.empty((d, h, w, c), dtype=torch.float32, device=ref.device)
    ptrs = [t.data_ptr() for t in (ref, srcs, xs, ys, out)]
    vec = 4 if c % 4 == 0 and all(p % 16 == 0 for p in ptrs) else 1
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _c_fn()(*ptrs, n_src, d, h, w, c, vec, stream)
    if rc != 0:
        raise RuntimeError(f"sweep_variance kernel launch failed: CUDA error {rc}")
    sweep_variance.launches += 1
    return out


sweep_variance.launches = 0
