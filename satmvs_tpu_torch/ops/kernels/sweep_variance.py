"""Fused plane-sweep variance cost volume: CUDA kernel and its plain version.

Replaces the TPU kernel `satmvs_tpu/ops/pallas/sweep_variance.py`
(`_sweep_variance_impl_hcw`, pallas_call at :161).  The CUDA source is
`satmvs_tpu_torch/csrc/sweep_variance.cu`; its header comment gives the
design and the memory bound.

Two entries launch the same kernel: `sweep_variance` (one sample) and
`sweep_variance_batched` (all samples of a batch in one launch, written in
place into one (B, D, H, W, C) volume).  Both count each launch in
`sweep_variance.launches`.  For CPU tensors, and only for them, they compute
the plain versions `sweep_variance_reference` and
`sweep_variance_batched_reference`.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from ..cost_volume import sweep_variance_volume
from ..sampling import bilinear_sample
from . import build, refuse_graph

SWEEP_THREADS = 256        # threads a block at most (the kernel's launch bounds)
SWEEP_ROW_THREADS = (32, 64, 128)  # threads a tile row: a warp, two, four
SWEEP_GROUPS = {4: (1, 2), 1: (1,)}  # channel groups of VEC a thread, by VEC
SWEEP_PLANES = (1, 2, 4, 8, 16)      # planes a thread
SWEEP_MAX_VIEWS_2 = 2                # source views with two groups a thread (more spill)


def sweep_variance_reference(ref: torch.Tensor, srcs: torch.Tensor, xs: torch.Tensor,
                             ys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: bilinear_sample of each source view, then the
    variance over {ref, warped srcs}.  ref (H, W, C), srcs (S, H, W, C),
    xs/ys (S, D, H, W) → (D, H, W, C) float32."""
    return sweep_variance_volume(ref, srcs, lambda feat, s: bilinear_sample(feat, xs[s], ys[s]))


def sweep_variance_batched_reference(feats: torch.Tensor, xs: torch.Tensor,
                                     ys: torch.Tensor) -> torch.Tensor:
    """Plain version of `sweep_variance_batched`: `sweep_variance_reference`
    on each sample.  feats (B, V, H, W, C), view 0 the reference; xs/ys
    (B, V − 1, D, H, W) → (B, D, H, W, C) float32."""
    return torch.stack([sweep_variance_reference(f[0], f[1:], x, y)
                        for f, x, y in zip(feats, xs, ys)])


def sweep_variance_plan_options(b: int, s: int, d: int, h: int, w: int, c: int,
                                aligned: bool = True) -> list[dict]:
    """Every launch the kernel takes for B samples of S source views, D
    planes of h×w pixels and C channels: float4 channel groups when C % 4 ==
    0 and the features and output are 16-byte aligned (vec 4), else single
    channels (vec 1); G groups (`SWEEP_GROUPS`; two up to
    `SWEEP_MAX_VIEWS_2` views) and K planes (`SWEEP_PLANES`, at most D) a
    thread; a tile of tx pixels × ty rows with `lanes` = C / (vec·G)
    threads a pixel, about `SWEEP_ROW_THREADS` threads a row and at most
    `SWEEP_THREADS` a block, neither wider nor taller than the plane.  Each dict holds vec,
    groups, planes, lanes, tx, ty, threads and the grid (tiles, chunks, B).
    Every option computes every output the same way (the same bits).  Any
    S ≥ 1: up to four views the kernel unrolls them all, beyond four it
    walks them in groups of up to four (the same sums in the same order)."""
    vec = 4 if c % 4 == 0 and aligned else 1
    options = []
    for groups, planes in itertools.product(SWEEP_GROUPS[vec], SWEEP_PLANES):
        lanes = c // (vec * groups)
        if groups == 2 and s > SWEEP_MAX_VIEWS_2:
            continue
        if planes > d > planes // 2:
            planes = d
        elif planes > d:
            continue
        if c % (vec * groups) or lanes > SWEEP_THREADS:
            continue
        tiles = set()
        for row in SWEEP_ROW_THREADS:
            tx = max(1, min(row // lanes, w))
            ty = max(1, min(SWEEP_THREADS // (lanes * tx), h))
            tiles.add((tx, ty))
        for tx, ty in sorted(tiles):
            options.append({"vec": vec, "groups": groups, "planes": planes, "lanes": lanes,
                            "tx": tx, "ty": ty, "threads": lanes * tx * ty,
                            "grid": (-(-h // ty) * -(-w // tx), -(-d // planes), b)})
    return options


@functools.lru_cache(maxsize=64)
def sweep_variance_plan(b: int, s: int, d: int, h: int, w: int, c: int,
                        aligned: bool = True) -> dict:
    """The launch of `sweep_variance_f32` (one of `sweep_variance_plan_options`):
    two channel groups a thread where the kernel has them (else one), eight
    planes a thread (at most D) and two warps a tile row.  Every plan gives
    the same bits; this one was the fastest, or within 3 % of it, at the
    three forward and the three scene-chunk shapes on an H100
    (`kernel_ab.py --only sweep --sweep`: each thread waits on one memory
    round trip a plane, so fewer threads that walk more planes, and more
    channels a thread, won).  Any number S ≥ 1 of source views; beyond two,
    one group a thread.  Pure Python, cached (do not modify what it
    returns); raises ValueError for a shape the kernel cannot take."""
    if min(b, d, h, w, c) < 1:
        raise ValueError(f"sweep_variance: empty operand (B, S, D, H, W, C) = "
                         f"{(b, s, d, h, w, c)}")
    if s < 1:
        raise ValueError(f"sweep_variance: {s} source views; the kernel takes at least 1")
    if b > 65535:
        raise ValueError(f"sweep_variance: {b} samples exceed the grid's 65535")
    if (h + 2) * (w + 2) * c >= 2 ** 31:
        raise ValueError(f"sweep_variance: a {h}×{w}×{c} map exceeds 32-bit offsets")
    options = sweep_variance_plan_options(b, s, d, h, w, c, aligned)
    if not options:
        raise ValueError(f"sweep_variance: {c} channels take more than {SWEEP_THREADS} threads "
                         f"a pixel")
    want = (2, min(8, d), 64)
    plan = min(options, key=lambda o: (abs(o["groups"] - want[0]), abs(o["planes"] - want[1]),
                                       abs(o["lanes"] * o["tx"] - want[2])))
    tiles, chunks, _ = plan["grid"]
    if tiles >= 2 ** 31 or chunks > 65535:
        raise ValueError(f"sweep_variance: a grid of {tiles} tiles × {chunks} plane chunks is "
                         f"too large")
    return plan


@functools.lru_cache(maxsize=1)
def _c_fn():
    fn = build.load("sweep_variance").sweep_variance_f32
    # pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(ref, srcs, bstride: int, xs, ys, out, plan: dict | None = None):
    """sweep_variance_f32 for sample b's maps at ref + b·bstride and
    srcs + b·bstride (floats), xs/ys (B, S, D, H, W) into out (B, D, H, W, C),
    under `plan` or `sweep_variance_plan`'s; counts the launch."""
    b, n_src, d, h, w = xs.shape
    c = out.shape[-1]
    if out.numel() == 0:
        return
    aligned = bstride % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (ref, srcs, out))
    if plan is None:
        plan = sweep_variance_plan(b, n_src, d, h, w, c, aligned)
    elif plan["vec"] == 4 and not aligned:
        raise ValueError("sweep_variance: a float4 plan on operands that are not 16-byte aligned")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _c_fn()(ref.data_ptr(), srcs.data_ptr(), bstride, xs.data_ptr(), ys.data_ptr(),
                     out.data_ptr(), b, n_src, d, h, w, c, plan["vec"], plan["groups"],
                     plan["planes"], plan["tx"], plan["ty"], stream)
    if rc != 0:
        raise RuntimeError(f"sweep_variance kernel launch failed: CUDA error {rc}")
    sweep_variance.launches += 1


def _check(ref, srcs, xs, ys, batched: bool):
    """ref (H, W, C), srcs (S, H, W, C), xs/ys (S, D, H, W), each with a
    leading B when batched; all float32 on one device."""
    name = "sweep_variance_batched" if batched else "sweep_variance"
    lead = 1 if batched else 0
    for what, t in (("ref", ref), ("srcs", srcs), ("xs", xs), ("ys", ys)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name}: {what} is on {t.device}, ref on {ref.device}")
    if ref.ndim != 3 + lead or srcs.ndim != 4 + lead or xs.ndim != 4 + lead:
        raise ValueError(f"{name}: want ref (H, W, C), srcs (S, H, W, C), xs/ys (S, D, H, W)"
                         f"{', each with a leading B' if batched else ''}; got "
                         f"{tuple(ref.shape)}, {tuple(srcs.shape)}, {tuple(xs.shape)}")
    *bs, h, w, c = ref.shape
    n_src, d = xs.shape[lead], xs.shape[lead + 1]
    if tuple(srcs.shape) != (*bs, n_src, h, w, c):
        raise ValueError(f"{name}: source views {tuple(srcs.shape)} != {(*bs, n_src, h, w, c)}")
    if tuple(xs.shape) != (*bs, n_src, d, h, w) or ys.shape != xs.shape:
        raise ValueError(f"{name}: xs {tuple(xs.shape)} / ys {tuple(ys.shape)} "
                         f"!= {(*bs, n_src, d, h, w)}")


def _cuda_operands(name: str, **tensors):
    """Raise unless the operands are contiguous CUDA tensors that need no graph."""
    device = next(iter(tensors.values())).device
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    refuse_graph(name, "its backward composes sweep_gather and sweep_scatter and is not written "
                 "yet; training takes the per-view sweep_gather instead", *tensors.values())
    for what, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def sweep_variance(ref: torch.Tensor, srcs: torch.Tensor, xs: torch.Tensor,
                   ys: torch.Tensor) -> torch.Tensor:
    """Variance cost volume over {ref, srcs warped at (xs, ys)}.

    ref (H, W, C), srcs (S, H, W, C), xs/ys (S, D, H, W), all float32 on one
    device → (D, H, W, C) float32.  CUDA tensors go to the CUDA kernel (the
    inputs must be contiguous; one launch, as `sweep_variance_batched` with
    B = 1); CPU tensors to `sweep_variance_reference`.  On CUDA tensors it
    raises where autograd would record a graph (`refuse_graph`).
    """
    _check(ref, srcs, xs, ys, batched=False)
    if ref.device.type == "cpu":
        return sweep_variance_reference(ref, srcs, xs, ys)
    _cuda_operands("sweep_variance", ref=ref, srcs=srcs, xs=xs, ys=ys)
    h, w, c = ref.shape
    out = torch.empty((xs.shape[1], h, w, c), dtype=torch.float32, device=ref.device)
    _launch(ref, srcs, 0, xs[None], ys[None], out[None])
    return out


def _batched(feats: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
             plan: dict | None = None) -> torch.Tensor:
    """sweep_variance_batched on contiguous CUDA operands, under `plan` (one
    of `sweep_variance_plan_options`) or `sweep_variance_plan`'s."""
    b, v, h, w, c = feats.shape
    out = torch.empty((b, xs.shape[2], h, w, c), dtype=torch.float32, device=feats.device)
    _launch(feats, feats[:, 1:], v * h * w * c, xs, ys, out, plan)
    return out


def sweep_variance_batched(feats: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """`sweep_variance` of every sample of a batch, in one launch.

    feats (B, V, H, W, C), view 0 the reference; xs/ys (B, V − 1, D, H, W);
    all float32 on one device → (B, D, H, W, C) float32, each sample
    `sweep_variance(feats[b, 0], feats[b, 1:], xs[b], ys[b])` bit for bit.
    CUDA tensors (contiguous) go to the CUDA kernel; CPU tensors to
    `sweep_variance_batched_reference`.  On CUDA tensors it raises where
    autograd would record a graph (`refuse_graph`).
    """
    if feats.ndim != 5:
        raise ValueError(f"sweep_variance_batched: want feats (B, V, H, W, C), got "
                         f"{tuple(feats.shape)}")
    _check(feats[:, 0], feats[:, 1:], xs, ys, batched=True)
    if feats.device.type == "cpu":
        return sweep_variance_batched_reference(feats, xs, ys)
    _cuda_operands("sweep_variance_batched", feats=feats, xs=xs, ys=ys)
    return _batched(feats, xs, ys)


sweep_variance.launches = 0
