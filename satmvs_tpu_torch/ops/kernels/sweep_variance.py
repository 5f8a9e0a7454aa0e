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

Both are differentiable in the features, as JAX's custom VJP
(`_sweep_variance_bwd`, sweep_variance.py:226-256) makes its kernel: the
forward saves the features and the coordinates, never a volume; the
backward is one launch of the `sweep_variance_backward` kernel for the
batch (`_vjp`, counted in `sweep_variance_backward.launches`): it gathers
the source views again and adds each view's cotangent into its source
view's as it goes, with no cotangent volume, and writes the reference's.
The coordinates get no gradient.  For CPU tensors the backward is the
plain `sweep_variance_backward_reference`: JAX's composition, each
view's cotangent volume, then `sweep_scatter_reference`.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from ..cost_volume import sweep_variance_volume
from ..sampling import bilinear_sample
from . import build
from .sweep_gather import sweep_scatter_reference

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


def sweep_variance_backward_reference(feats: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                                      g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the `sweep_variance_backward` kernel, JAX's
    composition (`_sweep_variance_bwd`): feats (B, V, H, W, C), view 0 the
    reference; xs/ys (B, S, D, H, W); g (B, D, H, W, C) the volume's
    cotangent → dref (B, H, W, C) and dsrcs (B, S, H, W, C), the reference's
    and each source view's cotangent: `_backward_reference`'s cotangent
    volumes, each scattered into its source view by
    `sweep_scatter_reference`."""
    return _plain_vjp(feats[:, 0], feats[:, 1:], xs, ys, g)


def _plain_vjp(ref, srcs, xs, ys, g) -> tuple[torch.Tensor, torch.Tensor]:
    """`sweep_variance_backward_reference` of ref (B, H', W, C) and srcs
    (B, S, H, W, C), H' ≤ H (a band of reference rows): (dref, dsrcs)."""
    gs, dref = _backward_reference(ref, srcs, xs, ys, g)
    hs, w = srcs.shape[2], srcs.shape[3]
    dsrcs = torch.stack([torch.stack([sweep_scatter_reference(gs[b, s], xs[b, s], ys[b, s], hs, w)
                                      for s in range(xs.shape[1])])
                         for b in range(xs.shape[0])])
    return dref, dsrcs


def _backward_reference(ref, srcs, xs, ys, g) -> tuple[torch.Tensor, torch.Tensor]:
    """The cotangents of JAX's composition before its scatter: each source
    view sampled again (`bilinear_sample`), the mean m = (ref + Σ_s w_s) / V
    over the V = S + 1 views, and the elementwise adjoint of the variance,
    ∂var/∂f = (2/V)(f − m): ref (B, H', W, C) and srcs (B, S, H, W, C), H' ≤ H
    (a band of reference rows), xs/ys (B, S, D, H', W), g (B, D, H', W, C) →
    gs (B, S, D, H', W, C), each source view's cotangent volume
    g·((2/V)(w_s − m)), and dref (B, H', W, C), Σ_d g·((2/V)(ref − m))."""
    v = srcs.shape[1] + 1
    scale = 2.0 / v
    gs, dref = [], []
    for r, f, x, y, gb in zip(ref, srcs, xs, ys, g):
        warped = [bilinear_sample(f[s], x[s], y[s]) for s in range(v - 1)]
        mean = r[None]
        for w in warped:
            mean = mean + w
        mean = mean / v
        dref.append(torch.sum(gb * (scale * (r[None] - mean)), dim=0))
        gs.append(torch.stack([gb * (scale * (w - mean)) for w in warped]))
    return torch.stack(gs), torch.stack(dref)


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
                   + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(ref, srcs, bstride: int, xs, ys, out, plan: dict | None = None):
    """sweep_variance_f32 for sample b's maps at ref + b·bstride and
    srcs + b·bstride (floats; srcs (B, S, Hs, W, C), ref H rows of W·C
    floats, H ≤ Hs), xs/ys (B, S, D, H, W) into out (B, D, H, W, C), under
    `plan` or `sweep_variance_plan`'s; counts the launch."""
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
                     plan["planes"], plan["tx"], plan["ty"], srcs.shape[-3], stream)
    if rc != 0:
        raise RuntimeError(f"sweep_variance kernel launch failed: CUDA error {rc}")
    sweep_variance.launches += 1


@functools.lru_cache(maxsize=64)
def sweep_variance_backward_plan(b: int, s: int, d: int, h: int, w: int, c: int,
                                 aligned: bool = True) -> dict:
    """The launch of `sweep_variance_backward_f32`: the forward's vec, one
    group of vec channels a thread, a tile of about two warps a row (one of
    `sweep_variance_plan_options`), and every thread walking all D planes,
    so each reference cotangent is summed over the planes in order by one
    thread and each view's corner sums are carried from plane to plane
    (grid (tiles, 1, B)).  Raises where `sweep_variance_plan` does."""
    sweep_variance_plan(b, s, d, h, w, c, aligned)
    options = [o for o in sweep_variance_plan_options(b, s, d, h, w, c, aligned)
               if o["groups"] == 1]
    plan = min(options, key=lambda o: abs(o["lanes"] * o["tx"] - 64))
    return {**plan, "planes": d, "grid": (plan["grid"][0], 1, b)}


@functools.lru_cache(maxsize=1)
def _c_bwd():
    fn = build.load("sweep_variance").sweep_variance_backward_f32
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _cotangents(ref, srcs, bstride: int, xs, ys, g):
    """The backward kernel for sample b's maps at ref + b·bstride and srcs +
    b·bstride (ref (B, H, W, C), srcs (B, S, Hs, W, C), as `_launch` takes
    them), xs/ys (B, S, D, H, W) and g (B, D, H, W, C) → (dref (B, H, W, C),
    dsrcs (B, S, Hs, W, C)); one launch, counted."""
    b, n_src, d, h, w = xs.shape
    c = g.shape[-1]
    hs = srcs.shape[-3]
    dref = torch.empty((b, h, w, c), dtype=torch.float32, device=g.device)
    dsrcs = torch.zeros((b, n_src, hs, w, c), dtype=torch.float32, device=g.device)
    if dref.numel() == 0:
        return dref, dsrcs
    aligned = bstride % 4 == 0 and all(t.data_ptr() % 16 == 0
                                       for t in (ref, srcs, g, dsrcs, dref))
    plan = sweep_variance_backward_plan(b, n_src, d, h, w, c, aligned)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _c_bwd()(ref.data_ptr(), srcs.data_ptr(), bstride, xs.data_ptr(), ys.data_ptr(),
                      g.data_ptr(), dsrcs.data_ptr(), dref.data_ptr(), b, n_src, d, h, w, c,
                      plan["vec"], plan["tx"], plan["ty"], hs, stream)
    if rc != 0:
        raise RuntimeError(f"sweep_variance_backward kernel launch failed: CUDA error {rc}")
    sweep_variance_backward.launches += 1
    return dref, dsrcs


def _check(ref, srcs, xs, ys, batched: bool):
    """ref (H', W, C), srcs (S, H, W, C), xs/ys (S, D, H', W), each with a
    leading B when batched, H' = H or a band of H' < H reference rows; all
    float32 on one device."""
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
    hs = srcs.shape[-3]
    if tuple(srcs.shape) != (*bs, n_src, hs, w, c) or hs < h:
        raise ValueError(f"{name}: source views {tuple(srcs.shape)} != {(*bs, n_src, h, w, c)}")
    if tuple(xs.shape) != (*bs, n_src, d, h, w) or ys.shape != xs.shape:
        raise ValueError(f"{name}: xs {tuple(xs.shape)} / ys {tuple(ys.shape)} "
                         f"!= {(*bs, n_src, d, h, w)}")


def _cuda_operands(name: str, **tensors):
    """Raise unless the operands are contiguous CUDA tensors."""
    device = next(iter(tensors.values())).device
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    for what, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def _vjp(ref, srcs, bstride: int, xs, ys, g) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward of the sweep for sample b's maps at ref + b·bstride and
    srcs + b·bstride (ref (B, H, W, C) and srcs (B, S, H, W, C), as `_launch`
    takes them; bstride is not read for CPU tensors), xs/ys (B, S, D, H, W)
    and the volume's cotangent g (B, D, H, W, C) contiguous → (dref (B, H,
    W, C), dsrcs (B, S, H, W, C)): one `sweep_variance_backward` launch, or
    for CPU tensors its plain version."""
    if g.device.type == "cpu":
        return _plain_vjp(ref, srcs, xs, ys, g)
    return _cotangents(ref, srcs, bstride, xs, ys, g)


class _SweepVariance(torch.autograd.Function):
    """The sweep of sample b's maps at ref + b·bstride and srcs + b·bstride
    (ref (B, H, W, C), srcs (B, S, H, W, C)): the kernel forward (for CPU
    tensors its plain version), saving the features and the coordinates;
    backward `_vjp`.  The coordinates get no gradient."""

    @staticmethod
    def forward(ctx, ref, srcs, xs, ys, bstride):
        ctx.save_for_backward(ref, srcs, xs, ys)
        ctx.bstride = bstride
        if ref.device.type == "cpu":
            return torch.stack([sweep_variance_reference(*args)
                                for args in zip(ref, srcs, xs, ys)])
        b, _, d, h, w = xs.shape
        out = torch.empty((b, d, h, w, ref.shape[-1]), dtype=torch.float32, device=ref.device)
        _launch(ref, srcs, bstride, xs, ys, out)
        return out

    @staticmethod
    def backward(ctx, g):
        ref, srcs, xs, ys = ctx.saved_tensors
        dref, dsrcs = _vjp(ref, srcs, ctx.bstride, xs, ys, g.contiguous())
        return dref, dsrcs, None, None, None


def sweep_variance(ref: torch.Tensor, srcs: torch.Tensor, xs: torch.Tensor,
                   ys: torch.Tensor) -> torch.Tensor:
    """Variance cost volume over {ref, srcs warped at (xs, ys)}.

    ref (H, W, C), srcs (S, H, W, C), xs/ys (S, D, H, W), all float32 on one
    device → (D, H, W, C) float32, differentiable in ref and srcs (module
    docstring).  CUDA tensors go to the CUDA kernel (the inputs must be
    contiguous; one launch, as `sweep_variance_batched` with B = 1); CPU
    tensors to `sweep_variance_reference`.
    """
    _check(ref, srcs, xs, ys, batched=False)
    if ref.device.type != "cpu":
        _cuda_operands("sweep_variance", ref=ref, srcs=srcs, xs=xs, ys=ys)
    return _SweepVariance.apply(ref[None], srcs[None], xs[None], ys[None], 0)[0]


def _batched(feats: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
             plan: dict | None = None, row0: int = 0) -> torch.Tensor:
    """sweep_variance_batched's forward on contiguous CUDA operands, under
    `plan` (one of `sweep_variance_plan_options`) or `sweep_variance_plan`'s;
    no graph."""
    b, v, h, w, c = feats.shape
    hb = xs.shape[3]
    out = torch.empty((b, xs.shape[2], hb, w, c), dtype=torch.float32, device=feats.device)
    _launch(feats[:, 0, row0:row0 + hb], feats[:, 1:], v * h * w * c, xs, ys, out, plan)
    return out


def sweep_variance_batched(feats: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                           row0: int = 0) -> torch.Tensor:
    """`sweep_variance` of every sample of a batch, in one launch.

    feats (B, V, H, W, C), view 0 the reference; xs/ys (B, V − 1, D, H', W)
    for the reference rows row0 .. row0 + H' − 1 (all H rows by default; a
    band of them is a rank's share under height sharding); all float32 on
    one device → (B, D, H', W, C) float32, each sample
    `sweep_variance(feats[b, 0], feats[b, 1:], xs[b], ys[b])` bit for bit
    (on the band, its rows), differentiable in feats (one
    `sweep_variance_backward` launch for the batch).
    CUDA tensors (contiguous) go to the CUDA kernel; CPU tensors to
    `sweep_variance_batched_reference`.
    """
    if feats.ndim != 5:
        raise ValueError(f"sweep_variance_batched: want feats (B, V, H, W, C), got "
                         f"{tuple(feats.shape)}")
    b, v, h, w, c = feats.shape
    hb = xs.shape[3] if xs.ndim == 5 else h
    if not 0 <= row0 <= h - hb:
        raise ValueError(f"sweep_variance_batched: rows {row0} .. {row0 + hb - 1} of {h}")
    ref = feats[:, 0, row0:row0 + hb]
    _check(ref, feats[:, 1:], xs, ys, batched=True)
    if feats.device.type != "cpu":
        _cuda_operands("sweep_variance_batched", feats=feats, xs=xs, ys=ys)
    return _SweepVariance.apply(ref, feats[:, 1:], xs, ys, v * h * w * c)


def sweep_variance_backward(feats: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                            g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused sweep's VJP, the backward kernel alone: feats (B, V, H, W,
    C), view 0 the reference; xs/ys (B, V − 1, D, H, W); g (B, D, H, W, C)
    the volume's cotangent; all float32 on one device → (dref (B, H, W, C),
    dsrcs (B, S, H, W, C)) as `sweep_variance_backward_reference` defines
    them.  CUDA tensors (contiguous) go to the kernel: one launch; dref the
    same bits in every run, dsrcs summed with float atomics in an order that
    changes from run to run (within the summation bound of
    csrc/sweep_gather.cu).  CPU tensors go to the plain version."""
    if feats.ndim != 5 or tuple(g.shape) != (feats.shape[0], xs.shape[2], *feats.shape[2:]):
        raise ValueError(f"sweep_variance_backward: want feats (B, V, H, W, C) and g (B, D, H, "
                         f"W, C), got {tuple(feats.shape)} and {tuple(g.shape)}")
    _check(feats[:, 0], feats[:, 1:], xs, ys, batched=True)
    if g.dtype != torch.float32 or g.device != feats.device:
        raise TypeError(f"sweep_variance_backward: g must be float32 on {feats.device}")
    if feats.device.type == "cpu":
        return sweep_variance_backward_reference(feats, xs, ys, g)
    _cuda_operands("sweep_variance_backward", feats=feats, xs=xs, ys=ys, g=g)
    b, v, h, w, c = feats.shape
    return _cotangents(feats[:, 0], feats[:, 1:], v * h * w * c, xs, ys, g)


sweep_variance.launches = 0
sweep_variance_backward.launches = 0
