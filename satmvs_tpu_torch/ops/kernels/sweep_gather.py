"""Per-view plane-sweep gather and its scatter adjoint: CUDA kernels and
their plain versions.

Replaces the two TPU kernels of `satmvs_tpu/ops/pallas/sweep_gather.py`:
`_sweep_gather_impl_hcw` (pallas_call at :436, kernel :315) and
`_sweep_scatter_impl_hcw` (pallas_call at :576, kernel :475), tied together
by the custom VJP of its `sweep_gather` (:636-681).  The CUDA source is
`satmvs_tpu_torch/csrc/sweep_gather.cu`; its header gives the design, the
bound and the scatter's summation-order tolerance.  The fp32 pair walks
runs of planes a thread; the bf16 pair has kernels of its own: the gather
keeps a thread's corners while they stay, the scatter sorts a block's
samples by floor corner in a shared-memory window and sums each touched
pixel in registers (`scatter_window_plan`), and counts the blocks whose
window did not fit (`window_blocks`).

`sweep_gather(src, xs, ys, out_dtype=None)` is differentiable in `src`
(the coordinates carry no gradient, as in JAX): its backward is
`sweep_scatter`.  out_dtype=torch.bfloat16 stores the warped volume in
bf16 (JAX's `out_dtype=bfloat16`, the same pallas_call traced with a bf16
output): the taps are summed in fp32 and rounded once at the store, and the
backward reads the bf16 cotangent into the fp32 scatter.  Both wrappers
launch their kernel for CUDA tensors and count each launch, the fp32
instances in `<wrapper>.launches` and the bf16 ones in
`<wrapper>.launches_bf16`; for CPU tensors, and only for them, they compute
the plain versions `sweep_gather_reference` (`ops.sampling.bilinear_sample`,
then the cast) and `sweep_scatter_reference` (an `index_add_` scatter of
the fp32 cotangent, the form of `_bilinear_scatter`, sweep_gather.py:607-633).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..sampling import bilinear_sample
from . import build


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}  # volume dtype → kernel instance


def _volume_dtype(out_dtype) -> torch.dtype:
    dtype = torch.float32 if out_dtype is None else out_dtype
    if dtype not in _SUFFIX:
        raise ValueError(f"sweep_gather: out_dtype {out_dtype!r}: want None, torch.float32 or "
                         f"torch.bfloat16")
    return dtype


def sweep_gather_reference(src: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                           out_dtype=None) -> torch.Tensor:
    """Plain version of the gather: src (H, W, C) sampled at xs, ys (D, H, W)
    → (D, H, W, C), zero outside the image, cast to out_dtype (None: fp32)."""
    return bilinear_sample(src, xs, ys).to(_volume_dtype(out_dtype))


def sweep_scatter_reference(g: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                            height: int, width: int) -> torch.Tensor:
    """Plain version of the transpose: g (D, H', W', C), fp32 or bf16 (widened
    to fp32), scattered into the (height, width, C) fp32 source at the taps
    of the samples (xs, ys) (D, H', W'); H' may be a band of the height rows."""
    c = g.shape[-1]
    x, y = xs.reshape(-1), ys.reshape(-1)
    gf = g.reshape(-1, c).to(torch.float32)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    # the clamp of bilinear_sample: the cast is undefined out of range
    x0i = x0.clamp(-2, width).to(torch.int64)
    y0i = y0.clamp(-2, height).to(torch.int64)
    out = torch.zeros((height * width, c), dtype=torch.float32, device=g.device)
    for dy, dx, wgt in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                        (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yy, xx = y0i + dy, x0i + dx
        valid = (xx >= 0) & (xx < width) & (yy >= 0) & (yy < height)
        idx = yy.clamp(0, height - 1) * width + xx.clamp(0, width - 1)
        out.index_add_(0, idx, gf * (wgt * valid)[:, None])
    return out.reshape(height, width, c)


@functools.lru_cache(maxsize=None)
def _c_fn(name: str, n_ints: int, n_ptrs: int = 0):
    """The C entry point `name`: four pointers, n_ints ints, n_ptrs more
    pointers, the stream."""
    fn = getattr(build.load("sweep_gather"), name)
    # pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p] * (n_ptrs + 1))
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(name: str, values: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
           value_dtypes=(torch.float32,)):
    for key, t in (("values", values), ("xs", xs), ("ys", ys)):
        want = value_dtypes if key == "values" else (torch.float32,)
        if t.dtype not in want:
            raise TypeError(f"{name}: {key} must be {' or '.join(map(str, want))}, got {t.dtype}")
        if t.device != values.device:
            raise ValueError(f"{name}: {key} is on {t.device}, values on {values.device}")
    if xs.ndim != 3 or ys.shape != xs.shape:
        raise ValueError(f"{name}: want xs/ys (D, H, W), got {tuple(xs.shape)} / "
                         f"{tuple(ys.shape)}")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {values.device}")


# planes each gather thread walks, two at a time: of 1, 2, 4 and 8, 4 and 8
# were fastest at the train step's shapes (kernel_ab.py --sweep on an H100),
# and 4 keeps twice the threads in flight
GATHER_PLANES = 4
# planes each bf16 gather thread walks, keeping its corners while they stay
GATHER_PLANES_BF16 = 8

# the bf16 scatter's window: its sort of a block's samples by floor corner
# takes SCATTER_SORT ints a sample and one a floor corner, room for
# SCATTER_CORNERS corners, and at most SCATTER_WINDOW ints of shared memory
# (48 KB less the kernel's 144 static bytes, its most); at most
# SCATTER_GROUP channels a block, and enough blocks for SCATTER_WAVES waves
# of SCATTER_RESIDENT blocks an SM (its launch bounds: 64 registers a
# thread).  kernel_ab.py --sweep on an H100 chose 8, 8 and 4 planes at the
# train shapes, and windows sized to the block over the most
SCATTER_WINDOW = 12252
SCATTER_SORT = 7
SCATTER_CORNERS = 4096
SCATTER_GROUP = 32
SCATTER_WAVES = 4
SCATTER_RESIDENT = 4


def volume_vec(c: int, aligned: bool = True) -> int:
    """Channels a thread of the bf16 kernels moves: 8 (16 bytes of bf16)
    where C % 8 == 0, else 4 where C % 4 == 0, else 1; 1 when a pointer is
    not 16-byte aligned."""
    if not aligned:
        return 1
    return 8 if c % 8 == 0 else 4 if c % 4 == 0 else 1


def scatter_window_plan(d: int, h: int, w: int, c: int, hs: int | None = None, sms: int = 132,
                        vec: int | None = None, planes: int | None = None,
                        budget: int | None = None) -> dict:
    """The bf16 scatter's launch plan for g (d, h, w, c) into a source of hs
    rows (default h): channels a thread `vec`, channels a block `cg` (all of
    C up to SCATTER_GROUP, else SCATTER_GROUP rounded down to a multiple of
    vec), `lanes` = cg / vec threads a pixel, tiles of ty × tx pixels (tx up
    to 32, about 256 threads), `threads` a block, chunks of `planes` planes
    (D cut into the fewest equal chunks that still give SCATTER_WAVES waves
    of SCATTER_RESIDENT blocks an SM, unless given), the window's `budget`
    ints (unless given, SCATTER_SORT a sample of a full block and
    SCATTER_CORNERS, at most SCATTER_WINDOW: shared memory the window does
    not take is L1 cache for the block's reads), and the `grid` (tiles_y ·
    tiles_x, chunks, channel groups).  A block keeps its window when its
    floor corners (the box of the pixels its samples touch, one more row
    and column) + 1 + SCATTER_SORT × its samples fit the budget."""
    hs = h if hs is None else hs
    if min(d, h, w, c) < 1 or hs < h:
        raise ValueError(f"scatter_window_plan: no plan for g {(d, h, w, c)} into {hs} rows")
    vec = volume_vec(c) if vec is None else vec
    if vec not in (1, 4, 8) or c % vec:
        raise ValueError(f"scatter_window_plan: {vec} channels a thread for C = {c}")
    if planes is not None and planes < 1:
        raise ValueError(f"scatter_window_plan: {planes} planes a block")
    if budget is not None and not 0 <= budget <= SCATTER_WINDOW:
        raise ValueError(f"scatter_window_plan: a window of {budget} ints, the most is "
                         f"{SCATTER_WINDOW}")
    cg = min(c, max(vec, SCATTER_GROUP // vec * vec))
    lanes = cg // vec
    pixels = max(1, 256 // lanes)
    tx = min(32, pixels)
    ty = max(1, pixels // tx)
    threads = min(256, -(-ty * tx * lanes // 32) * 32)
    tiles = -(-h // ty) * -(-w // tx) * -(-c // cg)
    if planes is None:
        per = max(1, min(d, d * tiles // (SCATTER_WAVES * SCATTER_RESIDENT * sms)))
        planes = -(-d // -(-d // per))
    if budget is None:
        budget = min(SCATTER_WINDOW, SCATTER_SORT * ty * tx * planes + SCATTER_CORNERS)
    return {"vec": vec, "cg": cg, "lanes": lanes, "ty": ty, "tx": tx, "threads": threads,
            "planes": planes, "budget": budget,
            "grid": (-(-h // ty) * -(-w // tx), -(-d // planes), -(-c // cg))}


_window_blocks: dict = {}


def window_blocks(device) -> torch.Tensor:
    """The bf16 scatter's block counts on `device` since its first launch
    there: int32 [blocks launched, blocks whose window did not fit (they
    took the per-pixel path)], on the device, added to by the kernel."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _window_blocks:
        _window_blocks[device] = torch.zeros(2, dtype=torch.int32, device=device)
    return _window_blocks[device]


def scatter_planes(d: int, h: int, w: int, groups: int, sms: int = 132) -> int:
    """Planes each scatter thread walks: D cut into the fewest equal chunks
    that still give about two threads per resident thread slot of the card
    (2048 an SM), so runs of planes that share a corner are long and the
    card stays full."""
    per = max(1, min(d, d * h * w * groups // (2 * 2048 * sms)))
    return -(-d // -(-d // per))


def _pointers(name: str, values, xs, ys, out) -> tuple[list[int], bool]:
    """The four tensors' pointers (values, xs, ys contiguous) and whether
    all are 16-byte aligned."""
    for key, t in (("values", values), ("xs", xs), ("ys", ys)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    ptrs = [t.data_ptr() for t in (values, xs, ys, out)]
    return ptrs, all(p % 16 == 0 for p in ptrs)


@functools.lru_cache(maxsize=256)
def _window_plan(d: int, h: int, w: int, c: int, hs: int, sms: int) -> dict:
    return scatter_window_plan(d, h, w, c, hs, sms)


def _launch(name: str, values, xs, ys, out, d: int, h: int, w: int, c: int, planes: int,
            hs: int | None = None):
    """Runs the per-pixel kernel `name` (sweep_gather, its instance for out's
    dtype, or the fp32 sweep_scatter) on CUDA tensors (contiguous; float4
    access, or 8 channels a thread in the bf16 gather, when C and every
    pointer allow it) on the current stream, each thread walking `planes`
    planes, the source map of `hs` rows (by default the samples' h); raises
    on a CUDA error."""
    if name == "sweep_scatter" and values.dtype != torch.float32:
        raise ValueError("sweep_scatter: the bf16 scatter launches through _launch_window")
    ptrs, aligned = _pointers(name, values, xs, ys, out)
    volume = out if name == "sweep_gather" else values
    if volume.dtype == torch.bfloat16:
        vec = volume_vec(c, aligned)
    else:
        vec = 4 if c % 4 == 0 and aligned else 1
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _c_fn(f"{name}_{_SUFFIX[volume.dtype]}", 7)(*ptrs, d, h, w, c, vec, planes,
                                                         h if hs is None else hs, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _launch_window(g, xs, ys, dsrc, plan: dict, hs: int):
    """Runs the bf16 scatter (g bf16 (D, H, W, C), dsrc (hs, W, C) fp32,
    zeroed by the caller) under `plan` (`scatter_window_plan`; planned
    again at one channel a thread when a pointer is not 16-byte aligned) on
    the current stream, counting blocks in `window_blocks`; raises on a CUDA
    error."""
    d, h, w, c = g.shape
    ptrs, aligned = _pointers("sweep_scatter", g, xs, ys, dsrc)
    if not aligned and plan["vec"] != 1:
        plan = scatter_window_plan(d, h, w, c, hs, vec=1, planes=plan["planes"],
                                   budget=plan["budget"])
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _c_fn("sweep_scatter_bf16", 12, 1)(
            *ptrs, d, h, w, c, hs, plan["vec"], plan["cg"], plan["ty"], plan["tx"], plan["planes"],
            plan["threads"], plan["budget"], window_blocks(g.device).data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sweep_scatter kernel launch failed: CUDA error {rc}")


def _count(fn, dtype: torch.dtype) -> None:
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def _gather(src: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    _check("sweep_gather", src, xs, ys)
    if src.ndim != 3 or src.shape[1] != xs.shape[2] or xs.shape[1] > src.shape[0]:
        raise ValueError(f"sweep_gather: want src (H, W, C) and xs/ys (D, H', W) with H' ≤ H, "
                         f"got {tuple(src.shape)} and {tuple(xs.shape)}")
    if src.device.type == "cpu":
        return sweep_gather_reference(src, xs, ys, out_dtype)
    d, h, w = xs.shape
    c = src.shape[-1]
    out = torch.empty((d, h, w, c), dtype=out_dtype, device=src.device)
    planes = GATHER_PLANES_BF16 if out_dtype == torch.bfloat16 else GATHER_PLANES
    _launch("sweep_gather", src, xs, ys, out, d, h, w, c, planes, src.shape[0])
    _count(sweep_gather, out_dtype)
    return out


def sweep_scatter(g: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                  height: int | None = None) -> torch.Tensor:
    """The transpose of `sweep_gather` at (xs, ys): g (D, H, W, C) float32
    or bfloat16 (widened exactly at the read), xs/ys (D, H, W) float32 → the
    source's cotangent (height, W, C) float32 (height: the source's rows, by
    default H; more when the samples are a band of them).  CUDA tensors go
    to the kernel (inputs contiguous; fp32: runs of planes summed in
    registers, then atomics; bf16: a block's samples sorted in a
    shared-memory window and each touched pixel summed in registers, then
    atomics; so the order of each element's sum changes from run to run),
    CPU tensors to `sweep_scatter_reference`."""
    _check("sweep_scatter", g, xs, ys, tuple(_SUFFIX))
    if g.ndim != 4 or tuple(g.shape[:3]) != tuple(xs.shape):
        raise ValueError(f"sweep_scatter: want g {tuple(xs.shape)} + (C,), got {tuple(g.shape)}")
    d, h, w, c = g.shape
    hs = h if height is None else height
    if hs < h:
        raise ValueError(f"sweep_scatter: a source of {hs} rows for samples of {h}")
    if g.device.type == "cpu":
        return sweep_scatter_reference(g, xs, ys, hs, w)
    dsrc = torch.zeros((hs, w, c), dtype=torch.float32, device=g.device)
    sms = _sms(g.device)
    if g.dtype == torch.bfloat16:
        _launch_window(g, xs, ys, dsrc, _window_plan(d, h, w, c, hs, sms), hs)
    else:
        groups = c // 4 if c % 4 == 0 else c
        _launch("sweep_scatter", g, xs, ys, dsrc, d, h, w, c,
                scatter_planes(d, h, w, groups, sms), hs)
    _count(sweep_scatter, g.dtype)
    return dsrc


class _SweepGather(torch.autograd.Function):
    """gather forward, scatter backward (its cotangent in the volume's dtype);
    the coordinates get no gradient."""

    @staticmethod
    def forward(ctx, src, xs, ys, out_dtype):
        ctx.save_for_backward(xs, ys)
        ctx.height = src.shape[0]
        return _gather(src, xs, ys, out_dtype)

    @staticmethod
    def backward(ctx, g):
        xs, ys = ctx.saved_tensors
        dsrc = (sweep_scatter(g.contiguous(), xs, ys, ctx.height) if ctx.needs_input_grad[0]
                else None)
        return dsrc, None, None, None


def sweep_gather(src: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    """Bilinear samples of one source view at the plane-sweep coordinates.

    src (H, W, C) float32, xs/ys (D, H', W) float32 on one device, H' = H
    or a band of H' ≤ H reference rows (height sharding) →
    (D, H', W, C) in out_dtype (None or torch.float32: fp32; torch.bfloat16:
    the fp32 sample rounded once to nearest even), zero outside the image;
    differentiable in src (backward: `sweep_scatter` of the cotangent, in
    the output's dtype), not in the coordinates.  CUDA tensors go to the
    kernel (inputs contiguous; each thread walks GATHER_PLANES planes, or
    GATHER_PLANES_BF16 for a bf16 volume), CPU tensors to
    `sweep_gather_reference`.
    """
    return _SweepGather.apply(src, xs, ys, _volume_dtype(out_dtype))


sweep_gather.launches = sweep_gather.launches_bf16 = 0
sweep_scatter.launches = sweep_scatter.launches_bf16 = 0
