"""Plane convolutions of the RED regularizer: CUDA kernels, their backwards
and their plain versions.

Replace the TPU kernels of `satmvs_tpu/ops/pallas/plane_conv.py`:

  conv_dn    stride-2 3×3 conv, pad 1, no bias, ReLU    (`_conv_dn_impl`, :382;
             backward `_conv_dn_bwd`, :424)
  deconv_up  ConvTranspose2d(k=3, s=2, p=1, op=1), no bias, ReLU, then an
             optional skip add                          (`_deconv_up_impl`, :569;
             backward `_deconv_up_bwd`, :610)
  conv_head  stride-1 3×3 conv, pad 1, with bias        (`_conv_head_impl`, :730;
             backward `_conv_head_bwd`, :768)

The RED regularizer runs them as written.  The packed CostRegNet
(`nn/costreg.py`) runs them in their CostRegNet forms, forward only as in
JAX: conv_dn and deconv_up with relu=False (no skip), and conv_head with up
to 64 output channels and a zero bias.  relu=False refuses a graph.

Activations are channels-last (N, H, W, C) float32, as in the JAX NHWC forms;
weights are the port's `nn.Conv2d` / `nn.ConvTranspose2d` parameters in torch
layout, and the backwards hand their cotangents back in that layout.  The
CUDA source is `satmvs_tpu_torch/csrc/plane_conv.cu`; its header gives the
design and the bound.

Each of `conv_dn`, `deconv_up` and `conv_head` is one `torch.autograd.Function`:
its forward launches the forward kernel for CUDA tensors and counts the launch
in `<wrapper>.launches`; its backward calls `<wrapper>_backward`, which
launches the backward kernels and counts in `<wrapper>_backward.launches`.
For CPU tensors, and only for them, both compute the plain versions
(`<name>_reference`, `<name>_backward_reference`: functional convolutions).
Every weight and bias cotangent on the card, these three and red_recur's,
is `wgrad3x3` (plain version `wgrad3x3_reference`), launched with the plan
of `wgrad3x3_plan` and counted in `wgrad3x3.launches`.  The forwards and
every dx run on two kernels, `conv3x3_f32` and `deconv3x3_s2_f32`, under
the launch plan of `plane_conv_plan` (tile, slab, threads, chunks, shared
memory); every plan gives the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.nn.grad import conv2d_weight

from . import build


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def conv_dn_reference(x: torch.Tensor, weight: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """relu(conv2d(x, weight, stride 2, pad 1)), without the ReLU when relu is
    False: (N, H, W, Cin) → (N, ⌈H/2⌉, ⌈W/2⌉, Cout)."""
    y = F.conv2d(_nchw(x), weight, stride=2, padding=1)
    return _nhwc(F.relu(y) if relu else y)


def conv_dn_backward_reference(x: torch.Tensor, weight: torch.Tensor, y: torch.Tensor,
                               g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cotangents (dx, dweight) of `conv_dn_reference` at x (even H, W) from
    its output y and the output's cotangent g: dz = g·[y > 0], dx the
    transposed stride-2 conv of dz, dweight Σ x-patches ⊗ dz."""
    dz = _nchw(torch.where(y > 0, g, torch.zeros_like(g)))
    dx = F.conv_transpose2d(dz, weight, stride=2, padding=1, output_padding=1)
    return _nhwc(dx), conv2d_weight(_nchw(x), weight.shape, dz, stride=2, padding=1)


def deconv_up_reference(x: torch.Tensor, weight: torch.Tensor,
                        skip: torch.Tensor | None = None, relu: bool = True) -> torch.Tensor:
    """relu(conv_transpose2d(x, weight, stride 2, pad 1, output pad 1)) + skip,
    without the ReLU when relu is False: (N, H, W, Cin) → (N, 2H, 2W, Cout);
    weight (Cin, Cout, 3, 3)."""
    y = F.conv_transpose2d(_nchw(x), weight, stride=2, padding=1, output_padding=1)
    y = _nhwc(F.relu(y) if relu else y)
    return y if skip is None else y + skip


def deconv_up_backward_reference(x: torch.Tensor, weight: torch.Tensor, act: torch.Tensor,
                                 g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cotangents (dx, dweight) of `deconv_up_reference` at x from act =
    relu(z), the output before the skip add, and the output's cotangent g
    (the skip's cotangent is g itself): dz = g·[act > 0], dx the stride-2
    conv of dz, dweight Σ x ⊗ dz-patches."""
    dz = _nchw(torch.where(act > 0, g, torch.zeros_like(g)))
    dx = F.conv2d(dz, weight, stride=2, padding=1)
    return _nhwc(dx), conv2d_weight(dz, weight.shape, _nchw(x), stride=2, padding=1)


def conv_head_reference(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """conv2d(x, weight, bias, pad 1): (N, H, W, Cin) → (N, H, W, Cout)."""
    return _nhwc(F.conv2d(_nchw(x), weight, bias, padding=1))


def conv_head_backward_reference(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cotangents (dx, dweight, dbias) of `conv_head_reference` at x from the
    output's cotangent g."""
    gn = _nchw(g)
    dx = F.conv_transpose2d(gn, weight, padding=1)
    return _nhwc(dx), conv2d_weight(_nchw(x), weight.shape, gn, padding=1), g.sum((0, 1, 2))


@functools.lru_cache(maxsize=None)
def _c_fn(name: str, n_ptrs: int, n_ints: int, stream: bool = True):
    """The C function `name` of plane_conv.cu: n_ptrs pointers, n_ints ints,
    then the stream when `stream`."""
    fn = getattr(build.load("plane_conv"), name)
    # pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p] * stream)
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, x: torch.Tensor, tensors: dict, cin: int):
    for key, t in {"x": x, **tensors}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: {key} is on {t.device}, x on {x.device}")
    if x.ndim != 4 or x.shape[-1] != cin:
        raise ValueError(f"{name}: want x (N, H, W, {cin}), got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _launch(name: str, fn, device: torch.device, *args):
    """Launches on the current stream of `device`; tensors go as pointers,
    None as a null pointer; raises on a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else 0 if a is None else a
                for a in args]
        rc = fn(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _contiguous(name: str, **tensors):
    for key, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


# The forward kernels' geometry (csrc/plane_conv.cu conv3x3_kernel,
# deconv3x3_s2_kernel): a thread owns CONV_ROWS output rows of one column (a
# conv) or QUAD_ROWS input rows of one column and their output quads (the
# transposed conv), × co_t channels; a block owns a tile of tx columns ×
# tile_rows rows and a slab of at most PLANE_MAX_SLAB channels.
CONV_ROWS = 4
QUAD_ROWS = 2
PLANE_MAX_SLAB = 64
PLANE_MAX_THREADS = 256
PLANE_REGS = 128             # registers a thread at most: __launch_bounds__(256, 2)
PLANE_MAX_SMEM = 232448      # bytes of shared memory a block may use on sm_90
PLANE_SM_SMEM = 233472       # bytes of shared memory an SM holds; a block also reserves 1 KB
# The cost model, in cycles of one SM, fitted to `kernel_ab.py --sweep` on
# an H100 (the option it picks against the fastest measured, over the 42
# calls of a train step): a block's FMAs at 128 a cycle or its shared-memory
# wavefronts at two a cycle, whichever is more, plus its staged input words
# at 20 a cycle, its weights at 16 and its stores at 10; a round of resident
# blocks shares the SM.  Options that keep PLANE_WARPS warps resident on an
# SM come first (plans with half as many measured 2-7× slower)
PLANE_LDS_PER_CYCLE = 2.0
PLANE_IN_WORDS_PER_CYCLE = 20.0
PLANE_W_WORDS_PER_CYCLE = 16.0
PLANE_OUT_WORDS_PER_CYCLE = 10.0
PLANE_WARPS = 16


def plane_conv_smem(transposed: bool, stride: int, gate: bool, rows: int, tx: int, ck: int,
                    co_s: int) -> int:
    """Shared bytes of a launch (plane_conv.cu `smem_bytes`): the staged input
    window of ck channels (twice with a gate), rounded up to whole float4,
    then the slab's weights of one chunk."""
    wr = rows + 1 if transposed else stride * (rows - 1) + 3
    wc = tx + 1 if transposed else stride * (tx - 1) + 3
    words = -(-ck * wr * wc // 4) * 4
    return 4 * (words * (2 if gate else 1) + 9 * ck * co_s)


def plane_conv_plan_options(stride: int, transposed: bool, cin: int, cout: int,
                            gate: bool = False):
    """Every launch the kernels take for these channels: vec 4 where Cin % 4
    == 0 (else 1), co_t 8 (1 for Cout = 1, so nothing is padded), slabs of
    the output rounded up to co_t (at most 64) and its halves and quarters,
    tx of 8, 16 or 32 with a warp inside one thread row, thread rows ty to
    fill up to 256 or 128 threads in whole warps (a slab of 3 or 6 groups
    of co_t channels takes fewer rows), chunks of the whole input or 32,
    16, 8 or 4 channels, within the shared memory that lets two blocks
    share an SM."""
    vec = 4 if cin % 4 == 0 else 1
    co_t = 1 if cout == 1 else 8
    full = min(PLANE_MAX_SLAB, -(-cout // co_t) * co_t)
    cin_v = -(-cin // vec) * vec
    per_thread = QUAD_ROWS if transposed else CONV_ROWS
    for co_s in sorted({full, full // 2, full // 4}, reverse=True):
        if co_s < co_t or co_s % co_t:
            continue
        lcn = co_s // co_t
        for tx in (32, 16, 8):
            if lcn * tx < 32 or lcn * tx > PLANE_MAX_THREADS:
                continue
            whole = 32 // math.gcd(lcn * tx, 32)  # thread rows that make whole warps
            for ty in sorted({cap // (lcn * tx) // whole * whole
                              for cap in (PLANE_MAX_THREADS, 128)} - {0}, reverse=True):
                threads = lcn * tx * ty
                chunks = {c for c in (cin_v, 32, 16, 8, 4) if c <= cin_v and c % vec == 0}
                for ck in sorted(chunks, reverse=True):
                    smem = plane_conv_smem(transposed, stride, gate, ty * per_thread, tx, ck,
                                           co_s)
                    if smem <= PLANE_SM_SMEM // 2 - 1024:
                        yield {"vec": vec, "co_t": co_t, "slab": co_s, "tx": tx, "ty": ty,
                               "threads": threads, "tile_rows": ty * per_thread, "ck": ck,
                               "smem": smem}


def _plane_resident(o: dict) -> int:
    """Blocks of a plan an SM holds: by threads, shared memory and registers."""
    return min(2048 // o["threads"], 32, PLANE_SM_SMEM // (o["smem"] + 1024),
               65536 // (o["threads"] * PLANE_REGS))


def _plane_cost(o: dict, transposed: bool, stride: int, n: int, rows_in: int, cols_in: int,
                cin: int, cout: int, gate: bool, sms: int) -> tuple:
    """The cost model's cycles of a launch (PLANE_* constants), then fewer
    threads a block on a tie."""
    vec, co_t, co_s, tx, threads = o["vec"], o["co_t"], o["slab"], o["tx"], o["threads"]
    rows = o["tile_rows"]
    lcn = co_s // co_t
    blocks = n * -(-rows_in // rows) * -(-cols_in // tx) * -(-cout // co_s)
    per_sm = _plane_resident(o)
    cin_v = -(-cin // vec) * vec
    wf_in = max(1, 32 // lcn * vec * 4 // 128)  # wavefronts of a warp's read of staged input
    w_loads = 2 if co_t == 8 else 1
    loads = (6 * wf_in + 9 * vec * w_loads if transposed
             else 9 * (CONV_ROWS * wf_in + vec * w_loads))
    wr = rows + 1 if transposed else stride * (rows - 1) + 3
    wc = tx + 1 if transposed else stride * (tx - 1) + 3
    block = (max(rows * tx * co_s * 9 * cin_v / 128,
                 threads // 32 * (cin_v // vec) * loads / PLANE_LDS_PER_CYCLE)
             + cin_v * wr * wc * (2 if gate else 1) / PLANE_IN_WORDS_PER_CYCLE
             + 9 * cin_v * co_s / PLANE_W_WORDS_PER_CYCLE
             + rows * tx * co_s * (4 if transposed else 1) / PLANE_OUT_WORDS_PER_CYCLE)
    return -(-blocks // (sms * per_sm)) * per_sm * block, threads


@functools.lru_cache(maxsize=1024)
def plane_conv_plan(stride: int, transposed: bool, n: int, h: int, w: int, cin: int, cout: int,
                    gate: bool = False, sms: int = 132) -> dict:
    """The launch of `conv3x3_f32` (transposed=False: stride 1 or 2, input
    (n, h, w, cin) → ⌈h/stride⌉ × ⌈w/stride⌉ outputs) or `deconv3x3_s2_f32`
    (transposed=True: stride 2, input (n, h, w, cin) → 2h × 2w) with cout
    output channels, gated or not, on a card with `sms` SMs: the option of
    `plane_conv_plan_options` of least modelled cost.  Returns vec, co_t,
    slab, tx, ty, threads, tile_rows, ck, smem and the grid (tiles, slabs,
    n).  Pure Python, cached (do not modify what it returns); raises
    ValueError for a shape the kernels cannot take."""
    if transposed and stride != 2 or stride not in (1, 2):
        raise ValueError(f"plane conv: stride {stride} (transposed: {transposed}) is not "
                         f"1 or 2 for a conv, 2 for a transposed conv")
    if min(n, h, w, cin, cout) < 1:
        raise ValueError(f"plane conv: empty operand ({n}, {h}, {w}, {cin}) → {cout}")
    if n > 65535:
        raise ValueError(f"plane conv: {n} images exceed the grid's 65535")
    rows_in, cols_in = (h, w) if transposed else ((h - 1) // stride + 1, (w - 1) // stride + 1)
    options = list(plane_conv_plan_options(stride, transposed, cin, cout, gate))
    if not options:
        raise ValueError(f"plane conv: no tile of {cin} → {cout} channels fits two blocks an SM")
    full = [o for o in options if _plane_resident(o) * o["threads"] >= 32 * PLANE_WARPS]
    o = min(full or options, key=lambda o: _plane_cost(o, transposed, stride, n, rows_in,
                                                       cols_in, cin, cout, gate, sms))
    tiles = -(-rows_in // o["tile_rows"]) * -(-cols_in // o["tx"])
    slabs = -(-cout // o["slab"])
    if tiles >= 2 ** 31 or slabs > 65535:
        raise ValueError(f"plane conv: a grid of {tiles} tiles × {slabs} slabs is too large")
    return {**o, "grid": (tiles, slabs, n)}


@functools.lru_cache(maxsize=16)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_prepared: dict = {}  # (device, kernel instance) → the shared bytes it may use


def _plan_args(name: str, transposed: bool, stride: int, x, gate, cout: int, plan: dict | None):
    """The plan's ints for the C entry (vec, co_t, co_s, tx, ty, ck, smem):
    `plane_conv_plan`'s unless `plan` is given, vec 1 where x or the gate is
    not 16-byte aligned; the instance is let use the plan's shared memory
    once per device and size."""
    n, h, w, cin = x.shape
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if plan is None:
        plan = plane_conv_plan(stride, transposed, n, h, w, cin, cout, gate is not None,
                               _sms(dev))
    aligned = all(t is None or t.data_ptr() % 16 == 0 for t in (x, gate))
    vec = plan["vec"] if aligned else 1
    key = (dev, transposed, stride, vec, gate is not None, plan["co_t"])
    if _prepared.get(key, -1) < plan["smem"]:
        with torch.cuda.device(x.device):
            rc = _c_fn("plane_conv_prepare", 0, 6, False)(int(transposed), stride, vec,
                                                          int(gate is not None), plan["co_t"],
                                                          plan["smem"])
        if rc != 0:
            raise RuntimeError(f"{name}: setting {plan['smem']} bytes of shared memory failed: "
                               f"CUDA error {rc}")
        _prepared[key] = plan["smem"]
    return (vec, plan["co_t"], plan["slab"], plan["tx"], plan["ty"], plan["ck"], plan["smem"])


def _conv3x3(name: str, x, gate, w_k, bias, stride: int, relu: bool,
             plan: dict | None = None) -> torch.Tensor:
    """conv3x3_f32 on x (N, H, W, Cin) with weights w_k (3, 3, Cin, Cout);
    `plan` replaces `plane_conv_plan`'s (to time other plans)."""
    n, h, w, cin = x.shape
    cout = w_k.shape[3]
    _contiguous(name, x=x, gate=gate)
    out = torch.empty((n, (h - 1) // stride + 1, (w - 1) // stride + 1, cout),
                      dtype=torch.float32, device=x.device)
    args = _plan_args(name, False, stride, x, gate, cout, plan)
    _launch(name, _c_fn("conv3x3_f32", 5, 14), x.device, x, gate, w_k.contiguous(), bias, out,
            n, h, w, cin, cout, stride, int(relu), *args)
    return out


def _deconv3x3(name: str, x, gate, w_k, skip, act, relu: bool,
               plan: dict | None = None) -> torch.Tensor:
    """deconv3x3_s2_f32 on x (N, H, W, Cin) with weights w_k (3, 3, Cin, Cout);
    `plan` replaces `plane_conv_plan`'s (to time other plans)."""
    n, h, w, cin = x.shape
    cout = w_k.shape[3]
    _contiguous(name, x=x, gate=gate, skip=skip)
    out = torch.empty((n, 2 * h, 2 * w, cout), dtype=torch.float32, device=x.device)
    args = _plan_args(name, True, 2, x, gate, cout, plan)
    _launch(name, _c_fn("deconv3x3_s2_f32", 6, 13), x.device, x, gate, w_k.contiguous(), skip,
            out, act, n, h, w, cin, cout, int(relu), *args)
    return out


def wgrad3x3_reference(a1: torch.Tensor, b: torch.Tensor, stride: int,
                       a2: torch.Tensor | None = None, amask: torch.Tensor | None = None,
                       bmask: torch.Tensor | None = None, bias: bool = False):
    """Plain version of `wgrad3x3`, in the inputs' dtype: the im2col of A'
    (`F.unfold`) contracted with B' over the pixels.  Returns dw (3, 3, CA,
    CB) and, with bias, db (CB,) = Σ B', else None."""
    a = a1 if amask is None else torch.where(amask > 0, a1, torch.zeros_like(a1))
    if a2 is not None:
        a = torch.cat([a, a2], dim=-1)
    bb = b if bmask is None else torch.where(bmask > 0, b, torch.zeros_like(b))
    n, hb, wb, cb = bb.shape
    ca = a.shape[-1]
    cols = F.unfold(_nchw(a), 3, padding=1, stride=stride)  # (N, CA·9, L), (ca, dy, dx)
    if cols.shape[-1] != hb * wb:
        raise ValueError(f"wgrad3x3_reference: A {tuple(a.shape)} at stride {stride} does not "
                         f"give B's {hb}×{wb} pixels")
    dw = torch.einsum("nkl,nlb->kb", cols, bb.reshape(n, hb * wb, cb))
    dw = dw.reshape(ca, 3, 3, cb).permute(1, 2, 0, 3)
    return dw, (bb.sum((0, 1, 2)) if bias else None)


WGRAD_THREADS = 192          # threads a block is planned with at most: two blocks an SM
                             # at WGRAD_REGS (plane_conv.cu takes up to 256)
WGRAD_TILE = 3 * 4 * 4       # fp32 sums a thread holds: dx × 4 ca × 4 cb
WGRAD_RUN = 1024             # pixels of one fp32 run before it goes into float64
WGRAD_MAX_SMEM = 232448      # bytes of shared memory a block may use on sm_90
WGRAD_REGS = 152             # registers a thread is planned with: the build's -Xptxas -v
                             # says 139-145, allocated in steps of 8


def _tile_channels(c: int) -> int:
    """Channels of one output tile: c split into the fewest tiles of ≤ 32,
    balanced, rounded up to a multiple of 4."""
    per = -(-c // -(-c // 32))
    return -(-per // 4) * 4


def wgrad3x3_plan(n: int, hb: int, wb: int, ca: int, cb: int, stride: int,
                  sms: int = 132) -> dict:
    """The launch of `wgrad3x3_f32` for B (n, hb, wb, cb) and A with ca
    channels at `stride`, on a card with `sms` SMs: pixel tiles of `tp`
    pixels of one row (the width among 64, 32, 24, 16 that pads a row
    least), output tiles of ca_t × cb_t channels, `lanes` pixel lanes per
    block to fill up to WGRAD_THREADS threads, gx pixel ranges so the grid
    is at most one wave of resident blocks, fp32 runs of `run` tiles.  Pure
    Python; raises ValueError for a shape the kernel cannot take."""
    if stride not in (1, 2):
        raise ValueError(f"wgrad3x3: stride must be 1 or 2, got {stride}")
    if min(n, hb, wb, ca, cb) < 1:
        raise ValueError(f"wgrad3x3: empty operand ({n}, {hb}, {wb}), ca {ca}, cb {cb}")
    ca_t, cb_t = _tile_channels(ca), _tile_channels(cb)
    base = 3 * (ca_t // 4) * (cb_t // 4)
    tp = min((64, 32, 24, 16), key=lambda t: (-(-wb // t) * t, -t))
    lanes = 1
    while 2 * lanes * base <= WGRAD_THREADS and 2 * lanes <= tp:
        lanes *= 2
    threads = lanes * base
    smem = 16 * (3 * (stride * tp + 2) * (ca_t // 4) + tp * (cb_t // 4))
    gy = -(-ca // ca_t) * -(-cb // cb_t)
    tiles = n * hb * -(-wb // tp)
    n_out = 9 * ca * cb + cb
    if threads > WGRAD_THREADS or smem > WGRAD_MAX_SMEM or gy > 65535 or n_out >= 2 ** 31:
        raise ValueError(f"wgrad3x3: no launch for ca {ca}, cb {cb}, stride {stride}")
    per_sm = max(1, min(2048 // threads, WGRAD_MAX_SMEM // smem,
                        65536 // (threads * WGRAD_REGS)))
    # at most one wave: a part-full second wave would cost as long as the first
    gx = max(1, min(tiles, sms * per_sm // gy))
    tpb = -(-tiles // gx)
    gx = -(-tiles // tpb)  # no block without tiles
    if gx * lanes * n_out >= 2 ** 31:
        raise ValueError(f"wgrad3x3: partials of {gx * lanes} × {n_out} do not fit")
    return {"tp": tp, "ca_t": ca_t, "cb_t": cb_t, "lanes": lanes, "threads": threads,
            "smem": smem, "gx": gx, "gy": gy, "tiles": tiles, "tiles_per_block": tpb,
            "run": max(1, WGRAD_RUN * lanes // tp)}


def wgrad3x3(name: str, a1: torch.Tensor, b: torch.Tensor, stride: int,
             a2: torch.Tensor | None = None, amask: torch.Tensor | None = None,
             bmask: torch.Tensor | None = None, bias: bool = False):
    """The weight (and bias) cotangent kernel on CUDA tensors (plane_conv.cu
    `wgrad3x3_f32`, deterministic; plain version `wgrad3x3_reference`):

      dw[dy, dx, ca, cb] = Σ A'[n, s·y + dy − 1, s·x + dx − 1, ca] · B'[n, y, x, cb]

    A = [a1 | a2] (N, Ha, Wa, CA) along channels, B = b (N, Hb, Wb, CB),
    A' = a1·[amask > 0] (amask only without a2), B' = b·[bmask > 0].
    Returns dw (3, 3, CA, CB) and, with bias, db (CB,) = Σ B', else None.
    Counts its launches in `wgrad3x3.launches`; `name` is the caller, for
    errors."""
    if b.device.type != "cuda":
        raise ValueError(f"{name}: wgrad3x3 takes CUDA tensors, got {b.device}")
    n, ha, wa, ca1 = a1.shape
    ca2 = 0 if a2 is None else a2.shape[-1]
    _, hb, wb, cb = b.shape
    _contiguous(name, a1=a1, a2=a2, amask=amask, b=b, bmask=bmask)
    n_w = 9 * (ca1 + ca2) * cb
    n_out = n_w + (cb if bias else 0)
    plan = wgrad3x3_plan(n, hb, wb, ca1 + ca2, cb, stride,
                         torch.cuda.get_device_properties(b.device).multi_processor_count)
    part = torch.empty((plan["gx"] * plan["lanes"], n_out), dtype=torch.float64, device=b.device)
    out = torch.empty((n_out,), dtype=torch.float32, device=b.device)
    _launch(name, _c_fn("wgrad3x3_f32", 7, 16), b.device, a1, a2, amask, b, bmask, part, out,
            n, ha, wa, ca1, ca2, hb, wb, cb, stride, int(bias), plan["tp"], plan["ca_t"],
            plan["cb_t"], plan["lanes"], plan["gx"], plan["run"])
    wgrad3x3.launches += 1
    return out[:n_w].reshape(3, 3, ca1 + ca2, cb), (out[n_w:] if bias else None)


def torch_weight(dw: torch.Tensor) -> torch.Tensor:
    """(3, 3, A, B) → (B, A, 3, 3): a Conv2d weight from (3, 3, I, O), a
    ConvTranspose2d weight from (3, 3, O, I)."""
    return dw.permute(3, 2, 0, 1).contiguous()


def conv_dn_backward(x: torch.Tensor, weight: torch.Tensor, y: torch.Tensor,
                     g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dweight) of `conv_dn` at x (N, H, W, Cin), even H and W, from its
    output y and the output's cotangent g (N, H/2, W/2, Cout).  CUDA tensors
    go to the kernels (a gated transposed conv and the weight reduction),
    counted in `conv_dn_backward.launches`; CPU tensors to
    `conv_dn_backward_reference`."""
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"conv_dn backward: H and W must be even, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return conv_dn_backward_reference(x, weight, y, g)
    _contiguous("conv_dn backward", y=y, g=g)
    dx = _deconv3x3("conv_dn backward", g, y, weight.detach().permute(2, 3, 0, 1), None, None,
                    False)
    dw, _ = wgrad3x3("conv_dn backward", x, g, 2, bmask=y)
    conv_dn_backward.launches += 1
    return dx, torch_weight(dw)


def deconv_up_backward(x: torch.Tensor, weight: torch.Tensor, act: torch.Tensor,
                       g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dweight) of `deconv_up` at x (N, H, W, Cin) from act = relu(z)
    (the output before the skip add) and the output's cotangent g
    (N, 2H, 2W, Cout).  CUDA tensors go to the kernels (a gated stride-2
    conv and the weight reduction), counted in `deconv_up_backward.launches`;
    CPU tensors to `deconv_up_backward_reference`."""
    if x.device.type == "cpu":
        return deconv_up_backward_reference(x, weight, act, g)
    _contiguous("deconv_up backward", act=act, g=g)
    dx = _conv3x3("deconv_up backward", g, act, weight.detach().permute(2, 3, 1, 0), None, 2,
                  False)
    dw, _ = wgrad3x3("deconv_up backward", g, x, 2, amask=act)  # (3, 3, Cout, Cin)
    deconv_up_backward.launches += 1
    return dx, torch_weight(dw)  # (Cin, Cout, 3, 3), ConvTranspose2d's layout


def conv_head_backward(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dweight, dbias) of `conv_head` at x (N, H, W, Cin) from the
    output's cotangent g (N, H, W, Cout).  CUDA tensors go to the kernels
    (the conv with the flipped, channel-transposed kernel and the weight and
    bias reduction), counted in `conv_head_backward.launches`; CPU tensors to
    `conv_head_backward_reference`."""
    if x.device.type == "cpu":
        return conv_head_backward_reference(x, weight, g)
    _contiguous("conv_head backward", g=g)
    w_t = weight.detach().flip(2, 3).permute(2, 3, 0, 1)  # (3, 3, Cout, Cin)
    dx = _conv3x3("conv_head backward", g, None, w_t, None, 1, False)
    dw, db = wgrad3x3("conv_head backward", x, g, 1, bias=True)
    conv_head_backward.launches += 1
    return dx, torch_weight(dw), db


class _ConvDn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, relu):
        if x.device.type == "cpu":
            y = conv_dn_reference(x, weight, relu)
        else:
            y = _conv3x3("conv_dn", x, None, weight.detach().permute(2, 3, 1, 0), None, 2, relu)
            conv_dn.launches += 1
        ctx.save_for_backward(x, weight, y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight, y = ctx.saved_tensors
        dx, dw = conv_dn_backward(x, weight, y, g.contiguous())
        return dx, dw, None


class _DeconvUp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, skip, keep_act, relu):
        if x.device.type == "cpu":
            act = deconv_up_reference(x, weight, relu=relu)
            out = act if skip is None else act + skip
        else:
            # relu(z) in a buffer of its own only when a backward will read it
            act = None if skip is None or not keep_act else torch.empty_like(skip)
            out = _deconv3x3("deconv_up", x, None, weight.detach().permute(2, 3, 0, 1), skip,
                             act, relu)
            act = out if act is None else act
            deconv_up.launches += 1
        if keep_act:
            ctx.save_for_backward(x, weight, act)
        ctx.has_skip = skip is not None
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight, act = ctx.saved_tensors
        g = g.contiguous()
        dx, dw = deconv_up_backward(x, weight, act, g)
        return dx, dw, (g if ctx.has_skip else None), None, None


class _ConvHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        if x.device.type == "cpu":
            out = conv_head_reference(x, weight, bias)
        else:
            out = _conv3x3("conv_head", x, None, weight.detach().permute(2, 3, 1, 0),
                           bias.detach().contiguous(), 1, False)
            conv_head.launches += 1
        ctx.save_for_backward(x, weight)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        return conv_head_backward(x, weight, g.contiguous())


def _forward_only(name: str, relu: bool, *tensors):
    if not relu and _wants_grad(*tensors):
        raise ValueError(f"{name}: relu=False (the packed CostRegNet's form) is forward-only, "
                         f"as in JAX; it takes no tensor that requires a gradient")


def conv_dn(x: torch.Tensor, weight: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """Stride-2 3×3 conv, pad 1, no bias, ReLU (the RED encoder's ConvBlock);
    relu=False leaves the ReLU out (the packed CostRegNet's stride-2 taps).

    x (N, H, W, Cin) float32, weight (Cout, Cin, 3, 3) → (N, ⌈H/2⌉, ⌈W/2⌉, Cout).
    CUDA tensors go to the kernel (x must be contiguous), CPU tensors to
    `conv_dn_reference`.  With the ReLU, differentiable in x and weight
    (backward `conv_dn_backward`) where H and W are even; with odd H or W,
    or without the ReLU, it raises where autograd would record a graph."""
    if weight.ndim != 4 or weight.shape[2:] != (3, 3):
        raise ValueError(f"conv_dn: want weight (Cout, Cin, 3, 3), got {tuple(weight.shape)}")
    _check("conv_dn", x, {"weight": weight}, weight.shape[1])
    _forward_only("conv_dn", relu, x, weight)
    if _wants_grad(x, weight) and (x.shape[1] % 2 or x.shape[2] % 2):
        raise ValueError(f"conv_dn: the backward takes even H and W, got {tuple(x.shape)}")
    return _ConvDn.apply(x, weight, relu)


def conv_head(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Stride-1 3×3 conv, pad 1, with bias, no activation (the RED logit head,
    and with up to 64 output channels and a zero bias the packed CostRegNet's
    stride-1 taps).

    x (N, H, W, Cin) float32, weight (Cout, Cin, 3, 3), bias (Cout,) → (N, H, W, Cout).
    CUDA tensors go to the kernel (x must be contiguous), CPU tensors to
    `conv_head_reference`.  Differentiable in x, weight and bias (backward
    `conv_head_backward`)."""
    if weight.ndim != 4 or weight.shape[2:] != (3, 3):
        raise ValueError(f"conv_head: want weight (Cout, Cin, 3, 3), got {tuple(weight.shape)}")
    if bias.shape != (weight.shape[0],):
        raise ValueError(f"conv_head: bias {tuple(bias.shape)} != ({weight.shape[0]},)")
    _check("conv_head", x, {"weight": weight, "bias": bias}, weight.shape[1])
    return _ConvHead.apply(x, weight, bias)


def deconv_up(x: torch.Tensor, weight: torch.Tensor,
              skip: torch.Tensor | None = None, relu: bool = True) -> torch.Tensor:
    """relu(ConvTranspose2d(k=3, s=2, p=1, op=1)(x)), plus `skip` after the ReLU
    when given (the RED decoder's DeconvBlock and its additive skip);
    relu=False leaves the ReLU out (the packed CostRegNet's depth taps).

    x (N, H, W, Cin) float32, weight (Cin, Cout, 3, 3), skip (N, 2H, 2W, Cout)
    → (N, 2H, 2W, Cout).  CUDA tensors go to the kernel (x and skip must be
    contiguous), CPU tensors to `deconv_up_reference`.  With the ReLU,
    differentiable in x, weight and skip (backward `deconv_up_backward`);
    when autograd records, the kernel also keeps relu(z) for the backward's
    mask.  Without the ReLU it raises where autograd would record a graph."""
    if weight.ndim != 4 or weight.shape[2:] != (3, 3):
        raise ValueError(f"deconv_up: want weight (Cin, Cout, 3, 3), got {tuple(weight.shape)}")
    extra = {"weight": weight} if skip is None else {"weight": weight, "skip": skip}
    _check("deconv_up", x, extra, weight.shape[0])
    n, h, w, _ = x.shape
    cout = weight.shape[1]
    if skip is not None and tuple(skip.shape) != (n, 2 * h, 2 * w, cout):
        raise ValueError(f"deconv_up: skip {tuple(skip.shape)} != {(n, 2 * h, 2 * w, cout)}")
    _forward_only("deconv_up", relu, x, weight, skip)
    # keep_act from the caller: inside the Function's forward grad mode is
    # off, and ctx.needs_input_grad says True for a parameter even under no_grad
    return _DeconvUp.apply(x, weight, skip, _wants_grad(x, weight, skip), relu)


conv_dn.launches = 0
deconv_up.launches = 0
conv_head.launches = 0
conv_dn_backward.launches = 0
deconv_up_backward.launches = 0
conv_head_backward.launches = 0
wgrad3x3.launches = 0
