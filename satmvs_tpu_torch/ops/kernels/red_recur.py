"""ConvGRU depth recurrence of one RED scale: CUDA kernels and their plain versions.

Replaces four TPU kernels of `satmvs_tpu/ops/pallas/red_recur.py`.  The
forward kernel: `_red_recur_impl` (pallas_call at :287; public `red_recur`
:1388 and the seeded `red_recur_from` :1429) and its batched form
`_red_recur_impl_batched` (pallas_call at :368; public
`red_recur_from_packed_batched` :1450).  The backward kernel: the
reverse-plane adjoint `_red_recur_bwd_pallas` (:755, pallas_call :802) and
its slab-streamed twin `_red_recur_bwd_pallas_stream` (:1197, pallas_call
:1246), whose split is a VMEM workaround; the dispatch is `_red_recur_bwd`
(:1471).  The CUDA source is `satmvs_tpu_torch/csrc/red_recur.cu`; its header
gives the design and the bound.

`red_recur(x, cell, h0)` runs a `nn.blocks.ConvGRUCell` over the D planes of
x, the state starting at h0 (zeros when None), and returns every plane's
state.  x may carry a leading batch axis B: then B independent recurrences,
each from its own start state, run in one launch.  It is one
`torch.autograd.Function`, differentiable in x and the cell's parameters
(as in JAX, not in h0): the forward launches the kernel for CUDA tensors and
counts each launch in `red_recur.launches`; the backward calls
`red_recur_backward`, which launches the adjoint kernel and the weight
reductions and counts in `red_recur_backward.launches`.  For CPU tensors,
and only for them, they compute the plain versions `red_recur_reference` (a
loop over the elements and the planes) and `red_recur_backward_reference` (a
reverse loop over the planes of the cell's local VJP).

Both kernels run under a launch plan computed here in Python
(`red_recur_bwd_plan`; the forward's `red_recur_plan` takes its first two
convs and its blocks, so the adjoint recomputes the forward's gates and
candidate in the same order).

The kernels take any state width 1 ≤ C ≤ 1024, as JAX's kernels and scan
do.  They move C in float4 groups, so a C that is not a multiple of 4
runs at C4 = 4⌈C/4⌉ (`padded_width`): the start state, the output's
cotangent and the weights are padded with zeros (`cell_kernel_args(cell,
C4)`), the kernels count H·W·C real values in each GroupNorm statistic,
and the outputs are cut back to C.  That costs, per call, a copy of the
(B, D, H, W, C) states out of the padded output in the forward; in the
backward a padded copy of the states and of their cotangent, and
weight reductions over C4 channels.  At C % 4 == 0 none of it runs.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ...nn.blocks import ConvGRUCell
from . import build
from .plane_conv import torch_weight, wgrad3x3


def _reference_one(x: torch.Tensor, cell: ConvGRUCell,
                   h0: torch.Tensor | None) -> torch.Tensor:
    xc = cell.x_contrib(x.permute(0, 3, 1, 2))  # (D, 3C, H, W)
    if h0 is None:
        h = x.new_zeros((1, cell.features, x.shape[1], x.shape[2]))
    else:
        h = h0.permute(2, 0, 1)[None]
    outs = []
    for i in range(x.shape[0]):
        h = cell.recur(xc[i:i + 1], h)
        outs.append(h)
    return torch.cat(outs).permute(0, 2, 3, 1).contiguous()


def red_recur_reference(x: torch.Tensor, cell: ConvGRUCell,
                        h0: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: per element, the cell's input convolution over
    all planes at once, then `cell.recur` plane by plane.  x (D, H, W, Cin),
    h0 (H, W, C) → (D, H, W, C); or x (B, D, H, W, Cin), h0 (B, H, W, C) →
    (B, D, H, W, C), each element from its own h0."""
    if x.ndim == 4:
        return _reference_one(x, cell, h0)
    return torch.stack([_reference_one(x[b], cell, None if h0 is None else h0[b])
                        for b in range(x.shape[0])])


def red_recur_backward_reference(x: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
                                 cell: ConvGRUCell, h0: torch.Tensor | None = None):
    """Plain backward of `red_recur` at x (B, D, H, W, Cin) from its output
    `out` and the output's cotangent g: a reverse loop over the planes that
    recomputes each step from the saved states (h_prev = out[d − 1], h0 or
    zeros at d = 0) and takes the local VJP of the cell's step, as the JAX
    fallback does (red_recur.py:1486-1504).  Returns dx and the cotangents of
    `cell.parameters()` in their order, summed over the elements."""
    names, params = zip(*cell.named_parameters())
    dps = [torch.zeros_like(p) for p in params]
    dx = torch.empty_like(x)
    nchw = lambda t: t.permute(2, 0, 1)[None]  # noqa: E731
    for b in range(x.shape[0]):
        dh = torch.zeros_like(nchw(out[b, 0]))
        for d in range(x.shape[1] - 1, -1, -1):
            hp = out[b, d - 1] if d > 0 else h0[b] if h0 is not None else torch.zeros_like(out[b, 0])
            with torch.enable_grad():
                hp_ = nchw(hp).detach().requires_grad_(True)
                x_ = nchw(x[b, d]).detach().requires_grad_(True)
                ps = [p.detach().requires_grad_(True) for p in params]
                hn = torch.func.functional_call(cell, dict(zip(names, ps)), (x_, hp_))
                grads = torch.autograd.grad(hn, (hp_, x_, *ps), dh + nchw(g[b, d]))
            dh = grads[0]
            dx[b, d] = grads[1][0].permute(1, 2, 0)
            for acc, gp in zip(dps, grads[2:]):
                acc += gp
    return dx, tuple(dps)


def padded_width(c: int) -> int:
    """The state width the kernels run a C-channel cell at: C rounded up to 4."""
    return -(-c // 4) * 4


def _pad_groups(t: torch.Tensor, c: int, c4: int) -> torch.Tensor:
    """t's last axis, groups of c channels, each zero-padded to c4."""
    if c4 == c:
        return t
    groups = t.reshape(*t.shape[:-1], -1, c)
    return F.pad(groups, (0, c4 - c)).reshape(*t.shape[:-1], -1).contiguous()


def _unpad_groups(t: torch.Tensor, c: int, c4: int) -> torch.Tensor:
    """`_pad_groups` undone: each group of c4 channels cut back to c."""
    if c4 == c:
        return t
    return t.reshape(*t.shape[:-1], -1, c4)[..., :c].reshape(*t.shape[:-1], -1)


def cell_kernel_args(cell: ConvGRUCell, width: int | None = None) -> tuple[torch.Tensor, ...]:
    """A ConvGRUCell's convs and norms as the kernel's arguments (wa, ba, wb, bb, gn):

      wa (9, Cin + C, 2C)  gates conv over [x | h]: conv_x's first 2C outputs and conv_h
      ba (2C,)             conv_h's bias
      wb (9, Cin + C, C)   candidate conv over [x | r·h]: conv_x's last C outputs and conv_c
      bb (C,)              conv_c's bias
      gn (6, C)            GroupNorm [r scale, r shift, u scale, u shift, y scale, y shift]

    width: run the cell at this many state channels (`padded_width`): every
    group of C channels above, inputs and outputs, is zero-padded to it.
    """
    c = cell.features
    c4 = c if width is None else width
    wx = cell.conv_x.weight.detach()  # (3C, Cin, 3, 3)

    def taps(w):  # (Cout, Cin', 3, 3) → (9, Cin', Cout)
        return w.permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0]).contiguous()

    def pad(w):  # the state's input rows, then each group of C outputs
        return _pad_groups(F.pad(w, (0, 0, 0, c4 - c)), c, c4)

    wa = pad(taps(torch.cat([wx[:2 * c], cell.conv_h.weight.detach()], dim=1)))
    wb = pad(taps(torch.cat([wx[2 * c:], cell.conv_c.weight.detach()], dim=1)))
    gn = torch.stack([t.detach() for norm in (cell.gn_r, cell.gn_u, cell.gn_y)
                      for t in (norm.weight, norm.bias)])
    return (wa, _pad_groups(cell.conv_h.bias.detach(), c, c4), wb,
            _pad_groups(cell.conv_c.bias.detach(), c, c4), _pad_groups(gn, c, c4))


def cell_backward_weights(wa: torch.Tensor, wb: torch.Tensor,
                          cin: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The transposed convolutions' weights of the backward kernel, taps
    flipped (t → 8 − t), input and output channels swapped:

      wcT (9, C, C)       [t, k, c] = wb[8 − t, Cin + c, k]: dm from dy_lin
      weT (9, 3C, ce)     from [dgr | dgu | dy_lin] to [dh | dx]:
                          [t, g, c] = wa[8 − t, Cin + c, g] for c < C and g < 2C, 0 for
                          g ≥ 2C; [t, g, C + i] = wa[8 − t, i, g] for g < 2C, then
                          wb[8 − t, i, g − 2C]; ce = C + Cin rounded up to 4, the rest 0
    """
    c = wb.shape[-1]
    flip = torch.arange(8, -1, -1, device=wa.device)
    wa_f, wb_f = wa[flip], wb[flip]
    wcT = wb_f[:, cin:].transpose(1, 2).contiguous()
    wh = torch.cat([wa_f[:, cin:].transpose(1, 2), wa.new_zeros((9, c, c))], dim=1)
    wx = torch.cat([wa_f[:, :cin], wb_f[:, :cin]], dim=2).transpose(1, 2)
    return wcT, F.pad(torch.cat([wh, wx], dim=2), (0, -(c + cin) % 4)).contiguous()


def _check(x: torch.Tensor, cell: ConvGRUCell, h0: torch.Tensor | None):
    if x.dtype != torch.float32:
        raise TypeError(f"red_recur: x must be float32, got {x.dtype}")
    cin, c = cell.conv_x.in_channels, cell.features
    if x.ndim not in (4, 5) or x.shape[-1] != cin:
        raise ValueError(f"red_recur: want x ([B,] D, H, W, {cin}), got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"red_recur: unsupported device {x.device}")
    if cell.conv_x.weight.device != x.device:
        raise ValueError(f"red_recur: cell is on {cell.conv_x.weight.device}, x on {x.device}")
    if h0 is not None:
        if h0.dtype != torch.float32 or h0.device != x.device:
            raise ValueError(f"red_recur: h0 must be float32 on {x.device}")
        want = (*x.shape[:-4], x.shape[-3], x.shape[-2], c)
        if tuple(h0.shape) != want:
            raise ValueError(f"red_recur: h0 {tuple(h0.shape)} != {want}")


def _lib() -> ctypes.CDLL:
    lib = build.load("red_recur")
    for name in ("red_recur_resident", "red_recur_smem", "red_recur_bwd_smem"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    # pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
    lib.red_recur_f32.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.POINTER(ctypes.c_int)]
                                  + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.red_recur_f32.restype = ctypes.c_int
    lib.red_recur_bwd_f32.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.POINTER(ctypes.c_int)]
                                      + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.red_recur_bwd_f32.restype = ctypes.c_int
    return lib


# Both kernels' geometry (csrc/red_recur.cu): blocks of 8 warps; a conv's
# work item is a tile of 32 columns × (wr·px) rows and a slab of wc·8 output
# channels, its raw operands (one a channel for the gates, two for the other
# convs) staged ck (8 to 64) input channels at a time with a one-pixel halo by
# cp.async, then mapped in shared memory.  The convs are the gates, the
# candidate (the forward's two), convᵀ Wc and convᵀ [Wh | Wx].
RED_BWD_THREADS = 256
_TW, _BCO, _RS = 32, 8, 34
_NRAW = (1, 2, 2, 2)  # raw operands a staged channel of each conv reads
_PLAN_KEYS = ("px", "wr", "wc", "wk", "ck")


def _staged_plane(tr: int, ck: int) -> int:
    """Words of one staged input channel of a tile of tr rows (≡ 32 / min(ck,
    32) mod 32)."""
    m = 32 // min(ck, 32)
    return ((tr + 2) * _RS - m + 31) // 32 * 32 + m


_IN_WORDS = 2 * 16 * _staged_plane(8, 16)
_W_WORDS = 9 * 16 * 8 * _BCO
RED_FWD_SMEM = 4 * (_IN_WORDS + _W_WORDS)
RED_BWD_SMEM = RED_FWD_SMEM + 4 * 24 * RED_BWD_THREADS
RED_BWD_MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
# The cost model, in instructions of one thread: mapping one staged element
# of each conv (m = σ(GN_r(g))·h; dy_lin; the gate cotangents), a chunk's
# fixed cost (the copies' latency, three barriers) and an item's (the
# epilogue); issuing a staged element's copies costs 4 + 8 a raw operand
_MAP_COST = (0, 50, 20, 25)
_CHUNK_COST, _ITEM_COST = 800, 300


def conv_plan_options(cout: int, nraw: int):
    """Every (px, wr, wc, wk, ck) the kernels run for a conv with cout
    outputs and nraw raw operands a staged channel: 8 warps, px 1 or 2, no
    slab wider than the output rounded up to 8, a chunk's raw operands and
    weights within their shared-memory buffers."""
    for px in (2, 1):
        for wc in (8, 4, 2, 1):
            if _BCO * wc > -(-cout // _BCO) * _BCO:
                continue
            for wk in (1, 2, 4, 8):
                if wc * wk > 8:
                    continue
                wr = 8 // (wc * wk)
                for ck in (64, 32, 16, 8):
                    if (nraw * ck * _staged_plane(wr * px, ck) <= _IN_WORDS
                            and 9 * ck * _BCO * wc <= _W_WORDS):
                        yield {"px": px, "wr": wr, "wc": wc, "wk": wk, "ck": ck}


def _conv_plan(h: int, w: int, cin: int, cout: int, cap: int, nraw: int, map_cost: int,
               order: tuple[int, int] | None = None) -> dict:
    """The least-cost (px, wr, wc, wk, ck) of one conv over an (h, w) plane
    with cin inputs of nraw raw operands each and cout outputs when `cap`
    blocks work on the element, with (wk, ck) = `order` when given: the
    rounds of items a block walks times an item's cost (per chunk the
    products and their shared loads, 3·(ck/wk)·(25·px + 8), the staging and
    a fixed cost); ties to more rows a thread, wider slabs and deeper
    chunks.  px is 1 or 2 (four rows a thread would spill registers), no
    slab is wider than the output rounded up to 8, no chunk deeper than the
    input, and a chunk's raw operands and weights fit their shared-memory
    buffers."""
    best = None
    for o in conv_plan_options(cout, nraw):
        px, wc, wk, ck = o["px"], o["wc"], o["wk"], o["ck"]
        if ck > -(-cin // 8) * 8 or (order is not None and order != (wk, ck)):
            continue
        tr = o["wr"] * px
        items = -(-h // tr) * -(-w // _TW) * -(-cout // (_BCO * wc))
        n_in = (tr + 2) * _RS * ck / RED_BWD_THREADS  # staged elements a thread
        chunk = (3 * (ck // wk) * (25 * px + 8)
                 + n_in * ((4 + 8 * nraw) + (map_cost if nraw > 1 else 0))
                 + 9 * ck * 2 * wc / RED_BWD_THREADS + _CHUNK_COST)
        item = -(-cin // ck) * chunk + _ITEM_COST + (16 * px * wk if wk > 1 else 0)
        key = (-(-items // cap) * item, -px, -wc, -ck, wk)
        if best is None or key < best[0]:
            best = (key, {**o, "tile_rows": tr, "slab": _BCO * wc, "items": items})
    return best[1]


@functools.lru_cache(maxsize=256)
def red_recur_bwd_plan(b: int, h: int, w: int, cin: int, c: int, resident: int) -> dict:
    """The backward kernel's launch for B elements of (h, w) planes, cin
    input and c state channels, on a card that holds `resident` of its blocks
    at once: per conv (the gates, the candidate, convᵀ Wc, convᵀ [Wh | Wx])
    its `_conv_plan`, and `blocks` = B · `per_element`, the most blocks any
    of the element's passes can use, at most resident // B.  An output's
    sum order depends on (wk, ck) alone, so each conv takes the (wk, ck) it
    would take with the card to itself and fits its tiles to the element's
    share: an element's results do not depend on the B it is batched with
    (the GroupNorm sums aside, float64 partials over other blocks).  Pure
    Python, cached (do not modify what it returns); raises ValueError for
    what the kernels cannot run.  A C that is not a multiple of 4 is
    planned at `padded_width(C)`, the width the kernels run it at."""
    if not 1 <= c <= 4 * RED_BWD_THREADS:
        raise ValueError(f"red_recur: the kernels take 1 ≤ C ≤ {4 * RED_BWD_THREADS}, "
                         f"got C = {c}")
    c = padded_width(c)  # the width the kernels run at
    if min(b, h, w, cin) < 1:
        raise ValueError(f"red_recur: empty operand B {b}, {h}×{w}, Cin {cin}")
    if h * w * (3 * c + cin) >= 2 ** 31:
        raise ValueError(f"red_recur: a {h}×{w} plane of {3 * c + cin} channels "
                         f"overflows 32-bit indices")
    if resident < b:
        raise ValueError(f"red_recur: no cooperative grid for B = {b} on a card "
                         f"that holds {resident} blocks")
    cap = resident // b
    shapes = ((cin + c, 2 * c), (cin + c, c), (c, c), (3 * c, c + cin))
    convs = []
    for (ci, co), nraw, cost in zip(shapes, _NRAW, _MAP_COST):
        alone = _conv_plan(h, w, ci, co, resident, nraw, cost)
        convs.append(_conv_plan(h, w, ci, co, cap, nraw, cost, (alone["wk"], alone["ck"])))
    own = -(-h * w // (RED_BWD_THREADS // (c // 4)))  # blocks the own-pixel passes fill
    per = min(cap, max(own, *(p["items"] for p in convs)))
    return {"blocks": b * per, "per_element": per, "convs": convs}


@functools.lru_cache(maxsize=256)
def red_recur_plan(b: int, h: int, w: int, cin: int, c: int, resident: int) -> dict:
    """The forward kernel's launch: the backward's plan (`red_recur_bwd_plan`,
    same arguments) for its first two convs, the gates and the candidate,
    and its blocks.  The adjoint's phases A and B then recompute the
    forward's r, u and y in the same order, over the same blocks.  Cached
    (do not modify what it returns); raises ValueError where the backward's
    plan does."""
    plan = red_recur_bwd_plan(b, h, w, cin, c, resident)
    return {"blocks": plan["blocks"], "per_element": plan["per_element"],
            "convs": plan["convs"][:2]}


def _plan_ints(plan: dict):
    """A plan's convs as the kernels' int array of (px, wr, wc, wk, ck)."""
    return (ctypes.c_int * (5 * len(plan["convs"])))(*(p[k] for p in plan["convs"]
                                                      for k in _PLAN_KEYS))


def _start_state(x: torch.Tensor, c: int, h0: torch.Tensor | None) -> torch.Tensor:
    """The kernels' start state (B, H, W, padded_width(C)): zeros for None."""
    b, _, h, w, _ = x.shape
    if h0 is None:
        return torch.zeros((b, h, w, padded_width(c)), dtype=torch.float32, device=x.device)
    if not h0.is_contiguous():
        raise ValueError("red_recur: h0 must be contiguous")
    h0 = _pad_groups(h0, c, padded_width(c))
    if h0.data_ptr() % 16:
        raise ValueError("red_recur: h0 must be 16-byte aligned")
    return h0


def _launch(x: torch.Tensor, cell: ConvGRUCell, h0: torch.Tensor | None,
            plan: dict | None = None) -> torch.Tensor:
    """The kernel on x (B, D, H, W, Cin) and h0 (B, H, W, C) or None, counted
    in `red_recur.launches`.  `plan` replaces `red_recur_plan`'s (to time
    other plans)."""
    b, d, h, w, cin = x.shape
    c = cell.features
    c4 = padded_width(c)
    if not x.is_contiguous():
        raise ValueError("red_recur: x must be contiguous")
    if plan is None:  # refuses C > 1024, 32-bit overflow and more elements than fit
        with torch.cuda.device(x.device):
            plan = red_recur_plan(b, h, w, cin, c, resident())
    h0 = _start_state(x, c, h0)
    lib = _lib()
    wa, ba, wb, bb, gn = (t.contiguous() for t in cell_kernel_args(cell, c4))
    new = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype,  # noqa: E731
                                                          device=x.device)
    out = new(b, d, h, w, c4)
    graw, yraw = new(b, h, w, 2 * c4), new(b, h, w, c4)
    part = new(2, plan["blocks"], 4, dtype=torch.float64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.red_recur_f32(*(t.data_ptr() for t in (x, h0, out, graw, yraw, part, wa, ba, wb,
                                                        bb, gn)),
                               _plan_ints(plan), b, d, h, w, cin, c4, c, plan["blocks"], stream)
    if rc != 0:
        raise RuntimeError(f"red_recur kernel launch failed: CUDA error {rc}")
    red_recur.launches += 1
    return out if c4 == c else out[..., :c].contiguous()


def _param_grads(cell: ConvGRUCell, dwa, dba, dwb, dbb, dgn) -> tuple[torch.Tensor, ...]:
    """The kernel-layout cotangents (at `padded_width(C)` channels) as those
    of `cell.parameters()`, in order."""
    cin, c = cell.conv_x.in_channels, cell.features
    c4 = padded_width(c)
    dwa, dba, dwb, dbb, dgn = (_unpad_groups(t, c, c4) for t in (dwa, dba, dwb, dbb, dgn))
    dwa, dwb = dwa[:, :, :cin + c], dwb[:, :, :cin + c]  # the state's pad rows
    dwx = torch_weight(torch.cat([dwa[:, :, :cin], dwb[:, :, :cin]], dim=3))
    grads = {"conv_x.weight": dwx, "conv_h.weight": torch_weight(dwa[:, :, cin:]),
             "conv_h.bias": dba, "conv_c.weight": torch_weight(dwb[:, :, cin:]),
             "conv_c.bias": dbb}
    for i, norm in enumerate(("gn_r", "gn_u", "gn_y")):
        grads[f"{norm}.weight"], grads[f"{norm}.bias"] = dgn[2 * i], dgn[2 * i + 1]
    return tuple(grads[name] for name, _ in cell.named_parameters())


@functools.lru_cache(maxsize=16)
def _resident(device: int) -> int:
    return _lib().red_recur_resident()


def resident() -> int:
    """Blocks of the forward and of the backward kernel the current device
    holds at once, whichever is fewer (their shared memory and registers at
    two blocks an SM): both plans take it.  Raises when the query fails."""
    n = _resident(torch.cuda.current_device())
    if n < 1:
        raise RuntimeError(f"red_recur: no resident block: CUDA error {-n}")
    return n


def _adjoint(x: torch.Tensor, out: torch.Tensor, g: torch.Tensor, cell: ConvGRUCell,
             h0: torch.Tensor, plan: dict | None = None) -> tuple[torch.Tensor, ...]:
    """The adjoint kernel alone on CUDA tensors (not counted), out, g and h0
    at the kernels' width C4 = `padded_width(C)`: dx, the per-plane
    cotangents dg (B, D, H, W, 2C4) and dyl (B, D, H, W, C4), the
    recomputed r·h m (B, D, H, W, C4) and dgn (6, C4), pads included.
    `plan` replaces `red_recur_bwd_plan`'s (to time other plans)."""
    b, d, h, w, cin = x.shape
    c = cell.features
    c4 = padded_width(c)
    lib = _lib()
    wa, ba, wb, bb, gn = (t.contiguous() for t in cell_kernel_args(cell, c4))
    wcT, weT = cell_backward_weights(wa, wb, cin)
    new = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype,  # noqa: E731
                                                          device=x.device)
    dx = new(b, d, h, w, cin)
    dg, dyl, m = new(b, d, h, w, 2 * c4), new(b, d, h, w, c4), new(b, d, h, w, c4)
    graw, yraw, draw = new(2, b, h, w, 2 * c4), new(b, h, w, c4), new(3, b, h, w, c4)
    dh = torch.zeros((b, h, w, c4), dtype=torch.float32, device=x.device)
    dgn = new(6, c4)
    with torch.cuda.device(x.device):
        if plan is None:
            plan = red_recur_bwd_plan(b, h, w, cin, c, resident())
        blocks = plan["blocks"]
        part = new(4, blocks, 4, dtype=torch.float64)
        gnpart = new(blocks, 6, c4, dtype=torch.float64)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.red_recur_bwd_f32(
            *(t.data_ptr() for t in (x, h0, out, g, dx, dg, dyl, m, graw, yraw, dh, draw, part,
                                     gnpart, dgn, wa, ba, wb, bb, gn, wcT, weT)),
            _plan_ints(plan), b, d, h, w, cin, c4, c, blocks, stream)
    if rc != 0:
        raise RuntimeError(f"red_recur backward kernel launch failed: CUDA error {rc}")
    return dx, dg, dyl, m, dgn


def red_recur_backward(x: torch.Tensor, out: torch.Tensor, g: torch.Tensor, cell: ConvGRUCell,
                       h0: torch.Tensor | None = None):
    """dx and the cotangents of `cell.parameters()` (in their order, summed
    over the elements) of `red_recur` at x (B, D, H, W, Cin) from its output
    `out` and the output's cotangent g; h0 is the start state the forward
    took (None for zeros; it gets no cotangent).  CUDA tensors go to the
    adjoint kernel and the weight reductions, counted in
    `red_recur_backward.launches` (x, out, g and h0 contiguous; a C that is
    not a multiple of 4 padded as the module docstring says); CPU tensors
    to `red_recur_backward_reference`."""
    if x.device.type == "cpu":
        return red_recur_backward_reference(x, out, g, cell, h0)
    b, d, h, w, cin = x.shape
    c = cell.features
    c4 = padded_width(c)
    for name, t in (("x", x), ("out", out), ("g", g)):
        if not t.is_contiguous():
            raise ValueError(f"red_recur backward: {name} must be contiguous")
    h0 = _start_state(x, c, h0)
    out, g = _pad_groups(out, c, c4), _pad_groups(g, c, c4)
    dx, dg, dyl, m, dgn = _adjoint(x, out, g, cell, h0)
    # weight and bias cotangents over all B·D planes: gates over [x | h_prev],
    # candidate over [x | r·h_prev]
    planes = lambda t: t.reshape(b * d, h, w, t.shape[-1])  # noqa: E731
    hprev = torch.cat([h0[:, None], out[:, :-1]], dim=1)
    dwa, dba = wgrad3x3("red_recur backward", planes(x), planes(dg), 1, a2=planes(hprev),
                        bias=True)
    dwb, dbb = wgrad3x3("red_recur backward", planes(x), planes(dyl), 1, a2=planes(m), bias=True)
    red_recur_backward.launches += 1
    return dx, _param_grads(cell, dwa, dba, dwb, dbb, dgn)


class _RedRecur(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h0, cell, *params):
        out = red_recur_reference(x, cell, h0) if x.device.type == "cpu" else _launch(x, cell, h0)
        ctx.cell = cell
        ctx.save_for_backward(x, h0, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, h0, out = ctx.saved_tensors
        dx, dps = red_recur_backward(x, out, g.contiguous(), ctx.cell, h0)
        return (dx, None, None, *dps)


def red_recur(x: torch.Tensor, cell: ConvGRUCell,
              h0: torch.Tensor | None = None) -> torch.Tensor:
    """Every plane's state of `cell` run over the planes of x, index 0 first.

    x (D, H, W, Cin) float32, h0 (H, W, C) or None for a zero start state →
    (D, H, W, C) float32; or, batched, x (B, D, H, W, Cin), h0 (B, H, W, C)
    or None → (B, D, H, W, C), B independent recurrences in one launch.
    Chaining: red_recur(x)[k:] equals red_recur(x[k:], cell,
    red_recur(x[:k], cell)[-1]) (per element when batched).  CUDA tensors go
    to the kernel (x and h0 contiguous, 1 ≤ C ≤ 1024; a grid the card
    cannot hold raises), CPU tensors to `red_recur_reference`.  Differentiable in x
    and the cell's parameters (backward `red_recur_backward`); an h0 that
    requires a gradient raises where autograd records, as the seeded JAX
    forms have no VJP.
    """
    _check(x, cell, h0)
    if h0 is not None and torch.is_grad_enabled() and h0.requires_grad:
        raise RuntimeError("red_recur: the start state h0 gets no gradient (the seeded "
                           "recurrence has no VJP); detach it or call under torch.no_grad()")
    if x.ndim == 4:  # one element: the batched form with B = 1
        return _RedRecur.apply(x[None], None if h0 is None else h0[None], cell,
                               *cell.parameters())[0]
    return _RedRecur.apply(x, h0, cell, *cell.parameters())


red_recur.launches = 0
red_recur_backward.launches = 0
