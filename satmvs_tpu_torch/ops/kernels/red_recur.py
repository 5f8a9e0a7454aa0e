"""ConvGRU depth recurrence of one RED scale: CUDA kernel and its plain version.

Replaces two TPU kernels of `satmvs_tpu/ops/pallas/red_recur.py` with one
CUDA kernel: `_red_recur_impl` (pallas_call at :287; public `red_recur`
:1388 and the seeded `red_recur_from` :1429) and its batched form
`_red_recur_impl_batched` (pallas_call at :368; public
`red_recur_from_packed_batched` :1450).  The CUDA source is
`satmvs_tpu_torch/csrc/red_recur.cu`; its header gives the design and the
bound.

`red_recur(x, cell, h0)` runs a `nn.blocks.ConvGRUCell` over the D planes of
x, the state starting at h0 (zeros when None), and returns every plane's
state.  x may carry a leading batch axis B: then B independent recurrences,
each from its own start state, run in one launch.  It launches the kernel for
CUDA tensors and counts each launch in `red_recur.launches`; for CPU tensors,
and only for them, it computes the plain version `red_recur_reference`, a
loop over the elements and the planes.
"""

from __future__ import annotations

import ctypes

import torch

from ...nn.blocks import ConvGRUCell
from . import build

_MAX_BLOCKS = 4096  # caps the cooperative grid; sizes the per-block sums scratch


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


def cell_kernel_args(cell: ConvGRUCell) -> tuple[torch.Tensor, ...]:
    """A ConvGRUCell's convs and norms as the kernel's arguments (wa, ba, wb, bb, gn):

      wa (9, Cin + C, 2C)  gates conv over [x | h]: conv_x's first 2C outputs and conv_h
      ba (2C,)             conv_h's bias
      wb (9, Cin + C, C)   candidate conv over [x | r·h]: conv_x's last C outputs and conv_c
      bb (C,)              conv_c's bias
      gn (6, C)            GroupNorm [r scale, r shift, u scale, u shift, y scale, y shift]
    """
    c = cell.features
    wx = cell.conv_x.weight.detach()  # (3C, Cin, 3, 3)

    def taps(w):  # (Cout, Cin', 3, 3) → (9, Cin', Cout)
        return w.permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0]).contiguous()

    wa = taps(torch.cat([wx[:2 * c], cell.conv_h.weight.detach()], dim=1))
    wb = taps(torch.cat([wx[2 * c:], cell.conv_c.weight.detach()], dim=1))
    gn = torch.stack([t.detach() for norm in (cell.gn_r, cell.gn_u, cell.gn_y)
                      for t in (norm.weight, norm.bias)])
    return wa, cell.conv_h.bias.detach(), wb, cell.conv_c.bias.detach(), gn


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
    lib.red_recur_blocks.argtypes = [ctypes.c_int] * 5
    lib.red_recur_blocks.restype = ctypes.c_int
    # pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
    lib.red_recur_f32.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.red_recur_f32.restype = ctypes.c_int
    return lib


def grid_blocks(b: int, h: int, w: int, c: int) -> int:
    """Blocks of the cooperative grid for B elements of (h, w) planes with c
    state channels (a multiple of B, all resident at once); raises when not
    even one block per element can be resident.  Call on the current device."""
    blocks = _lib().red_recur_blocks(b, h, w, c, _MAX_BLOCKS)
    if blocks < 1:
        raise RuntimeError(f"red_recur: no cooperative grid for B = {b}: CUDA error {-blocks}")
    return blocks


def _launch(x: torch.Tensor, cell: ConvGRUCell, h0: torch.Tensor | None) -> torch.Tensor:
    """The kernel on x (B, D, H, W, Cin) and h0 (B, H, W, C) or None."""
    b, d, h, w, cin = x.shape
    c = cell.features
    if c % 4:
        raise ValueError(f"red_recur: the kernel takes C % 4 == 0, got C = {c}")
    if h0 is None:
        h0 = torch.zeros((b, h, w, c), dtype=torch.float32, device=x.device)
    for name, t in (("x", x), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"red_recur: {name} must be contiguous")
    if h0.data_ptr() % 16:
        raise ValueError("red_recur: h0 must be 16-byte aligned")
    lib = _lib()
    wa, ba, wb, bb, gn = (t.contiguous() for t in cell_kernel_args(cell))
    out = torch.empty((b, d, h, w, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        blocks = grid_blocks(b, h, w, c)
        g = torch.empty((b, h, w, 2 * c), dtype=torch.float32, device=x.device)
        m = torch.empty((b, h, w, c), dtype=torch.float32, device=x.device)
        part = torch.empty((2, blocks, 4), dtype=torch.float64, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.red_recur_f32(*(t.data_ptr() for t in (x, h0, out, g, m, part, wa, ba, wb, bb,
                                                        gn)),
                               b, d, h, w, cin, c, blocks, stream)
    if rc != 0:
        raise RuntimeError(f"red_recur kernel launch failed: CUDA error {rc}")
    red_recur.launches += 1
    return out


def red_recur(x: torch.Tensor, cell: ConvGRUCell,
              h0: torch.Tensor | None = None) -> torch.Tensor:
    """Every plane's state of `cell` run over the planes of x, index 0 first.

    x (D, H, W, Cin) float32, h0 (H, W, C) or None for a zero start state →
    (D, H, W, C) float32; or, batched, x (B, D, H, W, Cin), h0 (B, H, W, C)
    or None → (B, D, H, W, C), B independent recurrences in one launch.
    Chaining: red_recur(x)[k:] equals red_recur(x[k:], cell,
    red_recur(x[:k], cell)[-1]) (per element when batched).  CUDA tensors go
    to the kernel (x and h0 contiguous, C % 4 == 0; a grid the card cannot
    hold raises), CPU tensors to `red_recur_reference`.  No gradient flows
    through the CUDA path.
    """
    _check(x, cell, h0)
    if x.device.type == "cpu":
        return red_recur_reference(x, cell, h0)
    if x.ndim == 4:
        return _launch(x[None], cell, None if h0 is None else h0[None])[0]
    return _launch(x, cell, h0)


red_recur.launches = 0
