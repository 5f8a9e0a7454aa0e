"""ConvGRU depth recurrence of one RED scale: CUDA kernel and its plain version.

Replaces the TPU kernel of `satmvs_tpu/ops/pallas/red_recur.py`
(`_red_recur_impl`, pallas_call at :287; public `red_recur` :1388 and the
seeded `red_recur_from` :1429).  The CUDA source is
`satmvs_tpu_torch/csrc/red_recur.cu`; its header gives the design and the
bound.

`red_recur(x, cell, h0)` runs a `nn.blocks.ConvGRUCell` over the D planes of
x, the state starting at h0 (zeros when None), and returns every plane's
state.  It launches the kernel for CUDA tensors and counts each launch in
`red_recur.launches`; for CPU tensors, and only for them, it computes the
plain version `red_recur_reference`, a loop over the planes.
"""

from __future__ import annotations

import ctypes

import torch

from ...nn.blocks import ConvGRUCell
from . import build

_MAX_BLOCKS = 4096  # caps the cooperative grid; sizes the per-block sums scratch


def red_recur_reference(x: torch.Tensor, cell: ConvGRUCell,
                        h0: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: the cell's input convolution over all planes at
    once, then `cell.recur` plane by plane.  x (D, H, W, Cin), h0 (H, W, C) →
    (D, H, W, C)."""
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
    if x.ndim != 4 or x.shape[-1] != cin:
        raise ValueError(f"red_recur: want x (D, H, W, {cin}), got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"red_recur: unsupported device {x.device}")
    if cell.conv_x.weight.device != x.device:
        raise ValueError(f"red_recur: cell is on {cell.conv_x.weight.device}, x on {x.device}")
    if h0 is not None:
        if h0.dtype != torch.float32 or h0.device != x.device:
            raise ValueError(f"red_recur: h0 must be float32 on {x.device}")
        if tuple(h0.shape) != (x.shape[1], x.shape[2], c):
            raise ValueError(f"red_recur: h0 {tuple(h0.shape)} != {(x.shape[1], x.shape[2], c)}")


def red_recur(x: torch.Tensor, cell: ConvGRUCell,
              h0: torch.Tensor | None = None) -> torch.Tensor:
    """Every plane's state of `cell` run over the planes of x, index 0 first.

    x (D, H, W, Cin) float32, h0 (H, W, C) or None for a zero start state →
    (D, H, W, C) float32.  Chaining: red_recur(x)[k:] equals
    red_recur(x[k:], cell, red_recur(x[:k], cell)[-1]).  CUDA tensors go to
    the kernel (x and h0 contiguous, C % 4 == 0), CPU tensors to
    `red_recur_reference`.  No gradient flows through the CUDA path.
    """
    _check(x, cell, h0)
    if x.device.type == "cpu":
        return red_recur_reference(x, cell, h0)
    d, h, w, cin = x.shape
    c = cell.features
    if c % 4:
        raise ValueError(f"red_recur: the kernel takes C % 4 == 0, got C = {c}")
    if h0 is None:
        h0 = torch.zeros((h, w, c), dtype=torch.float32, device=x.device)
    for name, t in (("x", x), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"red_recur: {name} must be contiguous")
    if h0.data_ptr() % 16:
        raise ValueError("red_recur: h0 must be 16-byte aligned")
    lib = build.load("red_recur")
    lib.red_recur_blocks.argtypes = [ctypes.c_int] * 4
    lib.red_recur_blocks.restype = ctypes.c_int
    # pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
    lib.red_recur_f32.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.red_recur_f32.restype = ctypes.c_int
    wa, ba, wb, bb, gn = (t.contiguous() for t in cell_kernel_args(cell))
    out = torch.empty((d, h, w, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        blocks = lib.red_recur_blocks(h, w, c, _MAX_BLOCKS)
        if blocks < 1:
            raise RuntimeError(f"red_recur: no cooperative grid: CUDA error {-blocks}")
        g = torch.empty((h, w, 2 * c), dtype=torch.float32, device=x.device)
        m = torch.empty((h, w, c), dtype=torch.float32, device=x.device)
        part = torch.empty((2, blocks, 4), dtype=torch.float64, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.red_recur_f32(*(t.data_ptr() for t in (x, h0, out, g, m, part, wa, ba, wb, bb,
                                                        gn)),
                               d, h, w, cin, c, blocks, stream)
    if rc != 0:
        raise RuntimeError(f"red_recur kernel launch failed: CUDA error {rc}")
    red_recur.launches += 1
    return out


red_recur.launches = 0
