"""Whole 3-D conv blocks of the CostRegNet families: CUDA kernels and their
plain versions.

Replace the packed CostRegNet's per-depth-tap composition (JAX
`satmvs_tpu/nn/costreg.py` `packed_costreg_forward`, :57-160):

  conv3d_block    3×3×3 conv, stride 1 or 2, explicit zero pads, + bias,
                  optional ReLU: JAX's `c3d_s1` (:111) over the Pallas
                  `conv_head` (`satmvs_tpu/ops/pallas/plane_conv.py:730`) and
                  `c3d_s2` (:121) over `conv_dn` (:382) with relu off; also
                  the 1-channel logit head (no bias, no ReLU)
  deconv3d_block  ConvTranspose3d(k=3, s=2, p=1, op=1), + bias, ReLU, + skip:
                  JAX's `d3dT` (:134) over `deconv_up` (:569) with relu off

with one launch per block for all B·D planes, at any number of input and
output channels (past 64 output channels each block of the grid computes a
slab of 64 of them).  Activations are channels-last
(N, D, H, W, C) float32; weights are the port's `nn.Conv3d` (Cout, Cin, 3, 3,
3) and `nn.ConvTranspose3d` (Cin, Cout, 3, 3, 3) parameters with the
BatchNorm folded in by the caller (`nn/costreg.py`).  The CUDA source is
`satmvs_tpu_torch/csrc/conv3d_block.cu`; its header gives the design.

Bound: the larger of the bytes (x, the weights, bias and skip read once, the
output written once) over 3.35 TB/s and the multiply-adds of the taps inside
the volume, 2 flops each, over 495 / 3 TFLOP/s: the kernels compute fp32
products as a 3×TF32 split on the tensor cores, three TF32 products each.

Explicit zero pads let a rank's slab of a volume sharded along D or H run
with its halo joined on (`dist.halo.halo_exchange`), with no crop or shift:
`pads` gives the conv's (front, back) zero pad per axis (0 or 1), `back` the
transposed conv's zero plane past the end per axis (0 where the last plane,
row or column is the next slab's halo, whose outputs are not written).

CUDA tensors launch the kernel, counted in `<wrapper>.launches`; CPU tensors,
and only they, take the plain version (`<name>_reference`: F.conv3d /
F.conv_transpose3d).  Both are forward-only, as JAX's packed path: a graph
is refused.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

PAD1 = ((1, 1), (1, 1), (1, 1))  # a whole volume: pad 1 on every axis
BACK1 = (1, 1, 1)
SLAB = 64  # output channels a block of the kernel computes at most


def conv3d_block_reference(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor | None = None, stride: int = 1,
                           relu: bool = False, pads=PAD1) -> torch.Tensor:
    """conv3d of x (N, D, H, W, Cin), zero-padded by pads ((d0, d1), (h0,
    h1), (w0, w1)), with weight (Cout, Cin, 3, 3, 3) and bias, at stride,
    then ReLU when relu → (N, Do, Ho, Wo, Cout)."""
    (d0, d1), (h0, h1), (w0, w1) = pads
    xt = F.pad(x.permute(0, 4, 1, 2, 3), (w0, w1, h0, h1, d0, d1))
    y = F.conv3d(xt, weight, bias, stride=stride)
    return (F.relu(y) if relu else y).permute(0, 2, 3, 4, 1).contiguous()


def deconv3d_block_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                             skip: torch.Tensor, back=BACK1) -> torch.Tensor:
    """relu(conv_transpose3d(x, weight, bias, stride 2, pad 1, output pad 1))
    + skip, x (N, D, H, W, Cin), weight (Cin, Cout, 3, 3, 3); along an axis
    whose back is 0 the input's last entry is a halo and the output stops
    before its outputs: (N, 2(D − 1 + back_d), ..., Cout)."""
    y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), weight, bias, stride=2, padding=1,
                           output_padding=1)
    d, h, w = (2 * (n - 1 + b) for n, b in zip(x.shape[1:4], back))
    return F.relu(y[:, :, :d, :h, :w]).permute(0, 2, 3, 4, 1) + skip


def _padded_cout(cout: int) -> int:
    """Output channels the kernel computes: Cout rounded up to NT = 8, 16, 32
    or 64, and past 64 to slabs of 64."""
    return next((n for n in (8, 16, 32) if cout <= n), -(-cout // SLAB) * SLAB)


def prepared_weight(weight: torch.Tensor, transposed: bool) -> torch.Tensor:
    """The kernel's weight layout (27, Cin8, slabs·NT): tap (kd, kh, kw),
    input channel, output channel, zero-padded to a multiple of 8 input
    channels and `_padded_cout` output channels."""
    w = weight.permute(2, 3, 4, 0, 1) if transposed else weight.permute(2, 3, 4, 1, 0)
    cin, cout = w.shape[3:]
    w = w.reshape(27, cin, cout)
    return F.pad(w, (0, _padded_cout(cout) - cout, 0, -(-cin // 8) * 8 - cin)).contiguous()


@functools.lru_cache(maxsize=None)
def _c_fn(name: str, n_ints: int):
    """conv3d_block.cu's `name`: five pointers, n_ints ints, the stream."""
    fn = getattr(build.load("conv3d_block"), name)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, x: torch.Tensor, weight: torch.Tensor, cin: int, **more):
    tensors = {"x": x, "weight": weight, **{k: t for k, t in more.items() if t is not None}}
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: {key} is on {t.device}, x on {x.device}")
    if x.ndim != 5 or x.shape[-1] != cin or weight.shape[2:] != (3, 3, 3):
        raise ValueError(f"{name}: want x (N, D, H, W, {cin}) and a 3×3×3 weight, got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise ValueError(f"{name}: forward-only (the packed CostRegNet's form); "
                         "run it under torch.no_grad()")


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, bias, skip, out, *ints):
    """One launch on the current stream of x's device; raises on a CUDA error."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [0 if t is None else t.data_ptr() for t in (x, w, bias, skip, out)]
        rc = _c_fn(name, len(ints))(*ptrs, *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def conv3d_block(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                 stride: int = 1, relu: bool = False, pads=PAD1) -> torch.Tensor:
    """3×3×3 conv, stride 1 or 2, of x (N, D, H, W, Cin) zero-padded by pads
    ((d0, d1), (h0, h1), (w0, w1), each 0 or 1) with weight (Cout, Cin, 3, 3,
    3), + bias (or None), then ReLU when relu → (N, Do, Ho, Wo, Cout), Do =
    (D + d0 + d1 − 3) // stride + 1 and so on.  CUDA tensors launch
    `conv3d_block_f32` (counted in `conv3d_block.launches`), CPU tensors take
    `conv3d_block_reference`."""
    cout, cin = weight.shape[:2]
    _check("conv3d_block", x, weight, cin, bias=bias)
    if stride not in (1, 2) or any(p not in (0, 1) for pair in pads for p in pair):
        raise ValueError(f"conv3d_block: stride 1 or 2 and pads of 0 or 1, got {stride}, "
                         f"{pads}")
    if x.device.type == "cpu":
        return conv3d_block_reference(x, weight, bias, stride, relu, pads)
    x, bias = x.contiguous(), None if bias is None else bias.contiguous()
    n, *dhw, _ = x.shape
    outer = [(e + a + b - 3) // stride + 1 for e, (a, b) in zip(dhw, pads)]
    if min(outer) < 1:
        raise ValueError(f"conv3d_block: empty output for {tuple(x.shape)}, pads {pads}")
    out = torch.empty((n, *outer, cout), dtype=torch.float32, device=x.device)
    _launch("conv3d_block_f32", x, prepared_weight(weight, False), bias, None, out,
            n, *dhw, cin, *outer, cout, stride, *(a for a, _ in pads), int(relu))
    conv3d_block.launches += 1
    return out


def deconv3d_block(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   skip: torch.Tensor, back=BACK1) -> torch.Tensor:
    """ConvTranspose3d(k=3, s=2, p=1, op=1) of x (N, D, H, W, Cin) with
    weight (Cin, Cout, 3, 3, 3), + bias, ReLU, + skip → (N, 2(D − 1 +
    back_d), 2(H − 1 + back_h), 2(W − 1 + back_w), Cout); back (each 0 or 1)
    as in the module docstring.  CUDA tensors launch `deconv3d_block_f32`
    (even and odd output planes in one launch, counted in
    `deconv3d_block.launches`), CPU tensors take `deconv3d_block_reference`."""
    cin, cout = weight.shape[:2]
    _check("deconv3d_block", x, weight, cin, bias=bias, skip=skip)
    if any(b not in (0, 1) for b in back):
        raise ValueError(f"deconv3d_block: back pads of 0 or 1, got {back}")
    m = [e - 1 + b for e, b in zip(x.shape[1:4], back)]
    want = (x.shape[0], *(2 * e for e in m), cout)
    if min(m) < 1 or tuple(skip.shape) != want:
        raise ValueError(f"deconv3d_block: x {tuple(x.shape)}, back {back} and skip "
                         f"{tuple(skip.shape)} do not give {want}")
    if x.device.type == "cpu":
        return deconv3d_block_reference(x, weight, bias, skip, back)
    x, bias = x.contiguous(), None if bias is None else bias.contiguous()
    out = torch.empty(want, dtype=torch.float32, device=x.device)
    _launch("deconv3d_block_f32", x, prepared_weight(weight, True), bias, skip.contiguous(),
            out, x.shape[0], *x.shape[1:4], cin, *m, cout)
    deconv3d_block.launches += 1
    return out


conv3d_block.launches = 0
deconv3d_block.launches = 0
