"""Plane convolutions of the RED regularizer: CUDA kernels and their plain versions.

Replace the TPU kernels of `satmvs_tpu/ops/pallas/plane_conv.py`:

  conv_dn    stride-2 3×3 conv, pad 1, no bias, ReLU    (`_conv_dn_impl`, :382)
  deconv_up  ConvTranspose2d(k=3, s=2, p=1, op=1), no bias, ReLU, then an
             optional skip add                          (`_deconv_up_impl`, :569)
  conv_head  stride-1 3×3 conv, pad 1, with bias        (`_conv_head_impl`, :730)

Activations are channels-last (N, H, W, C) float32, as in the JAX NHWC forms;
weights are the port's `nn.Conv2d` / `nn.ConvTranspose2d` parameters in torch
layout.  The CUDA source is `satmvs_tpu_torch/csrc/plane_conv.cu`; its header
gives the design and the bound.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
`<wrapper>.launches`; for CPU tensors, and only for them, it computes the plain
version (`<name>_reference`, the cuDNN-backed functional call).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build, refuse_graph

# where the backward kernels of the RED regularizer come from
RED_BACKWARD = ("its backward kernel comes with fused_red=on training; "
                "train with fused_red off until then")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def conv_dn_reference(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """relu(conv2d(x, weight, stride 2, pad 1)): (N, H, W, Cin) → (N, ⌈H/2⌉, ⌈W/2⌉, Cout)."""
    return _nhwc(F.relu(F.conv2d(_nchw(x), weight, stride=2, padding=1)))


def deconv_up_reference(x: torch.Tensor, weight: torch.Tensor,
                        skip: torch.Tensor | None = None) -> torch.Tensor:
    """relu(conv_transpose2d(x, weight, stride 2, pad 1, output pad 1)) + skip:
    (N, H, W, Cin) → (N, 2H, 2W, Cout); weight (Cin, Cout, 3, 3)."""
    y = F.relu(F.conv_transpose2d(_nchw(x), weight, stride=2, padding=1, output_padding=1))
    y = _nhwc(y)
    return y if skip is None else y + skip


def conv_head_reference(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """conv2d(x, weight, bias, pad 1): (N, H, W, Cin) → (N, H, W, Cout)."""
    return _nhwc(F.conv2d(_nchw(x), weight, bias, padding=1))


def _c_fn(name: str, n_ints: int):
    """The C function `name` of plane_conv.cu: 4 pointers, n_ints ints, the stream."""
    fn = getattr(build.load("plane_conv"), name)
    # pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
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


def _launch(name: str, fn, *args):
    """Launches on the current stream of the tensors' device; raises on a CUDA error."""
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        rc = fn(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _contiguous(name: str, **tensors):
    for key, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _conv3x3(name: str, x, weight, bias, stride: int, relu: bool) -> torch.Tensor:
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    _contiguous(name, x=x)
    out = torch.empty((n, (h - 1) // stride + 1, (w - 1) // stride + 1, cout),
                      dtype=torch.float32, device=x.device)
    w_k = weight.detach().permute(2, 3, 1, 0).contiguous()  # (3, 3, Cin, Cout)
    b = bias.detach().contiguous() if bias is not None else 0  # 0: a null pointer
    _launch(name, _c_fn("conv3x3_f32", 7), x, w_k, b, out, n, h, w, cin, cout, stride,
            int(relu))
    return out


def conv_dn(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Stride-2 3×3 conv, pad 1, no bias, ReLU (the RED encoder's ConvBlock).

    x (N, H, W, Cin) float32, weight (Cout, Cin, 3, 3) → (N, ⌈H/2⌉, ⌈W/2⌉, Cout).
    CUDA tensors go to the kernel (x must be contiguous), CPU tensors to
    `conv_dn_reference`.  On CUDA tensors it raises where autograd would
    record a graph (`refuse_graph`)."""
    if weight.ndim != 4 or weight.shape[2:] != (3, 3):
        raise ValueError(f"conv_dn: want weight (Cout, Cin, 3, 3), got {tuple(weight.shape)}")
    _check("conv_dn", x, {"weight": weight}, weight.shape[1])
    if x.device.type == "cpu":
        return conv_dn_reference(x, weight)
    refuse_graph("conv_dn", RED_BACKWARD, x, weight)
    out = _conv3x3("conv_dn", x, weight, None, 2, True)
    conv_dn.launches += 1
    return out


def conv_head(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Stride-1 3×3 conv, pad 1, with bias, no activation (the RED logit head).

    x (N, H, W, Cin) float32, weight (Cout, Cin, 3, 3), bias (Cout,) → (N, H, W, Cout).
    CUDA tensors go to the kernel (x must be contiguous), CPU tensors to
    `conv_head_reference`.  On CUDA tensors it raises where autograd would
    record a graph (`refuse_graph`)."""
    if weight.ndim != 4 or weight.shape[2:] != (3, 3):
        raise ValueError(f"conv_head: want weight (Cout, Cin, 3, 3), got {tuple(weight.shape)}")
    if bias.shape != (weight.shape[0],):
        raise ValueError(f"conv_head: bias {tuple(bias.shape)} != ({weight.shape[0]},)")
    _check("conv_head", x, {"weight": weight, "bias": bias}, weight.shape[1])
    if x.device.type == "cpu":
        return conv_head_reference(x, weight, bias)
    refuse_graph("conv_head", RED_BACKWARD, x, weight, bias)
    out = _conv3x3("conv_head", x, weight, bias, 1, False)
    conv_head.launches += 1
    return out


def deconv_up(x: torch.Tensor, weight: torch.Tensor,
              skip: torch.Tensor | None = None) -> torch.Tensor:
    """relu(ConvTranspose2d(k=3, s=2, p=1, op=1)(x)), plus `skip` after the ReLU
    when given (the RED decoder's DeconvBlock and its additive skip).

    x (N, H, W, Cin) float32, weight (Cin, Cout, 3, 3), skip (N, 2H, 2W, Cout)
    → (N, 2H, 2W, Cout).  CUDA tensors go to the kernel (x and skip must be
    contiguous), CPU tensors to `deconv_up_reference`.  On CUDA tensors it
    raises where autograd would record a graph (`refuse_graph`)."""
    if weight.ndim != 4 or weight.shape[2:] != (3, 3):
        raise ValueError(f"deconv_up: want weight (Cin, Cout, 3, 3), got {tuple(weight.shape)}")
    extra = {"weight": weight} if skip is None else {"weight": weight, "skip": skip}
    _check("deconv_up", x, extra, weight.shape[0])
    n, h, w, cin = x.shape
    cout = weight.shape[1]
    if skip is not None and tuple(skip.shape) != (n, 2 * h, 2 * w, cout):
        raise ValueError(f"deconv_up: skip {tuple(skip.shape)} != {(n, 2 * h, 2 * w, cout)}")
    if x.device.type == "cpu":
        return deconv_up_reference(x, weight, skip)
    refuse_graph("deconv_up", RED_BACKWARD, x, weight, skip)
    _contiguous("deconv_up", x=x, skip=skip)
    out = torch.empty((n, 2 * h, 2 * w, cout), dtype=torch.float32, device=x.device)
    w_k = weight.detach().permute(2, 3, 0, 1).contiguous()  # (3, 3, Cin, Cout)
    _launch("deconv_up", _c_fn("deconv3x3_s2_f32", 5), x, w_k,
            skip if skip is not None else 0, out, n, h, w, cin, cout)
    deconv_up.launches += 1
    return out


conv_dn.launches = 0
deconv_up.launches = 0
conv_head.launches = 0
