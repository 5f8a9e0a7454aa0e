"""2-D building blocks of FeatureNet and the RED regularizer.

Counterpart of `satmvs_tpu/nn/blocks.py` (2-D forms).  The blocks take and
return NCHW tensors, PyTorch's convolution layout; the modules built from
them (FeatureNet, REDRegularizer) keep the JAX package's channels-last
layouts at their public boundary.  Padding is torch-style (kernel k → k//2),
so output sizes match the flax blocks exactly.  As in flax, the blocks with
a BatchNorm take a `train` argument: the module's own train()/eval() mode
is not read.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm(nn.BatchNorm2d):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` over NCHW channels.

    train=False normalizes with the running statistics.  train=True
    normalizes with the batch's mean and biased variance E[x²] − E[x]²
    (clipped at 0, flax's fast variance) and moves the running statistics
    0.1 of the way to them, the variance biased too: torch's BatchNorm2d
    moves them to the unbiased variance, which would drift from flax's
    `batch_stats` at every step.  The running statistics are buffers
    updated in place, outside autograd.
    """

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class ConvBlock(nn.Module):
    """Conv → (BatchNorm) → ReLU.  norm: "bn" | "none"; the conv has a bias
    iff there is no norm, unless `use_bias` says otherwise."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, norm: str = "bn", use_bias: bool | None = None):
        super().__init__()
        if norm not in ("bn", "none"):
            raise ValueError(f"ConvBlock: unsupported norm {norm!r}")
        bias = (norm == "none") if use_bias is None else use_bias
        self.conv = nn.Conv2d(in_channels, features, kernel_size, stride,
                              padding=kernel_size // 2, bias=bias)
        self.bn = BatchNorm(features, eps=1e-5) if norm == "bn" else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.conv(x)
        return F.relu(x if self.bn is None else self.bn(x, train))


class DeconvBlock(nn.Module):
    """3×3 stride-2 transposed conv (×2 upsample) → (BatchNorm) → ReLU.

    torch's ConvTranspose2d(padding=1, output_padding=1): the flax block pads
    (1, 2) with transpose_kernel=True, which is the same map once the kernel
    is laid out as in `params.py`.
    """

    def __init__(self, in_channels: int, features: int, norm: str = "bn",
                 use_bias: bool | None = None):
        super().__init__()
        if norm not in ("bn", "none"):
            raise ValueError(f"DeconvBlock: unsupported norm {norm!r}")
        bias = (norm == "none") if use_bias is None else use_bias
        self.conv = nn.ConvTranspose2d(in_channels, features, 3, 2, padding=1,
                                       output_padding=1, bias=bias)
        self.bn = BatchNorm(features, eps=1e-5) if norm == "bn" else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.conv(x)
        return F.relu(x if self.bn is None else self.bn(x, train))


class ConvGRUCell(nn.Module):
    """Convolutional GRU with GroupNorm(1)-ed gates and a tanh candidate:

        r, u = σ(GN(conv([x, h])));  y = tanh(GN(conv([x, r·h])))
        h'   = u·h + (1 − u)·y

    Each concat-conv is split by linearity into an x-half and an h-half, as
    in the flax cell: `conv_x` packs the gates-x (2C) and candidate-x (C)
    kernels; the biases sit on the h-side convs `conv_h` and `conv_c`.  The
    x-half carries no state, so a depth scan computes it for all planes at
    once (`x_contrib`) and runs only `recur` per plane.
    """

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.features = features
        self.conv_x = nn.Conv2d(in_channels, 3 * features, 3, padding=1, bias=False)
        self.conv_h = nn.Conv2d(features, 2 * features, 3, padding=1, bias=True)
        self.conv_c = nn.Conv2d(features, features, 3, padding=1, bias=True)
        self.gn_r = nn.GroupNorm(1, features, eps=1e-5)
        self.gn_u = nn.GroupNorm(1, features, eps=1e-5)
        self.gn_y = nn.GroupNorm(1, features, eps=1e-5)

    def x_contrib(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3C, H, W) = [gates-x (2C) | candidate-x (C)]."""
        return self.conv_x(x)

    def recur(self, xc: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """One step given the precomputed input contribution; returns h'."""
        c = self.features
        gates = xc[:, : 2 * c] + self.conv_h(h)
        r = torch.sigmoid(self.gn_r(gates[:, :c]))
        u = torch.sigmoid(self.gn_u(gates[:, c:]))
        y = torch.tanh(self.gn_y(xc[:, 2 * c:] + self.conv_c(r * h)))
        return u * h + (1.0 - u) * y

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.recur(self.x_contrib(x), h)


class DeconvFuse(nn.Module):
    """The unet decoder step: upsample x, concatenate the skip, conv."""

    def __init__(self, in_channels: int, skip_channels: int, features: int):
        super().__init__()
        self.deconv = DeconvBlock(in_channels, features, norm="bn")
        self.conv = ConvBlock(features + skip_channels, features, 3, norm="bn")

    def forward(self, x_skip: torch.Tensor, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.conv(torch.cat([self.deconv(x, train), x_skip], dim=1), train)
