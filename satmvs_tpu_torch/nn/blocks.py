"""Building blocks of FeatureNet, the RED regularizer and CostRegNet.

Counterpart of `satmvs_tpu/nn/blocks.py`.  The blocks take and return
channels-first tensors, PyTorch's convolution layout: NCHW for the 2-D
blocks, NCDHW for the 3-D ones (`dims=3`, CostRegNet's); the modules built
from them (FeatureNet, REDRegularizer, CostRegNet) keep the JAX package's
channels-last layouts at their public boundary.  Padding is torch-style
(kernel k → k//2), so output sizes match the flax blocks exactly.  The 3-D
blocks are `F.conv3d` / `F.conv_transpose3d`: JAX's `Conv3DVia2D` and
`ConvTranspose3DVia2D` compute the same convolutions as sums of per-depth-tap
2-D convolutions (a TPU layout choice).  As in flax, the blocks with a
BatchNorm take a `train` argument: the module's own train()/eval() mode is
not read.

The 3-D blocks also take a slab of a sharded cost volume (`shard`, a
`dist.halo.Shard` of the depth or the height axis): the convolution joins
the neighbour ranks' halo planes or rows along that axis
(`dist.halo.halo_exchange`, zeros past the global ends) and pads nothing
there itself, so every rank computes its slab of the whole volume's
output: a stride-1 conv takes a halo each side, a stride-2 conv one before
(its slab starts at an even index), a stride-2 transposed conv one after.
Its BatchNorm takes the moments over the ranks its `group` names.

A compute dtype (`dtype`, JAX's `compute_dtype`: None for float32, or
torch.bfloat16) works as flax's `promote_dtype` (`satmvs_tpu/nn/blocks.py:
58-61`, `conv_in`): each convolution casts its input, kernel and bias to it
and returns its output in it; the parameters stay float32.  BatchNorm
normalizes in float32 and returns float32, as flax's does against its
float32 scale, so a block with a norm hands on float32.

Train-mode BatchNorms move their running statistics once per forward;
inside `frozen_running_stats` they normalize as usual and leave them alone
(the recompute of a checkpointed forward, `models.cascade`'s remat).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..dist.collectives import all_reduce_sum
from ..dist.halo import halo_exchange


class BatchNorm(nn.BatchNorm2d):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` over the channels of
    NCHW or NCDHW tensors.

    train=False normalizes with the running statistics.  train=True
    normalizes with the batch's mean Σx/n and biased variance Σx²/n − mean²
    (clipped at 0, flax's fast variance) and moves the running statistics
    0.1 of the way to them, the variance biased too: torch's BatchNorm2d
    moves them to the unbiased variance, which would drift from flax's
    `batch_stats` at every step.  The running statistics are buffers
    updated in place, outside autograd.

    Under a group (`group`, set by `sync_batch_norm`: the data group, or
    the whole mesh for a CostRegNet whose volume is sharded) the sums Σx,
    Σx² and the count n are those of the global batch (and volume), summed
    over the ranks with a differentiable all-reduce, as JAX's GSPMD computes
    the moments of a sharded batch; every rank then moves its running
    statistics identically.  Without one, the same formula runs on this
    rank's batch.
    """

    group = None  # a process group: train-mode moments over the global batch
    frozen = 0    # > 0: train mode leaves the running statistics alone

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        dims = (0, *range(2, x.ndim))
        c = x.shape[1]
        sums = torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims),
                          x.new_full((1,), x.numel() // c)])
        if self.group is not None:
            sums = all_reduce_sum(sums, self.group)
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        if not BatchNorm.frozen:
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight
        per_channel = (-1,) + (1,) * (x.ndim - 2)
        return ((x - mean.view(per_channel)) * mul.view(per_channel)
                + self.bias.view(per_channel))


@contextlib.contextmanager
def frozen_running_stats():
    """Within the block, train-mode BatchNorms leave their running statistics
    as they are (the module docstring)."""
    BatchNorm.frozen += 1
    try:
        yield
    finally:
        BatchNorm.frozen -= 1


def conv_in(conv: nn.Module, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """conv(x) computed in `dtype` (module docstring): the input and kernel
    cast to it, the convolution's output in it, then its bias (cast too)
    added in it, as flax adds it after the convolution; the gradients reach
    the float32 parameters through the casts.  dtype None: conv(x) as it
    is."""
    if dtype is None:
        return conv(x)
    x, w, b = _cast(conv, x, dtype)
    if isinstance(conv, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
        fn = F.conv_transpose2d if isinstance(conv, nn.ConvTranspose2d) else F.conv_transpose3d
        y = fn(x, w, None, conv.stride, conv.padding, conv.output_padding, conv.groups,
               conv.dilation)
    else:
        y = conv._conv_forward(x, w, None)
    return y if b is None else y + b.view(-1, *(1,) * (y.ndim - 2))


def _cast(conv: nn.Module, x: torch.Tensor, dtype):
    """(x, weight, bias) in dtype (None: as they are)."""
    if dtype is None:
        return x, conv.weight, conv.bias
    return (x.to(dtype), conv.weight.to(dtype),
            None if conv.bias is None else conv.bias.to(dtype))


def sync_batch_norm(module: nn.Module, group) -> nn.Module:
    """Every `BatchNorm` of `module` takes its train-mode moments over the
    ranks of `group` (None: over this rank's batch alone).  Returns
    `module`."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return module


def _check_dims(block: str, dims: int):
    if dims not in (2, 3):
        raise ValueError(f"{block}: dims must be 2 or 3, got {dims}")


def _slab_dim(shard) -> int:
    """The NCDHW dimension of a shard's axis."""
    return 2 if shard.axis == "depth" else 3


def conv3d_slab(conv: nn.Conv3d, x: torch.Tensor, shard, dtype=None) -> torch.Tensor:
    """A 3×3×3 pad-1 Conv3d (stride 1 or 2) of this rank's slab x (NCDHW)
    of a volume sharded along shard.axis: the halos joined, no padding on
    that axis → this rank's slab of the whole volume's output (computed in
    dtype, as `conv_in`)."""
    dim = _slab_dim(shard)
    stride = conv.stride[dim - 2]
    x, w, b = _cast(conv, halo_exchange(x, dim, shard, 1, 1 if stride == 1 else 0), dtype)
    pad = [1, 1, 1]
    pad[dim - 2] = 0
    return F.conv3d(x, w, b, conv.stride, tuple(pad))


def conv_transpose3d_slab(conv: nn.ConvTranspose3d, x: torch.Tensor, shard,
                          dtype=None) -> torch.Tensor:
    """The k=3, s=2, p=1, op=1 ConvTranspose3d of this rank's slab x: the
    next rank's first plane (or row) joined on, the output cut to twice the
    slab (computed in dtype, as `conv_in`)."""
    dim = _slab_dim(shard)
    n = x.shape[dim]
    x, w, b = _cast(conv, halo_exchange(x, dim, shard, 0, 1), dtype)
    y = F.conv_transpose3d(x, w, b, conv.stride, conv.padding, conv.output_padding)
    return y.narrow(dim, 0, 2 * n)


class ConvBlock(nn.Module):
    """Conv → (BatchNorm) → ReLU, 2-D (Conv2d) or 3-D (Conv3d, dims=3).
    norm: "bn" | "none"; the conv has a bias iff there is no norm, unless
    `use_bias` says otherwise; dtype: the conv's compute dtype (module
    docstring)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, norm: str = "bn", use_bias: bool | None = None,
                 dims: int = 2, dtype=None):
        super().__init__()
        if norm not in ("bn", "none"):
            raise ValueError(f"ConvBlock: unsupported norm {norm!r}")
        _check_dims("ConvBlock", dims)
        bias = (norm == "none") if use_bias is None else use_bias
        conv = nn.Conv2d if dims == 2 else nn.Conv3d
        self.conv = conv(in_channels, features, kernel_size, stride,
                         padding=kernel_size // 2, bias=bias)
        self.bn = BatchNorm(features, eps=1e-5) if norm == "bn" else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False, shard=None) -> torch.Tensor:
        """shard: x is this rank's slab of a sharded volume (3-D blocks;
        module docstring)."""
        x = (conv_in(self.conv, x, self.dtype) if shard is None else
             conv3d_slab(self.conv, x, shard, self.dtype))
        return F.relu(x if self.bn is None else self.bn(x, train))


class DeconvBlock(nn.Module):
    """3×3(×3) stride-2 transposed conv (×2 upsample) → (BatchNorm) → ReLU,
    2-D or 3-D (dims=3).

    torch's ConvTranspose2d/3d(padding=1, output_padding=1): the flax block
    pads (1, 2) with transpose_kernel=True, which is the same map once the
    kernel is laid out as in `params.py`.  In 3-D, JAX's
    `ConvTranspose3DVia2D` writes the depth axis as even planes
    convT2d(x[m], k[1]) and odd planes convT2d(x[m + 1], k[0]) +
    convT2d(x[m], k[2]): torch's index map with the kernel's depth taps in
    the same order.
    """

    def __init__(self, in_channels: int, features: int, norm: str = "bn",
                 use_bias: bool | None = None, dims: int = 2, dtype=None):
        super().__init__()
        if norm not in ("bn", "none"):
            raise ValueError(f"DeconvBlock: unsupported norm {norm!r}")
        _check_dims("DeconvBlock", dims)
        bias = (norm == "none") if use_bias is None else use_bias
        deconv = nn.ConvTranspose2d if dims == 2 else nn.ConvTranspose3d
        self.conv = deconv(in_channels, features, 3, 2, padding=1, output_padding=1, bias=bias)
        self.bn = BatchNorm(features, eps=1e-5) if norm == "bn" else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False, shard=None) -> torch.Tensor:
        """shard: x is this rank's slab of a sharded volume (3-D blocks)."""
        x = (conv_in(self.conv, x, self.dtype) if shard is None else
             conv_transpose3d_slab(self.conv, x, shard, self.dtype))
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

    def __init__(self, in_channels: int, skip_channels: int, features: int, dtype=None):
        super().__init__()
        self.deconv = DeconvBlock(in_channels, features, norm="bn", dtype=dtype)
        self.conv = ConvBlock(features + skip_channels, features, 3, norm="bn", dtype=dtype)

    def forward(self, x_skip: torch.Tensor, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.conv(torch.cat([self.deconv(x, train), x_skip], dim=1), train)
