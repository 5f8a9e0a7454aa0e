"""3-D cost-volume regularization U-Net of the CasMVSNet and UCSNet families.

Counterpart of `satmvs_tpu/nn/costreg.py`'s `CostRegNet`: three stride-2
3-D conv downsamples over (D, H, W), three transposed-conv upsamples with
skip additions, and a 1-channel logit head.  (B, D, H, W, C) volume →
(B, D, H, W) float32 logits; D, H and W must be divisible by 8.  Two paths
compute the same function:

  packed (fused None or True, no gradient recorded, train=False): what
    JAX's `packed_costreg_forward` (costreg.py:57-160) computes.  Inference
    BatchNorm folds into each conv's output channels and a bias (`_bn_fold`,
    fp32), and every block is one call of `ops/kernels/conv3d_block`:
    `conv3d_block` for the seven ConvBlocks (stride 1 or 2, bias, ReLU) and
    the head (no bias, no ReLU), `deconv3d_block` for the three
    DeconvBlocks (bias, ReLU and the skip add in the kernel's epilogue).
    JAX cut each 3-D conv into three per-depth-tap 2-D Pallas calls, a TPU
    workaround (XLA's conv3d ran these shapes at < 5 % of the MXU) that is
    not carried over: on the card one launch computes a whole block for
    all B·D planes, 8 `conv3d_block` and 3 `deconv3d_block` per forward
    whatever B is, and each element's logits are the bits of its B = 1
    call.  CUDA tensors go to the CUDA kernels, CPU tensors to their plain
    versions (F.conv3d / F.conv_transpose3d).
  conv3d (fused=False, a gradient recorded, or train=True): the blocks as
    JAX's XLA path runs them, `F.conv3d` / `F.conv_transpose3d` with
    flax-semantics BatchNorm (`nn/blocks.py`); differentiable.

JAX's row packing, `split_cols` / `merge_cols` and the VMEM feasibility caps
(`packed_costreg_feasible`) are TPU layout workarounds and are not ported:
any shape the contract takes runs packed.

A compute dtype (`dtype`, JAX's `compute_dtype`, `satmvs_tpu/nn/costreg.py:
175-197`) reaches the conv3d path's blocks: each 3-D conv and transposed
conv computes in it (cuDNN in bf16 on the card), BatchNorm in float32, the
head in float32 as JAX's.  The packed kernels stay float32, so under a
compute dtype the CostRegNet always takes the conv3d path, as JAX runs its
bf16 XLA convolutions there.

Both paths also take this rank's slab of a volume sharded along D or H
(`shard`, a `dist.halo.Shard`; JAX's GSPMD partitions the same network
under a sharding constraint): each convolution joins its neighbours' halo
planes or rows (`dist.halo.halo_exchange`, zeros past the global ends).  On
the conv3d path that is `nn.blocks.conv3d_slab`; on the packed path the
halo'd slab goes straight into the kernel with no zero pad on the sharded
axis, and the kernels sum each output in one fixed order, so a slab's
logits are the bits of the whole volume's.  The launches per forward stay
those of the whole volume.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..dist.halo import halo_exchange
from ..ops.kernels.conv3d_block import BACK1, PAD1, conv3d_block, deconv3d_block
from .blocks import BatchNorm, ConvBlock, DeconvBlock, conv3d_slab

_BN_EPS = 1e-5  # flax nn.BatchNorm's default


def _bn_fold(bn: BatchNorm) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm as a per-channel affine (scale, bias) with
    bn(z) = z·scale + bias under the running statistics, in fp32."""
    sc = bn.weight * torch.rsqrt(bn.running_var + _BN_EPS)
    return sc, bn.bias - bn.running_mean * sc


def _slab_dim(shard) -> int:
    """The (B, D, H, W, C) axis a shard cuts."""
    return 1 if shard.axis == "depth" else 2


def c3d(x: torch.Tensor, w3: torch.Tensor, bias: torch.Tensor | None, stride: int = 1,
        relu: bool = True, shard=None) -> torch.Tensor:
    """3×3×3 conv, pad 1, of x (B, D, h, w, Cin) with w3 (Cout, Cin, 3, 3, 3)
    at stride, + bias (or None), ReLU when relu; with a shard, x is this
    rank's slab (starting at an even plane or row) and so is the output."""
    pads = list(PAD1)
    if shard is not None:
        dim = _slab_dim(shard)
        x = halo_exchange(x, dim, shard, 1, 1 if stride == 1 else 0)
        pads[dim - 1] = (0, 0)
    return conv3d_block(x, w3, bias, stride, relu, tuple(pads))


def d3dT(x: torch.Tensor, wt3: torch.Tensor, bias: torch.Tensor, skip: torch.Tensor,
         shard=None) -> torch.Tensor:
    """ConvTranspose3d(k=3, s=2, p=1, op=1) of x (B, D, h, w, Cin) with wt3
    (Cin, Cout, 3, 3, 3), + bias, ReLU and + skip → (B, 2D, 2h, 2w, Cout);
    with a shard, x is this rank's slab and skip the output's."""
    back = list(BACK1)
    if shard is not None:
        dim = _slab_dim(shard)
        x = halo_exchange(x, dim, shard, 0, 1)  # the next rank's first plane or row last
        back[dim - 1] = 0
    return deconv3d_block(x, wt3, bias, skip, tuple(back))


class CostRegNet(nn.Module):
    """(B, D, H, W, C) variance volume → (B, D, H, W) float32 logits.

    fused: None (the default) or True run the packed path when no gradient
    is recorded, train is False and there is no compute dtype, on every
    device (JAX resolves None by its backend, `satmvs_tpu/nn/costreg.py:
    176-186`; the port's kernels run on every device); False always runs
    the conv3d path.  dtype: the conv3d path's compute dtype (module
    docstring)."""

    def __init__(self, in_channels: int, base_channels: int = 8,
                 fused: Optional[bool] = None, dtype=None):
        super().__init__()
        b = base_channels
        self.base_channels = b
        self.fused, self.dtype = fused, dtype

        def block(cin, cout, stride=1):
            return ConvBlock(cin, cout, stride=stride, dims=3, dtype=dtype)

        def up(cin, cout):
            return DeconvBlock(cin, cout, dims=3, dtype=dtype)

        # flax's creation order: ConvBlock_0..6, DeconvBlock_0..2, Conv_0
        self.convs = nn.ModuleList([
            block(in_channels, b), block(b, 2 * b, 2), block(2 * b, 2 * b),
            block(2 * b, 4 * b, 2), block(4 * b, 4 * b), block(4 * b, 8 * b, 2),
            block(8 * b, 8 * b)])
        self.deconvs = nn.ModuleList([up(8 * b, 4 * b), up(4 * b, 2 * b), up(2 * b, b)])
        self.head = nn.Conv3d(b, 1, 3, padding=1, bias=False)

    def forward(self, volume: torch.Tensor, train: bool = False, shard=None) -> torch.Tensor:
        """shard: volume is this rank's slab of a volume sharded along D or H
        (module docstring); the logits are the slab's."""
        extent = list(volume.shape[1:4])
        if shard is not None:
            extent[0 if shard.axis == "depth" else 1] = shard.extent
        if volume.ndim != 5 or any(n % 8 for n in extent):
            raise ValueError(f"CostRegNet: want a (B, D, H, W, C) volume with D, H and W "
                             f"divisible by 8, got {tuple(volume.shape)} (whole {extent})")
        records = torch.is_grad_enabled() and (
            volume.requires_grad or any(p.requires_grad for p in self.parameters()))
        if self.fused is not False and self.dtype is None and not train and not records:
            return self.packed(volume, shard)
        return self.conv3d(volume, train, shard)

    def conv3d(self, volume: torch.Tensor, train: bool = False, shard=None) -> torch.Tensor:
        """The conv3d path (JAX's XLA path): differentiable; train=True
        normalizes with batch statistics and moves the running ones."""
        x = volume.permute(0, 4, 1, 2, 3)
        c = self.convs
        conv0 = c[0](x, train, shard)
        conv2 = c[2](c[1](conv0, train, shard), train, shard)
        conv4 = c[4](c[3](conv2, train, shard), train, shard)
        x = c[6](c[5](conv4, train, shard), train, shard)
        x = conv4 + self.deconvs[0](x, train, shard)
        x = conv2 + self.deconvs[1](x, train, shard)
        x = conv0 + self.deconvs[2](x, train, shard)
        head = self.head(x) if shard is None else conv3d_slab(self.head, x, shard)
        return head[:, 0].float()

    @torch.no_grad()
    def packed(self, volume: torch.Tensor, shard=None) -> torch.Tensor:
        """The packed path (module docstring), running statistics folded in."""

        def conv(block, x, stride=1):
            sc, bias = _bn_fold(block.bn)
            return c3d(x, block.conv.weight * sc[:, None, None, None, None], bias, stride,
                       shard=shard)

        def up(block, x, skip):
            sc, bias = _bn_fold(block.bn)
            return d3dT(x, block.conv.weight * sc[None, :, None, None, None], bias, skip, shard)

        c = self.convs
        x = volume.float().contiguous()
        conv0 = conv(c[0], x)
        conv2 = conv(c[2], conv(c[1], conv0, 2))
        conv4 = conv(c[4], conv(c[3], conv2, 2))
        x = conv(c[6], conv(c[5], conv4, 2))
        x = up(self.deconvs[0], x, conv4)
        x = up(self.deconvs[1], x, conv2)
        x = up(self.deconvs[2], x, conv0)
        return c3d(x, self.head.weight.float(), None, relu=False, shard=shard)[..., 0]
