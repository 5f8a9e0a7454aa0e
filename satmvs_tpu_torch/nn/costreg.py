"""3-D cost-volume regularization U-Net of the CasMVSNet and UCSNet families.

Counterpart of `satmvs_tpu/nn/costreg.py`'s `CostRegNet`: three stride-2
3-D conv downsamples over (D, H, W), three transposed-conv upsamples with
skip additions, and a 1-channel logit head.  (B, D, H, W, C) volume →
(B, D, H, W) float32 logits; D, H and W must be divisible by 8.  Two paths
compute the same function:

  packed (fused None or True, no gradient recorded, train=False): JAX's
    `packed_costreg_forward` (costreg.py:57-160).  Inference BatchNorm folds
    into each conv's output channels and a bias (`_bn_fold`, fp32), and every
    3-D conv runs as three per-depth-tap 2-D convs of `ops/kernels`, summed
    t0, t1, t2 in JAX's order, then bias (and ReLU):

      conv3d s=1:  out[d]    = Σ_t conv2d(x[d+t−1], k[t])            conv_head
      conv3d s=2:  out[do]   = Σ_t conv2d(x[2do+t−1], k[t])          conv_dn, relu off
      convT3d s=2: out[2m]   = convT2d(x[m], k[1])                   deconv_up, relu off
                   out[2m+1] = convT2d(x[m+1], k[0]) + convT2d(x[m], k[2])

    (planes outside the volume are zero).  A tap is computed on the planes it
    reads and its output shifted along D, so no input is copied per tap.  The
    B elements' planes go through each tap in one call, (B·D, h, w, C): the
    kernels sum each output in one fixed order whatever the launch plan, so
    an element's logits are the bits of its B = 1 call.  CUDA tensors go to
    the CUDA kernels, CPU tensors to their plain versions.  Per forward:
    conv_head 15 calls (4 blocks and the head, 3 taps each), conv_dn 9,
    deconv_up 9, whatever B is.
  conv3d (fused=False, a gradient recorded, or train=True): the blocks as
    JAX's XLA path runs them, `F.conv3d` / `F.conv_transpose3d` with
    flax-semantics BatchNorm (`nn/blocks.py`); differentiable.

JAX's row packing, `split_cols` / `merge_cols` and the VMEM feasibility caps
(`packed_costreg_feasible`) are TPU layout workarounds and are not ported:
any shape the contract takes runs packed.

A compute dtype (`dtype`, JAX's `compute_dtype`, `satmvs_tpu/nn/costreg.py:
175-197`) reaches the conv3d path's blocks: each 3-D conv and transposed
conv computes in it (cuDNN in bf16 on the card), BatchNorm in float32, the
head in float32 as JAX's.  The packed forms are the port's own kernels for
what JAX computes as XLA convolutions, and they stay float32, so under a
compute dtype the CostRegNet always takes the conv3d path, as JAX runs
its bf16 XLA convolutions there.

Both paths also take this rank's slab of a volume sharded along D or H
(`shard`, a `dist.halo.Shard`; JAX's GSPMD partitions the same network
under a sharding constraint): each convolution joins its neighbours' halo
planes or rows (`dist.halo.halo_exchange`) and pads zeros only at the
global ends.  On the conv3d path that is `nn.blocks.conv3d_slab`; on the
packed path a depth halo is one more plane in the batch of planes a tap
takes, and a height halo joins rows to every plane, the kernel's output
rows that its own zero padding at the slab's edge produced cut off (two
rows before a stride-2 tap, so its rows keep the global parity).  The
launches per forward stay those of the whole volume.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..dist.halo import halo_exchange
from ..ops.kernels.plane_conv import conv_dn, conv_head, deconv_up
from .blocks import BatchNorm, ConvBlock, DeconvBlock, conv3d_slab

_BN_EPS = 1e-5  # flax nn.BatchNorm's default


def _bn_fold(bn: BatchNorm) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm as a per-channel affine (scale, bias) with
    bn(z) = z·scale + bias under the running statistics, in fp32."""
    sc = bn.weight * torch.rsqrt(bn.running_var + _BN_EPS)
    return sc, bn.bias - bn.running_mean * sc


def _planes(x: torch.Tensor) -> torch.Tensor:
    """(B, D, h, w, C) → (B·D, h, w, C), contiguous."""
    return x.reshape(-1, *x.shape[2:]).contiguous()


def _bias_relu(y: torch.Tensor, bias: torch.Tensor, relu: bool = True) -> torch.Tensor:
    y = y + bias
    return torch.relu(y) if relu else y


def c3d_s1(x: torch.Tensor, w3: torch.Tensor, bias: torch.Tensor | None,
           relu: bool = True) -> torch.Tensor:
    """Stride-1 3×3×3 conv, pad 1, of x (B, D, h, w, Cin) with w3 (Cout, Cin,
    3, 3, 3), then + bias and ReLU (bias None: neither) → (B, D, h, w,
    Cout): three `conv_head` calls with a zero bias; t0 + t1 + t2 in JAX's
    order, where plane d takes x[d − 1] through tap 0 and x[d + 1] through
    tap 2 (zero past the volume)."""
    b = x.shape[0]
    zb = w3.new_zeros(w3.shape[0])
    xp = _planes(x)
    t0, t1, t2 = (conv_head(xp, w3[:, :, k], zb) for k in range(3))
    t0, t1, t2 = (t.view(b, -1, *t.shape[1:]) for t in (t0, t1, t2))
    t1[:, 1:] += t0[:, :-1]
    t1[:, :-1] += t2[:, 1:]
    return t1 if bias is None else _bias_relu(t1, bias, relu)


def c3d_s2(x: torch.Tensor, w3: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Stride-2 3×3×3 conv, pad 1, of x (B, D, h, w, Cin), then + bias and
    ReLU → (B, D/2, h/2, w/2, Cout): out[do] takes x[2do − 1] (the odd plane
    before; zero at do = 0), x[2do] and x[2do + 1] through three `conv_dn`
    calls without their ReLU, summed t0 + t1 + t2."""
    b = x.shape[0]
    even, odd = _planes(x[:, 0::2]), _planes(x[:, 1::2])
    taps = [conv_dn(src, w3[:, :, k], relu=False) for k, src in enumerate((odd, even, odd))]
    t0, t1, t2 = (t.view(b, -1, *t.shape[1:]) for t in taps)
    t1[:, 1:] += t0[:, :-1]
    t1 += t2
    return _bias_relu(t1, bias)


def _d3dT_taps(x: torch.Tensor, wt3: torch.Tensor) -> torch.Tensor:
    b = x.shape[0]
    xp = _planes(x)
    u0, even, odd = (deconv_up(xp, wt3[:, :, k], relu=False) for k in range(3))
    u0, even, odd = (t.view(b, -1, *t.shape[1:]) for t in (u0, even, odd))
    odd[:, :-1] += u0[:, 1:]  # JAX's o1 + o2, added the other way round (exact)
    return torch.stack([even, odd], dim=2).view(b, -1, *even.shape[2:])


def d3dT(x: torch.Tensor, wt3: torch.Tensor, bias: torch.Tensor,
         skip: torch.Tensor) -> torch.Tensor:
    """ConvTranspose3d(k=3, s=2, p=1, op=1) of x (B, D, h, w, Cin) with wt3
    (Cin, Cout, 3, 3, 3), then + bias, ReLU and + skip → (B, 2D, 2h, 2w,
    Cout): three `deconv_up` calls without their ReLU, the even output planes
    from tap 1, the odd ones from tap 0 on the next input plane (zero past
    the last) plus tap 2."""
    return _bias_relu(_d3dT_taps(x, wt3), bias) + skip


# ---- the packed taps on a slab (module docstring): the same launches, the
# same sums in the same order as on the whole volume

def c3d_s1_slab(x: torch.Tensor, w3: torch.Tensor, bias: torch.Tensor | None, shard,
                relu: bool = True) -> torch.Tensor:
    """`c3d_s1` of this rank's slab x of a volume sharded along D or H."""
    if shard.axis == "spatial":
        y = c3d_s1(halo_exchange(x, 2, shard, 1, 1), w3, None)[:, :, 1:-1]
        return y if bias is None else _bias_relu(y, bias, relu)
    b = x.shape[0]
    zb = w3.new_zeros(w3.shape[0])
    xh = halo_exchange(x, 1, shard, 1, 1)
    t0, t1, t2 = (conv_head(_planes(src), w3[:, :, k], zb)
                  for k, src in enumerate((xh[:, :-2], x, xh[:, 2:])))
    t0, t1, t2 = (t.view(b, -1, *t.shape[1:]) for t in (t0, t1, t2))
    y = t1 + t0 + t2
    return y if bias is None else _bias_relu(y, bias, relu)


def c3d_s2_slab(x: torch.Tensor, w3: torch.Tensor, bias: torch.Tensor, shard) -> torch.Tensor:
    """`c3d_s2` of this rank's slab x (starting at an even plane or row)."""
    if shard.axis == "spatial":
        return c3d_s2(halo_exchange(x, 2, shard, 2, 0), w3, bias)[:, :, 1:]
    b, n = x.shape[:2]
    xh = halo_exchange(x, 1, shard, 1, 0)  # the odd plane before the slab first
    srcs = (xh[:, 0:n:2], x[:, 0::2], x[:, 1::2])
    t0, t1, t2 = (conv_dn(_planes(src), w3[:, :, k], relu=False) for k, src in enumerate(srcs))
    t0, t1, t2 = (t.view(b, -1, *t.shape[1:]) for t in (t0, t1, t2))
    return _bias_relu(t1 + t0 + t2, bias)


def d3dT_slab(x: torch.Tensor, wt3: torch.Tensor, bias: torch.Tensor, skip: torch.Tensor,
              shard) -> torch.Tensor:
    """`d3dT` of this rank's slab x; skip is the slab of the output."""
    if shard.axis == "spatial":
        n = x.shape[2]
        y = _d3dT_taps(halo_exchange(x, 2, shard, 0, 1), wt3)[:, :, :2 * n]
        return _bias_relu(y, bias) + skip
    b = x.shape[0]
    xh = halo_exchange(x, 1, shard, 0, 1)  # the next rank's first plane last
    even, odd, u0 = (deconv_up(_planes(src), wt3[:, :, k], relu=False)
                     for k, src in ((1, x), (2, x), (0, xh[:, 1:])))
    even, odd, u0 = (t.view(b, -1, *t.shape[1:]) for t in (even, odd, u0))
    odd += u0
    y = torch.stack([even, odd], dim=2).view(b, -1, *even.shape[2:])
    return _bias_relu(y, bias) + skip


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

        def conv_w(block):
            sc, bias = _bn_fold(block.bn)
            return block.conv.weight * sc[:, None, None, None, None], bias

        def deconv_w(block):
            sc, bias = _bn_fold(block.bn)
            return block.conv.weight * sc[None, :, None, None, None], bias

        if shard is None:
            s1, s2, up = c3d_s1, c3d_s2, d3dT
        else:
            def s1(x, w3, bias):
                return c3d_s1_slab(x, w3, bias, shard)

            def s2(x, w3, bias):
                return c3d_s2_slab(x, w3, bias, shard)

            def up(x, wt3, bias, skip):
                return d3dT_slab(x, wt3, bias, skip, shard)

        c = self.convs
        x = volume.float().contiguous()
        conv0 = s1(x, *conv_w(c[0]))
        conv2 = s1(s2(conv0, *conv_w(c[1])), *conv_w(c[2]))
        conv4 = s1(s2(conv2, *conv_w(c[3])), *conv_w(c[4]))
        x = s1(s2(conv4, *conv_w(c[5])), *conv_w(c[6]))
        x = up(x, *deconv_w(self.deconvs[0]), conv4)
        x = up(x, *deconv_w(self.deconvs[1]), conv2)
        x = up(x, *deconv_w(self.deconvs[2]), conv0)
        return s1(x, self.head.weight.float(), None)[..., 0]
