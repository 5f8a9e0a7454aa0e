"""Recurrent Encoder-Decoder (RED) cost regularization.

Counterpart of `satmvs_tpu/nn/red.py`'s `REDRegularizer` on both its paths.
`REDRegularizer(volume, fused=True)`, the default, is the fused pipeline,
as are `packed_red_pipeline(..., h0s=)` and `packed_red_pipeline_batched`
(red.py:182-301).  For a (B, D, H, W, C) volume and optional per-scale start
states:

  encode  neg = −volume;  c1, c2, c3 = conv_dn ×3 (stride 2 each), over all
          B·D planes at once
  recur   r1 .. r4 = red_recur on (neg, c1, c2, c3), fine → coarse: a
          ConvGRU per scale whose state runs across planes in hypothesis
          order, B independent recurrences in one call, each from its own
          start state
  decode  t2 = deconv_up(r4) + r3;  t1 = deconv_up(t2) + r2;
          hin = deconv_up(t1) + r1;  logits = conv_head(hin), over B·D planes

Each scale's last-plane state is handed back, so a volume cut into slabs
along D gives the same logits as the whole (the slab-streaming carry of
`infer/predict.py`).

Each step is a call of `ops/kernels` (a CUDA kernel for CUDA tensors, its
plain version for CPU tensors), so on the CPU this composition of plain
versions is the scan form of the same function.  Each is a
`torch.autograd.Function` whose backward is a CUDA kernel too (the JAX
custom VJPs, red.py:319-366, ops/pallas/plane_conv.py and red_recur.py), so
the pipeline is differentiable in the volume and every parameter: training
runs it, as the JAX package does on its accelerator.  The start states h0s
get no gradient (the seeded JAX recurrence has no VJP).

`REDRegularizer(volume, fused=False)` is the JAX scan path (red.py:368-390),
which JAX leaves to XLA and the port to torch built-ins (cuDNN convolutions
on the card, differentiable everywhere): the encoder over all B·D planes at
once, the four cells' input convolutions likewise, then plane by plane the
recurrences and the in-plane decoder, interleaved coarse → fine from zero
states.  H and W must be divisible by 8.

A compute dtype (`dtype`, JAX's `compute_dtype`) reaches the scan path as
JAX carries it (`satmvs_tpu/nn/red.py:60-75`, run through
`satmvs_tpu/nn/blocks.py:290-318`): the encoder convs, the decoder deconvs
and the head compute in it; the cells run float32, their input half too,
since JAX's scan calls the cells' concat form, whose bf16 input promotes
to float32 against the float32 state (the x-half's declared dtype acts
only at flax's init); the logits come back float32.  The fused pipeline
stays float32 whatever the dtype, as JAX keeps its Pallas kernels
(`satmvs_tpu/nn/red.py:199-204`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.kernels.plane_conv import conv_dn, conv_head, deconv_up
from ..ops.kernels.red_recur import red_recur
from .blocks import ConvBlock, ConvGRUCell, DeconvBlock, conv_in


class REDStep(nn.Module):
    """The layers of RED regularization (the flax `ScanREDStep_0`): the
    encoder convs, the four ConvGRU cells, the decoder deconvs and the head."""

    def __init__(self, in_channels: int, base_channels: int = 8, dtype=None):
        super().__init__()
        b = base_channels
        self.dtype = dtype

        def enc(cin, cout):
            return ConvBlock(cin, cout, 3, stride=2, norm="none", use_bias=False, dtype=dtype)

        def dec(cin, cout):
            return DeconvBlock(cin, cout, norm="none", use_bias=False, dtype=dtype)

        self.enc1 = enc(in_channels, 2 * b)
        self.enc2 = enc(2 * b, 4 * b)
        self.enc3 = enc(4 * b, 8 * b)
        self.gru4 = ConvGRUCell(8 * b, 8 * b)
        self.up3 = dec(8 * b, 4 * b)
        self.gru3 = ConvGRUCell(4 * b, 4 * b)
        self.up2 = dec(4 * b, 2 * b)
        self.gru2 = ConvGRUCell(2 * b, 2 * b)
        self.up1 = dec(2 * b, b)
        self.gru1 = ConvGRUCell(in_channels, b)
        self.head = nn.Conv2d(b, 1, 3, padding=1, bias=True)

    @property
    def grus(self) -> tuple[ConvGRUCell, ...]:
        """The cells fine → coarse (scales 1, 2, 4, 8)."""
        return self.gru1, self.gru2, self.gru3, self.gru4


class REDRegularizer(nn.Module):
    """(B, D, H, W, C) variance volume → (B, D, H, W) float32 logits; dtype:
    the scan path's compute dtype (module docstring)."""

    def __init__(self, in_channels: int, base_channels: int = 8, dtype=None):
        super().__init__()
        self.step = REDStep(in_channels, base_channels, dtype)

    def pipeline(self, volume: torch.Tensor, h0s=None):
        """(B, D, H, W, C) volume, start states h0s (None for zeros, or one
        (B, H/s, W/s, C_s) tensor per scale s = 1, 2, 4, 8) → logits
        (B, D, H, W) and each scale's last-plane state, contiguous (the next
        slab's h0s).  Differentiable in the volume and the parameters (H and
        W even at every scale under autograd), not in h0s."""
        s = self.step
        b, d = volume.shape[:2]
        neg = -volume.reshape(b * d, *volume.shape[2:])
        c1 = conv_dn(neg, s.enc1.conv.weight)
        c2 = conv_dn(c1, s.enc2.conv.weight)
        c3 = conv_dn(c2, s.enc3.conv.weight)
        rs, states = [], []
        for i, (x, cell) in enumerate(zip((neg, c1, c2, c3), s.grus)):
            r = red_recur(x.reshape(b, d, *x.shape[1:]), cell, None if h0s is None else h0s[i])
            rs.append(r.reshape(b * d, *r.shape[2:]))
            states.append(r[:, -1].contiguous())
        r1, r2, r3, r4 = rs
        t2 = deconv_up(r4, s.up3.conv.weight, r3)
        t1 = deconv_up(t2, s.up2.conv.weight, r2)
        hin = deconv_up(t1, s.up1.conv.weight, r1)
        logits = conv_head(hin, s.head.weight, s.head.bias)[..., 0]
        return logits.reshape(b, d, *logits.shape[1:]), tuple(states)

    def scan(self, volume: torch.Tensor) -> torch.Tensor:
        """(B, D, H, W, C) volume → (B, D, H, W) logits by the scan path."""
        s = self.step
        b, d, h, w, c = volume.shape
        neg = -volume.reshape(b * d, h, w, c).permute(0, 3, 1, 2)
        c1 = s.enc1(neg)
        c2 = s.enc2(c1)
        c3 = s.enc3(c2)
        xcs = [cell.x_contrib(x.float()).reshape(b, d, 3 * cell.features, *x.shape[2:])
               for cell, x in zip(s.grus, (neg, c1, c2, c3))]
        states = [x.new_zeros((b, cell.features, *x.shape[3:]))
                  for cell, x in zip(s.grus, xcs)]
        logits = []
        for k in range(d):
            s1, s2, s3, s4 = states
            s4 = s.gru4.recur(xcs[3][:, k], s4)
            u3 = s.up3(s4)
            s3 = s.gru3.recur(xcs[2][:, k], s3)
            u2 = s.up2(u3 + s3)
            s2 = s.gru2.recur(xcs[1][:, k], s2)
            u1 = s.up1(u2 + s2)
            s1 = s.gru1.recur(xcs[0][:, k], s1)
            logits.append(conv_in(s.head, u1 + s1, s.dtype)[:, 0])
            states = [s1, s2, s3, s4]
        return torch.stack(logits, dim=1).float()

    def forward(self, volume: torch.Tensor, fused: bool = True) -> torch.Tensor:
        """(B, D, H, W, C) volume → (B, D, H, W) logits: the fused pipeline,
        or the scan path with fused=False."""
        return self.pipeline(volume)[0] if fused else self.scan(volume)
