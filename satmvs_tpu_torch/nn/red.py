"""Recurrent Encoder-Decoder (RED) cost regularization, the fused pipeline.

Counterpart of `satmvs_tpu/nn/red.py`'s `REDRegularizer` on its default path
(fused=True) and of its pipelines `packed_red_pipeline(..., h0s=)` and
`packed_red_pipeline_batched` (red.py:182-301).  For a (B, D, H, W, C)
volume and optional per-scale start states:

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
versions is the scan form of the same function.  H and W must be divisible
by 8.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.kernels.plane_conv import conv_dn, conv_head, deconv_up
from ..ops.kernels.red_recur import red_recur
from .blocks import ConvBlock, ConvGRUCell, DeconvBlock


class REDStep(nn.Module):
    """The layers of RED regularization (the flax `ScanREDStep_0`): the
    encoder convs, the four ConvGRU cells, the decoder deconvs and the head."""

    def __init__(self, in_channels: int, base_channels: int = 8):
        super().__init__()
        b = base_channels
        self.enc1 = ConvBlock(in_channels, 2 * b, 3, stride=2, norm="none", use_bias=False)
        self.enc2 = ConvBlock(2 * b, 4 * b, 3, stride=2, norm="none", use_bias=False)
        self.enc3 = ConvBlock(4 * b, 8 * b, 3, stride=2, norm="none", use_bias=False)
        self.gru4 = ConvGRUCell(8 * b, 8 * b)
        self.up3 = DeconvBlock(8 * b, 4 * b, norm="none", use_bias=False)
        self.gru3 = ConvGRUCell(4 * b, 4 * b)
        self.up2 = DeconvBlock(4 * b, 2 * b, norm="none", use_bias=False)
        self.gru2 = ConvGRUCell(2 * b, 2 * b)
        self.up1 = DeconvBlock(2 * b, b, norm="none", use_bias=False)
        self.gru1 = ConvGRUCell(in_channels, b)
        self.head = nn.Conv2d(b, 1, 3, padding=1, bias=True)

    @property
    def grus(self) -> tuple[ConvGRUCell, ...]:
        """The cells fine → coarse (scales 1, 2, 4, 8)."""
        return self.gru1, self.gru2, self.gru3, self.gru4


class REDRegularizer(nn.Module):
    """(B, D, H, W, C) variance volume → (B, D, H, W) float32 logits."""

    def __init__(self, in_channels: int, base_channels: int = 8):
        super().__init__()
        self.step = REDStep(in_channels, base_channels)

    def pipeline(self, volume: torch.Tensor, h0s=None):
        """(B, D, H, W, C) volume, start states h0s (None for zeros, or one
        (B, H/s, W/s, C_s) tensor per scale s = 1, 2, 4, 8) → logits
        (B, D, H, W) and each scale's last-plane state, contiguous (the next
        slab's h0s)."""
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

    def forward(self, volume: torch.Tensor) -> torch.Tensor:
        return self.pipeline(volume)[0]
