"""Recurrent Encoder-Decoder (RED) cost regularization, the fused pipeline.

Counterpart of `satmvs_tpu/nn/red.py`'s `REDRegularizer` on its default path
(fused=True, `packed_red_pipeline` / `_packed_pipeline_body`, red.py:182-269),
one batch element at a time as red.py:362-366 does.  For the (D, H, W, C)
volume of one element:

  encode  neg = −volume;  c1, c2, c3 = conv_dn ×3 (stride 2 each)
  recur   r1 .. r4 = red_recur on (neg, c1, c2, c3), fine → coarse: a
          ConvGRU per scale whose state runs across planes in hypothesis order
  decode  t2 = deconv_up(r4) + r3;  t1 = deconv_up(t2) + r2;
          hin = deconv_up(t1) + r1;  logits = conv_head(hin)

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

    def pipeline(self, volume: torch.Tensor) -> torch.Tensor:
        """One batch element: (D, H, W, C) → (D, H, W) logits."""
        s = self.step
        neg = -volume
        c1 = conv_dn(neg, s.enc1.conv.weight)
        c2 = conv_dn(c1, s.enc2.conv.weight)
        c3 = conv_dn(c2, s.enc3.conv.weight)
        r1, r2, r3, r4 = (red_recur(x, g) for x, g in zip((neg, c1, c2, c3), s.grus))
        t2 = deconv_up(r4, s.up3.conv.weight, r3)
        t1 = deconv_up(t2, s.up2.conv.weight, r2)
        hin = deconv_up(t1, s.up1.conv.weight, r1)
        return conv_head(hin, s.head.weight, s.head.bias)[..., 0]

    def forward(self, volume: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.pipeline(v) for v in volume])
