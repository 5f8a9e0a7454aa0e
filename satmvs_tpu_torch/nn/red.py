"""Recurrent Encoder-Decoder (RED) cost regularization, scan form.

Counterpart of `satmvs_tpu/nn/red.py` (`REDStep` and the scan path of
`REDRegularizer`, the path the JAX model takes with fused_red=False).  Per
depth plane: a 3-level stride-2 conv pyramid over the negated cost, a
ConvGRU at each of 4 scales whose state runs across planes in hypothesis
order (index 0 first), transposed-conv decoding with additive skips, and a
1-channel logit head.  H and W must be divisible by 8.

Only the GRU recurrences depend on the previous plane, so the encoder, the
GRUs' input convolutions and the decoder run once over all B·D planes; a
Python loop over D carries the four GRU states.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import ConvBlock, ConvGRUCell, DeconvBlock

SCALES = (1, 2, 4, 8)


def init_red_states(batch: int, height: int, width: int, base_channels: int = 8,
                    dtype=torch.float32, device=None) -> tuple[torch.Tensor, ...]:
    """Zero GRU states at scales 1, 2, 4, 8: (B, base·s, H/s, W/s) each (NCHW)."""
    return tuple(
        torch.zeros((batch, base_channels * s, height // s, width // s), dtype=dtype,
                    device=device)
        for s in SCALES
    )


class REDStep(nn.Module):
    """The layers of one depth plane of RED regularization, split into the
    parts the scan runs: `encode`, the cells' `recur`, `decode`."""

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

    def encode(self, cost: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """cost (N, C, H, W) → the GRU inputs (neg, c1, c2, c3), fine → coarse."""
        neg = -cost
        c1 = self.enc1(neg)
        c2 = self.enc2(c1)
        c3 = self.enc3(c2)
        return neg, c1, c2, c3

    def recur(self, states, xcs) -> tuple[torch.Tensor, ...]:
        """One plane: GRU states and the plane's input contributions
        (`ConvGRUCell.x_contrib`), fine → coarse → the new states."""
        return tuple(g.recur(xc, s) for g, xc, s in zip(self.grus, xcs, states))

    def decode(self, r1, r2, r3, r4) -> torch.Tensor:
        """GRU outputs fine → coarse → logits (N, H, W)."""
        u3 = self.up3(r4)
        u2 = self.up2(u3 + r3)
        u1 = self.up1(u2 + r2)
        return self.head(u1 + r1)[:, 0]


class REDRegularizer(nn.Module):
    """(B, D, H, W, C) variance volume → (B, D, H, W) float32 logits."""

    def __init__(self, in_channels: int, base_channels: int = 8):
        super().__init__()
        self.base_channels = base_channels
        self.step = REDStep(in_channels, base_channels)

    def forward(self, volume: torch.Tensor) -> torch.Tensor:
        batch, d, height, width, cin = volume.shape
        flat = volume.reshape(batch * d, height, width, cin).permute(0, 3, 1, 2)
        pyr = self.step.encode(flat)
        # x-halves of every cell for all planes at once: (B, D, 3C, h, w)
        xcs = [g.x_contrib(x).unflatten(0, (batch, d)) for g, x in zip(self.step.grus, pyr)]
        del pyr
        states = init_red_states(batch, height, width, self.base_channels,
                                 volume.dtype, volume.device)
        outs = [[] for _ in SCALES]
        for i in range(d):
            states = self.step.recur(states, [xc[:, i] for xc in xcs])
            for out, s in zip(outs, states):
                out.append(s)
        rs = [torch.stack(o, dim=1).flatten(0, 1) for o in outs]
        logits = self.step.decode(*rs)
        return logits.reshape(batch, d, height, width).to(torch.float32)
