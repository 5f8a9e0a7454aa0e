"""Shared multi-scale feature encoder, unet mode.

Counterpart of `satmvs_tpu/nn/featurenet.py` (arch_mode="unet", 3 stages):
a stride-4 encoder (two stride-2 5×5 convs) and a unet decoder with outputs
of [4b, 2b, b] channels at 1/4, 1/2 and full resolution.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import ConvBlock, DeconvFuse


class FeatureNet(nn.Module):
    def __init__(self, base_channels: int = 8):
        super().__init__()
        b = base_channels
        self.conv0 = nn.Sequential(ConvBlock(3, b, 3), ConvBlock(b, b, 3))
        self.conv1 = nn.Sequential(ConvBlock(b, 2 * b, 5, stride=2),
                                   ConvBlock(2 * b, 2 * b, 3), ConvBlock(2 * b, 2 * b, 3))
        self.conv2 = nn.Sequential(ConvBlock(2 * b, 4 * b, 5, stride=2),
                                   ConvBlock(4 * b, 4 * b, 3), ConvBlock(4 * b, 4 * b, 3))
        self.out1 = nn.Conv2d(4 * b, 4 * b, 1, bias=False)
        self.deconv1 = DeconvFuse(4 * b, 2 * b, 2 * b)
        self.out2 = nn.Conv2d(2 * b, 2 * b, 1, bias=False)
        self.deconv2 = DeconvFuse(2 * b, b, b)
        self.out3 = nn.Conv2d(b, b, 1, bias=False)
        self.out_channels = [4 * b, 2 * b, b]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x (N, H, W, 3) → [(N, H/4, W/4, 4b), (N, H/2, W/2, 2b), (N, H, W, b)],
        coarsest first, each channels-last and contiguous."""
        x = x.permute(0, 3, 1, 2)
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        outs = [self.out1(conv2)]
        intra = self.deconv1(conv1, conv2)
        outs.append(self.out2(intra))
        intra = self.deconv2(conv0, intra)
        outs.append(self.out3(intra))
        return [o.permute(0, 2, 3, 1).contiguous() for o in outs]
