"""Shared multi-scale feature encoder, unet or fpn decoder.

Counterpart of `satmvs_tpu/nn/featurenet.py`: a stride-4 encoder
(two stride-2 5×5 convs) and a decoder with outputs of [4b, 2b, b] channels
at 1/4, 1/2 and full resolution.  arch_mode "unet" (CascadeREDNet, UCSNet):
transposed-conv decoder steps with skip concatenation and 1×1 outputs;
"fpn" (CascadeMVSNet): nearest ×2 upsampling plus a 1×1 lateral conv (with
bias) of the encoder's skip, and 3×3 output heads.  dtype: every
convolution's compute dtype (None: float32; torch.bfloat16 as flax's
`dtype`, `nn/blocks.py`); the parameters and the returned maps stay
float32.  num_stage: 3, or 1 for the encoder and the 1/4-resolution head
alone (JAX returns there, `satmvs_tpu/nn/featurenet.py:49-50`; the decoder
is not built, so the module holds exactly the flax tree's leaves).  Two
stages raise: JAX's second map is at 1/2 resolution, where
`STAGE_SCALES[2]` puts the second stage at full resolution.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import ConvBlock, DeconvFuse, conv_in


def check_stage_count(num_stage: int) -> None:
    """Raise unless the cascade has 1 or 3 stages (the counts JAX computes)."""
    if num_stage == 2:
        raise ValueError("a two-stage cascade: FeatureNet's second map is at 1/2 resolution, "
                         "but STAGE_SCALES[2] = (4, 1) puts stage 2 at full resolution (JAX "
                         "fails on the shapes); use 1 or 3 stages")
    if num_stage not in (1, 3):
        raise ValueError(f"a {num_stage}-stage cascade: the port runs 1 or 3 stages, as JAX "
                         f"does (STAGE_SCALES)")


class FeatureNet(nn.Module):
    def __init__(self, base_channels: int = 8, arch_mode: str = "unet", dtype=None,
                 num_stage: int = 3):
        super().__init__()
        if arch_mode not in ("unet", "fpn"):
            raise ValueError(f"FeatureNet: arch_mode {arch_mode!r} is not 'unet' or 'fpn'")
        check_stage_count(num_stage)
        b = base_channels
        self.arch_mode, self.dtype, self.num_stage = arch_mode, dtype, num_stage
        self.conv0 = nn.Sequential(ConvBlock(3, b, 3, dtype=dtype),
                                   ConvBlock(b, b, 3, dtype=dtype))
        self.conv1 = nn.Sequential(ConvBlock(b, 2 * b, 5, stride=2, dtype=dtype),
                                   ConvBlock(2 * b, 2 * b, 3, dtype=dtype),
                                   ConvBlock(2 * b, 2 * b, 3, dtype=dtype))
        self.conv2 = nn.Sequential(ConvBlock(2 * b, 4 * b, 5, stride=2, dtype=dtype),
                                   ConvBlock(4 * b, 4 * b, 3, dtype=dtype),
                                   ConvBlock(4 * b, 4 * b, 3, dtype=dtype))
        self.out1 = nn.Conv2d(4 * b, 4 * b, 1, bias=False)
        self.out_channels = [4 * b, 2 * b, b][:num_stage]
        if num_stage == 1:
            return
        if arch_mode == "unet":
            self.deconv1 = DeconvFuse(4 * b, 2 * b, 2 * b, dtype)
            self.out2 = nn.Conv2d(2 * b, 2 * b, 1, bias=False)
            self.deconv2 = DeconvFuse(2 * b, b, b, dtype)
            self.out3 = nn.Conv2d(b, b, 1, bias=False)
        else:
            self.inner1 = nn.Conv2d(2 * b, 4 * b, 1, bias=True)
            self.out2 = nn.Conv2d(4 * b, 2 * b, 3, padding=1, bias=False)
            self.inner2 = nn.Conv2d(b, 4 * b, 1, bias=True)
            self.out3 = nn.Conv2d(4 * b, b, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> list[torch.Tensor]:
        """x (N, H, W, 3) → [(N, H/4, W/4, 4b), (N, H/2, W/2, 2b), (N, H, W, b)],
        coarsest first, each channels-last and contiguous (the first alone at
        one stage).  train: the BatchNorms normalize with batch statistics
        and update their running ones (flax's `train`)."""

        def run(blocks, t):
            for block in blocks:
                t = block(t, train)
            return t

        def conv(layer, t):
            return conv_in(layer, t, self.dtype)

        conv0 = run(self.conv0, x.permute(0, 3, 1, 2))
        conv1 = run(self.conv1, conv0)
        conv2 = run(self.conv2, conv1)
        outs = [conv(self.out1, conv2)]
        if self.num_stage == 3 and self.arch_mode == "unet":
            intra = self.deconv1(conv1, conv2, train)
            outs.append(conv(self.out2, intra))
            intra = self.deconv2(conv0, intra, train)
            outs.append(conv(self.out3, intra))
        elif self.num_stage == 3:
            # nearest ×2 (jax.image.resize "nearest": output i reads input i // 2)
            intra = F.interpolate(conv2, scale_factor=2, mode="nearest") + conv(self.inner1, conv1)
            outs.append(conv(self.out2, intra))
            intra = F.interpolate(intra, scale_factor=2, mode="nearest") + conv(self.inner2, conv0)
            outs.append(conv(self.out3, intra))
        return [o.float().permute(0, 2, 3, 1).contiguous() for o in outs]
