"""The HiFi-GAN generator (counterpart of espnet_tpu/models/tts/hifigan.py:
ResBlock, HiFiGANGenerator): conv_pre -> [leaky ReLU -> transposed-conv
upsampling -> the mean of the multi-receptive-field residual blocks] per
scale -> leaky ReLU -> conv_post -> tanh. Convolutions run channels-first
with flax's SAME alignment (nn/convolution.py); the public input is the
JAX package's (B, T, C). The discriminators and the GAN losses wait for
VITS training (ROADMAP A.5)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from espnet_tpu_torch.nn.convolution import SameConv1d, SameConvTranspose1d

SLOPE = 0.1


class ResBlock(nn.Module):
    """Dilated conv pairs with residuals, on (B, C, T)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):   # flax's names
            self.add_module(f"conv1_{i}", SameConv1d(
                channels, channels, kernel_size, dilation=d))
            self.add_module(f"conv2_{i}", SameConv1d(
                channels, channels, kernel_size))

    def forward(self, x):
        for i in range(self.n):
            h = getattr(self, f"conv1_{i}")(F.leaky_relu(x, SLOPE))
            x = x + getattr(self, f"conv2_{i}")(F.leaky_relu(h, SLOPE))
        return x


class HiFiGANGenerator(nn.Module):

    def __init__(self, in_channels: int = 80, out_channels: int = 1,
                 channels: int = 512, kernel_size: int = 7,
                 upsample_scales: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilations: Sequence[Sequence[int]] = (
                     (1, 3, 5),) * 3):
        super().__init__()
        self.n_up, self.n_res = len(upsample_scales), len(
            resblock_kernel_sizes)
        self.conv_pre = SameConv1d(in_channels, channels, kernel_size)
        ch = channels
        for i, (s, k) in enumerate(zip(upsample_scales,
                                       upsample_kernel_sizes)):
            self.add_module(f"upsample{i}",
                            SameConvTranspose1d(ch, ch // 2, k, s))
            ch //= 2
            for j, (rk, rd) in enumerate(zip(resblock_kernel_sizes,
                                             resblock_dilations)):
                self.add_module(f"resblock{i}_{j}", ResBlock(ch, rk, rd))
        self.conv_post = SameConv1d(ch, out_channels, kernel_size)

    def forward(self, mel):
        """mel (B, T, in_channels) -> wav (B, T * prod(scales))."""
        h = self.conv_pre(mel.transpose(1, 2))
        for i in range(self.n_up):
            h = getattr(self, f"upsample{i}")(F.leaky_relu(h, SLOPE))
            acc = getattr(self, f"resblock{i}_0")(h)
            for j in range(1, self.n_res):
                acc = acc + getattr(self, f"resblock{i}_{j}")(h)
            h = acc / self.n_res
        h = self.conv_post(F.leaky_relu(h, SLOPE))
        return torch.tanh(h)[:, 0]
