"""Depthwise 1-D convolution (counterpart of
espnet_tpu/nn/convolution.py:DepthwiseConv1d, stride 1, SAME padding)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class DepthwiseConv1d(nn.Module):
    """(B, T, C) -> (B, T, C): a grouped Conv1d with weight (C, 1, K),
    padded (K-1)//2 on the left and the rest on the right."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels))
        span = kernel_size - 1
        self.pad = (span // 2, span - span // 2)

    def forward(self, x):
        h = F.pad(x.transpose(1, 2), self.pad)
        y = F.conv1d(h, self.weight, self.bias, groups=self.weight.shape[0])
        return y.transpose(1, 2)
