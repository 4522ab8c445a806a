"""Depthwise 1-D convolution (counterpart of
espnet_tpu/nn/convolution.py:DepthwiseConv1d, stride 1, SAME or VALID
padding, any kernel dilation), and flax's pointwise convolution."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class DepthwiseConv1d(nn.Module):
    """(B, T, C) -> (B, T', C): a grouped Conv1d with weight (C, 1, K),
    its taps ``dilation`` samples apart (span = dilation (K - 1)). "SAME"
    pads span // 2 on the left and the rest on the right (T' = T);
    "VALID" pads nothing (T' = T - span)."""

    def __init__(self, channels: int, kernel_size: int,
                 padding: str = "SAME", dilation: int = 1):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise NotImplementedError(f"padding {padding!r}: the port has "
                                      f"SAME and VALID")
        self.weight = nn.Parameter(torch.zeros(channels, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.dilation = dilation
        span = dilation * (kernel_size - 1)
        self.pad = ((span // 2, span - span // 2) if padding == "SAME"
                    else (0, 0))

    def forward(self, x):
        h = F.pad(x.transpose(1, 2), self.pad)
        y = F.conv1d(h, self.weight, self.bias, dilation=self.dilation,
                     groups=self.weight.shape[0])
        return y.transpose(1, 2)


class Pointwise(nn.Linear):
    """flax ``nn.Conv(out, (1,))`` on (B, T, in): a product with the
    kernel, which is (1, in, out) in the flax tree and a Linear weight
    (out, in) here."""
