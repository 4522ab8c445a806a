"""Convolutional subsampling (counterpart of espnet_tpu/nn/subsampling.py).

The JAX package's _PhaseConv2d writes a stride-2 VALID conv as shifted
strided-slice products for the TPU's sake; here it is the conv itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def sub_out_len(lengths, kernel: int, stride: int):
    """Length after one valid conv: floor((L - k) / s) + 1."""
    return (lengths - kernel + stride) // stride


class Conv2dSubsampling(nn.Module):
    """1/4-rate subsampling: two (k=3, s=2) convs with ReLU, then a linear
    projection of the flattened (channel, freq') axis."""

    def __init__(self, idim: int, odim: int):
        super().__init__()
        self.conv0 = nn.Conv2d(1, odim, 3, stride=2)
        self.conv1 = nn.Conv2d(odim, odim, 3, stride=2)
        fdim = sub_out_len(sub_out_len(idim, 3, 2), 3, 2)
        self.out = nn.Linear(odim * fdim, odim)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        """(B, T, F) -> (B, T', odim), lengths'."""
        h = F.relu(self.conv0(x[:, None]))
        h = F.relu(self.conv1(h))           # (B, C, T', F')
        B, C, T, Fo = h.shape
        h = h.permute(0, 2, 1, 3).reshape(B, T, C * Fo)
        olens = sub_out_len(sub_out_len(lengths, 3, 2), 3, 2)
        return self.out(h), torch.clamp(olens, min=0)
