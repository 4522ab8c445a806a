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


# (kernel, stride) of each valid conv, per subsampling rate
RATE_CONVS = {2: [(3, 2), (3, 1)], 4: [(3, 2), (3, 2)], 6: [(3, 2), (5, 3)],
              8: [(3, 2), (3, 2), (3, 2)]}


class Conv2dSubsampling(nn.Module):
    """1/``rate`` subsampling (rate 4: two (k=3, s=2) convs) with ReLU,
    then a linear projection of the flattened (channel, freq') axis."""

    def __init__(self, idim: int, odim: int, rate: int = 4):
        super().__init__()
        self.convs = RATE_CONVS[rate]
        fdim = idim
        for i, (k, s) in enumerate(self.convs):
            self.add_module(f"conv{i}", nn.Conv2d(1 if i == 0 else odim,
                                                  odim, k, stride=s))
            fdim = sub_out_len(fdim, k, s)
        self.out = nn.Linear(odim * fdim, odim)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        """(B, T, F) -> (B, T', odim), lengths'."""
        h = x[:, None]
        olens = lengths
        for i, (k, s) in enumerate(self.convs):
            h = F.relu(getattr(self, f"conv{i}")(h))   # (B, C, T', F')
            olens = sub_out_len(olens, k, s)
        B, C, T, Fo = h.shape
        h = h.permute(0, 2, 1, 3).reshape(B, T, C * Fo)
        return self.out(h), torch.clamp(olens, min=0)
