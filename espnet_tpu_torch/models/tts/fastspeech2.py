"""The two pieces of FastSpeech2 that VITS serving uses (counterpart of
espnet_tpu/models/tts/fastspeech2.py): the variance (duration) predictor
and the length regulator. FastSpeech2 itself waits (ROADMAP A.5)."""

from __future__ import annotations

import torch
from torch import nn

from espnet_tpu_torch.nn.convolution import SameConv1d

LN_EPS = 1e-6


class VariancePredictor(nn.Module):
    """(B, L, D) -> (B, L): [SAME conv -> ReLU -> LayerNorm -> dropout] x
    layers, then a Dense to one value; 0 where not valid."""

    def __init__(self, in_channels: int, layers: int = 2, chans: int = 256,
                 kernel_size: int = 3, dropout_rate: float = 0.5):
        super().__init__()
        self.layers = layers
        for i in range(layers):   # flax's names: conv{i}, norm{i}
            self.add_module(f"conv{i}", SameConv1d(
                in_channels if i == 0 else chans, chans, kernel_size))
            self.add_module(f"norm{i}", nn.LayerNorm(chans, eps=LN_EPS))
        self.dropout = nn.Dropout(dropout_rate)
        self.linear = nn.Linear(chans, 1)

    def forward(self, x, valid_mask):
        h = x
        for i in range(self.layers):
            conv, norm = getattr(self, f"conv{i}"), getattr(self, f"norm{i}")
            h = torch.relu(conv(h.transpose(1, 2))).transpose(1, 2)
            h = self.dropout(norm(h))
        return self.linear(h)[..., 0].masked_fill(~valid_mask, 0.0)


def length_regulator(hs: torch.Tensor, durations: torch.Tensor,
                     out_len: int):
    """Expand token states (B, L, D) by integer durations (B, L) into
    (B, out_len, D): frame t takes the first token whose cumulative end
    passes t, and frames past the total are zeros. -> (frames, totals)."""
    L = hs.shape[1]
    ends = torch.cumsum(durations, dim=1)
    t = torch.arange(out_len, device=hs.device)[None, :, None]
    tok = (t >= ends[:, None, :]).sum(dim=2)
    frames = hs.gather(1, tok.clamp(max=L - 1)[..., None].expand(
        -1, -1, hs.shape[2]))
    return frames.masked_fill((tok >= L)[..., None], 0.0), ends[:, -1]
