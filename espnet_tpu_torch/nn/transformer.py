"""Position-wise feed-forward (counterpart of
espnet_tpu/nn/transformer.py:PositionwiseFeedForward), with dropout after
the activation in training."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

ACTIVATIONS = {"relu": F.relu, "swish": F.silu}


class PositionwiseFeedForward(nn.Module):

    def __init__(self, d_model: int, hidden_units: int,
                 activation: str = "relu", dropout_rate: float = 0.1):
        super().__init__()
        self.w_1 = nn.Linear(d_model, hidden_units)
        self.w_2 = nn.Linear(hidden_units, d_model)
        self.act = ACTIVATIONS[activation]
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x):
        return self.w_2(self.dropout(self.act(self.w_1(x))))
