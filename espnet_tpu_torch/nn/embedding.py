"""Positional encodings (counterpart of espnet_tpu/nn/embedding.py)."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def sinusoidal_table(length: int, d_model: int, centered: bool = False
                     ) -> np.ndarray:
    """(L, d) sin/cos table; ``centered`` gives positions L-1 .. -(L-1)
    (2L-1 rows) for relative attention."""
    if centered:
        pos = np.arange(length - 1, -length, -1.0)[:, None]
    else:
        pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(np.log(10000.0) / d_model))[None, :]
    pe = np.zeros((pos.shape[0], d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


class PositionalEncoding(nn.Module):
    """x -> dropout(x * sqrt(d) + PE), with the table kept for ``max_len``
    rows."""

    def __init__(self, d_model: int, max_len: int = 2048,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.register_buffer("pe", torch.from_numpy(
            sinusoidal_table(max_len, d_model)), persistent=False)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """x (B, T, d) holds positions offset .. offset+T-1."""
        T = x.shape[1]
        return self.dropout(x * math.sqrt(self.d_model)
                            + self.pe[offset:offset + T])


class RelPositionalEncoding(nn.Module):
    """x -> (dropout(x * sqrt(d)), dropout(centred (1, 2T-1, d) table)),
    two independent dropout masks."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor):
        pe = torch.from_numpy(sinusoidal_table(x.shape[1], self.d_model,
                                               centered=True))
        pe = pe[None].to(x.device, x.dtype)
        return (self.dropout(x * math.sqrt(self.d_model)),
                self.dropout(pe))
