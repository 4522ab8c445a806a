"""Positional encodings (counterpart of espnet_tpu/nn/embedding.py)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
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
    """x -> dropout(x * sqrt(d) + PE) at any length: the table is kept on
    x's device and rebuilt at least twice as long when a longer one is
    asked for, so a decoder stepping one position at a time rebuilds it
    a logarithmic number of times (a row depends on its position alone,
    so a longer table's first rows are a shorter one's)."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.dropout = nn.Dropout(dropout_rate)
        self._pe = None

    def _table(self, length: int, device) -> torch.Tensor:
        """The (length, d) table on ``device``."""
        pe = self._pe
        if pe is None or pe.shape[0] < length or pe.device != device:
            pe = torch.from_numpy(sinusoidal_table(
                max(length, 0 if pe is None else 2 * pe.shape[0]),
                self.d_model)).to(device)
            self._pe = pe
        return pe[:length]

    def forward(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """x (B, T, d) holds positions offset .. offset+T-1."""
        T = x.shape[1]
        pe = self._table(offset + T, x.device)[offset:]
        return self.dropout(x * math.sqrt(self.d_model) + pe)


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


class OneHotEmbedding(nn.Embedding):
    """An embedding looked up as one-hot rows times the table: the same
    numbers forward, and a gradient that is a matrix product, the same in
    every run. The CUDA backward of a gathered lookup is not: on batches
    of long transcripts (4 x ~930 tokens) two runs from one seed parted in
    this table alone."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.one_hot(ids.long(), self.num_embeddings).to(
            self.weight.dtype) @ self.weight
