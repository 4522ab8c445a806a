"""Transformer encoder (counterpart of espnet_tpu/nn/transformer.py): the
position-wise feed-forward, the encoder layer and the encoder.

The encoder embeds with ``conv2d`` (Conv2dSubsampling x4), ``linear``
(Dense -> LayerNorm -> dropout -> ReLU) or ``embed`` (a token embedding
of token-id inputs (B, T), as the VITS text encoder's, looked up as a
one-hot product so that its gradient repeats bit for bit), adds the
absolute positional encoding and runs N layers of self-attention and
feed-forward with residuals, normalised before (``normalize_before``,
then a LayerNorm after the stack) or after each sub-block. With
``attention_window`` (the Longformer encoder) each frame attends the
valid frames within +-window of it, through the banded attention kernel.
LayerNorms use flax's epsilon, 1e-6. In training, dropout acts inside the
feed-forward after the activation, on each sub-block's output before its
residual add, and on the positional encoding, at the JAX package's
places.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from espnet_tpu_torch.nn.attention import MultiHeadedAttention
from espnet_tpu_torch.nn.embedding import OneHotEmbedding, PositionalEncoding
from espnet_tpu_torch.nn.subsampling import Conv2dSubsampling
from espnet_tpu_torch.utils.masks import make_non_pad_mask

ACTIVATIONS = {"relu": F.relu, "swish": F.silu}
LN_EPS = 1e-6


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


class TransformerEncoderLayer(nn.Module):
    """Self-attention and feed-forward, each with a residual add."""

    def __init__(self, attention_heads: int, d_model: int,
                 linear_units: int, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 normalize_before: bool = True, adapter_dim: int = 0):
        super().__init__()
        if adapter_dim > 0:
            raise NotImplementedError("Houlsby adapters are not ported")
        self.normalize_before = normalize_before
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = MultiHeadedAttention(attention_heads, d_model,
                                              attention_dropout_rate)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.feed_forward = PositionwiseFeedForward(d_model, linear_units,
                                                    "relu", dropout_rate)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x, mask, window=None, valid=None):
        """x (B, T, D); mask (B, 1 or T, T) bool, True = attend; with
        ``window``, valid (B, T) and a mask that holds the band."""
        pre = self.normalize_before
        h = self.norm1(x) if pre else x
        x = x + self.dropout(self.self_attn(h, h, h, mask, window, valid))
        if not pre:
            x = self.norm1(x)
        h = self.norm2(x) if pre else x
        x = x + self.dropout(self.feed_forward(h))
        if not pre:
            x = self.norm2(x)
        return x


class TransformerEncoder(nn.Module):
    """embed -> positional encoding -> layers [-> LayerNorm]."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = "conv2d", normalize_before: bool = True,
                 interctc_layer_idx=(), adapter_dim: int = 0,
                 attention_window: Optional[int] = None):
        super().__init__()
        if interctc_layer_idx:
            raise NotImplementedError("intermediate CTC is not ported")
        if input_layer == "conv2d":
            self.embed = Conv2dSubsampling(input_size, output_size)
        elif input_layer == "linear":
            self.embed = nn.Linear(input_size, output_size)
            self.embed_norm = nn.LayerNorm(output_size, eps=LN_EPS)
            self.embed_dropout = nn.Dropout(dropout_rate)
        elif input_layer == "embed":
            self.embed = OneHotEmbedding(input_size, output_size)
        else:
            raise NotImplementedError(f"input_layer {input_layer!r}: the "
                                      f"port has conv2d, linear and embed")
        self.input_layer = input_layer
        self.pos_enc = PositionalEncoding(output_size,
                                          dropout_rate=positional_dropout_rate)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(attention_heads, output_size,
                                    linear_units, dropout_rate,
                                    attention_dropout_rate, normalize_before,
                                    adapter_dim)
            for _ in range(num_blocks))
        self.after_norm = (nn.LayerNorm(output_size, eps=LN_EPS)
                           if normalize_before else None)
        self.attention_window = attention_window

    def forward(self, xs: torch.Tensor, ilens: torch.Tensor):
        """(B, T, F) features, or (B, T) token ids with ``embed`` ->
        (B, T', D), lengths (B,)."""
        if self.input_layer == "conv2d":
            xs, olens = self.embed(xs, ilens)
        elif self.input_layer == "embed":
            xs, olens = self.embed(xs), ilens
        else:
            xs = F.relu(self.embed_dropout(self.embed_norm(self.embed(xs))))
            olens = ilens
        xs = self.pos_enc(xs)
        T = xs.shape[1]
        valid = make_non_pad_mask(olens, T)
        mask = valid[:, None, :]
        window = self.attention_window
        if window is not None:
            # the kernel takes (window, valid); the mask, with the band
            # folded in, serves the attention-dropout route
            pos = torch.arange(T, device=xs.device)
            mask = mask & ((pos[:, None] - pos[None, :]).abs()
                           <= window)[None]
        for layer in self.layers:
            xs = layer(xs, mask, window, valid)
        if self.after_norm is not None:
            xs = self.after_norm(xs)
        return xs, olens
