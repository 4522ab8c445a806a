"""Streaming (chunked-causal) Conformer encoder, full-utterance path
(counterpart of espnet_tpu/nn/streaming_encoder.py).

Training and full-utterance decoding run the whole utterance with a
chunked-causal attention mask: a frame attends to the frames of its own
chunk and of ``left_chunks`` chunks before it. The conv module pads on
the left only. The encoder takes an absolute ``PositionalEncoding`` and
plain ``MultiHeadedAttention``. Chunk-by-chunk streaming (``step``,
``init_stream_state``, ``stream_step``) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from espnet_tpu_torch.nn.attention import MultiHeadedAttention
from espnet_tpu_torch.nn.conformer import LN_EPS
from espnet_tpu_torch.nn.convolution import DepthwiseConv1d
from espnet_tpu_torch.nn.embedding import PositionalEncoding
from espnet_tpu_torch.nn.subsampling import Conv2dSubsampling
from espnet_tpu_torch.nn.transformer import PositionwiseFeedForward
from espnet_tpu_torch.utils.masks import make_non_pad_mask


def chunk_attention_mask(T: int, chunk: int, left_chunks: int,
                         device=None) -> torch.Tensor:
    """(T, T) bool: query q attends key k iff k's chunk is q's or one of
    the ``left_chunks`` chunks before it."""
    q = torch.arange(T, device=device)[:, None] // chunk
    k = torch.arange(T, device=device)[None, :] // chunk
    return (k <= q) & (k >= q - left_chunks)


class CausalConvModule(nn.Module):
    """pointwise -> GLU -> (kernel-1 zeros on the left) VALID depthwise ->
    LayerNorm -> swish -> pointwise."""

    def __init__(self, channels: int, kernel_size: int = 15):
        super().__init__()
        self.pointwise_conv1 = nn.Linear(channels, 2 * channels)
        self.depthwise_conv = DepthwiseConv1d(channels, kernel_size,
                                              padding="VALID")
        self.norm = nn.LayerNorm(channels, eps=LN_EPS)
        self.pointwise_conv2 = nn.Linear(channels, channels)
        self.kernel_size = kernel_size

    def forward(self, x, valid_mask=None):
        """(B, T, D) -> (B, T, D); valid_mask (B, T) True = valid."""
        if valid_mask is not None:
            x = x.masked_fill(~valid_mask[:, :, None], 0.0)
        h = F.glu(self.pointwise_conv1(x), dim=-1)
        h = F.pad(h, (0, 0, self.kernel_size - 1, 0))
        h = F.silu(self.norm(self.depthwise_conv(h)))
        h = self.pointwise_conv2(h)
        if valid_mask is not None:
            h = h.masked_fill(~valid_mask[:, :, None], 0.0)
        return h


class StreamingConformerLayer(nn.Module):
    """Macaron FFN -> MHSA under the chunk mask -> causal conv -> FFN,
    half-step residuals, a LayerNorm at the end; in training, dropout on
    each sub-block's output before its residual add."""

    def __init__(self, attention_heads: int, d_model: int,
                 linear_units: int, cnn_kernel: int = 15,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.ff_macaron = PositionwiseFeedForward(d_model, linear_units,
                                                  "swish", dropout_rate)
        self.self_attn = MultiHeadedAttention(attention_heads, d_model)
        self.conv = CausalConvModule(d_model, cnn_kernel)
        self.ff = PositionwiseFeedForward(d_model, linear_units, "swish",
                                          dropout_rate)
        self.norm_ff_macaron = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm_mha = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm_conv = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm_ff = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm_final = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop = nn.Dropout(dropout_rate)

    def forward(self, x, attn_mask, valid_mask):
        """x (B, T, D); attn_mask (B, T, T) bool; valid_mask (B, T)."""
        drop = self.drop
        x = x + 0.5 * drop(self.ff_macaron(self.norm_ff_macaron(x)))
        h = self.norm_mha(x)
        x = x + drop(self.self_attn(h, h, h, attn_mask))
        x = x + drop(self.conv(self.norm_conv(x), valid_mask))
        x = x + 0.5 * drop(self.ff(self.norm_ff(x)))
        return self.norm_final(x)


class StreamingConformerEncoder(nn.Module):
    """Conv2dSubsampling x4 -> absolute positional encoding -> blocks under
    the chunked-causal mask -> LayerNorm."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 1024,
                 num_blocks: int = 6, chunk_size: int = 16,
                 left_chunks: int = 2, cnn_kernel: int = 15,
                 dropout_rate: float = 0.1, input_layer: str = "conv2d"):
        super().__init__()
        if input_layer != "conv2d":
            raise NotImplementedError(f"input_layer {input_layer!r}: the "
                                      f"port has conv2d")
        self.chunk_size, self.left_chunks = chunk_size, left_chunks
        self.embed = Conv2dSubsampling(input_size, output_size)
        self.pos_enc = PositionalEncoding(output_size,
                                          dropout_rate=dropout_rate)
        self.layers = nn.ModuleList(
            StreamingConformerLayer(attention_heads, output_size,
                                    linear_units, cnn_kernel, dropout_rate)
            for _ in range(num_blocks))
        self.after_norm = nn.LayerNorm(output_size, eps=LN_EPS)

    def forward(self, xs: torch.Tensor, ilens: torch.Tensor):
        """(B, T, F) features -> (B, T', D), lengths (B,)."""
        xs, olens = self.embed(xs, ilens)
        xs = self.pos_enc(xs)
        T = xs.shape[1]
        valid = make_non_pad_mask(olens, T)
        mask = (chunk_attention_mask(T, self.chunk_size, self.left_chunks,
                                     xs.device)[None] & valid[:, None, :])
        for layer in self.layers:
            xs = layer(xs, mask, valid)
        return self.after_norm(xs), olens
