"""Conformer encoder (counterpart of espnet_tpu/nn/conformer.py).

Macaron FFN -> rel-pos MHSA -> conv module -> FFN, half-step residuals,
a LayerNorm after each block and after the stack. The conv module
normalises with LayerNorm, as the JAX package does (not BatchNorm).
LayerNorms use flax's epsilon, 1e-6. In training, dropout acts on each
sub-block's output before its residual add, inside the feed-forwards, and
on the positional encoding; Conv2dSubsampling has none, as in the JAX
package. The input layer is ``conv2d`` (Conv2dSubsampling x4) or
``linear`` (one Linear, the enhancement separator's: no norm, no
activation, as in the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from espnet_tpu_torch.nn.attention import RelPositionMultiHeadedAttention
from espnet_tpu_torch.nn.convolution import DepthwiseConv1d
from espnet_tpu_torch.nn.embedding import RelPositionalEncoding
from espnet_tpu_torch.nn.subsampling import Conv2dSubsampling
from espnet_tpu_torch.nn.transformer import PositionwiseFeedForward
from espnet_tpu_torch.utils.masks import make_non_pad_mask

LN_EPS = 1e-6


class ConvolutionModule(nn.Module):
    """pointwise -> GLU -> depthwise -> LayerNorm -> swish -> pointwise."""

    def __init__(self, channels: int, kernel_size: int = 31):
        super().__init__()
        self.pointwise_conv1 = nn.Linear(channels, 2 * channels)
        self.depthwise_conv = DepthwiseConv1d(channels, kernel_size)
        self.norm = nn.LayerNorm(channels, eps=LN_EPS)
        self.pointwise_conv2 = nn.Linear(channels, channels)

    def forward(self, x, valid_mask=None):
        """(B, T, D) -> (B, T, D); valid_mask (B, T) True = valid."""
        if valid_mask is not None:
            x = x.masked_fill(~valid_mask[:, :, None], 0.0)
        h = F.glu(self.pointwise_conv1(x), dim=-1)
        h = F.silu(self.norm(self.depthwise_conv(h)))
        h = self.pointwise_conv2(h)
        if valid_mask is not None:
            h = h.masked_fill(~valid_mask[:, :, None], 0.0)
        return h


class ConformerEncoderLayer(nn.Module):

    def __init__(self, attention_heads: int, d_model: int,
                 linear_units: int, cnn_kernel: int = 31,
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0):
        super().__init__()
        self.norm_ff_macaron = nn.LayerNorm(d_model, eps=LN_EPS)
        self.feed_forward_macaron = PositionwiseFeedForward(
            d_model, linear_units, "swish", dropout_rate)
        self.norm_mha = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = RelPositionMultiHeadedAttention(
            attention_heads, d_model, attention_dropout_rate)
        self.norm_conv = nn.LayerNorm(d_model, eps=LN_EPS)
        self.conv_module = ConvolutionModule(d_model, cnn_kernel)
        self.norm_ff = nn.LayerNorm(d_model, eps=LN_EPS)
        self.feed_forward = PositionwiseFeedForward(d_model, linear_units,
                                                    "swish", dropout_rate)
        self.norm_final = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x, pos_emb, mask, valid_mask):
        drop = self.dropout
        x = x + 0.5 * drop(self.feed_forward_macaron(
            self.norm_ff_macaron(x)))
        h = self.norm_mha(x)
        x = x + drop(self.self_attn(h, h, h, pos_emb, mask))
        x = x + drop(self.conv_module(self.norm_conv(x), valid_mask))
        x = x + 0.5 * drop(self.feed_forward(self.norm_ff(x)))
        return self.norm_final(x)


class ConformerEncoder(nn.Module):
    """input layer -> rel-pos encoding -> blocks -> LayerNorm."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, cnn_module_kernel: int = 31,
                 dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = "conv2d"):
        super().__init__()
        if input_layer == "conv2d":
            self.embed = Conv2dSubsampling(input_size, output_size)
        elif input_layer == "linear":
            self.embed = nn.Linear(input_size, output_size)
        else:
            raise NotImplementedError(f"input_layer {input_layer!r}: the "
                                      f"port has conv2d and linear")
        self.input_layer = input_layer
        self.pos_enc = RelPositionalEncoding(output_size,
                                             positional_dropout_rate)
        self.layers = nn.ModuleList(
            ConformerEncoderLayer(attention_heads, output_size, linear_units,
                                  cnn_module_kernel, dropout_rate,
                                  attention_dropout_rate)
            for _ in range(num_blocks))
        self.after_norm = nn.LayerNorm(output_size, eps=LN_EPS)

    def forward(self, xs: torch.Tensor, ilens: torch.Tensor):
        """(B, T, F) features -> (B, T', D), lengths (B,)."""
        if self.input_layer == "conv2d":
            xs, olens = self.embed(xs, ilens)
        else:
            xs, olens = self.embed(xs), ilens
        xs, pos_emb = self.pos_enc(xs)
        valid = make_non_pad_mask(olens, xs.shape[1])
        for layer in self.layers:
            xs = layer(xs, pos_emb, valid[:, None, :], valid)
        return self.after_norm(xs), olens
