"""Streaming (chunked-causal) Conformer encoder (counterpart of
espnet_tpu/nn/streaming_encoder.py).

Training and full-utterance decoding run the whole utterance with a
chunked-causal attention mask: a frame attends to the frames of its own
chunk and of ``left_chunks`` chunks before it. The conv module pads on
the left only. The encoder takes an absolute ``PositionalEncoding`` and
plain ``MultiHeadedAttention``.

Streaming runs the same blocks one chunk at a time (``stream_step``),
with an explicit ``StreamingState``: each layer's last
``chunk_size * left_chunks`` post-macaron inputs (the attention context)
and its conv module's last kernel-1 GLU outputs, and per row the frames
done so far (the positional offset; rows of a session pool stand at
different offsets).
"""

from __future__ import annotations

import math
from typing import NamedTuple

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

# rows of the positional table a stream indexes; past its end the JAX
# package's gather clamps to the last row, and so does stream_step
STREAM_PE_ROWS = 8192
INPUT_RATES = {"conv2d": 4, "conv2d2": 2, "conv2d6": 6, "conv2d8": 8}


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

    def forward(self, x, valid_mask=None, tail=None):
        """(B, T, D) -> (B, T, D); valid_mask (B, T) True = valid. Given
        ``tail``, the (B, kernel-1, D) GLU outputs before x in place of
        the zeros, -> (out, new tail: the last kernel-1 of them)."""
        if valid_mask is not None:
            x = x.masked_fill(~valid_mask[:, :, None], 0.0)
        h = F.glu(self.pointwise_conv1(x), dim=-1)
        pad = self.kernel_size - 1
        if tail is None:
            h_ext = F.pad(h, (0, 0, pad, 0))
        else:
            h_ext = torch.cat([tail, h], dim=1)
        out = F.silu(self.norm(self.depthwise_conv(h_ext)))
        out = self.pointwise_conv2(out)
        if valid_mask is not None:
            out = out.masked_fill(~valid_mask[:, :, None], 0.0)
        if tail is None:
            return out
        return out, (h_ext[:, -pad:] if pad > 0 else tail)


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

    def step(self, x, ctx, conv_tail, kv_mask):
        """One chunk, no dropout: x (B, chunk, D); ctx (B, L_ctx, D) the
        earlier chunks' post-macaron inputs; conv_tail (B, kernel-1, D);
        kv_mask (B, L_ctx + chunk) bool, False on context slots not yet
        filled. -> (out, x after the macaron FFN (the next chunks'
        context), new conv tail). The conv module sees no valid mask: a
        final window's zero padding runs through it, as in the JAX
        package; the caller trims the outputs."""
        x = x + 0.5 * self.ff_macaron(self.norm_ff_macaron(x))
        kv = torch.cat([self.norm_mha(ctx), self.norm_mha(x)], dim=1)
        y = x + self.self_attn(kv[:, -x.shape[1]:], kv, kv,
                               kv_mask[:, None, :])
        h, new_tail = self.conv(self.norm_conv(y), None, conv_tail)
        y = y + h
        y = y + 0.5 * self.ff(self.norm_ff(y))
        return self.norm_final(y), x, new_tail


class StreamingState(NamedTuple):
    ctx: torch.Tensor           # (layers, B, L_ctx, D) attention context
    conv_tail: torch.Tensor     # (layers, B, kernel-1, D)
    frame_offset: torch.Tensor  # (B,) frames done per row; a scalar is
    # broadcast


class StreamingConformerEncoder(nn.Module):
    """Conv2dSubsampling (x2, x4, x6, x8; or a linear input layer) ->
    absolute positional encoding -> blocks under the chunked-causal mask
    -> LayerNorm."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 1024,
                 num_blocks: int = 6, chunk_size: int = 16,
                 left_chunks: int = 2, cnn_kernel: int = 15,
                 dropout_rate: float = 0.1, input_layer: str = "conv2d"):
        super().__init__()
        self.chunk_size, self.left_chunks = chunk_size, left_chunks
        self.output_size, self.num_blocks = output_size, num_blocks
        self.cnn_kernel = cnn_kernel
        rate = INPUT_RATES.get(input_layer)
        if rate is not None:
            self.embed = Conv2dSubsampling(input_size, output_size, rate)
        else:
            self.embed = None
            self.embed_lin = nn.Linear(input_size, output_size)
        self.pos_enc = PositionalEncoding(output_size,
                                          dropout_rate=dropout_rate)
        self.layers = nn.ModuleList(
            StreamingConformerLayer(attention_heads, output_size,
                                    linear_units, cnn_kernel, dropout_rate)
            for _ in range(num_blocks))
        self.after_norm = nn.LayerNorm(output_size, eps=LN_EPS)

    def forward(self, xs: torch.Tensor, ilens: torch.Tensor):
        """(B, T, F) features -> (B, T', D), lengths (B,)."""
        xs, olens = self._embed(xs, ilens)
        xs = self.pos_enc(xs)
        T = xs.shape[1]
        valid = make_non_pad_mask(olens, T)
        mask = (chunk_attention_mask(T, self.chunk_size, self.left_chunks,
                                     xs.device)[None] & valid[:, None, :])
        for layer in self.layers:
            xs = layer(xs, mask, valid)
        return self.after_norm(xs), olens

    def _embed(self, xs, ilens):
        if self.embed is not None:
            return self.embed(xs, ilens)
        return self.embed_lin(xs), ilens

    # -- streaming step API -----------------------------------------------
    def init_stream_state(self, batch: int, device=None,
                          dtype=torch.float32) -> StreamingState:
        """Zeros for ``batch`` rows, on ``device`` or the encoder's."""
        if device is None:
            device = self.after_norm.weight.device
        L_ctx = self.chunk_size * self.left_chunks
        D = self.output_size
        return StreamingState(
            ctx=torch.zeros(self.num_blocks, batch, L_ctx, D, device=device,
                            dtype=dtype),
            conv_tail=torch.zeros(self.num_blocks, batch,
                                  self.cnn_kernel - 1, D, device=device,
                                  dtype=dtype),
            frame_offset=torch.zeros(batch, dtype=torch.long,
                                     device=device))

    def stream_step(self, feats_chunk: torch.Tensor, state: StreamingState):
        """feats_chunk (B, window, F): one chunk's features before
        subsampling -> (enc_chunk (B, chunk, D), new state)."""
        B, W = feats_chunk.shape[:2]
        dev = feats_chunk.device
        xs, _ = self._embed(feats_chunk,
                            torch.full((B,), W, dtype=torch.long,
                                       device=dev))
        T, d = xs.shape[1], self.output_size
        off = torch.as_tensor(state.frame_offset, device=dev).long()
        off = off.expand(B) if off.dim() == 0 else off
        pe = self.pos_enc._table(STREAM_PE_ROWS, dev)
        rows = (off[:, None] + torch.arange(T, device=dev)).clamp(
            max=STREAM_PE_ROWS - 1)
        xs = xs * math.sqrt(d) + pe[rows]
        L_ctx = self.chunk_size * self.left_chunks
        # context slots fill from the right: the last min(offset, L_ctx)
        # hold earlier frames
        n_valid = off.clamp(max=L_ctx)
        kv_mask = torch.cat(
            [torch.arange(L_ctx, device=dev)[None, :]
             >= (L_ctx - n_valid)[:, None],
             torch.ones(B, T, dtype=torch.bool, device=dev)], dim=1)
        new_ctx, new_tail = [], []
        for i, layer in enumerate(self.layers):
            xs, entry, tail = layer.step(xs, state.ctx[i],
                                         state.conv_tail[i], kv_mask)
            new_ctx.append(torch.cat([state.ctx[i], entry],
                                     dim=1)[:, -L_ctx:])
            new_tail.append(tail)
        return self.after_norm(xs), StreamingState(
            ctx=torch.stack(new_ctx), conv_tail=torch.stack(new_tail),
            frame_offset=off + T)
