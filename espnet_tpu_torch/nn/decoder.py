"""Transformer decoder: the teacher-forced forward of training and the
cached one-step scoring of beam search (counterpart of
espnet_tpu/nn/decoder.py).

The decode state is a dict of fixed-size tensors: per-layer self-attention
KV caches (layers, rows, H, Lmax, dk) written at position ``step``, and
the encoder K/V of the cross-attention kept at utterance resolution
(layers, B, H, Tenc, dk) with rows = B * beam. Attention here is plain
torch: the JAX package runs no Pallas kernel in the decoder either. In
training, dropout acts on the attention probabilities (at the
``*_attention_dropout_rate``), inside the feed-forward, on each residual
branch and on the positional encoding.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from espnet_tpu_torch.nn.embedding import PositionalEncoding
from espnet_tpu_torch.nn.transformer import PositionwiseFeedForward
from espnet_tpu_torch.utils.masks import attention_bias, make_non_pad_mask

LN_EPS = 1e-6


class DecoderMHA(nn.Module):

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__()
        self.h, self.dk, self.d = n_head, n_feat // n_head, n_feat
        self.dropout = nn.Dropout(dropout_rate)
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)

    def _split(self, x):
        B, T = x.shape[:2]
        return x.reshape(B, T, self.h, self.dk).transpose(1, 2)

    def _attend(self, q, k, v, mask):
        """mask broadcasts to (B, H, Tq, Tk), True = attend."""
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(self.dk)
        scores = scores + attention_bias(mask)
        out = self.dropout(torch.softmax(scores, dim=-1)) @ v
        B, _, Tq, _ = out.shape
        return self.linear_out(out.transpose(1, 2).reshape(B, Tq, self.d))

    def forward(self, query, key, value, mask):
        """Full-sequence attention; mask (B, Tq, Tk) or (B, 1, Tk) bool,
        True = attend, the same for every head."""
        return self._attend(self._split(self.linear_q(query)),
                            self._split(self.linear_k(key)),
                            self._split(self.linear_v(value)), mask[:, None])

    def step(self, query, cache_k, cache_v, step: int, kv_mask):
        """query (rows, 1, D); caches (rows, H, Lmax, dk), written in place
        at ``step``; kv_mask (rows, Lmax) True = valid -> (rows, 1, D)."""
        cache_k[:, :, step] = self._split(self.linear_k(query))[:, :, 0]
        cache_v[:, :, step] = self._split(self.linear_v(query))[:, :, 0]
        q = self._split(self.linear_q(query))
        return self._attend(q, cache_k, cache_v, kv_mask[:, None, None, :])

    def cross(self, query, enc_k, enc_v, enc_mask):
        """query (rows, Tq, D) with rows = B * n against encoder K/V
        (B, H, Tenc, dk): the n hypotheses of an utterance fold into its
        query axis, so beam copies of the encoder K/V are never made."""
        rows, Tq, _ = query.shape
        B = enc_k.shape[0]
        n = rows // B
        q = self.linear_q(query).reshape(B, n * Tq, self.h, self.dk)
        out = self._attend(q.transpose(1, 2), enc_k, enc_v,
                           enc_mask[:, None, None, :])
        return out.reshape(rows, Tq, self.d)

    def encode_kv(self, memory):
        return (self._split(self.linear_k(memory)),
                self._split(self.linear_v(memory)))


class TransformerDecoderLayer(nn.Module):
    """Pre-norm self-attention, cross-attention and ReLU FFN."""

    def __init__(self, attention_heads: int, d_model: int,
                 linear_units: int, dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0):
        super().__init__()
        self.self_attn = DecoderMHA(attention_heads, d_model,
                                    self_attention_dropout_rate)
        self.src_attn = DecoderMHA(attention_heads, d_model,
                                   src_attention_dropout_rate)
        self.feed_forward = PositionwiseFeedForward(
            d_model, linear_units, dropout_rate=dropout_rate)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, tgt, tgt_mask, memory, memory_mask):
        drop = self.dropout
        h = self.norm1(tgt)
        x = tgt + drop(self.self_attn(h, h, h, tgt_mask))
        x = x + drop(self.src_attn(self.norm2(x), memory, memory,
                                   memory_mask))
        return x + drop(self.feed_forward(self.norm3(x)))

    def step(self, tgt, cache_k, cache_v, step: int, self_mask, enc_k,
             enc_v, enc_mask):
        x = tgt + self.self_attn.step(self.norm1(tgt), cache_k, cache_v,
                                      step, self_mask)
        x = x + self.src_attn.cross(self.norm2(x), enc_k, enc_v, enc_mask)
        return x + self.feed_forward(self.norm3(x))


class TransformerDecoder(nn.Module):

    def __init__(self, vocab_size: int, encoder_output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0):
        super().__init__()
        d = encoder_output_size
        self.d, self.h = d, attention_heads
        self.embed = nn.Embedding(vocab_size, d)
        self.pos_enc = PositionalEncoding(
            d, dropout_rate=positional_dropout_rate)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(attention_heads, d, linear_units,
                                    dropout_rate, self_attention_dropout_rate,
                                    src_attention_dropout_rate)
            for _ in range(num_blocks))
        self.after_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.output_layer = nn.Linear(d, vocab_size)

    def forward(self, memory, memory_lens, ys_in, ys_in_lens):
        """Teacher-forced forward: memory (B, Tenc, D), ys_in (B, L) ->
        logits (B, L, V). Position i attends to the valid positions
        <= i of ys_in and to the valid encoder frames."""
        L = ys_in.shape[1]
        causal = torch.ones(L, L, dtype=torch.bool,
                            device=ys_in.device).tril()
        tgt_mask = make_non_pad_mask(ys_in_lens, L)[:, None, :] & causal
        mem_mask = make_non_pad_mask(memory_lens, memory.shape[1])[:, None]
        x = self.pos_enc(self.embed(ys_in))
        for layer in self.layers:
            x = layer(x, tgt_mask, memory, mem_mask)
        return self.output_layer(self.after_norm(x))

    def init_state(self, memory, memory_lens, batch: int, maxlen: int):
        """Decode state for ``batch`` hypothesis rows over memory (B, Tenc,
        D) at utterance resolution, B dividing ``batch``."""
        shape = (len(self.layers), batch, self.h, maxlen, self.d // self.h)
        kv = [layer.src_attn.encode_kv(memory) for layer in self.layers]
        return {
            "cache_k": memory.new_zeros(shape),
            "cache_v": memory.new_zeros(shape),
            "enc_k": torch.stack([k for k, _ in kv]),
            "enc_v": torch.stack([v for _, v in kv]),
            "enc_mask": make_non_pad_mask(memory_lens, memory.shape[1]),
        }

    @staticmethod
    def select_state(state, idx):
        """Gather the self-attention caches by new-beam source rows. The
        encoder K/V stay: beam reordering never crosses an utterance."""
        return dict(state, cache_k=state["cache_k"][:, idx],
                    cache_v=state["cache_v"][:, idx])

    def score_step(self, token, step: int, state):
        """token (rows,) last tokens at position ``step`` -> (log-probs
        (rows, V), state). The caches are updated in place."""
        x = self.pos_enc(self.embed(token)[:, None, :], offset=step)
        maxlen = state["cache_k"].shape[3]
        self_mask = (torch.arange(maxlen, device=token.device) <= step
                     )[None].expand(token.shape[0], maxlen)
        for i, layer in enumerate(self.layers):
            x = layer.step(x, state["cache_k"][i], state["cache_v"][i], step,
                           self_mask, state["enc_k"][i], state["enc_v"][i],
                           state["enc_mask"])
        logits = self.output_layer(self.after_norm(x)[:, 0])
        return torch.log_softmax(logits, dim=-1), state
