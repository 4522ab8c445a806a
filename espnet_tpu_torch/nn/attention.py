"""Multi-head attention (counterpart of espnet_tpu/nn/attention.py).

``MultiHeadedAttention`` is the JAX package's module without its KV
cache. Given a band ``window`` (the Longformer encoder), it runs the banded
attention kernel (``ops/banded_attention.py``) unless attention dropout
acts, in training with a rate above 0: then, as in the JAX package's
dispatch, the softmax is written out under the caller's mask (which holds
the band) so that dropout can act on the probabilities. Without a window
it is plain torch matmuls, as the JAX package's einsum path.

In ``RelPositionMultiHeadedAttention`` position scores (Transformer-XL
terms b + d) become an additive bias of the fused attention; content
scores (a + c) are its q k^T. With attention dropout in training the
softmax is written out, so that dropout can act on the probabilities
(the JAX package's dispatch); otherwise the fused kernel runs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from espnet_tpu_torch.ops.attention import fused_attention
from espnet_tpu_torch.ops.banded_attention import banded_attention
from espnet_tpu_torch.utils.masks import attention_bias


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) -> (B, H, T, T) Transformer-XL relative shift."""
    B, H, T, P = x.shape
    x = F.pad(x, (1, 0)).reshape(B, H, P + 1, T)
    return x[:, :, 1:].reshape(B, H, T, P)[:, :, :, :T]


class MultiHeadedAttention(nn.Module):
    """Scaled dot-product attention over (B, T, D), heads split from D."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__()
        self.h, self.dk = n_head, n_feat // n_head
        self.dropout_rate = dropout_rate
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)

    def _split(self, x):
        B, T = x.shape[:2]
        return x.reshape(B, T, self.h, self.dk).transpose(1, 2)

    def qkv(self, query, key, value):
        """The projections, split into heads: (B, H, T, dk) each."""
        return (self._split(self.linear_q(query)),
                self._split(self.linear_k(key)),
                self._split(self.linear_v(value)))

    def forward(self, query, key, value, mask=None, window=None,
                valid=None):
        """mask: bool (B, Tq, Tk) or (B, 1, Tk), True = attend. A masked
        score is -1e9, so a row with no key softmaxes to uniform.

        window/valid: self-attention over a +-window band of the (B, T)
        valid keys, through the banded attention op; ``mask`` must then
        hold the same band for the dropout route."""
        q, k, v = self.qkv(query, key, value)
        dropout = self.training and self.dropout_rate > 0.0
        if window is not None and not dropout:
            out = banded_attention(q, k, v, window, valid,
                                   sm_scale=1.0 / math.sqrt(self.dk))
        else:
            scores = (q @ k.transpose(-1, -2)) / math.sqrt(self.dk)
            if mask is not None:
                scores = scores + attention_bias(mask[:, None])
            attn = torch.softmax(scores, dim=-1)
            if dropout:
                attn = F.dropout(attn, self.dropout_rate)
            out = attn @ v
        B, _, Tq, _ = out.shape
        return self.linear_out(out.transpose(1, 2).reshape(B, Tq, -1))


class RelPositionMultiHeadedAttention(nn.Module):

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__()
        self.h, self.dk = n_head, n_feat // n_head
        self.dropout_rate = dropout_rate
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)
        self.linear_pos = nn.Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, self.dk))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, self.dk))

    def _split(self, x):
        B, T = x.shape[:2]
        return x.reshape(B, T, self.h, self.dk).transpose(1, 2)

    def kernel_inputs(self, query, key, value, pos_emb, mask=None):
        """The fused attention's arguments: (q_u, k, v, bias, sm_scale)."""
        q = self._split(self.linear_q(query))
        k = self._split(self.linear_k(key))
        v = self._split(self.linear_v(value))
        p = self._split(self.linear_pos(pos_emb))       # (1, H, 2T-1, dk)
        q_u = q + self.pos_bias_u[None, :, None, :]
        q_v = q + self.pos_bias_v[None, :, None, :]
        sm_scale = 1.0 / math.sqrt(self.dk)
        bias = rel_shift(q_v @ p.transpose(-1, -2)) * sm_scale
        if mask is not None:
            bias = bias + attention_bias(mask[:, None])
        return q_u, k, v, bias, sm_scale

    def forward(self, query, key, value, pos_emb, mask=None):
        """query/key/value (B, T, D); pos_emb (1, 2T-1, D); mask (B, 1, T)
        bool, True = attend -> (B, T, D)."""
        q_u, k, v, bias, sm_scale = self.kernel_inputs(query, key, value,
                                                       pos_emb, mask)
        if self.training and self.dropout_rate > 0.0:
            scores = (q_u @ k.transpose(-1, -2)) * sm_scale + bias
            attn = F.dropout(torch.softmax(scores, dim=-1),
                             self.dropout_rate)
            out = attn @ v
        else:
            out = fused_attention(q_u, k, v, bias, sm_scale=sm_scale)
        B, _, T, _ = out.shape
        return self.linear_out(out.transpose(1, 2).reshape(B, T, -1))
