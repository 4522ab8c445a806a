"""Multi-head attention (counterpart of espnet_tpu/nn/attention.py).

``MultiHeadedAttention`` is the JAX package's plain einsum path, with no
KV cache and no band window: it reaches no Pallas kernel there, and here
it stays torch matmuls.

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
from espnet_tpu_torch.utils.masks import attention_bias


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) -> (B, H, T, T) Transformer-XL relative shift."""
    B, H, T, P = x.shape
    x = F.pad(x, (1, 0)).reshape(B, H, P + 1, T)
    return x[:, :, 1:].reshape(B, H, T, P)[:, :, :, :T]


class MultiHeadedAttention(nn.Module):
    """Scaled dot-product attention over (B, T, D), heads split from D.
    Without attention dropout: no caller of the port sets it."""

    def __init__(self, n_head: int, n_feat: int):
        super().__init__()
        self.h, self.dk = n_head, n_feat // n_head
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)

    def _split(self, x):
        B, T = x.shape[:2]
        return x.reshape(B, T, self.h, self.dk).transpose(1, 2)

    def forward(self, query, key, value, mask=None):
        """mask: bool (B, Tq, Tk) or (B, 1, Tk), True = attend. A masked
        score is -1e9, so a row with no key softmaxes to uniform."""
        q = self._split(self.linear_q(query))
        k = self._split(self.linear_k(key))
        v = self._split(self.linear_v(value))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(self.dk)
        if mask is not None:
            scores = scores + attention_bias(mask[:, None])
        out = torch.softmax(scores, dim=-1) @ v
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
