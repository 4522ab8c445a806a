"""Language models (counterpart of espnet_tpu/models/lm.py): the
Transformer LM, its scorer protocol for shallow fusion in beam search,
and the ``LanguageModel`` wrapper's nll.

The scorer state is a dict of batch-first KV caches (rows, layers, H,
maxlen, dk), as the JAX LM keeps them, so that beam search reorders it
with one gather on axis 0. ``score_step`` writes the caches in place at
``step``. Attention is plain torch (``DecoderMHA``), as the JAX LM's is
an einsum that reaches no Pallas kernel.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from espnet_tpu_torch.nn.decoder import DecoderMHA
from espnet_tpu_torch.nn.embedding import sinusoidal_table
from espnet_tpu_torch.nn.transformer import PositionwiseFeedForward
from espnet_tpu_torch.utils.masks import make_non_pad_mask

LN_EPS = 1e-6
POS_TABLE_ROWS = 2048   # the JAX LM's positional table: positions < 2048


class CausalSelfAttnLayer(nn.Module):
    """Pre-norm causal self-attention and feed-forward, with the cached
    single-step path of decoding on the same parameters."""

    def __init__(self, head: int, d_model: int, units: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.self_attn = DecoderMHA(head, d_model)
        self.feed_forward = PositionwiseFeedForward(
            d_model, units, dropout_rate=dropout_rate)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop = nn.Dropout(dropout_rate)

    def forward(self, x, mask):
        h = self.norm1(x)
        x = x + self.drop(self.self_attn(h, h, h, mask))
        return x + self.drop(self.feed_forward(self.norm2(x)))

    def step(self, x, cache_k, cache_v, step: int, kv_mask):
        """x (rows, 1, D); caches (rows, H, maxlen, dk), written in place."""
        x = x + self.self_attn.step(self.norm1(x), cache_k, cache_v, step,
                                    kv_mask)
        return x + self.feed_forward(self.norm2(x))


class TransformerLM(nn.Module):

    def __init__(self, vocab_size: int, pos_enc: str = "sinusoidal",
                 embed_unit: int = 128, att_unit: int = 256, head: int = 2,
                 unit: int = 1024, layer: int = 4, dropout_rate: float = 0.5):
        super().__init__()
        if pos_enc != "sinusoidal":
            raise NotImplementedError(f"pos_enc {pos_enc!r}: the port has "
                                      f"sinusoidal")
        self.att_unit, self.head, self.n_layers = att_unit, head, layer
        self.embed = nn.Embedding(vocab_size, embed_unit)
        self.input_proj = nn.Linear(embed_unit, att_unit)
        self.layers = nn.ModuleList(
            CausalSelfAttnLayer(head, att_unit, unit, dropout_rate)
            for _ in range(layer))
        self.after_norm = nn.LayerNorm(att_unit, eps=LN_EPS)
        self.decoder = nn.Linear(att_unit, vocab_size)
        self.dropout = nn.Dropout(dropout_rate)
        self.register_buffer("pe", torch.from_numpy(
            sinusoidal_table(POS_TABLE_ROWS, att_unit)), persistent=False)

    def _embed_pos(self, tok, pos: int = 0):
        """tok (B,) at position ``pos`` or (B, L) from position 0."""
        x = self.input_proj(self.embed(tok)) * math.sqrt(self.att_unit)
        if x.dim() == 2:
            # the JAX LM's dynamic_slice clamps past the table's end
            return x + self.pe[min(pos, POS_TABLE_ROWS - 1)]
        return x + self.pe[:x.shape[1]]

    def forward(self, input_ids, lengths=None):
        """(B, L) -> (B, L, V) logits, causally masked."""
        L = input_ids.shape[1]
        x = self.dropout(self._embed_pos(input_ids))
        mask = torch.ones(L, L, dtype=torch.bool,
                          device=input_ids.device).tril()[None]
        if lengths is not None:
            mask = mask & make_non_pad_mask(lengths, L)[:, None, :]
        for layer in self.layers:
            x = layer(x, mask)
        return self.decoder(self.after_norm(x))

    # -- scorer protocol ----------------------------------------------
    def init_carry(self, batch: int, maxlen: int = 256, device=None):
        dk = self.att_unit // self.head
        shape = (batch, self.n_layers, self.head, maxlen, dk)
        w = self.decoder.weight
        return {"cache_k": w.new_zeros(shape, device=device),
                "cache_v": w.new_zeros(shape, device=device)}

    def score_step(self, token, step: int, state):
        """token (B,) at position ``step`` -> (log-probs (B, V), state);
        the caches are written in place."""
        x = self._embed_pos(token, step)[:, None, :]
        maxlen = state["cache_k"].shape[3]
        kv_mask = (torch.arange(maxlen, device=token.device) <= step
                   )[None].expand(token.shape[0], maxlen)
        for i, layer in enumerate(self.layers):
            x = layer.step(x, state["cache_k"][:, i], state["cache_v"][:, i],
                           step, kv_mask)
        logits = self.decoder(self.after_norm(x)[:, 0])
        return torch.log_softmax(logits, dim=-1), state

    @staticmethod
    def select_state(state, idx):
        return {"cache_k": state["cache_k"][idx],
                "cache_v": state["cache_v"][idx]}


class SequentialRNNLM(nn.Module):
    """Not ported yet: ROADMAP A.5 (the RNN LM)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SequentialRNNLM is not ported yet (ROADMAP A.5: the RNN LM)")


class HuggingFaceLM(nn.Module):
    """Not ported yet: ROADMAP A.5 (with the RNN LM)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "HuggingFaceLM is not ported yet (ROADMAP A.5: the RNN LM and "
            "HuggingFaceLM)")


LM_CLASSES = {"transformer": TransformerLM, "seq_rnn": SequentialRNNLM,
              "hugging_face": HuggingFaceLM}


class LanguageModel(nn.Module):
    """The ESPnet LM wrapper: nll of [sos, y...] -> [y..., eos]; the scorer
    protocol delegates to the LM. Its training loss waits for the LM
    trainer (ROADMAP A.5)."""

    def __init__(self, vocab_size: int, lm_type: str = "transformer",
                 lm_conf: dict = None):
        super().__init__()
        if lm_type not in LM_CLASSES:
            raise ValueError(lm_type)
        self.vocab_size = vocab_size
        self.lm = LM_CLASSES[lm_type](vocab_size, **dict(lm_conf or {}))

    @property
    def sos_eos(self) -> int:
        return self.vocab_size - 1

    def nll(self, text, text_lengths):
        """text (B, U), lengths (B,) -> (nll (B, U+1), valid (B, U+1),
        logits, targets), nll 0 where not valid."""
        B, U = text.shape
        dev = text.device
        sos = torch.full((B, 1), self.sos_eos, dtype=text.dtype, device=dev)
        valid = make_non_pad_mask(text_lengths, U)
        x = torch.cat([sos, torch.where(valid, text, 0)], dim=1)
        pos = torch.arange(U + 1, device=dev)[None, :]
        y_ext = torch.cat([text, text.new_zeros(B, 1)], dim=1)
        lens = text_lengths[:, None]
        t = torch.where(pos < lens, y_ext,
                        torch.where(pos == lens, self.sos_eos, 0))
        t_valid = pos <= lens
        logits = self.lm(x, text_lengths + 1)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, t[..., None].long())[..., 0]
        return nll.masked_fill(~t_valid, 0.0), t_valid, logits, t

    def init_carry(self, batch: int, maxlen: int = 256, device=None):
        return self.lm.init_carry(batch, maxlen, device)

    def score_step(self, token, step: int, state):
        return self.lm.score_step(token, step, state)

    def select_state(self, state, idx):
        return self.lm.select_state(state, idx)
