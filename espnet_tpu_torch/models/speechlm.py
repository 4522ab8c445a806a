"""Speech language model: a causal LM over multi-stream discrete tokens
(counterpart of espnet_tpu/models/speechlm.py).

Per-stream embeddings are summed into one causal Transformer of
``models/lm.py:CausalSelfAttnLayer`` blocks; per-stream heads predict
the next frame's ids. ``generate_scan`` is the JAX package's KV-cached
loop over positions: the prompt is teacher-forced while t + 1 < its
length, then each stream samples its next id (top-k, temperature; a
temperature of 0 or less is greedy) from an explicit torch.Generator,
and a row that samples ``eos_id`` in stream 0 freezes at eos. The
embeddings are one-hot products (``OneHotEmbedding``), whose gradient
repeats itself on the card. Attention
is the plain product of ``nn/decoder.py:DecoderMHA``, as the JAX
package's is an einsum that reaches no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from espnet_tpu_torch.models.lm import LN_EPS, CausalSelfAttnLayer
from espnet_tpu_torch.nn.embedding import OneHotEmbedding, sinusoidal_table
from espnet_tpu_torch.utils.masks import make_non_pad_mask


class SpeechLM(nn.Module):

    def __init__(self, vocab_sizes: Sequence[int], d_model: int = 256,
                 heads: int = 4, units: int = 1024, layers: int = 4,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.d_model, self.heads = d_model, heads
        for i, v in enumerate(self.vocab_sizes):
            self.add_module(f"embed{i}", OneHotEmbedding(v, d_model))
        self.layers = nn.ModuleList(
            CausalSelfAttnLayer(heads, d_model, units, dropout_rate)
            for _ in range(layers))
        self.after_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        for i, v in enumerate(self.vocab_sizes):
            self.add_module(f"head{i}", nn.Linear(d_model, v))
        self.dropout = nn.Dropout(dropout_rate)

    @property
    def n_streams(self) -> int:
        return len(self.vocab_sizes)

    def _head(self, i: int) -> nn.Linear:
        return getattr(self, f"head{i}")

    def _embed_frame(self, frame):
        """(..., Q) ids -> (..., D): the summed stream embeddings times
        sqrt(d_model), without the position."""
        x = sum(getattr(self, f"embed{i}")(frame[..., i])
                for i in range(self.n_streams))
        return x * math.sqrt(self.d_model)

    def _pe(self, n: int, device):
        return torch.from_numpy(sinusoidal_table(n, self.d_model)).to(device)

    def trunk(self, tokens, lengths):
        """(B, T, Q), (B,) or None -> (B, T, D), causally masked."""
        B, T, _ = tokens.shape
        x = self._embed_frame(tokens) + self._pe(T, tokens.device)[None]
        x = self.dropout(x)
        mask = torch.ones(T, T, dtype=torch.bool,
                          device=tokens.device).tril()[None]
        if lengths is not None:
            mask = mask & make_non_pad_mask(lengths, T)[:, None, :]
        for layer in self.layers:
            x = layer(x, mask)
        return self.after_norm(x)

    def forward(self, tokens, token_lengths=None, tokens_lengths=None,
                loss_mask=None, loss_mask_lengths=None,
                generator: Optional[torch.Generator] = None):
        """tokens (B, T, Q), frame 0 a bos frame: position t predicts
        frame t + 1, scored where t + 1 < length and, with ``loss_mask``
        (B, T), where the target position's mask is on. -> (mean over
        streams of each stream's mean nll, {loss, ppl, acc}, B)."""
        if token_lengths is None:
            token_lengths = tokens_lengths
        B, T, _ = tokens.shape
        h = self.trunk(tokens[:, :-1], token_lengths - 1)
        valid = make_non_pad_mask(token_lengths - 1, T - 1)
        if loss_mask is not None:
            valid = valid & (loss_mask[:, 1:] > 0)
        n = torch.clamp(valid.sum(), min=1)
        total, accs = h.new_zeros(()), []
        for i in range(self.n_streams):
            logits = self._head(i)(h)
            logp = torch.log_softmax(logits.float(), dim=-1)
            tgt = tokens[:, 1:, i].long()
            nll = -logp.gather(-1, tgt[..., None])[..., 0]
            total = total + torch.where(valid, nll, 0.0).sum() / n
            accs.append(torch.where(valid, logits.argmax(-1) == tgt,
                                    False).sum() / n)
        loss = total / self.n_streams
        return loss, {"loss": loss, "ppl": torch.exp(loss),
                      "acc": torch.stack(accs).mean()}, float(B)

    @torch.no_grad()
    def generate(self, prompt, prompt_lengths, steps: int,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0):
        """Sampled continuation by re-encoding the whole sequence each
        step: (B, Tp, Q) -> (B, Tp + steps, Q)."""
        tokens, lens = prompt, prompt_lengths
        rows = torch.arange(prompt.shape[0], device=prompt.device)
        for _ in range(steps):
            h = self.trunk(tokens, lens)[rows, torch.clamp(lens - 1, min=0)]
            nxt = torch.stack([torch.multinomial(
                torch.softmax(self._head(i)(h) / temperature, dim=-1), 1,
                generator=generator)[:, 0]
                for i in range(self.n_streams)], dim=-1)
            tokens = torch.cat([tokens, nxt[:, None].to(tokens.dtype)], 1)
            lens = lens + 1
        return tokens

    @torch.no_grad()
    def generate_scan(self, prompt, prompt_lengths, steps: int,
                      generator: Optional[torch.Generator] = None,
                      temperature: float = 1.0, topk: int = 0,
                      eos_id: int = -1):
        """prompt (B, Tp, Q), lengths (B,) -> (tokens (B, Tp + steps, Q),
        lengths (B,): frames up to and with the first eos past the
        prompt, else Tp + steps)."""
        B, Tp, Q = prompt.shape
        dev = prompt.device
        Tmax = Tp + steps
        dk = self.d_model // self.heads
        w = self.after_norm.weight
        caches = [(w.new_zeros(B, self.heads, Tmax, dk),
                   w.new_zeros(B, self.heads, Tmax, dk))
                  for _ in self.layers]
        pe = self._pe(Tmax, dev)
        greedy = temperature <= 0
        positions = torch.arange(Tmax, device=dev)
        cur = prompt[:, 0].long()
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        frames = [cur]
        # the frame sampled at the last position is never kept
        for t in range(Tmax - 1):
            x = (self._embed_frame(cur) + pe[t])[:, None, :]
            kv_mask = (positions <= t)[None].expand(B, Tmax)
            for layer, (ck, cv) in zip(self.layers, caches):
                x = layer.step(x, ck, cv, t, kv_mask)
            h = self.after_norm(x[:, 0])
            codes = []
            for i in range(Q):
                logits = self._head(i)(h)
                if 0 < topk < logits.shape[-1]:
                    kth = torch.topk(logits, topk, dim=-1).values[:, -1:]
                    logits = torch.where(logits < kth, -1e9, logits)
                if greedy:
                    codes.append(logits.argmax(-1))
                else:
                    codes.append(torch.multinomial(torch.softmax(
                        logits / temperature, dim=-1), 1,
                        generator=generator)[:, 0])
            sampled = torch.stack(codes, dim=-1)
            in_prompt = (t + 1) < prompt_lengths
            forced = prompt[:, min(t + 1, Tp - 1)].long()
            done = done | (~in_prompt & (sampled[:, 0] == eos_id))
            cur = torch.where(in_prompt[:, None], forced,
                              torch.where(done[:, None],
                                          torch.full_like(sampled, eos_id),
                                          sampled))
            frames.append(cur)
        out = torch.stack(frames, dim=1).to(prompt.dtype)
        ended = (out[:, :, 0] == eos_id) & (
            positions[None] >= prompt_lengths[:, None])
        lengths = torch.where(ended.any(1), ended.int().argmax(1) + 1, Tmax)
        return out, lengths.int()


def delay_pattern(codes, pad: int = 0):
    """MusicGen's delay: stream q shifted right by q, (B, T, Q) ->
    (B, T + Q - 1, Q), vacated slots ``pad``."""
    B, T, Q = codes.shape
    out = codes.new_full((B, T + Q - 1, Q), pad)
    for q in range(Q):
        out[:, q:q + T, q] = codes[:, :, q]
    return out


def undelay_pattern(delayed, pad: int = 0):
    """The inverse of delay_pattern: (B, T + Q - 1, Q) -> (B, T, Q)."""
    B, Td, Q = delayed.shape
    T = Td - Q + 1
    return torch.stack([delayed[:, q:q + T, q] for q in range(Q)], dim=-1)


class MultimodalVocabulary:
    """One packed id space over modalities: the specials first, then each
    modality's contiguous interval in insertion order."""

    def __init__(self, modalities, specials=("<pad>", "<bos>", "<eos>")):
        self.specials = {s: i for i, s in enumerate(specials)}
        self.intervals = {}
        off = len(specials)
        for name, size in modalities.items():
            self.intervals[name] = (off, off + size)
            off += size
        self.size = off

    def encode(self, name, ids):
        return torch.as_tensor(ids) + self.intervals[name][0]

    def decode(self, name, ids):
        return torch.as_tensor(ids) - self.intervals[name][0]

    def modality_of(self, gid: int) -> str:
        for name, (lo, hi) in self.intervals.items():
            if lo <= gid < hi:
                return name
        return "special"

    def special(self, tok: str) -> int:
        return self.specials[tok]

    def build_sequence(self, *segments):
        """[(modality, local ids), ...] -> bos, the global ids, eos."""
        parts = [torch.tensor([self.special("<bos>")])]
        parts += [self.encode(name, ids) for name, ids in segments]
        parts.append(torch.tensor([self.special("<eos>")]))
        return torch.cat(parts)
