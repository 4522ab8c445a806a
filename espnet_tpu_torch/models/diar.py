"""EEND speaker diarization (counterpart of espnet_tpu/models/diar.py):
frontend -> UtteranceMVN -> encoder -> per-frame, per-speaker sigmoid
activity, trained by the binary cross-entropy of the best speaker
permutation (PIT), with the frame accuracy in the stats.

``EncoderDecoderAttractor`` (EEND-EDA) is the JAX package's module: an
LSTM over the frame embeddings whose carry is each row's at its own
length (flax's ``nn.RNN(..., seq_lengths=...)``), then an LSTM decoder
run from zero inputs that emits one attractor a step, and an existence
logit per attractor. The cells are ``models/transducer.py:LSTMCell``,
flax's ``OptimizedLSTMCell`` layout. The diarization task does not turn
it on (``use_attractor`` is False there).
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from espnet_tpu_torch.frontends.default import DefaultFrontend, UtteranceMVN
from espnet_tpu_torch.models.asr import ENCODER_CLASSES
from espnet_tpu_torch.models.transducer import LSTMCell
from espnet_tpu_torch.utils.masks import make_non_pad_mask


def optax_sigmoid_bce(logits, labels):
    """optax's sigmoid binary cross-entropy, elementwise."""
    return -(labels * F.logsigmoid(logits)
             + (1 - labels) * F.logsigmoid(-logits))


def pit_bce_loss(logits, labels, valid_mask):
    """logits, labels (B, T, S), valid_mask (B, T) -> (the least mean BCE
    over speaker permutations (B,), that permutation's index (B,), in
    ``itertools.permutations`` order; the first on ties)."""
    S = logits.shape[-1]
    m = valid_mask[:, :, None]
    n = torch.clamp(valid_mask.sum(1), min=1).to(logits.dtype)
    losses = []
    for p in itertools.permutations(range(S)):
        bce = optax_sigmoid_bce(logits[:, :, list(p)], labels)
        bce = torch.where(m, bce, bce.new_zeros(()))
        losses.append(bce.sum((1, 2)) / (n * S))
    losses = torch.stack(losses, dim=1)
    best = torch.argmin(losses, dim=1)
    return losses.gather(1, best[:, None])[:, 0], best


class _RNN(nn.Module):
    """flax's ``nn.RNN`` holds its cell as ``cell``."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.cell = LSTMCell(input_size, hidden)


class EncoderDecoderAttractor(nn.Module):

    def __init__(self, input_size: int, unit: int = 256):
        super().__init__()
        self.unit = unit
        self.enc_rnn = _RNN(input_size, unit)
        self.dec_cell = LSTMCell(unit, unit)
        self.existence = nn.Linear(unit, 1)

    def forward(self, emb, lengths, n_attractors: int):
        """emb (B, T, D), lengths (B,) -> (attractors (B, A, unit),
        existence logits (B, A))."""
        B, T, _ = emb.shape
        cell = self.enc_rnn.cell
        proj = cell.input_proj(emb)
        carry = (emb.new_zeros(B, self.unit), emb.new_zeros(B, self.unit))
        for t in range(T):
            new = cell(carry, proj[:, t])
            keep = (t < lengths)[:, None]
            carry = tuple(torch.where(keep, a, b) for a, b in zip(new, carry))
        zeros = self.dec_cell.input_proj(emb.new_zeros(B, self.unit))
        atts, exists = [], []
        for _ in range(n_attractors):
            carry = self.dec_cell(carry, zeros)
            atts.append(carry[1])
            exists.append(self.existence(carry[1])[:, 0])
        return torch.stack(atts, dim=1), torch.stack(exists, dim=1)


class DiarizationModel(nn.Module):

    def __init__(self, num_spk: int = 2, frontend_conf: Optional[dict] = None,
                 encoder: str = "transformer",
                 encoder_conf: Optional[dict] = None,
                 use_attractor: bool = False):
        super().__init__()
        if encoder not in ENCODER_CLASSES:
            raise NotImplementedError(f"encoder {encoder!r}: the port has "
                                      f"{sorted(ENCODER_CLASSES)}")
        self.num_spk = num_spk
        fc = dict(frontend_conf or {"n_fft": 512, "hop_length": 128,
                                    "n_mels": 23})
        self.frontend = DefaultFrontend(**fc)
        self.normalize = UtteranceMVN()
        enc_conf = dict(encoder_conf or {})
        enc_conf.setdefault("input_layer", "linear")
        self.encoder_mod = ENCODER_CLASSES[encoder](self.frontend.output_size,
                                                    **enc_conf)
        d = enc_conf.get("output_size", 256)
        self.use_attractor = use_attractor
        if use_attractor:
            self.attractor = EncoderDecoderAttractor(d, unit=d)
        else:
            self.output = nn.Linear(d, num_spk)

    def predict(self, speech, speech_lengths):
        """(B, S) wave, (B,) lengths -> (logits (B, T', num_spk), (B,))."""
        feats, flens = self.frontend(speech, speech_lengths)
        feats, flens = self.normalize(feats, flens)
        enc, olens = self.encoder_mod(feats, flens)
        if self.use_attractor:
            atts, _ = self.attractor(enc, olens, self.num_spk)
            return torch.einsum("btd,bad->bta", enc, atts), olens
        return self.output(enc), olens

    def forward(self, speech, speech_lengths, spk_labels,
                spk_labels_lengths=None,
                generator: Optional[torch.Generator] = None):
        """spk_labels (B, T_lab, S) 0/1 -> (loss, {loss, frame_acc}, B)."""
        logits, olens = self.predict(speech, speech_lengths)
        T = min(logits.shape[1], spk_labels.shape[1])
        logits, labels = logits[:, :T], spk_labels[:, :T].float()
        valid = make_non_pad_mask(torch.clamp(olens, max=T), T)
        per_utt, _ = pit_bce_loss(logits, labels, valid)
        loss = per_utt.mean()
        pred = (torch.sigmoid(logits) > 0.5).float()
        hit = torch.where(valid[:, :, None], pred == labels, False)
        acc = hit.sum() / torch.clamp(valid.sum() * labels.shape[-1], min=1)
        return loss, {"loss": loss, "frame_acc": acc}, float(speech.shape[0])
