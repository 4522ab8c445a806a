"""Hybrid CTC/attention ASR model (counterpart of
espnet_tpu/models/asr.py:ASRModel).

encode = frontend -> SpecAug (training only) -> GlobalMVN -> conformer
encoder; a CTC head; the transformer decoder, teacher-forced for the
loss and one step at a time for beam search. The loss is
ctc_weight * CTC + (1 - ctc_weight) * label-smoothed attention loss.
Attribute names follow the JAX parameter tree (encoder_mod, ctc,
decoder_mod) so that ``convert.py`` maps one onto the other by path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from espnet_tpu_torch.frontends.default import DefaultFrontend, GlobalMVN
from espnet_tpu_torch.nn.conformer import ConformerEncoder
from espnet_tpu_torch.nn.decoder import TransformerDecoder
from espnet_tpu_torch.nn.streaming_encoder import StreamingConformerEncoder
from espnet_tpu_torch.ops.losses import (accuracy, add_sos_eos, ctc_loss,
                                         label_smoothing_loss)
from espnet_tpu_torch.ops.specaug import specaug

# the encoders the port has, by their config names (the JAX package's
# ENCODER_CLASSES has more)
ENCODER_CLASSES = {
    "conformer": ConformerEncoder,
    "streaming_conformer": StreamingConformerEncoder,
}


class CTCHead(nn.Module):
    """Linear projection to the vocabulary for CTC."""

    def __init__(self, d_model: int, vocab_size: int):
        super().__init__()
        self.ctc_lo = nn.Linear(d_model, vocab_size)

    def forward(self, h):
        return self.ctc_lo(h)


class ASRModel(nn.Module):

    def __init__(self, vocab_size: int, token_list, frontend: DefaultFrontend,
                 normalize: Optional[GlobalMVN], encoder_conf: dict,
                 decoder_conf: Optional[dict], ctc_weight: float = 0.5,
                 blank_id: int = 0, specaug_conf: Optional[dict] = None,
                 lsm_weight: float = 0.0,
                 length_normalized_loss: bool = False, ignore_id: int = -1,
                 encoder: str = "conformer"):
        super().__init__()
        self.vocab_size = vocab_size
        self.token_list = tuple(token_list)
        self.ctc_weight = ctc_weight
        self.blank_id = blank_id
        self.specaug_conf = specaug_conf
        self.lsm_weight = lsm_weight
        self.length_normalized_loss = length_normalized_loss
        self.ignore_id = ignore_id
        self.frontend = frontend
        self.normalize = normalize
        d = encoder_conf.get("output_size", 256)
        self.encoder_mod = ENCODER_CLASSES[encoder](frontend.output_size,
                                                    **encoder_conf)
        self.ctc = CTCHead(d, vocab_size) if ctc_weight > 0.0 else None
        self.decoder_mod = None
        if decoder_conf is not None and ctc_weight < 1.0:
            conf = dict(decoder_conf)
            conf.setdefault("encoder_output_size", d)
            self.decoder_mod = TransformerDecoder(vocab_size, **conf)

    @property
    def sos_id(self) -> int:
        return self.vocab_size - 1

    @property
    def eos_id(self) -> int:
        return self.vocab_size - 1

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
               generator: Optional[torch.Generator] = None):
        """(B, S) wave, (B,) lengths -> (B, T', D), (B,) lengths. SpecAug
        runs in training only, drawing from ``generator``."""
        feats, feat_lens = self.frontend(speech, speech_lengths)
        if self.training and self.specaug_conf is not None:
            feats = specaug(feats, feat_lens, generator=generator,
                            **self.specaug_conf)
        if self.normalize is not None:
            feats, feat_lens = self.normalize(feats, feat_lens)
        return self.encoder_mod(feats, feat_lens)

    def forward(self, speech, speech_lengths, text, text_lengths,
                generator: Optional[torch.Generator] = None):
        """-> (loss, stats {loss, loss_ctc, loss_att, acc}, weight = B)."""
        enc, enc_lens = self.encode(speech, speech_lengths, generator)
        return self.compute_losses(enc, enc_lens, text, text_lengths)

    def compute_losses(self, enc, enc_lens, text, text_lengths):
        stats = {}
        loss_ctc = enc.new_zeros(())
        if self.ctc is not None:
            loss_ctc = ctc_loss(self.ctc(enc), enc_lens, text, text_lengths,
                                self.blank_id)
            stats["loss_ctc"] = loss_ctc
        loss_att = enc.new_zeros(())
        if self.decoder_mod is not None:
            ys_in, ys_out = add_sos_eos(text, text_lengths, self.sos_id,
                                        self.eos_id, self.ignore_id)
            logits = self.decoder_mod(enc, enc_lens, ys_in, text_lengths + 1)
            loss_att = label_smoothing_loss(logits, ys_out, self.lsm_weight,
                                            self.ignore_id,
                                            self.length_normalized_loss)
            stats["loss_att"] = loss_att
            stats["acc"] = accuracy(logits, ys_out, self.ignore_id)
        loss = self.ctc_weight * loss_ctc + (1.0 - self.ctc_weight) * loss_att
        stats["loss"] = loss
        return loss, stats, float(enc.shape[0])

    def ctc_logits(self, enc):
        return self.ctc(enc)

    def decoder_init_state(self, memory, memory_lens, batch: int,
                           maxlen: int):
        return self.decoder_mod.init_state(memory, memory_lens, batch,
                                           maxlen)

    def decoder_score_step(self, token, step: int, state):
        return self.decoder_mod.score_step(token, step, state)
