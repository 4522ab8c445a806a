"""Hybrid CTC/attention ASR model, inference side (counterpart of
espnet_tpu/models/asr.py:ASRModel).

encode = frontend -> GlobalMVN -> conformer encoder; a CTC head; and the
transformer decoder's one-step scorer for beam search. Attribute names
follow the JAX parameter tree (encoder_mod, ctc, decoder_mod) so that
``convert.py`` maps one onto the other by path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from espnet_tpu_torch.frontends.default import DefaultFrontend, GlobalMVN
from espnet_tpu_torch.nn.conformer import ConformerEncoder
from espnet_tpu_torch.nn.decoder import TransformerDecoder


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
                 blank_id: int = 0):
        super().__init__()
        self.vocab_size = vocab_size
        self.token_list = tuple(token_list)
        self.ctc_weight = ctc_weight
        self.blank_id = blank_id
        self.frontend = frontend
        self.normalize = normalize
        d = encoder_conf.get("output_size", 256)
        self.encoder_mod = ConformerEncoder(frontend.output_size,
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

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor):
        """(B, S) wave, (B,) lengths -> (B, T', D), (B,) lengths."""
        feats, feat_lens = self.frontend(speech, speech_lengths)
        if self.normalize is not None:
            feats, feat_lens = self.normalize(feats, feat_lens)
        return self.encoder_mod(feats, feat_lens)

    def ctc_logits(self, enc):
        return self.ctc(enc)

    def decoder_init_state(self, memory, memory_lens, batch: int,
                           maxlen: int):
        return self.decoder_mod.init_state(memory, memory_lens, batch,
                                           maxlen)

    def decoder_score_step(self, token, step: int, state):
        return self.decoder_mod.score_step(token, step, state)
