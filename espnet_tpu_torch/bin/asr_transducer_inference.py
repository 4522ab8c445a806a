"""Speech2TextTransducer: the port's transducer inference API
(counterpart of espnet_tpu/bin/asr_transducer_inference.py).

Built from (train_config, model_file); ``__call__`` returns, per
utterance, the n-best list [(text, tokens, token_ids, score)]. It takes
the default beam search and greedy search. The streaming session
(``Speech2TextTransducerStreaming``) and the batch-decode CLI are not
ported yet.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from espnet_tpu_torch.decode.transducer_search import (TransducerSearchConfig,
                                                       decode_transducer)
from espnet_tpu_torch.tasks.asr import build_model_from_file
from espnet_tpu_torch.tasks.asr_transducer import build_model
from espnet_tpu_torch.text.tokenizer import TokenIDConverter, build_tokenizer
from espnet_tpu_torch.utils.device import resolve_device


class Speech2TextTransducer:
    def __init__(self, train_config=None, model_file=None,
                 beam_size: int = 5, search_type: str = "default",
                 nbest: int = 1, score_norm: bool = True, device=None):
        self.device = resolve_device(device)
        self.model, self.cfg = build_model_from_file(
            train_config, model_file, self.device, build=build_model)
        self.converter = TokenIDConverter(list(self.model.token_list))
        self.tokenizer = build_tokenizer(self.cfg.get("token_type", "char"))
        self.config = TransducerSearchConfig(
            beam_size=beam_size, search_type=search_type, nbest=nbest,
            score_norm=score_norm)

    @torch.no_grad()
    def __call__(self, speech, speech_lengths=None) -> List[List[Tuple]]:
        """speech (S,) or (B, S), numpy or torch -> per-utterance n-best
        [(text, tokens, token_ids, score)]."""
        speech = torch.as_tensor(speech, dtype=torch.float32,
                                 device=self.device)
        if speech.dim() == 1:
            speech = speech[None]
        if speech_lengths is None:
            speech_lengths = [speech.shape[1]] * speech.shape[0]
        lengths = torch.as_tensor(speech_lengths, dtype=torch.int64,
                                  device=self.device)
        enc, enc_lens = self.model.encode(speech, lengths)
        out = []
        for hyps in decode_transducer(self.model, enc, enc_lens,
                                      self.config):
            nbest = []
            for ids, score in hyps:
                toks = self.converter.ids2tokens(ids)
                nbest.append((self.tokenizer.tokens2text(toks), toks, ids,
                              score))
            out.append(nbest)
        return out
