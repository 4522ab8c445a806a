"""Speech2Text: the port's ASR inference API (counterpart of
espnet_tpu/bin/asr_inference.py:Speech2Text).

Built from (asr_train_config, asr_model_file); ``__call__`` returns, per
utterance, the n-best list [(text, tokens, token_ids, score)]. It takes
hybrid CTC/attention beam search and greedy CTC. LM and n-gram fusion
and time-synchronous decoding are not ported yet and raise
NotImplementedError.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from espnet_tpu_torch.decode.beam_search import (BeamSearchConfig,
                                                 batch_beam_search)
from espnet_tpu_torch.decode.ctc_greedy import ctc_greedy_decode
from espnet_tpu_torch.tasks.asr import build_model_from_file
from espnet_tpu_torch.text.tokenizer import TokenIDConverter, build_tokenizer
from espnet_tpu_torch.utils.device import resolve_device


class Speech2Text:
    def __init__(self,
                 asr_train_config=None,
                 asr_model_file=None,
                 ctc_weight: float = 0.5,
                 beam_size: int = 10,
                 penalty: float = 0.0,
                 maxlenratio: float = 0.0,
                 minlenratio: float = 0.0,
                 nbest: int = 1,
                 lm_train_config=None,
                 lm_file=None,
                 lm_weight: float = 1.0,
                 ngram_file=None,
                 ngram_weight: float = 0.9,
                 time_sync: bool = False,
                 device=None):
        if lm_train_config is not None or lm_file is not None:
            raise NotImplementedError("LM fusion is not ported yet")
        if ngram_file is not None:
            raise NotImplementedError("n-gram fusion is not ported yet")
        if time_sync:
            raise NotImplementedError(
                "time-synchronous decoding is not ported yet")
        self.device = resolve_device(device)
        self.model, self.cfg = build_model_from_file(
            asr_train_config, asr_model_file, self.device)
        self.converter = TokenIDConverter(list(self.model.token_list))
        self.tokenizer = build_tokenizer(
            self.cfg.get("token_type", "char"),
            self.cfg.get("non_linguistic_symbols"))
        self.beam_size = beam_size
        self.ctc_weight = ctc_weight
        self.nbest = nbest
        self.search_config = BeamSearchConfig(
            beam_size=beam_size, ctc_weight=ctc_weight, length_bonus=penalty,
            maxlenratio=maxlenratio, minlenratio=minlenratio, nbest=nbest)

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
        use_beam = (self.model.decoder_mod is not None
                    and self.model.ctc_weight < 1.0 and self.beam_size > 1
                    and self.ctc_weight < 1.0)
        if use_beam:
            results = batch_beam_search(self.model, enc, enc_lens,
                                        self.search_config)
        else:
            results = self._greedy(enc, enc_lens)
        out = []
        for hyps in results:
            nbest = []
            for ids, score in hyps[:self.nbest]:
                toks = self.converter.ids2tokens(ids)
                nbest.append((self.tokenizer.tokens2text(toks), toks, ids,
                              score))
            out.append(nbest)
        return out

    def _greedy(self, enc, enc_lens):
        tokens, n_tok = ctc_greedy_decode(self.model.ctc_logits(enc),
                                          enc_lens, self.model.blank_id)
        tokens, n_tok = tokens.cpu().numpy(), n_tok.cpu().numpy()
        return [[(tokens[b, :n_tok[b]].tolist(), 0.0)]
                for b in range(tokens.shape[0])]
