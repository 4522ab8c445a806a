"""The port's transducer inference: ``Speech2TextTransducer``,
``Speech2TextTransducerStreaming`` and the batch-decode CLI (counterpart
of espnet_tpu/bin/asr_transducer_inference.py).

``Speech2TextTransducer`` is built from (train_config, model_file);
``__call__`` returns, per utterance, the n-best list
[(text, tokens, token_ids, score)]. It takes the default beam search and
greedy search.

``Speech2TextTransducerStreaming`` takes audio in pieces,
``s2t(piece, is_final=...)``, and keeps the streaming encoder's state,
the prediction network's state and the running hypothesis between
calls: greedy search over each encoder chunk. It is the JAX package's
class as it is: the windows go to the encoder without normalisation,
and every frame of the final zero-padded window is decoded.

``inference`` decodes a data dir into Kaldi-style maps, as the JAX
package's does:

    python -m espnet_tpu_torch.bin.asr_transducer_inference \
        --output_dir exp/decode \
        --data_path_and_name_and_type data/test/wav.scp,speech,sound \
        --train_config exp/rnnt/config.yaml --model_file exp/rnnt \
        [--batch_size 16] [--beam_size 5] [--device cpu]

writes ``<output_dir>/1best_recog/{text,token,token_int,score}`` (one
``Nbest_recog`` dir per n-best rank). Keys go in the data dir's order,
each batch padded to its length bucket. Everything runs on the card
unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import logging
import sys
from typing import List, Tuple

import numpy as np
import torch

from espnet_tpu_torch.bin.asr_inference_streaming import (feature_extractor,
                                                          subsampling_rate)
from espnet_tpu_torch.data.batching import common_collate_fn
from espnet_tpu_torch.data.dataset import ESPnetDataset
from espnet_tpu_torch.data.fileio import DatadirWriter
from espnet_tpu_torch.decode.transducer_search import (TransducerSearchConfig,
                                                       decode_transducer,
                                                       greedy_stream_init,
                                                       greedy_stream_step)
from espnet_tpu_torch.frontends.streaming import subsample_window
from espnet_tpu_torch.tasks.abs_task import parse_triples
from espnet_tpu_torch.tasks.asr_transducer import ASRTransducerTask
from espnet_tpu_torch.text.tokenizer import TokenIDConverter, build_tokenizer
from espnet_tpu_torch.utils.config import parse_cli_overrides
from espnet_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class Speech2TextTransducer:
    def __init__(self, train_config=None, model_file=None,
                 beam_size: int = 5, search_type: str = "default",
                 nbest: int = 1, score_norm: bool = True, device=None):
        self.device = resolve_device(device)
        self.model, self.cfg = ASRTransducerTask.build_model_from_file(
            train_config, model_file, self.device)
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


class Speech2TextTransducerStreaming:
    def __init__(self, train_config=None, model_file=None,
                 max_sym_exp: int = 3, umax: int = 512, device=None):
        self.device = resolve_device(device)
        self.model, self.cfg = ASRTransducerTask.build_model_from_file(
            train_config, model_file, self.device)
        if self.cfg.get("encoder") != "streaming_conformer":
            raise ValueError("streaming transducer requires "
                             "encoder: streaming_conformer")
        self.converter = TokenIDConverter(list(self.model.token_list))
        self.tokenizer = build_tokenizer(self.cfg.get("token_type", "char"))
        self.fe = feature_extractor(self.cfg, self.device)
        self.window, self.advance = subsample_window(
            subsampling_rate(self.cfg),
            (self.cfg.get("encoder_conf") or {}).get("chunk_size", 16))
        self.max_sym_exp = max_sym_exp
        self.umax = umax
        self.reset()

    def reset(self):
        self.fe.reset()
        self._enc_state = None
        self._dec_state = None

    @torch.no_grad()
    def __call__(self, speech: np.ndarray, is_final: bool = False):
        """Feed a piece of audio; -> [(text, tokens, ids)] so far."""
        self.fe.push(speech, is_final=is_final)
        for chunk in self.fe.pop_windows(self.window, self.advance,
                                         is_final=is_final):
            if self._enc_state is None:
                self._enc_state = self.model.encoder_mod.init_stream_state(
                    1, self.device)
                self._dec_state = greedy_stream_init(self.model, 1,
                                                     self.umax, self.device)
            enc, self._enc_state = self.model.encoder_mod.stream_step(
                torch.from_numpy(chunk[None]).to(self.device),
                self._enc_state)
            lens = torch.full((1,), enc.shape[1], dtype=torch.long,
                              device=self.device)
            self._dec_state = greedy_stream_step(
                self.model, enc, lens, self._dec_state, self.max_sym_exp)
        ids = []
        if self._dec_state is not None:
            n = int(self._dec_state.n_tok[0])
            ids = self._dec_state.tokens[0, :n].cpu().tolist()
        toks = self.converter.ids2tokens(ids)
        results = [(self.tokenizer.tokens2text(toks), toks, ids)]
        if is_final:
            self.reset()
        return results


def inference(output_dir, data_path_and_name_and_type, train_config,
              model_file, batch_size: int = 1, device=None, **kwargs):
    """Decode the ``speech`` of the data triples into Kaldi-style maps
    under ``output_dir``, ``batch_size`` keys at a time in the data dir's
    order; ``kwargs`` go to Speech2TextTransducer."""
    s2t = Speech2TextTransducer(train_config=train_config,
                                model_file=model_file, device=device,
                                **kwargs)
    ds = ESPnetDataset(parse_triples(data_path_and_name_and_type))
    keys = ds.keys()
    with DatadirWriter(output_dir) as writer:
        for i in range(0, len(keys), batch_size):
            uids, batch = common_collate_fn([ds[k] for k in
                                             keys[i:i + batch_size]])
            results = s2t(batch["speech"], batch["speech_lengths"])
            for uid, nbest in zip(uids, results):
                for n, (text, toks, ids, score) in enumerate(nbest, 1):
                    w = writer[f"{n}best_recog"]
                    w["text"][uid] = text
                    w["token"][uid] = " ".join(toks)
                    w["token_int"][uid] = " ".join(map(str, ids))
                    w["score"][uid] = str(score)
    logger.info("decoded %d utterances -> %s", len(keys), output_dir)


def main(argv=None):
    inference(**parse_cli_overrides(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
