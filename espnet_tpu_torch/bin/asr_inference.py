"""Speech2Text, the port's ASR inference API, and the batch-decode CLI
(counterpart of espnet_tpu/bin/asr_inference.py).

``Speech2Text`` is built from (asr_train_config, asr_model_file);
``__call__`` returns, per utterance, the n-best list
[(text, tokens, token_ids, score)]. It takes hybrid CTC/attention beam
search and greedy CTC. LM and n-gram fusion and time-synchronous decoding
are not ported yet and raise NotImplementedError.

``inference`` decodes a data dir into Kaldi-style maps, as the JAX
package's does:

    python -m espnet_tpu_torch.bin.asr_inference --output_dir exp/decode \
        --data_path_and_name_and_type data/test/wav.scp,speech,sound \
        --asr_train_config exp/asr/config.yaml \
        --asr_model_file exp/asr/checkpoint \
        [--batch_size 4] [--ctc_weight 1.0] [--device cpu]

writes ``<output_dir>/1best_recog/{text,token,token_int,score}`` (one
``Nbest_recog`` dir per n-best rank) and ``decode_stats.jsonl`` (per
batch: utterances, audio seconds, decode seconds). It decodes on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from espnet_tpu_torch.data.batching import bucket_length, common_collate_fn
from espnet_tpu_torch.data.dataset import ESPnetDataset
from espnet_tpu_torch.data.fileio import DatadirWriter
from espnet_tpu_torch.decode.beam_search import (BeamSearchConfig,
                                                 batch_beam_search)
from espnet_tpu_torch.decode.ctc_greedy import ctc_greedy_decode
from espnet_tpu_torch.tasks.abs_task import parse_triples, shard_keys
from espnet_tpu_torch.tasks.asr import ASRTask
from espnet_tpu_torch.text.tokenizer import TokenIDConverter, build_tokenizer
from espnet_tpu_torch.utils.config import parse_cli_overrides
from espnet_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


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
        self.model, self.cfg = ASRTask.build_model_from_file(
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


def decode_batches(ds, keys, batch_size: int):
    """-> (uids, speech, lengths, n) per batch, as ``inference`` decodes
    them: with ``batch_size`` > 1 the keys go by audio length, and each
    batch is padded to ``batch_size`` rows and to a length bucket, as the
    JAX package pads them; the first n rows are real."""
    if batch_size > 1:
        keys = sorted(keys, key=lambda k: len(ds[k][1]["speech"]))
    for i in range(0, len(keys), batch_size):
        uids, batch = common_collate_fn([ds[k] for k in
                                         keys[i:i + batch_size]])
        speech, lens = batch["speech"], batch["speech_lengths"]
        n = speech.shape[0]
        if batch_size > 1:
            Lb = bucket_length(speech.shape[1], base=4096, growth=1.3)
            speech = np.pad(speech, ((0, batch_size - n),
                                     (0, Lb - speech.shape[1])))
            lens = np.pad(lens, (0, batch_size - n),
                          constant_values=max(int(lens.min()), 1))
        yield uids, speech, lens, n


def inference(output_dir, data_path_and_name_and_type, asr_train_config,
              asr_model_file, batch_size: int = 1, nbest: int = 1,
              job_id: int = 0, num_jobs: int = 1, device=None, **kwargs):
    """Decode the ``speech`` of the data triples into Kaldi-style maps
    under ``output_dir`` in batches of ``decode_batches``; ``kwargs`` go
    to Speech2Text. ``job_id`` of ``num_jobs`` decodes its contiguous
    share of the keys."""
    s2t = Speech2Text(asr_train_config=asr_train_config,
                      asr_model_file=asr_model_file, nbest=nbest,
                      device=device, **kwargs)
    ds = ESPnetDataset(parse_triples(data_path_and_name_and_type))
    keys = ds.keys()
    if num_jobs > 1:
        keys = shard_keys(keys, job_id, num_jobs)
    fs = (s2t.cfg.get("frontend_conf") or {}).get("fs", 16000)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    with DatadirWriter(out) as writer, open(
            out / "decode_stats.jsonl", "w", encoding="utf-8") as stats_f:
        for uids, speech, lens, n in decode_batches(ds, keys, batch_size):
            t0 = time.perf_counter()
            results = s2t(speech, lens)[:n]
            wall = time.perf_counter() - t0
            audio_secs = float(lens[:n].sum()) / fs
            logger.info("speech length: %.3fs, decode time: %.3fs",
                        audio_secs, wall)
            stats_f.write(json.dumps({"n_utts": n, "audio_secs": audio_secs,
                                      "decode_secs": wall}) + "\n")
            for uid, nbest_hyps in zip(uids, results):
                for rank, (text, toks, ids, score) in enumerate(nbest_hyps,
                                                                1):
                    w = writer[f"{rank}best_recog"]
                    w["text"][uid] = text
                    w["token"][uid] = " ".join(toks)
                    w["token_int"][uid] = " ".join(map(str, ids))
                    w["score"][uid] = str(float(score))
    logger.info("decoded %d utterances -> %s", len(keys), output_dir)


def main(argv=None):
    inference(**parse_cli_overrides(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
