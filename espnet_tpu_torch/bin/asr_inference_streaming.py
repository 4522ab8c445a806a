"""Streaming speech recognition: ``Speech2TextStreaming`` and
``StreamingSessionPool`` (counterpart of
espnet_tpu/bin/asr_inference_streaming.py).

``Speech2TextStreaming`` takes audio in pieces,
``results = s2t(piece, is_final=False)``, and keeps the incremental
frontend, the streaming encoder's state and the running decode between
calls; ``is_final=True`` flushes and resets. The model must have a
``streaming_conformer`` encoder. Two decode modes:

- ``search_type="greedy"``: each feature window runs one encoder step and
  the CTC argmax; only the window's valid frames (its zero-padded tail
  trimmed) extend the hypothesis.
- ``search_type="beam"``: block-synchronous hybrid CTC/attention beam
  search. The encoder stays incremental (each chunk is computed once and
  kept); every ``decode_interval`` new chunks, and on the final push,
  the beam search runs over all the chunks so far, padded to a
  geometric length bucket, as the JAX package pads them.

GlobalMVN, being per frame, is applied to each window; any other
``normalize`` is skipped, as in the JAX package (train streaming models
with ``normalize: global_mvn``).

``StreamingSessionPool`` runs up to ``max_sessions`` streams through one
batched encoder step: each round takes at most one window per session,
and the rows of sessions without a window keep their state.

Everything runs on the card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from espnet_tpu_torch.data.batching import bucket_length
from espnet_tpu_torch.decode.beam_search import (BeamSearchConfig,
                                                 batch_beam_search)
from espnet_tpu_torch.frontends.streaming import (StreamingFeatureExtractor,
                                                  subsample_window,
                                                  subsampled_valid_len)
from espnet_tpu_torch.nn.streaming_encoder import INPUT_RATES
from espnet_tpu_torch.tasks.asr import ASRTask
from espnet_tpu_torch.text.tokenizer import TokenIDConverter, build_tokenizer
from espnet_tpu_torch.utils.device import resolve_device


def feature_extractor(cfg, device) -> StreamingFeatureExtractor:
    """The streaming frontend of a config's ``frontend_conf``."""
    fc = cfg.get("frontend_conf") or {}
    return StreamingFeatureExtractor(
        n_fft=fc.get("n_fft", 512), hop_length=fc.get("hop_length", 128),
        n_mels=fc.get("n_mels", 80), fs=fc.get("fs", 16000), device=device)


def subsampling_rate(cfg) -> int:
    ec = cfg.get("encoder_conf") or {}
    return INPUT_RATES.get(ec.get("input_layer", "conv2d"), 1)


class Speech2TextStreaming:
    def __init__(self, asr_train_config=None, asr_model_file=None,
                 search_type: str = "greedy", beam_size: int = 10,
                 ctc_weight: float = 0.3, nbest: int = 1,
                 decode_interval: int = 1, device=None):
        self.device = resolve_device(device)
        self.model, self.cfg = ASRTask.build_model_from_file(
            asr_train_config, asr_model_file, self.device)
        if self.cfg.get("encoder") != "streaming_conformer":
            raise ValueError(
                "streaming inference requires encoder: streaming_conformer")
        self.converter = TokenIDConverter(list(self.model.token_list))
        self.tokenizer = build_tokenizer(self.cfg.get("token_type", "char"))
        self.fe = feature_extractor(self.cfg, self.device)
        self.chunk_size = (self.cfg.get("encoder_conf") or {}).get(
            "chunk_size", 16)
        self.rate = subsampling_rate(self.cfg)
        self.feat_window, self.feat_advance = subsample_window(
            self.rate, self.chunk_size)
        self.search_type = search_type
        self.decode_interval = max(int(decode_interval), 1)
        if search_type == "beam":
            self.bs_config = BeamSearchConfig(
                beam_size=beam_size, ctc_weight=ctc_weight, nbest=nbest)
        elif search_type != "greedy":
            raise ValueError(f"unknown search_type: {search_type}")
        self._mvn = (self.model.normalize
                     if self.cfg.get("normalize") == "global_mvn" else None)
        self.reset()

    def reset(self):
        self.fe.reset()
        self._enc_state = None
        self._hyp: List[int] = []
        self._prev_tok = -1
        self._enc_chunks: List[torch.Tensor] = []
        self._blocks_since_decode = 0
        self._last_results: List[Tuple[str, List[str], List[int]]] = []

    # -- internals ----------------------------------------------------

    def norm(self, feats: torch.Tensor) -> torch.Tensor:
        """GlobalMVN of (B, W, F) windows, or the windows as they are."""
        if self._mvn is None:
            return feats
        lens = torch.full((feats.shape[0],), feats.shape[1],
                          dtype=torch.long, device=feats.device)
        return self._mvn(feats, lens)[0]

    def encoder_step(self, feats: np.ndarray, state):
        """(B, W, F) numpy windows -> (enc (B, chunk, D), new state)."""
        x = torch.from_numpy(np.ascontiguousarray(feats)).to(self.device)
        return self.model.encoder_mod.stream_step(self.norm(x), state)

    def _encoded_windows(self, is_final: bool):
        """One encoder step for each window the frontend holds; yields
        (enc (1, chunk, D), its valid frames), the zero-padded tail of a
        final window trimmed from the count."""
        while True:
            popped = self.fe.pop_one_window(self.feat_window,
                                            self.feat_advance,
                                            is_final=is_final,
                                            with_valid=True)
            if popped is None:
                return
            chunk, n_valid = popped
            if self._enc_state is None:
                self._enc_state = self.model.encoder_mod.init_stream_state(
                    1, self.device)
            enc, self._enc_state = self.encoder_step(chunk[None],
                                                     self._enc_state)
            yield enc, subsampled_valid_len(self.rate, n_valid)

    def _encode_pending(self, is_final: bool) -> int:
        """Encode every window the frontend holds; keep each chunk's valid
        frames. -> the number of new chunks."""
        n_new = 0
        for enc, out_valid in self._encoded_windows(is_final):
            self._enc_chunks.append(enc[0, :out_valid])
            n_new += 1
        return n_new

    def _beam_decode(self) -> List[Tuple[str, List[str], List[int]]]:
        """Hybrid beam search over all encoder frames so far."""
        enc = torch.cat(self._enc_chunks, dim=0)       # (T, D)
        T = enc.shape[0]
        Tb = bucket_length(T, base=self.chunk_size * 4, growth=1.4)
        enc = F.pad(enc, (0, 0, 0, Tb - T))
        nb = batch_beam_search(
            self.model, enc[None],
            torch.tensor([T], dtype=torch.long, device=self.device),
            self.bs_config)[0]
        results = []
        for ids, _ in nb:
            toks = self.converter.ids2tokens(ids)
            results.append((self.tokenizer.tokens2text(toks), toks,
                            list(ids)))
        return results

    def _greedy_update(self, is_final: bool):
        """The CTC argmax of each window's encoder step; the valid frames
        extend the hypothesis (blanks and repeats dropped)."""
        for enc, out_valid in self._encoded_windows(is_final):
            ids = self.model.ctc_logits(enc).argmax(dim=-1)[0]
            for tok in ids.cpu().tolist()[:out_valid]:
                if tok != self.model.blank_id and tok != self._prev_tok:
                    self._hyp.append(tok)
                self._prev_tok = tok

    # -- public API ----------------------------------------------------

    @torch.no_grad()
    def __call__(self, speech: np.ndarray, is_final: bool = False):
        """Feed a piece of audio; -> the current n-best
        [(text, tokens, ids)]."""
        self.fe.push(speech, is_final=is_final)
        if self.search_type == "greedy":
            self._greedy_update(is_final)
            toks = self.converter.ids2tokens(self._hyp)
            results = [(self.tokenizer.tokens2text(toks), toks,
                        list(self._hyp))]
        else:
            self._blocks_since_decode += self._encode_pending(is_final)
            due = (self._blocks_since_decode >= self.decode_interval
                   or (is_final and self._enc_chunks))
            if self._enc_chunks and due:
                self._last_results = self._beam_decode()
                self._blocks_since_decode = 0
            results = list(self._last_results)
        if is_final:
            self.reset()
        return results


class StreamingSessionPool:
    """Up to ``max_sessions`` concurrent greedy streams over one batched
    encoder step of ``s2t``'s model (one row per session)."""

    def __init__(self, s2t: Speech2TextStreaming, max_sessions: int = 8):
        self.s2t = s2t
        self.B = max_sessions
        self._state = s2t.model.encoder_mod.init_stream_state(self.B,
                                                              s2t.device)
        self._fes = [None] * self.B
        self._hyps = [[] for _ in range(self.B)]
        self._prev = [-1] * self.B
        self._final = [False] * self.B

    def open(self) -> int:
        """A free session id; its row starts from nothing."""
        for i in range(self.B):
            if self._fes[i] is None:
                self._fes[i] = feature_extractor(self.s2t.cfg,
                                                 self.s2t.device)
                self._hyps[i] = []
                self._prev[i] = -1
                self._final[i] = False
                self._reset_state_row(i)
                return i
        raise RuntimeError("session pool full")

    def close(self, sid: int):
        self._fes[sid] = None

    def _reset_state_row(self, sid: int):
        st = self._state
        ctx, tail, off = (st.ctx.clone(), st.conv_tail.clone(),
                          st.frame_offset.clone())
        ctx[:, sid] = 0.0
        tail[:, sid] = 0.0
        off[sid] = 0
        self._state = type(st)(ctx=ctx, conv_tail=tail, frame_offset=off)

    @torch.no_grad()
    def push(self, sid: int, speech: np.ndarray, is_final: bool = False):
        """Feed audio to session ``sid`` and run every session's pending
        windows in batched rounds. -> sid's (text, tokens, ids); a final
        push closes the session."""
        self._fes[sid].push(np.asarray(speech, np.float32),
                            is_final=is_final)
        self._final[sid] = is_final
        self._drain()
        toks = self.s2t.converter.ids2tokens(self._hyps[sid])
        out = (self.s2t.tokenizer.tokens2text(toks), toks,
               list(self._hyps[sid]))
        if is_final:
            self.close(sid)
        return out

    def _drain(self):
        """Rounds of at most one window per session, batched, until no
        session holds a window."""
        s2t = self.s2t
        W, A = s2t.feat_window, s2t.feat_advance
        n_mels = s2t.fe.n_mels
        while True:
            feats = np.zeros((self.B, W, n_mels), np.float32)
            active = np.zeros((self.B,), bool)
            valid_out = [0] * self.B
            for i, fe in enumerate(self._fes):
                if fe is None:
                    continue
                popped = fe.pop_one_window(W, A, is_final=self._final[i],
                                           with_valid=True)
                if popped is not None:
                    feats[i], n_valid = popped
                    valid_out[i] = subsampled_valid_len(s2t.rate, n_valid)
                    active[i] = True
            if not active.any():
                return
            old = self._state
            enc, new = s2t.encoder_step(feats, old)
            m = torch.from_numpy(active).to(s2t.device)
            # ctx and conv_tail are (layers, B, ...), the offset (B,)
            self._state = type(old)(
                ctx=torch.where(m[None, :, None, None], new.ctx, old.ctx),
                conv_tail=torch.where(m[None, :, None, None], new.conv_tail,
                                      old.conv_tail),
                frame_offset=torch.where(m, new.frame_offset,
                                         old.frame_offset))
            ids = torch.log_softmax(s2t.model.ctc_logits(enc), dim=-1
                                    ).argmax(dim=-1).cpu().numpy()
            for i in np.flatnonzero(active):
                for tok in ids[i, :valid_out[i]].tolist():
                    if tok != s2t.model.blank_id and tok != self._prev[i]:
                        self._hyps[i].append(tok)
                    self._prev[i] = tok
