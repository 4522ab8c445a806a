"""Streaming separation (counterpart of
espnet_tpu/bin/enh_inference_streaming.py): push pieces of a mixture,
get the separated speech as it becomes available.

Windows of ``segment_size`` seconds, advancing by half a window, go
through SeparateSpeech under a sqrt-Hann window at analysis and again at
synthesis (their product, a Hann window, sums to one at half-window
hops); each window's second half is carried and added to the next
window's first half. ``is_final`` separates what is left, zero-padded to
a window, and flushes the carry.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from espnet_tpu_torch.bin.enh_inference import SeparateSpeech


class SeparateSpeechStreaming:
    def __init__(self, train_config=None, model_file=None,
                 segment_size: float = 1.0, **kwargs):
        self.sep = SeparateSpeech(train_config, model_file, **kwargs)
        self.fs = self.sep.fs
        self.win = int(segment_size * self.fs)
        self.hop = self.win // 2
        self.window = np.sqrt(np.hanning(self.win).astype(np.float32)
                              + 1e-8)
        self.reset()

    def reset(self):
        self._buf = np.zeros((0,), np.float32)
        self._tail: Optional[List[np.ndarray]] = None   # per speaker

    def __call__(self, speech_chunk: np.ndarray, is_final: bool = False
                 ) -> List[np.ndarray]:
        """-> list over speakers of the newly available samples."""
        self._buf = np.concatenate(
            [self._buf, np.asarray(speech_chunk, np.float32)])
        outs: Optional[List[np.ndarray]] = None
        while len(self._buf) >= self.win or (is_final and len(self._buf)):
            seg = self._buf[:self.win]
            if len(seg) < self.win:
                seg = np.pad(seg, (0, self.win - len(seg)))
            self._buf = self._buf[self.hop:]
            est = self.sep((seg * self.window)[None])
            step = []
            for s, e in enumerate(est):
                e = np.asarray(e[0]) * self.window
                if self._tail is None or s >= len(self._tail):
                    head = e[:self.hop]
                else:
                    head = e[:self.hop] + self._tail[s]
                step.append(head)
            self._tail = [np.asarray(e[0] * self.window)[self.hop:]
                          for e in est]
            outs = step if outs is None else [
                np.concatenate([o, n]) for o, n in zip(outs, step)]
            if is_final and len(self._buf) < self.win - self.hop:
                break
        if outs is None:
            outs = [np.zeros((0,), np.float32)]
        if is_final:
            if self._tail is not None:
                outs = [np.concatenate([o, t])
                        for o, t in zip(outs, self._tail)]
            self.reset()
        return outs
