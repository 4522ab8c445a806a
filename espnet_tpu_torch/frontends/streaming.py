"""Incremental (chunk-by-chunk) log-mel features for streaming ASR
(counterpart of espnet_tpu/frontends/streaming.py).

Buffered raw samples become log-mel frames through a ``center=False``
STFT, so a frame never changes once made; the training-time centre
padding is mimicked by seeding the buffer with n_fft // 2 zeros and, on
the final push, flushing n_fft // 2 more. The sample and feature buffers
live on the host (numpy), as the JAX package's do; the STFT and the mel
product run on the extractor's device: the card unless ``device="cpu"``
is given. Shared by the CTC and transducer streaming APIs.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from espnet_tpu_torch.nn.subsampling import RATE_CONVS
from espnet_tpu_torch.ops.mel import log_mel
from espnet_tpu_torch.ops.stft import stft_power
from espnet_tpu_torch.utils.device import resolve_device

# valid-conv receptive-field extras per subsampling rate: k encoder
# frames need rate * k + extra feature frames (nn/subsampling.py)
_SUBSAMPLE_EXTRA = {1: 0, 2: 5, 4: 3, 6: 5, 8: 7}


class StreamingFeatureExtractor:
    def __init__(self, n_fft: int = 512, hop_length: int = 128,
                 n_mels: int = 80, fs: int = 16000, device=None):
        self.n_fft = n_fft
        self.hop = hop_length
        self.n_mels = n_mels
        self.fs = fs
        self.device = resolve_device(device)
        self.reset()

    def reset(self):
        self._samples = np.zeros((self.n_fft // 2,), np.float32)
        self.feats = np.zeros((0, self.n_mels), np.float32)

    @torch.no_grad()
    def push(self, speech: np.ndarray, is_final: bool = False) -> None:
        """Buffer samples; extend ``self.feats`` with completed frames."""
        parts = [self._samples, np.asarray(speech, np.float32)]
        if is_final:
            parts.append(np.zeros((self.n_fft // 2,), np.float32))
        self._samples = np.concatenate(parts)
        S = len(self._samples)
        n_frames = (S - self.n_fft) // self.hop + 1 if S >= self.n_fft else 0
        if n_frames <= 0:
            return
        wave = torch.from_numpy(self._samples[None]).to(self.device)
        power, _ = stft_power(wave, None, n_fft=self.n_fft,
                              hop_length=self.hop, center=False)
        feats = log_mel(power, fs=self.fs, n_fft=self.n_fft,
                        n_mels=self.n_mels)
        self.feats = np.concatenate(
            [self.feats, feats[0, :n_frames].cpu().numpy()], axis=0)
        self._samples = self._samples[n_frames * self.hop:]

    def pop_one_window(self, window: int, advance: int,
                       is_final: bool = False, with_valid: bool = False):
        """One (window, n_mels) chunk, or None: while not final, a full
        window; on the final push also a last window with more than
        window - advance frames, zero-padded. ``with_valid`` returns
        (chunk, n_valid_frames) so the caller can trim the padded tail."""
        if len(self.feats) >= window or (
                is_final and len(self.feats) > window - advance):
            take = min(window, len(self.feats))
            chunk = self.feats[:take]
            self.feats = self.feats[advance:]
            if take < window:
                chunk = np.pad(chunk, ((0, window - take), (0, 0)))
            return (chunk, take) if with_valid else chunk
        return None

    def pop_windows(self, window: int, advance: int,
                    is_final: bool = False) -> List[np.ndarray]:
        """Every window ``pop_one_window`` would give, in order."""
        out = []
        while (chunk := self.pop_one_window(window, advance,
                                            is_final)) is not None:
            out.append(chunk)
        return out


def subsample_window(rate: int, chunk_size: int) -> tuple:
    """(window, advance) in feature frames for an encoder chunk of
    ``chunk_size`` output frames."""
    return rate * chunk_size + _SUBSAMPLE_EXTRA[rate], rate * chunk_size


def subsampled_valid_len(rate: int, n_valid_feats: int) -> int:
    """Encoder frames made from the first ``n_valid_feats`` feature frames
    of a window alone (the valid convs' arithmetic)."""
    n = n_valid_feats
    for k, s in RATE_CONVS.get(rate, []):
        n = (n - k + s) // s
    return max(int(n), 0)
