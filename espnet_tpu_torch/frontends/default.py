"""Default frontend: wave -> STFT power -> log-mel, and GlobalMVN
(counterpart of espnet_tpu/frontends/default.py).

Where ``_fused_eligible()`` holds, the frontend computes its features
with ``ops.logmel.fused_logmel``: the log-mel CUDA kernel on the card
(under both "auto" and "pallas"; the JAX package's "auto" picks XLA
matmuls, a choice made for the TPU's compiler) and the kernel's plain
version on the CPU. The kernel (csrc/logmel.cu, replacing
espnet_tpu/ops/pallas/logmel_kernel.py:fused_logmel) is a shared-memory
FFT per frame with a sparse mel sum, bound by the bytes of its wave and
log-mel; so besides the JAX package's rule (Hann window of n_fft samples,
centred, hop | n_fft, the default mel scale, natural log) eligibility asks
what the FFT takes: a power-of-two n_fft from 64 to 2048 and at most 128
mel bins. A wave that needs a gradient (the joint enhancement + ASR
model trains through its frontend) still takes the kernel, whose
backward is its plain version's. Otherwise the frontend takes the plain
STFT and log-mel ops. A float64 wave stays float64 (on the CPU, through
the plain versions: the float64 reference of a grad check).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from espnet_tpu_torch.ops.logmel import fused_logmel, kernel_takes
from espnet_tpu_torch.ops.mel import log_mel
from espnet_tpu_torch.ops.stft import stft_power
from espnet_tpu_torch.utils.masks import make_non_pad_mask, mask_fill


@dataclasses.dataclass(frozen=True)
class DefaultFrontend:
    fs: int = 16000
    n_fft: int = 512
    win_length: int | None = None
    hop_length: int = 128
    window: str = "hann"
    center: bool = True
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float | None = None
    htk: bool = False
    log_base: float | None = None
    use_fused_kernel: str = "auto"   # "auto" | "pallas" | "never"

    @property
    def output_size(self) -> int:
        return self.n_mels

    def _fused_eligible(self) -> bool:
        return (self.use_fused_kernel in ("auto", "pallas")
                and self.win_length in (None, self.n_fft)
                and self.window == "hann" and self.center
                and kernel_takes(self.n_fft, self.hop_length, self.n_mels)
                and self.fmin == 0.0 and self.fmax is None
                and not self.htk and self.log_base is None)

    def __call__(self, speech: torch.Tensor, lengths: torch.Tensor):
        """(B, S) float wave, (B,) int -> (B, T, n_mels), (B,) lengths."""
        if self._fused_eligible():
            feats = fused_logmel(
                speech if speech.dtype == torch.float64 else speech.float(),
                fs=self.fs, n_fft=self.n_fft, hop_length=self.hop_length,
                n_mels=self.n_mels)
            olens = (lengths + 2 * (self.n_fft // 2)
                     - self.n_fft) // self.hop_length + 1
        else:
            power, olens = stft_power(
                speech, lengths, n_fft=self.n_fft, win_length=self.win_length,
                hop_length=self.hop_length, window=self.window,
                center=self.center)
            feats = log_mel(power, fs=self.fs, n_fft=self.n_fft,
                            n_mels=self.n_mels, fmin=self.fmin,
                            fmax=self.fmax, htk=self.htk,
                            log_base=self.log_base)
        valid = make_non_pad_mask(olens, feats.shape[1])
        return mask_fill(feats, valid), olens


@dataclasses.dataclass(frozen=True)
class GlobalMVN:
    """Global mean-variance normalisation from collected stats."""

    mean: np.ndarray  # (D,)
    istd: np.ndarray  # (D,)

    @classmethod
    def from_stats(cls, count, sum_, sum_square, eps: float = 1e-20):
        mean = sum_ / count
        var = np.maximum(sum_square / count - mean * mean, eps)
        return cls(mean=mean.astype(np.float32),
                   istd=(1.0 / np.sqrt(var)).astype(np.float32))

    @classmethod
    def from_file(cls, path):
        with np.load(path) as d:
            return cls.from_stats(d["count"], d["sum"], d["sum_square"])

    def __call__(self, x: torch.Tensor, lengths: torch.Tensor):
        mean = torch.from_numpy(self.mean).to(x.device)
        istd = torch.from_numpy(self.istd).to(x.device)
        x = (x - mean) * istd
        return mask_fill(x, make_non_pad_mask(lengths, x.shape[1])), lengths
