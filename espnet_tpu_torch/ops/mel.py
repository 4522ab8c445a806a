"""Mel filterbank and log-mel (counterpart of espnet_tpu/ops/mel.py).

librosa's slaney mel scale and area normalisation, rebuilt in numpy;
log(clamp(power @ mel, 1e-10)) per frame.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hz_to_mel(freq, htk: bool = False) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
        freq / f_sp)


def mel_to_hz(mels, htk: bool = False) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    f_sp * mels)


@functools.lru_cache(maxsize=16)
def mel_filterbank(fs: int = 16000, n_fft: int = 512, n_mels: int = 80,
                   fmin: float = 0.0, fmax: float | None = None,
                   htk: bool = False, norm: str | None = "slaney"
                   ) -> np.ndarray:
    """Triangular mel weights of shape (n_freq, n_mels), for power @ W."""
    if fmax is None:
        fmax = fs / 2.0
    n_freq = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, fs / 2.0, n_freq)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(np.array(fmin), htk),
                                    hz_to_mel(np.array(fmax), htk),
                                    n_mels + 2), htk)
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
        weights = weights * enorm[:, None]
    return np.ascontiguousarray(weights.T, dtype=np.float32)


@functools.lru_cache(maxsize=16)
def mel_matrix(fs: int, n_fft: int, n_mels: int, fmin: float,
               fmax: float | None, htk: bool, device: str) -> torch.Tensor:
    """The mel filterbank as a tensor on ``device``."""
    return torch.from_numpy(mel_filterbank(fs, n_fft, n_mels, fmin, fmax,
                                           htk)).to(device)


def log_mel(power: torch.Tensor, *, fs: int = 16000, n_fft: int = 512,
            n_mels: int = 80, fmin: float = 0.0, fmax: float | None = None,
            htk: bool = False, log_base: float | None = None
            ) -> torch.Tensor:
    """(B, T, n_freq) power spectrum -> (B, T, n_mels) log-mel, in float32
    (float64 for a float64 power)."""
    power = power.double() if power.dtype == torch.float64 else power.float()
    w = mel_matrix(fs, n_fft, n_mels, fmin, fmax, htk,
                   str(power.device)).to(power.dtype)
    out = torch.log(torch.clamp(power @ w, min=1e-10))
    if log_base is not None:
        out = out / np.log(log_base)
    return out
