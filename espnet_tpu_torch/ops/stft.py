"""STFT as a DFT matrix product (counterpart of espnet_tpu/ops/stft.py).

torch.stft semantics: centre reflect padding, periodic Hann window,
one-sided spectrum. The window is folded into a (n_fft, 2F) matrix built
with numpy exactly as the JAX package builds it, so both packages
multiply by the same numbers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window(periodic=True))."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(
        np.float32)


@functools.lru_cache(maxsize=16)
def _windowed_dft_matrix(n_fft: int, win_length: int, window: str | None,
                         normalized: bool) -> np.ndarray:
    """(n_fft, 2F) matrix: frames @ M -> [real | imag] of rfft(frame * w).

    A window shorter than n_fft is zero-padded to the centre.
    """
    n_freq = n_fft // 2 + 1
    if window == "hann":
        w = hann_window(win_length)
    elif window is None:
        w = np.ones(win_length, dtype=np.float32)
    else:
        raise ValueError(f"unsupported window: {window}")
    pad_l = (n_fft - win_length) // 2
    wfull = np.zeros(n_fft, dtype=np.float64)
    wfull[pad_l:pad_l + win_length] = w
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freq)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    mat = np.concatenate([np.cos(ang), np.sin(ang)], axis=1)
    mat = mat * wfull[:, None]
    if normalized:
        mat = mat / np.sqrt(n_fft)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=16)
def dft_matrix(n_fft: int, win_length: int, window: str | None,
               normalized: bool, device: str) -> torch.Tensor:
    """The windowed DFT matrix as a tensor on ``device``."""
    return torch.from_numpy(_windowed_dft_matrix(
        n_fft, win_length, window, normalized)).to(device)


def _center_pad(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    pad = n_fft // 2
    return F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]


def stft(x: torch.Tensor, ilens: torch.Tensor | None = None, *,
         n_fft: int = 512, win_length: int | None = None,
         hop_length: int = 128, window: str | None = "hann",
         center: bool = True, normalized: bool = False):
    """(B, S) -> real (B, T, F), imag (B, T, F), olens (B,) or None.

    Frames past olens are not zeroed; callers mask them.
    """
    if win_length is None:
        win_length = n_fft
    x = x.float()
    if center:
        x = _center_pad(x, n_fft)
    frames = x.unfold(-1, n_fft, hop_length)  # (B, T, n_fft)
    spec = frames @ dft_matrix(n_fft, win_length, window, normalized,
                               str(x.device))
    n_freq = n_fft // 2 + 1
    olens = None
    if ilens is not None:
        eff = ilens + (2 * (n_fft // 2) if center else 0)
        olens = torch.clamp((eff - n_fft) // hop_length + 1, min=0).to(
            torch.int64)
    return spec[..., :n_freq], spec[..., n_freq:], olens


def stft_power(x, ilens=None, **kw):
    """|STFT|^2: (B, S) -> (B, T, F), olens."""
    real, imag, olens = stft(x, ilens, **kw)
    return real * real + imag * imag, olens


def stft_segmented(x: torch.Tensor, *, n_fft: int = 512,
                   hop_length: int = 128, window: str | None = "hann",
                   normalized: bool = False):
    """Centred STFT by hop-segment accumulation; requires hop | n_fft.

    Frame t is hop chunks t .. t+k-1 of the padded signal (k = n_fft /
    hop), so spec[t] = sum_j chunk[t + j] @ W[j*hop:(j+1)*hop]: no frame
    matrix is built. Returns (real, imag) of shape (B, T, F).
    """
    if n_fft % hop_length:
        raise ValueError("stft_segmented requires hop | n_fft")
    k = n_fft // hop_length
    x = _center_pad(x.float(), n_fft)
    B, S = x.shape
    T = 1 + (S - n_fft) // hop_length
    n_chunks = T + k - 1
    x = F.pad(x, (0, max(n_chunks * hop_length - S, 0)))
    chunks = x[:, :n_chunks * hop_length].reshape(B, n_chunks, hop_length)
    mat = dft_matrix(n_fft, n_fft, window, normalized, str(x.device))
    spec = sum(chunks[:, j:j + T] @ mat[j * hop_length:(j + 1) * hop_length]
               for j in range(k))
    n_freq = n_fft // 2 + 1
    return spec[..., :n_freq], spec[..., n_freq:]
