"""STFT as a DFT matrix product, and its inverse (counterpart of
espnet_tpu/ops/stft.py).

torch.stft semantics: centre reflect padding, periodic Hann window,
one-sided spectrum. The window is folded into a (n_fft, 2F) matrix built
with numpy exactly as the JAX package builds it, so both packages
multiply by the same numbers. ``istft`` is torch.istft's: an inverse DFT
by matrix product, the window, an overlap-add and the division by the
overlap-added squared window.
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
    """(B, S) -> real (B, T, F), imag (B, T, F), olens (B,) or None, in
    float32 (float64 for a float64 input).

    Frames past olens are not zeroed; callers mask them.
    """
    if win_length is None:
        win_length = n_fft
    x = x.double() if x.dtype == torch.float64 else x.float()
    if center:
        x = _center_pad(x, n_fft)
    frames = x.unfold(-1, n_fft, hop_length)  # (B, T, n_fft)
    spec = frames @ dft_matrix(n_fft, win_length, window, normalized,
                               str(x.device)).to(x.dtype)
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
    matrix is built. Returns (real, imag) of shape (B, T, F), in float32
    (float64 for a float64 input).
    """
    if n_fft % hop_length:
        raise ValueError("stft_segmented requires hop | n_fft")
    k = n_fft // hop_length
    x = _center_pad(x.double() if x.dtype == torch.float64 else x.float(),
                    n_fft)
    B, S = x.shape
    T = 1 + (S - n_fft) // hop_length
    n_chunks = T + k - 1
    x = F.pad(x, (0, max(n_chunks * hop_length - S, 0)))
    chunks = x[:, :n_chunks * hop_length].reshape(B, n_chunks, hop_length)
    mat = dft_matrix(n_fft, n_fft, window, normalized,
                     str(x.device)).to(x.dtype)
    spec = sum(chunks[:, j:j + T] @ mat[j * hop_length:(j + 1) * hop_length]
               for j in range(k))
    n_freq = n_fft // 2 + 1
    return spec[..., :n_freq], spec[..., n_freq:]


@functools.lru_cache(maxsize=16)
def _istft_tables(n_fft: int, win_length: int, window: str | None):
    """(2F, n_fft) inverse real DFT ([real; imag] rows, the Hermitian
    fold-in weights: 1 for DC and Nyquist, 2 for the bins between) and
    the window zero-padded to n_fft, as the JAX package builds them."""
    n_freq = n_fft // 2 + 1
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * k * f / n_fft
    wts = np.full(n_freq, 2.0)
    wts[0] = 1.0
    if n_fft % 2 == 0:
        wts[-1] = 1.0
    cos_m = (np.cos(ang) * wts / n_fft).astype(np.float32)
    sin_m = (-np.sin(ang) * wts / n_fft).astype(np.float32)
    if window == "hann":
        w = hann_window(win_length)
    elif window is None:
        w = np.ones(win_length, dtype=np.float32)
    else:
        raise ValueError(f"unsupported window: {window}")
    pad_l = (n_fft - win_length) // 2
    wfull = np.zeros(n_fft, dtype=np.float32)
    wfull[pad_l:pad_l + win_length] = w
    return np.concatenate([cos_m.T, sin_m.T]), wfull


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(B, T, n) frames, frame t starting at t * hop -> (B, n + hop (T-1))
    sums. F.fold gathers the frames that cover each sample, without
    atomics, so the sums come out in the same order on every run."""
    B, T, n = frames.shape
    out_len = n + hop_length * (T - 1)
    return F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                  kernel_size=(1, n), stride=(1, hop_length))[:, 0, 0]


def istft(real: torch.Tensor, imag: torch.Tensor, *, n_fft: int = 512,
          win_length: int | None = None, hop_length: int = 128,
          window: str | None = "hann", center: bool = True,
          length: int | None = None) -> torch.Tensor:
    """(B, T, F) real, imag -> (B, S) float32 (float64 for float64
    inputs), normalised by the overlap-added squared window (floored at
    1e-11). With ``length`` the centre pad is
    dropped on the left and the signal trimmed or zero-padded to
    ``length``; without it both centre pads are dropped."""
    if win_length is None:
        win_length = n_fft
    B, T, n_freq = real.shape
    if n_freq != n_fft // 2 + 1:
        raise ValueError(f"{n_freq} bins for n_fft {n_fft}")
    mat, wfull = _istft_tables(n_fft, win_length, window)
    dtype = torch.float64 if real.dtype == torch.float64 else torch.float32
    dev = real.device
    frames = torch.cat([real, imag], dim=-1).to(dtype) @ torch.from_numpy(
        mat).to(dev, dtype)
    w = torch.from_numpy(wfull).to(dev, dtype)
    sig = overlap_add(frames * w, hop_length)
    wsq = overlap_add((w * w).expand(1, T, n_fft), hop_length)
    sig = sig / wsq.clamp(min=1e-11)
    out_len = sig.shape[1]
    if center:
        pad = n_fft // 2
        end = out_len - pad if length is None else min(pad + length, out_len)
        sig = sig[:, pad:end]
    if length is not None:
        sig = (sig[:, :length] if sig.shape[1] >= length
               else F.pad(sig, (0, length - sig.shape[1])))
    return sig
