"""Fused log-mel: the CUDA kernel and its plain version.

Counterpart of espnet_tpu/ops/pallas/logmel_kernel.py:fused_logmel. On a
CUDA tensor it launches ``logmel_fwd`` (csrc/logmel.cu): per frame the
n_fft-point real FFT as an n_fft/2-point complex FFT in shared memory, the
power, and the mel sum over each filter's nonzero weights only, bound by
the bytes of the wave and the log-mel; it takes every
power-of-two n_fft from 64 to 2048 with hop | n_fft and n_mels <= 128 (the
frontend's eligibility rule) and raises on anything else. Its tables are
built here: the window and the twiddles exp(-2 pi i k / n_fft) in float64
rounded to fp32 (``fft_tables``), and the mel filterbank packed per mel bin
as (first bin, count, offset) and the weights (``pack_mel``), cached per
device. On a CPU tensor it runs ``fused_logmel_plain``: centred Hann STFT
power by hop-segment accumulation, then log(max(power @ mel, 1e-10)).
Where the wave needs a gradient (the joint enhancement + ASR model trains
through its frontend) the kernel runs as a ``torch.autograd.Function``
whose backward differentiates the plain version, recomputed from the
saved wave: the Pallas kernel has no VJP, and the JAX package
differentiates XLA's STFT there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from espnet_tpu_torch.ops import _cuda
from espnet_tpu_torch.ops.mel import log_mel, mel_filterbank
from espnet_tpu_torch.ops.stft import hann_window, stft_segmented


def n_frames(n_samples: int, n_fft: int, hop_length: int) -> int:
    """Frames of the centred STFT of n_samples samples."""
    return (n_samples + 2 * (n_fft // 2) - n_fft) // hop_length + 1


def kernel_takes(n_fft: int, hop_length: int, n_mels: int) -> bool:
    """Whether the CUDA kernel takes this shape: n_fft a power of two in
    64..2048, hop | n_fft, 1 <= n_mels <= 128."""
    return (64 <= n_fft <= 2048 and n_fft & (n_fft - 1) == 0
            and hop_length >= 1 and n_fft % hop_length == 0
            and 1 <= n_mels <= 128)


@functools.lru_cache(maxsize=16)
def fft_tables(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's window (n_fft,), ``ops.stft.hann_window``, and its
    twiddles (n_fft, 2): exp(-2 pi i k / n_fft) for k < n_fft as (re, im),
    computed in float64 and rounded to fp32."""
    ang = -2.0 * np.pi * np.arange(n_fft) / n_fft
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return hann_window(n_fft), tw


@functools.lru_cache(maxsize=16)
def pack_mel(fs: int, n_fft: int, n_mels: int
             ) -> tuple[np.ndarray, np.ndarray]:
    """The mel filterbank of ``mel_matrix(fs, n_fft, n_mels, 0, None,
    False)`` packed per mel bin: idx (n_mels, 3) int32 holding the first
    nonzero bin, the count up to the last nonzero one and the offset into
    the weights (nnz,) float32; an all-zero filter gets count 0."""
    dense = mel_filterbank(fs, n_fft, n_mels, 0.0, None, False)
    idx = np.zeros((n_mels, 3), np.int32)
    weights = []
    offset = 0
    for m in range(n_mels):
        nz = np.flatnonzero(dense[:, m])
        first, count = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size \
            else (0, 0)
        idx[m] = (first, count, offset)
        weights.append(dense[first:first + count, m])
        offset += count
    return idx, np.concatenate(weights).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _kernel_tables(fs: int, n_fft: int, n_mels: int, device: str):
    """fft_tables and pack_mel as tensors on ``device``."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in (*fft_tables(n_fft), *pack_mel(fs, n_fft, n_mels)))


def fused_logmel_plain(wave, *, fs: int = 16000, n_fft: int = 512,
                       hop_length: int = 128, n_mels: int = 80):
    real, imag = stft_segmented(wave, n_fft=n_fft, hop_length=hop_length)
    return log_mel(real * real + imag * imag, fs=fs, n_fft=n_fft,
                   n_mels=n_mels)


def fused_logmel(wave, *, fs: int = 16000, n_fft: int = 512,
                 hop_length: int = 128, n_mels: int = 80):
    """(B, S) float32 wave -> (B, T, n_mels) log-mel, T = n_frames(S).

    Frames past an utterance's own length are computed from the padding;
    callers mask them.
    """
    if wave.device.type == "cpu":
        return fused_logmel_plain(wave, fs=fs, n_fft=n_fft,
                                  hop_length=hop_length, n_mels=n_mels)
    if wave.device.type != "cuda":
        raise RuntimeError(f"fused_logmel: no kernel for {wave.device}")
    return _FusedLogmel.apply(wave, fs, n_fft, hop_length, n_mels)


def _launch(wave, fs: int, n_fft: int, hop_length: int, n_mels: int):
    """``logmel_fwd`` on a CUDA wave, counted."""
    if wave.dim() != 2 or wave.dtype != torch.float32:
        raise ValueError(f"fused_logmel: need a (B, S) float32 wave, got "
                         f"{tuple(wave.shape)} {wave.dtype}")
    B, S = wave.shape
    if (not kernel_takes(n_fft, hop_length, n_mels) or S <= n_fft // 2
            or not 1 <= B <= 65535):
        raise ValueError(f"fused_logmel: kernel needs a power-of-two n_fft "
                         f"in 64..2048, hop | n_fft, n_mels <= 128, "
                         f"S > n_fft/2 and B <= 65535, got n_fft={n_fft}, "
                         f"hop={hop_length}, n_mels={n_mels}, B={B}, S={S}")
    wave = wave.contiguous()
    win, tw, mel_idx, mel_w = _kernel_tables(fs, n_fft, n_mels,
                                             str(wave.device))
    T = n_frames(S, n_fft, hop_length)
    out = torch.empty(B, T, n_mels, dtype=torch.float32, device=wave.device)
    err = _cuda.lib().logmel_fwd(
        wave.data_ptr(), win.data_ptr(), tw.data_ptr(), mel_idx.data_ptr(),
        mel_w.data_ptr(), out.data_ptr(), B, S, n_fft, hop_length, n_mels,
        mel_w.numel(), T, _cuda.stream_ptr(wave.device))
    _cuda.check(err, "logmel_fwd")
    _cuda.LAUNCHES["logmel_fwd"] += 1
    return out


class _FusedLogmel(torch.autograd.Function):
    """The kernel's forward; the backward is the plain version's,
    recomputed from the saved wave."""

    @staticmethod
    def forward(ctx, wave, fs, n_fft, hop_length, n_mels):
        ctx.conf = dict(fs=fs, n_fft=n_fft, hop_length=hop_length,
                        n_mels=n_mels)
        ctx.save_for_backward(wave)
        return _launch(wave, fs, n_fft, hop_length, n_mels)

    @staticmethod
    def backward(ctx, grad):
        wave, = ctx.saved_tensors
        with torch.enable_grad():
            x = wave.detach().requires_grad_()
            out = fused_logmel_plain(x, **ctx.conf)
            gx, = torch.autograd.grad(out, x, grad)
        return gx, None, None, None, None
