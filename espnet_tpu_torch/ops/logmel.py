"""Fused log-mel: the CUDA kernel and its plain version.

Counterpart of espnet_tpu/ops/pallas/logmel_kernel.py:fused_logmel. On a
CUDA tensor it launches ``logmel_fwd`` (csrc/logmel.cu); on a CPU tensor
it runs ``fused_logmel_plain``: centred Hann STFT power by hop-segment
accumulation, then log(max(power @ mel, 1e-10)). The kernel has no
backward, as the Pallas kernel has no VJP: on the card a wave that needs
a gradient is refused rather than given a detached result.
"""

from __future__ import annotations

import torch

from espnet_tpu_torch.ops import _cuda
from espnet_tpu_torch.ops.mel import log_mel, mel_matrix
from espnet_tpu_torch.ops.stft import dft_matrix, stft_segmented


def n_frames(n_samples: int, n_fft: int, hop_length: int) -> int:
    """Frames of the centred STFT of n_samples samples."""
    return (n_samples + 2 * (n_fft // 2) - n_fft) // hop_length + 1


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
    if torch.is_grad_enabled() and wave.requires_grad:
        raise RuntimeError("fused_logmel: the kernel has no backward; the "
                           "wave must not require a gradient")
    if wave.dim() != 2 or wave.dtype != torch.float32:
        raise ValueError(f"fused_logmel: need a (B, S) float32 wave, got "
                         f"{tuple(wave.shape)} {wave.dtype}")
    B, S = wave.shape
    if n_fft % hop_length or not 1 <= n_mels <= 128 or S <= n_fft // 2:
        raise ValueError(f"fused_logmel: kernel needs hop | n_fft, n_mels "
                         f"<= 128 and S > n_fft/2, got n_fft={n_fft}, "
                         f"hop={hop_length}, n_mels={n_mels}, S={S}")
    wave = wave.contiguous()
    dev = str(wave.device)
    dft = dft_matrix(n_fft, n_fft, "hann", False, dev)
    mel = mel_matrix(fs, n_fft, n_mels, 0.0, None, False, dev)
    T = n_frames(S, n_fft, hop_length)
    out = torch.empty(B, T, n_mels, dtype=torch.float32, device=wave.device)
    err = _cuda.lib().logmel_fwd(
        wave.data_ptr(), dft.data_ptr(), mel.data_ptr(), out.data_ptr(),
        B, S, n_fft, hop_length, n_mels, T, _cuda.stream_ptr(wave.device))
    _cuda.check(err, "logmel_fwd")
    _cuda.LAUNCHES["logmel_fwd"] += 1
    return out
