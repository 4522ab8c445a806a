"""WPE (weighted prediction error) dereverberation (counterpart of
espnet_tpu/models/enh/wpe.py): iterative multichannel linear prediction
of the late reverberation from delayed frames, per frequency, in complex
arithmetic (complex64 for a complex64 input)."""

from __future__ import annotations

import torch


def _stack_taps(spec, taps: int, delay: int):
    """(B, F, C, T) -> (B, F, C taps, T): the frames delayed by delay, ...,
    delay + taps - 1, zero before the start, tap-major."""
    T = spec.shape[-1]
    zeros = torch.zeros_like(spec)
    return torch.cat([torch.cat([zeros[..., :d], spec[..., :T - d]], dim=-1)
                      for d in range(delay, delay + taps)], dim=2)


def wpe_iterates(spec, taps: int = 5, delay: int = 3, iterations: int = 3,
                 eps: float = 1e-8):
    """(B, T, C, F) complex STFT -> each iteration's (loaded R, estimate)
    in turn, as ``wpe_dereverb`` runs them: the power estimate (mean over
    channels of |y|^2, + eps), the weighted correlations R and P of the
    delayed stack, R loaded by 1e-4 tr(R) / K + eps, G = R^-1 P, y = x -
    G^H stack; R is (B, F, K, K) and the estimate (B, T, C, F)."""
    x = spec.permute(0, 3, 2, 1)                          # (B, F, C, T)
    y = x
    tilde = _stack_taps(x, taps, delay)                   # (B, F, K, T)
    K = tilde.shape[2]
    eye = torch.eye(K, dtype=x.dtype, device=x.device)
    for _ in range(iterations):
        w = 1.0 / ((y.abs() ** 2).mean(dim=2) + eps)[:, :, None]
        R = torch.einsum("bfkt,bflt->bfkl", tilde * w, tilde.conj())
        P = torch.einsum("bfkt,bfct->bfkc", tilde * w, x.conj())
        load = (torch.diagonal(R, dim1=-2, dim2=-1).sum(-1).real[
            ..., None, None] / K) * 1e-4 + eps
        R = R + load * eye
        G = torch.linalg.solve(R, P)                      # (B, F, K, C)
        y = x - torch.einsum("bfkc,bfkt->bfct", G.conj(), tilde)
        yield R, y.permute(0, 3, 2, 1)


def wpe_dereverb(spec, taps: int = 5, delay: int = 3, iterations: int = 3,
                 eps: float = 1e-8):
    """(B, T, C, F) complex STFT -> the dereverberated STFT, same shape:
    the last of ``wpe_iterates``."""
    for _, y in wpe_iterates(spec, taps, delay, iterations, eps):
        pass
    return y
