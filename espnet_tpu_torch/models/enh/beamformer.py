"""Mask-based MVDR beamforming (counterpart of
espnet_tpu/models/enh/beamformer.py): a BLSTM mask net on the reference
channel's magnitude gives speech and noise masks; their mask-weighted
spatial covariances give the MVDR filter per frequency, applied to every
channel's STFT. The covariances and the solve are complex64 (complex128
for a float64 input), as in the JAX package.

``mvdr_filter`` divides by max(|tr(Phi_n^-1 Phi_s)|, 1e-10), a real
number, as the JAX package does; upstream ESPnet divides by the complex
trace itself (ROADMAP C.3).
"""

from __future__ import annotations

import torch
from torch import nn

from espnet_tpu_torch.models.enh.losses import si_snr_loss
from espnet_tpu_torch.models.enh.separators import RNNSeparator
from espnet_tpu_torch.ops.stft import istft, stft_channels
from espnet_tpu_torch.utils.masks import make_non_pad_mask


def _trace(x):
    return torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)


def spatial_covariance(spec, mask, valid):
    """spec (B, T, C, F) complex, mask (B, T, F), valid (B, T) -> (B, F,
    C, C): sum_t m x x^H over the valid frames, over sum_t m (floored at
    1e-6)."""
    m = mask * valid[:, :, None].to(mask.dtype)
    psd = torch.einsum("btcf,btdf->bfcd", spec * m[:, :, None], spec.conj())
    return psd / m.sum(1).clamp(min=1e-6)[:, :, None, None]


def loaded_noise(psd_n, diag_load: float = 1e-6):
    """Phi_n loaded by diag_load tr(Phi_n) / C + 1e-10: the system that
    ``mvdr_filter`` solves."""
    C = psd_n.shape[-1]
    eye = torch.eye(C, dtype=psd_n.dtype, device=psd_n.device)
    return psd_n + (diag_load * _trace(psd_n).real[..., None, None] / C
                    + 1e-10) * eye


def mvdr_filter(psd_s, psd_n, ref_ch: int = 0, diag_load: float = 1e-6):
    """-> (B, F, C) MVDR weights Phi_n^-1 Phi_s u / |tr(Phi_n^-1 Phi_s)|,
    Phi_n loaded (``loaded_noise``)."""
    num = torch.linalg.solve(loaded_noise(psd_n, diag_load), psd_s)
    return num[..., ref_ch] / _trace(num).abs().clamp(min=1e-10)[..., None]


class NeuralBeamformer(nn.Module):
    """(B, S, C) mixture -> the single-channel enhanced (B, S) wave."""

    def __init__(self, n_fft: int = 512, hop_length: int = 128,
                 mask_hidden: int = 128, mask_layers: int = 2,
                 ref_channel: int = 0):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        self.ref_channel = ref_channel
        self.mask_net = RNNSeparator(input_dim=n_fft // 2 + 1, num_spk=2,
                                     rnn_hidden=mask_hidden,
                                     num_layers=mask_layers)

    def forward(self, speech_mix, speech_mix_lengths, speech_ref1=None,
                **kw):
        """Without a reference -> (wave, lengths); with one -> (loss,
        stats {loss, si_snr}, weight = B)."""
        est, olens = self.enhance(speech_mix, speech_mix_lengths)
        if speech_ref1 is None:
            return est, olens
        loss = si_snr_loss(est, speech_ref1, speech_mix_lengths).mean()
        return loss, {"loss": loss, "si_snr": -loss}, float(
            speech_mix.shape[0])

    def enhance(self, speech_mix, speech_mix_lengths):
        S = speech_mix.shape[1]
        n_fft, hop = self.n_fft, self.hop_length
        re, im = stft_channels(speech_mix, n_fft=n_fft, hop_length=hop)
        spec = torch.complex(re, im).transpose(-1, -2)       # (B, T, C, F)
        T = spec.shape[1]
        valid = make_non_pad_mask(
            (speech_mix_lengths + 2 * (n_fft // 2) - n_fft) // hop + 1, T)
        mask_s, mask_n = self.mask_net(spec[:, :, self.ref_channel].abs())
        w = mvdr_filter(spatial_covariance(spec, mask_s, valid),
                        spatial_covariance(spec, mask_n, valid),
                        self.ref_channel)
        enh = torch.einsum("bfc,btcf->btf", w.conj(), spec)
        return istft(enh.real, enh.imag, n_fft=n_fft, hop_length=hop,
                     length=S), speech_mix_lengths
