"""Target-speaker extraction (counterpart of
espnet_tpu/models/enh/tse.py:TSEModel): a BLSTM over the enrollment's
STFT magnitude, its mean over the valid frames and a Linear make the
speaker embedding; a BLSTM stack over the mixture's magnitude, whose
first layer's output is scaled by the sigmoid of the embedding's
``adapt`` projection, gives one sigmoid mask for the spectrum; the
iSTFT gives the target's wave. Trained with -SI-SNR."""

from __future__ import annotations

import torch
from torch import nn

from espnet_tpu_torch.models.enh.losses import si_snr_loss
from espnet_tpu_torch.models.enh.separators import BLSTM
from espnet_tpu_torch.ops.stft import istft, stft
from espnet_tpu_torch.utils.masks import make_non_pad_mask


class TSEModel(nn.Module):

    def __init__(self, n_fft: int = 512, hop_length: int = 128,
                 hidden: int = 128, num_layers: int = 2, emb_dim: int = 64):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        self.num_layers = num_layers
        n_freq = n_fft // 2 + 1
        self.aux_net = nn.Linear(2 * (hidden // 2), emb_dim)
        self.aux_blstm = BLSTM(n_freq, hidden // 2)
        self.adapt = nn.Linear(emb_dim, 2 * hidden)
        for i in range(num_layers):
            self.add_module(f"blstm{i}", BLSTM(n_freq if i == 0
                                               else 2 * hidden, hidden))
        self.mask_out = nn.Linear(2 * hidden, n_freq)

    def _spec_mag(self, wav, lengths):
        re, im, flens = stft(wav, lengths, n_fft=self.n_fft,
                             hop_length=self.hop_length)
        return re, im, torch.sqrt(re * re + im * im + 1e-8), flens

    def embed_speaker(self, enroll, enroll_lengths):
        """(B, Se) enrollment -> (B, emb_dim)."""
        _, _, mag, flens = self._spec_mag(enroll, enroll_lengths)
        h = self.aux_blstm(mag)
        mask = make_non_pad_mask(flens, h.shape[1])[:, :, None]
        pooled = torch.where(mask, h, 0.0).sum(1) / mask.sum(1).clamp(
            min=1.0)
        return self.aux_net(pooled)

    def extract(self, speech_mix, speech_mix_lengths, enroll,
                enroll_lengths):
        """-> the target speaker's (B, S) estimate."""
        emb = self.embed_speaker(enroll, enroll_lengths)
        re, im, h, _ = self._spec_mag(speech_mix, speech_mix_lengths)
        scale = torch.sigmoid(self.adapt(emb))[:, None]
        for i in range(self.num_layers):
            h = getattr(self, f"blstm{i}")(h)
            if i == 0:
                h = h * scale
        m = torch.sigmoid(self.mask_out(h))
        return istft(re * m, im * m, n_fft=self.n_fft,
                     hop_length=self.hop_length, length=speech_mix.shape[1])

    def forward(self, speech_mix, speech_mix_lengths, enroll_ref1,
                speech_ref1, enroll_ref1_lengths=None, **kw):
        """-> (loss, stats {loss, si_snr}, weight = B). Without
        enrollment lengths the whole enrollment counts."""
        if enroll_ref1_lengths is None:
            enroll_ref1_lengths = torch.full(
                (enroll_ref1.shape[0],), enroll_ref1.shape[1],
                device=enroll_ref1.device)
        est = self.extract(speech_mix, speech_mix_lengths, enroll_ref1,
                           enroll_ref1_lengths)
        loss = si_snr_loss(est, speech_ref1, speech_mix_lengths).mean()
        return loss, {"loss": loss, "si_snr": -loss}, float(
            speech_mix.shape[0])
