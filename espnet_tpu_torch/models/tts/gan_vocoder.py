"""The GAN vocoder (counterpart of
espnet_tpu/models/tts/gan_vocoder.py:HiFiGANVocoderGAN): a HiFi-GAN
generator from log-mel to wave, the HiFi-GAN multi-period / multi-scale
discriminator, and the two turns of a GAN step.

The log-mel comes with the batch (``feats``, a teacher-forced fine-tune)
or is computed from the wave (``featurize``: the log-mel kernel's
function, through ``ops.logmel.fused_logmel`` where the kernel takes the
shape, its first S // hop frames). Both waves are cut to the shorter
one's length. The generator's turn: lambda_adv adv + lambda_feat_match fm
+ lambda_mel mel (1, 2, 45); the discriminator's turn: the least-squares
discriminator loss on the generator's wave without gradient. Only the
``hifigan`` generator is ported: ``melgan``, ``style_melgan`` and
``parallel_wavegan`` raise (ROADMAP A.5).
"""

from __future__ import annotations

import torch
from torch import nn

from espnet_tpu_torch.models.tts.hifigan import (HiFiGANGenerator,
                                                 HiFiGANMultiDiscriminator,
                                                 discriminator_adv_loss,
                                                 feature_match_loss,
                                                 generator_adv_loss,
                                                 mel_spectrogram_loss,
                                                 melspec)
from espnet_tpu_torch.models.tts.vits_gan import frozen

UNPORTED_GENERATORS = ("melgan", "style_melgan", "parallel_wavegan")


class HiFiGANVocoderGAN(nn.Module):
    flax_parts = ("generator", "discriminator")

    def __init__(self, fs: int = 22050, n_fft: int = 1024,
                 hop_length: int = 256, n_mels: int = 80,
                 generator: str = "hifigan", generator_conf: dict = None,
                 discriminator_conf: dict = None, lambda_adv: float = 1.0,
                 lambda_feat_match: float = 2.0, lambda_mel: float = 45.0):
        super().__init__()
        if generator in UNPORTED_GENERATORS:
            raise NotImplementedError(
                f"generator {generator!r} is not ported yet (ROADMAP A.5)")
        if generator != "hifigan":
            raise ValueError(f"unknown generator {generator!r}")
        gc = dict(generator_conf or {})
        gc.setdefault("in_channels", n_mels)
        self.generator = HiFiGANGenerator(**gc)
        self.discriminator = HiFiGANMultiDiscriminator(
            **dict(discriminator_conf or {}))
        self.mel = dict(fs=fs, n_fft=n_fft, hop_length=hop_length,
                        n_mels=n_mels)
        self.lambdas = dict(adv=lambda_adv, fm=lambda_feat_match,
                            mel=lambda_mel)

    def featurize(self, wav):
        """(B, S) -> log-mel (B, S // hop, n_mels)."""
        return melspec(wav, **self.mel)[:, :wav.shape[1]
                                        // self.mel["hop_length"]]

    def draw(self, batch: dict, generator=None) -> dict:
        """No draws: the vocoder's step is deterministic."""
        return {}

    def forward(self, speech, feats=None, forward_generator: bool = True,
                **_):
        """-> (loss, stats, weight) of the generator's turn or the
        discriminator's."""
        lam = self.lambdas
        mel = self.featurize(speech) if feats is None else feats
        if forward_generator:
            wav_hat = self.generator(mel)
        else:
            with torch.no_grad():
                wav_hat = self.generator(mel)
        S = min(speech.shape[1], wav_hat.shape[1])
        wav, wav_hat = speech[:, :S], wav_hat[:, :S]
        if forward_generator:
            with frozen(self.discriminator):
                fake_outs = self.discriminator(wav_hat)
                real_outs = self.discriminator(wav)
            adv = generator_adv_loss(fake_outs)
            fm = feature_match_loss(real_outs, fake_outs)
            mel_l = mel_spectrogram_loss(wav_hat, wav, **self.mel)
            loss = lam["adv"] * adv + lam["fm"] * fm + lam["mel"] * mel_l
            stats = {"generator_loss": loss, "generator_adv_loss": adv,
                     "generator_feat_match_loss": fm,
                     "generator_mel_loss": mel_l}
        else:
            real_outs = self.discriminator(wav)
            fake_outs = self.discriminator(wav_hat.detach())
            loss = discriminator_adv_loss(real_outs, fake_outs)
            stats = {"discriminator_loss": loss}
        return loss, stats, float(mel.shape[0])

    @torch.no_grad()
    def decode(self, mel):
        """mel (B, T, n_mels) -> wav (B, T * hop)."""
        return self.generator(mel)
