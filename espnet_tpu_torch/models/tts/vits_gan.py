"""The VITS GAN container (counterpart of
espnet_tpu/models/tts/vits_gan.py:VITSGan): the generator (VITS), the
HiFi-GAN multi-period / multi-scale discriminator, and the two turns of
a GAN step.

``forward(..., forward_generator=True)`` is the generator's turn: the
training forward on the batch's draws, the real wave's window at
start x hop, both waves through the discriminator (whose parameters take
no gradient), and lambda_adv adv + lambda_feat_match fm + lambda_mel mel
+ lambda_kl kl + lambda_dur dur (1, 2, 45, 1, 1). With False it is the
discriminator's turn: the generator's wave without gradient, and the
least-squares discriminator loss. Both turns of one step take the same
draws (``draw``): the JAX step runs the generator again in the
discriminator's turn, with the parameters its generator turn has just
updated and the same random keys, and so does the port's
(train/gan_trainer.py), where upstream ESPnet reuses the first turn's
wave.

The parameters are kept as the JAX container's tree holds them, one part
per network: ``flax_parts`` tells convert.py to read and write
generator/params/... and discriminator/params/....
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from espnet_tpu_torch.models.tts.hifigan import (HiFiGANMultiDiscriminator,
                                                 discriminator_adv_loss,
                                                 feature_match_loss,
                                                 generator_adv_loss,
                                                 mel_spectrogram_loss)
from espnet_tpu_torch.models.tts.vits import VITS, window


@contextlib.contextmanager
def frozen(module: nn.Module):
    """A context in which ``module``'s parameters take no gradient."""
    flags = [p.requires_grad for p in module.parameters()]
    for p in module.parameters():
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(module.parameters(), flags):
            p.requires_grad_(f)


class VITSGan(nn.Module):
    flax_parts = ("generator", "discriminator")

    def __init__(self, vocab_size: int, fs: int = 8000, n_fft: int = 128,
                 hop_length: int = 64, n_mels: int = 20, tts: str = "vits",
                 vits_conf: dict = None, discriminator_conf: dict = None,
                 lambda_adv: float = 1.0, lambda_mel: float = 45.0,
                 lambda_feat_match: float = 2.0, lambda_kl: float = 1.0,
                 lambda_dur: float = 1.0):
        super().__init__()
        if tts != "vits":
            raise NotImplementedError(
                f"tts {tts!r}: VISinger and VISinger2 are not ported yet "
                f"(ROADMAP A.5)")
        vc = dict(vits_conf or {})
        vc.setdefault("hop_length", hop_length)
        vc.setdefault("spec_channels", n_fft // 2 + 1)
        self.generator = VITS(vocab_size=vocab_size, **vc)
        self.discriminator = HiFiGANMultiDiscriminator(
            **dict(discriminator_conf or {}))
        self.mel = dict(fs=fs, n_fft=n_fft, hop_length=hop_length,
                        n_mels=n_mels)
        self.hop = vc["hop_length"]
        self.seg = self.generator.segment_frames * self.hop
        self.lambdas = dict(adv=lambda_adv, mel=lambda_mel,
                            fm=lambda_feat_match, kl=lambda_kl,
                            dur=lambda_dur)

    def draw(self, batch: dict, generator=None) -> dict:
        """The step's draws: the posterior's noise and the window starts."""
        return self.generator.draw(batch["spec"], batch["spec_lengths"],
                                   generator)

    def forward(self, text, text_lengths, spec, spec_lengths, speech,
                noise, starts, forward_generator: bool = True, **_):
        """-> (loss, stats, weight): the generator's turn or the
        discriminator's, on the given draws."""
        lam = self.lambdas
        if forward_generator:
            out = self.generator(text, text_lengths, spec, spec_lengths,
                                 noise, starts)
        else:
            with torch.no_grad():
                out = self.generator(text, text_lengths, spec, spec_lengths,
                                     noise, starts)
        wav_hat = out["wav_hat"]
        wav_real = window(speech, starts * self.hop, self.seg)
        if forward_generator:
            with frozen(self.discriminator):
                fake_outs = self.discriminator(wav_hat)
                real_outs = self.discriminator(wav_real)
            adv = generator_adv_loss(fake_outs)
            fm = feature_match_loss(real_outs, fake_outs)
            mel = mel_spectrogram_loss(wav_hat, wav_real, **self.mel)
            loss = (lam["adv"] * adv + lam["fm"] * fm + lam["mel"] * mel
                    + lam["kl"] * out["kl_loss"]
                    + lam["dur"] * out["dur_loss"])
            stats = {"generator_loss": loss, "generator_adv_loss": adv,
                     "generator_mel_loss": mel,
                     "generator_kl_loss": out["kl_loss"],
                     "generator_dur_loss": out["dur_loss"],
                     "generator_feat_match_loss": fm}
        else:
            real_outs = self.discriminator(wav_real)
            fake_outs = self.discriminator(wav_hat.detach())
            loss = discriminator_adv_loss(real_outs, fake_outs)
            stats = {"discriminator_loss": loss}
        return loss, stats, float(text.shape[0])

    @torch.no_grad()
    def decode(self, text, text_lengths, **kw):
        """-> (wav, frame lengths): VITS.inference."""
        return self.generator.inference(text, text_lengths, **kw)
