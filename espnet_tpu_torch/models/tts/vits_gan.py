"""The VITS container (counterpart of
espnet_tpu/models/tts/vits_gan.py:VITSGan) as far as synthesis needs it:
the generator, and ``decode``. The discriminator and the two-optimizer
GAN step wait for VITS training (ROADMAP A.5)."""

from __future__ import annotations

import torch
from torch import nn

from espnet_tpu_torch.models.tts.vits import VITS


class VITSGan(nn.Module):
    """The generator under ``generator``, as the JAX container's tree
    holds it under generator/params."""

    def __init__(self, vocab_size: int, n_fft: int = 128,
                 hop_length: int = 64, tts: str = "vits",
                 vits_conf: dict = None):
        super().__init__()
        if tts != "vits":
            raise NotImplementedError(
                f"tts {tts!r}: VISinger and VISinger2 are not ported yet "
                f"(ROADMAP A.5)")
        vc = dict(vits_conf or {})
        vc.setdefault("hop_length", hop_length)
        vc.setdefault("spec_channels", n_fft // 2 + 1)
        self.generator = VITS(vocab_size=vocab_size, **vc)

    @torch.no_grad()
    def decode(self, text, text_lengths, **kw):
        """-> (wav, frame lengths): VITS.inference."""
        return self.generator.inference(text, text_lengths, **kw)
