"""VITS, the generator side, for synthesis (counterpart of
espnet_tpu/models/tts/vits.py: PosteriorEncoder, ResidualCouplingLayer,
ResidualCouplingFlow, VITS._prior and VITS.inference).

Synthesis: the Transformer text encoder (``embed`` input) gives the
prior's mean and log-scale per token; the variance predictor gives log
durations, rounded (half to even, as jnp.round) to frames; the length
regulator expands the prior to max_frames frames (zeros past the total);
z_p = m + exp(logs) * noise_scale * noise; the coupling flow, inverted,
maps z_p to z; the HiFi-GAN generator decodes z to the wave. The noise
is an explicit (B, max_frames, z) tensor or is drawn from a
torch.Generator, so that two packages can be fed the same draws.

The couplings are convolutions in fp32 (TF32 off on the card,
tasks/asr.py:fp32_and_deterministic), as the JAX couplings run at
precision "highest": the inverse must undo the forward closely. GELU is
flax's default, the tanh approximation.

The posterior encoder is built so that the generator's parameter tree
loads strictly; its forward takes the noise explicitly. Training (MAS,
the losses, the discriminators), the stochastic duration predictor
(``use_sdp``) and VISinger / VISinger2 wait (ROADMAP A.5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from espnet_tpu_torch.models.tts.fastspeech2 import (VariancePredictor,
                                                     length_regulator)
from espnet_tpu_torch.models.tts.hifigan import HiFiGANGenerator
from espnet_tpu_torch.nn.convolution import Pointwise, SameConv1d
from espnet_tpu_torch.nn.transformer import TransformerEncoder
from espnet_tpu_torch.utils.masks import make_non_pad_mask

LN_EPS = 1e-6
LOGS_CLIP = 7.0


class PosteriorEncoder(nn.Module):
    """Linear spectrogram (B, T, spec) -> (z, m, logs), each (B, T, out),
    channels-last as the JAX encoder: pointwise in, LayerNorm, gated-tanh
    dilated residual units, LayerNorm, pointwise stats."""

    def __init__(self, spec_channels: int, out_channels: int = 96,
                 hidden: int = 96, layers: int = 4, kernel: int = 5):
        super().__init__()
        self.layers = layers
        self.pre = Pointwise(spec_channels, hidden)
        self.pre_norm = nn.LayerNorm(hidden, eps=LN_EPS)
        for i in range(layers):
            self.add_module(f"conv{i}", SameConv1d(
                hidden, 2 * hidden, kernel, dilation=2 ** (i % 3)))
            self.add_module(f"res{i}", Pointwise(hidden, hidden))
        self.post_norm = nn.LayerNorm(hidden, eps=LN_EPS)
        self.proj = Pointwise(hidden, 2 * out_channels)

    def forward(self, spec, valid_mask, noise):
        keep = valid_mask[..., None]
        h = self.pre_norm(self.pre(spec))
        for i in range(self.layers):
            g = getattr(self, f"conv{i}")(h.transpose(1, 2)).transpose(1, 2)
            a, b = g.chunk(2, dim=-1)
            h = h + getattr(self, f"res{i}")(torch.tanh(a) * torch.sigmoid(b))
            h = h.masked_fill(~keep, 0.0)
        m, logs = self.proj(self.post_norm(h)).chunk(2, dim=-1)
        logs = logs.clamp(-LOGS_CLIP, LOGS_CLIP)
        z = m + torch.exp(logs) * noise
        return z.masked_fill(~keep, 0.0), m, logs


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling over channel halves, on (B, C, T):
    xb +- m(xa), m from a pointwise conv, SAME convs on GELU with
    residuals, and a pointwise projection."""

    def __init__(self, channels: int, hidden: int = 96, kernel: int = 5,
                 layers: int = 3):
        super().__init__()
        self.half, self.layers = channels // 2, layers
        self.pre = SameConv1d(self.half, hidden, 1)
        for i in range(layers):
            self.add_module(f"conv{i}", SameConv1d(hidden, hidden, kernel))
        self.proj = SameConv1d(hidden, channels - self.half, 1)

    def forward(self, x, keep, reverse: bool = False):
        """x (B, C, T); keep (B, 1, T) bool, True = valid frame."""
        xa, xb = x[:, :self.half], x[:, self.half:]
        h = self.pre(xa)
        for i in range(self.layers):
            h = h + getattr(self, f"conv{i}")(F.gelu(h, approximate="tanh"))
            h = h.masked_fill(~keep, 0.0)
        m = self.proj(h)
        xb = xb - m if reverse else xb + m
        return torch.cat([xa, xb], dim=1).masked_fill(~keep, 0.0)


class ResidualCouplingFlow(nn.Module):
    """Couplings with a channel flip after each; the inverse unflips
    before each inverted coupling, in reverse order. (B, T, C) in and
    out, as the JAX flow."""

    def __init__(self, channels: int, flows: int = 4, hidden: int = 96):
        super().__init__()
        self.flows = flows
        for i in range(flows):
            self.add_module(f"flow{i}",
                            ResidualCouplingLayer(channels, hidden))

    def forward(self, x, valid_mask, reverse: bool = False):
        keep = valid_mask[:, None, :]
        x = x.transpose(1, 2)
        if not reverse:
            for i in range(self.flows):
                x = getattr(self, f"flow{i}")(x, keep).flip(1)
        else:
            for i in reversed(range(self.flows)):
                x = getattr(self, f"flow{i}")(x.flip(1), keep, reverse=True)
        return x.transpose(1, 2)


class VITS(nn.Module):
    """The generator. ``segment_frames``, ``hop_length`` and ``sdp_conf``
    are the training's and are taken from a config as they are."""

    def __init__(self, vocab_size: int, z_channels: int = 96,
                 hidden: int = 96, spec_channels: int = 65,
                 segment_frames: int = 16, hop_length: int = 64,
                 text_encoder_conf: dict = None, generator_conf: dict = None,
                 use_sdp: bool = False, sdp_conf: dict = None):
        super().__init__()
        if use_sdp:
            raise NotImplementedError(
                "use_sdp: the stochastic duration predictor is not ported "
                "yet (ROADMAP A.5, VITS training)")
        tc = dict(text_encoder_conf or {})
        tc.setdefault("output_size", hidden)
        tc.setdefault("input_layer", "embed")
        self.text_encoder = TransformerEncoder(input_size=vocab_size, **tc)
        d_text = tc["output_size"]
        self.text_proj = nn.Linear(d_text, 2 * z_channels)
        self.posterior = PosteriorEncoder(spec_channels, z_channels, hidden)
        self.flow = ResidualCouplingFlow(z_channels, hidden=hidden)
        gc = dict(generator_conf or {})
        gc.setdefault("in_channels", z_channels)
        self.decoder = HiFiGANGenerator(**gc)
        self.duration_predictor = VariancePredictor(d_text, chans=hidden)

    def _prior(self, text, text_lengths):
        """-> (h_text, m_p, logs_p, lengths), the stats (B, L, z)."""
        h, hlens = self.text_encoder(text, text_lengths)
        m_p, logs_p = self.text_proj(h).chunk(2, dim=-1)
        return h, m_p, logs_p.clamp(-LOGS_CLIP, LOGS_CLIP), hlens

    def prior_and_durations(self, text, text_lengths, speed: float = 1.0):
        """-> (m_p, logs_p, durations (B, L) int, 0 past each length):
        round((exp(log d) - 1) / speed), at least 0."""
        h_text, m_p, logs_p, _ = self._prior(text, text_lengths)
        t_mask = make_non_pad_mask(text_lengths, text.shape[1])
        d_pred = self.duration_predictor(h_text, t_mask)
        durations = torch.round((torch.exp(d_pred) - 1.0) / speed).clamp(
            min=0).long()
        return m_p, logs_p, durations.masked_fill(~t_mask, 0)

    def inference(self, text, text_lengths, noise=None, generator=None,
                  noise_scale: float = 0.667, max_frames: int = 512,
                  speed: float = 1.0):
        """text (B, L) ids -> (wav (B, max_frames * hop), frame lengths
        (B,)). ``noise`` (B, max_frames, z) is z_p's standard normal
        draw; without it the draw comes from ``generator``."""
        m_p, logs_p, durations = self.prior_and_durations(
            text, text_lengths, speed)
        m_p_f, total = length_regulator(m_p, durations, max_frames)
        logs_p_f, _ = length_regulator(logs_p, durations, max_frames)
        olens = total.clamp(max=max_frames)
        f_mask = make_non_pad_mask(olens, max_frames)
        if noise is None:
            noise = torch.randn(m_p_f.shape, generator=generator,
                                device=m_p_f.device)
        z_p = m_p_f + torch.exp(logs_p_f) * noise_scale * noise
        z = self.flow(z_p, f_mask, reverse=True)
        return self.decoder(z), olens

