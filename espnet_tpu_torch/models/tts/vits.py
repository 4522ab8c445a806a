"""VITS, the generator side (counterpart of espnet_tpu/models/tts/vits.py:
PosteriorEncoder, ResidualCouplingLayer, ResidualCouplingFlow and VITS):
the training forward, ``VITS.forward``, and synthesis, ``VITS.inference``.

Training: the posterior encoder maps the linear spectrogram to
z = m_q + exp(logs_q) * noise; the coupling flow maps z to z_p; the
log-likelihood of each frame under each token's prior,
neg_cent[s, t] = log N(z_p[t]; m_p[s], exp(logs_p[s])), goes to the
monotonic alignment search (ops/monotonic_align.py) without gradient;
the path's durations train the variance predictor (log-MSE against
log(d + 1)); the prior stats expanded through the path give the KL of
the z_p sample, summed over channels and averaged over valid frames;
a random window of segment_frames frames of z, at
start = randint(0, 2^30) % max(spec_length - segment_frames, 1) per
utterance, is decoded to the wave. The posterior's noise and the starts
are given explicitly (``draw`` makes them from a torch.Generator), so
that two packages, or two turns of a GAN step, take the same draws. The
text encoder's dropout acts in train mode.

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
flax's default, the tanh approximation. The prior's and the posterior's
log-scales are clipped to +-7 (``Clip`` modules, whose inputs a grad
check can pin). The path's expansions are products with the 0/1 path
(a gathered lookup's CUDA backward adds in no fixed order) and the
window is a gather whose indices never repeat, so training repeats
itself bit for bit on the card. The stochastic duration predictor
(``use_sdp``) and VISinger / VISinger2 are not ported (ROADMAP A.5).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from espnet_tpu_torch.models.tts.fastspeech2 import (VariancePredictor,
                                                     length_regulator)
from espnet_tpu_torch.models.tts.hifigan import HiFiGANGenerator
from espnet_tpu_torch.nn.convolution import Pointwise, SameConv1d
from espnet_tpu_torch.nn.transformer import TransformerEncoder
from espnet_tpu_torch.ops.monotonic_align import maximum_path
from espnet_tpu_torch.utils.masks import make_non_pad_mask

LN_EPS = 1e-6
LOGS_CLIP = 7.0


class Clip(nn.Module):
    """clip(x, -7, 7), as jnp.clip of the log-scales."""

    def forward(self, x):
        return x.clamp(-LOGS_CLIP, LOGS_CLIP)


def window(x, starts, size: int):
    """x (B, T, ...) -> (B, size, ...): rows starts[b] .. + size - 1 of
    each x[b], the start clamped to [0, T - size] as
    lax.dynamic_slice_in_dim clamps it; a gather whose indices never
    repeat within a row."""
    T = x.shape[1]
    s = starts.long().clamp(0, max(T - size, 0))
    idx = s[:, None] + torch.arange(size, device=x.device)[None]
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        -1, -1, *x.shape[2:])
    return torch.gather(x, 1, idx)


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
        self.clip = Clip()

    def forward(self, spec, valid_mask, noise):
        keep = valid_mask[..., None]
        h = self.pre_norm(self.pre(spec))
        for i in range(self.layers):
            g = getattr(self, f"conv{i}")(h.transpose(1, 2)).transpose(1, 2)
            a, b = g.chunk(2, dim=-1)
            h = h + getattr(self, f"res{i}")(torch.tanh(a) * torch.sigmoid(b))
            h = h.masked_fill(~keep, 0.0)
        m, logs = self.proj(self.post_norm(h)).chunk(2, dim=-1)
        logs = self.clip(logs)
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
        self.prior_clip = Clip()
        self.z_channels, self.segment_frames = z_channels, segment_frames

    def _prior(self, text, text_lengths):
        """-> (h_text, m_p, logs_p, lengths), the stats (B, L, z)."""
        h, hlens = self.text_encoder(text, text_lengths)
        m_p, logs_p = self.text_proj(h).chunk(2, dim=-1)
        return h, m_p, self.prior_clip(logs_p), hlens

    def draw(self, spec, spec_lengths, generator=None) -> dict:
        """The training forward's draws: the posterior's standard normal
        noise (B, T, z) and the window starts (B,)."""
        B, T = spec.shape[:2]
        noise = torch.randn((B, T, self.z_channels), generator=generator,
                            device=spec.device)
        starts = torch.randint(0, 2 ** 30, (B,), generator=generator,
                               device=spec.device)
        max_start = (spec_lengths.long() - self.segment_frames).clamp(min=1)
        return {"noise": noise, "starts": starts % max_start}

    @staticmethod
    def align(neg_cent, text_lengths, spec_lengths):
        """The alignment path (B, S, T) of neg_cent (a grad check replaces
        it on an instance to give every leg one path)."""
        return maximum_path(neg_cent, text_lengths, spec_lengths)

    def forward(self, text, text_lengths, spec, spec_lengths, noise,
                starts) -> dict:
        """The training forward on given draws (``draw``) -> {wav_hat
        (B, segment_frames * hop), starts, kl_loss, dur_loss, durations
        (B, S)}."""
        S = text.shape[1]
        h_text, m_p, logs_p, _ = self._prior(text, text_lengths)
        t_mask = make_non_pad_mask(text_lengths, S)
        f_mask = make_non_pad_mask(spec_lengths, spec.shape[1])
        z, m_q, logs_q = self.posterior(spec, f_mask, noise)
        z_p = self.flow(z, f_mask)
        with torch.no_grad():
            # log N(z_p[t]; m_p[s], exp(logs_p[s])) in the JAX package's
            # order of terms
            inv = torch.exp(-2 * logs_p)
            neg_cent = (
                -0.5 * torch.einsum("btd,bsd->bst", z_p ** 2, inv)
                + torch.einsum("btd,bsd->bst", z_p, m_p * inv)
                - 0.5 * torch.sum(m_p ** 2 * inv + 2 * logs_p,
                                  dim=-1)[:, :, None]
                - 0.5 * math.log(2 * math.pi) * self.z_channels)
            path = self.align(neg_cent, text_lengths, spec_lengths)
        durations = path.sum(dim=2)
        d_pred = self.duration_predictor(h_text, t_mask)
        n_text = t_mask.sum().clamp(min=1)
        dur_loss = torch.where(t_mask, (d_pred - torch.log(durations + 1.0))
                               ** 2, 0.0).sum() / n_text
        path_t = path.transpose(1, 2)
        m_p_f, logs_p_f = path_t @ m_p, path_t @ logs_p
        kl = (logs_p_f - logs_q - 0.5
              + 0.5 * (z_p - m_p_f) ** 2 * torch.exp(-2 * logs_p_f))
        kl = torch.where(f_mask[..., None], kl, 0.0).sum() / \
            f_mask.sum().clamp(min=1)
        wav_hat = self.decoder(window(z, starts, self.segment_frames))
        return {"wav_hat": wav_hat, "starts": starts, "kl_loss": kl,
                "dur_loss": dur_loss, "durations": durations}

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

