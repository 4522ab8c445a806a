"""HiFi-GAN (counterpart of espnet_tpu/models/tts/hifigan.py): the
generator, the multi-period and multi-scale discriminators, and the
least-squares GAN, feature-matching and mel losses.

The generator: conv_pre -> [leaky ReLU -> transposed-conv upsampling ->
the mean of the multi-receptive-field residual blocks] per scale ->
leaky ReLU -> conv_post -> tanh. Convolutions run channels-first with
flax's SAME alignment (nn/convolution.py); the public input is the JAX
package's (B, T, C).

A period discriminator pads the wave (B, S) to a multiple of its period
p by reflection and folds it to (B, 1, S / p, p), flax's NHWC
(B, S / p, p, 1); its (5, 1) convolutions at stride (3, 1) take flax's
SAME padding from each layer's input height, uneven where that is not a
multiple of 3. A scale discriminator runs (B, 1, S) through grouped
convolutions (group count g only where it divides both the input and
output channels, else 1), strides 1 and 4 under SAME; between scales the
wave is cut to an even length and each pair averaged. Every leaky ReLU
(slope 0.1) is a module of its own (``LeakyReLU``), so that a grad check
can pin the side of its kink. Feature maps are channels-first; the
losses take means, which do not depend on the layout.

The mel loss is the L1 distance of the log-mel spectrograms (reflect-
centred periodic Hann STFT power, slaney mel from 0 Hz to fs / 2, natural
log floored at 1e-10). Where ``ops.logmel.kernel_takes`` holds, that is
the log-mel kernel's function, and it goes through
``ops.logmel.fused_logmel`` (the kernel on the card, its plain version on
the CPU; the gradient is the plain version's, recomputed from the saved
wave); at other shapes it takes the plain STFT and log-mel ops, the rule
frontends/default.py follows.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from espnet_tpu_torch.nn.convolution import (SameConv1d, SameConv2d,
                                             SameConvTranspose1d)
from espnet_tpu_torch.ops.logmel import fused_logmel, kernel_takes
from espnet_tpu_torch.ops.mel import log_mel
from espnet_tpu_torch.ops.stft import stft_power

SLOPE = 0.1


class LeakyReLU(nn.Module):
    """flax's ``nn.leaky_relu(x, 0.1)``."""

    def forward(self, x):
        return F.leaky_relu(x, SLOPE)


class ResBlock(nn.Module):
    """Dilated conv pairs with residuals, on (B, C, T)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):   # flax's names
            self.add_module(f"conv1_{i}", SameConv1d(
                channels, channels, kernel_size, dilation=d))
            self.add_module(f"conv2_{i}", SameConv1d(
                channels, channels, kernel_size))
            self.add_module(f"act1_{i}", LeakyReLU())
            self.add_module(f"act2_{i}", LeakyReLU())

    def forward(self, x):
        for i in range(self.n):
            h = getattr(self, f"conv1_{i}")(getattr(self, f"act1_{i}")(x))
            x = x + getattr(self, f"conv2_{i}")(getattr(self, f"act2_{i}")(h))
        return x


class HiFiGANGenerator(nn.Module):

    def __init__(self, in_channels: int = 80, out_channels: int = 1,
                 channels: int = 512, kernel_size: int = 7,
                 upsample_scales: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilations: Sequence[Sequence[int]] = (
                     (1, 3, 5),) * 3):
        super().__init__()
        self.n_up, self.n_res = len(upsample_scales), len(
            resblock_kernel_sizes)
        self.conv_pre = SameConv1d(in_channels, channels, kernel_size)
        ch = channels
        for i, (s, k) in enumerate(zip(upsample_scales,
                                       upsample_kernel_sizes)):
            self.add_module(f"act{i}", LeakyReLU())
            self.add_module(f"upsample{i}",
                            SameConvTranspose1d(ch, ch // 2, k, s))
            ch //= 2
            for j, (rk, rd) in enumerate(zip(resblock_kernel_sizes,
                                             resblock_dilations)):
                self.add_module(f"resblock{i}_{j}", ResBlock(ch, rk, rd))
        self.act_post = LeakyReLU()
        self.conv_post = SameConv1d(ch, out_channels, kernel_size)

    def forward(self, mel):
        """mel (B, T, in_channels) -> wav (B, T * prod(scales))."""
        h = self.conv_pre(mel.transpose(1, 2))
        for i in range(self.n_up):
            h = getattr(self, f"upsample{i}")(getattr(self, f"act{i}")(h))
            acc = getattr(self, f"resblock{i}_0")(h)
            for j in range(1, self.n_res):
                acc = acc + getattr(self, f"resblock{i}_{j}")(h)
            h = acc / self.n_res
        h = self.conv_post(self.act_post(h))
        return torch.tanh(h)[:, 0]


class PeriodDiscriminator(nn.Module):
    """(B, S) -> (score (B, H * p), [feature maps (B, C, H, p)])."""

    def __init__(self, period: int,
                 channels: Sequence[int] = (32, 128, 512, 1024),
                 kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period, self.n = period, len(channels)
        c_in = 1
        for i, c in enumerate(channels):
            self.add_module(f"conv{i}", SameConv2d(
                c_in, c, (kernel_size, 1), (stride, 1)))
            self.add_module(f"act{i}", LeakyReLU())
            c_in = c
        self.conv_post = SameConv2d(c_in, 1, (3, 1))

    def forward(self, x):
        B, S = x.shape
        pad = (-S) % self.period
        if pad:
            x = F.pad(x[:, None], (0, pad),
                      mode="reflect" if S > 1 else "constant")[:, 0]
        h = x.reshape(B, 1, -1, self.period)
        feats = []
        for i in range(self.n):
            h = getattr(self, f"act{i}")(getattr(self, f"conv{i}")(h))
            feats.append(h)
        h = self.conv_post(h)
        feats.append(h)
        return h.reshape(B, -1), feats


class ScaleDiscriminator(nn.Module):
    """(B, S) -> (score (B, S'), [feature maps (B, C, S_i)])."""

    def __init__(self, channels: Sequence[int] = (64, 128, 256, 512, 1024),
                 kernel_sizes: Sequence[int] = (15, 41, 41, 41, 5),
                 strides: Sequence[int] = (1, 4, 4, 4, 1),
                 groups: Sequence[int] = (1, 4, 16, 16, 1)):
        super().__init__()
        self.n = len(channels)
        c_in = 1
        for i, (c, k, s, g) in enumerate(zip(channels, kernel_sizes,
                                             strides, groups)):
            g_eff = g if (c_in % g == 0 and c % g == 0) else 1
            self.add_module(f"conv{i}", SameConv1d(c_in, c, k, stride=s,
                                                   groups=g_eff))
            self.add_module(f"act{i}", LeakyReLU())
            c_in = c
        self.conv_post = SameConv1d(c_in, 1, 3)

    def forward(self, x):
        B = x.shape[0]
        h = x[:, None]
        feats = []
        for i in range(self.n):
            h = getattr(self, f"act{i}")(getattr(self, f"conv{i}")(h))
            feats.append(h)
        h = self.conv_post(h)
        feats.append(h)
        return h.reshape(B, -1), feats


class HiFiGANMultiDiscriminator(nn.Module):
    """The period discriminators (``mpd{p}``) and ``scales`` scale
    discriminators (``msd{i}``), each scale on the wave halved by pair
    means. (B, S) -> [(score, feature maps)], periods first."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 scales: int = 3):
        super().__init__()
        self.periods, self.scales = tuple(periods), scales
        for p in self.periods:
            self.add_module(f"mpd{p}", PeriodDiscriminator(p))
        for i in range(scales):
            self.add_module(f"msd{i}", ScaleDiscriminator())

    def forward(self, x):
        outs = [getattr(self, f"mpd{p}")(x) for p in self.periods]
        h = x
        for i in range(self.scales):
            outs.append(getattr(self, f"msd{i}")(h))
            S = h.shape[1] - h.shape[1] % 2
            h = h[:, :S].reshape(h.shape[0], -1, 2).mean(dim=-1)
        return outs


def generator_adv_loss(disc_outs):
    """Mean over discriminators of mean((score - 1)^2)."""
    losses = [torch.mean((score - 1.0) ** 2) for score, _ in disc_outs]
    return sum(losses) / len(losses)


def discriminator_adv_loss(real_outs, fake_outs):
    """(sum of mean((real - 1)^2) + sum of mean(fake^2)) / the count."""
    real = sum(torch.mean((s - 1.0) ** 2) for s, _ in real_outs)
    fake = sum(torch.mean(s ** 2) for s, _ in fake_outs)
    return (real + fake) / len(real_outs)


def feature_match_loss(real_outs, fake_outs):
    """Mean over every feature map but each discriminator's last of
    mean |real - fake|."""
    total, n = 0.0, 0
    for (_, rf), (_, ff) in zip(real_outs, fake_outs):
        for r, f in zip(rf[:-1], ff[:-1]):
            total = total + torch.mean(torch.abs(r - f))
            n += 1
    return total / max(n, 1)


def melspec(wav, *, fs: int, n_fft: int, hop_length: int, n_mels: int):
    """(B, S) -> (B, T, n_mels) log-mel: the log-mel kernel's function,
    through ``fused_logmel`` where the kernel takes the shape."""
    if kernel_takes(n_fft, hop_length, n_mels) and wav.shape[1] > n_fft // 2:
        return fused_logmel(wav if wav.dtype == torch.float64
                            else wav.float(), fs=fs, n_fft=n_fft,
                            hop_length=hop_length, n_mels=n_mels)
    power, _ = stft_power(wav, None, n_fft=n_fft, hop_length=hop_length)
    return log_mel(power, fs=fs, n_fft=n_fft, n_mels=n_mels)


def mel_spectrogram_loss(wav_fake, wav_real, *, fs: int = 22050,
                         n_fft: int = 1024, hop_length: int = 256,
                         n_mels: int = 80):
    """mean |melspec(fake) - melspec(real)|."""
    kw = dict(fs=fs, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels)
    return torch.mean(torch.abs(melspec(wav_fake, **kw)
                                - melspec(wav_real, **kw)))
