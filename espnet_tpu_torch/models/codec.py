"""Neural audio codecs with residual vector quantization (counterpart of
espnet_tpu/models/codec.py): SoundStream, Encodec and DAC.

- SoundStream (the committed asset): strided convolutions, ELU, the
  single-scale log-mel L1 loss (n_fft 256, hop 64, 40 mels).
- Encodec: dilated residual units per stage, an LSTM bottleneck after
  the encoder and before the decoder, the multi-scale STFT loss.
- DAC: the Snake activation x + sin^2(a x) / a, dilated residual units,
  codebooks looked up in an 8-dim L2-normalised space through per-stage
  input and output projections, the multi-scale STFT loss.

The convolutions run channels-first with flax's SAME alignment
(nn/convolution.py: a strided convolution of kernel 2s pads by the input
length, a transposed one keeps T * s outputs); the RVQ works on the JAX
package's (B, T, D). Each RVQ stage takes the argmin of ||r||^2 - 2 r c
+ ||c||^2 over the codebook: the product is a plain matmul (TF32 off),
so a code may differ from another backend's only where two distances
are within rounding. The straight-through estimator and the two commit
terms are the JAX package's. The SoundStream mel loss is
``models/tts/hifigan.py:melspec``: ``ops.stft.stft_power``'s defaults
(periodic Hann of n_fft, centred, reflect padding) and ``log_mel``'s
(slaney mel from 0 Hz, natural log floored at 1e-10) are the log-mel
kernel's function, so it runs through ``fused_logmel`` (K2) and its
gradient is the plain version's, recomputed from the saved wave. The
LSTMs are ``models/transducer.py:LSTMCell`` (flax's
``OptimizedLSTMCell`` layout), stepped over time.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from espnet_tpu_torch.models.transducer import LSTMCell
from espnet_tpu_torch.models.tts.hifigan import melspec
from espnet_tpu_torch.nn.convolution import SameConv1d, SameConvTranspose1d
from espnet_tpu_torch.ops.stft import stft_power


def snake(x, alpha):
    """x + sin^2(alpha x) / alpha (DAC)."""
    return x + torch.sin(alpha * x) ** 2 / torch.clamp(alpha, min=1e-9)


class Snake(nn.Module):
    """Channelwise learnable-frequency snake on (B, C, T); alpha starts
    at ones, as flax's initialiser has it (``init_like_flax`` leaves it)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        return snake(x, self.alpha[:, None])


class _Activations(nn.Module):
    """ELU, or Snakes named ``Snake_{i}`` as flax names them in order."""

    def __init__(self, activation: str):
        super().__init__()
        self.activation = activation
        self.n_snakes = 0

    def add(self, channels: int) -> int:
        """Register the next activation -> its index."""
        if self.activation == "snake":
            self.add_module(f"Snake_{self.n_snakes}", Snake(channels))
        self.n_snakes += 1
        return self.n_snakes - 1

    def act(self, i: int, x):
        if self.activation == "snake":
            return getattr(self, f"Snake_{i}")(x)
        return F.elu(x)


class ResidualUnit(_Activations):
    """x + conv1x1(act(conv_k,dil(act(x)))) on (B, C, T)."""

    def __init__(self, channels: int, dilation: int = 1, kernel: int = 7,
                 activation: str = "elu"):
        super().__init__(activation)
        self.add(channels)
        self.add(channels)
        self.Conv_0 = SameConv1d(channels, channels, kernel, dilation)
        self.Conv_1 = SameConv1d(channels, channels, 1)

    def forward(self, x):
        return x + self.Conv_1(self.act(1, self.Conv_0(self.act(0, x))))


def run_lstm(cell: LSTMCell, x):
    """(B, C, T) through ``cell`` from a zero carry -> (B, C, T) of h."""
    B, C, T = x.shape
    proj = cell.input_proj(x.transpose(1, 2))
    carry = (x.new_zeros(B, C), x.new_zeros(B, C))
    out = []
    for t in range(T):
        carry = cell(carry, proj[:, t])
        out.append(carry[1])
    return torch.stack(out, dim=2)


class ConvEncoder(_Activations):
    """(B, S) -> (B, T, dim), T = ceil(S / prod(strides))."""

    def __init__(self, channels: int = 32,
                 strides: Sequence[int] = (2, 4, 5, 8), dim: int = 128,
                 activation: str = "elu",
                 unit_dilations: Sequence[int] = (), use_lstm: bool = False):
        super().__init__(activation)
        self.strides = tuple(strides)
        self.unit_dilations = tuple(unit_dilations)
        in_ch, ch = 1, channels
        for i, s in enumerate(self.strides):
            for j, dil in enumerate(self.unit_dilations):
                self.add_module(f"res{i}_{j}", ResidualUnit(
                    in_ch, dil, activation=activation))
            self.add_module(f"down{i}", SameConv1d(in_ch, ch, 2 * s,
                                                   stride=s))
            self.add(ch)
            in_ch, ch = ch, min(ch * 2, 512)
        self.use_lstm = use_lstm
        if use_lstm:
            self.OptimizedLSTMCell_0 = LSTMCell(in_ch, in_ch)
        self.proj = SameConv1d(in_ch, dim, 3)

    def forward(self, wav):
        h = wav[:, None, :]
        for i in range(len(self.strides)):
            for j in range(len(self.unit_dilations)):
                h = getattr(self, f"res{i}_{j}")(h)
            h = self.act(i, getattr(self, f"down{i}")(h))
        if self.use_lstm:
            h = h + run_lstm(self.OptimizedLSTMCell_0, h)
        return self.proj(h).transpose(1, 2)


class ConvDecoder(_Activations):
    """(B, T, dim) -> (B, T * prod(strides)) in (-1, 1)."""

    def __init__(self, channels: int = 32,
                 strides: Sequence[int] = (2, 4, 5, 8), dim: int = 128,
                 activation: str = "elu",
                 unit_dilations: Sequence[int] = (), use_lstm: bool = False):
        super().__init__(activation)
        self.strides = tuple(strides)
        self.unit_dilations = tuple(unit_dilations)
        ch = min(channels * 2 ** (len(self.strides) - 1), 512)
        self.proj = SameConv1d(dim, ch, 3)
        self.use_lstm = use_lstm
        if use_lstm:
            self.OptimizedLSTMCell_0 = LSTMCell(ch, ch)
        for i, s in enumerate(reversed(self.strides)):
            self.add(ch)
            out = max(ch // 2, channels)
            self.add_module(f"up{i}", SameConvTranspose1d(ch, out, 2 * s, s))
            ch = out
            for j, dil in enumerate(self.unit_dilations):
                self.add_module(f"res{i}_{j}", ResidualUnit(
                    ch, dil, activation=activation))
        self.out = SameConv1d(ch, 1, 3)

    def forward(self, z):
        h = self.proj(z.transpose(1, 2))
        if self.use_lstm:
            h = h + run_lstm(self.OptimizedLSTMCell_0, h)
        for i in range(len(self.strides)):
            h = getattr(self, f"up{i}")(self.act(i, h))
            for j in range(len(self.unit_dilations)):
                h = getattr(self, f"res{i}_{j}")(h)
        return torch.tanh(self.out(h))[:, 0]


class ResidualVQ(nn.Module):
    """num_quantizers codebooks applied to successive residuals; with
    ``proj_dim`` (DAC) each stage looks up in a projected, L2-normalised
    space and decodes through an output projection."""

    def __init__(self, num_quantizers: int = 4, codebook_size: int = 256,
                 dim: int = 128, proj_dim: Optional[int] = None):
        super().__init__()
        self.num_quantizers = num_quantizers
        self.dim = dim
        self.proj_dim = proj_dim
        self.codebooks = nn.Parameter(torch.zeros(
            num_quantizers, codebook_size, proj_dim or dim))
        if proj_dim is not None:
            for q in range(num_quantizers):
                self.add_module(f"in{q}", nn.Linear(dim, proj_dim))
                self.add_module(f"out{q}", nn.Linear(proj_dim, dim))

    def flax_init_(self, generator: torch.Generator):
        """flax's normal(1.0) codebooks."""
        with torch.no_grad():
            self.codebooks.normal_(0.0, 1.0, generator=generator)

    def _norm(self, v):
        if self.proj_dim is None:
            return v
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                               min=1e-8)

    def _codebook(self, q: int):
        return self._norm(self.codebooks[q])

    def distances(self, r, cb):
        """||r||^2 - 2 r.c + ||c||^2: (B, T, d), (K, d) -> (B, T, K)."""
        return ((r ** 2).sum(-1, keepdim=True) - 2 * (r @ cb.t())
                + (cb ** 2).sum(-1)[None, None, :])

    def nearest(self, q: int, r, cb):
        """Stage q's codes: the argmin of the distances (B, T)."""
        return torch.argmin(self.distances(r, cb), dim=-1)

    def forward(self, z):
        """z (B, T, D) -> (quantized, codes (B, T, Q), commit loss)."""
        residual = z
        quantized = torch.zeros_like(z)
        codes = []
        commit = z.new_zeros(())
        for q in range(self.num_quantizers):
            cb = self._codebook(q)
            r = (self._norm(getattr(self, f"in{q}")(residual))
                 if self.proj_dim is not None else residual)
            idx = self.nearest(q, r, cb)
            # one-hot rows times the codebook: the gathered rows, with a
            # gradient that is a product (a gather's scatter-add backward
            # adds in another order from run to run)
            sel = F.one_hot(idx, cb.shape[0]).to(cb.dtype) @ cb
            codes.append(idx)
            commit = commit + torch.mean((r - sel.detach()) ** 2)
            commit = commit + torch.mean((r.detach() - sel) ** 2)
            sel_d = (getattr(self, f"out{q}")(sel)
                     if self.proj_dim is not None else sel)
            quantized = quantized + sel_d
            residual = residual - sel_d.detach()
        quantized = z + (quantized - z).detach()
        return quantized, torch.stack(codes, dim=-1), commit

    def lookup(self, codes):
        """codes (B, T, Q) -> the summed codebook vectors (B, T, D)."""
        z = self.codebooks.new_zeros(codes.shape[:2] + (self.dim,))
        for q in range(self.num_quantizers):
            sel = self._codebook(q)[codes[..., q].long()]
            z = z + (getattr(self, f"out{q}")(sel)
                     if self.proj_dim is not None else sel)
        return z


# codec_type -> (activation, unit_dilations, use_lstm, proj_dim,
# multi-scale STFT loss)
CODEC_DEFAULTS = {
    "soundstream": ("elu", (), False, None, False),
    "encodec": ("elu", (1, 3), True, None, True),
    "dac": ("snake", (1, 3, 9), False, 8, True),
}


class CodecModel(nn.Module):
    """The codec with its reconstruction (L1 + lambda_mel x spectral +
    lambda_commit x commit) objective."""

    def __init__(self, fs: int = 16000, codec_type: str = "soundstream",
                 channels: int = 32, strides: Sequence[int] = (2, 4, 5, 8),
                 code_dim: int = 128, num_quantizers: int = 4,
                 codebook_size: int = 256, lambda_commit: float = 0.25,
                 lambda_mel: float = 1.0):
        super().__init__()
        if codec_type not in CODEC_DEFAULTS:
            raise ValueError(f"codec_type {codec_type!r}: one of "
                             f"{sorted(CODEC_DEFAULTS)}")
        act, dils, lstm, proj, self.multi_scale_stft = \
            CODEC_DEFAULTS[codec_type]
        self.fs = fs
        self.codec_type = codec_type
        self.strides = tuple(strides)
        self.lambda_commit = lambda_commit
        self.lambda_mel = lambda_mel
        self.encoder = ConvEncoder(channels, strides, code_dim, act, dils,
                                   lstm)
        self.rvq = ResidualVQ(num_quantizers, codebook_size, code_dim, proj)
        self.decoder = ConvDecoder(channels, strides, code_dim, act, dils,
                                   lstm)

    @property
    def hop(self) -> int:
        h = 1
        for s in self.strides:
            h *= s
        return h

    def encode(self, wav):
        """(B, S) -> codes (B, ceil(S / hop), Q)."""
        return self.rvq(self.encoder(wav))[1]

    def decode(self, codes):
        """codes (B, T, Q) -> (B, T * hop)."""
        return self.decoder(self.rvq.lookup(codes))

    def spectral_loss(self, recon, wav):
        if not self.multi_scale_stft:
            kw = dict(fs=self.fs, n_fft=256, hop_length=64, n_mels=40)
            return torch.mean(torch.abs(melspec(recon, **kw)
                                        - melspec(wav, **kw)))
        total = recon.new_zeros(())
        for n_fft in (128, 256, 512):
            p1, _ = stft_power(recon, None, n_fft=n_fft,
                               hop_length=n_fft // 4)
            p2, _ = stft_power(wav, None, n_fft=n_fft, hop_length=n_fft // 4)
            a1 = torch.sqrt(torch.clamp(p1, min=1e-10))
            a2 = torch.sqrt(torch.clamp(p2, min=1e-10))
            total = total + torch.mean(torch.abs(a1 - a2)) \
                + torch.mean(torch.abs(torch.log(a1) - torch.log(a2)))
        return total / 3.0

    def forward(self, speech, speech_lengths=None,
                generator: Optional[torch.Generator] = None):
        """-> (loss, {loss, recon_l1, mel_l1, commit}, B). The wave is cut
        to a multiple of the hop; lengths are not used, as in the JAX
        package."""
        S = speech.shape[1]
        wav = speech[:, :(S // self.hop) * self.hop]
        zq, _, commit = self.rvq(self.encoder(wav))
        recon = self.decoder(zq)
        n = min(recon.shape[1], wav.shape[1])
        recon, wav = recon[:, :n], wav[:, :n]
        l_time = torch.mean(torch.abs(recon - wav))
        l_mel = self.spectral_loss(recon, wav)
        loss = l_time + self.lambda_mel * l_mel + self.lambda_commit * commit
        return loss, {"loss": loss, "recon_l1": l_time, "mel_l1": l_mel,
                      "commit": commit}, float(speech.shape[0])
