"""Speaker verification (counterpart of espnet_tpu/models/spk.py): a
speaker encoder over log-mel frames (ECAPA, SKA-TDNN, x-vector) or over
the raw wave (RawNet3), channel-attentive statistics pooling, a linear
projector to the embedding, and the additive-angular-margin (AAM)
softmax over learned speaker centres.

Frames are (B, T, C) throughout, as in the flax modules; each
convolution is flax's SAME one (``nn/convolution.py``), its kernel in
the flax tree's layout through ``convert.py``. LayerNorms use flax's
epsilon, 1e-6. The squeeze-excitation of ``SERes2NetBlock`` averages
over every frame of the batch's length, padding included, as the JAX
package does: an embedding depends on how far its batch is padded, so a
caller pads as the JAX package's callers do. RawNet3's max-pools are
flax's SAME pools (padding at -inf, ceil(T / p) outputs), and its sinc
stem a strided SAME convolution with flax's uneven padding.
"""

from __future__ import annotations

import inspect
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from espnet_tpu_torch.frontends.default import DefaultFrontend
from espnet_tpu_torch.nn.conformer import LN_EPS
from espnet_tpu_torch.nn.convolution import (Pointwise, SameConv1d,
                                             SameConv2d, same_pads)
from espnet_tpu_torch.nn.initialize import xavier_uniform_
from espnet_tpu_torch.utils.masks import make_non_pad_mask


def _norm(channels: int) -> nn.LayerNorm:
    return nn.LayerNorm(channels, eps=LN_EPS)


class TimeConv(SameConv1d):
    """flax ``nn.Conv(out, (K,), kernel_dilation=d, padding="SAME")`` on
    (B, T, C) frames."""

    def forward(self, x):
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class FreqConv(SameConv2d):
    """flax ``nn.Conv(out, (kt, kf), strides=(1, s))`` (SAME) on
    (B, T, F, C) frames -> (B, T, ceil(F / s), out). The input is made
    contiguous: on a channels-last view, torch 2.13's CPU backward of a
    strided 1x1 convolution corrupted the heap on 8 threads."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2).contiguous()).permute(
            0, 2, 3, 1)


def max_pool_same(x, p: int):
    """flax ``nn.max_pool(x, (p,), strides=(p,), padding="SAME")`` on
    (B, T, C): -inf padding, (ceil(T / p) p - T) // 2 on the left."""
    total = -(-x.shape[1] // p) * p - x.shape[1]
    h = F.pad(x.transpose(1, 2), (total // 2, total - total // 2),
              value=float("-inf"))
    return F.max_pool1d(h, p, p).transpose(1, 2)


class SERes2NetBlock(nn.Module):
    """Dilated convolution and squeeze-excitation, with a residual add."""

    def __init__(self, channels: int, kernel: int = 3, dilation: int = 1):
        super().__init__()
        self.conv_in = Pointwise(channels, channels)
        self.norm1 = _norm(channels)
        self.dconv = TimeConv(channels, channels, kernel, dilation)
        self.norm2 = _norm(channels)
        self.conv_out = Pointwise(channels, channels)
        self.se1 = nn.Linear(channels, channels // 4)
        self.se2 = nn.Linear(channels // 4, channels)

    def forward(self, x):
        h = F.relu(self.norm1(self.conv_in(x)))
        h = F.relu(self.norm2(self.dconv(h)))
        h = self.conv_out(h)
        # over all T frames, the batch's padding included
        s = F.relu(self.se1(h.mean(1, keepdim=True)))
        return x + h * torch.sigmoid(self.se2(s))


def _blocks(module: nn.Module, channels: int, num_blocks: int):
    """``block{i}``: SERes2NetBlocks at dilation 2**i, as flax names them."""
    for i in range(num_blocks):
        module.add_module(f"block{i}", SERes2NetBlock(channels,
                                                      dilation=2 ** i))


def _run_blocks(module: nn.Module, h, num_blocks: int):
    outs = []
    for i in range(num_blocks):
        h = getattr(module, f"block{i}")(h)
        outs.append(h)
    return F.relu(module.mfa(torch.cat(outs, dim=-1)))


class EcapaEncoder(nn.Module):
    """(B, T, input_size) -> (B, T, channels)."""

    def __init__(self, input_size: int, channels: int = 512,
                 num_blocks: int = 3):
        super().__init__()
        self.output_size = channels
        self.num_blocks = num_blocks
        self.conv_in = TimeConv(input_size, channels, 5)
        self.norm_in = _norm(channels)
        _blocks(self, channels, num_blocks)
        self.mfa = Pointwise(channels * num_blocks, channels)

    def forward(self, feats):
        h = F.relu(self.norm_in(self.conv_in(feats)))
        return _run_blocks(self, h, self.num_blocks)


class AttnStatPooling(nn.Module):
    """Channel-attentive statistics pooling: (B, T, C), (B, T) valid ->
    (B, 2C), the attention-weighted mean and standard deviation."""

    def __init__(self, channels: int, hidden: int = 128):
        super().__init__()
        self.attn1 = Pointwise(3 * channels, hidden)
        self.attn2 = Pointwise(hidden, channels)

    def forward(self, h, valid_mask):
        mask = valid_mask[:, :, None].to(h.dtype)
        n = torch.clamp(mask.sum(1, keepdim=True), min=1.0)
        mu = (h * mask).sum(1, keepdim=True) / n
        sd = torch.sqrt(torch.clamp(
            (((h - mu) ** 2) * mask).sum(1, keepdim=True) / n, min=1e-7))
        ctx = torch.cat([h, mu.expand_as(h), sd.expand_as(h)], dim=-1)
        a = self.attn2(torch.tanh(self.attn1(ctx)))
        a = torch.where(valid_mask[:, :, None], a, a.new_full((), -1e9))
        w = torch.softmax(a, dim=1)
        mean = (h * w).sum(1)
        std = torch.sqrt(torch.clamp((h ** 2 * w).sum(1) - mean ** 2,
                                     min=1e-7))
        return torch.cat([mean, std], dim=-1)


class AFMS(nn.Module):
    """Alpha feature-map scaling: (x + alpha) * sigmoid(fc(mean_t x))."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels))
        self.fc = nn.Linear(channels, channels)

    def forward(self, x):
        g = torch.sigmoid(self.fc(x.mean(1)))
        return (x + self.alpha) * g[:, None, :]


class Bottle2neck(nn.Module):
    """Res2Net bottleneck over time: 1x1 expand, ``scale - 1`` dilated
    convolutions over cumulative channel groups, 1x1 out, residual,
    optional SAME max-pool over time, AFMS."""

    def __init__(self, in_channels: int, planes: int, kernel: int = 3,
                 dilation: int = 1, scale: int = 8, pool: int = 0):
        super().__init__()
        self.scale, self.pool = scale, pool
        self.width = width = planes // scale
        if in_channels != planes:
            self.residual = Pointwise(in_channels, planes, bias=False)
        self.conv1 = Pointwise(in_channels, width * scale)
        self.bn1 = _norm(width * scale)
        for i in range(scale - 1):
            self.add_module(f"convs{i}", TimeConv(width, width, kernel,
                                                  dilation))
            self.add_module(f"bns{i}", _norm(width))
        self.conv3 = Pointwise(width * scale, planes)
        self.bn3 = _norm(planes)
        self.afms = AFMS(planes)

    def forward(self, x):
        w = self.width
        res = self.residual(x) if hasattr(self, "residual") else x
        h = self.bn1(F.relu(self.conv1(x)))
        sp, outs = None, []
        for i in range(self.scale - 1):
            part = h[..., i * w:(i + 1) * w]
            sp = part if sp is None else sp + part
            sp = getattr(self, f"bns{i}")(F.relu(
                getattr(self, f"convs{i}")(sp)))
            outs.append(sp)
        outs.append(h[..., (self.scale - 1) * w:])
        h = self.bn3(F.relu(self.conv3(torch.cat(outs, dim=-1)))) + res
        if self.pool:
            h = max_pool_same(h, self.pool)
        return self.afms(h)


def mel_init_cutoffs(n_filters: int, fs: float) -> np.ndarray:
    """Mel-spaced (low, high) cutoff pairs in normalised frequency (the
    JAX package's ``nn/preencoder.py:_mel_init_cutoffs``)."""
    mel_max = 2595.0 * np.log10(1.0 + (fs / 2) / 700.0)
    mels = np.linspace(0.0, mel_max, n_filters + 2)
    hz = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    return np.stack([hz[:-2] / fs, hz[2:] / fs], axis=1).astype(np.float32)


class RawNet3Encoder(nn.Module):
    """(B, S) wave, (B,) lengths -> ((B, T, out_channels), (B,) lengths):
    a sinc-filterbank stem (band-pass filters from learned mel-initialised
    cutoffs, a strided SAME convolution, log1p |.|, LayerNorm), three
    Bottle2necks (pooled by 5 and 3), a multi-scale concat and a 1x1
    output convolution. Output lengths are max(len // stride // 15, 1)."""

    def __init__(self, ndim: int = 256, model_scale: int = 4,
                 out_channels: int = 384, stem_filters: int = 80,
                 stem_kernel: int = 251, stem_stride: int = 160):
        super().__init__()
        self.output_size = out_channels
        self.stem_kernel, self.stem_stride = stem_kernel, stem_stride
        self.cutoffs = nn.Parameter(torch.from_numpy(
            mel_init_cutoffs(stem_filters, 16000.0)))
        self.register_buffer("hamming", torch.from_numpy(
            np.hamming(stem_kernel).astype(np.float32)), persistent=False)
        self.stem_norm = _norm(stem_filters)
        self.layer1 = Bottle2neck(stem_filters, ndim, 3, 2, model_scale,
                                  pool=5)
        self.layer2 = Bottle2neck(ndim, ndim, 3, 3, model_scale, pool=3)
        self.layer3 = Bottle2neck(ndim, ndim, 3, 4, model_scale)
        self.layer4 = Pointwise(3 * ndim, out_channels)

    def flax_init_(self, generator: torch.Generator):
        with torch.no_grad():
            self.cutoffs.copy_(torch.from_numpy(mel_init_cutoffs(
                self.cutoffs.shape[0], 16000.0)))

    def filters(self):
        """(F, K) band-pass filters, each scaled to a largest |tap| of 1."""
        K = self.stem_kernel
        low = self.cutoffs[:, 0].abs()
        high = low + (self.cutoffs[:, 1] - self.cutoffs[:, 0]).abs()
        n = torch.arange(-(K // 2), K // 2 + 1, dtype=self.cutoffs.dtype,
                         device=self.cutoffs.device)
        # a safe denominator: where() alone would let the untaken branch's
        # NaN at n == 0 into the gradient
        n_safe = torch.where(n == 0, torch.ones_like(n), n)

        def sinc(f):
            return torch.where(n == 0, 2.0 * f[:, None],
                               torch.sin(2.0 * math.pi * f[:, None] * n_safe)
                               / (math.pi * n_safe))

        filt = (sinc(high) - sinc(low)) * self.hamming.to(n.dtype)[None]
        return filt / torch.clamp(filt.abs().amax(1, keepdim=True),
                                  min=1e-8)

    def forward(self, speech, speech_lengths):
        S = speech.shape[1]
        x = F.conv1d(F.pad(speech[:, None], same_pads(
            self.stem_kernel, 1, self.stem_stride, S)),
            self.filters()[:, None, :], stride=self.stem_stride)
        x = self.stem_norm(torch.log1p(x.abs()).transpose(1, 2))
        lens = speech_lengths // self.stem_stride
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x1p = max_pool_same(x1, 3)
        T = min(x1p.shape[1], x2.shape[1])
        x3 = self.layer3(x1p[:, :T] + x2[:, :T])
        h = torch.cat([x1p[:, :T], x2[:, :T], x3[:, :T]], dim=-1)
        return F.relu(self.layer4(h)), torch.clamp(lens // 15, min=1)


class SKAttention(nn.Module):
    """Selective-kernel attention over (B, T, F, C): two SAME 2-D
    convolutions of kernels 3 and 5, and a softmax over the two branches
    per channel (``axis="channel"``) or per frequency bin (``"freq"``)
    from their pooled sum."""

    def __init__(self, channels: int, freq: int, kernels=(3, 5),
                 axis: str = "channel", reduction: int = 4,
                 min_d: int = 16):
        super().__init__()
        self.kernels, self.axis = tuple(kernels), axis
        for i, k in enumerate(self.kernels):
            self.add_module(f"conv{i}", FreqConv(channels, channels, (k, k)))
            self.add_module(f"bn{i}", _norm(channels))
        n_sel = channels if axis == "channel" else freq
        d = max(min_d, n_sel // reduction)
        self.fc = nn.Linear(n_sel, d)
        for i in range(len(self.kernels)):
            self.add_module(f"fcs{i}", nn.Linear(d, n_sel))

    def forward(self, x):
        branches = [getattr(self, f"bn{i}")(F.relu(
            getattr(self, f"conv{i}")(x))) for i in range(len(self.kernels))]
        u = sum(branches)
        s = u.mean((1, 2)) if self.axis == "channel" else u.mean((1, 3))
        z = F.relu(self.fc(s))
        w = torch.softmax(torch.stack([getattr(self, f"fcs{i}")(z) for i in
                                       range(len(self.kernels))]), dim=0)
        w = (w[:, :, None, None, :] if self.axis == "channel"
             else w[:, :, None, :, None])
        return sum(wk * bk for wk, bk in zip(w, branches))


class SkaResBlock(nn.Module):
    """3x3 convolution striding over frequency, then frequency-wise and
    channel-wise selective-kernel attention, with a residual add."""

    def __init__(self, in_channels: int, channels: int, freq: int,
                 stride: int = 1):
        super().__init__()
        out_freq = -(-freq // stride)
        self.conv1 = FreqConv(in_channels, channels, (3, 3), (1, stride))
        self.bn1 = _norm(channels)
        self.skfwse = SKAttention(channels, out_freq, axis="freq")
        self.skcwse = SKAttention(channels, out_freq, axis="channel")
        if stride != 1 or in_channels != channels:
            self.down = FreqConv(in_channels, channels, (1, 1), (1, stride))

    def forward(self, x):
        h = self.bn1(F.relu(self.conv1(x)))
        h = self.skcwse(self.skfwse(h))
        res = self.down(x) if hasattr(self, "down") else x
        return F.relu(h + res)


class SkaTdnnEncoder(nn.Module):
    """(B, T, input_size) -> (B, T, tdnn_channels): a 2-D stem and SKA
    residual blocks striding by 2 over frequency, flattened into ECAPA's
    dilated blocks."""

    def __init__(self, input_size: int, channels: int = 32,
                 num_res_blocks: int = 2, tdnn_channels: int = 128,
                 num_blocks: int = 2):
        super().__init__()
        self.output_size = tdnn_channels
        self.num_res_blocks, self.num_blocks = num_res_blocks, num_blocks
        self.stem = FreqConv(1, channels, (3, 3))
        self.stem_norm = _norm(channels)
        freq = input_size
        for i in range(num_res_blocks):
            self.add_module(f"res{i}", SkaResBlock(channels, channels, freq,
                                                   stride=2))
            freq = -(-freq // 2)
        self.conv_in = TimeConv(freq * channels, tdnn_channels, 5)
        self.norm_in = _norm(tdnn_channels)
        _blocks(self, tdnn_channels, num_blocks)
        self.mfa = Pointwise(tdnn_channels * num_blocks, tdnn_channels)

    def forward(self, feats):
        h = self.stem_norm(F.relu(self.stem(feats[..., None])))
        for i in range(self.num_res_blocks):
            h = getattr(self, f"res{i}")(h)
        B, T, Fr, C = h.shape
        h = F.relu(self.norm_in(self.conv_in(h.reshape(B, T, Fr * C))))
        return _run_blocks(self, h, self.num_blocks)


class XVectorEncoder(nn.Module):
    """Five TDNN layers, (kernel, dilation) (5, 1), (3, 2), (3, 3),
    (1, 1), (1, 1), each convolution -> LayerNorm -> ReLU."""

    def __init__(self, input_size: int, channels: int = 512,
                 out_channels: int = 1500):
        super().__init__()
        self.output_size = out_channels
        layers = [(5, 1, channels), (3, 2, channels), (3, 3, channels),
                  (1, 1, channels), (1, 1, out_channels)]
        c_in = input_size
        for i, (k, d, c) in enumerate(layers):
            self.add_module(f"tdnn{i}", TimeConv(c_in, c, k, d))
            self.add_module(f"norm{i}", _norm(c))
            c_in = c
        self.n_layers = len(layers)

    def forward(self, feats):
        h = feats
        for i in range(self.n_layers):
            h = F.relu(getattr(self, f"norm{i}")(
                getattr(self, f"tdnn{i}")(h)))
        return h


def aam_softmax_loss(emb, weight, labels, margin=0.2, scale: float = 30.0):
    """ArcFace AAM-softmax: (B, D) embeddings, (n_spk, D) centres, (B,)
    labels -> (loss, accuracy). The target's angle grows by ``margin``
    (a float or a 0-d tensor); the cosine is clipped to +-(1 - 1e-7)
    before its arccos."""
    emb_n = emb / torch.clamp(torch.linalg.norm(emb, dim=1, keepdim=True),
                              min=1e-9)
    w_n = weight / torch.clamp(torch.linalg.norm(weight, dim=1,
                                                 keepdim=True), min=1e-9)
    cos = emb_n @ w_n.T
    theta = torch.arccos(torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7))
    onehot = F.one_hot(labels, weight.shape[0]).to(cos.dtype)
    logits = scale * (onehot * torch.cos(theta + margin)
                      + (1 - onehot) * cos)
    loss = -torch.mean(torch.sum(onehot * torch.log_softmax(logits, -1),
                                 dim=-1))
    acc = torch.mean((torch.argmax(cos, -1) == labels).to(cos.dtype))
    return loss, acc


SPK_ENCODERS = {"ecapa": EcapaEncoder, "rawnet3": RawNet3Encoder,
                "ska_tdnn": SkaTdnnEncoder, "xvector": XVectorEncoder}


def encoder_fields(name: str) -> set:
    """The configuration fields of SPK_ENCODERS[name]."""
    params = inspect.signature(SPK_ENCODERS[name]).parameters
    return set(params) - {"input_size"}


class SpeakerModel(nn.Module):
    """frontend (not for RawNet3) -> encoder -> pooling -> projector; the
    loss is the AAM-softmax of the embedding against ``aam_weight``."""

    def __init__(self, n_spk: int, frontend_conf: Optional[dict] = None,
                 encoder_name: str = "ecapa",
                 encoder_conf: Optional[dict] = None, embed_dim: int = 192,
                 aam_margin: float = 0.2, aam_scale: float = 30.0):
        super().__init__()
        fc = dict(frontend_conf or {"n_fft": 512, "hop_length": 160,
                                    "n_mels": 80})
        self.frontend = DefaultFrontend(**fc)
        self.encoder_name = encoder_name
        conf = dict(encoder_conf or {})
        if encoder_name == "rawnet3":
            self.encoder = RawNet3Encoder(**conf)
        else:
            self.encoder = SPK_ENCODERS[encoder_name](
                self.frontend.output_size, **conf)
        self.pooling = AttnStatPooling(self.encoder.output_size)
        self.projector = nn.Linear(2 * self.encoder.output_size, embed_dim)
        self.aam_weight = nn.Parameter(torch.zeros(n_spk, embed_dim))
        self.aam_margin, self.aam_scale = aam_margin, aam_scale

    def flax_init_(self, generator: torch.Generator):
        xavier_uniform_(self.aam_weight, generator)

    def extract_embedding(self, speech, speech_lengths):
        """(B, S) wave, (B,) lengths -> (B, embed_dim)."""
        if self.encoder_name == "rawnet3":
            h, flens = self.encoder(speech, speech_lengths)
        else:
            feats, flens = self.frontend(speech, speech_lengths)
            h = self.encoder(feats)
        return self.projector(self.pooling(
            h, make_non_pad_mask(flens, h.shape[1])))

    def forward(self, speech, speech_lengths, spk_labels,
                spk_labels_lengths=None, margin=None,
                generator: Optional[torch.Generator] = None):
        """``margin``: a per-batch 0-d margin in place of ``aam_margin``
        (the task's warm-up puts it in each train batch); it is reported
        as ``stats["margin"]``. -> (loss, {loss, acc[, margin]}, B)."""
        emb = self.extract_embedding(speech, speech_lengths)
        labels = spk_labels[:, 0] if spk_labels.dim() > 1 else spk_labels
        m = self.aam_margin if margin is None else margin.reshape(())
        loss, acc = aam_softmax_loss(emb, self.aam_weight, labels, m,
                                     self.aam_scale)
        stats = {"loss": loss, "acc": acc}
        if margin is not None:
            stats["margin"] = m
        return loss, stats, float(speech.shape[0])
