"""Enhancement separators (counterpart of
espnet_tpu/models/enh/separators.py). Each maps (B, T, F) features to
``num_spk`` outputs of the same shape. The class attributes say what a
separator takes and gives, as in the JAX package: ``complex_input``
separators take the (real, imag) spectrum; ``output`` is "mask" (real
masks, the default), "complex_mask" ((mr, mi) ratio masks), "spectrum"
((er, ei) estimates) or "dpcl" (a (B, T, F, D) bin embedding that the
model clusters by k-means); ``needs_ref_spectra`` (DAN) takes the
references' magnitudes in training.

- Masking: the BLSTM ``rnn``, Conv-TasNet's ``tcn``, ``dprnn`` and
  ``dptnet`` (dual path over 50%-overlapped chunks), ``skim`` (segment
  LSTMs seeded by memory LSTMs), ``transformer`` and ``conformer`` (the
  encoders with a linear input; the Conformer's rel-pos self-attention
  runs the fused attention kernel, K1, and its backward, K1b).
- Complex: ``tfgridnet`` (spectrum), ``bsrnn``, ``dc_crn`` and ``dccrn``
  (complex masks).
- Clustering: ``dpcl`` (embedding; ``dpcl_loss`` trains it),
  ``dan`` (attractors) and ``dpcl_e2e`` (soft k-means, then a BLSTM).

Attribute names follow the JAX parameter tree (``conv1x1``, ``PReLU_0``,
``OptimizedLSTMCell_0``, ...) so that ``convert.py`` maps one onto the
other by path. flax numbers its unnamed ``PReLU`` and LSTM cells per
module in the order it creates them, and the port's names follow that
order. The layouts that flax has and torch lacks are written out:
``Pointwise`` is flax's ``nn.Conv(..., (1,))``, a product with a
(1, in, out) kernel; ``PReLU`` is flax's, one scalar ``negative_slope``;
``LayerNorm`` takes flax's epsilon, 1e-6, and ``TwoAxisLayerNorm`` is
flax's ``LayerNorm(reduction_axes=(-2, -1))``, statistics over the last
two axes and scale and bias per channel. 2-D convolutions run
channels-first with flax's SAME padding (``nn/convolution.py``) on the
channels-last activations. The LSTM is the port's ``LSTMCell`` (flax's
``OptimizedLSTMCell`` layout) in a loop over frames, not cuDNN's.

``_segment`` and ``_merge`` cut frames into 50%-overlapped chunks and add
them back with F.unfold and F.fold: no index scatter-add, so that the
gradient on the card adds in a fixed order. ``kmeans_tf_bins`` runs a
fixed number of Lloyd steps, as in the JAX package.

The JAX package's time-domain, multichannel and USES separators and
the TF-GridNet v2/v3 variants raise NotImplementedError (ROADMAP A.4).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from espnet_tpu_torch.models.transducer import LSTMCell
from espnet_tpu_torch.nn.attention import SelfAttention
from espnet_tpu_torch.nn.conformer import ConformerEncoder
from espnet_tpu_torch.nn.convolution import (DepthwiseConv1d, Pointwise,
                                             SameConv2d, SameConvTranspose2d)
from espnet_tpu_torch.nn.transformer import TransformerEncoder

FLAX_LN_EPS = 1e-6


class PReLU(nn.Module):
    """flax's PReLU: x where x >= 0, else negative_slope * x, with one
    scalar slope (0.01 at init)."""

    def __init__(self):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(0.01))

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope * x)


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=FLAX_LN_EPS)


class TwoAxisLayerNorm(nn.LayerNorm):
    """flax's ``LayerNorm(reduction_axes=(-2, -1))``: mean and variance
    over the last two axes, scale and bias over the last one only
    (TF-GridNet's norm over (F, channel)). ``nn.LayerNorm((F, C))``
    would hold a scale per (F, C)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=FLAX_LN_EPS)

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(-2, -1), unbiased=False,
                                   keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


def lstm_scan(cell: LSTMCell, x, carry=None, reverse: bool = False):
    """One LSTM direction over the frames of (B, T, D) from ``carry``
    (c, h), zeros by default -> (B, T, H) outputs, the last carry. The
    input projections are formed once and unbound (a slice per frame
    would cost its backward a zero-filled copy of all frames' gradient
    each frame), and the hidden kernel is taken once."""
    B, T, _ = x.shape
    wt = cell.hidden_kernel()
    H = wt.shape[0]
    proj = cell.input_proj(x).unbind(1)
    c, h = carry if carry is not None else (x.new_zeros(B, H),
                                            x.new_zeros(B, H))
    out = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        c, h = cell((c, h), proj[t], wt)
        out[t] = h
    return torch.stack(out, dim=1), (c, h)


class BLSTM(nn.Module):
    """One bidirectional LSTM layer over every frame: (B, T, D) -> (B, T,
    2H). The backward direction runs over the padding too, as the JAX
    package's ``nn.RNN(reverse=True, keep_order=True)`` without lengths
    does. Cell 0 runs forward, cell 1 backward."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.OptimizedLSTMCell_0 = LSTMCell(input_size, hidden)
        self.OptimizedLSTMCell_1 = LSTMCell(input_size, hidden)

    def forward(self, x):
        return torch.cat([lstm_scan(self.OptimizedLSTMCell_0, x)[0],
                          lstm_scan(self.OptimizedLSTMCell_1, x,
                                    reverse=True)[0]], dim=-1)


NONLINEAR = {"sigmoid": torch.sigmoid, "relu": F.relu, "tanh": torch.tanh}


def _speaker_masks(m, num_spk: int, nonlinear: str):
    """(B, T, S * F) -> the list over speakers of (B, T, F) masks through
    relu, sigmoid or a softmax over the speakers."""
    B, T, _ = m.shape
    m = m.reshape(B, T, num_spk, -1)
    if nonlinear == "softmax":
        m = torch.softmax(m, dim=2)
    else:
        m = {"relu": F.relu, "sigmoid": torch.sigmoid}[nonlinear](m)
    return [m[:, :, s] for s in range(num_spk)]


def _mask_heads(module: nn.Module, hidden: int, input_dim: int,
                num_spk: int, nonlinear: str):
    """Per speaker ``mask{s}`` = Linear(hidden, input_dim), and the
    nonlinearity (the RNN, Transformer and Conformer separators' heads)."""
    for s in range(num_spk):
        module.add_module(f"mask{s}", nn.Linear(hidden, input_dim))
    module.num_spk = num_spk
    module.nonlinear = nonlinear


def _apply_mask_heads(module: nn.Module, h):
    act = NONLINEAR[module.nonlinear]
    return [act(getattr(module, f"mask{s}")(h))
            for s in range(module.num_spk)]


def _blstm_stack(module: nn.Module, input_dim: int, layers: int, unit: int):
    for i in range(layers):
        module.add_module(f"blstm{i}", BLSTM(
            input_dim if i == 0 else 2 * unit, unit))


class RNNSeparator(nn.Module):
    """Stacked BLSTMs, then per speaker a Linear and the mask
    nonlinearity."""

    def __init__(self, input_dim: int, num_spk: int = 2,
                 rnn_hidden: int = 128, num_layers: int = 2,
                 nonlinear: str = "sigmoid", dropout_rate: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        _blstm_stack(self, input_dim, num_layers, rnn_hidden)
        self.dropout = nn.Dropout(dropout_rate)
        _mask_heads(self, 2 * rnn_hidden, input_dim, num_spk, nonlinear)

    def forward(self, x):
        h = x
        for i in range(self.num_layers):
            h = self.dropout(getattr(self, f"blstm{i}")(h))
        return _apply_mask_heads(self, h)


class TCNBlock(nn.Module):
    """1x1 conv, PReLU, LayerNorm, dilated depthwise conv, PReLU,
    LayerNorm, 1x1 conv back to the bottleneck, plus the input."""

    def __init__(self, bottleneck: int, hidden: int, kernel: int,
                 dilation: int):
        super().__init__()
        self.conv1x1 = Pointwise(bottleneck, hidden)
        self.PReLU_0 = PReLU()
        self.norm1 = layer_norm(hidden)
        self.dconv = DepthwiseConv1d(hidden, kernel, dilation=dilation)
        self.PReLU_1 = PReLU()
        self.norm2 = layer_norm(hidden)
        self.res_out = Pointwise(hidden, bottleneck)

    def forward(self, x):
        h = self.norm1(self.PReLU_0(self.conv1x1(x)))
        h = self.norm2(self.PReLU_1(self.dconv(h)))
        return x + self.res_out(h)


class TCNSeparator(nn.Module):
    """Conv-TasNet's TCN: LayerNorm, a 1x1 bottleneck, ``stacks`` repeats
    of ``layers`` blocks at dilations 1, 2, 4, ..., PReLU, a 1x1 conv to
    num_spk masks and their nonlinearity."""

    def __init__(self, input_dim: int, num_spk: int = 2, layers: int = 4,
                 stacks: int = 2, bottleneck_dim: int = 64,
                 hidden_dim: int = 128, kernel: int = 3,
                 nonlinear: str = "relu"):
        super().__init__()
        if nonlinear not in ("relu", "sigmoid", "softmax"):
            raise ValueError(f"nonlinear {nonlinear!r}")
        self.input_dim = input_dim
        self.num_spk = num_spk
        self.nonlinear = nonlinear
        self.norm_in = layer_norm(input_dim)
        self.bottleneck = Pointwise(input_dim, bottleneck_dim)
        self.blocks = []
        for r in range(stacks):
            for i in range(layers):
                name = f"tcn{r}_{i}"
                self.add_module(name, TCNBlock(bottleneck_dim, hidden_dim,
                                               kernel, 2 ** i))
                self.blocks.append(name)
        self.PReLU_0 = PReLU()
        self.mask_out = Pointwise(bottleneck_dim, num_spk * input_dim)

    def forward(self, x):
        h = self.bottleneck(self.norm_in(x))
        for name in self.blocks:
            h = getattr(self, name)(h)
        return _speaker_masks(self.mask_out(self.PReLU_0(h)), self.num_spk,
                              self.nonlinear)




# ---- dual path: DPRNN, DPTNet ----------------------------------------------

def _segment(x, K: int):
    """(B, T, F) -> (B, n, K, F) chunks with 50% overlap (hop K // 2),
    the tail zero-padded; -> (chunks, padded length)."""
    B, T, Fd = x.shape
    P = K // 2
    n = -(-max(T - K, 0) // P) + 1
    Tp = (n - 1) * P + K
    cols = F.unfold(F.pad(x, (0, 0, 0, Tp - T)).transpose(1, 2)[:, :, None],
                    (1, K), stride=(1, P))           # (B, F * K, n)
    return cols.reshape(B, Fd, K, n).permute(0, 3, 2, 1), Tp


def _merge(chunks, T: int):
    """The inverse of ``_segment``: overlapping chunks added back and
    divided by the number that cover each frame -> (B, T, F)."""
    B, n, K, Fd = chunks.shape
    P = K // 2
    Tp = (n - 1) * P + K
    out = F.fold(chunks.permute(0, 3, 2, 1).reshape(B, Fd * K, n), (1, Tp),
                 (1, K), stride=(1, P))[:, :, 0]    # (B, F, Tp)
    wt = F.fold(chunks.new_ones(1, K, n), (1, Tp), (1, K),
                stride=(1, P))[0, 0]                # (1, Tp)
    return (out / wt.clamp(min=1.0)).transpose(1, 2)[:, :T]


class DPRNNSeparator(nn.Module):
    """Dual-path RNN: a Linear bottleneck, 50%-overlapped chunks, per
    block an intra-chunk BLSTM (over K) and an inter-chunk BLSTM (over
    the chunks), each projected back and added under a LayerNorm; the
    chunks merged, PReLU, one Linear to num_spk masks."""

    def __init__(self, input_dim: int, num_spk: int = 2,
                 num_blocks: int = 3, chunk_size: int = 40,
                 hidden: int = 64, bottleneck: int = 64,
                 nonlinear: str = "relu"):
        super().__init__()
        self.num_spk, self.num_blocks = num_spk, num_blocks
        self.chunk_size, self.nonlinear = chunk_size, nonlinear
        D = bottleneck
        self.embed = nn.Linear(input_dim, D)
        for blk in range(num_blocks):
            for path in ("intra", "inter"):
                self.add_module(f"{path}{blk}", BLSTM(D, hidden))
                self.add_module(f"{path}_proj{blk}",
                                nn.Linear(2 * hidden, D))
                self.add_module(f"{path}_norm{blk}", layer_norm(D))
        self.PReLU_0 = PReLU()
        self.mask_out = nn.Linear(D, num_spk * input_dim)

    def forward(self, x):
        B, T, _ = x.shape
        seg, _ = _segment(self.embed(x), self.chunk_size)
        _, n, K, D = seg.shape
        for blk in range(self.num_blocks):
            intra = getattr(self, f"intra{blk}")(seg.reshape(B * n, K, D))
            intra = getattr(self, f"intra_proj{blk}")(intra)
            seg = getattr(self, f"intra_norm{blk}")(
                seg + intra.reshape(B, n, K, D))
            inter = getattr(self, f"inter{blk}")(
                seg.transpose(1, 2).reshape(B * K, n, D))
            inter = getattr(self, f"inter_proj{blk}")(inter)
            seg = getattr(self, f"inter_norm{blk}")(
                seg + inter.reshape(B, K, n, D).transpose(1, 2))
        h = _merge(seg, T)
        return _speaker_masks(self.mask_out(self.PReLU_0(h)), self.num_spk,
                              self.nonlinear)


class _ImprovedTransformerLayer(nn.Module):
    """DPTNet's layer: pre-norm self-attention, then a pre-norm BLSTM ->
    ReLU -> Linear in place of the feed-forward, each with a residual."""

    def __init__(self, d_model: int, heads: int, hidden: int):
        super().__init__()
        self.norm1 = layer_norm(d_model)
        self.mha = SelfAttention(d_model, heads)
        self.norm2 = layer_norm(d_model)
        self.ff_rnn = BLSTM(d_model, hidden)
        self.ff_out = nn.Linear(2 * hidden, d_model)

    def forward(self, x):
        x = x + self.mha(self.norm1(x))
        return x + self.ff_out(F.relu(self.ff_rnn(self.norm2(x))))


class DPTNetSeparator(nn.Module):
    """Dual-path transformer: DPRNN's chunks with an improved transformer
    layer along each path."""

    def __init__(self, input_dim: int, num_spk: int = 2,
                 num_blocks: int = 3, chunk_size: int = 40, heads: int = 4,
                 hidden: int = 64, bottleneck: int = 64,
                 nonlinear: str = "relu"):
        super().__init__()
        self.num_spk, self.num_blocks = num_spk, num_blocks
        self.chunk_size, self.nonlinear = chunk_size, nonlinear
        self.embed = nn.Linear(input_dim, bottleneck)
        for blk in range(num_blocks):
            for path in ("intra", "inter"):
                self.add_module(f"{path}{blk}", _ImprovedTransformerLayer(
                    bottleneck, heads, hidden))
        self.PReLU_0 = PReLU()
        self.mask_out = nn.Linear(bottleneck, num_spk * input_dim)

    def forward(self, x):
        B, T, _ = x.shape
        seg, _ = _segment(self.embed(x), self.chunk_size)
        _, n, K, D = seg.shape
        for blk in range(self.num_blocks):
            seg = getattr(self, f"intra{blk}")(
                seg.reshape(B * n, K, D)).reshape(B, n, K, D)
            inter = getattr(self, f"inter{blk}")(
                seg.transpose(1, 2).reshape(B * K, n, D))
            seg = inter.reshape(B, K, n, D).transpose(1, 2)
        h = _merge(seg, T)
        return _speaker_masks(self.mask_out(self.PReLU_0(h)), self.num_spk,
                              self.nonlinear)


# ---- SkiM -------------------------------------------------------------------

class _SkiMChunkStep(nn.Module):
    """One SkiM block's recurrences: the segment LSTM
    (``OptimizedLSTMCell_0``) over each segment from the carried state,
    and with mem_type "hc" the memory LSTMs ``mem_h`` and ``mem_c``
    stepping once a segment on its last h and c to seed the next; with
    any other mem_type the last (h, c) carry over as they are."""

    def __init__(self, input_size: int, hidden: int, mem_type: str):
        super().__init__()
        self.mem_type = mem_type
        self.OptimizedLSTMCell_0 = LSTMCell(input_size, hidden)
        if mem_type == "hc":
            self.mem_h = LSTMCell(hidden, hidden)
            self.mem_c = LSTMCell(hidden, hidden)

    def forward(self, seg):
        """(B, S, K, D) segments -> (B, S, K, H) outputs."""
        B, S, K, _ = seg.shape
        cell = self.OptimizedLSTMCell_0
        H = cell.hi.weight.shape[0]
        zeros = seg.new_zeros(B, H)
        carry, mem = (zeros, zeros), ((zeros, zeros), (zeros, zeros))
        outs = []
        for j in range(S):
            out, (c_k, h_k) = lstm_scan(cell, seg[:, j], carry)
            outs.append(out)
            if self.mem_type == "hc":
                mem_h = self.mem_h(mem[0], self.mem_h.input_proj(h_k))
                mem_c = self.mem_c(mem[1], self.mem_c.input_proj(c_k))
                mem = (mem_h, mem_c)
                carry = (mem_c[1], mem_h[1])
            else:
                carry = (c_k, h_k)
        return torch.stack(outs, dim=1)


class SkiMSeparator(nn.Module):
    """SkiM: non-overlapping segments of ``segment_size`` frames, per
    block the segment LSTM seeded by the memory LSTMs, projected back and
    added under a LayerNorm; PReLU and one Linear to num_spk masks."""

    def __init__(self, input_dim: int, num_spk: int = 2,
                 num_blocks: int = 2, segment_size: int = 20,
                 hidden: int = 64, bottleneck: int = 64,
                 mem_type: str = "hc", nonlinear: str = "relu"):
        super().__init__()
        self.num_spk, self.num_blocks = num_spk, num_blocks
        self.segment_size, self.nonlinear = segment_size, nonlinear
        D = bottleneck
        self.embed = nn.Linear(input_dim, D)
        for blk in range(num_blocks):
            self.add_module(f"skim{blk}", _SkiMChunkStep(D, hidden,
                                                         mem_type))
            self.add_module(f"seg_proj{blk}", nn.Linear(hidden, D))
            self.add_module(f"seg_norm{blk}", layer_norm(D))
        self.PReLU_0 = PReLU()
        self.mask_out = nn.Linear(D, num_spk * input_dim)

    def forward(self, x):
        B, T, _ = x.shape
        K = self.segment_size
        S = -(-T // K)
        h = F.pad(self.embed(x), (0, 0, 0, S * K - T))
        D = h.shape[-1]
        seg = h.reshape(B, S, K, D)
        for blk in range(self.num_blocks):
            outs = getattr(self, f"skim{blk}")(seg)
            seg = getattr(self, f"seg_norm{blk}")(
                seg + getattr(self, f"seg_proj{blk}")(outs))
        h = seg.reshape(B, S * K, D)[:, :T]
        return _speaker_masks(self.mask_out(self.PReLU_0(h)), self.num_spk,
                              self.nonlinear)


# ---- TF-GridNet, BSRNN ------------------------------------------------------

def frame_attention(q, k, v, temperature: float):
    """TF-GridNet's full-band attention over frames: q, k (B, T, F * E),
    v (B, T, F * Dv) -> softmax(q k^T / temperature) v."""
    return torch.softmax(q @ k.transpose(1, 2) / temperature, dim=-1) @ v


class TFGridNetSeparator(nn.Module):
    """TF-GridNet: the (real, imag) spectrum embedded per bin; per block
    a BLSTM over frequency, a BLSTM over time and a full-band
    self-attention over frames (per head 1x1 projections, PReLU and a
    LayerNorm over (F, channel); keys and queries hold the whole band,
    F * E), each a residual; a Linear to the speakers' (real, imag)
    estimates. flax creates three PReLUs per head (Q, K, V) and one
    for the output in each block: ``PReLU_n`` in that order."""

    complex_input = True
    output = "spectrum"

    def __init__(self, input_dim: int, num_spk: int = 2,
                 num_blocks: int = 3, emb_dim: int = 32, hidden: int = 64,
                 attn_heads: int = 2, attn_qk_dim: int = 4):
        super().__init__()
        self.num_spk, self.num_blocks = num_spk, num_blocks
        self.heads, self.qk_dim = attn_heads, attn_qk_dim
        D, E, Dv = emb_dim, attn_qk_dim, emb_dim // attn_heads
        self.embed = nn.Linear(2, D)
        n_prelu = 0
        for blk in range(num_blocks):
            for axis in ("freq", "time"):
                norm = "fnorm" if axis == "freq" else "tnorm"
                self.add_module(f"{norm}{blk}", layer_norm(D))
                self.add_module(f"{axis}_blstm{blk}", BLSTM(D, hidden))
                self.add_module(f"{axis}_proj{blk}", nn.Linear(2 * hidden, D))
            self.add_module(f"anorm{blk}", layer_norm(D))
            for ii in range(attn_heads):
                for kind, width in (("Q", E), ("K", E), ("V", Dv)):
                    self.add_module(f"attn{kind}{blk}_{ii}",
                                    nn.Linear(D, width))
                    self.add_module(f"PReLU_{n_prelu}", PReLU())
                    n_prelu += 1
                    self.add_module(f"attn{kind}n{blk}_{ii}",
                                    TwoAxisLayerNorm(width))
            self.add_module(f"attnO{blk}", nn.Linear(attn_heads * Dv, D))
            self.add_module(f"PReLU_{n_prelu}", PReLU())
            n_prelu += 1
            self.add_module(f"attnOn{blk}", TwoAxisLayerNorm(D))
        self.deconv = nn.Linear(D, 2 * num_spk)

    def forward(self, ri):
        real, imag = ri
        B, T, Fq = real.shape
        h = self.embed(torch.stack([real, imag], dim=-1))   # (B, T, F, D)
        D, E, Hh = h.shape[-1], self.qk_dim, self.heads
        Dv = D // Hh
        n_prelu = 0
        for blk in range(self.num_blocks):
            z = getattr(self, f"fnorm{blk}")(h).reshape(B * T, Fq, D)
            z = getattr(self, f"freq_proj{blk}")(
                getattr(self, f"freq_blstm{blk}")(z))
            h = h + z.reshape(B, T, Fq, D)
            z = getattr(self, f"tnorm{blk}")(h).transpose(1, 2)
            z = getattr(self, f"time_proj{blk}")(
                getattr(self, f"time_blstm{blk}")(z.reshape(B * Fq, T, D)))
            h = h + z.reshape(B, Fq, T, D).transpose(1, 2)
            z = getattr(self, f"anorm{blk}")(h)
            heads = []
            for ii in range(Hh):
                qkv = []
                for kind in ("Q", "K", "V"):
                    y = getattr(self, f"attn{kind}{blk}_{ii}")(z)
                    y = getattr(self, f"PReLU_{n_prelu}")(y)
                    n_prelu += 1
                    qkv.append(getattr(self, f"attn{kind}n{blk}_{ii}")(y))
                q, k, v = (t.reshape(B, T, -1) for t in qkv)
                heads.append(frame_attention(q, k, v, math.sqrt(Fq * E))
                             .reshape(B, T, Fq, Dv))
            y = getattr(self, f"attnO{blk}")(torch.cat(heads, dim=-1))
            y = getattr(self, f"PReLU_{n_prelu}")(y)
            n_prelu += 1
            h = h + getattr(self, f"attnOn{blk}")(y)
        out = self.deconv(h).reshape(B, T, Fq, self.num_spk, 2)
        return [(out[..., s, 0], out[..., s, 1])
                for s in range(self.num_spk)]


class BSRNNSeparator(nn.Module):
    """Band-split RNN: the (real, imag) spectrum cut into ``num_bands``
    equal bands (F zero-padded to a multiple), each embedded after a
    LayerNorm; per block a BLSTM over time and one over the bands, each a
    residual under a LayerNorm; a per-band MLP to complex masks."""

    complex_input = True
    output = "complex_mask"

    def __init__(self, input_dim: int, num_spk: int = 2,
                 num_bands: int = 8, feature_dim: int = 32,
                 hidden: int = 64, num_blocks: int = 3):
        super().__init__()
        self.num_spk, self.num_bands = num_spk, num_bands
        self.num_blocks = num_blocks
        W = -(-input_dim // num_bands)
        N = feature_dim
        self.band_norm = layer_norm(2 * W)
        self.band_embed = nn.Linear(2 * W, N)
        for blk in range(num_blocks):
            for axis, norm in (("time", "tnorm"), ("band", "bnorm")):
                self.add_module(f"{norm}{blk}", layer_norm(N))
                self.add_module(f"{axis}_blstm{blk}", BLSTM(N, hidden))
                self.add_module(f"{axis}_proj{blk}", nn.Linear(2 * hidden, N))
        self.dec_norm = layer_norm(N)
        self.dec_hidden = nn.Linear(N, 4 * N)
        self.dec_out = nn.Linear(4 * N, num_spk * W * 2)

    def forward(self, ri):
        real, imag = ri
        B, T, Fq = real.shape
        nb = self.num_bands
        Fp = -(-Fq // nb) * nb
        W = Fp // nb
        x = F.pad(torch.stack([real, imag], dim=-1), (0, 0, 0, Fp - Fq))
        h = self.band_embed(self.band_norm(x.reshape(B, T, nb, W * 2)))
        N = h.shape[-1]
        for blk in range(self.num_blocks):
            z = getattr(self, f"tnorm{blk}")(h).transpose(1, 2)
            z = getattr(self, f"time_proj{blk}")(
                getattr(self, f"time_blstm{blk}")(z.reshape(B * nb, T, N)))
            h = h + z.reshape(B, nb, T, N).transpose(1, 2)
            z = getattr(self, f"bnorm{blk}")(h).reshape(B * T, nb, N)
            z = getattr(self, f"band_proj{blk}")(
                getattr(self, f"band_blstm{blk}")(z))
            h = h + z.reshape(B, T, nb, N)
        m = torch.tanh(self.dec_hidden(self.dec_norm(h)))
        m = self.dec_out(m).reshape(B, T, nb, self.num_spk, W, 2)
        m = m.transpose(2, 3).reshape(B, T, self.num_spk, Fp, 2)[:, :, :,
                                                                  :Fq]
        return [(m[:, :, s, :, 0], m[:, :, s, :, 1])
                for s in range(self.num_spk)]


# ---- DC-CRN, DCCRN ----------------------------------------------------------

def _conv_last(conv: nn.Module, x):
    """A channels-first 2-D convolution on channels-last (B, T, F, C)."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _GLUConvBlock(nn.Module):
    """Two gated 3x3 convolutions over (T, F), each under a LayerNorm,
    the second on the input and the first's output (a dense link)."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.c1 = SameConv2d(in_channels, channels, (3, 3))
        self.g1 = SameConv2d(in_channels, channels, (3, 3))
        self.n1 = layer_norm(channels)
        self.c2 = SameConv2d(in_channels + channels, channels, (3, 3))
        self.g2 = SameConv2d(in_channels + channels, channels, (3, 3))
        self.n2 = layer_norm(channels)

    def forward(self, x):
        h1 = self.n1(_conv_last(self.c1, x)
                     * torch.sigmoid(_conv_last(self.g1, x)))
        cat = torch.cat([x, h1], dim=-1)
        return self.n2(_conv_last(self.c2, cat)
                       * torch.sigmoid(_conv_last(self.g2, cat)))


class DC_CRNSeparator(nn.Module):
    """DC-CRN: a U-net over (T, F) of gated conv blocks, each followed by
    a (1, 3) convolution at stride 2 over F (F zero-padded to a multiple
    of 2^L); a BLSTM bottleneck over frames; (1, 3) transposed
    convolutions at stride 2 and gated blocks over the skips back up; a
    1x1 convolution to complex masks."""

    complex_input = True
    output = "complex_mask"

    def __init__(self, input_dim: int, num_spk: int = 2,
                 enc_channels: Sequence[int] = (8, 16, 32),
                 hidden: int = 64):
        super().__init__()
        self.num_spk = num_spk
        chans = list(enc_channels)
        L = len(chans)
        self.n_levels = L
        Fb = -(-input_dim // 2 ** L)
        for i, ch in enumerate(chans):
            self.add_module(f"enc{i}", _GLUConvBlock(
                2 if i == 0 else chans[i - 1], ch))
            self.add_module(f"down{i}", SameConv2d(ch, ch, (1, 3),
                                                   stride=(1, 2)))
        self.bottleneck = BLSTM(Fb * chans[-1], hidden)
        self.bottleneck_proj = nn.Linear(2 * hidden, Fb * chans[-1])
        for i, ch in enumerate(chans):
            self.add_module(f"up{i}", SameConvTranspose2d(
                chans[min(i + 1, L - 1)], ch, (1, 3), (1, 2)))
            self.add_module(f"dec{i}", _GLUConvBlock(2 * ch, ch))
        self.mask_out = SameConv2d(chans[0], 2 * num_spk, (1, 1))

    def forward(self, ri):
        real, imag = ri
        B, T, Fq = real.shape
        L = self.n_levels
        Fp = -(-Fq // 2 ** L) * 2 ** L
        h = F.pad(torch.stack([real, imag], dim=-1), (0, 0, 0, Fp - Fq))
        skips = []
        for i in range(L):
            h = getattr(self, f"enc{i}")(h)
            skips.append(h)
            h = _conv_last(getattr(self, f"down{i}"), h)
        _, _, Fb, Cb = h.shape
        z = self.bottleneck_proj(self.bottleneck(h.reshape(B, T, Fb * Cb)))
        h = z.reshape(B, T, Fb, Cb)
        for i in reversed(range(L)):
            h = _conv_last(getattr(self, f"up{i}"), h)
            h = h[:, :, :skips[i].shape[2]]
            h = getattr(self, f"dec{i}")(torch.cat([h, skips[i]], dim=-1))
        m = _conv_last(self.mask_out, h)[:, :, :Fq]
        m = m.reshape(B, T, Fq, self.num_spk, 2)
        return [(m[..., s, 0], m[..., s, 1]) for s in range(self.num_spk)]


class DCCRNSeparator(nn.Module):
    """DCCRN: complex (2, 5) convolutions at stride 2 over F (two real
    ones under the complex product rule), each with a LayerNorm and a
    PReLU per part; a complex LSTM over frames (two real LSTMs, the
    product rule again) and a Linear; complex transposed convolutions
    over the skips back up; polar masks |m| = tanh(|z|) (masking mode
    'E'). flax names the two LSTM cells ``OptimizedLSTMCell_0`` (real)
    and ``_1`` (imaginary), and the PReLUs real-then-imaginary per level,
    the encoder's first."""

    complex_input = True
    output = "complex_mask"

    def __init__(self, input_dim: int, num_spk: int = 2,
                 enc_channels: Sequence[int] = (16, 32, 64),
                 hidden: int = 128):
        super().__init__()
        self.num_spk = num_spk
        chans = list(enc_channels)
        L = len(chans)
        self.n_levels = L
        Fb = -(-input_dim // 2 ** L)
        n_prelu = 0
        for i, ch in enumerate(chans):
            for part in ("re", "im"):
                self.add_module(f"enc{i}_{part}", SameConv2d(
                    1 if i == 0 else chans[i - 1], ch, (2, 5), stride=(1, 2)))
            for part in ("nr", "ni"):
                self.add_module(f"enc_{part}{i}", layer_norm(ch))
            for _ in range(2):
                self.add_module(f"PReLU_{n_prelu}", PReLU())
                n_prelu += 1
        self.OptimizedLSTMCell_0 = LSTMCell(Fb * chans[-1], hidden)
        self.OptimizedLSTMCell_1 = LSTMCell(Fb * chans[-1], hidden)
        self.bottleneck_proj = nn.Linear(hidden, Fb * chans[-1])
        for i in reversed(range(L)):
            out = chans[i - 1] if i else num_spk
            for part in ("re", "im"):
                self.add_module(f"dec{i}_{part}", SameConvTranspose2d(
                    2 * chans[i], out, (2, 5), (1, 2)))
            if i:
                for part in ("nr", "ni"):
                    self.add_module(f"dec_{part}{i}", layer_norm(out))
                for _ in range(2):
                    self.add_module(f"PReLU_{n_prelu}", PReLU())
                    n_prelu += 1

    def _complex(self, name: str, hr, hi):
        cr, ci = getattr(self, f"{name}_re"), getattr(self, f"{name}_im")
        return (_conv_last(cr, hr) - _conv_last(ci, hi),
                _conv_last(cr, hi) + _conv_last(ci, hr))

    def forward(self, ri):
        real, imag = ri
        B, T, Fq = real.shape
        L = self.n_levels
        Fp = -(-Fq // 2 ** L) * 2 ** L
        hr = F.pad(real, (0, Fp - Fq))[..., None]
        hi = F.pad(imag, (0, Fp - Fq))[..., None]
        skips, n_prelu = [], 0
        for i in range(L):
            hr, hi = self._complex(f"enc{i}", hr, hi)
            hr = getattr(self, f"PReLU_{n_prelu}")(
                getattr(self, f"enc_nr{i}")(hr))
            hi = getattr(self, f"PReLU_{n_prelu + 1}")(
                getattr(self, f"enc_ni{i}")(hi))
            n_prelu += 2
            skips.append((hr, hi))
        _, _, Fb, Cb = hr.shape
        zr, zi = hr.reshape(B, T, Fb * Cb), hi.reshape(B, T, Fb * Cb)
        rnn_r, rnn_i = self.OptimizedLSTMCell_0, self.OptimizedLSTMCell_1
        yr = lstm_scan(rnn_r, zr)[0] - lstm_scan(rnn_i, zi)[0]
        yi = lstm_scan(rnn_r, zi)[0] + lstm_scan(rnn_i, zr)[0]
        hr = self.bottleneck_proj(yr).reshape(B, T, Fb, Cb)
        hi = self.bottleneck_proj(yi).reshape(B, T, Fb, Cb)
        for i in reversed(range(L)):
            sr, si = skips[i]
            hr, hi = self._complex(f"dec{i}", torch.cat([hr, sr], dim=-1),
                                   torch.cat([hi, si], dim=-1))
            if i:
                hr = getattr(self, f"PReLU_{n_prelu}")(
                    getattr(self, f"dec_nr{i}")(hr))
                hi = getattr(self, f"PReLU_{n_prelu + 1}")(
                    getattr(self, f"dec_ni{i}")(hi))
                n_prelu += 2
        hr, hi = hr[:, :, :Fq], hi[:, :, :Fq]
        mag = torch.sqrt(hr * hr + hi * hi + 1e-8)
        scale = torch.tanh(mag) / mag
        return [(hr[..., s] * scale[..., s], hi[..., s] * scale[..., s])
                for s in range(self.num_spk)]


# ---- Transformer, Conformer ----------------------------------------------

class TransformerSeparator(nn.Module):
    """The Transformer encoder with a linear input over every frame (no
    padding mask), then per speaker a Linear and the mask nonlinearity."""

    def __init__(self, input_dim: int, num_spk: int = 2, adim: int = 128,
                 aheads: int = 4, layers: int = 2, linear_units: int = 512,
                 nonlinear: str = "relu", dropout_rate: float = 0.0):
        super().__init__()
        self.enc = TransformerEncoder(
            input_dim, output_size=adim, attention_heads=aheads,
            linear_units=linear_units, num_blocks=layers,
            dropout_rate=dropout_rate,
            positional_dropout_rate=dropout_rate, input_layer="linear")
        _mask_heads(self, adim, input_dim, num_spk, nonlinear)

    def forward(self, x):
        B, T, _ = x.shape
        h, _ = self.enc(x, torch.full((B,), T, device=x.device))
        return _apply_mask_heads(self, h)


class ConformerSeparator(nn.Module):
    """The Conformer encoder with a linear input over every frame (no
    padding mask: each row of a padded batch attends all its frames, as
    in the JAX package), then per speaker a Linear and the mask
    nonlinearity. Its rel-pos self-attention runs the fused attention
    kernel and, in training, its backward kernel."""

    def __init__(self, input_dim: int, num_spk: int = 2, adim: int = 128,
                 aheads: int = 4, layers: int = 2, linear_units: int = 512,
                 cnn_module_kernel: int = 15, nonlinear: str = "relu",
                 dropout_rate: float = 0.0):
        super().__init__()
        self.enc = ConformerEncoder(
            input_dim, output_size=adim, attention_heads=aheads,
            linear_units=linear_units, num_blocks=layers,
            cnn_module_kernel=cnn_module_kernel, dropout_rate=dropout_rate,
            positional_dropout_rate=dropout_rate, input_layer="linear")
        _mask_heads(self, adim, input_dim, num_spk, nonlinear)

    def forward(self, x):
        B, T, _ = x.shape
        h, _ = self.enc(x, torch.full((B,), T, device=x.device))
        return _apply_mask_heads(self, h)


# ---- clustering: DPCL, DAN, DPCL-E2E ------------------------------------

def _sq_dist(emb, centers):
    """emb (B, N, D), centers (B, K, D) -> squared distances (B, N, K),
    |e|^2 - 2 e.c + |c|^2 as in the JAX package."""
    e2 = (emb * emb).sum(-1)[..., None]
    c2 = (centers * centers).sum(-1)[:, None]
    return e2 - 2.0 * emb @ centers.transpose(1, 2) + c2


def lloyd_step(emb, centers):
    """One Lloyd step of k-means over (B, N, D) from ``centers`` (B, K, D)
    -> (the bins' squared distances (B, N, K) to ``centers``, the means
    of the bins nearest each center). Ties go to the lower cluster, as
    argmin's first."""
    dist = _sq_dist(emb, centers)
    oh = F.one_hot(dist.argmin(-1), centers.shape[1]).to(emb.dtype)
    return dist, (oh.transpose(1, 2) @ emb) / (oh.sum(1)[:, :, None] + 1e-8)


def kmeans_tf_bins(emb, n_clusters: int, n_iter: int = 10):
    """Batched k-means of T-F bin embeddings (B, N, D): the first
    ``n_clusters`` bins as centers, ``n_iter`` Lloyd steps (a fixed
    number, as the JAX package's scan) -> (labels (B, N), centers
    (B, K, D))."""
    centers = emb[:, :n_clusters]
    for _ in range(n_iter):
        centers = lloyd_step(emb, centers)[1]
    return _sq_dist(emb, centers).argmin(-1), centers


def _ideal_assignment(refs_mag, dtype):
    """One-hot (B, N, S) of each bin's loudest reference."""
    stacked = torch.stack(list(refs_mag), dim=-1)        # (B, T, F, S)
    B, T, Fq, S = stacked.shape
    return F.one_hot(stacked.argmax(-1).reshape(B, T * Fq), S).to(dtype)


def dpcl_loss(emb, refs_mag):
    """The deep-clustering affinity loss per utterance, ||E^T E||_F^2 +
    ||Y^T Y||_F^2 - 2 ||E^T Y||_F^2 through the D x D and S x S Gram
    matrices, over N^2 (N = T F bins); Y the bins' ideal assignment."""
    B, T, Fq, D = emb.shape
    E = emb.reshape(B, T * Fq, D)
    Y = _ideal_assignment(refs_mag, emb.dtype)
    EtE = E.transpose(1, 2) @ E
    YtY = Y.transpose(1, 2) @ Y
    EtY = E.transpose(1, 2) @ Y
    return ((EtE ** 2).sum((1, 2)) + (YtY ** 2).sum((1, 2))
            - 2.0 * (EtY ** 2).sum((1, 2))) / float((T * Fq) ** 2)


class DPCLSeparator(nn.Module):
    """Deep clustering: stacked BLSTMs, a Linear to a ``emb_D``-dim
    embedding of every T-F bin and its nonlinearity -> (B, T, F, D).
    The model clusters it by k-means into binary masks, and trains it
    with ``dpcl_loss``."""

    output = "dpcl"

    def __init__(self, input_dim: int, num_spk: int = 2, layers: int = 2,
                 unit: int = 256, emb_D: int = 20, nonlinear: str = "tanh",
                 dropout_rate: float = 0.0):
        super().__init__()
        self.input_dim, self.emb_D = input_dim, emb_D
        self.layers, self.nonlinear = layers, nonlinear
        _blstm_stack(self, input_dim, layers, unit)
        self.dropout = nn.Dropout(dropout_rate)
        self.embed = nn.Linear(2 * unit, input_dim * emb_D)

    def forward(self, x):
        h = x
        for i in range(self.layers):
            h = self.dropout(getattr(self, f"blstm{i}")(h))
        e = NONLINEAR[self.nonlinear](self.embed(h))
        B, T, _ = e.shape
        return e.reshape(B, T, self.input_dim, self.emb_D)


class DANSeparator(nn.Module):
    """Deep attractor network: DPCL's embedding of every bin; attractors
    are the means of the bins that each reference dominates (training,
    ``refs_mag`` given) or k-means centers (inference); masks are the
    softmax over speakers of the embedding's products with them."""

    needs_ref_spectra = True

    def __init__(self, input_dim: int, num_spk: int = 2, layers: int = 2,
                 unit: int = 256, emb_D: int = 40, nonlinear: str = "tanh",
                 dropout_rate: float = 0.0):
        super().__init__()
        self.num_spk, self.emb_D = num_spk, emb_D
        self.layers, self.nonlinear = layers, nonlinear
        _blstm_stack(self, input_dim, layers, unit)
        self.dropout = nn.Dropout(dropout_rate)
        self.embed = nn.Linear(2 * unit, input_dim * emb_D)

    def forward(self, x, refs_mag=None):
        B, T, Fq = x.shape
        h = x
        for i in range(self.layers):
            h = self.dropout(getattr(self, f"blstm{i}")(h))
        emb = NONLINEAR[self.nonlinear](self.embed(h)).reshape(
            B, T * Fq, self.emb_D)
        if refs_mag is not None:
            oh = _ideal_assignment(refs_mag, emb.dtype)      # (B, N, S)
            attractor = (emb.transpose(1, 2) @ oh) / (
                oh.sum(1)[:, None] + 1e-8)                   # (B, D, S)
        else:
            attractor = kmeans_tf_bins(emb, self.num_spk)[1].transpose(1, 2)
        masks = torch.softmax(emb @ attractor, dim=-1).reshape(
            B, T, Fq, self.num_spk)
        return [masks[..., s] for s in range(self.num_spk)]


class DPCLE2ESeparator(nn.Module):
    """DPCL++ end to end: DPCL's embedding, ``n_iter`` steps of soft
    k-means (responsibilities softmax(-alpha d)), soft masks, a BLSTM
    over the masked magnitudes and the mixture, and a softmax over
    speakers of its Linear: trained with the signal-level PIT loss."""

    def __init__(self, input_dim: int, num_spk: int = 2, layers: int = 2,
                 unit: int = 256, emb_D: int = 20, alpha: float = 5.0,
                 n_iter: int = 10, nonlinear: str = "tanh"):
        super().__init__()
        self.num_spk, self.emb_D = num_spk, emb_D
        self.layers, self.nonlinear = layers, nonlinear
        self.alpha, self.n_iter = alpha, n_iter
        _blstm_stack(self, input_dim, layers, unit)
        self.emb = nn.Linear(2 * unit, input_dim * emb_D)
        self.enh_blstm = BLSTM(input_dim * (num_spk + 1), unit)
        self.enh_out = nn.Linear(2 * unit, input_dim * num_spk)

    def forward(self, x):
        B, T, Fq = x.shape
        S = self.num_spk
        h = x
        for i in range(self.layers):
            h = getattr(self, f"blstm{i}")(h)
        V = NONLINEAR[self.nonlinear](self.emb(h)).reshape(B, T * Fq,
                                                            self.emb_D)
        centers = V[:, :S]
        for _ in range(self.n_iter):
            gamma = torch.softmax(-self.alpha * _sq_dist(V, centers), -1)
            centers = (gamma.transpose(1, 2) @ V) / (
                gamma.sum(1)[..., None] + 1e-8)
        gamma = torch.softmax(-self.alpha * _sq_dist(V, centers), -1)
        soft = gamma.reshape(B, T, Fq, S)
        z = self.enh_blstm(torch.cat([x * soft[..., s] for s in range(S)]
                                     + [x], dim=-1))
        m = torch.softmax(self.enh_out(z).reshape(B, T, Fq, S), dim=-1)
        return [m[..., s] for s in range(S)]


def _not_ported(name: str, **kwargs):
    raise NotImplementedError(
        f"separator {name!r} is not ported yet (ROADMAP A.4)")


# the JAX package's registry, in its order
SEPARATORS = {
    "rnn": RNNSeparator, "tcn": TCNSeparator, "dprnn": DPRNNSeparator,
    "tfgridnet": TFGridNetSeparator, "bsrnn": BSRNNSeparator,
    "dptnet": DPTNetSeparator, "skim": SkiMSeparator,
    "dc_crn": DC_CRNSeparator, "transformer": TransformerSeparator,
    "conformer": ConformerSeparator, "dpcl": DPCLSeparator,
    "dan": DANSeparator, "dccrn": DCCRNSeparator,
    "dpcl_e2e": DPCLE2ESeparator}
SEPARATORS.update({
    name: functools.partial(_not_ported, name) for name in (
        "svoice", "fasnet", "uses", "tfgridnetv2", "tfgridnetv3", "ineube",
        "uses2", "neural_beamformer", "asteroid")})
