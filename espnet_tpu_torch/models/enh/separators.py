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

Time-domain (``time_domain``: the raw (B, S) or (B, S, C) wave in,
waves out): ``svoice`` (a strided conv encoder, dual-path MulCat blocks,
the last block decoded by overlap-add: the JAX package's single-loss
variant), ``fasnet`` (FaSNet-TAC's filter-and-sum) and
``neural_beamformer`` (mask-based MVDR, ``beamformer.py``). Multichannel
(``multichannel_input``: the (B, T, F, C) spectrum of every channel):
``uses2`` (USES with TAC and cross-channel attention in its first
blocks), ``tfgridnetv2`` / ``tfgridnetv3`` (one projection for every
head's Q, K and V; V3's norms over the channel axis only) and ``ineube``
(DNN1, the multi-frame multichannel Wiener filter ``mfmcwf``, DNN2).
``uses`` is single-channel. Every overlap-add is F.fold and every frame
cut a ``Tensor.unfold`` view: no index scatter-add on the card.
``asteroid`` raises, naming the missing package, as the JAX package's
stub does.
"""

from __future__ import annotations

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
    would hold a scale per (F, C). ``dims`` names other axes: (-3, -1) is
    TF-GridNetV2's per-head norm over (F, E) of (B, T, F, H, E)."""

    def __init__(self, channels: int, dims=(-2, -1)):
        super().__init__(channels, eps=FLAX_LN_EPS)
        self.dims = tuple(dims)

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=self.dims, unbiased=False,
                                   keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


def lstm_scans(cells, xs, reverse=None, carry=None):
    """LSTM cells, cell k over the frames of its own (B, T, D) input
    ``xs[k]`` from ``carry`` ((K, B, H) c and h, zeros by default),
    forward or backward as ``reverse`` says (all forward by default), in
    lockstep: each frame is one batched step of all of them (LSTMCell's
    stacked form), not one step a cell. -> ((K, B, T, H) outputs in frame
    order, the last carry). The input projections are formed once and
    unbound (a slice per frame would cost its backward a zero-filled copy
    of all frames' gradient each frame), and the hidden kernels are
    stacked once."""
    reverse = reverse or (False,) * len(cells)
    wt = torch.stack([c.hidden_kernel() for c in cells])
    proj = torch.stack([c.input_proj(x).flip(1) if r else c.input_proj(x)
                        for c, x, r in zip(cells, xs, reverse)])
    K, B, T, _ = proj.shape                                # (K, B, T, 4H)
    c, h = carry if carry is not None else (proj.new_zeros(
        K, B, wt.shape[1]),) * 2
    out = [None] * T
    for t, p in enumerate(proj.unbind(2)):
        c, h = cells[0]((c, h), p, wt)
        out[t] = h
    out = torch.stack(out, dim=2)
    return torch.stack([o.flip(1) if r else o
                        for o, r in zip(out.unbind(0), reverse)]), (c, h)


class BLSTM(nn.Module):
    """One bidirectional LSTM layer over every frame: (B, T, D) -> (B, T,
    2H). The backward direction runs over the padding too, as the JAX
    package's ``nn.RNN(reverse=True, keep_order=True)`` without lengths
    does. Cell 0 runs forward, cell 1 backward, in lockstep."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.OptimizedLSTMCell_0 = LSTMCell(input_size, hidden)
        self.OptimizedLSTMCell_1 = LSTMCell(input_size, hidden)

    def cells(self):
        return [self.OptimizedLSTMCell_0, self.OptimizedLSTMCell_1]

    def forward(self, x):
        out, _ = lstm_scans(self.cells(), (x, x), (False, True))
        return torch.cat(out.unbind(0), dim=-1)


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
        carry, mem = None, ((zeros, zeros), (zeros, zeros))
        outs = []
        for j in range(S):
            out, (c_k, h_k) = lstm_scans([cell], [seg[:, j]], carry=carry)
            outs.append(out[0])
            if self.mem_type == "hc":
                mem_h = self.mem_h(mem[0], self.mem_h.input_proj(h_k[0]))
                mem_c = self.mem_c(mem[1], self.mem_c.input_proj(c_k[0]))
                mem = (mem_h, mem_c)
                carry = (mem_c[1][None], mem_h[1][None])
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
        rr, ii, ri, ir = lstm_scans([rnn_r, rnn_i, rnn_r, rnn_i],
                                    [zr, zi, zi, zr])[0]
        yr, yi = rr - ii, ri + ir
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


# ---- time domain: SVoice, FaSNet ------------------------------------------

def overlap_add(frames, hop: int):
    """(..., T, W) frames -> (..., (T - 1) hop + W), frame t added in at
    t hop: F.fold, no index scatter-add."""
    *lead, T, W = frames.shape
    out = F.fold(frames.reshape(-1, T, W).transpose(1, 2),
                 (1, (T - 1) * hop + W), (1, W), stride=(1, hop))
    return out.reshape(*lead, -1)


def _lag_windows(frames, width: int):
    """(..., N) -> (..., N - width + 1, width): window k holds samples k,
    ..., k + width - 1 (a ``Tensor.unfold`` view)."""
    return frames.unfold(-1, width, 1)


class _MulCatLayer(nn.Module):
    """SVoice's MulCat block: two BLSTMs (``rnn``, ``gate``) whose outputs
    multiply, concatenated with the input and projected back; their four
    directions step in lockstep."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.rnn = BLSTM(dim, hidden)
        self.gate = BLSTM(dim, hidden)
        self.proj = nn.Linear(2 * hidden + dim, dim)

    def forward(self, x):
        fr, br, fg, bg = lstm_scans(self.rnn.cells() + self.gate.cells(),
                                    (x,) * 4, (False, True, False, True))[0]
        a, g = torch.cat([fr, br], dim=-1), torch.cat([fg, bg], dim=-1)
        return self.proj(torch.cat([a * g, x], dim=-1))


class SVoiceSeparator(nn.Module):
    """SVoice: a VALID strided conv encoder (stride K / 2, the wave
    right-padded to cover every sample) and its ReLU; dual-path MulCat
    blocks over 50%-overlapped chunks, each a residual under a LayerNorm;
    PReLU and a Linear to every speaker's representation; the chunks
    merged; each frame's representation averaged in groups of K into
    D / K samples and the frames added back at hop K / 2 (F.fold). The
    last block decodes (the JAX package's single-loss variant)."""

    time_domain = True

    def __init__(self, input_dim: int = 0, num_spk: int = 2,
                 enc_dim: int = 128, kernel_size: int = 8, hidden: int = 64,
                 num_layers: int = 2, segment_size: int = 20):
        super().__init__()
        self.num_spk, self.num_layers = num_spk, num_layers
        self.kernel_size, self.segment_size = kernel_size, segment_size
        D = enc_dim
        self.encoder = nn.Conv1d(1, D, kernel_size, stride=kernel_size // 2,
                                 bias=False)
        for blk in range(num_layers):
            for path, norm in (("intra", "norm_i"), ("inter", "norm_o")):
                self.add_module(f"{path}{blk}", _MulCatLayer(D, hidden))
                self.add_module(f"{norm}{blk}", layer_norm(D))
        self.PReLU_0 = PReLU()
        self.spk_out = nn.Linear(D, num_spk * D)

    def forward(self, speech_mix, speech_lengths=None):
        x = speech_mix[..., 0] if speech_mix.dim() == 3 else speech_mix
        B, S = x.shape
        K, hop = self.kernel_size, self.kernel_size // 2
        T = max(-(-max(S - K, 0) // hop) + 1, 1)
        w = F.relu(self.encoder(F.pad(x, (0, (T - 1) * hop + K - S))[:, None]
                                )).transpose(1, 2)            # (B, T, N)
        h, _ = _segment(w, self.segment_size)
        _, n, Kc, D = h.shape
        for blk in range(self.num_layers):
            intra = getattr(self, f"intra{blk}")(h.reshape(B * n, Kc, D))
            h = getattr(self, f"norm_i{blk}")(h + intra.reshape(B, n, Kc, D))
            inter = getattr(self, f"inter{blk}")(
                h.transpose(1, 2).reshape(B * Kc, n, D))
            h = getattr(self, f"norm_o{blk}")(
                h + inter.reshape(B, Kc, n, D).transpose(1, 2))
        h = _merge(self.spk_out(self.PReLU_0(h)), T)     # (B, T, S' * D)
        frames = h.reshape(B, T, self.num_spk, D // K, K).mean(-1)
        est = overlap_add(frames.transpose(1, 2), K // 2)  # (B, S', len)
        est = F.pad(est, (0, max(0, S - est.shape[-1])))
        return [est[:, s, :S] for s in range(self.num_spk)]


class _TAC(nn.Module):
    """Transform-average-concatenate across microphones on (B, C, ..., D):
    ``transform`` and a PReLU per channel, their channel mean through
    ``average`` and a PReLU, both concatenated, ``concat_proj``, plus the
    input."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.transform = nn.Linear(dim, hidden)
        self.PReLU_0 = PReLU()
        self.average = nn.Linear(hidden, hidden)
        self.PReLU_1 = PReLU()
        self.concat_proj = nn.Linear(2 * hidden, dim)

    def forward(self, x):
        h = self.PReLU_0(self.transform(x))
        avg = self.PReLU_1(self.average(h.mean(dim=1, keepdim=True)))
        return x + self.concat_proj(torch.cat([h, avg.expand_as(h)], dim=-1))


class FaSNetSeparator(nn.Module):
    """FaSNet-TAC: the (B, S) or (B, S, C) wave framed at 50% overlap, each
    frame with ``context`` samples either side; per frame and channel a
    learned encoding of the context frame under a LayerNorm, and the
    cosine of every channel's context at each of the 2 context + 1 lags
    against channel 0's centre frame (+1e-8 inside each square root);
    dual-path BLSTMs with TAC across channels; a gated (tanh x sigmoid)
    head to a filter of 2 context + 1 taps per speaker; filter-and-sum,
    the frames added back (F.fold), the pads cut, the mean over channels.
    Every frame cut is a ``Tensor.unfold`` view."""

    time_domain = True

    def __init__(self, input_dim: int = 0, num_spk: int = 2,
                 enc_dim: int = 64, feature_dim: int = 64, hidden: int = 64,
                 num_layers: int = 2, segment_size: int = 24,
                 window_ms: int = 4, context_ms: int = 4, sr: int = 16000):
        super().__init__()
        self.num_spk, self.num_layers = num_spk, num_layers
        self.segment_size = segment_size
        self.win = max(int(sr * window_ms / 1000), 2)
        self.ctx = int(sr * context_ms / 1000)
        n_lag = 2 * self.ctx + 1
        D = feature_dim
        self.encoder = nn.Linear(2 * self.ctx + self.win, enc_dim, bias=False)
        self.enc_norm = layer_norm(enc_dim)
        self.bottleneck = nn.Linear(enc_dim + n_lag, D)
        for blk in range(num_layers):
            for path, norm in (("intra", "norm_i"), ("inter", "norm_o")):
                self.add_module(f"{path}{blk}", BLSTM(D, hidden))
                self.add_module(f"{path}_proj{blk}", nn.Linear(2 * hidden, D))
                self.add_module(f"{norm}{blk}", layer_norm(D))
            self.add_module(f"tac{blk}", _TAC(D, hidden))
        self.filt_t = nn.Linear(D, num_spk * n_lag)
        self.filt_g = nn.Linear(D, num_spk * n_lag)

    def forward(self, speech_mix, speech_lengths=None):
        x = speech_mix[..., None] if speech_mix.dim() == 2 else speech_mix
        x = x.transpose(1, 2)                                # (B, C, S)
        B, C, S = x.shape
        win, ctx = self.win, self.ctx
        hop, n_lag = win // 2, 2 * ctx + 1
        rest = (win - (hop + S % win) % win) % win
        xp = F.pad(x, (hop, rest + hop))
        Sp = xp.shape[-1]
        L = Sp // hop - 1
        ctx_frames = F.pad(xp, (ctx, ctx)).unfold(-1, 2 * ctx + win, hop)
        ref = xp[:, 0].unfold(-1, win, hop)                  # (B, L, win)
        if ctx_frames.shape[2] != L or ref.shape[1] != L:
            raise ValueError(f"FaSNet needs an even window, not {win}")
        enc = self.enc_norm(self.encoder(ctx_frames))        # (B, C, L, N)
        lags = _lag_windows(ctx_frames, win)         # (B, C, L, lag, win)
        num = torch.einsum("bclkw,blw->bclk", lags, ref)
        den = (torch.sqrt((lags ** 2).sum(-1) + 1e-8)
               * torch.sqrt((ref ** 2).sum(-1) + 1e-8)[:, None, :, None])
        h = self.bottleneck(torch.cat([enc, num / den], dim=-1))
        D = h.shape[-1]
        seg, _ = _segment(h.reshape(B * C, L, D), self.segment_size)
        _, n, K, _ = seg.shape
        for blk in range(self.num_layers):
            intra = getattr(self, f"intra_proj{blk}")(getattr(
                self, f"intra{blk}")(seg.reshape(B * C * n, K, D)))
            seg = getattr(self, f"norm_i{blk}")(
                seg + intra.reshape(B * C, n, K, D))
            inter = getattr(self, f"inter_proj{blk}")(getattr(
                self, f"inter{blk}")(seg.transpose(1, 2).reshape(
                    B * C * K, n, D)))
            seg = getattr(self, f"norm_o{blk}")(
                seg + inter.reshape(B * C, K, n, D).transpose(1, 2))
            seg = getattr(self, f"tac{blk}")(
                seg.reshape(B, C, n, K, D)).reshape(B * C, n, K, D)
        h = _merge(seg, L).reshape(B, C, L, D)
        filt = (torch.tanh(self.filt_t(h)) * torch.sigmoid(self.filt_g(h))
                ).reshape(B, C, L, self.num_spk, n_lag)
        taps = _lag_windows(ctx_frames, n_lag)       # (B, C, L, win, lag)
        est = torch.einsum("bclwk,bclsk->bcslw", taps, filt)
        sig = overlap_add(est, hop)[..., hop:hop + S].mean(1)  # (B, S', S)
        return [sig[:, s] for s in range(self.num_spk)]


# ---- USES, USES2 -----------------------------------------------------------

def _add_atf_block(module: nn.Module, blk: int, D: int, heads: int,
                   hidden: int):
    """USES's ATF block ``blk``: a BLSTM over time (memory tokens first),
    projected back and added under a LayerNorm; pre-norm self-attention
    over frequency and a pre-norm ReLU feed-forward, each a residual; a
    LayerNorm."""
    module.add_module(f"time_rnn{blk}", BLSTM(D, hidden))
    module.add_module(f"time_proj{blk}", nn.Linear(2 * hidden, D))
    module.add_module(f"norm_t{blk}", layer_norm(D))
    module.add_module(f"prenorm_f{blk}", layer_norm(D))
    module.add_module(f"freq_att{blk}", SelfAttention(D, heads))
    module.add_module(f"prenorm_ff{blk}", layer_norm(D))
    module.add_module(f"ff1_{blk}", nn.Linear(D, 2 * D))
    module.add_module(f"ff2_{blk}", nn.Linear(2 * D, D))
    module.add_module(f"norm_f{blk}", layer_norm(D))


def _atf_block(module: nn.Module, h, blk: int):
    """(n, T, F, D) -> (n, T, F, D) through ``_add_atf_block``'s modules
    and ``module.memory_tokens`` (M, D)."""
    nb, T, Fq, D = h.shape
    mem = module.memory_tokens
    M = mem.shape[0]
    ht = torch.cat([mem[None, :, None].expand(nb, M, Fq, D), h], dim=1)
    t = getattr(module, f"time_proj{blk}")(getattr(module, f"time_rnn{blk}")(
        ht.transpose(1, 2).reshape(nb * Fq, T + M, D)))
    ht = getattr(module, f"norm_t{blk}")(
        ht + t.reshape(nb, Fq, T + M, D).transpose(1, 2))
    f = ht[:, M:].reshape(nb * T, Fq, D)
    f = f + getattr(module, f"freq_att{blk}")(
        getattr(module, f"prenorm_f{blk}")(f))
    z = getattr(module, f"prenorm_ff{blk}")(f)
    f = f + getattr(module, f"ff2_{blk}")(F.relu(getattr(
        module, f"ff1_{blk}")(z)))
    return getattr(module, f"norm_f{blk}")(f).reshape(nb, T, Fq, D)


class USESSeparator(nn.Module):
    """USES: the (real, imag) planes through a 3x3 conv and a Linear
    bottleneck; ATF blocks with ``memory_tokens`` joining the time axis
    (every bin sees them); a 3x3 conv to complex masks."""

    complex_input = True
    output = "complex_mask"

    def __init__(self, input_dim: int, num_spk: int = 2,
                 enc_channels: int = 32, bottleneck: int = 64,
                 num_blocks: int = 2, heads: int = 4, hidden: int = 64,
                 memory_size: int = 4):
        super().__init__()
        self.num_spk, self.num_blocks = num_spk, num_blocks
        D = bottleneck
        self.post_encoder = SameConv2d(2, enc_channels, (3, 3))
        self.bottleneck = nn.Linear(enc_channels, D)
        self.memory_tokens = nn.Parameter(torch.zeros(memory_size, D))
        for blk in range(num_blocks):
            _add_atf_block(self, blk, D, heads, hidden)
        self.mask_out = SameConv2d(D, 2 * num_spk, (3, 3))

    def flax_init_(self, generator):
        self.memory_tokens.normal_(0.0, 0.02, generator=generator)

    def _masks(self, h):
        B, T, Fq, _ = h.shape
        m = _conv_last(self.mask_out, h).reshape(B, T, Fq, self.num_spk, 2)
        return [(m[..., s, 0], m[..., s, 1]) for s in range(self.num_spk)]

    def forward(self, ri):
        h = self.bottleneck(_conv_last(self.post_encoder,
                                       torch.stack(ri, dim=-1)))
        for blk in range(self.num_blocks):
            h = _atf_block(self, h, blk)
        return self._masks(h)


class USES2Separator(USESSeparator):
    """USES2: USES over every channel with shared weights; in the first
    ``num_spatial_blocks`` blocks (with C > 1) each ATF block is followed
    by TAC (``tac_tf``, ReLU, the channel mean concatenated, ReLU,
    ``tac_out`` under ``tac_norm``, a residual) and a pre-norm
    self-attention across channels at each (t, f); after the last of them
    the reference channel goes on. With C = 1 (or no spatial block) the
    channels collapse to the reference before the first block; a stack
    still holding channels at the end keeps channel 0, as the JAX
    package's fold-out does. The spatial modules always exist here: the
    JAX package creates them only where its init saw C > 1 (load such a
    single-channel tree with ``init_param``)."""

    multichannel_input = True

    def __init__(self, input_dim: int, num_spk: int = 2,
                 enc_channels: int = 32, bottleneck: int = 64,
                 num_blocks: int = 2, num_spatial_blocks: int = 1,
                 heads: int = 4, hidden: int = 64, memory_size: int = 4,
                 ref_channel: int = 0):
        super().__init__(input_dim, num_spk, enc_channels, bottleneck,
                         num_blocks, heads, hidden, memory_size)
        self.num_spatial_blocks, self.ref_channel = (num_spatial_blocks,
                                                     ref_channel)
        D = bottleneck
        for blk in range(min(num_spatial_blocks, num_blocks)):
            self.add_module(f"tac_tf{blk}", nn.Linear(D, D))
            self.add_module(f"tac_out{blk}", nn.Linear(2 * D, D))
            self.add_module(f"tac_norm{blk}", layer_norm(D))
            self.add_module(f"ch_norm{blk}", layer_norm(D))
            self.add_module(f"ch_att{blk}", SelfAttention(D, heads))

    def forward(self, ri):
        real, imag = ri
        if real.dim() == 3:
            real, imag = real[..., None], imag[..., None]
        B, T, Fq, C = real.shape
        x = torch.stack([real, imag], dim=-1).permute(0, 3, 1, 2, 4)
        h = self.bottleneck(_conv_last(self.post_encoder,
                                       x.reshape(B * C, T, Fq, 2)))
        D = h.shape[-1]
        ref = self.ref_channel
        for blk in range(self.num_blocks):
            if blk < self.num_spatial_blocks and C > 1:
                hc = _atf_block(self, h, blk).reshape(B, C, T, Fq, D)
                z = F.relu(getattr(self, f"tac_tf{blk}")(hc))
                z = torch.cat([z, z.mean(dim=1, keepdim=True).expand_as(z)],
                              dim=-1)
                hc = hc + getattr(self, f"tac_norm{blk}")(
                    getattr(self, f"tac_out{blk}")(F.relu(z)))
                a = getattr(self, f"ch_att{blk}")(getattr(
                    self, f"ch_norm{blk}")(hc.permute(0, 2, 3, 1, 4).reshape(
                        B * T * Fq, C, D)))
                hc = hc + a.reshape(B, T, Fq, C, D).permute(0, 3, 1, 2, 4)
                h = (hc[:, ref] if blk == self.num_spatial_blocks - 1
                     else hc.reshape(B * C, T, Fq, D))
            else:
                if blk == 0 and C > 1:
                    h = h.reshape(B, C, T, Fq, D)[:, ref]
                h = _atf_block(self, h, blk)
        if h.shape[0] != B:
            h = h.reshape(B, -1, T, Fq, D)[:, 0]
        return self._masks(h)


# ---- TF-GridNetV2 / V3 -----------------------------------------------------

class _GridBlockV2(nn.Module):
    """One TF-GridNetV2 block: a BLSTM over frequency and one over time,
    each a residual after a LayerNorm; the full-band attention over
    frames with every head's Q, K and V from one Linear each (PReLU_0,
    _1, _2 in that order), per-head norms, and ``attnO``, PReLU_3 and a
    norm as the residual. ``norm_freq`` (V2): the block norms over (F, D)
    and the head norms over (F, E) of each head; else (V3) over the
    channel axis only. Each has a scale per channel."""

    def __init__(self, emb_dim: int, hidden: int, attn_heads: int,
                 attn_qk_dim: int, norm_freq: bool):
        super().__init__()
        D, E, Hh = emb_dim, attn_qk_dim, attn_heads
        Dv = D // Hh
        self.heads, self.qk_dim = Hh, E
        norm = TwoAxisLayerNorm if norm_freq else layer_norm
        for axis, name in (("freq", "fnorm"), ("time", "tnorm")):
            self.add_module(name, norm(D))
            self.add_module(f"{axis}_blstm", BLSTM(D, hidden))
            self.add_module(f"{axis}_proj", nn.Linear(2 * hidden, D))
        self.anorm = norm(D)
        for i, (kind, width) in enumerate((("Q", E), ("K", E), ("V", Dv))):
            self.add_module(f"attn{kind}", nn.Linear(D, Hh * width))
            self.add_module(f"PReLU_{i}", PReLU())
            self.add_module(f"attn{kind}n", TwoAxisLayerNorm(width, (-3, -1))
                            if norm_freq else layer_norm(width))
        self.attnO = nn.Linear(D, D)
        self.PReLU_3 = PReLU()
        self.attnOn = norm(D)

    def forward(self, h):
        B, T, Fq, D = h.shape
        Hh, E = self.heads, self.qk_dim
        z = self.freq_proj(self.freq_blstm(self.fnorm(h).reshape(B * T, Fq,
                                                                 D)))
        h = h + z.reshape(B, T, Fq, D)
        z = self.tnorm(h).transpose(1, 2).reshape(B * Fq, T, D)
        z = self.time_proj(self.time_blstm(z))
        h = h + z.reshape(B, Fq, T, D).transpose(1, 2)
        z = self.anorm(h)
        qkv = []
        for i, kind in enumerate("QKV"):
            y = getattr(self, f"PReLU_{i}")(getattr(self, f"attn{kind}")(z))
            y = getattr(self, f"attn{kind}n")(y.reshape(B, T, Fq, Hh, -1))
            qkv.append(y.permute(0, 3, 1, 2, 4).reshape(B * Hh, T, -1))
        o = frame_attention(*qkv, math.sqrt(Fq * E))     # (B H, T, F Dv)
        o = o.reshape(B, Hh, T, Fq, -1).permute(0, 2, 3, 1, 4).reshape(
            B, T, Fq, D)
        return h + self.attnOn(self.PReLU_3(self.attnO(o)))


class TFGridNetV2Separator(nn.Module):
    """TF-GridNetV2: the (real, imag) planes of every mic (2 ``n_imics``
    inputs) embedded per bin, ``num_blocks`` grid blocks, a Linear to the
    speakers' (real, imag) estimates. With ``remat`` each block runs
    under ``torch.utils.checkpoint`` in training (its activations
    recomputed in the backward, as flax's ``nn.remat``)."""

    complex_input = True
    multichannel_input = True
    output = "spectrum"

    def __init__(self, input_dim: int, num_spk: int = 2, n_imics: int = 1,
                 num_blocks: int = 3, emb_dim: int = 32, hidden: int = 64,
                 attn_heads: int = 2, attn_qk_dim: int = 4,
                 norm_freq: bool = True, remat: bool = True):
        super().__init__()
        self.num_spk, self.num_blocks, self.remat = num_spk, num_blocks, remat
        self.embed = nn.Linear(2 * n_imics, emb_dim)
        for blk in range(num_blocks):
            self.add_module(f"block{blk}", _GridBlockV2(
                emb_dim, hidden, attn_heads, attn_qk_dim, norm_freq))
        self.deconv = nn.Linear(emb_dim, 2 * num_spk)

    def forward(self, ri):
        real, imag = ri
        if real.dim() == 3:
            real, imag = real[..., None], imag[..., None]
        B, T, Fq, _ = real.shape
        h = self.embed(torch.cat([real, imag], dim=-1))
        remat = self.remat and self.training and torch.is_grad_enabled()
        for blk in range(self.num_blocks):
            block = getattr(self, f"block{blk}")
            h = (torch.utils.checkpoint.checkpoint(block, h,
                                                   use_reentrant=False)
                 if remat else block(h))
        out = self.deconv(h).reshape(B, T, Fq, self.num_spk, 2)
        return [(out[..., s, 0], out[..., s, 1])
                for s in range(self.num_spk)]


class TFGridNetV3Separator(TFGridNetV2Separator):
    """TF-GridNetV3: V2 with every norm over the channel axis alone, so one
    parameter set holds at any number of frequency bins."""

    def __init__(self, input_dim: int, *args, norm_freq: bool = False,
                 **kwargs):
        super().__init__(input_dim, *args, norm_freq=norm_freq, **kwargs)


# ---- iNeuBe ----------------------------------------------------------------

class _DenseConvStack(nn.Module):
    """iNeuBe's DNN: ``layers`` SAME convolutions over (T, F), each on the
    concatenation of the input and every earlier output, under a
    LayerNorm and an ELU; a 1x1 convolution of all of them."""

    def __init__(self, in_channels: int, out_channels: int, hidden: int = 24,
                 layers: int = 4, kernel=(3, 3)):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"conv{i}", SameConv2d(in_channels + i * hidden,
                                                   hidden, tuple(kernel)))
            self.add_module(f"ln{i}", layer_norm(hidden))
        self.proj = SameConv2d(in_channels + layers * hidden, out_channels,
                               (1, 1))

    def forward(self, x):
        feats = [x]
        for i in range(self.layers):
            h = _conv_last(getattr(self, f"conv{i}"), torch.cat(feats, dim=-1))
            feats.append(F.elu(getattr(self, f"ln{i}")(h)))
        return _conv_last(self.proj, torch.cat(feats, dim=-1))


def mfmcwf_system(real, imag, er, ei, n_chunks: int = 3,
                  tik_eps: float = 1e-6):
    """``mfmcwf``'s system: the mics at ``2 n_chunks + 1`` frame shifts
    (``torch.roll``: the shifts wrap around in time, as the JAX package's
    ``jnp.roll``) y = (yr, yi) (B, T, F, N), R = sum_t y y^H with
    Tikhonov loading eps (1 + tr(Re R) / N), p = sum_t y s^* -> (the real
    2N x 2N block matrix [[Rr, -Ri], [Ri, Rr]] (B, F, 2N, 2N), [pr; pi]
    (B, F, 2N), yr, yi)."""
    y = torch.stack([real, imag], dim=-1)
    y = torch.cat([torch.roll(y, s, dims=1)
                   for s in range(-n_chunks, n_chunks + 1)], dim=3)
    yr, yi = y[..., 0], y[..., 1]                         # (B, T, F, N)
    N = yr.shape[-1]

    def corr(a, b):
        return torch.einsum("btfn,btfm->bfnm", a, b)

    Rr, Ri = corr(yr, yr) + corr(yi, yi), corr(yi, yr) - corr(yr, yi)
    pr = (torch.einsum("btfn,btf->bfn", yr, er)
          + torch.einsum("btfn,btf->bfn", yi, ei))
    pi = (torch.einsum("btfn,btf->bfn", yi, er)
          - torch.einsum("btfn,btf->bfn", yr, ei))
    load = tik_eps + tik_eps * torch.diagonal(Rr, dim1=-2, dim2=-1).sum(
        -1)[..., None, None] / N
    eye = torch.eye(N, dtype=real.dtype, device=real.device) * load
    A = torch.cat([torch.cat([Rr + eye, -Ri], dim=-1),
                   torch.cat([Ri, Rr + eye], dim=-1)], dim=-2)
    return A, torch.cat([pr, pi], dim=-1), yr, yi


def mfmcwf(real, imag, er, ei, n_chunks: int = 3, tik_eps: float = 1e-6):
    """The multi-frame multichannel Wiener filter toward (er, ei) (B, T, F)
    from the mixture (B, T, F, C): w from ``mfmcwf_system`` per (batch,
    bin), solved in its real block form; -> the estimate w^H y (real,
    imag)."""
    A, p, yr, yi = mfmcwf_system(real, imag, er, ei, n_chunks, tik_eps)
    N = yr.shape[-1]
    w = torch.linalg.solve(A, p[..., None])[..., 0]
    wr, wi = w[..., :N], w[..., N:]
    sr = (torch.einsum("bfn,btfn->btf", wr, yr)
          + torch.einsum("bfn,btfn->btf", wi, yi))
    si = (torch.einsum("bfn,btfn->btf", wr, yi)
          - torch.einsum("bfn,btfn->btf", wi, yr))
    return sr, si


class INeuBeSeparator(nn.Module):
    """iNeuBe: DNN1 (``dnn1``) estimates each speaker's (real, imag) from
    the mixture's 2 ``mic_channels`` planes; ``mfmcwf`` beamforms toward
    it; per speaker DNN2 (``dnn2_{s}``) refines from the mixture, DNN1's
    and the filter's estimates. ``output_from`` picks the stage: dnn1,
    mfmcwf, or dnn2 (any other value, as in the JAX package)."""

    complex_input = True
    multichannel_input = True
    output = "spectrum"

    def __init__(self, input_dim: int, num_spk: int = 1,
                 mic_channels: int = 1, hidden: int = 24, layers: int = 4,
                 n_chunks: int = 3, tik_eps: float = 1e-6,
                 output_from: str = "dnn2"):
        super().__init__()
        self.num_spk, self.n_chunks, self.tik_eps = num_spk, n_chunks, tik_eps
        self.output_from = output_from
        self.dnn1 = _DenseConvStack(2 * mic_channels, 2 * num_spk, hidden,
                                    layers)
        if output_from not in ("dnn1", "mfmcwf"):
            for s in range(num_spk):
                self.add_module(f"dnn2_{s}", _DenseConvStack(
                    2 * mic_channels + 4, 2, hidden, layers))

    def forward(self, ri):
        real, imag = ri
        if real.dim() == 3:
            real, imag = real[..., None], imag[..., None]
        B, T, Fq, _ = real.shape
        mix = torch.cat([real, imag], dim=-1)
        d1 = self.dnn1(mix).reshape(B, T, Fq, self.num_spk, 2)
        outs = []
        for s in range(self.num_spk):
            er, ei = d1[..., s, 0], d1[..., s, 1]
            if self.output_from == "dnn1":
                outs.append((er, ei))
                continue
            br, bi = mfmcwf(real, imag, er, ei, self.n_chunks, self.tik_eps)
            if self.output_from == "mfmcwf":
                outs.append((br, bi))
                continue
            d2 = getattr(self, f"dnn2_{s}")(torch.cat(
                [mix, er[..., None], ei[..., None], br[..., None],
                 bi[..., None]], dim=-1))
            outs.append((d2[..., 0], d2[..., 1]))
        return outs


class NeuralBeamformerSeparator(nn.Module):
    """The registry's adapter over the MVDR ``NeuralBeamformer`` (``bf``):
    the (B, S, C) wave (or (B, S), one channel) -> [the beamformed (B, S)
    wave], through the model's time-domain path."""

    time_domain = True

    def __init__(self, input_dim: int = 0, num_spk: int = 1,
                 n_fft: int = 512, hop_length: int = 128,
                 mask_hidden: int = 128, mask_layers: int = 2,
                 ref_channel: int = 0):
        super().__init__()
        from espnet_tpu_torch.models.enh.beamformer import NeuralBeamformer
        self.bf = NeuralBeamformer(n_fft, hop_length, mask_hidden,
                                   mask_layers, ref_channel)

    def forward(self, speech_mix, speech_lengths):
        if speech_mix.dim() == 2:
            speech_mix = speech_mix[..., None]
        return [self.bf.enhance(speech_mix, speech_lengths)[0]]


class AsteroidModel_Converter:
    """The JAX package's stub of the asteroid pretrained-separator wrapper:
    it needs the ``asteroid`` package and hub downloads, which neither
    package has. Raises ImportError, as the JAX stub's OfflineHubError
    (an ImportError) does."""

    def __init__(self, *args, **kwargs):
        raise ImportError(
            "AsteroidModel_Converter needs the `asteroid` package (pip "
            "install asteroid) and hub downloads, which are not available "
            "here. Use one of the in-repo separators (tcn, tfgridnet, "
            "bsrnn, dprnn, ...) instead.")


# the JAX package's registry, in its order
SEPARATORS = {
    "rnn": RNNSeparator, "tcn": TCNSeparator, "dprnn": DPRNNSeparator,
    "tfgridnet": TFGridNetSeparator, "bsrnn": BSRNNSeparator,
    "dptnet": DPTNetSeparator, "skim": SkiMSeparator,
    "dc_crn": DC_CRNSeparator, "transformer": TransformerSeparator,
    "conformer": ConformerSeparator, "dpcl": DPCLSeparator,
    "dan": DANSeparator, "dccrn": DCCRNSeparator,
    "dpcl_e2e": DPCLE2ESeparator, "svoice": SVoiceSeparator,
    "fasnet": FaSNetSeparator, "uses": USESSeparator,
    "tfgridnetv2": TFGridNetV2Separator,
    "tfgridnetv3": TFGridNetV3Separator, "ineube": INeuBeSeparator,
    "uses2": USES2Separator, "neural_beamformer": NeuralBeamformerSeparator,
    "asteroid": AsteroidModel_Converter}
