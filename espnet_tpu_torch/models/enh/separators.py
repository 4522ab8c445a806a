"""Enhancement separators (counterpart of
espnet_tpu/models/enh/separators.py): the BLSTM TF-masking separator and
the Conv-TasNet TCN. Each maps (B, T, F) features to ``num_spk`` masks
of the same shape.

Attribute names follow the JAX parameter tree (``conv1x1``, ``PReLU_0``,
``OptimizedLSTMCell_0``, ...) so that ``convert.py`` maps one onto the
other by path. The layouts that flax has and torch lacks are written
out: ``Pointwise`` is flax's ``nn.Conv(..., (1,))``, a product with a
(1, in, out) kernel; ``PReLU`` is flax's, one scalar ``negative_slope``;
``LayerNorm`` takes flax's epsilon, 1e-6. The LSTM is the port's
``LSTMCell`` (flax's ``OptimizedLSTMCell`` layout), not cuDNN's.

The JAX package registers more separators; the port builds "rnn" and
"tcn", and the others raise NotImplementedError.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from espnet_tpu_torch.models.transducer import LSTMCell
from espnet_tpu_torch.nn.convolution import DepthwiseConv1d, Pointwise

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


class BLSTM(nn.Module):
    """One bidirectional LSTM layer over every frame: (B, T, D) -> (B, T,
    2H). The backward direction runs over the padding too, as the JAX
    package's ``nn.RNN(reverse=True, keep_order=True)`` without lengths
    does. Cell 0 runs forward, cell 1 backward."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.OptimizedLSTMCell_0 = LSTMCell(input_size, hidden)
        self.OptimizedLSTMCell_1 = LSTMCell(input_size, hidden)

    def _run(self, cell, x, reverse: bool):
        B, T, _ = x.shape
        proj = cell.input_proj(x)
        carry = (x.new_zeros(B, self.hidden), x.new_zeros(B, self.hidden))
        out = [None] * T
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            carry = cell(carry, proj[:, t])
            out[t] = carry[1]
        return torch.stack(out, dim=1)

    def forward(self, x):
        return torch.cat([self._run(self.OptimizedLSTMCell_0, x, False),
                          self._run(self.OptimizedLSTMCell_1, x, True)],
                         dim=-1)


NONLINEAR = {"sigmoid": torch.sigmoid, "relu": F.relu, "tanh": torch.tanh}


class RNNSeparator(nn.Module):
    """Stacked BLSTMs, then per speaker a Linear and the mask
    nonlinearity."""

    def __init__(self, input_dim: int, num_spk: int = 2,
                 rnn_hidden: int = 128, num_layers: int = 2,
                 nonlinear: str = "sigmoid", dropout_rate: float = 0.0):
        super().__init__()
        self.num_spk = num_spk
        self.num_layers = num_layers
        self.nonlinear = nonlinear
        for i in range(num_layers):
            self.add_module(f"blstm{i}", BLSTM(
                input_dim if i == 0 else 2 * rnn_hidden, rnn_hidden))
        self.dropout = nn.Dropout(dropout_rate)
        for s in range(num_spk):
            self.add_module(f"mask{s}", nn.Linear(2 * rnn_hidden,
                                                  input_dim))

    def forward(self, x):
        h = x
        for i in range(self.num_layers):
            h = self.dropout(getattr(self, f"blstm{i}")(h))
        act = NONLINEAR[self.nonlinear]
        return [act(getattr(self, f"mask{s}")(h))
                for s in range(self.num_spk)]


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
        m = self.mask_out(self.PReLU_0(h))
        B, T, _ = m.shape
        m = m.reshape(B, T, self.num_spk, self.input_dim)
        if self.nonlinear == "softmax":
            m = torch.softmax(m, dim=2)
        else:
            m = NONLINEAR[self.nonlinear](m)
        return [m[:, :, s] for s in range(self.num_spk)]


def _not_ported(name: str, **kwargs):
    raise NotImplementedError(
        f"separator {name!r} is not ported yet (ROADMAP A.4); the port "
        f"builds 'rnn' and 'tcn'")


SEPARATORS = {"rnn": RNNSeparator, "tcn": TCNSeparator}
# the JAX package's other separators, in its registry's order
SEPARATORS.update({
    name: functools.partial(_not_ported, name) for name in (
        "dprnn", "tfgridnet", "bsrnn", "dptnet", "skim", "dc_crn",
        "transformer", "conformer", "dpcl", "dan", "dccrn", "dpcl_e2e",
        "svoice", "fasnet", "uses", "tfgridnetv2", "tfgridnetv3", "ineube",
        "uses2", "neural_beamformer", "asteroid")})
