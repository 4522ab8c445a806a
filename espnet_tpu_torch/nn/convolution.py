"""Depthwise 1-D convolution (counterpart of
espnet_tpu/nn/convolution.py:DepthwiseConv1d, stride 1, SAME or VALID
padding, any kernel dilation), flax's pointwise convolution, and flax's
``SAME`` alignment for a 1-D or 2-D convolution and a 1-D or 2-D
transposed one.

flax's ``SAME`` pads a convolution of stride s over n inputs to
ceil(n / s) outputs: by total = max((ceil(n / s) - 1) s + span + 1 - n, 0)
in all, span = dilation (K - 1), total // 2 on the left and the rest on
the right (``same_pads``). At stride 1 that is span whatever n is; at
strides 3 and 4 (the HiFi-GAN discriminators) it depends on each
layer's input length and is uneven where n is not a multiple of s.
Its ``ConvTranspose(K, strides=s, padding="SAME")`` (lax.conv_transpose)
runs the kernel over the input dilated by s and padded by (a, b),
a + b = K + s - 2, with a = K - 1 when s > K - 1 and ceil((K + s - 2) / 2)
otherwise: T * s outputs. torch's conv_transpose1d without padding pads
by K - 1 on both sides, (T - 1) s + K outputs, so flax's are those from
K - 1 - a on (``transpose_same_crop``), and past torch's end (b > K - 1)
the bias alone. The 2-D one crops each axis so."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class DepthwiseConv1d(nn.Module):
    """(B, T, C) -> (B, T', C): a grouped Conv1d with weight (C, 1, K),
    its taps ``dilation`` samples apart (span = dilation (K - 1)). "SAME"
    pads span // 2 on the left and the rest on the right (T' = T);
    "VALID" pads nothing (T' = T - span)."""

    def __init__(self, channels: int, kernel_size: int,
                 padding: str = "SAME", dilation: int = 1):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise NotImplementedError(f"padding {padding!r}: the port has "
                                      f"SAME and VALID")
        self.weight = nn.Parameter(torch.zeros(channels, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.dilation = dilation
        self.pad = (same_pads(kernel_size, dilation) if padding == "SAME"
                    else (0, 0))

    def forward(self, x):
        h = F.pad(x.transpose(1, 2), self.pad)
        y = F.conv1d(h, self.weight, self.bias, dilation=self.dilation,
                     groups=self.weight.shape[0])
        return y.transpose(1, 2)


class Pointwise(nn.Linear):
    """flax ``nn.Conv(out, (1,))`` on (B, T, in): a product with the
    kernel, which is (1, in, out) in the flax tree and a Linear weight
    (out, in) here."""


def same_pads(kernel_size: int, dilation: int = 1, stride: int = 1,
              n: int = 0):
    """flax's SAME padding of a convolution over n inputs: (left, right).
    At stride 1 it does not depend on n."""
    span = dilation * (kernel_size - 1)
    total = max((-(-n // stride) - 1) * stride + span + 1 - n, 0) \
        if stride > 1 else span
    return total // 2, total - total // 2


def transpose_same_crop(kernel_size: int, stride: int) -> int:
    """The first of torch's (T - 1) s + K transposed-convolution outputs
    that flax's SAME keeps; it keeps T * s from there."""
    if stride > kernel_size - 1:
        left = kernel_size - 1
    else:
        left = -(-(kernel_size + stride - 2) // 2)
    return kernel_size - 1 - left


class SameConv1d(nn.Conv1d):
    """flax ``nn.Conv(out, (K,), strides=(s,), padding="SAME",
    kernel_dilation=d, feature_group_count=g)`` on channels-first
    (B, C, T) -> (B, out, ceil(T / s))."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, dilation: int = 1, stride: int = 1,
                 groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, dilation=dilation, groups=groups)
        self.pads = same_pads(kernel_size, dilation)

    def forward(self, x):
        s = self.stride[0]
        pads = self.pads if s == 1 else same_pads(
            self.kernel_size[0], self.dilation[0], s, x.shape[-1])
        return super().forward(F.pad(x, pads))


class SameConv2d(nn.Conv2d):
    """flax ``nn.Conv(out, (kh, kw), strides=(sh, sw))`` (SAME, flax's
    default) on channels-first (B, C, H, W) -> (B, out, ceil(H / sh),
    ceil(W / sw))."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=(1, 1)):
        super().__init__(in_channels, out_channels, tuple(kernel_size),
                         stride=tuple(stride))

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = same_pads(kh, 1, sh, x.shape[-2])
        left, right = same_pads(kw, 1, sw, x.shape[-1])
        return super().forward(F.pad(x, (left, right, top, bottom)))


class SameConvTranspose1d(nn.ConvTranspose1d):
    """flax ``nn.ConvTranspose(out, (K,), strides=(s,), padding="SAME")``
    on channels-first (B, C, T) -> (B, out, T * s)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride)
        self.crop = transpose_same_crop(kernel_size, stride)

    def forward(self, x):
        n = x.shape[-1] * self.stride[0]
        y = F.conv_transpose1d(x, self.weight, None, self.stride)
        # with s > K flax pads the right by more than K - 1: those
        # outputs see no input, only the bias
        y = F.pad(y, (0, max(self.crop + n - y.shape[-1], 0)))
        return y[..., self.crop:self.crop + n] + self.bias[:, None]


class SameConvTranspose2d(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(out, (kh, kw), strides=(sh, sw),
    padding="SAME")`` on channels-first (B, C, H, W) -> (B, out, H * sh,
    W * sw): each axis cropped as ``SameConvTranspose1d``'s."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride):
        super().__init__(in_channels, out_channels, tuple(kernel_size),
                         stride=tuple(stride))
        self.crops = tuple(transpose_same_crop(k, s) for k, s in
                           zip(self.kernel_size, self.stride))

    def forward(self, x):
        (ch, cw), (sh, sw) = self.crops, self.stride
        nh, nw = x.shape[-2] * sh, x.shape[-1] * sw
        y = F.conv_transpose2d(x, self.weight, None, self.stride)
        y = F.pad(y, (0, max(cw + nw - y.shape[-1], 0),
                      0, max(ch + nh - y.shape[-2], 0)))
        return y[..., ch:ch + nh, cw:cw + nw] + self.bias[:, None, None]
