"""Length masks (counterpart of espnet_tpu/utils/masks.py).

Masks are boolean with True = valid frame.
"""

from __future__ import annotations

import torch


def make_non_pad_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """True at valid positions: (B,) -> (B, maxlen)."""
    ar = torch.arange(maxlen, device=lengths.device)
    return ar[None, :] < lengths[:, None]


def mask_fill(x: torch.Tensor, valid_mask: torch.Tensor) -> torch.Tensor:
    """Zero the invalid positions of x (B, T, ...)."""
    shape = valid_mask.shape + (1,) * (x.dim() - valid_mask.dim())
    return x.masked_fill(~valid_mask.reshape(shape), 0.0)


def attention_bias(mask: torch.Tensor) -> torch.Tensor:
    """bool mask (True = attend) -> f32 additive bias of 0 or -1e9: finite,
    so a fully masked row gives a uniform softmax, not NaN."""
    return torch.where(mask, 0.0, -1e9)
