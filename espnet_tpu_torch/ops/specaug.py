"""SpecAugment with an explicit random generator (counterpart of
espnet_tpu/ops/specaug.py): time warp, then frequency masks, then time
masks, on a (B, T, D) feature batch with static shapes.

The random numbers come from the ``torch.Generator`` the caller passes
(on the features' device); they are not the JAX package's bits, so the
tests compare what the masks do, not where they fall.
"""

from __future__ import annotations

import torch


def _randint(generator, low: int, high: int, shape, device):
    """Integers in [low, high); an empty range gives ``low``."""
    if high <= low:
        return torch.full(shape, low, dtype=torch.int64, device=device)
    return torch.randint(low, high, shape, generator=generator,
                         device=device)


def mask_along_axis(x, lengths, *, axis: int, generator=None,
                    mask_width_range=(0, 30), num_mask: int = 2,
                    mask_value: float = 0.0):
    """Random bands along time (axis=1) or frequency (axis=2) of x
    (B, T, D) set to ``mask_value``: widths in [lo, hi), and time bands
    that start inside each utterance's own length."""
    B = x.shape[0]
    size = x.shape[axis]
    widths = _randint(generator, mask_width_range[0], mask_width_range[1],
                      (B, num_mask), x.device)
    if axis == 1 and lengths is not None:
        maxstart = torch.clamp(lengths[:, None] - widths, min=1)
    else:
        maxstart = torch.clamp(size - widths, min=1)
    starts = _randint(generator, 0, 2 ** 30, (B, num_mask),
                      x.device) % maxstart
    pos = torch.arange(size, device=x.device)[None, None, :]
    hit = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    shape = [B, 1, 1]
    shape[axis] = size
    return x.masked_fill(hit.any(dim=1).reshape(shape), mask_value)


def time_warp(x, lengths, *, generator=None, window: int = 5):
    """Piecewise-linear time warp of each utterance around a random
    frame c in [window, L - window), moved to c + w with w in
    [-window, window]; nearest-neighbour gather. Padding frames and
    utterances shorter than 2 * window + 2 frames are left as they are."""
    B, T, _ = x.shape
    L = (lengths if lengths is not None
         else torch.full((B,), T, device=x.device)).long()
    safe_hi = torch.clamp(L - window, min=window + 1)
    c = window + _randint(generator, 0, 2 ** 30, (B,), x.device) \
        % torch.clamp(safe_hi - window, min=1)
    w = _randint(generator, -window, window + 1, (B,), x.device)
    cw = torch.minimum(torch.clamp(c + w, min=1),
                       torch.clamp(L - 1, min=2))
    t = torch.arange(T, device=x.device, dtype=torch.float32)[None, :]
    cf, cwf, Lf = (v[:, None].float() for v in (c, cw, L))
    src_lo = t * cf / torch.clamp(cwf, min=1.0)
    src_hi = cf + (t - cwf) * (Lf - cf) / torch.clamp(Lf - cwf, min=1.0)
    src = torch.where(t < cwf, src_lo, src_hi)
    src = torch.where(t < Lf, src, t)
    idx = torch.round(src).long().clamp(0, T - 1)
    warped = x.gather(1, idx[:, :, None].expand_as(x))
    ok = (L >= 2 * window + 2)[:, None, None]
    return torch.where(ok, warped, x)


def specaug(x, lengths=None, *, generator=None, apply_time_warp: bool = True,
            time_warp_window: int = 5, apply_freq_mask: bool = True,
            freq_mask_width_range=(0, 20), num_freq_mask: int = 2,
            apply_time_mask: bool = True, time_mask_width_range=(0, 40),
            num_time_mask: int = 2):
    """Time warp -> frequency masks -> time masks. An int width range W
    means (0, W)."""
    if isinstance(freq_mask_width_range, int):
        freq_mask_width_range = (0, freq_mask_width_range)
    if isinstance(time_mask_width_range, int):
        time_mask_width_range = (0, time_mask_width_range)
    if apply_time_warp:
        x = time_warp(x, lengths, generator=generator,
                      window=time_warp_window)
    if apply_freq_mask:
        x = mask_along_axis(x, lengths, axis=2, generator=generator,
                            mask_width_range=freq_mask_width_range,
                            num_mask=num_freq_mask)
    if apply_time_mask:
        x = mask_along_axis(x, lengths, axis=1, generator=generator,
                            mask_width_range=time_mask_width_range,
                            num_mask=num_time_mask)
    return x
