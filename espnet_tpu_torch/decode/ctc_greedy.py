"""Greedy CTC decoding (counterpart of espnet_tpu/decode/ctc_greedy.py):
argmax per frame, collapse repeats, drop blanks."""

from __future__ import annotations

import torch

from espnet_tpu_torch.utils.masks import make_non_pad_mask


def ctc_greedy_decode(logits, lengths, blank_id: int = 0):
    """(B, T, V), (B,) -> tokens (B, T) left-packed and 0-padded,
    token counts (B,)."""
    B, T, _ = logits.shape
    pred = logits.argmax(dim=-1)
    prev = torch.cat([torch.full((B, 1), -1, dtype=pred.dtype,
                                 device=pred.device), pred[:, :-1]], dim=1)
    keep = (pred != blank_id) & (pred != prev) & make_non_pad_mask(lengths, T)
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    packed = pred.gather(1, order)
    n_tok = keep.sum(dim=1)
    ar = torch.arange(T, device=pred.device)[None]
    return torch.where(ar < n_tok[:, None], packed, 0), n_tok
