"""Monotonic alignment search (counterpart of
espnet_tpu/ops/monotonic_align.py:maximum_path): the best monotonic path
through a (B, S, T) log-likelihood matrix, text position s per feature
frame t, on the tensor's device.

The same function bit for bit: fp32 scores with NEG_INF = -1e9; a loop
over the T frames keeps the best score ending at (s, t), advancing from
s - 1 only where that is strictly better (``advance > stay``: ties stay);
the only feasibility rule is s <= t (padded text rows are not masked);
the backtrack starts at (text_lens - 1, feat_lens - 1) and walks back
through the noted choices; frames past feat_lens are zeroed. Both loops
are T steps of (B, S) vector ops, as the JAX package's two scans are.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def maximum_path(value: torch.Tensor, text_lens: torch.Tensor,
                 feat_lens: torch.Tensor) -> torch.Tensor:
    """value (B, S, T) fp32 -> path (B, S, T) in {0, 1}, value's dtype."""
    B, S, T = value.shape
    dev = value.device
    s_idx = torch.arange(S, device=dev)
    neg = value.new_full((B, 1), NEG_INF)
    prev = torch.where(s_idx[None] == 0, value[:, :, 0], NEG_INF)
    from_adv = torch.zeros(max(T - 1, 0), B, S, dtype=torch.bool,
                           device=dev)
    for t in range(1, T):
        advance = torch.cat([neg, prev[:, :-1]], dim=1)
        from_adv[t - 1] = advance > prev
        cur = torch.maximum(prev, advance) + value[:, :, t]
        prev = torch.where(s_idx[None] <= t, cur, NEG_INF)

    text_lens, feat_lens = text_lens.long(), feat_lens.long()
    rows = torch.arange(B, device=dev)
    s_cur = text_lens - 1
    s_path = torch.empty(B, T, dtype=torch.long, device=dev)
    for t in range(T - 1, -1, -1):
        s_cur = torch.where(feat_lens - 1 == t, text_lens - 1, s_cur)
        s_path[:, t] = s_cur
        if t > 0:
            step = from_adv[t - 1, rows, s_cur] & (feat_lens - 1 >= t)
            s_cur = (s_cur - step.long()).clamp(0, S - 1)
    path = torch.zeros(B, S, T, dtype=value.dtype, device=dev)
    path.scatter_(1, s_path[:, None, :], 1.0)
    t_valid = torch.arange(T, device=dev)[None] < feat_lens[:, None]
    return path * t_valid[:, None, :]
