"""CTC prefix scorer for hybrid beam search (counterpart of
espnet_tpu/decode/ctc_prefix.py).

Algorithm 2 of Watanabe et al. (hybrid CTC/attention), vectorised over
all W pre-beam candidates of all hypothesis rows: one loop over frames
carries (r_nb, r_b). Frames past an utterance's length have blank
log-prob 0 and every other token logzero, so the DP runs past the end at
no cost and needs no per-frame mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from espnet_tpu_torch.utils.masks import make_non_pad_mask

NEG_INF = -1e10


class CTCPrefixState(NamedTuple):
    """Per-row state (rows = batch * beam hypothesis slots)."""

    r_nb: torch.Tensor    # (rows, T) log p(prefix, ends non-blank at t)
    r_b: torch.Tensor     # (rows, T) log p(prefix, ends blank at t)
    score: torch.Tensor   # (rows,) prefix score
    last: torch.Tensor    # (rows,) last token, -1 for the empty prefix
    length: torch.Tensor  # (rows,) prefix length


def pad_log_posteriors(logp, lengths, blank_id: int = 0):
    """Apply the padding convention past each length."""
    rows, T, V = logp.shape
    valid = make_non_pad_mask(lengths, T)[:, :, None]
    pad = torch.full((V,), NEG_INF, device=logp.device)
    pad[blank_id] = 0.0
    return torch.where(valid, logp, pad)


def init_state(x, blank_id: int = 0) -> CTCPrefixState:
    """x (rows, T, V) padded log-posteriors; the prefix starts empty."""
    rows, T, _ = x.shape
    dev = x.device
    return CTCPrefixState(
        r_nb=torch.full((rows, T), NEG_INF, device=dev),
        r_b=torch.cumsum(x[:, :, blank_id], dim=1),
        score=torch.zeros(rows, device=dev),
        last=torch.full((rows,), -1, dtype=torch.int64, device=dev),
        length=torch.zeros(rows, dtype=torch.int64, device=dev))


def score_candidates(state: CTCPrefixState, cand_ids, x, enc_lens,
                     blank_id: int = 0, eos_id: int | None = None):
    """Score W candidate extensions per row.

    cand_ids (rows, W); x (rows, T, V) padded log-posteriors; enc_lens
    (rows,). Returns (local scores = log_psi - prefix score, log_psi,
    r_nb_new, r_b_new (rows, W, T)). An eos candidate gets the
    full-sequence probability of the prefix; a blank candidate logzero.
    """
    rows, W = cand_ids.shape
    T = x.shape[1]
    xc = x.gather(2, cand_ids[:, None, :].expand(rows, T, W))  # (rows, T, W)
    xb = x[:, :, blank_id]
    same = cand_ids == state.last[:, None]
    phi = torch.where(same[:, None, :], state.r_b[:, :, None],
                      torch.logaddexp(state.r_b, state.r_nb)[:, :, None])
    empty = (state.length == 0)[:, None]
    r_nb = torch.where(empty, xc[:, 0, :],
                       torch.full((), NEG_INF, device=x.device))
    r_b = torch.full((rows, W), NEG_INF, device=x.device)
    r_nb_seq = torch.empty(T, rows, W, device=x.device)
    r_b_seq = torch.empty(T, rows, W, device=x.device)
    r_nb_seq[0], r_b_seq[0] = r_nb, r_b
    log_psi = r_nb
    for t in range(1, T):
        r_nb_next = torch.logaddexp(r_nb, phi[:, t - 1]) + xc[:, t]
        r_b = torch.logaddexp(r_nb, r_b) + xb[:, t, None]
        log_psi = torch.logaddexp(log_psi, phi[:, t - 1] + xc[:, t])
        r_nb = r_nb_next
        r_nb_seq[t], r_b_seq[t] = r_nb, r_b
    ar = torch.arange(rows, device=x.device)
    end = torch.clamp(enc_lens - 1, min=0)
    r_sum_end = torch.logaddexp(state.r_nb[ar, end], state.r_b[ar, end])
    if eos_id is not None:
        log_psi = torch.where(cand_ids == eos_id, r_sum_end[:, None], log_psi)
    log_psi = log_psi.masked_fill(cand_ids == blank_id, NEG_INF)
    local = log_psi - state.score[:, None]
    return (local, log_psi, r_nb_seq.permute(1, 2, 0),
            r_b_seq.permute(1, 2, 0))


def select_state(state: CTCPrefixState, r_nb_new, r_b_new, log_psi,
                 src_row, cand_idx, new_token) -> CTCPrefixState:
    """Gather the chosen (row, candidate) DP states into the next beam."""
    return CTCPrefixState(
        r_nb=r_nb_new[src_row, cand_idx],
        r_b=r_b_new[src_row, cand_idx],
        score=log_psi[src_row, cand_idx],
        last=new_token,
        length=state.length[src_row] + 1)
