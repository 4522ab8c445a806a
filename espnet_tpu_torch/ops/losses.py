"""Losses of the hybrid CTC/attention model (counterpart of
espnet_tpu/ops/losses.py): CTC, label smoothing, token accuracy and the
sos/eos framing of the decoder's targets.

CTC is the JAX package's own closed form (``ctc_nll``): an alpha
recursion over time in the forward, then one beta recursion and the
state posteriors in the backward, folded onto the vocabulary with a
one-hot product. It is plain torch, vectorised over (B, 2U+1) inside a
loop over T, as the JAX package runs it in XLA, not in a Pallas kernel.
Nothing in it adds two floats to one address in an order that changes
between runs, so its gradient is the same on every run on the card (the
CUDA backward of ``F.ctc_loss`` is not).

The recursions run up to the batch's longest sequence, not over the
padded frames. The log-softmax is taken in fp32, the recursions and the
posteriors in fp64. The gradient is softmax - posterior, two numbers
near 1 where the model is sure; alpha and beta are sums over up to T
log-probabilities of O(10) each, and in fp32 their rounding (~1e-5)
reaches the posterior whole. The tensors are (T, B, 2U+1): fp64 costs
nothing that shows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from espnet_tpu_torch.utils.masks import make_non_pad_mask

_NEG = -1e30


def at_least_fp32(x):
    """x in fp32, or as it is where it is float64: a float64 reference of
    the model keeps its digits through the losses."""
    return x if x.dtype == torch.float64 else x.float()


def _ctc_expand(labels, label_lens, blank_id: int):
    """(B, U) labels -> the (B, S = 2U+1) blank-interleaved states z, which
    states lie inside each sequence, and which may skip from s-2."""
    B, U = labels.shape
    S = 2 * U + 1
    s = torch.arange(S, device=labels.device)
    is_lab = (s % 2) == 1
    lab = F.pad(labels.long(), (0, 1))       # a column to read when U = 0
    z = torch.where(is_lab[None, :], lab[:, s // 2], blank_id)
    valid = s[None, :] < (2 * label_lens[:, None] + 1)
    z_m2 = F.pad(z, (2, 0), value=-1)[:, :S]
    can_skip = is_lab[None, :] & (z != z_m2)
    return z, valid, can_skip


def _shift(a, k: int):
    """a[:, s - k], with _NEG shifted in."""
    return F.pad(a, (k, 0), value=_NEG)[:, :a.shape[1]]


def _unshift(a, k: int):
    """a[:, s + k], with _NEG shifted in."""
    return F.pad(a, (0, k), value=_NEG)[:, k:]


def _state_logprobs(logits, labels, label_lens, blank_id: int):
    """-> log-softmax (B, T, V), each state's log-emission time-major
    (T, B, S), both fp64, and the states of ``_ctc_expand``."""
    lp = torch.log_softmax(at_least_fp32(logits), dim=-1).double()
    z, valid, can_skip = _ctc_expand(labels, label_lens, blank_id)
    lp_z = lp.gather(2, z[:, None, :].expand(-1, lp.shape[1], -1))
    return lp, lp_z.transpose(0, 1), z, valid, can_skip


class _CTCNLL(torch.autograd.Function):
    """Per-sequence CTC negative log likelihood (B,) of unnormalised
    logits (B, T, V), with the closed-form gradient softmax - posterior."""

    @staticmethod
    def forward(ctx, logits, logit_lens, labels, label_lens, blank_id):
        lp, lp_z, z, valid, can_skip = _state_logprobs(
            logits, labels, label_lens, blank_id)
        # past the longest sequence alpha stays as it is and the posteriors
        # are 0: the recursions stop there (one host read of the length)
        T = max(min(int(logit_lens.max()), lp_z.shape[0]), 1)
        B, S = lp_z.shape[1:]
        alpha = torch.full((B, S), _NEG, dtype=lp.dtype,
                           device=logits.device)
        alpha[:, :2] = 0.0
        alpha = torch.where(valid, alpha + lp_z[0], _NEG)
        alphas = [alpha]
        for t in range(1, T):
            prev = torch.logaddexp(alpha, _shift(alpha, 1))
            prev = torch.logaddexp(
                prev, torch.where(can_skip, _shift(alpha, 2), _NEG))
            new = torch.where(valid, prev + lp_z[t], _NEG)
            # frames at or after a sequence's end carry alpha unchanged
            alpha = torch.where((t < logit_lens)[:, None], new, alpha)
            alphas.append(alpha)
        send = valid.sum(1) - 1                       # 2 * label_len
        a_end = alpha.gather(1, send[:, None])[:, 0]
        a_pen = torch.where(
            send >= 1, alpha.gather(1, (send - 1).clamp(min=0)[:, None])[:, 0],
            _NEG)
        nll = -torch.logaddexp(a_end, a_pen)
        ctx.blank_id = blank_id
        ctx.save_for_backward(logits, logit_lens, labels, label_lens,
                              torch.stack(alphas), nll)
        return nll.to(at_least_fp32(logits).dtype)

    @staticmethod
    def backward(ctx, g):
        logits, logit_lens, labels, label_lens, alphas, nll = \
            ctx.saved_tensors
        lp, lp_z, z, valid, can_skip = _state_logprobs(
            logits, labels, label_lens, ctx.blank_id)
        T, B, S = alphas.shape                        # frames swept
        V = lp.shape[-1]
        send = valid.sum(1) - 1
        s_idx = torch.arange(S, device=logits.device)[None, :]
        terminal = torch.where((s_idx == send[:, None])
                               | (s_idx == (send - 1).clamp(min=0)[:, None]),
                               0.0, _NEG).to(lp.dtype)
        betas = [terminal]
        beta = terminal
        for t in range(T - 2, -1, -1):
            term = beta + lp_z[t + 1]
            skip = torch.where(can_skip, term, _NEG)
            nxt = torch.logaddexp(torch.logaddexp(term, _unshift(term, 1)),
                                  _unshift(skip, 2))
            beta = torch.where(valid, nxt, _NEG)
            # from a sequence's last frame on, the chain is terminal
            beta = torch.where((t >= logit_lens - 1)[:, None], terminal, beta)
            betas.append(beta)
        betas = torch.stack(betas[::-1])              # (T, B, S)
        # state posteriors: alpha holds frame t's emission, beta does not
        gamma = torch.exp(torch.clamp(alphas + betas + nll[None, :, None],
                                      max=0.0))
        tmask = (torch.arange(lp.shape[1], device=logits.device)[:, None]
                 < logit_lens[None, :])               # (all frames, B)
        gamma = torch.where(tmask[:T, :, None] & valid[None], gamma, 0.0)
        onehot = F.one_hot(z, V).to(gamma.dtype)      # (B, S, V)
        post = torch.einsum("tbs,bsv->btv", gamma, onehot)
        post = F.pad(post, (0, 0, 0, lp.shape[1] - T))
        dlp = lp.exp() * tmask.t()[..., None] - post
        # an impossible alignment saturates at ~|_NEG|: no gradient
        safe = torch.isfinite(nll) & (nll < 1e29)
        coeff = torch.where(safe, g, 0.0)[:, None, None]
        return (coeff * dlp).to(logits.dtype), None, None, None, None


def ctc_nll(logits, logit_lens, labels, label_lens, blank_id: int = 0):
    """Per-sequence CTC negative log likelihood, (B,)."""
    return _CTCNLL.apply(logits, logit_lens, labels, label_lens, blank_id)


def ctc_loss(logits, logit_lens, labels, label_lens, blank_id: int = 0):
    """Mean over the batch of the per-sequence CTC negative log
    likelihood; logits (B, T, V) unnormalised, labels (B, U) 0-padded.

    Impossible alignments (U > T, or too few frames for the repeats)
    count 0 and give no gradient (zero-infinity).
    """
    per_seq = ctc_nll(at_least_fp32(logits), logit_lens, labels, label_lens,
                      blank_id)
    per_seq = torch.where(torch.isfinite(per_seq)
                          & (per_seq < 0.5 * -_NEG), per_seq, 0.0)
    return per_seq.mean()


def label_smoothing_loss(logits, targets, smoothing: float = 0.1,
                         padding_idx: int = -1,
                         normalize_length: bool = False):
    """KL(smoothed one-hot || softmax(logits)) summed over tokens, the
    entropy of the smoothed target included; logits (B, L, V), targets
    (B, L) with ``padding_idx`` at padding. The smoothing mass spreads
    over the V - 1 other tokens. Normalised by the number of sequences
    that hold a token, or by the number of tokens when
    ``normalize_length``."""
    V = logits.shape[-1]
    valid = targets != padding_idx
    tgt = torch.where(valid, targets, 0).long()
    logp = torch.log_softmax(at_least_fp32(logits), dim=-1)
    confidence = 1.0 - smoothing
    smooth_val = smoothing / (V - 1)
    # a one-hot product, not a gather: its backward adds nothing to a
    # shared address
    logp_t = (logp * F.one_hot(tgt, V).to(logp.dtype)).sum(-1)
    true_dist_logp_sum = (confidence * logp_t
                          + smooth_val * (logp.sum(dim=-1) - logp_t))
    ent = -(confidence * math.log(max(confidence, 1e-20))
            + (V - 1) * smooth_val * math.log(max(smooth_val, 1e-20)))
    kl = torch.where(valid, -true_dist_logp_sum - ent, 0.0)
    if normalize_length:
        denom = valid.sum().clamp(min=1)
    else:
        denom = valid.any(dim=-1).sum().clamp(min=1)
    return kl.sum() / denom


def accuracy(logits, targets, padding_idx: int = -1):
    """Token accuracy over the positions that are not padding."""
    valid = targets != padding_idx
    correct = ((logits.argmax(dim=-1) == targets) & valid).sum()
    return correct / valid.sum().clamp(min=1)


def add_sos_eos(ys_pad, ys_lens, sos: int, eos: int, ignore_id: int = -1):
    """(B, U) 0-padded labels -> ys_in (B, U+1) = [sos, y..., eos-padded]
    and ys_out (B, U+1) = [y..., eos, ignore_id...]."""
    B, U = ys_pad.shape
    valid = make_non_pad_mask(ys_lens, U)
    sos_col = ys_pad.new_full((B, 1), sos)
    ys_in = torch.cat([sos_col, torch.where(valid, ys_pad, eos)], dim=1)
    pos = torch.arange(U + 1, device=ys_pad.device)[None, :]
    y_ext = torch.cat([ys_pad, ys_pad.new_zeros((B, 1))], dim=1)
    lens = ys_lens[:, None]
    ys_out = torch.where(pos < lens, y_ext,
                         torch.where(pos == lens, eos, ignore_id))
    return ys_in, ys_out
