"""Losses of the hybrid CTC/attention model (counterpart of
espnet_tpu/ops/losses.py): CTC, label smoothing, token accuracy and the
sos/eos framing of the decoder's targets.

CTC is ``F.ctc_loss``: the JAX package computes it with XLA (an alpha
scan and an analytic-gradient beta scan), not with a Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from espnet_tpu_torch.utils.masks import make_non_pad_mask


def ctc_loss(logits, logit_lens, labels, label_lens, blank_id: int = 0):
    """Mean over the batch of the per-sequence CTC negative log
    likelihood; logits (B, T, V) unnormalised, labels (B, U) 0-padded.

    Impossible alignments (U > T, or too few frames for the repeats)
    count 0 and give no gradient (zero-infinity). The mean is over
    sequences: ``reduction="mean"`` would divide by target lengths.
    """
    logp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    per_seq = F.ctc_loss(logp, labels.long(), logit_lens.long(),
                         label_lens.long(), blank=blank_id,
                         reduction="none", zero_infinity=True)
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
    logp = torch.log_softmax(logits.float(), dim=-1)
    confidence = 1.0 - smoothing
    smooth_val = smoothing / (V - 1)
    logp_t = logp.gather(-1, tgt[..., None])[..., 0]
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
