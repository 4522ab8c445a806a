"""Enhancement losses and the permutation-invariant wrapper (counterpart
of espnet_tpu/models/enh/losses.py): -SI-SNR, -SNR and L1 per batch
element, and PIT as the least mean loss over every assignment of
estimates to references. ``mixit_loss`` is not ported yet."""

from __future__ import annotations

import itertools

import torch

from espnet_tpu_torch.utils.masks import make_non_pad_mask


def si_snr_loss(est: torch.Tensor, ref: torch.Tensor,
                lengths: torch.Tensor | None = None,
                eps: float = 1e-8) -> torch.Tensor:
    """-SI-SNR in dB per batch element; est, ref (B, S). With lengths:
    mask, remove the mean over the valid samples, mask again."""
    if lengths is not None:
        mask = make_non_pad_mask(lengths, est.shape[1]).to(est.dtype)
        est, ref = est * mask, ref * mask
        n = lengths.to(est.dtype).clamp(min=1.0)[:, None]
    else:
        n = est.shape[1]
    est = est - est.sum(dim=1, keepdim=True) / n
    ref = ref - ref.sum(dim=1, keepdim=True) / n
    if lengths is not None:
        est, ref = est * mask, ref * mask
    dot = (est * ref).sum(dim=1, keepdim=True)
    s_ref = dot * ref / ((ref * ref).sum(dim=1, keepdim=True) + eps)
    e = est - s_ref
    ratio = ((s_ref * s_ref).sum(dim=1) + eps) / ((e * e).sum(dim=1) + eps)
    return -10.0 * torch.log10(ratio)


def snr_loss(est, ref, lengths=None, eps: float = 1e-8):
    """-SNR in dB per batch element."""
    if lengths is not None:
        mask = make_non_pad_mask(lengths, est.shape[1]).to(est.dtype)
        est, ref = est * mask, ref * mask
    noise = est - ref
    ratio = ((ref * ref).sum(dim=1) + eps) / ((noise * noise).sum(dim=1)
                                              + eps)
    return -10.0 * torch.log10(ratio)


def l1_loss(est, ref, lengths=None):
    """|est - ref| summed per batch element over its valid entries, over
    the number of valid steps (the first axis after the batch's)."""
    d = (est - ref).abs()
    dims = tuple(range(1, d.dim()))
    if lengths is not None:
        mask = make_non_pad_mask(lengths, est.shape[1])
        mask = mask.reshape(mask.shape + (1,) * (d.dim() - 2))
        d = torch.where(mask, d, 0.0)
        denom = mask.sum(dim=dims).clamp(min=1)
        return d.sum(dim=dims) / denom
    return d.mean(dim=dims)


CRITERIA = {"si_snr": si_snr_loss, "snr": snr_loss, "l1": l1_loss}


def pit_loss(loss_fn, ests, refs, lengths=None):
    """ests, refs: lists of (B, ...) per speaker -> (the least mean loss
    over the permutations (B,), its index into
    itertools.permutations(range(n)) (B,)). Ties go to the first."""
    n = len(ests)
    losses = torch.stack([
        sum(loss_fn(ests[i], refs[p], lengths) for i, p in enumerate(perm))
        / n for perm in itertools.permutations(range(n))], dim=1)
    best = torch.argmin(losses, dim=1)
    return losses.gather(1, best[:, None])[:, 0], best
