"""Enhancement losses and the permutation-invariant wrapper (counterpart
of espnet_tpu/models/enh/losses.py): -SI-SNR, -SNR and L1 per batch
element, PIT as the least mean loss over every assignment of estimates
to references, and MixIT's least loss over every assignment of estimated
sources to two mixtures."""

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


def mixit_losses(loss_fn, ests, mixtures, lengths=None):
    """ests, a list of M (B, S) estimates; mixtures, a list of two (B, S)
    -> (B, 2^M): for each assignment in bit order (bit i set: source i
    goes to mixture 1) the mean of the two mixtures' losses against their
    summed sources."""
    M = len(ests)
    est = torch.stack(ests, dim=1)                       # (B, M, S)
    losses = []
    for bits in range(2 ** M):
        sel = torch.tensor([(bits >> i) & 1 for i in range(M)],
                           dtype=est.dtype, device=est.device)
        mix1 = torch.einsum("m,bms->bs", sel, est)
        mix0 = torch.einsum("m,bms->bs", 1.0 - sel, est)
        losses.append((loss_fn(mix0, mixtures[0], lengths)
                       + loss_fn(mix1, mixtures[1], lengths)) / 2.0)
    return torch.stack(losses, dim=1)


def mixit_loss(loss_fn, ests, mixtures, lengths=None):
    """Mixture-invariant training -> (the least of ``mixit_losses`` (B,),
    its assignment (B,)). Ties go to the first, as JAX's argmin."""
    losses = mixit_losses(loss_fn, ests, mixtures, lengths)
    best = torch.argmin(losses, dim=1)
    return losses.gather(1, best[:, None])[:, 0], best
