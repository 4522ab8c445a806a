"""Banded (Longformer) attention: the CUDA kernels and their plain versions.

Counterpart of espnet_tpu/ops/attention_kernels.py:banded_attention, which
on the TPU reaches the Pallas splash-attention kernel with a local mask
(``_splash_banded_kernel``) and its VJP. Query i attends key j when
|i - j| <= window and ``valid[b, j]``. On a CUDA tensor the forward
launches ``banded_attn_fwd`` (csrc/banded_attn.cu) at every T, on q, k, v
as the caller gives them (any batch, head and time strides); when a
gradient is wanted it runs as a ``torch.autograd.Function`` whose backward
launches ``banded_attn_bwd`` (csrc/banded_attn_bwd.cu: one dk/dv kernel
that also writes the band's dS into a scratch, then one dq kernel that
reads it). On a CPU tensor it runs ``banded_attention_plain``,
the dense masked softmax at O(T^2) memory, whose gradient is torch's own
autograd.

A query row with no allowed key (only a padded row further than
``window`` from every valid key can have one) gives 0 and takes no
gradient, in the kernels and in the plain versions alike. The JAX
package's two routes differ on such rows; valid rows are the same in all.
"""

from __future__ import annotations

import torch

from espnet_tpu_torch.ops import _cuda
from espnet_tpu_torch.ops.attention import _head_contiguous

NEG_MASK = -1e9


def banded_allowed(T: int, window: int, valid=None, device=None):
    """(B or 1, 1, T, T) bool: key j is allowed for query i iff
    |i - j| <= window and valid[b, j]."""
    pos = torch.arange(T, device=device)
    allowed = ((pos[:, None] - pos[None, :]).abs() <= window)[None, None]
    if valid is not None:
        allowed = allowed & valid[:, None, None, :].bool()
    return allowed


def _scores(q, k, window, valid, sm_scale):
    allowed = banded_allowed(q.shape[2], window, valid, q.device)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    return scores, allowed


def banded_attention_plain(q, k, v, window: int, valid=None, *,
                           sm_scale: float = 1.0):
    """softmax over the allowed keys of (q k^T) * sm_scale, times v, over
    (B, H, T, d) tensors; valid (B, T) bool or None. Masked scores are
    -1e9; a row with no allowed key gives 0."""
    scores, allowed = _scores(q, k, window, valid, sm_scale)
    attn = torch.softmax(scores.masked_fill(~allowed, NEG_MASK), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", attn.to(v.dtype), v)
    return out.masked_fill(~allowed.any(dim=-1, keepdim=True), 0.0)


def banded_stats_plain(q, k, window: int, valid=None, *,
                       sm_scale: float = 1.0):
    """The forward kernel's row statistics, (B, H, T, 2): the max m of
    each row's allowed scores and the log of its sum of exp(score - m);
    (0, -inf) for a row with no allowed key."""
    scores, allowed = _scores(q, k, window, valid, sm_scale)
    scores = scores.masked_fill(~allowed, float("-inf"))
    m = scores.amax(dim=-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    logl = torch.log(torch.exp(scores - m[..., None]).sum(dim=-1))
    return torch.stack([m, logl], dim=-1)


def banded_attention_bwd_plain(q, k, v, valid, out, stats, dout, *,
                               window: int, sm_scale: float = 1.0):
    """The backward kernels' arithmetic -> (dq, dk, dv): P recomputed from
    the row statistics on the allowed keys (0 elsewhere),
    D = rowsum(dout * out), dS = P * (dout v^T - D)."""
    scores, allowed = _scores(q, k, window, valid, sm_scale)
    logits = scores - stats[..., :1] - stats[..., 1:]
    p = torch.exp(logits.masked_fill(~allowed, float("-inf")))
    D = (dout * out).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dout, v) - D)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * sm_scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout)
    return dq, dk, dv


def _check(q, k, v, valid):
    B, H, T, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"banded_attention: shapes {q.shape} {k.shape} "
                         f"{v.shape}")
    if d > 128 or B * H > 65535:
        raise ValueError(f"banded_attention: kernel takes d <= 128 and "
                         f"B*H <= 65535, got d={d}, B*H={B * H}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"banded_attention: {name} must be float32 on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if valid is not None and (valid.shape != (B, T)
                              or valid.device != q.device):
        raise ValueError(f"banded_attention: valid must be ({B}, {T}) on "
                         f"{q.device}, got {tuple(valid.shape)} on "
                         f"{valid.device}")


def _valid_arg(valid):
    """The kernels read valid as one byte per frame, nonzero = valid, or
    all valid: a bool or uint8 mask as it is, anything else as uint8."""
    if valid is None:
        return None, None
    if valid.dtype not in (torch.bool, torch.uint8):
        valid = valid.to(torch.uint8)
    valid = valid.contiguous()
    return valid, valid.data_ptr()


def _launch_fwd(q, k, v, valid, window, sm_scale, with_stats: bool):
    """The forward kernel on q, k, v with any batch, head and time strides
    (the head dimension is made contiguous where it is not) -> out
    (B, H, T, d) and, with_stats, the row statistics (B, H, T, 2)."""
    q, k, v = _head_contiguous(q, k, v)
    B, H, T, d = q.shape
    out = torch.empty(B, H, T, d, dtype=torch.float32, device=q.device)
    stats = (torch.empty(B, H, T, 2, dtype=torch.float32, device=q.device)
             if with_stats else None)
    valid, valid_ptr = _valid_arg(valid)
    err = _cuda.lib().banded_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr, out.data_ptr(),
        None if stats is None else stats.data_ptr(), B, H, T, d,
        int(window), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(sm_scale), _cuda.stream_ptr(q.device))
    _cuda.check(err, "banded_attn_fwd")
    _cuda.LAUNCHES["banded_attn_fwd"] += 1
    return out, stats


def banded_attention_bwd(q, k, v, valid, out, stats, dout, *, window: int,
                         sm_scale: float = 1.0):
    """Given the forward's inputs, its output and row statistics and the
    output gradient -> (dq, dk, dv)."""
    if q.device.type == "cpu":
        return banded_attention_bwd_plain(q, k, v, valid, out, stats, dout,
                                          window=window, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"banded_attention_bwd: no kernel for {q.device}")
    _check(q, k, v, valid)
    B, H, T, d = q.shape
    for name, t, shape in (("out", out, q.shape), ("dout", dout, q.shape),
                           ("stats", stats, (B, H, T, 2))):
        if (t.shape != shape or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"banded_attention_bwd: {name} must be float32 "
                             f"{tuple(shape)} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not all(t.is_contiguous() for t in (out, stats, dout)):
        raise ValueError("banded_attention_bwd: out, stats and dout must be "
                         "contiguous")
    q, k, v = _head_contiguous(q, k, v)
    dq, dk, dv = (torch.empty(B, H, T, d, dtype=torch.float32,
                              device=q.device) for _ in range(3))
    lib = _cuda.lib()
    # the band's dS, written by the first kernel and read by the second
    ds = torch.empty(lib.banded_attn_bwd_scratch(B, H, T, int(window)),
                     dtype=torch.float32, device=q.device)
    valid, valid_ptr = _valid_arg(valid)
    stream = _cuda.stream_ptr(q.device)
    err = lib.banded_attn_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr, out.data_ptr(),
        dout.data_ptr(), stats.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ds.data_ptr(), B, H, T, d, int(window), *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], float(sm_scale), stream)
    _cuda.check(err, "banded_attn_bwd_dkv")
    _cuda.LAUNCHES["banded_attn_bwd"] += 1
    err = lib.banded_attn_bwd_dq(ds.data_ptr(), k.data_ptr(), dq.data_ptr(),
                                 B, H, T, d, int(window), *k.stride()[:3],
                                 float(sm_scale), stream)
    _cuda.check(err, "banded_attn_bwd_dq")
    _cuda.LAUNCHES["banded_attn_bwd"] += 1
    return dq, dk, dv


class BandedAttention(torch.autograd.Function):
    """The forward kernel, saving its row statistics, and the backward
    kernels as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, valid, window, sm_scale):
        # both kernels read q, k, v through their strides
        q, k, v = _head_contiguous(q, k, v)
        out, stats = _launch_fwd(q, k, v, valid, window, sm_scale, True)
        ctx.save_for_backward(q, k, v, valid, out, stats)
        ctx.window, ctx.sm_scale = window, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid, out, stats = ctx.saved_tensors
        dq, dk, dv = banded_attention_bwd(
            q, k, v, valid, out, stats, dout.contiguous(),
            window=ctx.window, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None


def banded_attention(q, k, v, window: int, valid=None, *,
                     sm_scale: float = 1.0):
    """q, k, v (B, H, T, d); valid (B, T) bool or None -> (B, H, T, d).

    On the card, the forward kernel alone runs when no input needs a
    gradient (or under ``torch.no_grad``): then nothing is saved.
    """
    if q.device.type == "cpu":
        return banded_attention_plain(q, k, v, window, valid,
                                      sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"banded_attention: no kernel for {q.device}")
    _check(q, k, v, valid)
    if window < 0:
        raise ValueError(f"banded_attention: window {window} < 0")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return BandedAttention.apply(q, k, v, valid, int(window), sm_scale)
    out, _ = _launch_fwd(q, k, v, valid, window, sm_scale, False)
    return out
