"""Fused attention: the flash-attention CUDA kernels and their plain versions.

Counterpart of espnet_tpu/ops/attention_kernels.py:fused_attention and of
the VJP of the Pallas flash attention it reaches on the TPU. On a CUDA
tensor the forward launches ``flash_attn_fwd`` (csrc/flash_attn.cu); when
a gradient is wanted it runs as a ``torch.autograd.Function`` whose
backward launches ``flash_attn_bwd`` (csrc/flash_attn_bwd.cu: one dk/dv/dS
kernel, then one dq kernel). Both read q, k and v through their strides
(the conformer's are views of its projections), so nothing is copied
before them. On a CPU tensor it runs
``fused_attention_plain``, the same math in plain torch, whose gradient is
torch's own autograd.

``fused_attention_bwd`` is the backward's wrapper: the kernels on a CUDA
tensor, ``fused_attention_bwd_plain`` on a CPU one, the same arithmetic in
plain torch (recompute of P from the forward's row statistics, dS, and
the four gradients).
"""

from __future__ import annotations

import torch

from espnet_tpu_torch.ops import _cuda

NEG_MASK = -1e9


def _causal_allowed(Tq: int, Tk: int, device) -> torch.Tensor:
    """Key j is allowed for query i iff j <= i + Tk - Tq."""
    return torch.ones(Tq, Tk, dtype=torch.bool, device=device).tril(Tk - Tq)


def _scores(q, k, bias, causal, sm_scale):
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    if bias is not None:
        scores = scores + bias
    if causal:
        allowed = _causal_allowed(*scores.shape[-2:], q.device)
        scores = scores.masked_fill(~allowed, NEG_MASK)
    return scores


def fused_attention_plain(q, k, v, bias=None, *, causal: bool = False,
                          sm_scale: float = 1.0):
    """softmax(q k^T * sm_scale + bias) v over (B, H, T, d) tensors.

    bias broadcasts to (B, H, Tq, Tk); with ``causal`` key j is allowed
    for query i iff j <= i + Tk - Tq, and masked scores become -1e9.
    """
    attn = torch.softmax(_scores(q, k, bias, causal, sm_scale), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", attn.to(v.dtype), v)


def softmax_stats_plain(q, k, bias=None, *, causal: bool = False,
                        sm_scale: float = 1.0):
    """The forward kernel's row statistics: (B, H, Tq, 2) holding each
    row's score max m and log of its sum of exp(score - m)."""
    scores = _scores(q, k, bias, causal, sm_scale)
    m = scores.amax(dim=-1)
    logl = torch.log(torch.exp(scores - m[..., None]).sum(dim=-1))
    return torch.stack([m, logl], dim=-1)


def fused_attention_bwd_plain(q, k, v, bias, out, stats, dout, *,
                              causal: bool = False, sm_scale: float = 1.0):
    """The backward kernels' arithmetic -> (dq, dk, dv, dS), dS being the
    gradient of the bias broadcast to (B, H, Tq, Tk)."""
    scores = _scores(q, k, bias, causal, sm_scale)
    p = torch.exp(scores - stats[..., :1] - stats[..., 1:])
    D = (dout * out).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dout, v) - D)
    if causal:
        ds = ds.masked_fill(~_causal_allowed(*ds.shape[-2:], q.device), 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * sm_scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout)
    return dq, dk, dv, ds


def _check(q, k, v, bias):
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, d) or v.shape != (B, H, Tk, d):
        raise ValueError(f"fused_attention: shapes {q.shape} {k.shape} "
                         f"{v.shape}")
    if d > 128 or B * H > 65535:
        raise ValueError(f"fused_attention: kernel takes d <= 128 and "
                         f"B*H <= 65535, got d={d}, B*H={B * H}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32
                              or t.device != q.device):
            raise ValueError(f"fused_attention: {name} must be float32 on "
                             f"{q.device}, got {t.dtype} on {t.device}")


def _bias_args(bias, shape):
    """Pointer and (B, H, Tq, Tk) strides of the bias; broadcast dims get
    stride 0."""
    if bias is None:
        return None, (0, 0, 0, 0)
    bias = bias.expand(shape)
    return bias.data_ptr(), bias.stride()


def _head_contiguous(*ts):
    """The kernels read any batch, head and time strides but need the
    head dimension contiguous."""
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in ts)


def _launch_fwd(q, k, v, bias, causal, sm_scale, with_stats: bool):
    """The forward kernel on q, k, v with any batch, head and time strides
    (the head dimension is made contiguous where it is not) -> out
    (B, H, Tq, d) and, with_stats, the row statistics (B, H, Tq, 2)."""
    q, k, v = _head_contiguous(q, k, v)
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    out = torch.empty(B, H, Tq, d, dtype=torch.float32, device=q.device)
    stats = (torch.empty(B, H, Tq, 2, dtype=torch.float32, device=q.device)
             if with_stats else None)
    bias_ptr, strides = _bias_args(bias, (B, H, Tq, Tk))
    err = _cuda.lib().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
        None if stats is None else stats.data_ptr(), B, H, Tq, Tk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *strides,
        int(causal), float(sm_scale), _cuda.stream_ptr(q.device))
    _cuda.check(err, "flash_attn_fwd")
    _cuda.LAUNCHES["flash_attn_fwd"] += 1
    return out, stats


def fused_attention_bwd(q, k, v, bias, out, stats, dout, *,
                        causal: bool = False, sm_scale: float = 1.0):
    """Given the forward's inputs, its output and row statistics and the
    output gradient -> (dq, dk, dv, dS), dS (B, H, Tq, Tk) being the bias
    gradient before any broadcast is summed out."""
    if q.device.type == "cpu":
        return fused_attention_bwd_plain(q, k, v, bias, out, stats, dout,
                                         causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"fused_attention_bwd: no kernel for {q.device}")
    _check(q, k, v, bias)
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    for name, t, shape in (("out", out, q.shape), ("dout", dout, q.shape),
                           ("stats", stats, (B, H, Tq, 2))):
        if (t.shape != shape or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"fused_attention_bwd: {name} must be float32 "
                             f"{tuple(shape)} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not all(t.is_contiguous() for t in (out, stats, dout)):
        raise ValueError("fused_attention_bwd: out, stats and dout must be "
                         "contiguous")
    q, k, v = _head_contiguous(q, k, v)
    dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device=q.device)
                  for t in (q, k, v))
    ds = torch.empty(B, H, Tq, Tk, dtype=torch.float32, device=q.device)
    bias_ptr, strides = _bias_args(bias, (B, H, Tq, Tk))
    stream = _cuda.stream_ptr(q.device)
    lib = _cuda.lib()
    err = lib.flash_attn_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
        dout.data_ptr(), stats.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ds.data_ptr(), B, H, Tq, Tk, d, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *strides, int(causal), float(sm_scale), stream)
    _cuda.check(err, "flash_attn_bwd_dkv")
    _cuda.LAUNCHES["flash_attn_bwd"] += 1
    err = lib.flash_attn_bwd_dq(ds.data_ptr(), k.data_ptr(), dq.data_ptr(),
                                B, H, Tq, Tk, d, *k.stride()[:3],
                                float(sm_scale), stream)
    _cuda.check(err, "flash_attn_bwd_dq")
    _cuda.LAUNCHES["flash_attn_bwd"] += 1
    return dq, dk, dv, ds


class FlashAttention(torch.autograd.Function):
    """The forward kernel, saving its row statistics, and the backward
    kernels as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale):
        q, k, v = _head_contiguous(q, k, v)
        out, stats = _launch_fwd(q, k, v, bias, causal, sm_scale, True)
        ctx.save_for_backward(q, k, v, bias, out, stats)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, stats = ctx.saved_tensors
        dq, dk, dv, ds = fused_attention_bwd(
            q, k, v, bias, out, stats, dout.contiguous(), causal=ctx.causal,
            sm_scale=ctx.sm_scale)
        # a padding-only bias arrives broadcast: sum dS back to its shape
        dbias = (ds.sum_to_size(bias.shape) if ctx.needs_input_grad[3]
                 else None)
        return dq, dk, dv, dbias, None, None


def fused_attention(q, k, v, bias=None, *, causal: bool = False,
                    sm_scale: float = 1.0):
    """q (B, H, Tq, d), k and v (B, H, Tk, d), bias broadcastable to
    (B, H, Tq, Tk) additive -> (B, H, Tq, d).

    On the card, the forward kernel alone runs when no input needs a
    gradient (or under ``torch.no_grad``): then nothing is saved.
    """
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, bias, causal=causal,
                                     sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"fused_attention: no kernel for {q.device}")
    _check(q, k, v, bias)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return FlashAttention.apply(q, k, v, bias, causal, sm_scale)
    out, _ = _launch_fwd(q, k, v, bias, causal, sm_scale, False)
    return out
