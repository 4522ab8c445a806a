"""Fused attention: the flash-attention CUDA kernel and its plain version.

Counterpart of espnet_tpu/ops/attention_kernels.py:fused_attention. On a
CUDA tensor it launches ``flash_attn_fwd`` (csrc/flash_attn.cu); on a CPU
tensor it runs ``fused_attention_plain``, the same math in plain torch.
"""

from __future__ import annotations

import torch

from espnet_tpu_torch.ops import _cuda

NEG_MASK = -1e9


def fused_attention_plain(q, k, v, bias=None, *, causal: bool = False,
                          sm_scale: float = 1.0):
    """softmax(q k^T * sm_scale + bias) v over (B, H, T, d) tensors.

    bias broadcasts to (B, H, Tq, Tk); with ``causal`` key j is allowed
    for query i iff j <= i + Tk - Tq, and masked scores become -1e9.
    """
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    if bias is not None:
        scores = scores + bias
    if causal:
        Tq, Tk = scores.shape[-2:]
        allowed = torch.ones(Tq, Tk, dtype=torch.bool,
                             device=q.device).tril(Tk - Tq)
        scores = scores.masked_fill(~allowed, NEG_MASK)
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


def fused_attention(q, k, v, bias=None, *, causal: bool = False,
                    sm_scale: float = 1.0):
    """q (B, H, Tq, d), k and v (B, H, Tk, d), bias broadcastable to
    (B, H, Tq, Tk) additive -> (B, H, Tq, d)."""
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, bias, causal=causal,
                                     sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"fused_attention: no kernel for {q.device}")
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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if bias is not None:
        bias = bias.expand(B, H, Tq, Tk)  # broadcast dims get stride 0
        strides = bias.stride()
        bias_ptr = bias.data_ptr()
    else:
        strides = (0, 0, 0, 0)
        bias_ptr = None
    err = _cuda.lib().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
        B, H, Tq, Tk, d, *strides, int(causal), float(sm_scale),
        _cuda.stream_ptr(q.device))
    _cuda.check(err, "flash_attn_fwd")
    _cuda.LAUNCHES["flash_attn_fwd"] += 1
    return out
