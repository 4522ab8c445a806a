"""Times of the port's kernels at the paths' shapes, for any checkout.

From seeded random data, at the shapes of the paths that run them:

- ``banded_attn_fwd`` (K4) at the long-form decode shape (4, 4, 3339, 64)
  with 2168-2228 valid frames and at the train shape (4, 4, 2189, 64) with
  2148-2189, W = 64, on q, k, v given as the encoder gives them: views of
  (B, T, H * d) projections; beside SDPA with the band and the valid keys
  as a float mask, and with its bound (the larger of its bytes at 3.35
  TB/s and its allowed pairs' operations at the 3xTF32 rate, 165
  TFLOP/s);
- ``rnnt_alpha`` and ``rnnt_beta`` (K3) on (25, 145, 65) lattices, with
  every sample's lattice full (T_b + U_b = 209 diagonals) and with ragged
  lengths;
- ``fused_attention_bwd`` (K1b) at the flagship's train shape (25, 4, 145,
  64) with an f32 bias plus padding, and ``banded_attention_bwd`` (K4b) at
  the long-form train shape, each beside SDPA's autograd backward on the
  same inputs;
- ``fused_attention`` (K1) at the flagship's decode shape (64, 4, 145, 64)
  and at the Conformer separator's (10, 4, 501, 32), and K1b at the
  separator's train shape (8, 4, 501, 32), each against its plain
  version (``attention_fwd_row``, ``attention_bwd_row``: chip_smoke.py
  holds K1 and K1b at the separator's own inputs with them).

For each: the mean of 20 calls by CUDA events around the wrapper (its host
time included), and torch.profiler's device time of each kernel over 10
calls. ``--root`` times the kernels of another checkout of the repository
(a parent commit beside this one, in one process each). One card; prints
one JSON line, with the card's name and power limit:

    python3 espnet_tpu_torch/tools/kernel_times.py [--root DIR]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


HBM_BYTES_PER_S = 3.35e12
FP32_TC_FLOPS = 495e12 / 3  # fp32-accurate 3xTF32 products


def device_times(torch, fn, n: int = 10) -> list:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [{"kernel": e.key[:120], "ms": e.device_time_total / n / 1e3}
            for e in prof.key_averages() if e.device_time_total > 0]


def event_ms(torch, fn, n: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def timed(torch, kernel, library=None) -> dict:
    dev = device_times(torch, kernel)
    out = {"ms": event_ms(torch, kernel),
           "device_ms": sum(e["ms"] for e in dev), "device_kernels": dev}
    if library is not None:
        lib = device_times(torch, library)
        out |= {"library_ms": event_ms(torch, library),
                "library_device_ms": sum(e["ms"] for e in lib),
                "library_device_kernels": lib}
    return out


def attention_fwd_row(torch, q, k, v, bias, scale: float) -> dict:
    """K1 on (q, k, v, bias): its largest error against the plain
    version, whether two launches give the same output and row
    statistics, its times (``timed``) beside SDPA's with the bias as a
    float mask and the plain version's, its bytes and operations."""
    import torch.nn.functional as F

    from espnet_tpu_torch.ops import attention
    B, H, T, d = q.shape
    with torch.no_grad():
        def fwd():
            return attention.fused_attention(q, k, v, bias, sm_scale=scale)

        def plain():
            return attention.fused_attention_plain(q, k, v, bias,
                                                   sm_scale=scale)

        o1, s1 = attention._launch_fwd(q, k, v, bias, False, scale, True)
        o2, s2 = attention._launch_fwd(q, k, v, bias, False, scale, True)
        row = {"shape": [B, H, T, d],
               "max_abs_err": float((fwd() - plain()).abs().max()),
               "same_bits_twice": bool(torch.equal(o1, o2)
                                       and torch.equal(s1, s2)),
               "plain_ms": event_ms(torch, plain),
               "library_note": "scaled_dot_product_attention with the "
                               "float bias as attn_mask",
               "flops": 4.0 * B * H * T * T * d,
               "bytes": 4.0 * (4 * B * H * T * d + bias.numel())}
        del o1, s1, o2, s2
        return row | timed(torch, fwd, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, scale=scale))


def attention_bwd_row(torch, q, k, v, bias, dout, scale: float) -> dict:
    """K1b on (q, k, v, bias) and dout: each gradient through the
    kernels' autograd against the plain version's (its largest error, and
    that over the plain one's largest entry), the sum over the keys of dk
    over dk's largest entry for both (zero in exact arithmetic: the
    gradient of a key bias under the softmax), whether two launches give
    the same bits, its times (``timed``) beside SDPA's autograd backward
    with the bias needing a gradient and the plain version's, its bytes
    and operations."""
    import torch.nn.functional as F

    from espnet_tpu_torch.ops import attention
    B, H, T, d = q.shape
    grads = {}
    for route, fn in (("kernel", attention.fused_attention),
                      ("plain", attention.fused_attention_plain)):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (q, k, v, bias)]
        grads[route] = torch.autograd.grad(fn(*leaves, sm_scale=scale),
                                           leaves, dout)
    with torch.no_grad():
        out = attention.fused_attention_plain(q, k, v, bias, sm_scale=scale)
        stats = attention.softmax_stats_plain(q, k, bias, sm_scale=scale)

    def bwd():
        return attention.fused_attention_bwd(q, k, v, bias, out, stats,
                                             dout, sm_scale=scale)

    def plain():
        return attention.fused_attention_bwd_plain(q, k, v, bias, out,
                                                   stats, dout,
                                                   sm_scale=scale)

    lib_ins = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
    lib_out = F.scaled_dot_product_attention(*lib_ins[:3],
                                             attn_mask=lib_ins[3],
                                             scale=scale)
    errors = {n: {"max_abs_err": float((a - b).abs().max()),
                  "rel_err": float((a - b).abs().max() / b.abs().max())}
              for n, a, b in zip(("dq", "dk", "dv", "dbias"),
                                 grads["kernel"], grads["plain"])}
    row = {"shape": [B, H, T, d], "errors": errors,
           "max_abs_err": max(e["max_abs_err"] for e in errors.values()),
           "key_sum_over_max": {
               r: float(g_[1].sum(2).abs().max() / g_[1].abs().max())
               for r, g_ in grads.items()},
           "same_bits_twice": all(torch.equal(a, b)
                                  for a, b in zip(bwd(), bwd())),
           "plain_ms": event_ms(torch, plain),
           "library_note": "autograd backward of scaled_dot_product_attention"
                           " with the float bias needing a gradient",
           "flops": 10.0 * B * H * T * T * d,
           "bytes": 4.0 * (8 * B * H * T * d + 2 * B * H * T * T)}
    del grads
    return row | timed(torch, bwd, lambda: torch.autograd.grad(
        lib_out, lib_ins, dout, retain_graph=True))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parents[2])
    args = parser.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    import torch.nn.functional as F

    from espnet_tpu_torch.ops import attention, banded_attention, rnnt
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no card")
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(args.root), "nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]}

    H, d, W = 4, 64, 64
    scale = d ** -0.5
    for name, T, lens in (("decode", 3339, [2228, 2200, 2168, 2190]),
                          ("train", 2189, [2189, 2180, 2160, 2148])):
        # (B, H, T, d) views of (B, T, H, d) projections
        q, k, v = (torch.randn(4, T, H, d, generator=g, device="cuda")
                   .transpose(1, 2) for _ in range(3))
        valid = (torch.arange(T, device="cuda")[None]
                 < torch.tensor(lens, device="cuda")[:, None])
        allowed = banded_attention.banded_allowed(T, W, valid, "cuda")
        mask = torch.where(allowed, 0.0, -1e9)
        # the least work: 4 d operations per allowed pair on the tensor
        # cores' 3xTF32 rate, q, k, v and out moved once with the valid
        # bytes
        t_ops = 4.0 * d * H * float(allowed.sum()) / FP32_TC_FLOPS * 1e3
        t_bytes = (4.0 * 4 * 4 * H * T * d + 4 * T) / HBM_BYTES_PER_S * 1e3
        with torch.no_grad():
            out[f"banded_attn_fwd_{name}"] = timed(
                torch, lambda: banded_attention.banded_attention(
                    q, k, v, W, valid, sm_scale=scale),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale)) | {
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        del mask, allowed

    B, T, U1, V = 25, 145, 65, 25
    logits = torch.randn(B, T, U1, V, generator=g, device="cuda")
    labels = torch.randint(1, V, (B, U1 - 1), generator=g, device="cuda")
    for name, tl, ul in (
            ("full", torch.full((B,), T, device="cuda"),
             torch.full((B,), U1 - 1, device="cuda")),
            ("ragged", torch.randint(20, 42, (B,), generator=g,
                                     device="cuda"),
             torch.randint(5, 18, (B,), generator=g, device="cuda"))):
        lat = rnnt.lattices(logits, labels, tl, ul)
        out[f"rnnt_{name}"] = {"diagonals": int((tl + ul).max())} | {
            sweep: timed(torch, lambda f=getattr(rnnt, sweep): f(*lat, tl,
                                                                  ul))
            for sweep in ("rnnt_alpha", "rnnt_beta")}

    B, T = 25, 145
    q, k, v, dout = (torch.randn(B, H, T, d, generator=g, device="cuda")
                     for _ in range(4))
    lens = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
    bias = (torch.randn(B, H, T, T, generator=g, device="cuda")
            + torch.where(torch.arange(T, device="cuda")[None]
                          < lens[:, None], 0.0, -1e9)[:, None, None, :])
    with torch.no_grad():
        o = attention.fused_attention_plain(q, k, v, bias, sm_scale=scale)
        stats = attention.softmax_stats_plain(q, k, bias, sm_scale=scale)
    ins = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    lib_out = F.scaled_dot_product_attention(*ins[:3], attn_mask=ins[3],
                                             scale=scale)
    out["flash_attn_bwd"] = timed(
        torch,
        lambda: attention.fused_attention_bwd(q, k, v, bias, o, stats, dout,
                                              sm_scale=scale),
        lambda: torch.autograd.grad(lib_out, ins, dout, retain_graph=True))

    Bb, Tb = 4, 2189
    bq, bk, bv, bdout = (torch.randn(Bb, H, Tb, d, generator=g,
                                     device="cuda") for _ in range(4))
    valid = (torch.arange(Tb, device="cuda")[None]
             < torch.tensor([2189, 2180, 2160, 2148], device="cuda")[:, None])
    bdout = bdout * valid[:, None, :, None]
    with torch.no_grad():
        bo = banded_attention.banded_attention_plain(bq, bk, bv, W, valid,
                                                     sm_scale=scale)
        bstats = banded_attention.banded_stats_plain(bq, bk, W, valid,
                                                     sm_scale=scale)
    mask = torch.where(banded_attention.banded_allowed(Tb, W, valid, "cuda"),
                       0.0, -1e9)
    bins = [t.clone().requires_grad_() for t in (bq, bk, bv)]
    blib_out = F.scaled_dot_product_attention(*bins, attn_mask=mask,
                                              scale=scale)
    out["banded_attn_bwd"] = timed(
        torch,
        lambda: banded_attention.banded_attention_bwd(
            bq, bk, bv, valid, bo, bstats, bdout, window=W, sm_scale=scale),
        lambda: torch.autograd.grad(blib_out, bins, bdout,
                                    retain_graph=True))

    for name, (B, T, d_) in (("flash_attn_fwd_decode", (64, 145, 64)),
                             ("flash_attn_fwd_separator", (10, 501, 32))):
        q, k, v = (torch.randn(B, H, T, d_, generator=g, device="cuda")
                   for _ in range(3))
        bias = torch.randn(B, H, T, T, generator=g, device="cuda")
        out[name] = attention_fwd_row(torch, q, k, v, bias, d_ ** -0.5)
    q, k, v, dout = (torch.randn(8, H, 501, 32, generator=g, device="cuda")
                     for _ in range(4))
    bias = torch.randn(8, H, 501, 501, generator=g, device="cuda")
    out["flash_attn_bwd_separator"] = attention_bwd_row(
        torch, q, k, v, bias, dout, 32 ** -0.5)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
