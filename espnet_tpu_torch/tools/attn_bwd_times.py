"""Device times of the attention backward kernels at the paths' shapes.

Times ``fused_attention_bwd`` (K1b) at the flagship's train shape (25, 4,
145, 64) with an f32 bias plus padding, ``banded_attention_bwd`` (K4b) at
the long-form train shape (4, 4, 2189, 64), W = 64, 2148-2189 valid
frames, and SDPA's autograd backward on the same inputs, from seeded
random data: the mean of 20 calls by CUDA events around the wrapper, and
torch.profiler's device time of each kernel over 10 calls. ``--root``
times the kernels of another checkout of the repository (for a parent
commit beside this one, in one process each). One card; prints one JSON
line, with the card's name and power limit:

    python3 espnet_tpu_torch/tools/attn_bwd_times.py [--root DIR]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


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


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parents[2])
    args = parser.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    import torch.nn.functional as F

    from espnet_tpu_torch.ops import attention, banded_attention
    if not torch.cuda.is_available():
        sys.exit("attn_bwd_times: no card")
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(args.root), "nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]}

    B, H, T, d = 25, 4, 145, 64
    scale = d ** -0.5
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
    cases = {"flash_attn_bwd": (
        lambda: attention.fused_attention_bwd(q, k, v, bias, o, stats, dout,
                                              sm_scale=scale),
        lambda: torch.autograd.grad(lib_out, ins, dout, retain_graph=True))}

    Bb, Tb, W = 4, 2189, 64
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
    cases["banded_attn_bwd"] = (
        lambda: banded_attention.banded_attention_bwd(
            bq, bk, bv, valid, bo, bstats, bdout, window=W, sm_scale=scale),
        lambda: torch.autograd.grad(blib_out, bins, bdout,
                                    retain_graph=True))
    for name, (kernel, library) in cases.items():
        dev = device_times(torch, kernel)
        lib = device_times(torch, library)
        out[name] = {"ms": event_ms(torch, kernel),
                     "device_ms": sum(e["ms"] for e in dev),
                     "device_kernels": dev,
                     "library_ms": event_ms(torch, library),
                     "library_device_ms": sum(e["ms"] for e in lib),
                     "library_device_kernels": lib}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
