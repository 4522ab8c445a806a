"""The chain floor of the RNN-T sweeps (csrc/rnnt.cu, K3), read on the card.

A sweep's anti-diagonals depend each on the one before, so a sweep over D
diagonals takes at least D times the latency of one diagonal's dependent
step: the shuffle that brings the neighbouring lane's cell, then the
cell's two adds and log-add (``alpha_cell``, ``beta_cell``; a lane's other
cells are independent of it). This script compiles a probe that includes
csrc/rnnt.cu and runs those device functions on one warp for STEPS
dependent diagonals, one cell a lane, every cell inside the lattice and
its lattice entries already in registers (so no load is on the chain),
and times the loop by clock64 in SM cycles. It also disassembles the probe
(cuobjdump -sass) and counts the instructions of one diagonal, the loop
body between the two clock reads, by opcode; and it reads the SM clock
that nvidia-smi reports. A sweep's chain floor is then D_max * cycles /
clocks.max.sm, D_max the longest sample's T_b + U_b. Run it where the CUDA
toolkit and a card are, from the repository root:

    python3 -m espnet_tpu_torch.tools.rnnt_chain

It prints one JSON line; ``measure`` returns the same dictionary.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

from espnet_tpu_torch.ops import _cuda

STEPS = 4096

PROBE = r"""
#include "rnnt.cu"

namespace {

template <bool ALPHA>
__global__ void chain_probe(const float* in, float* out, long long* cycles,
                            int steps) {
  const int lane = threadIdx.x, big = 1 << 29;
  float x = in[lane];
  const float xb = in[32 + lane], xe = in[64 + lane];
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
    const float y = __shfl_sync(FULL, x, (lane + (ALPHA ? 31 : 1)) & 31);
    if (ALPHA)
      x = alpha_cell(x, lane > 0 ? y : NEG, xb, xe, big + i - lane, lane,
                     2 * big, 2 * big);
    else
      x = beta_cell(x, lane < 31 ? y : NEG, xb, xe, big - i - lane, lane,
                    2 * big, 2 * big);
  }
  const long long t1 = clock64();
  out[lane] = x;
  if (lane == 0) *cycles = t1 - t0;
}

}  // namespace

extern "C" int rnnt_chain_probe(const float* in, float* out,
                                long long* cycles, int steps, int alpha) {
  if (alpha)
    chain_probe<true><<<1, 32>>>(in, out, cycles, steps);
  else
    chain_probe<false><<<1, 32>>>(in, out, cycles, steps);
  return (int)cudaGetLastError();
}
"""


def loop_opcodes(sass: str) -> dict:
    """Opcodes between the two clock reads of each probe function: one
    diagonal's step, plus the loop's counter and branch."""
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n")[0]
        if "chain_probe" not in name:
            continue
        kind = "alpha" if "ILb1E" in name else "beta"
        ops = [re.match(r"(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", line).group(1)
               for line in (re.sub(r"^/\*[0-9a-f]+\*/\s*", "", raw.strip())
                            for raw in func.split("\n")
                            if re.search(r"/\*[0-9a-f]{4}\*/", raw))
               if re.match(r"(?:@!?U?P\w+\s+)?[A-Z]", line)]
        clocks = [i for i, op in enumerate(ops) if op.startswith("CS2R")]
        body = ops[clocks[0] + 1:clocks[-1]] if len(clocks) >= 2 else []
        out[kind] = {"instructions": len(body),
                     "by_opcode": dict(Counter(op.split(".")[0]
                                               for op in body))}
    return out


def measure() -> dict:
    """-> cycles per diagonal of each sweep, the probe loop's SASS opcodes,
    and the SM clocks nvidia-smi reports."""
    import torch
    nvcc = _cuda._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        src, so = Path(tmp) / "probe.cu", Path(tmp) / "probe.so"
        src.write_text(PROBE)
        subprocess.run([nvcc, *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-shared", str(src), "-o",
                        str(so)], check=True, capture_output=True)
        sass = subprocess.run(
            [str(Path(nvcc).parent / "cuobjdump"), "-sass", str(so)],
            capture_output=True, text=True,
            check=True).stdout
        lib = ctypes.CDLL(str(so))
        lib.rnnt_chain_probe.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int]
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.rand(96, generator=g, device="cuda").log()
        x[:32] = 0.0
        y = torch.empty(32, device="cuda")
        cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
        out = {"steps": STEPS}
        for kind, flag in (("alpha", 1), ("beta", 0)):
            per = []
            for _ in range(3):   # the first run loads the code
                _cuda.check(lib.rnnt_chain_probe(
                    x.data_ptr(), y.data_ptr(), cycles.data_ptr(), STEPS,
                    flag), "rnnt_chain_probe")
                torch.cuda.synchronize()
                per.append(int(cycles.item()) / STEPS)
            if not torch.isfinite(y).all():
                raise RuntimeError("rnnt_chain_probe: non-finite cells")
            out[f"{kind}_cycles_per_diagonal"] = min(per[1:])
        del lib
    out["sass"] = loop_opcodes(sass)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out["clocks_sm_mhz"], out["clocks_max_sm_mhz"] = (
        float(f) for f in clocks.split(","))
    return out


def main():
    print(json.dumps(measure()), flush=True)


if __name__ == "__main__":
    main()
