"""Check in the SASS that the attention kernels round their scores as the
backward recomputes them.

The backward kernels (csrc/attn_bwd.cuh) recompute each score as a chain of
fmaf over d, then round the product with ``sm_scale`` and the sum with the
bias apart (``__fmul_rn``, ``__fadd_rn``); the banded forward
(csrc/banded_attn.cu) rounds its scores as the banded backward does, the
product with ``sm_scale`` alone. nvcc contracts a product and a sum into
one FFMA unless told not to; this script shows that it did not: it
compiles each source for sm_90a, disassembles it with ``cuobjdump -sass``,
follows every register loaded from ``sm_scale`` (the last field of
``BwdArgs``, the last parameter of ``banded_attn_fwd_kernel``) and lists
the instructions that read it. Run it where the CUDA toolkit is, from the
repository root:

    python3 -m espnet_tpu_torch.tools.sass_check

It prints one JSON line per dk/dv kernel and per banded forward kernel,
and exits non-zero if any of them reads ``sm_scale`` with anything but
FMUL.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

from espnet_tpu_torch.ops import _cuda

PARAM_BASE = 0x210  # the kernel parameters' offset in constant bank 0, sm_90


class _Strides(ctypes.Structure):
    _fields_ = [(n, ctypes.c_longlong) for n in ("b", "h", "t")]


class _BwdArgs(ctypes.Structure):
    """csrc/attn_bwd.cuh:BwdArgs, for the offset of sm_scale."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "o", "dout", "stats", "dq", "dk", "dv", "ds",
        "bias")]
        + [(n, ctypes.c_longlong) for n in ("bsb", "bsh", "bsq", "bsk")]
        + [("valid", ctypes.c_void_p)]
        + [(n, _Strides) for n in ("qs", "ks", "vs")]
        + [(n, ctypes.c_int) for n in ("H", "Tq", "Tk", "d", "causal", "W",
                                       "nw16")]
        + [("sm_scale", ctypes.c_float)])


class _BandedFwdParams(ctypes.Structure):
    """The parameters of csrc/banded_attn.cu:banded_attn_fwd_kernel, for
    the offset of sm_scale."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "valid", "out", "stats")]
        + [(n, ctypes.c_int) for n in ("H", "T", "d", "W", "nw16")]
        + [(n, _Strides) for n in ("qs", "ks", "vs")]
        + [("sm_scale", ctypes.c_float)])


# each source, the kernels to check in it and where their sm_scale lies
CHECKED = (("flash_attn_bwd.cu", r"attn_bwd_dkv_kernelI\w+E",
            _BwdArgs.sm_scale.offset),
           ("banded_attn_bwd.cu", r"attn_bwd_dkv_kernelI\w+E",
            _BwdArgs.sm_scale.offset),
           ("banded_attn.cu", r"banded_attn_fwd_kernelI\w+E",
            _BandedFwdParams.sm_scale.offset))


def readers_of(sass_lines, const: str) -> Counter:
    """Opcodes of the instructions that read a register loaded from the
    constant ``const`` (e.g. ``c[0x0][0x2f4]``), or a copy of it, until it
    is redefined."""
    bank, off = re.match(r"(c\[0x0\]\[)(0x[0-9a-f]+)\]", const).groups()
    pair = f"{bank}{int(off, 16) - 4:#x}]"  # a 64-bit load ending at const
    found, held = Counter(), set()
    for line in sass_lines:
        m = re.match(r"(?:@!?U?P\w+\s+)?(\S+)\s+(.*);", line)
        if not m:
            continue
        op, args = m.groups()
        regs = [a.strip().replace(".reuse", "") for a in args.split(",")]
        if op.split(".")[0] in ("LDC", "ULDC") and const in args:
            held.add(regs[0])
            continue
        if op in ("LDC.64", "ULDC.64") and pair in args:
            name, num = re.match(r"(\D+)(\d+)", regs[0]).groups()
            held.add(f"{name}{int(num) + 1}")
            continue
        base = op.split(".")[0]
        # SHFL writes its second operand, after a predicate
        dest, srcs = ((regs[1], regs[2:]) if base == "SHFL"
                      else (regs[0] if regs else None, regs[1:]))
        reads = [r for r in held if r in srcs]
        if base in ("MOV", "IMAD") and reads and (
                base == "MOV" or op.startswith("IMAD.MOV")):
            held.add(regs[0])  # a copy: follow it
            continue
        found.update(base for _ in reads)
        held.discard(dest)
        if const in args:
            found[op.split(".")[0]] += 1
    return found


def main() -> int:
    nvcc = _cuda._nvcc()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for src, pattern, offset in CHECKED:
            const = f"c[0x0][{PARAM_BASE + offset:#x}]"
            obj = Path(tmp) / (src + ".o")
            subprocess.run([nvcc, *_cuda.NVCC_FLAGS, "-c",
                            str(_cuda.CSRC / src), "-o", str(obj)],
                           check=True)
            sass = subprocess.run([cuobjdump, "-sass", str(obj)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            found = 0
            for func in re.split(r"\n\s*Function : ", sass)[1:]:
                kernel = re.search(pattern, func.split("\n")[0])
                if kernel is None:
                    continue
                found += 1
                lines = [re.sub(r"^/\*[0-9a-f]+\*/\s*|\s*/\*[^*]*\*/\s*$",
                                "", line.strip())
                         for line in func.split("\n")
                         if re.search(r"/\*[0-9a-f]{4}\*/", line)]
                readers = readers_of(lines, const)
                good = bool(readers) and set(readers) == {"FMUL"}
                ok &= good
                print(json.dumps({
                    "source": src,
                    "kernel": kernel.group(0), "sm_scale": const,
                    "read_by": dict(readers),
                    "ffma_free": good}))
            ok &= found > 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
