"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``espnet_tpu_torch/csrc`` include only CUDA headers and
expose plain ``extern "C"`` entry points. On first use they are compiled
with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per source, all started
together, then one link) into ``espnet_tpu_torch/_build/`` and loaded
with ``ctypes``. A hash of the sources and flags decides whether to
rebuild; a file lock keeps concurrent processes from building at once.

Every wrapper that launches a kernel adds one to ``LAUNCHES[name]`` at
the launch, and nowhere else, so a run can show which kernels its path
went through.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
LIB_NAME = "libespnet_tpu_torch_kernels.so"
SOURCES = ("flash_attn.cu", "flash_attn_bwd.cu", "logmel.cu", "rnnt.cu",
           "banded_attn.cu", "banded_attn_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

LAUNCHES = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "logmel_fwd": 0,
            "rnnt_alpha": 0, "rnnt_beta": 0, "banded_attn_fwd": 0,
            "banded_attn_bwd": 0}

_lib = None
BUILD_SECONDS = None  # wall time of the build this process ran, if any


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def _build(nvcc: str, digest: str):
    objs = [BUILD / (Path(name).stem + ".o") for name in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / name),
                               "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for name, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    for name, p, log in zip(SOURCES, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
    tmp = BUILD / (LIB_NAME + ".tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                           "-o", str(tmp)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    tmp.replace(BUILD / LIB_NAME)
    for obj in objs:
        obj.unlink()
    (BUILD / "sources.sha256").write_text(digest)


def build() -> Path:
    """Build the kernel library if its sources changed; return its path."""
    global BUILD_SECONDS
    BUILD.mkdir(exist_ok=True)
    digest = _source_hash()
    so = BUILD / LIB_NAME
    stamp = BUILD / "sources.sha256"
    with open(BUILD / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (so.exists() and stamp.exists()
                    and stamp.read_text() == digest):
                t0 = time.perf_counter()
                _build(_nvcc(), digest)
                BUILD_SECONDS = time.perf_counter() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(build()))
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        f32 = ctypes.c_float
        L.flash_attn_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                     i64, i64, i64, i64, i, f32, p]
        L.flash_attn_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                         i, i, i, i, i, i64, i64, i64, i64,
                                         i, f32, p]
        L.flash_attn_bwd_dq.argtypes = [p, p, p, i, i, i, i, i, f32, p]
        for fn in (L.flash_attn_fwd, L.flash_attn_bwd_dkv,
                   L.flash_attn_bwd_dq):
            fn.restype = i
        L.logmel_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        L.logmel_fwd.restype = i
        L.rnnt_alpha.argtypes = [p, p, p, p, p, p, i, i, i, p]
        L.rnnt_beta.argtypes = [p, p, p, p, p, i, i, i, p]
        L.rnnt_alpha.restype = L.rnnt_beta.restype = i
        L.banded_attn_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f32,
                                      p]
        L.banded_attn_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i,
                                          i, i, f32, p]
        L.banded_attn_bwd_dq.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                         i, f32, p]
        for fn in (L.banded_attn_fwd, L.banded_attn_bwd_dkv,
                   L.banded_attn_bwd_dq):
            fn.restype = i
        _lib = L
    return _lib


def check(err: int, name: str):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
