"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each kernel source under `csrc/` has a plain C entry point that returns the
launch's `cudaError_t`.  At first use the source is compiled for Hopper
(`sm_90a`) into `build/kernels/` at the root of the checkout, under a name
that carries a hash of the source, the shared headers (`csrc/*.cuh`) and
the flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is.  Nothing is compiled when a
module is imported: the CPU tests import every module and have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

# Every kernel source (csrc/<name>.cu): K1, K2 with K3's backward, K4, K5 and
# its prologue, K3, K6, K4b, K7; then the fp32 kernels of K1, K3 and K4, and
# of K2, K3's backward and K4b.
SOURCES = ("qkv_attention", "qkv_attention_bwd", "flash_attention", "qkv_attention_int8",
           "quantize_qkv_int8", "mha_attention", "ln_qkv_attention", "flash_attention_bwd",
           "qkv_out_attention", "attention_fp32", "attention_bwd_fp32")

_LIBS: Dict[str, ctypes.CDLL] = {}
# Seconds spent in nvcc and its -Xptxas -v report, per library built in this
# process (empty when the library was already on disk).
BUILD_SECONDS: Dict[str, float] = {}
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` once and return the loaded library."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    # every header under csrc/ enters the hash: an edited header rebuilds
    # each library that may include it
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        start = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
        BUILD_SECONDS[name] = time.perf_counter() - start
        BUILD_LOG[name] = proc.stdout + proc.stderr
    _LIBS[name] = ctypes.CDLL(str(lib_path))
    return _LIBS[name]


def build_all() -> None:
    """Compile every source in `SOURCES`, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(load_library, SOURCES))
