"""ctypes binding of the host ops in `native/hostops.cc` (the port's copy of
the JAX package's `data/_native.py`).

At first use the source is compiled with g++ and the flags of
`native/Makefile` (`-O3 -Wall -fPIC -shared -std=c++17`) into `build/host/`
at the root of the checkout, under a name that carries a hash of the source
and the flags, so an edited source is rebuilt.  Nothing under `native/` is
written, and its tracked library is never loaded.  Every entry point returns
None when the library is unavailable (no compiler, a failed build): the
callers then take their numpy versions, as in the JAX package.  The ctypes
calls release the GIL, so the loader's decode threads run them in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "hostops.cc"
BUILD_DIR = ROOT / "build" / "host"
CXX_FLAGS = ("-O3", "-Wall", "-fPIC", "-shared", "-std=c++17")


class _Library:
    """The library, built and loaded once per process; `error` says why it
    is not there."""

    def __init__(self):
        self.lock = threading.Lock()
        self.tried = False
        self.lib: Optional[ctypes.CDLL] = None
        self.path: Optional[Path] = None
        self.error: Optional[str] = None


_LIBRARY = _Library()


def _build() -> Path:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"libhostops-{digest}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        tmp.replace(path)  # atomic: a concurrent loader sees all or nothing
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.remap_labels_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint8]
    lib.remap_labels_u8.restype = None
    lib.disparity_to_depth_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t] + [
        ctypes.c_float] * 6
    lib.disparity_to_depth_f32.restype = ctypes.c_size_t
    lib.normalize_u8_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                     ctypes.c_void_p, ctypes.c_void_p]
    lib.normalize_u8_f32.restype = None
    return lib


def library() -> Optional[ctypes.CDLL]:
    """The loaded library, building it at the first call; None if it cannot be."""
    state = _LIBRARY
    if state.tried:
        return state.lib
    with state.lock:
        if not state.tried:
            try:
                state.path = _build()
                state.lib = _declare(ctypes.CDLL(str(state.path)))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                state.error = f"{type(e).__name__}: {e}"
            state.tried = True  # last: the unlocked check above reads it
    return state.lib


def status() -> dict:
    """Whether the library is loaded, from which file, or why not."""
    lib = library()
    return {"loaded": lib is not None,
            "path": None if _LIBRARY.path is None else str(_LIBRARY.path),
            "error": _LIBRARY.error}


def remap_labels(labels: np.ndarray, table: np.ndarray, ignore: int = 255
                 ) -> Optional[np.ndarray]:
    """Native labelId -> trainId remap; None if the library is unavailable."""
    lib = library()
    if lib is None:
        return None
    labels = np.ascontiguousarray(labels, dtype=np.uint8)
    table = np.ascontiguousarray(table, dtype=np.uint8)
    out = np.empty_like(labels)
    lib.remap_labels_u8(labels.ctypes.data, out.ctypes.data, labels.size,
                        table.ctypes.data, table.size, ignore)
    return out


def disparity_to_depth(disparity: np.ndarray, depth_max: float, bf: float,
                       scale: float = 256.0, offset: float = 1.0, min_scaled: float = 1e-3,
                       ignore_value: float = 0.0) -> Optional[Tuple[np.ndarray, int]]:
    """Native fused disparity -> depth; (depth, n_valid), or None if the
    library is unavailable."""
    lib = library()
    if lib is None:
        return None
    disparity = np.ascontiguousarray(disparity, dtype=np.uint16)
    depth = np.empty(disparity.shape, np.float32)
    n_valid = lib.disparity_to_depth_f32(disparity.ctypes.data, depth.ctypes.data,
                                         disparity.size, bf, depth_max, scale, offset,
                                         min_scaled, ignore_value)
    return depth, int(n_valid)


def normalize_image(image: np.ndarray, mean, std) -> Optional[np.ndarray]:
    """Native fused uint8 HWC -> CLIP-normalised float32; None if the library
    is unavailable or the image has no 3 channels.  No path of the port calls
    it yet: training and serving normalise on the device
    (`data/augment.py::normalize_image`); it waits for a host-normalise path."""
    lib = library()
    if lib is None or image.shape[-1] != 3:
        return None
    image = np.ascontiguousarray(image, dtype=np.uint8)
    out = np.empty(image.shape, np.float32)
    mean = np.ascontiguousarray(mean, dtype=np.float32)
    inv_std = np.ascontiguousarray(1.0 / np.asarray(std, np.float32))
    lib.normalize_u8_f32(image.ctypes.data, out.ctypes.data, image.size // 3,
                         mean.ctypes.data, inv_std.ctypes.data)
    return out
