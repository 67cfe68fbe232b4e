"""Host image I/O without Pillow: a baseline JPEG decoder and Pillow's
BILINEAR / NEAREST resize, in C++ (`native/imageio.cc` inside this package).

The JAX package reads ADE20K through Pillow (`Image.open(jpg).convert("RGB")`,
`.resize(..., BILINEAR)`, the label's `.resize(..., NEAREST)`); the card has
no Pillow, so the port computes the same pixels itself:

* `read_jpeg_header(data) -> JpegHeader(width, height, components, mode)`
  parses up to the frame header only (the server's decompression-bomb guard);
* `decode_jpeg(data) -> uint8 [H, W, 3]` equals Pillow's `convert("RGB")`
  (libjpeg-turbo's islow IDCT, fancy upsampling and colour tables);
  `UnsupportedJPEG` (a `ValueError`) names a mode it refuses: progressive,
  lossless, hierarchical or arithmetic-coded files, 12-bit samples,
  4-component (CMYK / YCCK) files, sampling other than 4:4:4 / 4:2:2 / 4:2:0;
* `resize_bilinear_u8(img, (w, h))` and `resize_nearest(img, (w, h))` equal
  Pillow's `Image.resize((w, h), BILINEAR | NEAREST)`.

At first use the source is compiled with g++ (`-O3 -fPIC -shared -std=c++17
-ffp-contract=off`) into `build/host/` at the root of the checkout, under a
name that carries a hash of the source and the flags.  There is no fallback:
a failed build raises `RuntimeError` with g++'s message.  The ctypes calls
release the GIL, so the loader's decode threads run them in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).resolve().parents[1] / "native" / "imageio.cc"
BUILD_DIR = ROOT / "build" / "host"
CXX_FLAGS = ("-O3", "-Wall", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")

_OK, _UNSUPPORTED = 0, 1
_ERRLEN = 256


class UnsupportedJPEG(ValueError):
    """A JPEG mode the port's decoder does not decode (Pillow does)."""


class JpegHeader(NamedTuple):
    width: int
    height: int
    components: int
    mode: str  # "baseline", "extended", "progressive", ...; "+ N-bit" off 8 bits


class _Library:
    def __init__(self):
        self.lock = threading.Lock()
        self.lib: Optional[ctypes.CDLL] = None


_LIBRARY = _Library()


def _build() -> Path:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's JPEG decoder and resize need it")
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"libimageio-{digest}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        tmp.replace(path)  # atomic: a concurrent loader sees all or nothing
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, sz, i32 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    lib.imageio_jpeg_header.argtypes = [p, sz, p, ctypes.c_char_p, sz, ctypes.c_char_p, sz]
    lib.imageio_jpeg_decode.argtypes = [p, sz, p, sz, ctypes.c_char_p, sz]
    lib.imageio_resize_bilinear_u8.argtypes = [p, i32, i32, i32, p, i32, i32]
    lib.imageio_resize_nearest.argtypes = [p, i32, i32, i32, p, i32, i32]
    for fn in (lib.imageio_jpeg_header, lib.imageio_jpeg_decode,
               lib.imageio_resize_bilinear_u8, lib.imageio_resize_nearest):
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built at the first call; raises if it cannot be."""
    state = _LIBRARY
    if state.lib is None:
        with state.lock:
            if state.lib is None:
                state.lib = _declare(ctypes.CDLL(str(_build())))
    return state.lib


def _raise(code: int, err) -> None:
    message = err.value.decode(errors="replace")
    if code == _UNSUPPORTED:
        raise UnsupportedJPEG(f"{message} is not decoded by the port's JPEG decoder")
    raise ValueError(f"cannot decode JPEG: {message}")


def is_jpeg(data: bytes) -> bool:
    return data[:3] == b"\xff\xd8\xff"


def read_jpeg_header(data: bytes) -> JpegHeader:
    """Size, component count and mode from the markers up to the frame header."""
    lib = library()
    data = bytes(data)
    info = np.zeros(4, np.int32)
    mode = ctypes.create_string_buffer(32)
    err = ctypes.create_string_buffer(_ERRLEN)
    code = lib.imageio_jpeg_header(data, len(data), info.ctypes.data, mode, 32, err, _ERRLEN)
    if code != _OK:
        _raise(code, err)
    kind = mode.value.decode()
    if int(info[3]) != 8:
        kind += f" {int(info[3])}-bit"
    return JpegHeader(int(info[0]), int(info[1]), int(info[2]), kind)


def decode_jpeg(data: bytes) -> np.ndarray:
    """uint8 [H, W, 3], as Pillow's `Image.open(...).convert("RGB")` gives it."""
    lib = library()
    data = bytes(data)
    hdr = read_jpeg_header(data)
    out = np.empty((hdr.height, hdr.width, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    code = lib.imageio_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes, err, _ERRLEN)
    if code != _OK:
        _raise(code, err)
    return out


def _size(size: Tuple[int, int]) -> Tuple[int, int]:
    w, h = (int(s) for s in size)
    if w < 1 or h < 1:
        raise ValueError(f"resize to {w}x{h}: both sides must be at least 1")
    return w, h


def resize_bilinear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Pillow's `Image.resize(size, BILINEAR)` of uint8 [H, W] or [H, W, C]
    (C <= 4); `size` is (width, height), as Pillow takes it."""
    w, h = _size(size)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and not
                                                           1 <= img.shape[2] <= 4):
        raise ValueError(f"resize_bilinear_u8 takes uint8 [H, W] or [H, W, C<=4], got "
                         f"{img.dtype} {img.shape}")
    img = np.ascontiguousarray(img)
    channels = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty((h, w) + img.shape[2:], np.uint8)
    if library().imageio_resize_bilinear_u8(img.ctypes.data, img.shape[1], img.shape[0],
                                            channels, out.ctypes.data, w, h) != _OK:
        raise MemoryError("resize_bilinear_u8: out of memory")
    return out


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Pillow's `Image.resize(size, NEAREST)` of [H, W] or [H, W, C] of any
    dtype; `size` is (width, height)."""
    w, h = _size(size)
    if img.ndim not in (2, 3):
        raise ValueError(f"resize_nearest takes [H, W] or [H, W, C], got {img.shape}")
    img = np.ascontiguousarray(img)
    pixel_bytes = img.itemsize * (1 if img.ndim == 2 else img.shape[2])
    out = np.empty((h, w) + img.shape[2:], img.dtype)
    if library().imageio_resize_nearest(img.ctypes.data, img.shape[1], img.shape[0],
                                        pixel_bytes, out.ctypes.data, w, h) != _OK:
        raise MemoryError("resize_nearest: out of memory")
    return out
