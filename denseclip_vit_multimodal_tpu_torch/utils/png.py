"""PNG decode and encode with zlib and numpy alone (no Pillow).

The JAX package decodes and encodes through Pillow; the port's server and
its Cityscapes readers take PNG through this module, so they run on a
machine that has no Pillow.

* `read_header` parses the IHDR chunk only (the size is known before any
  pixel is inflated, for the server's decompression-bomb guard).
* `decode_png` takes 8-bit, non-interlaced gray, gray + alpha, RGB, RGBA and
  palette images and returns uint8 RGB [H, W, 3], as Pillow's
  `convert("RGB")` does: gray is replicated, alpha dropped, palette indices
  looked up (indices past the palette read black).
* `decode_png_array` returns the samples as the file holds them, as
  `np.asarray(Image.open(...))` does: 8-bit gray uint8 [H, W], 16-bit gray
  uint16 [H, W] (big-endian in the file), 8-bit RGB uint8 [H, W, 3] (gray +
  alpha and RGBA [H, W, 2 | 4], palette images their indices [H, W]).  It
  reads Cityscapes' labels and disparity maps raw.
* Both undo all five row filters on BYTES, with bpp = channels x bytes per
  sample (2 for 16-bit gray): None / Sub / Up row by row, any image with
  Average or Paeth rows (what most encoders write for photographs) by
  anti-diagonals.  Other bit depths, interlacing, and images whose unfilter
  would take more than `MAX_UNFILTER_STEPS` numpy steps raise `ValueError`.
* `encode_png` writes uint8 RGB [H, W, 3], uint8 gray [H, W] or uint16 gray
  [H, W] with filter 0 on every row, and, where `text` is given, one tEXt
  chunk per (keyword, value) pair between IHDR and IDAT; `read_text` reads
  them back.
"""

from __future__ import annotations

import functools
import struct
import zlib
from typing import Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
from numpy.lib.stride_tricks import as_strided

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples per pixel
_SPAN = 511  # byte differences lie in [-255, 255]
# The unfilter loops in Python over rows (H steps) or anti-diagonals (H + W - 1):
# a strip of millions of 1-pixel rows inflates from a few hundred KB and
# would hold a core for minutes.  A 1024x2048 frame takes 3071 steps.
MAX_UNFILTER_STEPS = 32768


class PNGHeader(NamedTuple):
    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _chunks(data: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """(type, body) of every chunk up to IEND, CRCs checked."""
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG: chunk {ctype!r} runs past the data")
        body = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4
    raise ValueError("truncated PNG: no IEND chunk")


def read_header(data: bytes) -> PNGHeader:
    """The IHDR fields of a PNG (nothing is inflated)."""
    if not is_png(data):
        raise ValueError("not a PNG")
    if len(data) < 33 or data[12:16] != b"IHDR":
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", data[16:29])
    return PNGHeader(width, height, depth, ctype, interlace)


@functools.lru_cache(maxsize=None)
def _predictor_table() -> np.ndarray:
    """Predictor minus c of every filter type t for the byte differences
    da = a - c and db = b - c (a left, b up, c upper left), flat at
    t * 511**2 + (da + 255) * 511 + (db + 255).  Sub predicts a = c + da, Up
    b = c + db, Average floor((a + b) / 2) = c + floor((da + db) / 2), and
    Paeth (p = a + b - c, so |p - a| = |db|, |p - b| = |da|, |p - c| =
    |da + db|) a, b or c.  None predicts 0, which is not c plus a function of
    (da, db): its entry is 0 and its rows drop c."""
    d = np.arange(-255, 256)
    da, db = np.broadcast_arrays(d[:, None], d[None, :])
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
    paeth = np.where((pa <= pb) & (pa <= pc), da, np.where(pb <= pc, db, 0))
    return np.stack([np.zeros_like(da), da, db, (da + db) >> 1, paeth]).astype(np.int32).ravel()


def _unfilter_rows(ftypes: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Filters None / Sub / Up only: one vectorised step per row."""
    out = np.empty_like(rows)
    prev = np.zeros(rows.shape[1], np.uint8)
    for r, ftype in enumerate(ftypes):
        cur = rows[r]
        if ftype == 1:
            cur = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = cur + prev  # uint8: wraps mod 256
        out[r] = cur
        prev = out[r]
    return out


def _unfilter_wavefront(ftypes: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of the five filters.  Average and Paeth depend on the pixel to
    the left, so no row can be undone in one vector step; every pixel depends
    only on its left, upper and upper-left neighbours, so all pixels of one
    anti-diagonal r + x = d are undone together (H + W - 1 steps of about ten
    numpy calls each, one predictor lookup for every filter type).  Diagonal
    d is read and written through strided views of the input and output; the
    last two diagonals are kept in buffers indexed by row + 1, whose cells
    outside the image stay 0, the PNG border."""
    h = rows.shape[0]
    w = rows.shape[1] // bpp

    def diagonals(x: np.ndarray) -> np.ndarray:  # [d, r, channel] -> x[r, (d - r) * bpp + channel]
        row, col = x.strides
        return as_strided(x, (h + w - 1, h, bpp), (bpp * col, row - bpp * col, col))

    out = np.empty((h, w * bpp), np.uint8)
    filt_d, out_d = diagonals(rows), diagonals(out)
    types = np.repeat(ftypes.astype(np.int32)[:, None], bpp, axis=1)
    offset = types * _SPAN**2 + 255 * _SPAN + 255
    keep_c = (types != 0).astype(np.int32)
    nones = np.concatenate([[0], np.cumsum(ftypes == 0)])  # None rows before each row
    table = _predictor_table()
    diag = [np.zeros((h + 1, bpp), np.int32) for _ in range(3)]
    idx, tmp = np.empty((h, bpp), np.int32), np.empty((h, bpp), np.int32)
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1  # rows of this diagonal
        cur, prev, prev2 = diag[d % 3], diag[(d - 1) % 3], diag[(d - 2) % 3]
        a, b, c = prev[lo + 1:hi + 1], prev[lo:hi], prev2[lo:hi]
        i, j = idx[:hi - lo], tmp[:hi - lo]
        np.subtract(a, c, out=i)
        np.multiply(i, _SPAN, out=i)
        np.subtract(b, c, out=j)
        np.add(i, j, out=i)
        np.add(i, offset[lo:hi], out=i)
        np.take(table, i, out=j, mode="clip")  # in range by construction
        v = cur[lo + 1:hi + 1]
        np.add(filt_d[d, lo:hi], j, out=v)
        if nones[hi] != nones[lo]:
            c = np.multiply(c, keep_c[lo:hi], out=j)
        np.add(v, c, out=v)
        np.bitwise_and(v, 255, out=v)
        out_d[d, lo:hi] = v
    return out


def _decode_samples(data: bytes, gray16: bool
                    ) -> Tuple[PNGHeader, np.ndarray, Optional[np.ndarray]]:
    """PNG bytes -> (header, samples [H, W, channels]; uint8, or uint16 for
    16-bit gray where `gray16`, palette [n, 3] or None).  Palette images give
    their indices: the caller looks them up."""
    hdr = read_header(data)
    depth_ok = hdr.bit_depth == 8 or (gray16 and hdr.bit_depth == 16 and hdr.color_type == 0)
    if not depth_ok or hdr.color_type not in _CHANNELS or hdr.interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {hdr.bit_depth}, color type "
                         f"{hdr.color_type}, interlace {hdr.interlace} (8-bit"
                         f"{' or 16-bit gray' if gray16 else ''}, non-interlaced only)")
    if hdr.width < 1 or hdr.height < 1:
        raise ValueError(f"PNG of size {hdr.width}x{hdr.height}")
    idat, palette = [], None
    for ctype, body in _chunks(data):
        if ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    if hdr.color_type == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    ch = _CHANNELS[hdr.color_type]
    bpp = ch * hdr.bit_depth // 8  # bytes per pixel: the filters' unit
    stride = 1 + hdr.width * bpp
    need = hdr.height * stride
    try:
        inflate = zlib.decompressobj()
        raw = inflate.decompress(b"".join(idat), need)  # never inflate past the image
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from None
    if len(raw) < need:
        raise ValueError(f"truncated PNG data: {len(raw)} of {need} bytes")
    rows = np.frombuffer(raw, np.uint8).reshape(hdr.height, stride)
    ftypes, filtered = rows[:, 0], rows[:, 1:]
    if ftypes.max() > 4:
        raise ValueError(f"PNG row filter {int(ftypes.max())} does not exist")
    by_rows = ftypes.max() <= 2
    steps = hdr.height if by_rows else hdr.height + hdr.width - 1
    if steps > MAX_UNFILTER_STEPS:
        raise ValueError(f"PNG of {hdr.height}x{hdr.width} would take {steps} unfilter steps "
                         f"(at most {MAX_UNFILTER_STEPS})")
    unfilter = _unfilter_rows if by_rows else _unfilter_wavefront
    px = unfilter(ftypes, filtered, bpp)  # bytes; samples only after the unfilter
    if hdr.bit_depth == 16:
        px = px.view(">u2").astype(np.uint16)
    return hdr, px.reshape(hdr.height, hdr.width, ch), palette


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 RGB [H, W, 3]."""
    hdr, px, palette = _decode_samples(data, gray16=False)
    if hdr.color_type == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if px.shape[-1] <= 2:  # gray, gray + alpha
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def decode_png_array(data: bytes) -> np.ndarray:
    """PNG bytes -> the samples as stored: [H, W] for gray and palette
    images (uint16 at bit depth 16), else [H, W, channels] uint8."""
    _, px, _ = _decode_samples(data, gray16=True)
    return px[..., 0] if px.shape[-1] == 1 else px


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(
        ">I", zlib.crc32(ctype + body))


def read_text(data: bytes) -> Dict[str, str]:
    """The tEXt chunks of a PNG as {keyword: text} (Latin-1), in file order."""
    if not is_png(data):
        raise ValueError("not a PNG")
    out = {}
    for ctype, body in _chunks(data):
        if ctype == b"tEXt":
            key, _, value = body.partition(b"\0")
            out[key.decode("latin-1")] = value.decode("latin-1")
    return out


def _text_chunk(key: str, value: str) -> bytes:
    kw = key.encode("latin-1")
    if not 1 <= len(kw) <= 79 or b"\0" in kw or kw != kw.strip() or b"  " in kw:
        raise ValueError(f"invalid PNG tEXt keyword {key!r}")
    return _chunk(b"tEXt", kw + b"\0" + value.encode("latin-1"))


def encode_png(image: np.ndarray, level: int = 6,
               text: Optional[Sequence[Tuple[str, str]]] = None) -> bytes:
    """uint8 RGB [H, W, 3], uint8 gray [H, W] or uint16 gray [H, W] -> PNG
    bytes (filter 0, zlib `level`).  `text`: (keyword, value) pairs written
    as tEXt chunks before the image data; without it the bytes are those of
    the image alone."""
    gray16 = image.dtype == np.uint16 and image.ndim == 2
    if not gray16 and (image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[-1] != 3)):
        raise ValueError(f"encode_png takes uint8 [H, W, 3], uint8 [H, W] or uint16 [H, W], "
                         f"got {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    color_type = 2 if image.ndim == 3 else 0
    rows = np.ascontiguousarray(image.astype(">u2") if gray16 else image).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.reshape(h, -1)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 16 if gray16 else 8, color_type, 0, 0, 0)
    return (SIGNATURE
            + _chunk(b"IHDR", ihdr)
            + b"".join(_text_chunk(k, v) for k, v in (text or ()))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))
