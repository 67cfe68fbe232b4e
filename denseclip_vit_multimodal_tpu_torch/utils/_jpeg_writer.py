"""A small baseline JPEG encoder in numpy; private, not an API of the port.

The card has no Pillow, so `chip_smoke.py` writes its ADE20K tree with this,
and the tests hold the port's decoder to Pillow on its files.  One
interleaved scan of a JFIF file: YCbCr at 4:2:0 (2x2 means of the
edge-padded frame), the orthonormal 8x8 DCT, Annex K's quantisation tables
scaled by `quality` as libjpeg scales them, and Annex K's Huffman tables.
The entropy coding is vectorised: every block's symbols are built at once,
sorted into stream order and packed into bits with numpy.
"""

from __future__ import annotations

import struct

import numpy as np

# zigzag position -> natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
    92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.full(64, 99)
CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19, 24, 25, 26, 27]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 99, 47, 66, 99, 99]

# Annex K.3: (bits[1..16], values) of the DC / AC luminance and chrominance tables
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25"
    "262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a83"
    "8485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3"
    "d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718"
    "191a262728292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a"
    "82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9ca"
    "d2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    d[0] /= np.sqrt(2)
    return d


def _scaled(table: np.ndarray, quality: int) -> np.ndarray:
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((table * scale + 50) // 100, 1, 255)


def _codes(spec):
    """Canonical Huffman codes: (code, length) arrays indexed by symbol."""
    bits, values = spec
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            code_of[values[k]], len_of[values[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _bit_length(v: np.ndarray) -> np.ndarray:
    a = np.abs(v)
    return np.where(a == 0, 0, np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) + 1)


def _amplitude_bits(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, v, v + (1 << size) - 1)


def _blocks(plane: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Quantised coefficients [rows, cols, 64] of a plane whose sides are
    multiples of 8, in zigzag order."""
    h, w = plane.shape
    d = _dct_matrix()
    b = (plane - 128.0).reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("ij,rcjk,lk->rcil", d, b, d).reshape(h // 8, w // 8, 64)
    return np.rint(coef / quant[None, None, :]).astype(np.int64)[..., ZIGZAG]


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def encode_jpeg(image: np.ndarray, quality: int = 90) -> bytes:
    """uint8 RGB [H, W, 3] -> baseline JFIF JPEG bytes at 4:2:0."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes uint8 [H, W, 3], got {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    rgb = np.pad(image.astype(np.float64), ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    down = lambda p: p.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3))
    q_luma, q_chroma = _scaled(LUMA_Q, quality), _scaled(CHROMA_Q, quality)
    yb = _blocks(y, q_luma)  # [2 my, 2 mx, 64]
    cbb, crb = _blocks(down(cb), q_chroma), _blocks(down(cr), q_chroma)
    my, mx = ph // 16, pw // 16
    # stream order: per MCU four Y blocks (row-major), Cb, Cr
    y_mcu = yb.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
    seq = np.concatenate([y_mcu, cbb.reshape(-1, 1, 64), crb.reshape(-1, 1, 64)], axis=1)
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    seq = seq.reshape(-1, 64)
    chroma = comp > 0
    nseq = len(seq)

    dc = seq[:, 0].copy()
    diff = np.empty_like(dc)
    for c in range(3):
        sel = comp == c
        diff[sel] = np.diff(dc[sel], prepend=0)

    dc_tab = [_codes(DC_LUMA), _codes(DC_CHROMA)]
    ac_tab = [_codes(AC_LUMA), _codes(AC_CHROMA)]

    def coded(sym, tab_chroma, tabs, extra, extra_len):
        code = np.where(tab_chroma, tabs[1][0][sym], tabs[0][0][sym])
        length = np.where(tab_chroma, tabs[1][1][sym], tabs[0][1][sym])
        return (code << extra_len) | extra, length + extra_len

    keys, vals, lens = [], [], []
    # DC
    size = _bit_length(diff)
    v, n = coded(size, chroma, dc_tab, _amplitude_bits(diff, size), size)
    keys.append(np.arange(nseq) * 256)
    vals.append(v)
    lens.append(n)
    # AC: each nonzero coefficient, with the ZRLs its run needs before it
    blk, pos = np.nonzero(seq[:, 1:])
    pos = pos + 1
    coef = seq[blk, pos]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.roll(pos, 1))
    run = pos - prev - 1
    size = _bit_length(coef)
    v, n = coded(((run % 16) << 4) | size, chroma[blk], ac_tab, _amplitude_bits(coef, size), size)
    keys.append(blk * 256 + 2 * pos + 1)
    vals.append(v)
    lens.append(n)
    n_zrl = run // 16
    zblk = np.repeat(blk, n_zrl)
    zkey = np.repeat(blk * 256 + 2 * pos, n_zrl)
    v, n = coded(np.full(len(zblk), 0xF0), chroma[zblk], ac_tab, 0, 0)
    keys.append(zkey)
    vals.append(v)
    lens.append(n)
    # EOB where the block's last nonzero is before position 63
    last = np.zeros(nseq, np.int64)
    np.maximum.at(last, blk, pos)
    eob = np.nonzero(last < 63)[0]
    v, n = coded(np.zeros(len(eob), np.int64), chroma[eob], ac_tab, 0, 0)
    keys.append(eob * 256 + 200)
    vals.append(v)
    lens.append(n)

    order = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[order]
    lens = np.concatenate(lens)[order].astype(np.int64)
    total = int(lens.sum())
    starts = np.cumsum(lens) - lens
    item = np.repeat(np.arange(len(lens)), lens)
    offset = np.arange(total) - starts[item]
    bits = ((vals[item] >> (lens[item] - 1 - offset)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])  # pad with 1-bits
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    data = np.insert(data, ff + 1, 0).astype(np.uint8)  # byte stuffing

    out = [b"\xff\xd8",
           _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
           _segment(0xFFDB, bytes([0]) + bytes(q_luma[ZIGZAG].astype(np.uint8))
                    + bytes([1]) + bytes(q_chroma[ZIGZAG].astype(np.uint8))),
           _segment(0xFFC0, struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1,
                                                                      3, 0x11, 1]))]
    for cls_id, spec in ((0x00, DC_LUMA), (0x10, AC_LUMA), (0x01, DC_CHROMA), (0x11, AC_CHROMA)):
        out.append(_segment(0xFFC4, bytes([cls_id]) + bytes(spec[0]) + bytes(spec[1])))
    out.append(_segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.append(data.tobytes())
    out.append(b"\xff\xd9")
    return b"".join(out)
