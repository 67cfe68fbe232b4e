"""The port's Cityscapes readers against the JAX package's, on the CPU.

Trees are written with Pillow (its adaptive filters choose None, Sub, Up and
Paeth rows) plus one triplet a split whose rows cycle through all five
filters (Pillow never picks Average), so the port's decoder meets every
filter at 1, 2 and 3 bytes per pixel.  The JAX datasets decode with Pillow;
the port's with `utils/png.py`: samples must agree bit for bit.
"""

import io
import os
import os.path as osp
import zlib

import numpy as np
import pytest
from PIL import Image

from denseclip_vit_multimodal_tpu.data import cityscapes as j_cs
from denseclip_vit_multimodal_tpu.data import loader as j_loader
from denseclip_vit_multimodal_tpu_torch.core.config import Config
from denseclip_vit_multimodal_tpu_torch.data import _native
from denseclip_vit_multimodal_tpu_torch.data import cityscapes as t_cs
from denseclip_vit_multimodal_tpu_torch.data import loader as t_loader
from denseclip_vit_multimodal_tpu_torch.utils import png

H, W = 48, 96
ALL_FILTERS = "01234"


def _filtered_png(arr: np.ndarray, ftypes: str) -> bytes:
    """`arr` (uint8 gray / RGB or uint16 gray) as a PNG whose row r carries
    filter ftypes[r % len]; the filters work on bytes (the PNG spec)."""
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    size = arr.dtype.itemsize
    bpp = ch * size
    x = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder(">"))).view(np.uint8)
    x = x.reshape(h, w * bpp).astype(np.int64)
    rows = []
    for r in range(h):
        prev = x[r - 1] if r else np.zeros(w * bpp, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), x[r, :-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = left + prev - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        f = int(ftypes[r % len(ftypes)])
        pred = [0, left, prev, (left + prev) // 2, paeth][f]
        rows.append(np.concatenate([[f], (x[r] - pred) % 256]).astype(np.uint8))
    ihdr = np.array([w, h], ">u4").tobytes() + bytes([8 * size, 2 if ch == 3 else 0, 0, 0, 0])
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(np.stack(rows).tobytes()))
            + png._chunk(b"IEND", b""))


def _row_filters(data: bytes) -> set:
    hdr = png.read_header(data)
    raw = zlib.decompress(b"".join(body for ctype, body in png._chunks(data) if ctype == b"IDAT"))
    return set(np.frombuffer(raw, np.uint8).reshape(hdr.height, -1)[:, 0].tolist())


def _sample_arrays(rs):
    image = rs.randint(0, 256, (H, W, 3), dtype=np.uint8)
    labels = rs.randint(0, 34, (H, W)).astype(np.uint8)
    labels[0, :3] = [34, 200, 255]  # ids past the table -> ignore
    disparity = rs.randint(0, 30000, (H, W)).astype(np.uint16)
    disparity[::7] = 0
    disparity[1, :4] = [1, 2, 257, 65535]  # below the usable scale, and the largest
    return image, labels, disparity


def _write_triplet(root, split, city, base, rs, *, all_filters=False, disparity=True,
                   corrupt_image=False):
    image, labels, disp = _sample_arrays(rs)
    files = [("leftImg8bit", "leftImg8bit", image), ("gtFine", "gtFine_labelIds", labels)]
    if disparity:
        files.append(("disparity", "disparity", disp))
    for top, suffix, arr in files:
        folder = osp.join(root, top, split, city)
        os.makedirs(folder, exist_ok=True)
        path = osp.join(folder, f"{base}_{suffix}.png")
        if corrupt_image and top == "leftImg8bit":
            data = b"\x89PNG\r\n\x1a\nnot actually a png"
        elif all_filters:
            data = _filtered_png(arr, ALL_FILTERS)
        else:
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="PNG")
            data = buf.getvalue()
        with open(path, "wb") as f:
            f.write(data)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """2 cities x 3 train triplets (the third with all five filters), one
    image + labels without disparity, one corrupt image, 2 val triplets."""
    root = str(tmp_path_factory.mktemp("cityscapes"))
    rs = np.random.RandomState(0)
    for city in ("aachen", "bochum"):
        for i in range(3):
            _write_triplet(root, "train", city, f"{city}_00000{i}_000019", rs, all_filters=i == 2)
    _write_triplet(root, "train", "aachen", "aachen_000009_000019", rs, disparity=False)
    _write_triplet(root, "train", "bochum", "bochum_000009_000019", rs, corrupt_image=True)
    for i in range(2):
        _write_triplet(root, "val", "frankfurt", f"frankfurt_00000{i}_000294", rs,
                       all_filters=i == 1)
    return root


def test_tree_covers_every_filter_at_every_depth(tree):
    seen = {}
    for folder, _, files in os.walk(tree):
        for name in files:
            with open(osp.join(folder, name), "rb") as f:
                data = f.read()
            if png.is_png(data) and len(data) > 40:
                hdr = png.read_header(data)
                seen.setdefault((hdr.bit_depth, hdr.color_type), set()).update(_row_filters(data))
    assert seen == {(8, 2): set(range(5)), (8, 0): set(range(5)), (16, 0): set(range(5))}


@pytest.mark.parametrize("kind", ["CityscapesDepthSegDataset", "CityscapesDataset"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_datasets_match_jax_bitwise(tree, kind, split):
    j = getattr(j_cs, kind)(tree, split=split)
    t = getattr(t_cs, kind)(tree, split=split)
    assert t.samples == j.samples
    for idx in range(len(t)):
        a, b = t[idx], j[idx]
        if b is None:  # the corrupt image
            assert a is None and "bochum_000009" in t.samples[idx][0]
            continue
        assert a.keys() == b.keys()
        for key in b:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{kind} {idx} {key}")


def test_scan_skips_misaligned_triplets(tree):
    with_depth = t_cs.CityscapesDepthSegDataset(tree, "train")
    seg_only = t_cs.CityscapesDataset(tree, "train")
    names = lambda ds: [osp.basename(s[0]) for s in ds.samples]
    assert "aachen_000009_000019_leftImg8bit.png" not in names(with_depth)
    assert "aachen_000009_000019_leftImg8bit.png" in names(seg_only)
    assert len(with_depth) == 7 and len(seg_only) == 8
    with pytest.raises(RuntimeError, match="Image directory not found"):
        t_cs.CityscapesDataset(tree, "test")


def test_corrupt_sample_is_none_and_the_loader_resamples(tree):
    ds = t_cs.CityscapesDepthSegDataset(tree, "train")
    bad = next(i for i, s in enumerate(ds.samples) if "bochum_000009" in s[0])
    assert ds[bad] is None
    loader = t_loader.DataLoader(ds, batch_size=len(ds), shuffle=False, num_threads=2)
    (batch,) = list(loader.epoch(0))
    assert batch["image"].shape == (len(ds), H, W, 3) and batch["depth"].shape == (len(ds), H, W)
    nxt = ds[(bad + 1) % len(ds)]
    for key in ("image", "seg", "depth"):
        np.testing.assert_array_equal(batch[key][bad], nxt[key])


def test_native_ops_match_numpy():
    """Built by g++ into build/host/ (never into native/), bitwise equal to
    the numpy versions, and to the JAX package's."""
    status = _native.status()
    assert status["loaded"], status
    assert osp.join("build", "host", "libhostops-") in status["path"]
    rs = np.random.RandomState(1)
    labels = rs.randint(0, 256, (37, 53)).astype(np.uint8)
    got = _native.remap_labels(labels, t_cs.ID_TO_TRAIN_ID, t_cs.IGNORE_INDEX)
    np.testing.assert_array_equal(got, t_cs.remap_labels_numpy(labels))
    np.testing.assert_array_equal(got, j_cs.remap_labels(labels))
    disparity = rs.randint(0, 65536, (37, 53)).astype(np.uint16)
    disparity[::5] = 0
    for depth_max in (80.0, 20.0):
        depth, n_valid = _native.disparity_to_depth(disparity, depth_max, 500.0)
        want, valid = t_cs.disparity_to_depth_numpy(disparity, depth_max)
        np.testing.assert_array_equal(depth, want)
        np.testing.assert_array_equal(depth, j_cs.disparity_to_depth(disparity, depth_max)[0])
        assert n_valid == int(valid.sum())
    image = rs.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
    np.testing.assert_allclose(_native.normalize_image(image, mean, std),
                               (image / 255.0 - np.array(mean)) / np.array(std), atol=1e-5)
    assert _native.normalize_image(image[..., :2], mean, std) is None


def test_without_the_library_numpy_takes_over(monkeypatch):
    monkeypatch.setattr(_native, "_LIBRARY", _native._Library())
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    assert _native.status() == {"loaded": False, "path": None,
                                "error": "RuntimeError: g++ not found"}
    labels = np.arange(40, dtype=np.uint8).reshape(5, 8)
    np.testing.assert_array_equal(t_cs.remap_labels(labels), j_cs.remap_labels(labels))
    disparity = np.arange(0, 40000, 1000, dtype=np.uint16).reshape(5, 8)
    np.testing.assert_array_equal(t_cs.disparity_to_depth(disparity)[0],
                                  j_cs.disparity_to_depth(disparity)[0])


def _pillow_png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb"])
@pytest.mark.parametrize("writer", ["pillow", "all_filters"])
def test_decode_png_array_matches_pillow(kind, writer):
    rs = np.random.RandomState(2)
    yy, xx = np.mgrid[0:29, 0:41]
    arr = {"gray8": ((xx * 7 + yy * 3) % 256).astype(np.uint8),
           "gray16": (xx * 1543 + yy * 977 + rs.randint(0, 300, xx.shape)).astype(np.uint16),
           "rgb": rs.randint(0, 256, (29, 41, 3)).astype(np.uint8)}[kind]
    data = _pillow_png(arr) if writer == "pillow" else _filtered_png(arr, ALL_FILTERS)
    got = png.decode_png_array(data)
    want = np.asarray(Image.open(io.BytesIO(data)))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)


def test_encode_png_16bit_round_trip():
    arr = np.random.RandomState(3).randint(0, 65536, (23, 31)).astype(np.uint16)
    data = png.encode_png(arr)
    hdr = png.read_header(data)
    assert (hdr.bit_depth, hdr.color_type) == (16, 0)
    back = np.asarray(Image.open(io.BytesIO(data)))
    assert back.dtype == np.uint16
    np.testing.assert_array_equal(back, arr)
    np.testing.assert_array_equal(png.decode_png_array(data), arr)
    with pytest.raises(ValueError, match="unsupported PNG"):
        png.decode_png(data)  # the RGB contract stays 8-bit
    with pytest.raises(ValueError, match="encode_png takes"):
        png.encode_png(np.zeros((4, 4, 3), np.uint16))


def test_decode_png_array_rejects_16bit_color():
    data = _filtered_png(np.zeros((4, 4, 3), np.uint8), "0")
    rgb16 = data[:24] + bytes([16]) + data[25:29]  # bit depth 16 in the IHDR
    rgb16 = rgb16[:8] + png._chunk(b"IHDR", rgb16[16:29]) + data[33:]
    with pytest.raises(ValueError, match="16-bit gray"):
        png.decode_png_array(rgb16)


@pytest.mark.parametrize("kind", ["CityscapesDepthSegDataset", "CityscapesDataset"])
def test_build_dataset_cityscapes_types(tree, kind):
    data = {"dataset_type": kind, "path": tree, "depth_max": 40.0}
    t = t_loader.build_dataset(Config(data), "val")
    j = j_loader.build_dataset(data, "val")
    assert type(t).__name__ == type(j).__name__ == kind
    assert t.samples == j.samples
    if kind == "CityscapesDepthSegDataset":
        assert t.depth_max == j.depth_max == 40.0
        np.testing.assert_array_equal(t[0]["depth"], j[0]["depth"])
    # the ADE20K reader (ported) finds no ADE20K layout under a Cityscapes tree
    with pytest.raises(RuntimeError, match="Image directory not found"):
        t_loader.build_dataset(Config({"dataset_type": "ADE20KSegmentation", "path": tree}),
                               "train")
