"""The port's host image I/O (`utils/imageio.py`, `native/imageio.cc`)
against Pillow 12.1 (libjpeg-turbo): the baseline JPEG decoder, bit for bit,
over files Pillow writes (4:4:4, 4:2:2, 4:2:0 and gray; qualities 50-100;
optimised tables; restart intervals; sizes 1x1 to 683x512), 16-bit
quantisation tables (SOF1) and RGB files; the modes it refuses; the header;
BILINEAR and NEAREST resize over hypothesis-drawn size pairs; the files of
the smoke script's numpy encoder.  Every comparison is bitwise: no case
needs a +-1 limit.
"""

import io
import re

import numpy as np
import pytest

from denseclip_vit_multimodal_tpu_torch.utils import _jpeg_writer, imageio

Image = pytest.importorskip("PIL.Image")
ImageFile = pytest.importorskip("PIL.ImageFile")
hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

SIZES = [(1, 1), (7, 9), (17, 33), (513, 683), (683, 512)]


@pytest.fixture(autouse=True)
def _whole_file_buffer(monkeypatch):
    # Pillow writes optimised tables in one buffer: give it the whole file
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 24)


def _picture(h, w, seed):
    """A gradient with noise: smooth areas and busy ones, every channel different."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) * 3 % 256], -1)
    return np.clip(a + rs.randint(-30, 31, a.shape), 0, 255).astype(np.uint8)


def _save(array, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", [0, 1, 2, "gray"], ids=["444", "422", "420", "gray"])
def test_decode_matches_pillow_bitwise(sampling, size):
    h, w = size
    img = _picture(h, w, seed=h * 7 + w)
    if sampling == "gray":
        img = img[..., 1]
    kw = {} if sampling == "gray" else {"subsampling": sampling}
    for quality in (50, 75, 90, 95, 100):
        for extra in ({}, {"optimize": True}, {"restart_marker_blocks": 3},
                      {"restart_marker_rows": 1, "optimize": True}):
            data = _save(img, quality=quality, **kw, **extra)
            got = imageio.decode_jpeg(data)
            assert got.shape == (h, w, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, _pillow(data), err_msg=f"q{quality} {extra}")


def test_decode_16bit_tables_and_rgb_files():
    img = _picture(37, 53, seed=1)
    # a table entry above 255 makes libjpeg write 16-bit DQT and SOF1
    data = _save(img, qtables=[[min(5 * v, 600) for v in range(1, 65)], [300] * 64])
    assert imageio.read_jpeg_header(data).mode == "extended"
    np.testing.assert_array_equal(imageio.decode_jpeg(data), _pillow(data))
    # keep_rgb: Adobe transform 0, no colour conversion
    data = _save(img, keep_rgb=True)
    assert b"Adobe" in data
    np.testing.assert_array_equal(imageio.decode_jpeg(data), _pillow(data))


def _sof(data: bytes) -> int:
    for marker in (b"\xff\xc0", b"\xff\xc1", b"\xff\xc2"):
        pos = data.find(marker)
        if pos >= 0:
            return pos
    raise AssertionError("no frame header")


def _patched(data: bytes, offset: int, value: int) -> bytes:
    pos = _sof(data) + offset
    return data[:pos] + bytes([value]) + data[pos + 1:]


@pytest.mark.parametrize("case,mode", [
    ("progressive", "progressive"),
    ("cmyk", "4-component (CMYK/YCCK)"),
    ("arithmetic", "arithmetic-coded"),
    ("12-bit", "extended 12-bit"),
    ("lossless", "lossless"),
])
def test_refused_modes_raise_naming_the_mode(case, mode):
    img = _picture(24, 40, seed=2)
    if case == "progressive":
        data = _save(img, progressive=True)
    elif case == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, format="JPEG")
        data = buf.getvalue()
    else:
        data = _save(img)
        if case == "arithmetic":
            data = _patched(data, 1, 0xC9)  # SOF9: sequential, arithmetic-coded
        elif case == "12-bit":
            data = _patched(_patched(data, 1, 0xC1), 4, 12)  # SOF1 at 12-bit precision
        else:
            data = _patched(data, 1, 0xC3)  # SOF3
    with pytest.raises(imageio.UnsupportedJPEG, match=re.escape(mode)):
        imageio.decode_jpeg(data)
    assert issubclass(imageio.UnsupportedJPEG, ValueError)


def test_other_sampling_factors_are_refused():
    data = _save(_picture(32, 32, seed=3), subsampling=2)
    sof = _sof(data)
    # the luma component's factors (first component: id, hv, tq at offset 10..12)
    patched = data[:sof + 11] + bytes([0x12]) + data[sof + 12:]  # 1x2 luma: 4:4:0
    with pytest.raises(imageio.UnsupportedJPEG, match="sampling factors 1x2,1x1,1x1"):
        imageio.decode_jpeg(patched)


@pytest.mark.parametrize("kind", ["color", "gray", "progressive"])
def test_header_gives_pillow_size(kind):
    img = _picture(19, 45, seed=4)
    data = _save(img[..., 0] if kind == "gray" else img, progressive=kind == "progressive")
    hdr = imageio.read_jpeg_header(data)
    assert (hdr.width, hdr.height) == Image.open(io.BytesIO(data)).size == (45, 19)
    assert hdr.components == (1 if kind == "gray" else 3)
    assert hdr.mode == ("progressive" if kind == "progressive" else "baseline")


@pytest.mark.parametrize("data", [
    b"\xff\xd8\xff\xe0 not a jpeg at all",
    b"\x89PNG\r\n\x1a\n",
    b"",
], ids=["garbage", "png", "empty"])
def test_undecodable_bytes_raise(data):
    with pytest.raises(ValueError):
        imageio.decode_jpeg(data)


def test_truncated_file_raises():
    data = _save(_picture(64, 64, seed=5))
    with pytest.raises(ValueError, match="truncated"):
        imageio.decode_jpeg(data[: len(data) // 2])


def _resize_case(iw, ih, ow, oh, channels, seed):
    rs = np.random.RandomState(seed)
    shape = (ih, iw) if channels == 1 else (ih, iw, channels)
    img = rs.randint(0, 256, shape, dtype=np.uint8)
    pil = Image.fromarray(img)
    for method, ours in ((Image.BILINEAR, imageio.resize_bilinear_u8),
                         (Image.NEAREST, imageio.resize_nearest)):
        want = np.asarray(pil.resize((ow, oh), method))
        got = ours(img, (ow, oh))
        np.testing.assert_array_equal(got, want, err_msg=f"{method} {iw}x{ih} -> {ow}x{oh}")


_side = st.integers(1, 400)


@hypothesis.settings(max_examples=150, deadline=None, derandomize=True)
@hypothesis.given(st.one_of(
    st.tuples(_side, _side, st.integers(1, 40), st.integers(1, 40)),  # shrinks, often past 3x
    st.tuples(st.integers(1, 60), st.integers(1, 60), _side, _side),  # enlargements
    st.tuples(_side, _side, _side, _side),  # anything
    st.integers(1, 400).flatmap(lambda w: st.tuples(st.just(w), _side, st.just(w), _side)),
    st.integers(1, 400).flatmap(lambda h: st.tuples(_side, st.just(h), _side, st.just(h))),
), st.sampled_from([1, 3]))
def test_resizes_match_pillow_bitwise(sizes, channels):
    _resize_case(*sizes, channels, seed=sum(sizes))


@pytest.mark.parametrize("size", [(2100, 1400), (640, 480), (1024, 768), (683, 512), (512, 683)])
def test_resize_to_the_ade20k_canvas(size):
    _resize_case(*size, 683, 512, 3, seed=6)
    _resize_case(*size, 683, 512, 1, seed=7)


def test_nearest_keeps_dtype_and_channels():
    img = np.arange(5 * 7 * 2, dtype=np.uint16).reshape(5, 7, 2)
    out = imageio.resize_nearest(img, (3, 11))
    assert out.dtype == np.uint16 and out.shape == (11, 3, 2)
    for c in range(2):  # Pillow's 16-bit gray mode, one channel at a time
        want = np.asarray(Image.fromarray(img[..., c]).resize((3, 11), Image.NEAREST))
        np.testing.assert_array_equal(out[..., c], want)


@pytest.mark.parametrize("size", [(1, 1), (17, 33), (480, 640), (683, 512)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_smoke_encoder_files_decode_alike(size):
    """The numpy encoder that writes the smoke script's tree: its files decode
    to the same bytes under Pillow and under the port, and look like the frame."""
    img = _picture(*size, seed=8)
    data = _jpeg_writer.encode_jpeg(img, quality=90)
    got = imageio.decode_jpeg(data)
    np.testing.assert_array_equal(got, _pillow(data))
    psnr = 10 * np.log10(255.0**2 / max(np.mean((got.astype(float) - img) ** 2), 1e-9))
    assert psnr > 20.0


def test_smoke_encoder_tables_are_annex_k():
    """The encoder's Huffman tables are the ones libjpeg writes by default."""
    data = _save(_picture(16, 16, seed=9))
    tables = {}
    pos = data.find(b"\xff\xc4")
    while pos >= 0:
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        seg, i = data[pos + 4:end], 0
        while i < len(seg):
            bits = list(seg[i + 1:i + 17])
            tables[seg[i]] = (bits, bytes(seg[i + 17:i + 17 + sum(bits)]))
            i += 17 + sum(bits)
        pos = data.find(b"\xff\xc4", end)
    for cls_id, spec in ((0x00, _jpeg_writer.DC_LUMA), (0x10, _jpeg_writer.AC_LUMA),
                         (0x01, _jpeg_writer.DC_CHROMA), (0x11, _jpeg_writer.AC_CHROMA)):
        assert tables[cls_id] == (list(spec[0]), bytes(spec[1]))


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    """No fallback: a source that does not compile raises at the first call."""
    broken = tmp_path / "imageio.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(imageio, "SOURCE", broken)
    monkeypatch.setattr(imageio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(imageio, "_LIBRARY", imageio._Library())
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*error: expected"):
        imageio.decode_jpeg(_save(_picture(8, 8, seed=10)))
