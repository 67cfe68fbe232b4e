"""The port's panels and colourisers (`utils/visualize.py`, numpy alone) against
the JAX package's (matplotlib): `colorize_scaled` and `denormalize_image`
bitwise, every tile cut back out of both panels bitwise equal to the arrays
the JAX figure shows, in JAX's grid, and the tEXt titles equal to the JAX
figure's strings; `encode_png` without `text` unchanged; and
`train/loop.py::validate`'s three panels, whose best batch is the one the
JAX `validate` picks on the same converted weights and batches (fp32 on the
CPU, tiny model)."""

import logging
import struct
import zlib

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from denseclip_vit_multimodal_tpu.data.augment import AugmentConfig as JAugmentConfig
from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.train import loop as j_loop
from denseclip_vit_multimodal_tpu.train.state import create_train_state as j_create_state
from denseclip_vit_multimodal_tpu.train.step import make_eval_step as j_make_eval_step
from denseclip_vit_multimodal_tpu.utils import visualize as jv
from denseclip_vit_multimodal_tpu_torch.convert import load_flax_variables
from denseclip_vit_multimodal_tpu_torch.data.augment import AugmentConfig
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.train import loop as t_loop
from denseclip_vit_multimodal_tpu_torch.train.state import TrainState
from denseclip_vit_multimodal_tpu_torch.train.step import make_eval_step as t_make_eval_step
from denseclip_vit_multimodal_tpu_torch.utils import png
from denseclip_vit_multimodal_tpu_torch.utils import visualize as tv

matplotlib.use("Agg")

# --------------------------------------------------------------------------
# colourisers
# --------------------------------------------------------------------------

finite = st.floats(allow_nan=False, allow_infinity=False, width=64)


@settings(max_examples=150, deadline=None)
@given(hnp.arrays(np.float64, hnp.array_shapes(min_dims=2, max_dims=2, max_side=9),
                  elements=finite))
def test_colorize_scaled_matches_jax_on_drawn_arrays(arr):
    with np.errstate(all="ignore"):
        want = jv._colorize_scaled(arr)
    np.testing.assert_array_equal(tv.colorize_scaled(arr), want)


@pytest.mark.parametrize("case", ["zeros", "negatives", "labels", "max_at_minus_eps", "extremes",
                                  "depth_float32", "magma"])
def test_colorize_scaled_matches_jax_on_edge_cases(case):
    rs = np.random.RandomState(0)
    arr, cmap = {
        "zeros": (np.zeros((6, 7)), "jet"),
        "negatives": (-np.abs(rs.randn(6, 7)) - 1.0, "jet"),
        "labels": (rs.randint(0, 19, (16, 24)).astype(np.int32), "jet"),
        "max_at_minus_eps": (np.full((3, 4), -1e-6), "jet"),  # max + 1e-6 == 0
        "extremes": (np.array([[1.7e308, -1.7e308], [5e-324, 0.0]]), "jet"),
        "depth_float32": ((rs.rand(16, 24) * 80).astype(np.float32), "jet"),
        "magma": (rs.randn(16, 24), "magma"),
    }[case]
    with np.errstate(all="ignore"):
        want = jv._colorize_scaled(arr, cmap)
    np.testing.assert_array_equal(tv.colorize_scaled(arr, cmap), want)


def test_colorize_scaled_tables_are_matplotlibs():
    for name, table in tv.CMAPS.items():
        lut = matplotlib.colormaps[name](np.arange(256) / 256.0)[:, :3]
        np.testing.assert_array_equal(table, (lut * 255).astype(np.uint8), err_msg=name)
    with pytest.raises(ValueError, match="unknown colormap"):
        tv.colorize_scaled(np.zeros((2, 2)), "viridis")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_denormalize_image_matches_jax(dtype):
    img = (np.random.RandomState(1).randn(9, 11, 3) * 3).astype(dtype)
    np.testing.assert_array_equal(tv.denormalize_image(img), jv.denormalize_image(img))
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    np.testing.assert_array_equal(tv.denormalize_image(img, mean, std),
                                  jv.denormalize_image(img, mean, std))


# --------------------------------------------------------------------------
# panels: tiles and titles against what the JAX figure shows
# --------------------------------------------------------------------------


@pytest.fixture
def jax_figure(monkeypatch):
    """Records the grid, the arrays shown, the panel titles and the suptitle
    of every figure the JAX package draws."""
    import matplotlib.axes
    import matplotlib.figure
    import matplotlib.pyplot as plt

    seen = {"grid": None, "images": [], "titles": [], "suptitle": ""}
    subplots, imshow = plt.subplots, matplotlib.axes.Axes.imshow
    set_title, suptitle = matplotlib.axes.Axes.set_title, matplotlib.figure.Figure.suptitle

    def rec_subplots(rows, cols, **kw):
        seen["grid"] = (rows, cols)
        return subplots(rows, cols, **kw)

    def rec_imshow(ax, img, *a, **kw):
        seen["images"].append(np.array(img))
        return imshow(ax, img, *a, **kw)

    def rec_title(ax, name, *a, **kw):
        seen["titles"].append(name)
        return set_title(ax, name, *a, **kw)

    def rec_suptitle(fig, text, *a, **kw):
        seen["suptitle"] = text
        return suptitle(fig, text, *a, **kw)

    monkeypatch.setattr(plt, "subplots", rec_subplots)
    monkeypatch.setattr(matplotlib.axes.Axes, "imshow", rec_imshow)
    monkeypatch.setattr(matplotlib.axes.Axes, "set_title", rec_title)
    monkeypatch.setattr(matplotlib.figure.Figure, "suptitle", rec_suptitle)
    return seen


def _assert_panel_is_jax_figure(path, seen):
    with open(path, "rb") as f:
        data = f.read()
    title, tiles = tv.read_panels(data)
    assert title == seen["suptitle"]
    assert [name for name, _ in tiles] == seen["titles"]
    assert len(tiles) == len(seen["images"])
    for (name, tile), want in zip(tiles, seen["images"]):
        np.testing.assert_array_equal(tile, want, err_msg=name)
    layout = png.read_text(data)["Layout"]
    rows, cols = seen["grid"]
    assert f"grid {rows}x{cols} " in layout
    # the gutters are white and the tiles sit where the module note says
    canvas = png.decode_png(data)
    h, w = tiles[0][1].shape[:2]
    g = tv.GUTTER
    assert canvas.shape == (g + rows * (h + g), g + cols * (w + g), 3)
    assert (canvas[:g] == 255).all() and (canvas[:, :g] == 255).all()


def _sample(rs, h=20, w=28, normalized=False):
    image = (rs.randn(h, w, 3).astype(np.float32) if normalized
             else rs.randint(0, 256, (h, w, 3), dtype=np.uint8))
    seg = rs.randint(0, 19, (h, w)).astype(np.int32)
    seg[rs.rand(h, w) < 0.1] = 255
    depth = (rs.rand(h, w) * 90).astype(np.float32)
    depth[rs.rand(h, w) < 0.2] = 0.0
    return image, seg, depth


@pytest.mark.parametrize("normalized,epoch", [(False, 3), (True, None)])
def test_comparison_panel_matches_jax(tmp_path, jax_figure, normalized, epoch):
    rs = np.random.RandomState(2)
    image, seg, _ = _sample(rs, normalized=normalized)
    pred = rs.randint(0, 19, seg.shape).astype(np.int64)
    jv.save_comparison_panel(str(tmp_path / "j.png"), image, pred, seg, epoch=epoch)
    out = tv.save_comparison_panel(str(tmp_path / "sub" / "t.png"), image, pred, seg, epoch=epoch)
    assert out == str(tmp_path / "sub" / "t.png")
    _assert_panel_is_jax_figure(out, jax_figure)
    assert jax_figure["grid"] == (1, 3)


@pytest.mark.parametrize("which", ["all", "no_depth", "seg_only_pred", "depth_no_gt", "normalized"])
def test_multi_task_panel_matches_jax(tmp_path, jax_figure, which):
    rs = np.random.RandomState(3)
    image, seg_gt, depth_gt = _sample(rs, normalized=which == "normalized")
    seg_pred = rs.randint(0, 19, seg_gt.shape).astype(np.int32)
    depth_pred = (rs.rand(*seg_gt.shape) * 70).astype(np.float32)
    kw = {"all": dict(seg_gt=seg_gt, depth_pred=depth_pred, depth_gt=depth_gt),
          "no_depth": dict(seg_gt=seg_gt),
          "seg_only_pred": {},
          "depth_no_gt": dict(depth_pred=depth_pred),
          "normalized": dict(seg_gt=seg_gt, depth_pred=depth_pred, depth_gt=depth_gt)}[which]
    title = "" if which == "no_depth" else "frame 7"
    jv.save_multi_task_panel(str(tmp_path / "j.png"), image, seg_pred, max_depth=60.0,
                             title=title, **kw)
    out = tv.save_multi_task_panel(str(tmp_path / "t.png"), image, seg_pred, max_depth=60.0,
                                   title=title, **kw)
    _assert_panel_is_jax_figure(out, jax_figure)
    n = 2 + len(kw)
    assert jax_figure["grid"] == (-(-n // min(3, n)), min(3, n))


# --------------------------------------------------------------------------
# utils/png.py: tEXt chunks
# --------------------------------------------------------------------------


def _chunk(ctype, body):
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


@pytest.mark.parametrize("kind", ["rgb", "gray", "gray16"])
def test_encode_png_without_text_is_unchanged(kind):
    """The bytes of the image alone: signature, IHDR, one IDAT of filter-0
    rows at the zlib level, IEND, built here by hand."""
    rs = np.random.RandomState(4)
    image = {"rgb": rs.randint(0, 256, (5, 7, 3), dtype=np.uint8),
             "gray": rs.randint(0, 256, (4, 9), dtype=np.uint8),
             "gray16": rs.randint(0, 65536, (3, 6)).astype(np.uint16)}[kind]
    h, w = image.shape[:2]
    rows = (image.astype(">u2") if kind == "gray16" else image).tobytes()
    stride = len(rows) // h
    raw = b"".join(b"\0" + rows[r * stride:(r + 1) * stride] for r in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 16 if kind == "gray16" else 8,
                       2 if kind == "rgb" else 0, 0, 0, 0)
    for level in (6, 9):
        want = (png.SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw, level))
                + _chunk(b"IEND", b""))
        assert png.encode_png(image, level) == want
        assert png.encode_png(image, level, text=None) == want
        assert png.encode_png(image, level, text=()) == want
    assert png.read_text(want) == {}


def test_text_chunks_round_trip_and_read_by_pillow():
    from PIL import Image
    import io

    image = np.random.RandomState(5).randint(0, 256, (6, 8, 3), dtype=np.uint8)
    text = [("Title", "Validation Epoch 2 - Best Accuracy Image"), ("Panel 0", "input"),
            ("Panel 0 size", "6x8")]
    data = png.encode_png(image, text=text)
    assert png.read_text(data) == dict(text)
    np.testing.assert_array_equal(png.decode_png(data), image)
    pil = Image.open(io.BytesIO(data))
    assert pil.text == dict(text)
    np.testing.assert_array_equal(np.asarray(pil.convert("RGB")), image)
    for bad in ("", " lead", "a" * 80, "two  spaces", "nul\0"):
        with pytest.raises(ValueError, match="tEXt keyword"):
            png.encode_png(image, text=[(bad, "x")])


# --------------------------------------------------------------------------
# train/loop.py::validate: the three panels and the best batch
# --------------------------------------------------------------------------


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def epoch(self, _):
        return iter([dict(b) for b in self.batches])


@pytest.fixture(scope="module")
def pair(tiny_model_cfg):
    """The same fp32 weights in a JAX model and a port model (one text layer)."""
    cfg = dict(tiny_model_cfg)
    cfg["text_encoder"] = dict(cfg["text_encoder"], transformer_layers=1)
    jm, texts = j_build(cfg, CITYSCAPES_CLASSES)
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 96, 3), jnp.float32),
                        jnp.asarray(texts))
    rs = np.random.RandomState(3)
    variables = {
        "params": jax.tree.map(np.asarray, variables["params"]),
        "batch_stats": jax.tree.map(lambda a: (rs.rand(*a.shape) + 0.5).astype(np.float32),
                                    variables["batch_stats"]),
    }
    tm, _ = t_build(cfg, CITYSCAPES_CLASSES, device="cpu")
    load_flax_variables(tm, variables)
    return jm, variables, tm, texts


def test_validate_writes_the_panels_of_the_batch_jax_picks(pair, tmp_path, monkeypatch):
    """Three batches whose ground truth copies a different share of the
    model's own prediction (so one batch is clearly the most accurate);
    argmax near-ties (top two logits within 1e-3) are `ignore`, so both
    packages count the same pixels.  The JAX panels are recorded, not drawn."""
    jm, variables, tm, texts = pair
    crop = (64, 128)
    t_step = t_make_eval_step(texts, AugmentConfig(crop_size=crop), 19)
    state = TrainState(tm, None)
    rs = np.random.RandomState(8)
    batches = []
    for share in (0.2, 0.7, 0.4):
        image = rs.randint(0, 256, (2, 64, 128, 3), dtype=np.uint8)
        probe = {"image": image, "seg": np.zeros((2, 64, 128), np.int32)}
        with torch.no_grad():
            from denseclip_vit_multimodal_tpu_torch.data.augment import eval_preprocess_batch
            from denseclip_vit_multimodal_tpu_torch.models.layers import resize_bilinear

            pre = eval_preprocess_batch({"image": torch.from_numpy(image)},
                                        AugmentConfig(crop_size=crop))
            logits = resize_bilinear(tm(pre["image"], texts)["seg"], (64, 128),
                                     antialias=True).numpy()
        top2 = np.sort(logits, axis=-1)[..., -2:]
        seg = np.where(rs.rand(2, 64, 128) < share, logits.argmax(-1),
                       rs.randint(0, 19, (2, 64, 128))).astype(np.int32)
        seg[top2[..., 1] - top2[..., 0] <= 1e-3] = 255
        depth = (rs.rand(2, 64, 128) * 4.0).astype(np.float32)
        batches.append({**probe, "seg": seg, "depth": depth})

    recorded = []
    monkeypatch.setattr(jv, "save_multi_task_panel",
                        lambda path, *a, **kw: recorded.append(("multi", path, a, kw)))
    monkeypatch.setattr(jv, "save_comparison_panel",
                        lambda path, *a, **kw: recorded.append(("comparison", path, a, kw)))
    j_state = j_create_state(jm, variables, {}, 1)
    j_step = j_make_eval_step(jnp.asarray(texts), JAugmentConfig(crop_size=crop), 19)
    logger = logging.getLogger("test_visualize")
    j_metrics = j_loop.validate(j_state, j_step, _Loader(batches), None, logger,
                                visualize_to=str(tmp_path / "j" / "epoch_4.png"), epoch=4)
    assert [r[0] for r in recorded] == ["multi", "multi", "comparison"]

    path = str(tmp_path / "t" / "epoch_4.png")
    t_metrics = t_loop.validate(state, t_step, _Loader(batches), logger, visualize_to=path,
                                epoch=4)
    assert t_metrics["pixel_acc"] == pytest.approx(j_metrics["pixel_acc"], rel=1e-6)
    files = {name: tv.read_panels(open(tmp_path / "t" / name, "rb").read())
             for name in ("epoch_4.png", "best_epoch_4.png", "comparison_epoch_4.png")}

    (_, _, first_args, first_kw), (_, _, best_args, best_kw), (_, _, cmp_args, cmp_kw) = recorded
    assert best_args[0] is not None and np.array_equal(best_args[0], batches[1]["image"][0])
    for name, args, kw in (("epoch_4.png", first_args, first_kw),
                           ("best_epoch_4.png", best_args, best_kw)):
        title, tiles = files[name]
        assert title == kw.get("title", "")
        tiles = dict(tiles)
        assert list(tiles) == ["input", "seg pred", "seg gt", "depth pred", "depth gt"]
        np.testing.assert_array_equal(tiles["input"], args[0])
        np.testing.assert_array_equal(tiles["seg gt"], jv.colorize_seg(kw["seg_gt"]))
        np.testing.assert_array_equal(tiles["depth gt"], jv.colorize_depth(kw["depth_gt"]))
        counted = kw["seg_gt"] != 255  # off the near-ties
        np.testing.assert_array_equal(tiles["seg pred"][counted],
                                      jv.colorize_seg(np.asarray(args[1]))[counted])
    title, tiles = files["comparison_epoch_4.png"]
    assert title == "Validation Epoch 4 - Best Accuracy Image" and cmp_kw == {"epoch": 4}
    assert [n for n, _ in tiles] == ["Input Image", "Prediction", "Ground Truth"]
    np.testing.assert_array_equal(tiles[0][1], cmp_args[0])
    np.testing.assert_array_equal(tiles[2][1], jv._colorize_scaled(cmp_args[2]))


def test_validate_logs_a_failed_panel_and_carries_on(pair, tmp_path, caplog):
    _, _, tm, texts = pair
    t_step = t_make_eval_step(texts, AugmentConfig(crop_size=(64, 128)), 19)
    rs = np.random.RandomState(9)
    batch = {"image": rs.randint(0, 256, (1, 64, 128, 3), dtype=np.uint8),
             "seg": rs.randint(0, 19, (1, 64, 128)).astype(np.int32)}
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    logger = logging.getLogger("test_visualize_fail")
    with caplog.at_level(logging.WARNING, logger="test_visualize_fail"):
        metrics = t_loop.validate(TrainState(tm, None), t_step, _Loader([batch]), logger,
                                  visualize_to=str(blocker / "epoch_0.png"), epoch=0)
    assert np.isfinite(metrics["miou"])
    assert "visualization failed" in caplog.text
    assert "best-image visualization failed" in caplog.text
