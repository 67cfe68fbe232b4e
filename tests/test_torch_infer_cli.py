"""The port's evaluation outputs and inference CLI against the JAX package's
`Inferencer` on the same converted weights (fp32 on the CPU, tiny flagship):
`tools/test.py --out / --format-dir / --show-dir / --fetch-logits /
--shard-windows` and `tools/infer.py` on a written directory.

Tolerances: seg is compared off the pixels whose top two JAX logits are
within 1e-3 (an fp32 argmax there may go either way); depth in the npz to
one float16 ulp of JAX's fp32 depth plus 1e-5 (the fp32 depths differ by up
to 1.6e-6, more than an ulp near 0); the depth PNG's magma index within 1 of
the index of JAX's depth (fp32 sums in another order can cross a bin edge).
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from denseclip_vit_multimodal_tpu.data.augment import AugmentConfig as JAugmentConfig
from denseclip_vit_multimodal_tpu.data.cityscapes import labelids_from_trainids as j_labelids
from denseclip_vit_multimodal_tpu.infer.engine import Inferencer as JInferencer
from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.utils import visualize as jv
from denseclip_vit_multimodal_tpu_torch.convert import load_flax_variables
from denseclip_vit_multimodal_tpu_torch.core.config import load_config
from denseclip_vit_multimodal_tpu_torch.data.loader import build_dataset
from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer as TInferencer
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.tools import infer as infer_cli
from denseclip_vit_multimodal_tpu_torch.tools import test as test_cli
from denseclip_vit_multimodal_tpu_torch.train.checkpoint import save_checkpoint
from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state
from denseclip_vit_multimodal_tpu_torch.utils import png
from denseclip_vit_multimodal_tpu_torch.utils import visualize as tv

CONFIG = "configs/denseclip_vitb16_cityscapes_multitask.yaml"
TINY = [
    "model.backbone.width=96", "model.backbone.layers=2", "model.backbone.heads=3",
    "model.backbone.out_indices=[0,1]", "model.text_encoder.transformer_layers=1",
    "model.text_encoder.transformer_width=64", "model.text_encoder.transformer_heads=2",
    "model.token_embed_dim=64",
    "model.neck.inter_channels=16", "model.neck.out_channels=32",
    "model.decode_head.in_channels=32", "model.decode_head.channels=32",
    "model.depth_head.in_channels=32", "model.depth_head.channels=16",
    "data.synthetic=true", "data.synthetic_options.image_size=[64,128]",
    "data.synthetic_options.length=3", "tpu.compute_dtype=float32",
]
PROTOCOL = dict(mode="slide", crop=(64, 64), stride=(48, 48), window_batch=2)
CLI_PROTOCOL = ["--mode", "slide", "--crop", "64", "64", "--stride", "48", "48",
                "--window-batch", "2"]
TIE_MARGIN = 1e-3
DEPTH_ATOL = 1e-5  # the fp32 depths' own difference (measured 1.6e-6), beside the float16 ulp
MAGMA_INDEX = {tuple(c): i for i, c in enumerate(tv.MAGMA)}  # 256 distinct colours


def _near_ties(logits):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= TIE_MARGIN


def _magma_index(depth, max_depth):
    """The entry `colorize_depth` takes for each pixel (-1: black)."""
    x = np.clip(depth / max_depth, 0.0, 1.0) * 256
    idx = np.minimum(x, 255).astype(np.int64)
    idx[depth <= 0] = -1
    return idx


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """One set of weights: a JAX model initialised and perturbed, the same
    weights in a port checkpoint; both packages' inferencers."""
    tmp = tmp_path_factory.mktemp("infer_cli")
    cfg = load_config(CONFIG, overrides=TINY)
    model_cfg = cfg.model.to_dict()
    jm, texts = j_build(model_cfg, CITYSCAPES_CLASSES)
    variables = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3), jnp.float32),
                        jnp.asarray(texts))
    rs = np.random.RandomState(4)
    variables = {
        "params": jax.tree.map(lambda a: np.asarray(a) + 0.05 * rs.randn(*a.shape).astype(
            np.float32), variables["params"]),
        "batch_stats": jax.tree.map(lambda a: (rs.rand(*a.shape) + 0.5).astype(np.float32),
                                    variables["batch_stats"]),
    }
    tm, t_texts = t_build(model_cfg, CITYSCAPES_CLASSES, device="cpu")
    load_flax_variables(tm, variables)
    work_dir = str(tmp / "wd")
    save_checkpoint(work_dir, create_train_state(tm, cfg.training, 1), epoch=2)
    j_engine = JInferencer(jm, variables, texts, JAugmentConfig(), num_classes=19,
                           with_depth=True)
    return {"tmp": tmp, "cfg": cfg, "work_dir": work_dir, "j_engine": j_engine,
            "t_engine": TInferencer(tm, t_texts, num_classes=19)}


def test_test_cli_outputs_match_jax(setup, capsys):
    tmp = setup["tmp"]
    out, show, fmt = str(tmp / "preds.npz"), str(tmp / "show"), str(tmp / "fmt")
    results = test_cli.main([CONFIG, setup["work_dir"], *CLI_PROTOCOL, "--device", "cpu",
                             "--eval", "mIoU", "depth", "--shard-windows", "--fetch-logits",
                             "--out", out, "--show-dir", show, "--format-dir", fmt,
                             "--set", *TINY])
    captured = capsys.readouterr()
    assert "--shard-windows needs --mode slide and >1 device; running unsharded" in captured.err
    assert "saved 3 frames to" in captured.out
    # the artifacts come from the primary pass only: the reference protocol
    # (crop 640, here the whole 64x128 frame) is scored but writes nothing
    assert "ref/mIoU" in results and np.isfinite(results["mIoU"])
    saved = np.load(out)
    assert sorted(saved.files) == sorted(f"{k}_{i}" for k in ("seg", "depth") for i in range(3))
    ds = build_dataset(setup["cfg"].data, "val")
    max_depth = float(setup["cfg"].data.depth_max)
    for i in range(3):
        sample = ds[i]
        want = setup["j_engine"].predict(sample["image"][None], fetch="logits", **PROTOCOL)
        seg, depth = saved[f"seg_{i}"], saved[f"depth_{i}"]
        assert seg.dtype == np.uint8 and depth.dtype == np.float16
        off = ~_near_ties(want["seg_logits"][0])
        assert off.mean() > 0.9
        np.testing.assert_array_equal(seg[off], want["seg"][0][off])
        jd = want["depth"][0]
        assert (np.abs(depth.astype(np.float32) - jd)
                <= np.spacing(np.abs(jd).astype(np.float16)).astype(np.float32) + DEPTH_ATOL).all()
        # the submission PNG: 8-bit gray labelIds, as Pillow reads it
        pil = Image.open(os.path.join(fmt, f"frame_{i:05d}_labelIds.png"))
        assert pil.mode == "L"
        np.testing.assert_array_equal(np.asarray(pil), j_labelids(seg))
        np.testing.assert_array_equal(np.asarray(pil)[off], j_labelids(want["seg"][0])[off])
        # the panel: JAX's tiles, from the port's own fp32 prediction
        own = setup["t_engine"].predict(sample["image"][None], fetch="argmax", **PROTOCOL)
        np.testing.assert_array_equal(own["seg"][0], seg)
        title, tiles = tv.read_panels(open(os.path.join(show, f"frame_{i:05d}.png"), "rb").read())
        tiles = dict(tiles)
        assert title == f"frame {i}"
        assert list(tiles) == ["input", "seg pred", "seg gt", "depth pred", "depth gt"]
        np.testing.assert_array_equal(tiles["input"], sample["image"])
        np.testing.assert_array_equal(tiles["seg pred"], jv.colorize_seg(seg))
        np.testing.assert_array_equal(tiles["seg gt"], jv.colorize_seg(sample["seg"]))
        np.testing.assert_array_equal(tiles["depth pred"],
                                      jv.colorize_depth(own["depth"][0], max_depth))
        np.testing.assert_array_equal(tiles["depth gt"],
                                      jv.colorize_depth(sample["depth"], max_depth))


def test_shard_windows_over_several_devices_is_not_ported(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 6"):
        test_cli.main([CONFIG, setup["work_dir"], "--mode", "slide", "--shard-windows",
                       "--set", *TINY])


def _write_inputs(folder, rs):
    """A PNG, a baseline JPEG (Pillow, 4:2:0), a non-image file and a
    subdirectory holding an image (not read: the scan is not recursive)."""
    os.makedirs(os.path.join(folder, "sub"))
    a = rs.randint(0, 256, (64, 128, 3), dtype=np.uint8)
    with open(os.path.join(folder, "a.png"), "wb") as f:
        f.write(png.encode_png(a))
    b = np.clip(np.mgrid[0:64, 0:128][1][..., None] * 2 + rs.randint(0, 40, (64, 128, 3)), 0,
                255).astype(np.uint8)
    Image.fromarray(b).save(os.path.join(folder, "b.jpg"), quality=90)
    with open(os.path.join(folder, "notes.txt"), "w") as f:
        f.write("not an image\n")
    Image.fromarray(a).save(os.path.join(folder, "sub", "c.png"))


def _assert_pngs_match_jax(setup, out_dir, name, image):
    want = setup["j_engine"].predict(image[None], fetch="logits", **PROTOCOL)
    seg_png = np.asarray(Image.open(os.path.join(out_dir, f"{name}_seg.png")).convert("RGB"))
    off = ~_near_ties(want["seg_logits"][0])
    assert off.mean() > 0.9
    np.testing.assert_array_equal(seg_png[off], jv.colorize_seg(want["seg"][0])[off])
    depth_png = png.decode_png(open(os.path.join(out_dir, f"{name}_depth.png"), "rb").read())
    max_depth = float(setup["cfg"].data.depth_max)
    got = np.array([[MAGMA_INDEX.get(tuple(c), -1) if c.any() else -1 for c in row]
                    for row in depth_png])
    assert np.abs(got - _magma_index(want["depth"][0], max_depth)).max() <= 1


def test_infer_cli_matches_jax_on_a_directory(setup, capsys):
    tmp = setup["tmp"]
    folder, out_dir = str(tmp / "frames"), str(tmp / "inferred")
    _write_inputs(folder, np.random.RandomState(5))
    written = infer_cli.main([CONFIG, setup["work_dir"], folder, "-o", out_dir, *CLI_PROTOCOL,
                              "--device", "cpu", "--set", *TINY])
    assert sorted(os.path.basename(p) for p in written) == [
        "a_depth.png", "a_seg.png", "b_depth.png", "b_seg.png"]
    printed = capsys.readouterr().out
    assert re.search(r"a\.png -> .*a_seg\.png", printed) and "notes" not in printed
    for name, ext in (("a", "png"), ("b", "jpg")):
        image = np.asarray(Image.open(os.path.join(folder, f"{name}.{ext}")).convert("RGB"))
        _assert_pngs_match_jax(setup, out_dir, name, image)


def test_infer_cli_aug_test_and_a_single_file(setup):
    tmp = setup["tmp"]
    image = np.random.RandomState(6).randint(0, 256, (64, 128, 3), dtype=np.uint8)
    path = str(tmp / "one.png")
    with open(path, "wb") as f:
        f.write(png.encode_png(image))
    out_dir = str(tmp / "aug")
    infer_cli.main([CONFIG, setup["work_dir"], path, "-o", out_dir, "--aug-test", "--mode",
                    "whole", "--device", "cpu", "--set", *TINY])
    want = setup["j_engine"].aug_test(image[None], mode="whole", fetch="logits")
    seg_png = png.decode_png(open(os.path.join(out_dir, "one_seg.png"), "rb").read())
    off = ~_near_ties(want["seg_logits"][0])
    np.testing.assert_array_equal(seg_png[off], jv.colorize_seg(want["seg"][0])[off])
    empty = tmp / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no images found"):
        infer_cli.main([CONFIG, setup["work_dir"], str(empty), "--device", "cpu", "--set", *TINY])


def test_infer_cli_refused_jpeg_mode_takes_the_servers_route(setup, monkeypatch):
    """A progressive JPEG, which the port's decoder refuses, is decoded by
    Pillow where it is installed (as the HTTP server does), and raises the
    server's error where it is not."""
    tmp = setup["tmp"]
    folder = tmp / "progressive"
    folder.mkdir()
    image = np.random.RandomState(7).randint(0, 256, (64, 128, 3), dtype=np.uint8)
    Image.fromarray(image).save(str(folder / "p.jpg"), quality=95, progressive=True)
    out_dir = str(tmp / "progressive_out")
    infer_cli.main([CONFIG, setup["work_dir"], str(folder), "-o", out_dir, *CLI_PROTOCOL,
                    "--device", "cpu", "--set", *TINY])
    decoded = np.asarray(Image.open(str(folder / "p.jpg")).convert("RGB"))
    _assert_pngs_match_jax(setup, out_dir, "p", decoded)
    monkeypatch.setitem(sys.modules, "PIL", None)  # no Pillow: the import fails
    with pytest.raises(ValueError, match="progressive.*Pillow, which would, is not installed"):
        infer_cli.main([CONFIG, setup["work_dir"], str(folder), "-o", out_dir, *CLI_PROTOCOL,
                        "--device", "cpu", "--set", *TINY])
