"""The ViT-L/14 preset (`configs/denseclip_vitl14_cityscapes_multitask.yaml`:
patch 14, `tpu.remat: true`, crop 504x1008, slide crop 630 / reference 644)
and the seg-only preset (`configs/denseclip_vitb16_cityscapes_seg.yaml`:
`CityscapesDataset`, no depth head) in the port against the JAX package, on
the CPU in fp32, each narrowed by `--set` (width, layers and out indices,
the towers' widths, the crops and slide protocol scaled to a 70x140 frame)
with its structure as published: the forward and the slide logits on the
same weights (`convert.load_flax_variables`); ViT-L/14's whole mode refused
on a frame that is not a multiple of the patch, as the JAX ViT refuses it,
and its aug-test (sizes rounded to the patch grid in both packages) run;
then each preset through `tools/train.py` (CLIP import from a stub archive,
one step, validation with its panels), its first step's loss against JAX's
on the same decoded batch and imported weights, `tools/test.py --out` and
`tools/infer.py`: the seg-only preset writes no depth anywhere.

fp32 tolerances: max abs 1e-4 (and relative L2 1e-5, `torch_parity.py`) on
logits and depth; 1e-5 relative on the loss.
"""

import os
import os.path as osp

import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu_torch.core.config import load_config as t_load
from denseclip_vit_multimodal_tpu_torch.data.augment import normalize_image
from denseclip_vit_multimodal_tpu_torch.data.loader import build_dataset
from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer as TInferencer
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.tools import infer as infer_tool
from denseclip_vit_multimodal_tpu_torch.tools import test as test_tool
from denseclip_vit_multimodal_tpu_torch.tools import train as train_tool
from denseclip_vit_multimodal_tpu_torch.train import losses as t_losses
from denseclip_vit_multimodal_tpu_torch.train.clip_import import load_clip_into_model
from denseclip_vit_multimodal_tpu_torch.utils.png import encode_png
from denseclip_vit_multimodal_tpu_torch.utils.visualize import read_panels

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from denseclip_vit_multimodal_tpu.core.config import load_config as j_load  # noqa: E402
from denseclip_vit_multimodal_tpu.infer.engine import Inferencer as JInferencer  # noqa: E402
from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build  # noqa: E402
from denseclip_vit_multimodal_tpu.train import clip_import as j_ci  # noqa: E402
from denseclip_vit_multimodal_tpu.train import losses as j_losses  # noqa: E402
from torch_clip_files import write_stub_clip  # noqa: E402
from torch_parity import assert_parity, init, port, randn, t  # noqa: E402

VITL = "configs/denseclip_vitl14_cityscapes_multitask.yaml"
SEG = "configs/denseclip_vitb16_cityscapes_seg.yaml"
_TOWERS = ["model.text_encoder.transformer_width=64", "model.text_encoder.transformer_heads=2",
           "model.text_encoder.transformer_layers=1", "model.text_encoder.embed_dim=32",
           "model.text_dim=32", "model.token_embed_dim=64", "model.backbone.width=64",
           "model.backbone.layers=2", "model.backbone.heads=1", "model.backbone.output_dim=32",
           "model.backbone.out_indices=[0,1]", "model.neck.inter_channels=16",
           "model.neck.out_channels=32", "model.decode_head.in_channels=32",
           "model.decode_head.channels=32", "tpu.compute_dtype=float32", "training.batch_size=2",
           "training.workers=1"]
SETS = {
    # crop 504x1008 -> 56x112 (patch 14); slide 630 / 644 / 426 -> 42 / 56 / 28
    VITL: _TOWERS + ["model.depth_head.in_channels=32", "model.depth_head.channels=16",
                     "data.crop_size=[56,112]", "test.crop=[42,42]", "test.reference_crop=[56,56]",
                     "test.stride=[28,28]", "test.window_batch=2"],
    # crop 512x1024 -> 64x128; slide 624 / 640 / 426 -> 48 / 64 / 32
    SEG: _TOWERS + ["data.crop_size=[64,128]", "test.crop=[48,48]", "test.reference_crop=[64,64]",
                    "test.stride=[32,32]", "test.window_batch=2"],
}
PATCH = {VITL: 14, SEG: 16}
CROP = {VITL: (56, 112), SEG: (64, 128)}
# the stub archives: (width, layers, patch, positions, proj), (width, layers, vocab, positions, proj)
ARCHIVE = {VITL: ((64, 2, 14, (224 // 14) ** 2 + 1, 32), (64, 1, 49408, 77, 32)),
           SEG: ((64, 2, 16, (224 // 16) ** 2 + 1, 32), (64, 1, 49408, 77, 32))}
FRAME = (70, 140)  # a multiple of 14 (ViT-L/14's slide windows), not of 16
NO_DROPOUT = ["model.decode_head.dropout_ratio=0", "model.depth_head.dropout_ratio=0"]
TOL_LOSS = 1e-5


def _pair(config, img, extra=()):
    sets = SETS[config] + list(extra)
    jcfg, tcfg = j_load(config, overrides=sets), t_load(config, overrides=sets)
    jm, texts = j_build(jcfg.model, CITYSCAPES_CLASSES)
    v = init(jm, jnp.asarray(img), jnp.asarray(texts))
    tm, t_texts = t_build(tcfg.model, CITYSCAPES_CLASSES, device="cpu",
                          remat=tcfg.tpu.get("remat", False))
    np.testing.assert_array_equal(t_texts, texts)
    return jm, v, port(tm, v), texts, tcfg


@pytest.mark.parametrize("config", [VITL, SEG], ids=["vitl14", "seg_only"])
def test_forward_and_slide_match_jax(config):
    img = randn(2, *CROP[config], 3, seed=30)
    jm, v, tm, texts, cfg = _pair(config, img)
    assert tm.backbone.patch_size == PATCH[config]
    assert (tm.backbone.transformer.remat is not None) == (config == VITL)  # as shipped
    want = jm.apply(v, jnp.asarray(img), jnp.asarray(texts))
    with torch.no_grad():
        got = tm(t(img), texts)
    assert_parity(want["seg"], got["seg"], what="seg")
    if config == SEG:
        assert got.get("depth") is None and want.get("depth") is None
    else:
        assert_parity(want["depth"], got["depth"], what="depth")

    frame = np.random.RandomState(31).randint(0, 256, (1, *FRAME, 3), dtype=np.uint8)
    test_cfg = cfg.test
    kw = dict(mode="slide", crop=tuple(test_cfg.crop), stride=tuple(test_cfg.stride),
              window_batch=int(test_cfg.window_batch))
    j_engine = JInferencer(jm, v, texts, num_classes=19, with_depth=config == VITL)
    t_engine = TInferencer(tm, texts, num_classes=19)
    for fn, extra in (("predict", {}), ("aug_test", {"scales": (0.75, 1.0)})):
        want = getattr(j_engine, fn)(frame, **kw, **extra)
        got = getattr(t_engine, fn)(frame, **kw, **extra)
        assert_parity(want["seg_logits"], torch.from_numpy(got["seg_logits"]), what=fn)
        assert ("depth" in got) == ("depth" in want) == (config == VITL)
        if config == VITL:
            assert_parity(want["depth"], torch.from_numpy(got["depth"]), what=f"{fn} depth")


def test_vitl14_whole_mode_is_refused_as_jax_refuses_it():
    """A 70x140 frame (grid 5x10) runs whole; a 64x128 frame is not a multiple
    of patch 14 in either package.  aug-test rounds each scale to the grid."""
    img = randn(1, 56, 112, 3, seed=32)
    jm, v, tm, texts, _ = _pair(VITL, img)
    frame = np.random.RandomState(33).randint(0, 256, (1, 64, 128, 3), dtype=np.uint8)
    j_engine = JInferencer(jm, v, texts, num_classes=19, with_depth=True)
    t_engine = TInferencer(tm, texts, num_classes=19)
    with pytest.raises(AssertionError, match="input 64x128 not divisible by patch 14"):
        j_engine.predict(frame, mode="whole")
    with pytest.raises(ValueError, match="input 64x128 not divisible by patch 14"):
        t_engine.predict(frame, mode="whole")
    want = j_engine.aug_test(frame, mode="whole", scales=(0.5, 1.0, 1.25))
    got = t_engine.aug_test(frame, mode="whole", scales=(0.5, 1.0, 1.25))
    assert_parity(want["seg_logits"], torch.from_numpy(got["seg_logits"]), what="aug_test")


def _write_tree(root, rs, hw=FRAME):
    for split, n in (("train", 2), ("val", 2)):
        for i in range(n):
            disparity = rs.randint(0, 30000, hw).astype(np.uint16)
            disparity[::5] = 0
            for top, suffix, arr in (
                    ("leftImg8bit", "leftImg8bit", rs.randint(0, 256, (*hw, 3), dtype=np.uint8)),
                    ("gtFine", "gtFine_labelIds", rs.randint(0, 34, hw).astype(np.uint8)),
                    ("disparity", "disparity", disparity)):
                folder = osp.join(root, top, split, "aachen")
                os.makedirs(folder, exist_ok=True)
                with open(osp.join(folder, f"aachen_{i:06d}_000019_{suffix}.png"), "wb") as f:
                    f.write(encode_png(arr))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each preset through tools/train.py (one step, then validation),
    tools/test.py --out and tools/infer.py on one tree."""
    tmp = tmp_path_factory.mktemp("presets")
    tree = str(tmp / "cityscapes")
    _write_tree(tree, np.random.RandomState(34))
    out = {}
    for config, tag in ((VITL, "vitl14"), (SEG, "seg")):
        archive = str(tmp / f"{tag}.pt")
        write_stub_clip(archive, *ARCHIVE[config])
        sets = ["--set", *SETS[config], f"data.path={tree}", f"model.clip_pretrained={archive}",
                "training.lr_mults.backbone=0.1"]
        wd = str(tmp / f"wd_{tag}")
        summary = train_tool.main([config, "--device", "cpu", "--max-steps", "1",
                                   "--work-dir", wd, *sets])
        npz = str(tmp / f"{tag}.npz")
        results = test_tool.main([config, wd, "--device", "cpu", "--mode", "slide",
                                  "--out", npz, *sets])
        images = osp.join(tree, "leftImg8bit", "val", "aachen")
        written = infer_tool.main([config, wd, images, "-o", str(tmp / f"inf_{tag}"),
                                   "--mode", "slide", "--device", "cpu", *sets])
        inputs = infer_tool.image_paths(images)
        out[config] = {"tree": tree, "archive": archive, "sets": sets, "wd": wd,
                       "summary": summary, "results": results, "npz": np.load(npz),
                       "written": written, "inputs": inputs}
    return out


@pytest.mark.parametrize("config", [VITL, SEG], ids=["vitl14", "seg_only"])
def test_entry_points_train_validate_score_and_infer(runs, config):
    run = runs[config]
    assert run["summary"]["step"] == 1.0 and np.isfinite(run["summary"]["loss_total"])
    assert np.isfinite(run["summary"]["miou"])
    with open(osp.join(run["wd"], "train.log")) as f:
        log = f.read()
    assert f"loaded CLIP weights from {run['archive']}: " in log and " / 17 text tensors" in log
    assert "frozen modules: ['text_encoder']" in log  # the backbone at lr x0.1
    depth = config == VITL
    names = ["input", "seg pred", "seg gt"] + (["depth pred", "depth gt"] if depth else [])
    for panel in ("epoch_0.png", "best_epoch_0.png"):
        with open(osp.join(run["wd"], "visualizations", panel), "rb") as f:
            assert [n for n, _ in read_panels(f.read())[1]] == names
    assert osp.exists(osp.join(run["wd"], "visualizations", "comparison_epoch_0.png"))
    assert np.isfinite(run["results"]["mIoU"]) and np.isfinite(run["results"]["ref/mIoU"])
    assert ("depth/abs_rel" in run["results"]) == depth
    assert sorted(run["npz"].files) == sorted(
        [f"seg_{i}" for i in range(2)] + ([f"depth_{i}" for i in range(2)] if depth else []))
    kinds = ["seg", "depth"] if depth else ["seg"]
    assert sorted(osp.basename(p) for p in run["written"]) == sorted(
        f"{osp.splitext(osp.basename(p))[0]}_{k}.png" for p in run["inputs"] for k in kinds)


@pytest.mark.parametrize("config", [VITL, SEG], ids=["vitl14", "seg_only"])
def test_first_step_loss_matches_jax(runs, config):
    """The training forward (every dropout 0; ViT-L/14 under remat) and the
    preset's loss on the same decoded batch with the same imported weights."""
    run = runs[config]
    sets = run["sets"][1:] + NO_DROPOUT if config == VITL else run["sets"][1:] + NO_DROPOUT[:1]
    tcfg, jcfg = t_load(config, overrides=sets), j_load(config, overrides=sets)
    ds = build_dataset(tcfg.data, "train")
    samples = [ds[0], ds[1]]
    ch, cw = tcfg.data.crop_size
    image = normalize_image(torch.from_numpy(np.stack([s["image"][:ch, :cw] for s in samples])),
                            tcfg.data.norm_mean, tcfg.data.norm_std).numpy()
    seg = np.stack([s["seg"][:ch, :cw] for s in samples]).astype(np.int32)
    silog_w = float(tcfg.training.loss_weights.silog)

    jm, texts = j_build(jcfg.model, CITYSCAPES_CLASSES)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(texts))
    variables, _, _ = j_ci.load_clip_into_variables(jax.tree.map(np.asarray, variables),
                                                    run["archive"], jcfg.model)
    out, _ = jm.apply(variables, jnp.asarray(image), jnp.asarray(texts), train=True,
                      gt_hw=(ch, cw), mutable=["batch_stats"],
                      rngs={"dropout": jax.random.PRNGKey(1)})
    want = j_losses.cross_entropy_loss(out["seg"], jnp.asarray(seg))
    model, t_texts = t_build(tcfg.model, CITYSCAPES_CLASSES, device="cpu",
                             remat=tcfg.tpu.get("remat", False))
    from denseclip_vit_multimodal_tpu_torch.convert import load_flax_variables

    load_flax_variables(model, {"params": variables["params"],
                                "batch_stats": variables["batch_stats"]})
    load_clip_into_model(model, run["archive"], tcfg.model)
    model.train()
    got_out = model(torch.from_numpy(image), t_texts, train=True, gt_hw=(ch, cw),
                    gen=torch.Generator().manual_seed(0))
    got = t_losses.cross_entropy_loss(got_out["seg"], torch.from_numpy(seg))
    if config == VITL:
        depth = np.stack([s["depth"][:ch, :cw] for s in samples])
        want = want + silog_w * j_losses.silog_loss(out["depth"], jnp.asarray(depth),
                                                     jnp.asarray(depth > 0))
        got = got + silog_w * t_losses.silog_loss(got_out["depth"], torch.from_numpy(depth),
                                                  torch.from_numpy(depth > 0))
    else:
        assert out.get("depth") is None and got_out.get("depth") is None and silog_w == 0.0
    got.backward()  # through the recomputed blocks under remat
    assert model.backbone.patch_embed.weight.grad is not None
    assert np.isfinite(float(want)) and float(got) == pytest.approx(float(want), rel=TOL_LOSS)
