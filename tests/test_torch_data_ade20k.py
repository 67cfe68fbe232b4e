"""The port's ADE20K reader against the JAX package's (which reads through
Pillow): one on-disk tree of mixed JPEG kinds and sizes, the same samples in
the same order, `image` and `seg` bit for bit on the 512x683 canvas; a
corrupt file gives None in both; a progressive file gives None in the port
with a warning naming the mode; the loader's batches; `class_names_for` and
the 150 tokenised prompts.
"""

import logging
import os
import os.path as osp

import numpy as np
import pytest

from denseclip_vit_multimodal_tpu_torch.core.config import Config
from denseclip_vit_multimodal_tpu_torch.data import ade20k as t_ade
from denseclip_vit_multimodal_tpu_torch.data import loader as t_loader
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.train.loop import class_names_for as t_class_names_for

# the references: Pillow and the JAX package (absent on the card: the file skips)
Image = pytest.importorskip("PIL.Image")
j_ade = pytest.importorskip("denseclip_vit_multimodal_tpu.data.ade20k")
j_loader = pytest.importorskip("denseclip_vit_multimodal_tpu.data.loader")
j_build = pytest.importorskip("denseclip_vit_multimodal_tpu.models.denseclip").build_denseclip
j_class_names_for = pytest.importorskip("denseclip_vit_multimodal_tpu.train.loop").class_names_for

# (name, height, width, Pillow save options): ADE20K's varied sizes and the
# JPEG kinds the decoder takes
TRAIN = [
    ("ADE_train_00000001", 96, 128, {"quality": 90}),
    ("ADE_train_00000002", 128, 96, {"quality": 75, "subsampling": 0}),
    ("ADE_train_00000003", 75, 101, {"quality": 95, "subsampling": 1, "optimize": True}),
    ("ADE_train_00000004", 683, 512, {"quality": 50, "restart_marker_blocks": 5}),
    ("ADE_train_00000005", 61, 47, {"gray": True, "quality": 85}),
    ("ADE_train_00000006", 512, 683, {"quality": 100}),
]
VAL = [
    ("ADE_val_00000001", 480, 640, {"quality": 90}),
    ("ADE_val_00000002", 33, 17, {"quality": 70, "subsampling": 0}),
]


def _write_split(root, split, items, rs):
    img_dir = osp.join(root, "ADEChallengeData2016", "images", split)
    ann_dir = osp.join(root, "ADEChallengeData2016", "annotations", split)
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    for name, h, w, opts in items:
        opts = dict(opts)
        y, x = np.mgrid[0:h, 0:w]
        img = np.stack([x * 255 // w, y * 255 // h, (x * y) % 256], -1)
        img = np.clip(img + rs.randint(-40, 41, img.shape), 0, 255).astype(np.uint8)
        pil = Image.fromarray(img[..., 0] if opts.pop("gray", False) else img)
        pil.save(osp.join(img_dir, f"{name}.jpg"), **opts)
        label = rs.randint(0, 151, (h, w)).astype(np.uint8)
        label[0, 0] = 0  # background -> ignore
        Image.fromarray(label, mode="L").save(osp.join(ann_dir, f"{name}.png"))
    # an image without its annotation is skipped at scan time
    Image.fromarray(rs.randint(0, 256, (32, 32, 3), dtype=np.uint8)).save(
        osp.join(img_dir, "ADE_orphan.jpg"))
    return img_dir, ann_dir


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ade20k"))
    rs = np.random.RandomState(1)
    _write_split(root, "training", TRAIN, rs)
    _write_split(root, "validation", VAL, rs)
    return root


@pytest.mark.parametrize("split,alias", [("training", "train"), ("validation", "val")])
def test_samples_match_jax_bitwise(tree, split, alias):
    t = t_ade.ADE20KSegmentation(tree, split=alias)
    j = j_ade.ADE20KSegmentation(tree, split=split)
    assert len(t) == len(j) == len(TRAIN if split == "training" else VAL)
    assert t.samples == j.samples  # same order, orphan skipped
    for i in range(len(t)):
        got, want = t[i], j[i]
        assert got["image"].shape == (512, 683, 3) and got["image"].dtype == np.uint8
        np.testing.assert_array_equal(got["image"], want["image"], err_msg=t.samples[i][0])
        np.testing.assert_array_equal(got["seg"], want["seg"], err_msg=t.samples[i][1])
        assert got["seg"].dtype == want["seg"].dtype == np.uint8
        assert set(np.unique(got["seg"])) <= set(range(150)) | {255}


def test_other_canvas_and_remap_match_jax(tree):
    t = t_ade.ADE20KSegmentation(tree, split="train", canvas_size=(64, 96), ignore_index=250)
    j = j_ade.ADE20KSegmentation(tree, split="train", canvas_size=(64, 96), ignore_index=250)
    for i in range(len(t)):
        np.testing.assert_array_equal(t[i]["image"], j[i]["image"])
        np.testing.assert_array_equal(t[i]["seg"], j[i]["seg"])
    labels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(t_ade.remap_labels(labels), j_ade.remap_labels(labels))
    assert t_ade.ADE20K_CLASSES == j_ade.ADE20K_CLASSES and t_ade.NUM_CLASSES == 150


def _copy_tree(src, dst):
    import shutil

    shutil.copytree(src, dst)
    return str(dst)


def test_corrupt_file_gives_none_in_both(tree, tmp_path):
    root = _copy_tree(tree, tmp_path / "corrupt")
    path = osp.join(root, "ADEChallengeData2016", "images", "validation", "ADE_val_00000001.jpg")
    with open(path, "r+b") as f:
        data = f.read()
        f.seek(0)
        f.write(data[: len(data) // 3])
        f.truncate()
    t = t_ade.ADE20KSegmentation(root, split="val")
    j = j_ade.ADE20KSegmentation(root, split="val")
    assert t[0] is None and j[0] is None
    np.testing.assert_array_equal(t[1]["image"], j[1]["image"])


def test_progressive_file_is_skipped_with_a_warning(tree, tmp_path, caplog):
    root = _copy_tree(tree, tmp_path / "progressive")
    path = osp.join(root, "ADEChallengeData2016", "images", "validation", "ADE_val_00000002.jpg")
    Image.open(path).save(path, progressive=True)
    t = t_ade.ADE20KSegmentation(root, split="val")
    with caplog.at_level(logging.WARNING, logger=t_ade.__name__):
        assert t[1] is None and t[1] is None
    warned = [r.getMessage() for r in caplog.records if "ADE_val_00000002" in r.getMessage()]
    assert len(warned) == 1 and "progressive" in warned[0]  # one warning a file


def test_missing_directories_raise_as_in_jax(tmp_path):
    for split in ("train", "val"):
        with pytest.raises(RuntimeError, match="Image directory not found"):
            t_ade.ADE20KSegmentation(str(tmp_path), split=split)
    with pytest.raises(ValueError, match="Unknown ADE20K split: test"):
        t_ade.ADE20KSegmentation(str(tmp_path), split="test")


@pytest.mark.parametrize("kind", ["ADE20KSegmentation", "ADE20K"])
def test_build_dataset_and_loader(tree, kind):
    data = {"dataset_type": kind, "path": tree}
    t = t_loader.build_dataset(Config(data), "validation")
    j = j_loader.build_dataset(data, "validation")
    assert type(t).__name__ == type(j).__name__ == "ADE20KSegmentation"
    assert t.samples == j.samples
    loader = t_loader.DataLoader(t_loader.build_dataset(Config(data), "train"), batch_size=2,
                                 seed=3, num_threads=2)
    batches = list(loader.epoch(0))
    assert len(batches) == len(TRAIN) // 2
    for batch in batches:
        assert set(batch) == {"image", "seg"}  # no depth
        assert batch["image"].shape == (2, 512, 683, 3) and batch["seg"].shape == (2, 512, 683)


def test_class_names_and_prompts_match_jax():
    ade = {"dataset_type": "ADE20KSegmentation"}
    for data in (ade, {"dataset_type": "ADE20K"}, {"dataset_type": "CityscapesDataset"}, {}):
        assert t_class_names_for(Config(data)) == j_class_names_for(data)
    assert len(t_class_names_for(ade)) == 150
    model_cfg = {
        "type": "DenseCLIP", "text_dim": 32, "context_length": 5, "token_embed_dim": 64,
        "backbone": {"type": "CLIPVisionTransformer", "patch_size": 16, "width": 64,
                     "layers": 1, "heads": 2, "input_resolution": 32, "out_indices": [0]},
        "text_encoder": {"type": "CLIPTextContextEncoder", "context_length": 13,
                         "vocab_size": 49408, "transformer_width": 64, "transformer_heads": 2,
                         "transformer_layers": 1, "embed_dim": 32},
        "neck": {"type": "ViTFeatureFusionNeck", "inter_channels": 16, "out_channels": 32},
        "decode_head": {"type": "FCNHead", "in_channels": 32, "channels": 32,
                        "num_classes": 150},
    }
    _, want = j_build(model_cfg, j_class_names_for(ade))
    _, got = t_build(model_cfg, t_class_names_for(ade), device="cpu")
    assert got.shape[0] == 150
    np.testing.assert_array_equal(got, want)
