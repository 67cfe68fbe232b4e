"""Data pipeline of the port against the JAX package's, on the CPU: the
augmentation resamplers with a given geometry, the geometry sampler's ranges,
the synthetic dataset, the loader's order and the dataset dispatch."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.data import augment as j_aug
from denseclip_vit_multimodal_tpu.data import loader as j_loader
from denseclip_vit_multimodal_tpu.data.synthetic import SyntheticDataset as JSynthetic
from denseclip_vit_multimodal_tpu_torch.core.config import Config, load_config
from denseclip_vit_multimodal_tpu_torch.data import augment as t_aug
from denseclip_vit_multimodal_tpu_torch.data import loader as t_loader
from denseclip_vit_multimodal_tpu_torch.data.synthetic import SyntheticDataset as TSynthetic

# fp32 resampling: the same products summed in another order.
TOL = 1e-4

SRC_HW = (32, 48)
CROP = (24, 40)
GEOMETRIES = {
    # (sy, sx, oy, ox, flip), as _sample_geometry draws them: scale = round(s * n) / n
    "upscale": (48 / 32, 72 / 48, 5.0, 10.0, False),
    "downscale_centred_pad": (16 / 32, 24 / 48, -4.0, -8.0, False),
    "flip": (40 / 32, 60 / 48, 3.0, 7.0, True),
    "mixed_pad_rows": (20 / 32, 72 / 48, -2.0, 4.0, True),
}


def _sample(seed=0):
    rs = np.random.RandomState(seed)
    image = rs.randint(0, 256, SRC_HW + (3,)).astype(np.uint8)
    seg = rs.randint(0, 19, SRC_HW).astype(np.uint8)
    seg[rs.rand(*SRC_HW) < 0.1] = 255
    depth = rs.uniform(1.0, 80.0, SRC_HW).astype(np.float32)
    depth[rs.rand(*SRC_HW) < 0.2] = 0.0
    return image, seg, depth


def _jax_augment(image, seg, depth, geometry):
    sy, sx, oy, ox = (jnp.float32(g) for g in geometry[:4])
    flip = jnp.bool_(geometry[4])
    y, x = j_aug._source_coords_1d(sy, sx, oy, ox, flip, CROP, SRC_HW)
    wy, wx, wy_nn, wx_nn = j_aug._interp_matrices(y, x, SRC_HW)
    img = j_aug._resample_bilinear_mm(jnp.asarray(image, jnp.float32), wy, wx)
    d = j_aug._resample_nearest_mm(jnp.asarray(depth), wy_nn, wx_nn, 0.0)
    cfg = j_aug.AugmentConfig(crop_size=CROP)
    return {
        "coords": (np.asarray(y), np.asarray(x)),
        "image": np.asarray(j_aug.normalize_image(img, cfg.norm_mean, cfg.norm_std)),
        "seg": np.asarray(j_aug._resample_nearest_mm(jnp.asarray(seg, jnp.int32), wy_nn, wx_nn, 255)),
        "depth": np.asarray(d),
        "depth_mask": np.asarray(d > 0.0),
    }


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_augment_sample_matches_jax(name):
    geometry = GEOMETRIES[name]
    image, seg, depth = _sample()
    want = _jax_augment(image, seg, depth, geometry)
    y, x = t_aug._source_coords_1d(geometry, CROP, SRC_HW)
    np.testing.assert_allclose(y.numpy(), want["coords"][0], atol=1e-6)
    np.testing.assert_allclose(x.numpy(), want["coords"][1], atol=1e-6)
    got = t_aug.augment_sample(torch.from_numpy(image), torch.from_numpy(seg),
                               torch.from_numpy(depth), t_aug.AugmentConfig(crop_size=CROP),
                               geometry)
    assert got["image"].shape == CROP + (3,) and got["image"].dtype == torch.float32
    np.testing.assert_allclose(got["image"].numpy(), want["image"], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got["seg"].numpy(), want["seg"])
    np.testing.assert_array_equal(got["depth"].numpy(), want["depth"])
    np.testing.assert_array_equal(got["depth_mask"].numpy(), want["depth_mask"])
    if name.startswith("downscale"):  # centred pad: fill values around the image
        assert (got["seg"][:4] == 255).all() and (got["depth"][:, :8] == 0).all()
        assert not got["depth_mask"][:4].any()
        pad_pixel = t_aug.normalize_image(torch.zeros(3), t_aug.AugmentConfig().norm_mean,
                                          t_aug.AugmentConfig().norm_std)
        torch.testing.assert_close(got["image"][0, 0], pad_pixel)


def test_sample_geometry_ranges():
    cfg = t_aug.AugmentConfig(crop_size=(640, 640))
    gen = torch.Generator().manual_seed(0)
    h, w = 1024, 2048
    flips = []
    for _ in range(400):
        sy, sx, oy, ox, flip = t_aug._sample_geometry(gen, (h, w), cfg)
        for s, n, o, c in ((sy, h, oy, 640), (sx, w, ox, 640)):
            scaled = round(s * n)
            assert 0.5 * n - 1 <= scaled <= 2.0 * n + 1 and abs(s * n - scaled) < 1e-3
            assert o == int(o)
            if scaled >= c:
                assert 0 <= o <= scaled - c
            else:
                assert o == -((c - scaled) // 2)
        assert sy == pytest.approx(sx, abs=2e-3)  # one scale for both axes
        flips.append(flip)
    assert 0.4 < np.mean(flips) < 0.6


def test_augment_batch_shapes_and_determinism():
    cfg = t_aug.AugmentConfig(crop_size=CROP)
    image, seg, depth = _sample(1)
    batch = {"image": torch.from_numpy(np.stack([image, image])),
             "seg": torch.from_numpy(np.stack([seg, seg])),
             "depth": torch.from_numpy(np.stack([depth, depth]))}
    a = t_aug.augment_batch(batch, cfg, torch.Generator().manual_seed(5))
    b = t_aug.augment_batch(batch, cfg, torch.Generator().manual_seed(5))
    assert a["image"].shape == (2,) + CROP + (3,) and a["seg"].shape == (2,) + CROP
    for key in a:
        assert torch.equal(a[key], b[key])
    assert not torch.equal(a["image"][0], a["image"][1])  # each sample draws its own geometry


def test_augment_config_from_heritage_preset():
    data = load_config(Path(__file__).resolve().parents[1] / "configs"
                       / "denseclip_vitb16_640x640_80k.yaml").data
    cfg = t_aug.augment_config_from_data_cfg(data)
    want = j_aug.augment_config_from_data_cfg(data.to_dict())
    assert cfg.crop_size == (640, 640) == tuple(want.crop_size)
    assert (cfg.scale_range, cfg.hflip_prob, cfg.norm_mean, cfg.norm_std, cfg.ignore_index) == (
        tuple(want.scale_range), want.hflip_prob, tuple(want.norm_mean), tuple(want.norm_std),
        want.ignore_index)
    # `color_jitter: true` maps to the reference's ColorJitter, as in the JAX package
    jitter = t_aug.augment_config_from_data_cfg(Config({"color_jitter": True}))
    want = j_aug.augment_config_from_data_cfg({"color_jitter": True})
    assert (jitter.brightness, jitter.contrast, jitter.saturation, jitter.hue,
            jitter.color_jitter_prob) == (want.brightness, want.contrast, want.saturation,
                                          want.hue, want.color_jitter_prob) == (0.4, 0.4, 0.4,
                                                                                0.1, 0.8)


@pytest.mark.parametrize("kw", [{}, {"learnable": True}, {"with_depth": False, "seed": 3}])
def test_synthetic_dataset_matches_jax(kw):
    args = dict(length=5, image_size=(96, 160), **kw)
    j, t = JSynthetic(**args), TSynthetic(**args)
    assert len(j) == len(t) == 5
    for idx in (0, 4):
        a, b = j[idx], t[idx]
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_loader_epochs_match_jax():
    ds = TSynthetic(length=7, image_size=(64, 96))
    j = j_loader.DataLoader(JSynthetic(length=7, image_size=(64, 96)), batch_size=2, seed=11,
                            num_threads=2, process_index=0, process_count=1)
    t = t_loader.DataLoader(ds, batch_size=2, seed=11, num_threads=2)
    assert len(t) == len(j) == 3
    for epoch in (0, 1):
        got, want = list(t.epoch(epoch)), list(j.epoch(epoch))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            for key in b:
                np.testing.assert_array_equal(a[key], b[key])
    moved = t_loader.to_device(got[0], "cpu")
    assert moved["image"].dtype == torch.uint8 and moved["image"].shape == (2, 64, 96, 3)


def test_build_dataset_synthetic_and_refusals():
    data = {"synthetic": True, "synthetic_options": {"image_size": [64, 128], "length": 3}}
    t = t_loader.build_dataset(Config(data), "train")
    j = j_loader.build_dataset(data, "train")
    np.testing.assert_array_equal(t[1]["image"], j[1]["image"])
    assert t_loader.build_dataset(Config(data), "val").seed == j_loader.build_dataset(data, "val").seed
    # the Cityscapes readers are rooted at data.path, as in the JAX package
    for kind in ("CityscapesDepthSegDataset", "CityscapesDataset"):
        with pytest.raises(RuntimeError, match="Image directory not found: /nonexistent"):
            t_loader.build_dataset(Config({"dataset_type": kind, "path": "/nonexistent"}), "train")
        with pytest.raises(RuntimeError, match="Image directory not found: /nonexistent"):
            j_loader.build_dataset({"dataset_type": kind, "path": "/nonexistent"}, "train")
    # ADE20K is ported: rooted at data.path, it refuses a missing tree as JAX does;
    # an unknown type raises JAX's message
    for kind in ("ADE20K", "ADE20KSegmentation"):
        with pytest.raises(RuntimeError, match="Image directory not found: /nonexistent"):
            t_loader.build_dataset(Config({"dataset_type": kind, "path": "/nonexistent"}), "train")
        with pytest.raises(RuntimeError, match="Image directory not found: /nonexistent"):
            j_loader.build_dataset({"dataset_type": kind, "path": "/nonexistent"}, "train")
    with pytest.raises(ValueError, match="Unsupported dataset_type: NoSuchDataset"):
        t_loader.build_dataset(Config({"dataset_type": "NoSuchDataset"}), "train")
