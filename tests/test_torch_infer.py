"""Slide inference and the Inferencer of the PyTorch port against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.data.augment import AugmentConfig as JAugmentConfig
from denseclip_vit_multimodal_tpu.infer import slide as j_slide
from denseclip_vit_multimodal_tpu.infer.engine import Inferencer as JInferencer
from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu_torch.convert import load_flax_variables
from denseclip_vit_multimodal_tpu_torch.data.augment import normalize_image
from denseclip_vit_multimodal_tpu_torch.infer import slide as t_slide
from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer as TInferencer
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build

# fp32 end to end (backbone, neck, heads, upsample, overlap-add): 1e-4.
TOL = 1e-4
FRAME = (1, 128, 256, 3)
# 3 x 3 = 9 windows of 64x96; window_batch 4 pads the last chunk with 3 duplicates
CROP, STRIDE, WINDOW_BATCH = (64, 96), (48, 80), 4


def head_res_forward(win):
    """A shape-sensitive stand-in model: 2x2 average pool (half resolution)."""
    n, h, w, c = win.shape
    return win.reshape(n, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))


@pytest.mark.parametrize("window_batch", [0, 4])
def test_slide_inference_matches_jax(window_batch):
    x = np.random.RandomState(0).rand(2, 96, 160, 5).astype(np.float32)
    want = j_slide.slide_inference(head_res_forward, jnp.asarray(x), 5, crop=(64, 64),
                                   stride=(48, 48), window_batch=window_batch)
    got = t_slide.slide_inference(head_res_forward, torch.from_numpy(x), 5, crop=(64, 64),
                                  stride=(48, 48), window_batch=window_batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_slide_identity_forward_averages_to_input():
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 96, 160, 4).astype(np.float32))
    out = t_slide.slide_inference(lambda w: w, x, 4, crop=(64, 64), stride=(48, 48))
    torch.testing.assert_close(out, x, rtol=1e-5, atol=1e-6)


def test_slide_grid_helpers_match_jax():
    for args in [((1024, 2048), (624, 624), (426, 426)), ((128, 256), CROP, STRIDE)]:
        assert t_slide.slide_grid(*args) == j_slide.slide_grid(*args)
        np.testing.assert_array_equal(t_slide.count_map(*args), j_slide.count_map(*args))
    assert len(t_slide.slide_grid((1024, 2048), (624, 624), (426, 426))) == 10


def test_normalize_image_matches_jax():
    from denseclip_vit_multimodal_tpu.data.augment import normalize_image as j_normalize

    img = np.random.RandomState(2).randint(0, 256, FRAME, dtype=np.uint8)
    cfg = JAugmentConfig()
    want = j_normalize(jnp.asarray(img), cfg.norm_mean, cfg.norm_std)
    got = normalize_image(torch.from_numpy(img), cfg.norm_mean, cfg.norm_std)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def engines(tiny_model_cfg):
    cfg = dict(tiny_model_cfg)
    cfg["text_encoder"] = dict(cfg["text_encoder"], transformer_layers=2)
    jm, texts = j_build(cfg, CITYSCAPES_CLASSES)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3), jnp.float32),
                        jnp.asarray(texts))
    rs = np.random.RandomState(3)
    variables = {
        "params": jax.tree.map(np.asarray, variables["params"]),
        "batch_stats": jax.tree.map(lambda a: (rs.rand(*a.shape) + 0.5).astype(np.float32),
                                    variables["batch_stats"]),
    }
    tm, _ = t_build(cfg, CITYSCAPES_CLASSES, device="cpu")
    load_flax_variables(tm, variables)
    j_engine = JInferencer(jm, variables, texts, num_classes=19, with_depth=True)
    t_engine = TInferencer(tm, texts, num_classes=19)
    frame = np.random.RandomState(4).randint(0, 256, FRAME, dtype=np.uint8)
    return j_engine, t_engine, frame


def _check_logits(want, got):
    np.testing.assert_allclose(got["seg_logits"], want["seg_logits"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got["depth"], want["depth"], atol=TOL, rtol=TOL)
    # argmax agrees wherever the top two logits are not within the tolerance
    top2 = np.sort(want["seg_logits"], axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 10 * TOL
    np.testing.assert_array_equal(got["seg"][clear], want["seg"][clear])
    assert clear.mean() > 0.9  # random-init logits: a few pixels are near-ties


@pytest.mark.parametrize("mode", ["slide", "whole"])
def test_predict_matches_jax(engines, mode):
    j_engine, t_engine, frame = engines
    kw = dict(mode=mode, crop=CROP, stride=STRIDE, window_batch=WINDOW_BATCH)
    want = j_engine.predict(frame, **kw)
    got = t_engine.predict(frame, **kw)
    assert got["seg_logits"].shape == (1, 128, 256, 19) and got["seg"].dtype == np.int32
    assert got["depth"].shape == (1, 128, 256) and got["depth"].dtype == np.float32
    _check_logits(want, got)


def test_predict_fetch_policies(engines):
    _, t_engine, frame = engines
    kw = dict(mode="slide", crop=CROP, stride=STRIDE, window_batch=WINDOW_BATCH)
    full = t_engine.predict(frame, fetch="logits", **kw)
    arg = t_engine.predict(frame, fetch="argmax", **kw)
    assert "seg_logits" not in arg
    np.testing.assert_array_equal(arg["seg"], full["seg"])
    np.testing.assert_array_equal(arg["depth"], full["depth"])
    packed = t_engine.predict(frame, fetch="packed", **kw)
    assert packed["seg"].dtype == np.uint8 and packed["depth"].dtype == np.float16
    np.testing.assert_array_equal(packed["seg"], full["seg"].astype(np.uint8))
    np.testing.assert_allclose(packed["depth"].astype(np.float32), full["depth"],
                               rtol=2e-3, atol=1e-3)  # float16 cast
    dev = t_engine.predict(frame, fetch="device", **kw)
    assert isinstance(dev["seg_logits"], torch.Tensor)
    np.testing.assert_array_equal(dev["seg"].numpy(), full["seg"])
    np.testing.assert_array_equal(dev["seg_logits"].numpy(), full["seg_logits"])
    with pytest.raises(ValueError, match="fetch"):
        t_engine.predict(frame, fetch="nope", **kw)
    with pytest.raises(ValueError, match="mode"):
        t_engine.predict(frame, mode="aug")


def test_preprocessed_input_and_text_cache(engines):
    _, t_engine, frame = engines
    kw = dict(mode="whole", fetch="logits")
    cfg = t_engine.aug_cfg
    pre = normalize_image(torch.from_numpy(frame), cfg.norm_mean, cfg.norm_std)
    a = t_engine.predict(frame, **kw)
    b = t_engine.predict(pre, preprocessed=True, **kw)
    np.testing.assert_array_equal(a["seg_logits"], b["seg_logits"])
    cached = t_engine._text_base()
    assert cached is t_engine._text_base()  # computed once per weights
    with torch.no_grad():
        t_engine.model.text_encoder.ln_final.bias.add_(1.0)
    assert t_engine._text_base() is not cached  # new weights, new tower output
    with torch.no_grad():
        t_engine.model.text_encoder.ln_final.bias.sub_(1.0)
