"""Evaluation in the PyTorch port against the JAX package: the metrics,
multi-scale + flip `aug_test` with `eval_metrics`, the validation step, and
the port's `tools/test.py` end to end (all fp32 on the CPU, tiny model)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.data.augment import AugmentConfig as JAugmentConfig
from denseclip_vit_multimodal_tpu.infer.engine import Inferencer as JInferencer
from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.train import metrics as j_metrics
from denseclip_vit_multimodal_tpu.train.state import create_train_state as j_create_state
from denseclip_vit_multimodal_tpu.train.step import make_eval_step as j_make_eval_step
from denseclip_vit_multimodal_tpu_torch.convert import load_flax_variables
from denseclip_vit_multimodal_tpu_torch.data.augment import AugmentConfig, eval_preprocess_batch
from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer as TInferencer
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.models.layers import resize_bilinear
from denseclip_vit_multimodal_tpu_torch.train import metrics as t_metrics
from denseclip_vit_multimodal_tpu_torch.train.state import TrainState
from denseclip_vit_multimodal_tpu_torch.train.step import make_eval_step as t_make_eval_step

TOL = 1e-4  # fp32 end to end, as tests/test_torch_infer.py
DEPTH_REL = 1e-6  # fp32 sums over ~1e4 pixels in another order
FRAME = (1, 64, 128, 3)
CROP, STRIDE = (64, 96), (48, 80)
SCALES = (0.5, 1.0, 1.5)


def _near_ties(logits, margin=10 * TOL):
    """Pixels whose top two logits are within `margin` (argmax ambiguous)."""
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= margin


def _labels(rs, shape, k=19):
    seg = rs.randint(0, k, shape).astype(np.int32)
    seg[rs.rand(*shape) < 0.1] = 255
    depth = (rs.rand(*shape) * 90.0).astype(np.float32)  # some beyond max_depth 80
    depth[rs.rand(*shape) < 0.2] = 0.0
    return seg, depth


def test_metrics_match_jax():
    rs = np.random.RandomState(0)
    seg, depth = _labels(rs, (2, 48, 80))
    preds = rs.randint(0, 21, seg.shape).astype(np.int32)  # 19, 20: outside the classes
    want = np.asarray(j_metrics.confusion_matrix(jnp.asarray(preds), jnp.asarray(seg), 19))
    got = t_metrics.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(seg), 19)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == ((seg != 255) & (preds < 19)).sum()

    j_miou, j_iou = j_metrics.miou_from_confusion(jnp.asarray(want))
    t_miou, t_iou = t_metrics.miou_from_confusion(got)
    np.testing.assert_allclose(t_iou.numpy(), np.asarray(j_iou), rtol=1e-6)
    np.testing.assert_allclose(float(t_miou), float(j_miou), rtol=1e-6)
    np.testing.assert_allclose(float(t_metrics.accuracy_from_confusion(got)),
                               float(j_metrics.accuracy_from_confusion(jnp.asarray(want))),
                               rtol=1e-6)

    pred_depth = (rs.rand(*depth.shape) * 100.0 - 5.0).astype(np.float32)  # clamped both ways
    j_sums, j_n = j_metrics.depth_errors(jnp.asarray(pred_depth), jnp.asarray(depth),
                                         jnp.asarray(depth > 0))
    t_sums, t_n = t_metrics.depth_errors(torch.from_numpy(pred_depth), torch.from_numpy(depth),
                                         torch.from_numpy(depth > 0))
    assert float(t_n) == float(j_n)
    for k in j_sums:
        np.testing.assert_allclose(float(t_sums[k]), float(j_sums[k]), rtol=DEPTH_REL, err_msg=k)
    j_fin = j_metrics.finalize_depth_errors(j_sums, j_n)
    t_fin = t_metrics.finalize_depth_errors(t_sums, t_n)
    for k in j_fin:
        np.testing.assert_allclose(float(t_fin[k]), float(j_fin[k]), rtol=DEPTH_REL, err_msg=k)


@pytest.fixture(scope="module")
def pair(tiny_model_cfg):
    """The same fp32 weights in a JAX model and a port model."""
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


@pytest.mark.parametrize("mode", ["whole", "slide"])
def test_aug_test_and_eval_metrics_match_jax(pair, mode):
    jm, variables, tm, texts = pair
    j_engine = JInferencer(jm, variables, texts, num_classes=19, with_depth=True)
    t_engine = TInferencer(tm, texts, num_classes=19)
    rs = np.random.RandomState(4)
    frame = rs.randint(0, 256, FRAME, dtype=np.uint8)
    kw = dict(scales=SCALES, flip=True, mode=mode, crop=CROP, stride=STRIDE, window_batch=4)
    want = j_engine.aug_test(frame, **kw)
    got = t_engine.aug_test(frame, **kw)
    assert got["seg_logits"].shape == (1, 64, 128, 19) and got["depth"].shape == (1, 64, 128)
    np.testing.assert_allclose(got["seg_logits"], want["seg_logits"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got["depth"], want["depth"], atol=TOL, rtol=TOL)

    # eval_metrics on the device outputs, against JAX's on its own outputs;
    # pixels whose top two logits are within the tolerance are labelled
    # `ignore`, so that the two argmaxes must agree on every counted pixel
    seg_gt, depth_gt = _labels(rs, FRAME[:3])
    seg_gt[_near_ties(want["seg_logits"])] = 255
    depth_gt *= 0.05  # the random-init depth head predicts small depths
    t_dev = t_engine.aug_test(frame, fetch="device", **kw)
    j_dev = j_engine.aug_test(frame, fetch="device", **kw)
    t_cm, t_sums, t_n = t_engine.eval_metrics(t_dev, seg_gt=seg_gt, depth_gt=depth_gt)
    j_cm, j_sums, j_n = j_engine.eval_metrics(j_dev, seg_gt=seg_gt, depth_gt=depth_gt)
    assert int(t_cm.sum()) > 0.8 * seg_gt.size
    np.testing.assert_array_equal(t_cm.numpy(), np.asarray(j_cm))
    assert float(t_n) == float(j_n) > 0
    for k in j_sums:
        np.testing.assert_allclose(float(t_sums[k]), float(j_sums[k]), rtol=1e-4, err_msg=k)
    assert t_engine.eval_metrics(t_dev) == (None, None, None)


def test_aug_test_views_and_validation(pair):
    """A single unflipped scale of 1.0 is `predict`; a bad mode raises."""
    _, _, tm, texts = pair
    engine = TInferencer(tm, texts, num_classes=19)
    frame = np.random.RandomState(5).randint(0, 256, FRAME, dtype=np.uint8)
    one = engine.aug_test(frame, scales=(1.0,), flip=False)
    plain = engine.predict(frame)
    np.testing.assert_allclose(one["seg_logits"], plain["seg_logits"], atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        engine.aug_test(frame, mode="aug")


def test_eval_step_matches_jax(pair):
    jm, variables, tm, texts = pair
    rs = np.random.RandomState(6)
    seg, depth = _labels(rs, (2, 96, 160))
    depth *= 0.05
    batch = {"image": rs.randint(0, 256, (2, 96, 160, 3), dtype=np.uint8), "seg": seg,
             "depth": depth}
    crop = (64, 128)  # the input is resized (shrunk, antialiased) to the crop
    with torch.no_grad():  # the port's logits at the labels' size, to find near-ties
        pre = eval_preprocess_batch({"image": torch.from_numpy(batch["image"])},
                                    AugmentConfig(crop_size=crop))
        logits = resize_bilinear(tm(pre["image"], texts)["seg"], (96, 160), antialias=True)
    ties = _near_ties(logits.numpy(), margin=1e-3)
    batch["seg"][ties] = 255
    j_state = j_create_state(jm, variables, {}, 1)
    j_step = j_make_eval_step(jnp.asarray(texts), JAugmentConfig(crop_size=crop), 19)
    want = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()})
    t_step = t_make_eval_step(texts, AugmentConfig(crop_size=crop), 19)
    got = t_step(TrainState(tm, None), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(got["seg_pred"].numpy()[~ties],
                                  np.asarray(want["seg_pred"])[~ties])
    np.testing.assert_array_equal(got["confusion"].numpy(), np.asarray(want["confusion"]))
    np.testing.assert_allclose(got["depth_pred"].numpy(), np.asarray(want["depth_pred"]),
                               atol=TOL, rtol=TOL)
    assert float(got["depth_count"]) == float(want["depth_count"]) > 0
    for k in want["depth_sums"]:
        np.testing.assert_allclose(float(got["depth_sums"][k]), float(want["depth_sums"][k]),
                                   rtol=1e-4, err_msg=k)
    for k in ("loss_seg", "loss_silog"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


# The flagship preset cut to a tiny size, fp32, on synthetic 64x128 frames;
# the text tower is narrow so that the checkpoint stays small.
CLI_TINY = [
    "model.backbone.width=96", "model.backbone.layers=2", "model.backbone.heads=3",
    "model.backbone.out_indices=[0,1]", "model.text_encoder.transformer_layers=1",
    "model.text_encoder.transformer_width=64", "model.text_encoder.transformer_heads=2",
    "model.token_embed_dim=64",
    "model.neck.inter_channels=16", "model.neck.out_channels=32",
    "model.decode_head.in_channels=32", "model.decode_head.channels=32",
    "model.depth_head.in_channels=32", "model.depth_head.channels=16",
    "data.synthetic=true", "data.synthetic_options.image_size=[64,128]",
    "data.synthetic_options.length=2", "tpu.compute_dtype=float32",
]


def test_test_cli_end_to_end(tmp_path, capsys):
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config
    from denseclip_vit_multimodal_tpu_torch.data.loader import build_dataset
    from denseclip_vit_multimodal_tpu_torch.tools import test as test_cli
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import save_checkpoint
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state

    config = "configs/denseclip_vitb16_cityscapes_multitask.yaml"
    cfg = load_config(config, overrides=CLI_TINY)
    # other weights than the CLI's seeded init: the restore must take effect
    model, texts = t_build(cfg.model, CITYSCAPES_CLASSES, device="cpu", seed=7)
    save_checkpoint(str(tmp_path), create_train_state(model, cfg.training, 1), epoch=3)

    results = test_cli.main([config, str(tmp_path), "--aug-test", "--eval", "mIoU", "depth",
                             "--device", "cpu", "--set", *CLI_TINY])
    printed = capsys.readouterr().out
    assert "restored checkpoint at epoch 3" in printed
    assert float(re.search(r"^mIoU: ([0-9.]+)$", printed, re.M).group(1)) == pytest.approx(
        results["mIoU"], abs=5e-5)
    assert results["images_per_sec"] > 0  # one timed frame after the first
    for key in ("mIoU", "pixel_acc", "iou/road", "depth/abs_rel", "depth/rmse", "depth/a1"):
        assert np.isfinite(results[key]), key

    # the same numbers from aug_test + eval_metrics on the saved model directly
    engine = TInferencer(model, texts, num_classes=19)
    ds = build_dataset(cfg.data, "val")
    cm, sums, count = None, None, None
    for i in range(len(ds)):
        sample = ds[i]
        out = engine.aug_test(sample["image"][None], fetch="device")
        c, s, n = engine.eval_metrics(out, seg_gt=sample["seg"][None],
                                      depth_gt=sample["depth"][None])
        cm = c if cm is None else cm + c
        sums = s if sums is None else {k: sums[k] + s[k] for k in sums}
        count = n if count is None else count + n
    assert results["mIoU"] == pytest.approx(float(t_metrics.miou_from_confusion(cm)[0]), abs=1e-7)
    depth = t_metrics.finalize_depth_errors(sums, count)
    assert results["depth/rmse"] == pytest.approx(float(depth["rmse"]), rel=1e-6)
