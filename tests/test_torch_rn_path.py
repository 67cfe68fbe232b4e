"""The original DenseCLIP architecture in the port, against the JAX package,
on the CPU at tiny sizes: the ResNet + attention pool, context decoder, FPN
with score-map concatenation model of `tests/test_resnet_path.py` (widened so
that `vis_proj` / `global_proj` exist), a ViT + context decoder model, the
first training step of the RN50 recipe, the inference engine, the RN50 preset
through `tools/train.py` and `tools/test.py`, the registry fallback,
`IdentityHead` and `CLIPTextEncoder`.

fp32 tolerances: max abs 1e-4 and relative L2 1e-5 (`torch_parity.py`).
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from denseclip_vit_multimodal_tpu.infer.engine import Inferencer as JInferencer
from denseclip_vit_multimodal_tpu.models import text as j_text
from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.train.losses import cross_entropy_loss as j_ce
from denseclip_vit_multimodal_tpu.train.state import create_train_state as j_state
from denseclip_vit_multimodal_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from denseclip_vit_multimodal_tpu_torch.core import registry
from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer as TInferencer
from denseclip_vit_multimodal_tpu_torch.models import text as t_text
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.train.losses import cross_entropy_loss as t_ce
from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state as t_state
from torch_parity import assert_parity, init, port, randn, t

TEXT = {"type": "CLIPTextContextEncoder", "context_length": 13, "vocab_size": 49408,
        "transformer_width": 64, "transformer_heads": 2, "transformer_layers": 2,
        "embed_dim": 32}
DECODER = {"type": "ContextDecoder", "transformer_width": 32, "transformer_heads": 2,
           "transformer_layers": 1, "dropout": 0.1}
TINY_RN = {  # tests/test_resnet_path.py's model, with output_dim 48 != text_dim 32
    "type": "DenseCLIP", "text_dim": 32, "context_length": 5, "token_embed_dim": 64,
    "context_feature": "attention", "score_concat_index": 3,
    "backbone": {"type": "CLIPResNetWithAttention", "layers": [1, 1, 1, 1], "width": 8,
                 "output_dim": 48, "input_resolution": 64},
    "text_encoder": TEXT, "context_decoder": DECODER,
    "neck": {"type": "FPN", "in_channels": [32, 64, 128, 256], "out_channels": 32,
             "num_outs": 4},
    "decode_head": {"type": "FPNHead", "in_channels": 32, "channels": 32, "num_classes": 19},
}
TINY_VIT_CD = {
    "type": "DenseCLIP", "text_dim": 32, "context_length": 5, "token_embed_dim": 64,
    "context_feature": "attention", "score_concat_index": -1,
    "backbone": {"type": "CLIPVisionTransformer", "patch_size": 16, "width": 64, "layers": 2,
                 "heads": 2, "input_resolution": 64, "out_indices": [0, 1]},
    "text_encoder": TEXT, "context_decoder": DECODER,
    "neck": {"type": "ViTFeatureFusionNeck", "inter_channels": 16, "out_channels": 32},
    "decode_head": {"type": "FPNHead", "in_channels": 32, "channels": 32, "num_classes": 19},
    "depth_head": {"type": "FCNHeadDepth", "in_channels": 32, "channels": 16},
}
IMG = randn(2, 72, 100, 3, seed=10)  # pool grid 2 x 3, base 2 x 2


def _pair(cfg, img=IMG, seed=0):
    jm, texts = j_build(cfg, CITYSCAPES_CLASSES)
    v = init(jm, jnp.asarray(img), jnp.asarray(texts), seed=seed)
    tm, t_texts = t_build(cfg, CITYSCAPES_CLASSES, device="cpu")
    np.testing.assert_array_equal(t_texts, texts)
    return jm, v, load_flax_variables(tm, v).eval(), texts


@pytest.fixture(scope="module")
def rn_pair():
    return _pair(TINY_RN)


FEATURES = ("seg", "score_map", "text_embeddings", "head_input")


@pytest.mark.parametrize("cached", [False, True], ids=["tower", "cached_text"])
def test_rn_model_matches_jax(rn_pair, cached):
    jm, v, tm, texts = rn_pair
    assert tm.vis_proj is not None and tm.gamma is not None
    j_cached = jm.apply(v, jnp.asarray(texts), method="encode_text_base") if cached else None
    want = jm.apply(v, jnp.asarray(IMG), jnp.asarray(texts), return_features=True,
                    cached_text=j_cached)
    with torch.no_grad():
        t_cached = tm.encode_text_base(texts) if cached else None
        got = tm(t(IMG), texts, return_features=True, cached_text=t_cached)
        plain = tm(t(IMG), texts)  # the score map still feeds the neck
    assert tuple(got["score_map"].shape) == (2, 2, 3, 19)
    for key in FEATURES:
        assert_parity(want[key], got[key], what=key)
    assert torch.equal(plain["seg"], got["seg"])


@pytest.mark.parametrize("feature", ["attention", "backbone"])
def test_vit_context_decoder_matches_jax(feature):
    """ViT width 64 against text width 32: `global_proj` and `vis_proj` feed
    the decoder's context (`attention`: global token + map; `backbone`: map)."""
    cfg = dict(TINY_VIT_CD, context_feature=feature)
    img = randn(2, 64, 96, 3, seed=11)
    jm, v, tm, texts = _pair(cfg, img)
    assert tm.global_proj is not None
    want = jm.apply(v, jnp.asarray(img), jnp.asarray(texts), return_features=True)
    with torch.no_grad():
        got = tm(t(img), texts, return_features=True)
    for key in FEATURES + ("depth",):
        assert_parity(want[key], got[key], what=key)


def test_rn_first_train_step_matches_jax():
    """The RN50 recipe's first step (backbone lr x0.1, text tower frozen,
    every BatchNorm on its batch statistics): the loss, the gradients of
    `gamma`, `contexts`, `vis_proj`, `global_proj`, the decoder and a
    backbone conv, the updated parameters and running statistics.  Dropout
    is 0 in this copy, so the training forward is deterministic."""
    cfg = copy.deepcopy(TINY_RN)
    cfg["context_decoder"]["dropout"] = 0.0
    cfg["decode_head"]["dropout_ratio"] = 0.0
    img = randn(2, 64, 96, 3, seed=12)
    seg = np.random.RandomState(13).randint(0, 19, (2, 64, 96)).astype(np.int32)
    seg[:, :4] = 255
    jm, v, tm, texts = _pair(cfg, img)
    tcfg = {"optimizer": {"type": "AdamW", "lr": 1e-3, "weight_decay": 1e-4},
            "scheduler": {"type": "constant"}, "lr_mults": {"backbone": 0.1}}

    jstate = j_state(jm, v, tcfg, steps_per_epoch=5)
    frozen = {"text_encoder": jstate.params["text_encoder"]}

    def loss_fn(trainable):
        out, mutated = jm.apply({"params": {**trainable, **frozen}, "batch_stats": v["batch_stats"]},
                                jnp.asarray(img), jnp.asarray(texts), train=True, gt_hw=(64, 96),
                                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return j_ce(out["seg"], jnp.asarray(seg), ignore_index=255), mutated["batch_stats"]

    trainable = {k: p for k, p in jstate.params.items() if k != "text_encoder"}
    (j_loss, j_stats), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    j_grads = dict(j_grads, text_encoder=jax.tree.map(jnp.zeros_like, frozen["text_encoder"]))
    jstate = jax.jit(lambda st, g: st.apply_gradients(grads=g))(jstate, j_grads)

    tstate = t_state(tm, tcfg, steps_per_epoch=5)
    tm.train()
    out = tm(t(img), texts, train=True, gt_hw=(64, 96), gen=torch.Generator().manual_seed(0))
    loss = t_ce(out["seg"], torch.from_numpy(seg), ignore_index=255)
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    want_grads = flax_to_state_dict({"params": jax.tree.map(np.asarray, j_grads)})
    named = dict(tm.named_parameters())
    keys = ["gamma", "contexts", "vis_proj.weight", "global_proj.weight",
            "context_decoder.layers.0.cross_attn.kv.weight", "backbone.layer1.0.conv2.weight",
            "backbone.attnpool.q_proj.weight", "neck.lateral.3.weight"]
    for key in keys:
        assert_parity(want_grads[key].numpy(), named[key].grad, max_abs=1e-4, rel_l2=1e-4,
                      what=f"grad {key}")
    assert all(p.grad is None for p in tm.text_encoder.parameters())
    tstate.optimizer.step()

    want = flax_to_state_dict({"params": jax.tree.map(np.asarray, jstate.params),
                               "batch_stats": jax.tree.map(np.asarray, j_stats)})
    got = tm.state_dict()
    for key in keys + ["backbone.stem.bn1.running_var", "backbone.layer4.0.bn3.running_mean",
                       "text_encoder.positional_embedding"]:
        assert_parity(want[key].numpy(), got[key], what=key)
    lr_of = {id(p): g["lr"] for g in tstate.optimizer.inner.param_groups for p in g["params"]}
    assert lr_of[id(named["backbone.stem.conv1.weight"])] == pytest.approx(1e-4)
    assert lr_of[id(named["gamma"])] == pytest.approx(1e-3)


@pytest.mark.parametrize("mode", ["whole", "slide", "aug_test"])
def test_rn_engine_matches_jax(rn_pair, mode):
    """Whole, slide and multi-scale + flip inference: the tower cached per
    checkpoint, the decoder run per image; scaled views on multiples of 32."""
    jm, v, tm, texts = rn_pair
    jv = {"params": v["params"], "batch_stats": v["batch_stats"]}
    j_engine = JInferencer(jm, jv, texts, num_classes=19)
    t_engine = TInferencer(tm, texts, num_classes=19)
    frame = np.random.RandomState(14).randint(0, 256, (1, 96, 160, 3), dtype=np.uint8)
    if mode == "aug_test":
        shapes = []
        forward = tm.forward
        tm.forward = lambda image, *a, **k: shapes.append(tuple(image.shape[1:3])) or forward(
            image, *a, **k)
        kw = dict(scales=(0.75, 1.25), flip=True, mode="whole")
        try:
            got = t_engine.aug_test(frame, **kw)
        finally:
            del tm.forward
        want = j_engine.aug_test(frame, **kw)
        assert shapes == [(64, 128), (128, 192)]  # round(96 * s / 32) * 32, ...
    else:
        kw = dict(mode=mode, crop=(64, 64), stride=(48, 48), window_batch=4)
        want, got = j_engine.predict(frame, **kw), t_engine.predict(frame, **kw)
    assert got["seg_logits"].shape == (1, 96, 160, 19)
    np.testing.assert_allclose(got["seg_logits"], want["seg_logits"], atol=1e-4, rtol=1e-4)


def _write_tree(root, rs, hw=(96, 160)):
    from denseclip_vit_multimodal_tpu_torch.utils.png import encode_png

    for split, n in (("train", 4), ("val", 2)):
        for i in range(n):
            for top, sfx, arr in (
                    ("leftImg8bit", "leftImg8bit", rs.randint(0, 256, hw + (3,), dtype=np.uint8)),
                    ("gtFine", "gtFine_labelIds", rs.randint(0, 34, hw).astype(np.uint8))):
                d = os.path.join(root, top, split, "aachen")
                os.makedirs(d, exist_ok=True)
                with open(os.path.join(d, f"aachen_{i:06d}_000019_{sfx}.png"), "wb") as f:
                    f.write(encode_png(arr))


RN50_SETS = [  # the RN50 preset, narrowed; the structure (and its recipe) as published
    "model.text_dim=32", "model.token_embed_dim=64", "model.backbone.layers=[1,1,1,1]",
    "model.backbone.width=8", "model.backbone.output_dim=32",
    "model.backbone.input_resolution=64", "model.text_encoder.transformer_width=64",
    "model.text_encoder.transformer_heads=2", "model.text_encoder.transformer_layers=1",
    "model.text_encoder.embed_dim=32", "model.context_decoder.transformer_width=32",
    "model.context_decoder.transformer_heads=2", "model.context_decoder.transformer_layers=1",
    "model.neck.in_channels=[32,64,128,256]", "model.neck.out_channels=32",
    "model.decode_head.in_channels=32", "model.decode_head.channels=32",
    "tpu.compute_dtype=float32", "data.crop_size=[64,64]", "training.batch_size=2",
    "training.workers=1",
]


def test_rn50_preset_trains_and_evaluates(tmp_path):
    """`tools/train.py` on the RN50 preset (narrowed) from a stub ResNet CLIP
    archive on a written Cityscapes tree, then `tools/test.py` whole and
    slide on its checkpoint, and `tools/get_flops.py` on the frame."""
    from denseclip_vit_multimodal_tpu_torch.tools import get_flops
    from denseclip_vit_multimodal_tpu_torch.tools import test as test_tool
    from denseclip_vit_multimodal_tpu_torch.tools import train as train_tool
    from torch_clip_files import write_stub_clip

    tree, archive, wd = tmp_path / "tree", tmp_path / "RN50.pt", tmp_path / "wd"
    _write_tree(str(tree), np.random.RandomState(15))
    write_stub_clip(str(archive), (8, (1, 1, 1, 1), 7, 32), (64, 1, 49408, 77, 32), resnet=True)
    cfg = "configs/denseclip_rn50_cityscapes.yaml"
    sets = ["--set", *RN50_SETS, f"data.path={tree}", f"model.clip_pretrained={archive}"]
    summary = train_tool.main([cfg, "--device", "cpu", "--no-validate", "--max-steps", "2",
                               "--work-dir", str(wd), *sets])
    assert summary["step"] == 2.0 and np.isfinite(summary["loss_total"])
    log = (wd / "train.log").read_text()
    # stem 3 x (conv + 4 BN) + 4 blocks x (3 x 5 + 5 downsample) + pool 9; text 1 x 12 + 5
    assert "loaded CLIP weights" in log and ": 104 visual / 17 text tensors" in log
    assert "frozen modules: ['text_encoder']" in log
    steps = [json.loads(line) for line in (wd / "train_log.jsonl").read_text().splitlines()]
    assert [s["step"] for s in steps] == [1, 2]
    for mode in ("whole", "slide"):
        results = test_tool.main([cfg, str(wd), "--device", "cpu", "--mode", mode, "--crop",
                                  "64", "64", "--stride", "48", "48", "--single-protocol", *sets])
        assert np.isfinite(results["mIoU"]) and 0.0 <= results["pixel_acc"] <= 1.0
    flops = get_flops.main([cfg, "--device", "cpu", "--shape", "96", "160", *sets[:-1]])
    assert flops["flops"] > 0 and flops["kernel_flops"] == 0


def test_registry_fallback():
    """Unknown `type:` strings go to the registries (JAX `Unsupported ...
    type` where nothing is registered)."""

    @registry.BACKBONES.register("_TestTinyBackbone")
    class TinyBackbone(nn.Module):
        out_channels, num_levels = 12, 1

        def __init__(self, **kw):
            super().__init__()
            self.kw = kw
            self.conv = nn.Conv2d(3, 12, 1)

        def forward(self, x, deterministic=True, gen=None):
            return (self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1),)

    @registry.HEADS.register("_TestTinyHead")
    class TinyHead(nn.Module):
        def __init__(self, **kw):
            super().__init__()
            self.proj = nn.Linear(12, int(kw["num_classes"]))

        def forward(self, x, train=False, gen=None):
            return self.proj(x)

    cfg = dict(TINY_VIT_CD, backbone={"type": "_TestTinyBackbone", "depth": 3},
               neck=None, context_decoder=None, depth_head=None,
               decode_head={"type": "_TestTinyHead", "num_classes": 19})
    model, _ = t_build(cfg, CITYSCAPES_CLASSES, device="cpu")
    assert isinstance(model.backbone, TinyBackbone) and model.backbone.kw == {"depth": 3}
    with torch.no_grad():
        out = model(torch.zeros(1, 32, 32, 3), None)
    assert tuple(out["seg"].shape) == (1, 32, 32, 19)
    assert model.global_proj.in_features == 12  # out_channels 12 != text_dim 32
    for section in ("backbone", "text_encoder", "neck", "decode_head"):
        bad = dict(TINY_VIT_CD, **{section: {"type": "_NoSuchModule"}})
        with pytest.raises(ValueError, match=f"Unsupported {section} type: _NoSuchModule"):
            t_build(bad, CITYSCAPES_CLASSES, device="cpu")
        with pytest.raises(ValueError, match=f"Unsupported {section} type: _NoSuchModule"):
            j_build(bad, CITYSCAPES_CLASSES)


def test_identity_head_matches_jax():
    """`IdentityHead` as the decode head (the seg output is the neck's) and
    the `identity_head` output, the score map over tau."""
    cfg = dict(TINY_RN, identity_head=True, tau=0.05,
               decode_head={"type": "IdentityHead", "num_classes": 19})
    jm, v, tm, texts = _pair(cfg)
    want = jm.apply(v, jnp.asarray(IMG), jnp.asarray(texts), return_features=True)
    with torch.no_grad():
        got = tm(t(IMG), texts, return_features=True)
    assert_parity(want["identity"], got["identity"], what="identity")
    assert_parity(want["seg"], got["seg"], what="seg")
    assert torch.allclose(got["identity"], got["score_map"] / 0.05)


def test_clip_text_encoder_matches_jax():
    """The plain tower alone, and as the model's text encoder (no contexts)."""
    text = np.random.RandomState(16).randint(1, 400, (7, 6)).astype(np.int32)
    text[:, -1] = 511  # the EOT: the argmax
    jm = j_text.CLIPTextEncoder(context_length=6, vocab_size=512, transformer_width=64,
                                transformer_heads=2, transformer_layers=2, embed_dim=32)
    v = init(jm, jnp.asarray(text))
    tm = port(t_text.CLIPTextEncoder(6, 512, 64, 2, 2, 32), v)
    with torch.no_grad():
        assert_parity(jm.apply(v, jnp.asarray(text)), tm(torch.from_numpy(text).long()))
        assert_parity(jm.apply(v, jnp.asarray(text[:, :4])), tm(torch.from_numpy(text[:, :4]).long()))
    cfg = dict(TINY_RN, text_encoder=dict(TEXT, type="CLIPTextEncoder"))
    jm, v, tm, texts = _pair(cfg)
    assert tm.contexts is None and "contexts" not in v["params"]
    want = jm.apply(v, jnp.asarray(IMG), jnp.asarray(texts), return_features=True)
    with torch.no_grad():
        got = tm(t(IMG), texts, return_features=True)
    for key in FEATURES:
        assert_parity(want[key], got[key], what=key)
