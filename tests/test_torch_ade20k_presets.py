"""The three ADE20K presets in the port against the JAX package, on the CPU
at tiny widths in fp32: `configs/denseclip_rn50_512x512_80k.yaml`,
`configs/denseclip_rn101_512x512_80k.yaml` and
`configs/denseclip_vitb16_ade20k.yaml` (a context decoder on the ViT,
`FPNHead` on `ViTFeatureFusionNeck`, `text_head: false`,
`score_concat_index: -1`), each narrowed by `--set` with its structure as
published and 150 classes; the same weights through
`convert.load_flax_variables`; then the first training step's loss.  The
entry points run in `tests/test_torch_ade20k_tools.py`.

fp32 tolerances: max abs 1e-4 and relative L2 1e-5 (`torch_parity.py`).
"""

import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu_torch.core.config import load_config as t_load
from denseclip_vit_multimodal_tpu_torch.data.ade20k import ADE20K_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.train.losses import cross_entropy_loss as t_ce

# the reference: the JAX package (absent on the card: the file skips)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
j_load = pytest.importorskip("denseclip_vit_multimodal_tpu.core.config").load_config
j_build = pytest.importorskip("denseclip_vit_multimodal_tpu.models.denseclip").build_denseclip
j_ce = pytest.importorskip("denseclip_vit_multimodal_tpu.train.losses").cross_entropy_loss
from torch_parity import assert_parity, init, port, randn, t  # noqa: E402  (imports JAX)

RN50 = "configs/denseclip_rn50_512x512_80k.yaml"
RN101 = "configs/denseclip_rn101_512x512_80k.yaml"
VIT = "configs/denseclip_vitb16_ade20k.yaml"

_TEXT = ["model.text_encoder.transformer_width=64", "model.text_encoder.transformer_heads=2",
         "model.text_encoder.transformer_layers=1", "model.text_encoder.embed_dim=32",
         "model.context_decoder.transformer_width=32", "model.context_decoder.transformer_heads=2",
         "model.context_decoder.transformer_layers=1", "model.text_dim=32",
         "model.token_embed_dim=64", "tpu.compute_dtype=float32"]
RN_SETS = _TEXT + [
    "model.backbone.width=8", "model.backbone.output_dim=32", "model.backbone.input_resolution=64",
    "model.context_decoder.visual_dim=32", "model.neck.in_channels=[32,64,128,256]",
    "model.neck.out_channels=32", "model.decode_head.in_channels=32",
    "model.decode_head.channels=32"]
SETS = {
    RN50: RN_SETS + ["model.backbone.layers=[1,1,1,1]"],
    RN101: RN_SETS + ["model.backbone.layers=[1,1,2,1]"],  # the deeper third stage, shortened
    VIT: _TEXT + [
        "model.backbone.width=64", "model.backbone.layers=2", "model.backbone.heads=2",
        "model.backbone.input_resolution=64", "model.backbone.output_dim=32",
        "model.backbone.out_indices=[0,1]", "model.neck.inter_channels=16",
        "model.neck.out_channels=32", "model.decode_head.in_channels=32",
        "model.decode_head.channels=32"],
}
NO_DROPOUT = ["model.context_decoder.dropout=0.0", "model.decode_head.dropout_ratio=0.0"]
FEATURES = ("seg", "score_map", "text_embeddings", "head_input")


def _pair(config, extra=(), img=None, seed=0):
    sets = SETS[config] + list(extra)
    jcfg, tcfg = j_load(config, overrides=sets), t_load(config, overrides=sets)
    jm, texts = j_build(jcfg.model, ADE20K_CLASSES)
    v = init(jm, jnp.asarray(img), jnp.asarray(texts), seed=seed)
    tm, t_texts = t_build(tcfg.model, ADE20K_CLASSES, device="cpu")
    np.testing.assert_array_equal(t_texts, texts)
    return jm, v, port(tm, v), texts


@pytest.mark.parametrize("config,hw", [(RN50, (64, 86)), (RN101, (64, 86)), (VIT, (64, 96))],
                         ids=["rn50-odd-width", "rn101-odd-width", "vitb16"])
def test_preset_matches_jax(config, hw):
    img = randn(2, *hw, 3, seed=20)
    jm, v, tm, texts = _pair(config, img=img)
    if config == VIT:  # the combination only this preset has
        assert tm.context_decoder is not None  # `text_head: false` is read by neither package
        assert type(tm.neck).__name__ == "ViTFeatureFusionNeck"
        assert type(tm.decode_head).__name__ == "FCNHead"  # `FPNHead`, as JAX builds it
    want = jm.apply(v, jnp.asarray(img), jnp.asarray(texts), return_features=True)
    with torch.no_grad():
        got = tm(t(img), texts, return_features=True)
    assert tuple(got["seg"].shape) == (2, *hw, 150)
    for key in FEATURES:
        assert_parity(want[key], got[key], what=key)
    assert got.get("depth") is None


@pytest.mark.parametrize("config", [RN50, VIT], ids=["rn50", "vitb16"])
def test_first_step_loss_matches_jax(config):
    """The training forward (the RN's BatchNorms on batch statistics, every
    dropout 0) and the cross-entropy over 150 classes with ignored pixels."""
    img = randn(2, 64, 64, 3, seed=21)
    seg = np.random.RandomState(22).randint(0, 150, (2, 64, 64)).astype(np.int32)
    seg[:, :5] = 255
    jm, v, tm, texts = _pair(config, NO_DROPOUT, img=img)
    variables = {"params": v["params"], **({"batch_stats": v["batch_stats"]}
                                           if "batch_stats" in v else {})}
    out = jm.apply(variables, jnp.asarray(img), jnp.asarray(texts), train=True, gt_hw=(64, 64),
                   mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})[0]
    j_loss = float(j_ce(out["seg"], jnp.asarray(seg), ignore_index=255))
    tm.train()
    got = tm(t(img), texts, train=True, gt_hw=(64, 64), gen=torch.Generator().manual_seed(0))
    t_loss = t_ce(got["seg"], torch.from_numpy(seg), ignore_index=255)
    t_loss.backward()
    assert abs(t_loss.item() - j_loss) <= 1e-5 * abs(j_loss)
    grads = [p.grad for p in tm.decode_head.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    # the score map feeds the RN preset's neck (score_concat_index 3), not the ViT's (-1)
    assert (tm.gamma.grad is not None) == (config == RN50)
