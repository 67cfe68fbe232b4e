"""Module parity of the PyTorch port against the JAX package, on the CPU.

Inputs come from numpy seeds; JAX parameters come from `model.init`, are
perturbed with numpy noise (so no LayerNorm scale is exactly 1 and no
BatchNorm statistic exactly 0/1), and are carried into the port by
`convert.load_flax_variables`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.models import heads as j_heads
from denseclip_vit_multimodal_tpu.models import layers as j_layers
from denseclip_vit_multimodal_tpu.models import necks as j_necks
from denseclip_vit_multimodal_tpu.models import text as j_text
from denseclip_vit_multimodal_tpu.models import vit as j_vit
from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.ops.score_map import l2_normalize as j_l2_normalize
from denseclip_vit_multimodal_tpu.ops.score_map import score_map as j_score_map
from denseclip_vit_multimodal_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from denseclip_vit_multimodal_tpu_torch.models import heads as t_heads
from denseclip_vit_multimodal_tpu_torch.models import layers as t_layers
from denseclip_vit_multimodal_tpu_torch.models import necks as t_necks
from denseclip_vit_multimodal_tpu_torch.models import text as t_text
from denseclip_vit_multimodal_tpu_torch.models import vit as t_vit
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.ops.score_map import l2_normalize as t_l2_normalize
from denseclip_vit_multimodal_tpu_torch.ops.score_map import score_map as t_score_map

# fp32 module parity: the same fp32 arithmetic summed in another order.
TOL_MODULE = 2e-5
# fp32 composite (ViT stack + neck + heads, values up to ~15): 1e-4.
TOL_COMPOSITE = 1e-4
# bf16 (relative L2): both sides round activations to 8 mantissa bits, at
# different points (XLA fuses casts PyTorch does one by one).
TOL_BF16_REL = 2e-2


def randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def perturb(variables, seed=1):
    """Numpy-noised copy of a Flax variables tree (BN variances kept > 0)."""
    rs = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rs.randn(*np.shape(a)).astype(np.float32),
        variables["params"])
    out = {"params": params}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree.map(
            lambda a: (rs.rand(*np.shape(a)) + 0.5).astype(np.float32), variables["batch_stats"])
    return out


def init(module, *args, seed=0, **kwargs):
    variables = module.init(jax.random.PRNGKey(seed), *args, **kwargs)
    return perturb(jax.tree.map(np.asarray, dict(variables)), seed=seed + 1)


def port(module, variables):
    return load_flax_variables(module, variables).eval()


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(a, b, tol):
    a = np.asarray(a, np.float32)
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(b, a, atol=tol, rtol=tol)


# --------------------------------------------------------------------------
# layers.py: one parametrised test
# --------------------------------------------------------------------------


def _layer_norm():
    x = randn(2, 7, 96)
    v = init(j_layers.LayerNorm(), x)
    return [j_layers.LayerNorm().apply(v, x)], [port(t_layers.LayerNorm(96), v)(t(x))]


def _quick_gelu():
    x = randn(3, 50) * 3
    return [j_layers.quick_gelu(x)], [t_layers.quick_gelu(t(x))]


def _mha(causal=False, valid_len=None):
    def case():
        x = randn(2, 9, 96)
        jm = j_layers.MultiHeadAttention(num_heads=3, causal=causal)
        v = init(jm, x, valid_len=valid_len)
        tm = port(t_layers.MultiHeadAttention(96, 3, causal=causal), v)
        return [jm.apply(v, x, valid_len=valid_len)], [tm(t(x), valid_len=valid_len)]
    return case


def _mlp():
    x = randn(2, 5, 96)
    v = init(j_layers.MLP(), x)
    return [j_layers.MLP().apply(v, x)], [port(t_layers.MLP(96), v)(t(x))]


def _block(causal=False):
    def case():
        x = randn(2, 9, 96)
        jm = j_layers.ResidualAttentionBlock(num_heads=3, causal=causal)
        v = init(jm, x, valid_len=7)
        tm = port(t_layers.ResidualAttentionBlock(96, 3, causal=causal), v)
        return [jm.apply(v, x, valid_len=7)], [tm(t(x), valid_len=7)]
    return case


def _transformer():
    x = randn(2, 9, 96)
    jm = j_layers.Transformer(width=96, layers=3, heads=3)
    v = init(jm, x)
    final, taps = port(t_layers.Transformer(96, 3, 3), v)(t(x))
    return list(jm.apply(v, x)), [final, taps]


def _conv_bn_relu(k):
    def case():
        x = randn(2, 6, 10, 8)
        jm = j_layers.ConvBNReLU(features=16, kernel_size=k)
        v = init(jm, x)
        return [jm.apply(v, x)], [port(t_layers.ConvBNReLU(8, 16, kernel_size=k), v)(t(x))]
    return case


def _resize(size, antialias):
    def case():
        x = randn(2, 5, 7, 3)
        return ([j_layers.resize_bilinear(x, size, antialias=antialias)],
                [t_layers.resize_bilinear(t(x), size, antialias=antialias)])
    return case


LAYER_CASES = {
    "layer_norm": _layer_norm,
    "quick_gelu": _quick_gelu,
    "mha_self": _mha(),
    "mha_causal": _mha(causal=True),
    "mha_valid_len": _mha(valid_len=6),
    "mlp": _mlp,
    "block": _block(),
    "block_causal": _block(causal=True),
    "transformer_taps": _transformer,
    "conv_bn_relu_3x3": _conv_bn_relu(3),
    "conv_bn_relu_1x1": _conv_bn_relu(1),
    "resize_up": _resize((11, 13), False),
    "resize_down": _resize((3, 4), False),
    "resize_down_antialias": _resize((3, 4), True),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layers_match_jax(name):
    want, got = LAYER_CASES[name]()
    assert len(want) == len(got)
    with torch.no_grad():
        for a, b in zip(want, got):
            close(a, b, TOL_MODULE)


# --------------------------------------------------------------------------
# vit.py
# --------------------------------------------------------------------------


def test_interpolate_pos_embed_identity():
    pos = t(randn(197, 32))
    assert t_vit.interpolate_pos_embed(pos, 14, (14, 14)) is pos


@pytest.mark.parametrize("grid", [(39, 39), (8, 16), (20, 7)])
def test_interpolate_pos_embed_matches_jax(grid):
    pos = randn(197, 32, seed=3)
    close(j_vit.interpolate_pos_embed(jnp.asarray(pos), 14, grid),
          t_vit.interpolate_pos_embed(t(pos), 14, grid), TOL_MODULE)


@pytest.mark.parametrize("hw", [(128, 256), (512, 512)], ids=["129_tokens", "pad_once_1025"])
def test_vit_matches_jax(hw):
    """512x512 gives 32*32+1 = 1025 tokens: the pad-once branch (1152, valid_len 1025)."""
    x = randn(1, *hw, 3, seed=4)
    jm = j_vit.CLIPVisionTransformer(width=96, layers=2, heads=3, out_indices=(0, 1))
    v = init(jm, x)
    tm = port(t_vit.CLIPVisionTransformer(width=96, layers=2, heads=3, out_indices=(0, 1)), v)
    want = jm.apply(v, x)
    with torch.no_grad():
        got = tm(t(x))
    assert len(got) == 2 and got[0].shape == (1, hw[0] // 16, hw[1] // 16, 96)
    for a, b in zip(want, got):
        close(a, b, TOL_COMPOSITE)


# --------------------------------------------------------------------------
# text.py, score_map.py, necks.py, heads.py
# --------------------------------------------------------------------------


def test_text_context_encoder_matches_jax():
    rs = np.random.RandomState(5)
    text = rs.randint(1, 400, (5, 4)).astype(np.int32)
    text[np.arange(5), rs.randint(1, 4, 5)] = 499  # EOT: the row maximum
    context = randn(2, 6, 64, seed=6)
    kw = dict(context_length=10, vocab_size=500, transformer_width=64, transformer_heads=4,
              transformer_layers=2, embed_dim=32)
    jm = j_text.CLIPTextContextEncoder(**kw)
    v = init(jm, text, context)
    tm = port(t_text.CLIPTextContextEncoder(**kw), v)
    with torch.no_grad():
        got = tm(t(text).long(), t(context))
    assert got.shape == (2, 5, 32)
    close(jm.apply(v, text, context), got, TOL_MODULE)


def test_score_map_matches_jax():
    vis, txt = randn(2, 4, 5, 32, seed=7), randn(2, 7, 32, seed=8)
    close(j_score_map(vis, txt), t_score_map(t(vis), t(txt)), TOL_MODULE)
    close(j_l2_normalize(txt), t_l2_normalize(t(txt)), TOL_MODULE)


def test_neck_matches_jax():
    feats = [randn(2, 4, 6, 16, seed=i) for i in range(3)]
    jm = j_necks.ViTFeatureFusionNeck(num_inputs=3, out_channels=24, inter_channels=8)
    v = init(jm, feats)
    tm = port(t_necks.ViTFeatureFusionNeck(3, 16, 24, inter_channels=8), v)
    with torch.no_grad():
        close(jm.apply(v, feats), tm([t(f) for f in feats]), TOL_MODULE)


def test_fcn_head_matches_jax():
    x = randn(2, 4, 6, 32, seed=9)
    jm = j_heads.FCNHead(in_channels=32, channels=16, num_outputs=5)
    v = init(jm, x)
    tm = port(t_heads.FCNHead(32, 16, 5), v)
    with torch.no_grad():
        close(jm.apply(v, x), tm(t(x)), TOL_MODULE)


# --------------------------------------------------------------------------
# denseclip.py: the composite
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pair(tiny_model_cfg):
    cfg = dict(tiny_model_cfg)
    cfg["text_encoder"] = dict(cfg["text_encoder"], transformer_layers=2)
    jm, texts = j_build(cfg, CITYSCAPES_CLASSES)
    x = randn(2, 64, 128, 3, seed=10)
    v = init(jm, jnp.asarray(x), jnp.asarray(texts))
    tm, t_texts = t_build(cfg, CITYSCAPES_CLASSES, device="cpu")
    np.testing.assert_array_equal(t_texts, texts)
    return cfg, jm, v, load_flax_variables(tm, v), texts, x


@pytest.mark.parametrize("cached", [False, True], ids=["tower", "cached_text"])
def test_denseclip_forward_matches_jax(tiny_pair, cached):
    _, jm, v, tm, texts, x = tiny_pair
    j_cached = jm.apply(v, jnp.asarray(texts), method="encode_text_base") if cached else None
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(texts), return_features=True,
                    cached_text=j_cached)
    with torch.no_grad():
        t_cached = tm.encode_text_base(texts) if cached else None
        got = tm(t(x), texts, return_features=True, cached_text=t_cached)
    for key in ("seg", "depth", "score_map", "text_embeddings", "head_input"):
        close(want[key], got[key], TOL_COMPOSITE)
    with torch.no_grad():
        plain = tm(t(x), texts)  # no features: the score map path is skipped
    close(want["seg"], plain["seg"], TOL_COMPOSITE)


def test_denseclip_head_resolution_and_gt_resize(tiny_pair):
    """Head-resolution logits, and `gt_hw` resizing them (in fp32) to another size."""
    _, jm, v, tm, texts, x = tiny_pair
    head = jm.apply(v, jnp.asarray(x), jnp.asarray(texts), resize_outputs=False)
    with torch.no_grad():
        got_head = tm(t(x), texts, resize_outputs=False)
        got_gt = tm(t(x), texts, gt_hw=(40, 72))
    for key in ("seg", "depth"):
        close(head[key], got_head[key], TOL_COMPOSITE)
        want = j_layers.resize_bilinear(head[key].astype(jnp.float32), (40, 72))
        close(want, got_gt[key], TOL_COMPOSITE)


def test_denseclip_bf16_matches_jax(tiny_pair):
    cfg, _, v, _, texts, x = tiny_pair
    jm, _ = j_build(cfg, CITYSCAPES_CLASSES, dtype=jnp.bfloat16)
    tm, _ = t_build(cfg, CITYSCAPES_CLASSES, dtype=torch.bfloat16, device="cpu")
    load_flax_variables(tm, v)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(texts))
    with torch.no_grad():
        got = tm(t(x), texts)
    for key in ("seg", "depth"):
        a = np.asarray(want[key], np.float32)
        b = got[key].float().numpy()
        assert np.linalg.norm(a - b) / np.linalg.norm(a) < TOL_BF16_REL, key


# --------------------------------------------------------------------------
# convert.py and build_denseclip's refusals
# --------------------------------------------------------------------------


def test_convert_rejects_unknown_and_missing_leaves(tiny_pair):
    cfg, _, v, tm, _, _ = tiny_pair
    extra = {"params": dict(v["params"], stray={"kernel": np.zeros((2, 2), np.float32)}),
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="stray"):
        load_flax_variables(tm, extra)
    missing = {"params": {k: p for k, p in v["params"].items() if k != "contexts"},
               "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="contexts"):
        load_flax_variables(tm, missing)
    with pytest.raises(KeyError, match="unmapped"):
        flax_to_state_dict({"params": {"mystery": np.zeros(3, np.float32)}})
    sd = flax_to_state_dict(v)
    assert sd["backbone.transformer.blocks.3.attn.qkv.weight"].shape == (288, 96)
    assert sd["neck.process.1.bn.running_var"].shape == (32,)
    np.testing.assert_array_equal(
        sd["backbone.patch_embed.weight"].numpy(), v["params"]["backbone"]["patch_embed"].T)


@pytest.mark.parametrize("section,override", [
    ("backbone", {"type": "CLIPResNet", "layers": [1, 1, 1, 1], "width": 8}),
    ("text_encoder", {"type": "CLIPTextEncoder"}),
    ("neck", {"type": "FPN"}),
    ("context_decoder", {"type": "ContextDecoder"}),
])
def test_build_refuses_what_is_not_ported(tiny_model_cfg, section, override):
    """Named for the refusals it checked before these modules were ported:
    each type now builds into its module (their parity with the JAX package
    is in tests/test_torch_{resnet,rn_path,fpn,context_decoder}.py), and an
    unregistered type in the section raises the JAX package's error."""
    cfg = dict(tiny_model_cfg)
    cfg[section] = dict(cfg.get(section) or {}, **override)
    model, _ = t_build(cfg, CITYSCAPES_CLASSES, device="cpu")
    assert type(getattr(model, section)).__name__ == override["type"]
    if section == "context_decoder":  # the JAX build_denseclip does not read its type
        assert model.gamma is not None
        return
    cfg[section] = dict(cfg[section], type="_Unregistered")
    with pytest.raises(ValueError, match=f"Unsupported {section} type: _Unregistered"):
        t_build(cfg, CITYSCAPES_CLASSES, device="cpu")
    with pytest.raises(ValueError, match=f"Unsupported {section} type: _Unregistered"):
        j_build(cfg, CITYSCAPES_CLASSES)
