"""The port's context decoder (`models/context_decoder.py`) and the
cross-attention / bias-free routes of its `MultiHeadAttention`, against the
JAX package's, on the CPU.  fp32: max abs 1e-4 and relative L2 1e-5
(`torch_parity.py`); bf16: relative L2 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.models import context_decoder as j_cd
from denseclip_vit_multimodal_tpu.models import layers as j_layers
from denseclip_vit_multimodal_tpu_torch.models import context_decoder as t_cd
from denseclip_vit_multimodal_tpu_torch.models import layers as t_layers
from torch_parity import assert_parity, errors, init, port, randn, t


@pytest.mark.parametrize("bias", [True, False])
def test_cross_attention_matches_jax(bias):
    x, mem = randn(2, 19, 32, seed=1), randn(2, 37, 32, seed=2)
    jm = j_layers.MultiHeadAttention(num_heads=4, use_qkv_bias=bias, attn_impl="xla")
    v = init(jm, jnp.asarray(x), kv=jnp.asarray(mem))
    assert set(v["params"]) == {"q", "kv", "out"}
    tm = port(t_layers.MultiHeadAttention(32, 4, attn_impl="xla", use_qkv_bias=bias,
                                          cross=True), v)
    assert (tm.q.bias is None) == (tm.kv.bias is None) == (not bias)
    with torch.no_grad():
        got = tm(t(x), kv=t(mem))
    assert_parity(jm.apply(v, jnp.asarray(x), kv=jnp.asarray(mem)), got)


def test_bias_free_self_attention_matches_jax():
    x = randn(2, 19, 32, seed=3)
    jm = j_layers.MultiHeadAttention(num_heads=4, use_qkv_bias=False, attn_impl="xla")
    v = init(jm, jnp.asarray(x))
    tm = port(t_layers.MultiHeadAttention(32, 4, attn_impl="xla", use_qkv_bias=False), v)
    assert tm.qkv.bias is None and tm.out.bias is not None
    with torch.no_grad():
        assert_parity(jm.apply(v, jnp.asarray(x)), tm(t(x)))


def test_attention_layout_is_checked():
    cross = t_layers.MultiHeadAttention(32, 4, cross=True)
    with pytest.raises(ValueError, match="kv="):
        cross(torch.zeros(1, 3, 32))
    with pytest.raises(ValueError, match="kv="):
        t_layers.MultiHeadAttention(32, 4)(torch.zeros(1, 3, 32), kv=torch.zeros(1, 5, 32))


def _decoder_pair(layers=2, visual_dim=48, width=32, heads=4, dtype=jnp.float32):
    text, visual = randn(2, 19, visual_dim, seed=4), randn(2, 1 + 5 * 7, visual_dim, seed=5)
    jm = j_cd.ContextDecoder(transformer_width=width, transformer_heads=heads,
                             transformer_layers=layers, visual_dim=visual_dim, dtype=dtype)
    v = init(jm, jnp.asarray(text), jnp.asarray(visual))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tm = port(t_cd.ContextDecoder(width, heads, layers, visual_dim, dtype=tdt), v)
    return jm, v, tm, text, visual


@pytest.mark.parametrize("scale", [1.0, 1e-3], ids=["unit", "small"])
def test_context_decoder_matches_jax(scale):
    """At `small` inputs the memory's and text's variances (~1e-6) sit at the
    LayerNorm epsilon: 1e-5 (CLIP's) instead of Flax's 1e-6 would show."""
    jm, v, tm, text, visual = _decoder_pair()
    text, visual = text * scale, visual * scale
    want = jm.apply(v, jnp.asarray(text), jnp.asarray(visual))
    with torch.no_grad():
        got = tm(t(text), t(visual))
    assert tuple(got.shape) == (2, 19, 48)
    assert_parity(want, got)
    assert all(m.epsilon == 1e-6 for m in tm.modules() if isinstance(m, t_layers.LayerNorm))


def test_context_decoder_bf16_matches_jax():
    jm, v, tm, text, visual = _decoder_pair(dtype=jnp.bfloat16)
    want = jm.apply(v, jnp.asarray(text), jnp.asarray(visual).astype(jnp.bfloat16))
    with torch.no_grad():
        got = tm(t(text), t(visual).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert errors(np.asarray(want, np.float32), got.float())[1] < 2e-2


def test_context_decoder_dropout_draws_from_the_generator():
    """Dropout only with a generator (training), seeded: the same seed the
    same masks; rate 0 is the eval forward."""
    _, _, tm, text, visual = _decoder_pair(layers=1)
    with torch.no_grad():
        base = tm(t(text), t(visual))
        a = tm(t(text), t(visual), gen=torch.Generator().manual_seed(3))
        b = tm(t(text), t(visual), gen=torch.Generator().manual_seed(3))
        for layer in tm.layers:
            layer.dropout_rate = 0.0
        c = tm(t(text), t(visual), gen=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.allclose(a, base) and torch.equal(c, base)


def test_gelu_is_exact():
    x = torch.linspace(-4, 4, 101)
    want = np.asarray(j_layers.nn.gelu(jnp.asarray(x.numpy()), approximate=False))
    np.testing.assert_allclose(t_layers.gelu(x).numpy(), want, atol=1e-6)
