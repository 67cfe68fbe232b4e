"""`attn_impl: ring` in the port on the CPU.

JAX's `ring` shards the sequence over a ring mesh (`models/layers.py:171-222`):
over conftest's 8 virtual devices it runs the ring, exactly.  The port runs
one process a card and has no ring yet: in a one-process world, and for
causal or cross attention, its `ring` takes `auto`, which is exact as well,
so the tiny seg+depth ViT built with `ring` in both packages agrees at the
fp32 module limits; over a group of more than one process the port refuses
it (`NotImplementedError` naming ROADMAP §1 item 1), in the attention core
and in the training loop's check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.parallel.ring_attention import current_ring_mesh
from denseclip_vit_multimodal_tpu_torch.models import layers as t_layers
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.parallel import mesh as port_mesh
from torch_parity import assert_parity, init, port, randn, t


def test_ring_model_matches_jax_ring_over_eight_devices(tiny_model_cfg):
    mesh, axis = current_ring_mesh()
    assert mesh.shape[axis] == 8  # JAX really rides the ring here
    img = randn(1, 64, 96, 3, seed=3)  # 4 x 6 patches + class token: 25 tokens, padded to 32
    jm, texts = j_build(tiny_model_cfg, CITYSCAPES_CLASSES, attn_impl="ring")
    variables = init(jm, jnp.asarray(img), jnp.asarray(texts))
    tm, _ = t_build(tiny_model_cfg, CITYSCAPES_CLASSES, attn_impl="ring", device="cpu")
    assert {m.attn_impl for m in tm.backbone.modules()
            if isinstance(m, t_layers.MultiHeadAttention)} == {"ring"}
    tm = port(tm, variables)
    want = jax.jit(lambda v, x: jm.apply(v, x, jnp.asarray(texts)))(variables, jnp.asarray(img))
    with torch.no_grad():
        got = tm(t(img), texts)
    for key in ("seg", "depth"):
        assert_parity(np.asarray(want[key]), got[key], what=key)
    # the ring's fallback is the exact `auto` route: the same model under auto
    tm_auto, _ = t_build(tiny_model_cfg, CITYSCAPES_CLASSES, device="cpu")
    tm_auto = port(tm_auto, variables)
    with torch.no_grad():
        assert torch.equal(tm_auto(t(img), texts)["seg"], got["seg"])


def test_ring_core_falls_back_and_refuses_over_a_group(monkeypatch):
    q, k, v = (torch.randn(1, 10, 2, 8) for _ in range(3))
    want = t_layers.attention_core(q, k, v, impl="auto")
    assert torch.equal(t_layers.attention_core(q, k, v, impl="ring"), want)
    monkeypatch.setattr(port_mesh, "world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match=r"attn_impl: ring over 2 processes is not "
                                                  r"ported yet .*ROADMAP §1 item 1"):
        t_layers.attention_core(q, k, v, impl="ring")
    # causal and cross attention take auto over a group too, as in JAX
    assert torch.equal(t_layers.attention_core(q, k, v, impl="ring", causal=True),
                       t_layers.attention_core(q, k, v, impl="auto", causal=True))
    kv = torch.randn(1, 6, 2, 8)
    assert torch.equal(t_layers.attention_core(q, kv, kv, impl="ring"),
                       t_layers.attention_core(q, kv, kv, impl="auto"))
    with pytest.raises(NotImplementedError, match="ring over 2 processes"):
        port_mesh.check_ported({"data": 2}, {"attn_impl": "ring"})


def test_ring_never_takes_the_qkv_kernel(monkeypatch):
    """As JAX's `_qkv_kernel_applicable`: `ring` is `xla` for the fused
    kernels, even where the dispatch believes it is on CUDA."""
    from denseclip_vit_multimodal_tpu_torch.ops import attention as t_attention

    monkeypatch.setattr(t_attention, "_on_cuda", lambda x: True)
    tm = t_layers.MultiHeadAttention(128, 2, attn_impl="ring")
    assert not tm._qkv_kernel_applicable(torch.empty(1, 1500, 384), 128)
    t_layers.set_attn_impl(tm, "auto")
    assert tm._qkv_kernel_applicable(torch.empty(1, 1500, 384), 128)
