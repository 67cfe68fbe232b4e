"""The port's CLIP ResNet (`models/resnet.py`) against the JAX package's, on
the CPU, in fp32: the anti-aliased bottleneck, the stem, both trunks and the
attention pool, at odd sizes (average pools floor them) and with BatchNorm in
eval mode and in train mode (outputs and the updated running statistics).
Tolerances: max abs 1e-4 and relative L2 1e-5 (`torch_parity.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from denseclip_vit_multimodal_tpu.models import resnet as j_resnet
from denseclip_vit_multimodal_tpu_torch.convert import flax_to_state_dict
from denseclip_vit_multimodal_tpu_torch.models import layers as t_layers
from denseclip_vit_multimodal_tpu_torch.models import resnet as t_resnet
from denseclip_vit_multimodal_tpu_torch.ops import attention as t_attention
from torch_parity import assert_parity, init, port, randn, t

LAYERS, WIDTH, OUT = (1, 2, 1, 1), 8, 48


def _apply(jm, v, x, mutate, **kw):
    """JAX forward; with `mutate` (train mode) also the updated batch_stats."""
    if not mutate:
        return jm.apply(v, jnp.asarray(x), **kw), None
    out, mutated = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"], **kw)
    return out, mutated["batch_stats"]


def _check_stats(tm, new_stats, prefix=""):
    want = flax_to_state_dict({"batch_stats": jax.tree.map(np.asarray, new_stats)})
    got = tm.state_dict()
    assert want
    for key, value in want.items():
        assert_parity(value.numpy(), got[prefix + key], what=key)


@pytest.mark.parametrize("size", [(7, 9), (8, 6)])
def test_avg_pool_floors_odd_sizes(size):
    x = randn(2, *size, 5, seed=3)
    want = fnn.avg_pool(jnp.asarray(x), (2, 2), strides=(2, 2), padding="VALID")
    got = t_resnet._avg_pool(t(x), 2)
    assert tuple(got.shape) == (2, size[0] // 2, size[1] // 2, 5)
    assert_parity(want, got)


@pytest.mark.parametrize("cin,planes,stride,train", [
    (16, 8, 2, False), (16, 8, 2, True),  # strided: pooled residual + downsample
    (32, 8, 1, False),                    # identity shortcut
    (16, 8, 1, True),                     # width change: 1x1 downsample at stride 1
])
def test_bottleneck_matches_jax(cin, planes, stride, train):
    x = randn(2, 9, 11, cin, seed=1)
    jm = j_resnet.Bottleneck(planes=planes, stride=stride)
    v = init(jm, jnp.asarray(x))
    tm = port(t_resnet.Bottleneck(cin, planes, stride), v)
    assert (tm.downsample_conv is None) == (stride == 1 and cin == planes * 4)
    want, stats = _apply(jm, v, x, train, train=train)
    with torch.no_grad():
        got = tm(t(x), train=train)
    assert tuple(got.shape) == (2, 9 // stride, 11 // stride, planes * 4)
    assert_parity(want, got)
    if train:
        _check_stats(tm, stats)


@pytest.mark.parametrize("train", [False, True])
def test_stem_matches_jax(train):
    x = randn(2, 37, 51, 3, seed=2)
    jm = j_resnet._Stem(width=WIDTH)
    v = init(jm, jnp.asarray(x))
    tm = port(t_resnet._Stem(WIDTH), v)
    want, stats = _apply(jm, v, x, train, train=train)
    with torch.no_grad():
        got = tm(t(x), train=train)
    assert tuple(got.shape) == (2, 9, 13, WIDTH)  # 37 -> 19 (stride-2 conv) -> 9 (pool)
    assert_parity(want, got)
    if train:
        _check_stats(tm, stats)


@pytest.mark.parametrize("train", [False, True])
def test_clip_resnet_matches_jax(train):
    x = randn(2, 72, 100, 3, seed=4)
    jm = j_resnet.CLIPResNet(layers=LAYERS, width=WIDTH)
    v = init(jm, jnp.asarray(x))
    tm = port(t_resnet.CLIPResNet(LAYERS, WIDTH), v)
    want, stats = _apply(jm, v, x, train, deterministic=not train)
    with torch.no_grad():
        got = tm(t(x), deterministic=not train)
    assert [tuple(g.shape) for g in got] == [(2, 18, 25, 32), (2, 9, 12, 64), (2, 4, 6, 128),
                                             (2, 2, 3, 256)]
    assert tm.stage_channels == (32, 64, 128, 256)
    for i, (a, b) in enumerate(zip(want, got)):
        assert_parity(a, b, what=f"c{i + 1}")
    if train:
        _check_stats(tm, stats)


@pytest.mark.parametrize("train", [False, True])
def test_resnet_with_attention_matches_jax(train):
    """c1..c4, the pooled map and the global feature (JAX `sow`s it) at
    72 x 100, whose 2 x 3 pool grid is not the base 2 x 2.

    In train mode every BatchNorm normalises by its batch statistics, whose
    one-pass variance loses digits to cancellation.  At the pooled map JAX's
    fp32 result is ~1.2e-5 (relative L2) from the port's run with float64
    convs and projections, the port's fp32 result ~5e-6.  So in train mode
    the pool is held to JAX on JAX's c4 (the pool has no BatchNorm, and the
    stages are held above it)."""
    x = randn(2, 72, 100, 3, seed=5)
    jm = j_resnet.CLIPResNetWithAttention(layers=LAYERS, width=WIDTH, output_dim=OUT,
                                          input_resolution=64)
    v = init(jm, jnp.asarray(x))
    tm = port(t_resnet.CLIPResNetWithAttention(LAYERS, WIDTH, OUT, input_resolution=64), v)
    mutable = ["intermediates"] + (["batch_stats"] if train else [])
    want, mutated = jm.apply(v, jnp.asarray(x), deterministic=not train, mutable=mutable)
    with torch.no_grad():
        maps, global_feat = tm(t(x), deterministic=not train, return_global=True)
    assert len(maps) == 5 and tuple(maps[-1].shape) == (2, 2, 3, OUT)
    if train:
        _check_stats(tm, mutated["batch_stats"])
        with torch.no_grad():
            global_feat, pooled = tm.attnpool(t(want[3]))
        maps = maps[:4] + (pooled,)
    for i, (a, b) in enumerate(zip(want, maps)):
        assert_parity(a, b, what=f"level {i}")
    assert_parity(mutated["intermediates"]["attnpool_global"][0], global_feat, what="global")


@pytest.mark.parametrize("grid", [(4, 4), (3, 5), (6, 7)])
def test_attention_pool_matches_jax(grid):
    """Base grid 4: resized where the runtime grid differs (shrinking antialiases)."""
    x = randn(2, *grid, 64, seed=6)
    jm = j_resnet.AttentionPool2d(spacial_dim=4, num_heads=32, output_dim=24)
    v = init(jm, jnp.asarray(x))
    tm = port(t_resnet.AttentionPool2d(4, 64, 32, 24), v)
    want_g, want_map = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got_g, got_map = tm(t(x))
    assert_parity(want_g, got_g, what="global")
    assert_parity(want_map, got_map, what="map")


def test_attention_pool_never_takes_a_kernel(monkeypatch):
    """At 32 x 33 the pool sees 1057 tokens: K1's window on the card.  The
    JAX module pins plain attention; so does the port, whatever the device
    looks like."""
    monkeypatch.setattr(t_attention, "_on_cuda", lambda *a, **k: True)

    def no_kernel(*a, **k):
        raise AssertionError("the attention pool reached a kernel")

    for name in ("flash_attention", "mha_qkv_attention", "mha_qkv_attention_int8"):
        monkeypatch.setattr(t_layers, name, no_kernel)
    tm = t_resnet.AttentionPool2d(8, 64, 32, 16, dtype=torch.bfloat16)
    with torch.no_grad():
        global_feat, local_map = tm(torch.randn(1, 32, 33, 64))
    assert tuple(local_map.shape) == (1, 32, 33, 16) and torch.isfinite(global_feat).all()
