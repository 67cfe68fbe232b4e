"""The port's sharding rules (`parallel/sharding_rules.py`) against the JAX
package's `param_partition_spec` / `fsdp_extend_spec` / `resolved_spec`, on
the tiny flagship tree (the flagship preset's `model:` section at width 128,
4 heads, 2 layers; its text tower at 2 layers), over the meshes `{data: 8}`,
`{data: 4, model: 2}` and `{data: 2, model: 2}` of conftest's virtual
devices, with FSDP on and off, at `fsdp_min_size` 1024 and the default:
both sides shard the same leaves the same way and put the same elements on
a device.  `jax_leaves` recovers JAX's tree (paths and shapes) from the
port's names, and `test_fsdp.py::test_fsdp_spec_rules`'s `_Leaf` cases
carry over.  `Sharding` (`parallel/fsdp.py`) then places each port tensor
of a leaf by that spec, and keeps an attention layer whose heads do not
divide by the model axis replicated."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.parallel import sharding_rules as jax_rules
from denseclip_vit_multimodal_tpu.parallel.mesh import make_mesh
from denseclip_vit_multimodal_tpu_torch.core.config import load_config
from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
    CITYSCAPES_CLASSES,
    build_denseclip,
)
from denseclip_vit_multimodal_tpu_torch.parallel import sharding_rules as rules
from denseclip_vit_multimodal_tpu_torch.parallel.fsdp import Sharding
from denseclip_vit_multimodal_tpu_torch.parallel.tensor_parallel import qkv_rows, tp_plan

FLAGSHIP = "configs/denseclip_vitb16_cityscapes_multitask.yaml"
TINY = ["model.backbone.width=128", "model.backbone.heads=4", "model.backbone.layers=2",
        "model.backbone.out_indices=[0,1]", "model.text_encoder.transformer_layers=2",
        "model.neck.inter_channels=32", "model.neck.out_channels=64",
        "model.decode_head.in_channels=64", "model.decode_head.channels=32",
        "model.depth_head.in_channels=64", "model.depth_head.channels=32"]
MESHES = [{"data": 8}, {"data": 4, "model": 2}, {"data": 2, "model": 2}]


class _Leaf:
    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(shape)
        self.size = int(np.prod(shape))


def _tiny(extra=()):
    return dict(load_config(FLAGSHIP, overrides=TINY + list(extra)).model)


@pytest.fixture(scope="module")
def trees():
    """JAX's parameter tree of the tiny flagship (shapes) and the port's model."""
    cfg = _tiny()
    jm, texts = j_build(cfg, CITYSCAPES_CLASSES)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), np.zeros((1, 64, 128, 3), np.float32),
                            texts)["params"]
    model, _ = build_denseclip(cfg, CITYSCAPES_CLASSES, device="cpu")
    return shapes, model


def _pad(spec, ndim):
    entries = list(spec)
    return tuple(entries + [None] * (ndim - len(entries)))


def _jax_leaves(shapes):
    return [(tuple(str(getattr(k, "key", k)) for k in path), path, leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]]


def test_jax_leaves_recovers_jax_tree(trees):
    shapes, model = trees
    want = {names: tuple(leaf.shape) for names, _, leaf in _jax_leaves(shapes)}
    got = {path: leaf.shape for path, leaf in rules.jax_leaves(model).items()}
    assert got == want
    # the scan-stacked blocks: one [L, ...] leaf for the L port tensors
    ln = rules.jax_leaves(model)[("backbone", "transformer", "blocks", "block", "ln_1", "scale")]
    assert ln.shape == (2, 128) and ln.members == [
        ("backbone.transformer.blocks.0.ln_1.weight", 0),
        ("backbone.transformer.blocks.1.ln_1.weight", 1)]


@pytest.mark.parametrize("min_size", [1024, rules.FSDP_MIN_SIZE])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_spec", MESHES, ids=str)
def test_resolved_specs_match_jax(trees, mesh_spec, fsdp, min_size):
    shapes, _ = trees
    n = int(np.prod(list(mesh_spec.values())))
    mesh = make_mesh(mesh_spec, devices=jax.devices()[:n])
    sharded = 0
    for names, path, leaf in _jax_leaves(shapes):
        want = jax_rules.resolved_spec(path, leaf, mesh, fsdp=fsdp, fsdp_min_size=min_size)
        got = rules.resolved_spec(names, tuple(leaf.shape), mesh_spec, fsdp=fsdp,
                                  fsdp_min_size=min_size)
        assert _pad(got, leaf.ndim) == _pad(want, leaf.ndim), names
        # the elements one device holds: JAX's shard shape of the leaf
        shard = jax.sharding.NamedSharding(mesh, want).shard_shape(leaf.shape)
        assert rules.per_device_elements(tuple(leaf.shape), got, mesh_spec) == int(
            np.prod(shard)), names
        sharded += bool(got)
    assert sharded > (0 if fsdp or "model" in mesh_spec else -1)
    if not fsdp and "model" not in mesh_spec:
        assert sharded == 0


@pytest.mark.parametrize("mesh_spec", MESHES[1:], ids=str)
def test_partition_specs_match_jax(trees, mesh_spec):
    shapes, _ = trees
    matched = []
    for names, path, leaf in _jax_leaves(shapes):
        want = jax_rules.param_partition_spec(path, leaf)
        got = rules.param_partition_spec(names, tuple(leaf.shape))
        assert _pad(got, leaf.ndim) == _pad(want, leaf.ndim), names
        if got:
            matched.append("/".join(names[-3:]))
    # every attn/qkv, attn/out, mlp/c_fc, mlp/c_proj kernel and column bias of
    # both towers' blocks
    assert sorted(set(matched)) == ["attn/out/kernel", "attn/qkv/bias", "attn/qkv/kernel",
                                    "mlp/c_fc/bias", "mlp/c_fc/kernel", "mlp/c_proj/kernel"]
    assert len(matched) == 12


def test_fsdp_spec_rules_carry_over():
    """`tests/test_fsdp.py::test_fsdp_spec_rules` on the port's rules."""
    for leaf, spec, dp, min_size in [((49408, 512), (), 8, 1), ((768, 2304), (None, "model"), 8, 1),
                                     ((8, 768, 2304), (None, None, "model"), 8, 1),
                                     ((96,), (), 8, rules.FSDP_MIN_SIZE), ((7, 19), (), 8, 1),
                                     ((49408, 512), (), 1, 1)]:
        want = jax_rules.fsdp_extend_spec(P(*spec), _Leaf(leaf), dp, min_size=min_size)
        got = rules.fsdp_extend_spec(spec, leaf, dp, min_size=min_size)
        assert _pad(got, len(leaf)) == _pad(want, len(leaf)), leaf
    assert rules.fsdp_extend_spec((), (49408, 512), 8, min_size=1) == ("data", None)
    assert rules.fsdp_extend_spec((None, "model"), (768, 2304), 8, min_size=1) == ("data", "model")
    assert rules.fsdp_extend_spec((None, None, "model"), (8, 768, 2304), 8, min_size=1) == (
        None, "data", "model")
    assert rules.fsdp_extend_spec((), (96,), 8) == ()
    assert rules.fsdp_extend_spec((), (7, 19), 8, min_size=1) == ()
    assert rules.fsdp_extend_spec((), (49408, 512), 1, min_size=1) == ()


def test_qkv_split_is_head_aligned():
    """Model rank r holds q, k and v of heads [r H/M, (r+1) H/M): the ranks'
    rows together are every row once."""
    width, heads, ways = 768, 12, 2
    rows = [qkv_rows(width, heads, r, ways) for r in range(ways)]
    assert torch.equal(torch.sort(torch.cat(rows)).values, torch.arange(3 * width))
    for part in range(3):  # q, k, v: each rank's heads are contiguous 64-row blocks
        assert torch.equal(rows[1][part * 384:(part + 1) * 384],
                           torch.arange(part * width + 384, (part + 1) * width))


def test_sharding_places_each_port_tensor_by_its_leaf(trees):
    """`Sharding` on `{data: 2, model: 2}` with FSDP at min size 1024: the
    port tensors of a stacked leaf take the leaf's data dim (mapped to the
    port's layout) or, where it is the layer axis, one data rank each; JAX's
    per-device elements are the sum of the port's."""
    _, model = trees
    mesh = {"data": 2, "model": 2}
    sharding = Sharding(model, mesh, fsdp=True, fsdp_min_size=1024)
    leaves = sharding.leaves
    qkv = ("backbone", "transformer", "blocks", "block", "attn", "qkv", "kernel")
    assert leaves[qkv].shape == (2, 128, 384)
    assert sharding.jax_specs[qkv] == (None, "data", "model")
    shard = sharding.shards["backbone.transformer.blocks.1.attn.qkv.weight"]
    assert shard.dim == 1 and shard.tp[0] == 0  # weight [3D, D]: data on D (in), model on 3D
    c_fc_bias = ("text_encoder", "transformer", "blocks", "block", "mlp", "c_fc", "bias")
    assert sharding.jax_specs[c_fc_bias] == ("data", "model")  # [2, 2048]: the layer axis
    owners = [sharding.shards[f"text_encoder.transformer.blocks.{i}.mlp.c_fc.bias"].owner
              for i in range(2)]
    assert owners == [0, 1]
    assert sharding.port_specs == sharding.jax_specs
    assert len(tp_plan(model, mesh)) == 2 * 2 * 6  # two towers, two layers, six tensors


def test_heads_that_do_not_divide_keep_attention_replicated():
    """3 heads over a 2-way model axis: JAX splits the [D, 3D] kernel's
    columns (not head-aligned); the port keeps the attention replicated and
    puts only the MLP on the model axis."""
    cfg = _tiny(["model.backbone.width=96", "model.backbone.heads=3"])
    model, _ = build_denseclip(cfg, CITYSCAPES_CLASSES, device="cpu")
    sharding = Sharding(model, {"model": 2}, fsdp=False)
    block = ("backbone", "transformer", "blocks", "block")
    assert sharding.jax_specs[block + ("attn", "qkv", "kernel")] == (None, None, "model")
    assert sharding.port_specs[block + ("attn", "qkv", "kernel")] == ()
    assert sharding.port_specs[block + ("attn", "out", "kernel")] == ()
    assert sharding.port_specs[block + ("mlp", "c_fc", "kernel")] == (None, None, "model")
    plan = tp_plan(model, {"model": 2})
    assert "backbone.transformer.blocks.0.attn.qkv.weight" not in plan
    assert "backbone.transformer.blocks.0.mlp.c_fc.weight" in plan
    assert "text_encoder.transformer.blocks.0.attn.qkv.weight" in plan  # 8 heads divide
