"""Tensor-parallel and FSDP sharding rules (the port of the JAX package's
`parallel/sharding_rules.py`), evaluated on the port's parameters as JAX's
leaves.

JAX assigns each parameter leaf a `PartitionSpec` over the mesh:

  qkv / c_fc kernels  [.., D, 3D|4D]  -> shard LAST dim  (column parallel)
  out / c_proj kernels [.., 3D|4D, D] -> shard FIRST weight dim (row parallel)
  biases of column-parallel layers    -> shard over model
  everything else (embeddings, norms, convs, heads, prompt) -> replicated

with replication where a sharded dim does not divide by its axis, and, under
`tpu.fsdp`, a data-axis shard added on the largest free divisible dim of
every leaf of at least `fsdp_min_size` elements (never dim 0 of a leaf of
rank >= 3: the `nn.scan` layer axis).  A spec here is a tuple with one entry
per dim (an axis name or None); `()` is replicated.

The rules read a leaf's Flax path and shape, so the port evaluates them on
JAX's leaves, which `jax_leaves` recovers from the port's names by
`convert.py`'s map reversed: JAX's `nn.scan` stacks a transformer's layers
as [L, ...], so the twelve `blocks.{i}.ln_1.weight` of a 768-wide tower are
one [12, 768] leaf of 9216 elements, and the port tensors of one leaf are
sharded together or not at all.  `JaxLeaf.port_dim` maps a leaf's dims to
the port tensors' (a Dense kernel [in, out] is the port's weight [out, in],
a Conv kernel HWIO its OIHW); dim 0 of a stacked leaf is its layer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
from torch import nn

from denseclip_vit_multimodal_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

Spec = Tuple[Optional[str], ...]

# (path-suffix match, which weight dim to shard counted from the end)
_COLUMN_SUFFIXES = (("attn", "qkv", "kernel"), ("mlp", "c_fc", "kernel"))
_ROW_SUFFIXES = (("attn", "out", "kernel"), ("mlp", "c_proj", "kernel"))
_COLUMN_BIAS_SUFFIXES = (("attn", "qkv", "bias"), ("mlp", "c_fc", "bias"))


def _ends_with(names: Tuple[str, ...], suffix: Tuple[str, ...]) -> bool:
    return len(names) >= len(suffix) and tuple(names[-len(suffix):]) == suffix


def param_partition_spec(names: Tuple[str, ...], shape: Tuple[int, ...]) -> Spec:
    """The tensor-parallel spec of one leaf (replicated by default)."""
    ndim = len(shape)
    if any(_ends_with(names, s) for s in _COLUMN_SUFFIXES + _COLUMN_BIAS_SUFFIXES):
        return (None,) * (ndim - 1) + (MODEL_AXIS,)
    if any(_ends_with(names, s) for s in _ROW_SUFFIXES):
        return (None,) * (ndim - 2) + (MODEL_AXIS, None)
    return ()


def _divisible(shape: Tuple[int, ...], spec: Spec, mesh: Mapping[str, int]) -> bool:
    return all(axis is None or shape[dim] % mesh[axis] == 0 for dim, axis in enumerate(spec))


# Leaves below this element count stay replicated under FSDP: sharding a
# LayerNorm vector saves nothing and adds an all-gather to every use.
FSDP_MIN_SIZE = 2 ** 15


def fsdp_extend_spec(spec: Spec, shape: Tuple[int, ...], dp_size: int,
                     min_size: int = FSDP_MIN_SIZE) -> Spec:
    """Add a DATA-axis shard (ZeRO-3) to `spec` on the largest free,
    divisible dim of a leaf of `shape`: never a dim already sharded (TP owns
    it), never dim 0 of a leaf of rank >= 3 (the scan layer axis), nothing
    for a leaf smaller than `min_size`."""
    ndim, size = len(shape), math.prod(shape)
    if ndim == 0 or size < min_size or dp_size <= 1:
        return spec
    entries = list(spec) + [None] * (ndim - len(spec))
    best = None
    for d in range(ndim):
        if entries[d] is not None or (ndim >= 3 and d == 0) or shape[d] % dp_size:
            continue
        if best is None or shape[d] > shape[best]:
            best = d
    if best is None:
        return spec
    entries[best] = DATA_AXIS
    return tuple(entries)


def resolved_spec(names: Tuple[str, ...], shape: Tuple[int, ...], mesh: Mapping[str, int],
                  fsdp: bool = False, fsdp_min_size: int = FSDP_MIN_SIZE) -> Spec:
    """The final spec of one leaf on `mesh`: the TP rules (replicated where
    a dim does not divide), then, under `fsdp`, the data-axis shard."""
    spec: Spec = ()
    if MODEL_AXIS in mesh:
        spec = param_partition_spec(names, shape)
        if spec and not _divisible(shape, spec, mesh):
            spec = ()
    if fsdp and DATA_AXIS in mesh:
        spec = fsdp_extend_spec(spec, shape, int(mesh[DATA_AXIS]), min_size=fsdp_min_size)
    return spec


def per_device_elements(shape: Tuple[int, ...], spec: Spec, mesh: Mapping[str, int]) -> int:
    """Elements of a leaf of `shape` on one device under `spec`."""
    n = math.prod(shape)
    for axis in spec:
        if axis is not None:
            n //= mesh[axis]
    return n


# --------------------------------------------------------------------------
# The port's parameters as JAX's leaves
# --------------------------------------------------------------------------


@dataclass
class JaxLeaf:
    """One leaf of JAX's parameter tree: its path, its shape, and the port
    tensors that hold it (`members`: (port name, layer) pairs, the layer
    None for an unstacked leaf), with the map from the leaf's per-layer dims
    to the port tensors' dims."""

    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    stacked: bool
    per_layer_dims: Tuple[int, ...]  # port dim of each per-layer JAX dim
    members: List[Tuple[str, Optional[int]]] = field(default_factory=list)

    def port_dim(self, jax_dim: int) -> Optional[int]:
        """The port tensors' dim of JAX dim `jax_dim`; None: the layer axis."""
        if self.stacked:
            return None if jax_dim == 0 else self.per_layer_dims[jax_dim - 1]
        return self.per_layer_dims[jax_dim]


def _flax_module_names(parts: List[str]) -> Tuple[List[str], Optional[int]]:
    """The port's module path as Flax's, and the layer of a scanned block."""
    out, layer, i = [], None, 0
    while i < len(parts):
        name = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if nxt is not None and nxt.isdigit():
            if name in ("process", "lateral", "output"):
                out.append(f"{name}_{nxt}")
            elif name == "layers":
                out.append(f"layer_{nxt}")
            elif name == "blocks":
                out += ["blocks", "block"]
                layer = int(nxt)
            else:  # a ResNet stage's bottleneck
                out += [name, f"block{nxt}"]
            i += 2
            continue
        out.append(name)
        i += 1
    return out, layer


def _leaf_of(model: nn.Module, name: str, ndim: int) -> Tuple[Tuple[str, ...], Optional[int],
                                                               Tuple[int, ...]]:
    """(Flax path, layer, port dim of each per-layer JAX dim) of parameter `name`."""
    from denseclip_vit_multimodal_tpu_torch.models.layers import LayerNorm

    mod_path, _, leaf = name.rpartition(".")
    module = model.get_submodule(mod_path) if mod_path else model
    mods, layer = _flax_module_names(mod_path.split(".") if mod_path else [])
    identity = tuple(range(ndim))
    if leaf == "weight":
        if mods and mods[-1] == "patch_embed" and ndim == 2:
            return tuple(mods), layer, (1, 0)
        if isinstance(module, nn.Embedding):
            return tuple(mods + ["embedding"]), layer, identity
        if isinstance(module, (LayerNorm, nn.BatchNorm2d, nn.LayerNorm)):
            return tuple(mods + ["scale"]), layer, identity
        if ndim == 2:
            return tuple(mods + ["kernel"]), layer, (1, 0)
        if ndim == 4:  # HWIO -> OIHW
            return tuple(mods + ["kernel"]), layer, (2, 3, 1, 0)
    return tuple(mods + [leaf]), layer, identity


def jax_leaves(model: nn.Module) -> Dict[Tuple[str, ...], JaxLeaf]:
    """JAX's parameter leaves of `model`, keyed by path, in the order the
    port's parameters first reach them.  Each leaf is checked against
    `convert.py`'s forward map: it must give back the port's own name."""
    from denseclip_vit_multimodal_tpu_torch.convert import _map_leaf

    leaves: Dict[Tuple[str, ...], JaxLeaf] = {}
    for name, p in model.named_parameters():
        path, layer, dims = _leaf_of(model, name, p.dim())
        flat = path
        if layer is not None:
            i = next(k for k in range(len(path) - 1) if path[k:k + 2] == ("blocks", "block"))
            flat = path[:i] + ("blocks", str(layer)) + path[i + 2:]
        jax_shape =tuple(p.shape[dims[j]] for j in range(p.dim()))
        back, _ = _map_leaf("params", flat, np.zeros(jax_shape, np.float32))
        if back != name:
            raise KeyError(f"{name}: its Flax leaf {'/'.join(path)} maps back to {back}")
        leaf = leaves.get(path)
        if leaf is None:
            shape = ((0,) if layer is not None else ()) + jax_shape
            leaf = leaves[path] = JaxLeaf(path, shape, layer is not None, dims)
        leaf.members.append((name, layer))
        if layer is not None:
            leaf.shape = (max(leaf.shape[0], layer + 1),) + jax_shape
    for leaf in leaves.values():
        if leaf.stacked and sorted(m[1] for m in leaf.members) != list(range(leaf.shape[0])):
            raise KeyError(f"{'/'.join(leaf.path)}: the stacked layers are not 0..L-1")
    return leaves
