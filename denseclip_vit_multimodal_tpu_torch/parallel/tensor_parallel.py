"""Megatron tensor parallelism over the mesh's `model` axis (the port of what
JAX's `parallel/sharding_rules.py` asks of XLA's partitioner for the
transformer blocks).

Where JAX's rules shard a block's `attn/qkv` and `mlp/c_fc` column-parallel
and its `attn/out` and `mlp/c_proj` row-parallel, each rank of a model group
of M holds 1/M of those weights and computes with them:

  * `copy_to_model` (Megatron's f), before a column-parallel layer: the
    identity forward, an all-reduce of the gradient over the model group in
    the backward;
  * `reduce_from_model` (Megatron's g), after a row-parallel layer: an
    all-reduce forward, the identity backward; the row-parallel bias is added
    once, after the reduction (`row_parallel`).

The fused qkv is split by heads, not as JAX lays it out: `P(None, 'model')`
on the [D, 3D] kernel splits its 3D columns contiguously, which is not
head-aligned (XLA's partitioner makes it right with extra communication).
A rank holds q, k and v of its H/M heads, [3·(H/M)·d, D] in the port's
layout, so the attention kernels (K1, K2) run unchanged on the local heads.
The function is the same.  Where JAX's rule falls back to replication (a
sharded dim that does not divide by M), and where the heads do not divide by
M, the layer stays replicated.

`tp_plan` says which rows or columns of each full parameter each model rank
holds; `apply_tensor_parallel` cuts the model's parameters to one rank's and
hands the layers their group; `unshard_tp` puts a full tensor back together.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from denseclip_vit_multimodal_tpu_torch.parallel.mesh import MODEL_AXIS
from denseclip_vit_multimodal_tpu_torch.parallel.sharding_rules import (
    jax_leaves,
    resolved_spec,
)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f (the identity without a model group)."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g (the identity without a model group)."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def row_parallel(linear: nn.Module, x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel `layers.Linear` on this rank's input columns: the
    partial products summed over the model group, then the bias, once."""
    dt = linear.compute_dtype
    y = reduce_from_model(F.linear(x.to(dt), linear.weight.to(dt)), group)
    return y if linear.bias is None else y + linear.bias.to(dt)


# --------------------------------------------------------------------------
# Which rows / columns a model rank holds
# --------------------------------------------------------------------------


def _chunk(n: int, rank: int, ways: int) -> torch.Tensor:
    return torch.arange(rank * n // ways, (rank + 1) * n // ways)


def qkv_rows(width: int, heads: int, rank: int, ways: int) -> torch.Tensor:
    """The rows of the fused [3D, D] qkv weight (and its [3D] bias) that
    model rank `rank` of `ways` holds: q, k and v of its heads, in order."""
    local = _chunk(heads, rank, ways)
    head_dim = width // heads
    rows = (local[:, None] * head_dim + torch.arange(head_dim)).reshape(-1)
    return torch.cat([part * width + rows for part in range(3)])


def tp_modules(model: nn.Module, mesh: Mapping[str, int]) -> Dict[str, str]:
    """The attention and MLP layers that JAX's rules shard on `mesh`:
    module name -> "attn" or "mlp".  An attention layer whose heads do not
    divide by the model axis stays replicated (as one whose dims do not)."""
    from denseclip_vit_multimodal_tpu_torch.models.layers import MLP, MultiHeadAttention

    ways = mesh.get(MODEL_AXIS, 1)
    if ways <= 1:
        return {}
    leaves = jax_leaves(model)
    sharded = {name for leaf in leaves.values() if resolved_spec(leaf.path, leaf.shape, mesh)
               for name, _ in leaf.members}
    out = {}
    for name, module in model.named_modules():
        if isinstance(module, MultiHeadAttention) and not module.cross:
            if (f"{name}.qkv.weight" in sharded and f"{name}.out.weight" in sharded
                    and module.num_heads % ways == 0):
                out[name] = "attn"
        elif isinstance(module, MLP):
            if f"{name}.c_fc.weight" in sharded and f"{name}.c_proj.weight" in sharded:
                out[name] = "mlp"
    return out


def tp_plan(model: nn.Module, mesh: Mapping[str, int]
            ) -> Dict[str, Tuple[int, List[torch.Tensor]]]:
    """Parameter name -> (dim, [indices along it that model rank r holds,
    for each r]) for every full parameter tensor parallelism cuts (the
    row-parallel biases are not cut)."""
    ways = mesh.get(MODEL_AXIS, 1)
    out: Dict[str, Tuple[int, List[torch.Tensor]]] = {}
    for name, kind in tp_modules(model, mesh).items():
        module = model.get_submodule(name)
        if kind == "attn":
            width = module.out.weight.shape[0]
            rows = [qkv_rows(width, module.num_heads, r, ways) for r in range(ways)]
            out[f"{name}.qkv.weight"] = (0, rows)
            if module.qkv.bias is not None:
                out[f"{name}.qkv.bias"] = (0, rows)
            out[f"{name}.out.weight"] = (1, [_chunk(width, r, ways) for r in range(ways)])
        else:
            hidden = [_chunk(module.c_fc.weight.shape[0], r, ways) for r in range(ways)]
            out[f"{name}.c_fc.weight"] = (0, hidden)
            out[f"{name}.c_fc.bias"] = (0, hidden)
            out[f"{name}.c_proj.weight"] = (1, hidden)
    return out


def apply_tensor_parallel(model: nn.Module, mesh: Mapping[str, int], plan, rank: int,
                          group) -> None:
    """Cut the model's parameters to model rank `rank`'s slices of `plan`
    (`tp_plan`, made on the full model) and give the layers the model
    group.  The model must hold full parameters (every rank the same)."""
    from denseclip_vit_multimodal_tpu_torch.models.layers import MultiHeadAttention

    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, (dim, indices) in plan.items():
            params[name].data = local_of(params[name].data, dim, indices[rank])
    ways = mesh.get(MODEL_AXIS, 1)
    for name in {n.rpartition(".")[0].rpartition(".")[0] for n in plan}:
        module = model.get_submodule(name)
        module.tp_group = group
        if isinstance(module, MultiHeadAttention):
            module.num_heads //= ways


def local_of(full: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """A model rank's slice of a full tensor."""
    return full.index_select(dim, index.to(full.device)).contiguous()


def unshard_tp(local: torch.Tensor, dim: int, indices: List[torch.Tensor], group
               ) -> torch.Tensor:
    """The full tensor from every model rank's slice along `dim`: gathered
    over the model group, each rank's slice put back at its `indices`."""
    from denseclip_vit_multimodal_tpu_torch.parallel.mesh import all_gather

    ways = len(indices)
    moved = local.movedim(dim, 0).contiguous()
    gathered = all_gather(moved, group).view(ways, *moved.shape)
    full = moved.new_empty((sum(len(i) for i in indices),) + tuple(moved.shape[1:]))
    for r in range(ways):
        full[indices[r].to(full.device)] = gathered[r]
    return full.movedim(0, dim).contiguous()
