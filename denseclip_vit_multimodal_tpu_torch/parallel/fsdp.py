"""ZeRO-3 (FSDP) over the data axis, and the sharded train state (the port of
the JAX package's `tpu.fsdp` / `shard_train_state`,
`parallel/sharding_rules.py:141-198`).

JAX places every leaf of the train state by `resolved_spec`: tensor-parallel
over `model`, plus, under `tpu.fsdp`, a shard over `data` on the largest
free divisible dim of every leaf of at least `fsdp_min_size` elements, the
frozen ones included; Adam's moments take their parameter's placement.
`shard_train_state` does the same to the port's state:

  * at rest each rank holds its slice of every parameter (`ParamShard`):
    its model rank's rows or columns (`tensor_parallel.py`), then its 1/D of
    the dim JAX's rule puts on `data`.  Where that dim is the layer axis of
    a scan-stacked leaf (a [L, 4D] c_fc bias whose 4D is the model axis's),
    each layer's tensor lives whole on one data rank (`owner`) and is empty
    on the others.  The optimizer's moments are created on these tensors,
    so they take the same slices;
  * forward: a unit's parameters are gathered just before its forward and
    freed after it (`.data` swapped between the shard and the gathered
    tensor, as FSDP1 does).  The unit is one `ResidualAttentionBlock`; the
    rest of the model is one root unit, gathered for the whole step;
  * backward: a tensor hook on a block's output gathers its parameters again
    before its backward runs (under `tpu.remat` the recomputed forward runs
    inside that backward and keeps them); as each parameter's gradient is
    accumulated, a hook reduce-scatters it over the data group, as the mean,
    into the parameter's shard gradient and frees the parameter.  At the end
    of the backward (`finish_backward`) everything is freed and the shard
    gradients become `.grad`;
  * checkpoints: `full_state_dict` / `full_optimizer_state` put every
    tensor back together (the file a one-process run writes), and
    `load_state_dict` / `load_optimizer_state` slice a full file for this
    layout (JAX's topology-portable checkpoints).

The step (`train/step.py`) averages the gradients of what is not sharded
by all-reduces over the data group, the model group or every rank
(`gradient_groups`), and the optimizer's global norm adds each rank's
squares once (`norm_weight`).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from denseclip_vit_multimodal_tpu_torch.parallel import mesh as mesh_lib
from denseclip_vit_multimodal_tpu_torch.parallel import tensor_parallel as tp_lib
from denseclip_vit_multimodal_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from denseclip_vit_multimodal_tpu_torch.parallel.sharding_rules import (
    FSDP_MIN_SIZE,
    fsdp_extend_spec,
    jax_leaves,
    per_device_elements,
    resolved_spec,
)


class ParamShard:
    """How one parameter is held on this rank: `tp` (dim, every model
    rank's indices) cut over the model group; then `dim` cut into the data
    group's equal chunks, or the whole tensor on data rank `owner` alone."""

    def __init__(self, name: str, tp=None, dim: Optional[int] = None,
                 owner: Optional[int] = None):
        self.name, self.tp, self.dim, self.owner = name, tp, dim, owner

    @property
    def data_sharded(self) -> bool:
        return self.dim is not None or self.owner is not None

    # -- full tensor <-> this rank's tensor ---------------------------------

    def tp_local(self, full: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return full
        dim, indices = self.tp
        return tp_lib.local_of(full, dim, indices[mesh_lib.model_rank()])

    def data_local(self, t: torch.Tensor) -> torch.Tensor:
        """This data rank's part of a model rank's tensor `t`."""
        if self.dim is not None:
            n = t.shape[self.dim] // mesh_lib.data_size()
            return t.narrow(self.dim, mesh_lib.data_rank() * n, n).contiguous()
        if self.owner is not None and mesh_lib.data_rank() != self.owner:
            return t.new_empty((0,) + tuple(t.shape[1:]))
        return t

    def local(self, full: torch.Tensor) -> torch.Tensor:
        return self.data_local(self.tp_local(full)).contiguous()

    def gather_data(self, local: torch.Tensor, shape: torch.Size) -> torch.Tensor:
        """The model rank's tensor (of `shape`) from every data rank's part."""
        group = mesh_lib.data_group()
        if self.dim is not None:
            moved = local.movedim(self.dim, 0).contiguous()
            return mesh_lib.all_gather(moved, group).movedim(0, self.dim).contiguous()
        if self.owner is not None:
            full = local if mesh_lib.data_rank() == self.owner else local.new_empty(shape)
            full = full.contiguous()
            src = mesh_lib.axis_ranks(mesh_lib.layout().mesh, mesh_lib.rank(), DATA_AXIS)
            dist.broadcast(full, src=src[self.owner], group=group)
            return full
        return local

    def full(self, local: torch.Tensor, shape: torch.Size) -> torch.Tensor:
        """The full parameter from every rank's part (collective); `shape`
        is the model rank's tensor's."""
        t = self.gather_data(local, shape)
        if self.tp is None:
            return t
        return tp_lib.unshard_tp(t, self.tp[0], self.tp[1], mesh_lib.model_group())

    def reduce_grad(self, grad: torch.Tensor) -> torch.Tensor:
        """The mean over the data group of the ranks' gradients of the model
        rank's tensor, this rank's part of it (collective)."""
        group, ways = mesh_lib.data_group(), mesh_lib.data_size()
        if self.dim is not None:
            moved = grad.movedim(self.dim, 0).contiguous()
            return mesh_lib.reduce_scatter(moved, group).div_(ways).movedim(
                0, self.dim).contiguous()
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=group)
        return self.data_local(grad.div_(ways))


class FSDP:
    """The gather / free / reduce-scatter hooks of the data-sharded
    parameters of `model` (one unit a `ResidualAttentionBlock`, the rest the
    root unit)."""

    def __init__(self, model: nn.Module, shards: Mapping[str, ParamShard],
                 shapes: Mapping[str, torch.Size]):
        from denseclip_vit_multimodal_tpu_torch.models.layers import ResidualAttentionBlock

        params = dict(model.named_parameters())
        self.entries: Dict[int, Tuple[nn.Parameter, ParamShard, torch.Size]] = {}
        for name, shard in shards.items():
            if shard.data_sharded:
                p = params[name]
                self.entries[id(p)] = (p, shard, shapes[name])
        in_block = set()
        for block in model.modules():
            if isinstance(block, ResidualAttentionBlock):
                unit = [p for p in block.parameters() if id(p) in self.entries]
                in_block.update(id(p) for p in block.parameters())
                if unit:
                    self._hook_block(block, unit)
        self.root = [p for p in model.parameters()
                     if id(p) in self.entries and id(p) not in in_block]
        model.register_forward_pre_hook(self._before_root)
        model.register_forward_hook(self._after_root)
        self.gathered: set = set()
        self.in_backward: set = set()
        self.grads: Dict[int, torch.Tensor] = {}
        for p, _, _ in self.entries.values():
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(self._grad_ready)

    def _hook_block(self, block: nn.Module, unit: List[nn.Parameter]) -> None:
        key = id(block)

        def before(module, args):
            self.gather(unit)

        def after(module, args, output):
            if torch.is_grad_enabled() and isinstance(output, torch.Tensor) \
                    and output.requires_grad:
                def backward_begins(grad):
                    self.in_backward.add(key)
                    self.gather(unit)
                output.register_hook(backward_begins)
            if key not in self.in_backward:  # a recompute inside the backward keeps them
                self.free(unit)

        block.register_forward_pre_hook(before)
        block.register_forward_hook(after)

    def _before_root(self, module, args):
        self.in_backward.clear()  # a new forward: no block's backward is running
        self.gather(self.root)

    def _after_root(self, module, args, output):
        if not torch.is_grad_enabled():  # inference: nothing is needed after the forward
            self.free(self.root)

    def gather(self, params: List[nn.Parameter]) -> None:
        with torch.inference_mode(False), torch.no_grad():
            for p in params:
                if id(p) in self.gathered:
                    continue
                _, shard, shape = self.entries[id(p)]
                p._fsdp_shard = p.data
                p.data = shard.gather_data(p.data, shape)
                self.gathered.add(id(p))

    def free(self, params: List[nn.Parameter]) -> None:
        for p in params:
            if id(p) in self.gathered:
                p.data = p._fsdp_shard
                del p._fsdp_shard
                self.gathered.discard(id(p))

    def _grad_ready(self, p: nn.Parameter) -> None:
        _, shard, _ = self.entries[id(p)]
        with torch.no_grad():
            part = shard.reduce_grad(p.grad)
        p.grad = None
        prev = self.grads.get(id(p))
        self.grads[id(p)] = part if prev is None else prev.add_(part)
        self.free([p])

    def finish_backward(self) -> None:
        """Free every gathered parameter and hand each data-sharded
        parameter its shard gradient as `.grad` (None where none came)."""
        self.free([p for p, _, _ in self.entries.values()])
        self.in_backward.clear()
        for key, grad in self.grads.items():
            self.entries[key][0].grad = grad
        self.grads = {}


class ShardedState:
    """The checkpoint side of a train state held in parts (`Sharding` here,
    `parallel/pipeline.py::StageSharding`): `shards[name]` puts a
    parameter's (or a moment's) tensor whole from every rank's part
    (`full(local, shape)`, collective) and cuts this rank's part from the
    whole (`local`); `shapes[name]` is the whole tensor's shape; a name
    without a shard is replicated."""

    # -- checkpoints ------------------------------------------------------------

    def full_state_dict(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The model's state_dict with full tensors (collective)."""
        self.finish_backward()
        out = {}
        for name, t in model.state_dict().items():
            shard = self.shards.get(name)
            out[name] = t if shard is None else shard.full(t, self.shapes[name])
        return out

    def load_state_dict(self, model: nn.Module, full: Mapping[str, torch.Tensor]) -> None:
        """Load a full state_dict (a one-process checkpoint) into this layout."""
        self.finish_backward()
        local = {k: (v if k not in self.shards else self.shards[k].local(
            v.to(self._device(model)))) for k, v in full.items()}
        params = dict(model.named_parameters())
        with torch.no_grad():
            for name, p in params.items():  # shapes change with the layout
                p.data = torch.empty_like(local[name])
        model.load_state_dict(local)

    @staticmethod
    def _device(model: nn.Module) -> torch.device:
        return next(model.buffers(), next(model.parameters())).device

    def finish_backward(self) -> None:
        pass

    def _optimizer_params(self, model: nn.Module, inner) -> List[Tuple[str, nn.Parameter]]:
        names = {id(p): n for n, p in model.named_parameters()}
        return [(names[id(p)], p) for g in inner.param_groups for p in g["params"]]

    def full_optimizer_state(self, model: nn.Module, optimizer) -> dict:
        """The optimizer's state_dict with full moments (collective), keyed
        in the unsharded order."""
        sd = optimizer.state_dict()
        params = self._optimizer_params(model, optimizer.inner)
        state = {}
        for idx, entry in sd["inner"]["state"].items():
            name, p = params[idx]
            state[idx] = {k: (self.shards[name].full(v, self.shapes[name])
                              if torch.is_tensor(v) and v.dim() > 0 else v)
                          for k, v in entry.items()}
        return {**sd, "inner": {**sd["inner"], "state": state}}

    def load_optimizer_state(self, model: nn.Module, optimizer, full: dict) -> None:
        params = self._optimizer_params(model, optimizer.inner)
        state = {}
        for idx, entry in full["inner"]["state"].items():
            name, p = params[int(idx)]
            state[idx] = {k: (self.shards[name].local(v.to(p.device))
                              if torch.is_tensor(v) and v.dim() > 0 else v)
                          for k, v in entry.items()}
        optimizer.load_state_dict({**full, "inner": {**full["inner"], "state": state}})


class Sharding(ShardedState):
    """The layout of a train state over the mesh: each parameter's
    `ParamShard`, the FSDP hooks, and the JAX specs they follow."""

    def __init__(self, model: nn.Module, mesh: Mapping[str, int], fsdp: bool,
                 fsdp_min_size: int = FSDP_MIN_SIZE):
        self.mesh, self.fsdp, self.fsdp_min_size = dict(mesh), fsdp, int(fsdp_min_size)
        self.leaves = jax_leaves(model)
        self.tp_plan = tp_lib.tp_plan(model, self.mesh)
        data_ways = self.mesh.get(DATA_AXIS, 1)
        self.jax_specs, self.port_specs, self.shards = {}, {}, {}
        for path, leaf in self.leaves.items():
            spec = resolved_spec(path, leaf.shape, self.mesh, fsdp, self.fsdp_min_size)
            self.jax_specs[path] = spec
            tp_spec = resolved_spec(path, leaf.shape, self.mesh)
            if tp_spec and leaf.members[0][0] not in self.tp_plan:
                # JAX's split that the port does not make (heads % M != 0):
                # replicated over model, FSDP on what is left
                spec = () if not fsdp else fsdp_extend_spec(
                    (), leaf.shape, data_ways, self.fsdp_min_size)
            self.port_specs[path] = spec
            entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
            data_dim = entries.index(DATA_AXIS) if DATA_AXIS in entries else None
            for name, layer in leaf.members:
                dim = owner = None
                if data_dim is not None and data_ways > 1:
                    port_dim = leaf.port_dim(data_dim)
                    if port_dim is None:  # the layer axis
                        owner = layer // (leaf.shape[0] // data_ways)
                    else:
                        dim = port_dim
                self.shards[name] = ParamShard(name, self.tp_plan.get(name), dim, owner)
        self.fsdp_hooks: Optional[FSDP] = None

    def apply(self, model: nn.Module) -> None:
        """Cut the model's full parameters to this rank's and hook FSDP."""
        tp_lib.apply_tensor_parallel(model, self.mesh, self.tp_plan, mesh_lib.model_rank(),
                                     mesh_lib.model_group())
        params = dict(model.named_parameters())
        self.shapes = {n: p.shape for n, p in params.items()}  # a model rank's, gathered
        with torch.no_grad():
            for name, shard in self.shards.items():
                if shard.data_sharded:
                    params[name].data = shard.data_local(params[name].data)
        if any(s.data_sharded for s in self.shards.values()):
            self.fsdp_hooks = FSDP(model, self.shards, self.shapes)
        model._port_sharding = self

    # -- the optimizer's view -------------------------------------------------

    def norm_weight(self, name: str) -> float:
        """1 / the number of ranks that hold the same values of `name`."""
        s = self.shards[name]
        copies = (1 if s.data_sharded else self.mesh.get(DATA_AXIS, 1)) * (
            1 if s.tp is not None else self.mesh.get(MODEL_AXIS, 1))
        return 1.0 / copies

    def gradient_groups(self, named: Mapping[str, nn.Parameter]) -> Dict[str, list]:
        """The trainable parameters by the group their gradients are still
        averaged over once the backward is done: "world" (held whole by
        every rank), "data" (cut over the model group), "model" (cut over the
        data group, already reduce-scattered there)."""
        out: Dict[str, list] = {"world": [], "data": [], "model": []}
        for name, p in named.items():
            s = self.shards[name]
            if s.data_sharded and s.tp is not None:
                continue
            out["model" if s.data_sharded else "data" if s.tp is not None else "world"].append(p)
        return out

    def finish_backward(self) -> None:
        if self.fsdp_hooks is not None:
            self.fsdp_hooks.finish_backward()

    # -- what a device holds ----------------------------------------------------

    def jax_elements(self, frozen: Optional[set] = None) -> Tuple[int, int]:
        """(parameter, Adam moment) elements JAX's specs put on one device:
        every leaf, and two moments of each trainable one (the names in
        `frozen` have none, as optax's `set_to_zero`)."""
        frozen = frozen or set()
        params = moments = 0
        for path, leaf in self.leaves.items():
            n = per_device_elements(leaf.shape, self.jax_specs[path], self.mesh)
            params += n
            if leaf.members[0][0] not in frozen:
                moments += 2 * n
        return params, moments


def resident_elements(model: nn.Module, optimizer) -> Tuple[int, int]:
    """(parameter, moment) elements this rank holds: its parameters' and
    the tensors of its optimizer's state (exp_avg, exp_avg_sq)."""
    params = sum(p.numel() for p in model.parameters())
    moments = sum(v.numel() for entry in optimizer.inner.state.values() for v in entry.values()
                  if torch.is_tensor(v) and v.dim() > 0)
    return params, moments


def shard_train_state(state, mesh: Mapping[str, int], fsdp: bool = False,
                      fsdp_min_size: int = FSDP_MIN_SIZE) -> Sharding:
    """Shard a TrainState built on full, replicated parameters: TP over the
    model group, plus ZeRO-3 over the data group under `fsdp`; the
    optimizer's moments follow (they are created on the shards).  Returns
    the `Sharding`, also kept on the state."""
    sharding = Sharding(state.model, mesh, fsdp, fsdp_min_size)
    sharding.apply(state.model)
    state.optimizer.sharding = sharding
    state.sharding = sharding
    return sharding


def sharding_of(model: nn.Module) -> Optional[Sharding]:
    return getattr(model, "_port_sharding", None)
