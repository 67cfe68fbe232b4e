"""GPipe pipeline parallelism over a `pipe` mesh axis (the port of the JAX
package's `parallel/pipeline.py`).

JAX shards the scanned layer axis [L, ...] of a transformer stack over a
`pipe` mesh axis under a `shard_map`: stage s runs its contiguous L/S
blocks on each of M microbatches, activations hop one stage a tick by
`ppermute`, and `jax.grad` runs the backward pipeline through the
transposes.  Here the stages are the ranks of a pipe group
(`parallel/mesh.py::setup_layout` makes one for each stage chain), one card
a rank:

  * `PipelineContext`, `current_pipeline`, `activate_pipeline`,
    `pipeline_from_config` and `enable_pipeline_from_config` are JAX's, over
    the mesh spec (a dict of axis sizes); `current_pipeline()` is None for a
    one-stage pipe axis;
  * `pipeline_blocks(block_apply, layers, x, per_layer, mesh)` runs the L
    layers (a sequence: the ViT's blocks, or any per-layer parameters that
    `block_apply(layer, h, aux, microbatch)` takes) as a GPipe schedule and
    returns every layer's output, taps [L, B, ...], on every rank of the
    pipe group (JAX's `out_specs P(axis)` read by replicated consumers).
    Stage s receives each microbatch's activation from stage s - 1 and sends
    its output to stage s + 1 by point-to-point exchanges
    (`mesh.exchange`: through the host under Gloo on CUDA tensors); the taps
    are gathered over the pipe group.  The backward runs the microbatches in
    reverse order on every stage: each stage's taps' gradient (the same on
    every rank: the consumers are replicated) plus the gradient of its last
    output from stage s + 1, back through the stage's blocks, and the
    gradient of the stage's input to stage s - 1; stage 0's input gradient
    is broadcast over the pipe group, as every rank computed the input;
  * `StageSharding` holds each block of a pipelined stack on its stage
    alone (the others keep an empty tensor): its gradient stays there and
    its stage's optimizer updates it; what is replicated (embeddings, the
    neck, the heads, the text tower) gets its gradient averaged over every
    rank, so that the pipe ranks' copies cannot drift (on CUDA the bilinear
    resizes' backward adds by atomics).  A checkpoint is the one-process
    file: each block is broadcast from its stage at save and cut again at
    restore.

`models/layers.py::Transformer` routes a non-causal stack through
`pipeline_blocks` while a pipeline is active, with remat per block
(`torch.utils.checkpoint`) and the drop-path masks of each (layer,
microbatch) from a generator of their own.  Where L % S or B % M is not 0
it warns once and runs the stack replicated, as JAX does (a stack whose
blocks are held by their stages then broadcasts each block from its stage).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from denseclip_vit_multimodal_tpu_torch.parallel import mesh as mesh_lib
from denseclip_vit_multimodal_tpu_torch.parallel.fsdp import ShardedState
from denseclip_vit_multimodal_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS

_ACTIVE: contextvars.ContextVar[Optional["PipelineContext"]] = contextvars.ContextVar(
    "denseclip_torch_pipeline", default=None)


class PipelineContext:
    """Mesh + axis + microbatch count for an active pipeline region."""

    def __init__(self, mesh: Mapping[str, int], axis: str = PIPE_AXIS,
                 microbatches: Optional[int] = None):
        if axis not in mesh:
            raise ValueError(f"mesh {tuple(mesh)} has no '{axis}' axis")
        self.mesh = dict(mesh)
        self.axis = axis
        self.microbatches = microbatches

    @property
    def stages(self) -> int:
        return self.mesh[self.axis]


def current_pipeline() -> Optional[PipelineContext]:
    """The active pipeline context, or None (single-stage execution)."""
    ctx = _ACTIVE.get()
    if ctx is not None and ctx.stages == 1:
        return None  # a 1-stage pipeline is just the plain stack
    return ctx


@contextlib.contextmanager
def activate_pipeline(mesh: Mapping[str, int], axis: str = PIPE_AXIS,
                      microbatches: Optional[int] = None):
    """Route transformer stacks through the pipeline inside the block."""
    token = _ACTIVE.set(PipelineContext(mesh, axis, microbatches))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def _context_from_config(tpu_cfg: Any, mesh: Mapping[str, int]) -> Optional[PipelineContext]:
    """PipelineContext from the `tpu:` config section, or None when
    `tpu.pipeline` is absent or the mesh has no pipe axis
    (``tpu: {mesh: {data: 2, pipe: 4}, pipeline: {microbatches: 8}}``)."""
    pipe_cfg = tpu_cfg.get("pipeline") if tpu_cfg else None
    if pipe_cfg is None or PIPE_AXIS not in mesh:
        return None
    micro = pipe_cfg.get("microbatches") if hasattr(pipe_cfg, "get") else None
    return PipelineContext(mesh, PIPE_AXIS, micro)


def pipeline_from_config(tpu_cfg: Any, mesh: Mapping[str, int]):
    """`activate_pipeline` context manager from the config (a no-op context
    when the config asks for no pipeline)."""
    ctx = _context_from_config(tpu_cfg, mesh)
    if ctx is None:
        return contextlib.nullcontext()
    return activate_pipeline(ctx.mesh, ctx.axis, ctx.microbatches)


def enable_pipeline_from_config(tpu_cfg: Any, mesh: Mapping[str, int]) -> bool:
    """Process-lifetime variant of `pipeline_from_config` for the entry
    points; returns True when a pipeline was activated.  Calling again
    rebinds: a new config / mesh replaces the context, and a config without
    `tpu.pipeline` clears it."""
    _ACTIVE.set(_context_from_config(tpu_cfg, mesh))
    return current_pipeline() is not None


# --------------------------------------------------------------------------
# The schedule
# --------------------------------------------------------------------------


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors of one layer's parameters (a module, a tensor, or a
    tuple / list / dict of them)."""
    if isinstance(obj, nn.Module):
        return list(obj.parameters())
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    return []


class _Stage:
    """One stage's run of the schedule: its microbatches' graphs, kept from
    the forward for the backward."""

    def __init__(self, block_apply, layers, per_layer, x_shape, microbatches: int):
        self.block_apply, self.layers, self.per_layer = block_apply, layers, per_layer
        self.stages, self.stage, self.group = (mesh_lib.pipe_size(), mesh_lib.pipe_rank(),
                                               mesh_lib.pipe_group())
        self.m = microbatches
        self.local = len(layers) // self.stages
        self.first = self.stage * self.local
        self.x_shape = x_shape
        self.inputs: list = []
        self.outputs: list = []

    def _mb_shape(self):
        return (self.x_shape[0] // self.m,) + tuple(self.x_shape[1:])

    def forward(self, x: torch.Tensor, grad: bool) -> torch.Tensor:
        """This stage's taps [L/S, B, ...] of every microbatch, gathered
        over the pipe group into [L, B, ...]; with `grad`, each
        microbatch's graph is kept."""
        s, m, b = self.stage, self.m, x.shape[0] // self.m
        taps = x.new_empty((self.local,) + tuple(x.shape))
        sends = []
        for i in range(m):
            if s == 0:
                h = x[i * b:(i + 1) * b].detach()
            else:
                h = mesh_lib.exchange([], [(x.new_empty(self._mb_shape()), s - 1)],
                                      self.group).wait()[0]
            with torch.enable_grad() if grad else contextlib.nullcontext():
                if grad:
                    h = h.requires_grad_(True)
                self.inputs.append(h)
                outs = []
                for j in range(self.local):
                    layer = self.first + j
                    h = self.block_apply(self.layers[layer], h, self.per_layer[layer], i)
                    outs.append(h)
            if grad:
                self.outputs.append(outs)
            taps[:, i * b:(i + 1) * b] = torch.stack([o.detach() for o in outs])
            if s < self.stages - 1:
                sends.append(mesh_lib.exchange([(h.detach(), s + 1)], [], self.group))
        for w in sends:
            w.wait()
        return mesh_lib.all_gather(taps, self.group)

    def backward(self, dtaps: torch.Tensor) -> torch.Tensor:
        """The gradient of x from the taps' (the same on every rank); the
        stage's parameters get theirs accumulated."""
        s, m = self.stage, self.m
        mine = dtaps[self.first:self.first + self.local]
        b = mine.shape[1] // m
        dx = torch.zeros(self.x_shape, dtype=dtaps.dtype, device=dtaps.device)
        sends = []
        for i in reversed(range(m)):
            outs = self.outputs[i]
            grads = [mine[j, i * b:(i + 1) * b].to(outs[j].dtype) for j in range(self.local)]
            if s < self.stages - 1:
                nxt = mesh_lib.exchange([], [(torch.empty_like(grads[-1]), s + 1)],
                                        self.group).wait()[0]
                grads[-1] = grads[-1] + nxt
            torch.autograd.backward(outs, grads)
            h_in = self.inputs[i]
            g_in = h_in.grad if h_in.grad is not None else torch.zeros_like(h_in)
            if s > 0:
                sends.append(mesh_lib.exchange([(g_in, s - 1)], [], self.group))
            else:
                dx[i * b:(i + 1) * b] = g_in
        for w in sends:
            w.wait()
        self.inputs, self.outputs = [], []
        if self.stages > 1:
            src = mesh_lib.global_rank(self.group, 0)
            dx = dx.contiguous()
            dist.broadcast(dx, src=src, group=self.group)
        return dx


class _PipelineFunction(torch.autograd.Function):
    """The schedule as one node of the outer graph: taps from x (and the
    stage's parameters, handed in so that the node exists where only they
    need a gradient; their gradients are accumulated by the stage's own
    backward)."""

    @staticmethod
    def forward(ctx, stage, x, *params):
        ctx.stage = stage
        return stage.forward(x, grad=True)

    @staticmethod
    def backward(ctx, dtaps):
        dx = ctx.stage.backward(dtaps.contiguous())
        return (None, dx) + (None,) * (len(ctx.needs_input_grad) - 2)


def pipeline_blocks(
    block_apply: Callable[[Any, torch.Tensor, Any, int], torch.Tensor],
    layers: Sequence,
    x: torch.Tensor,
    per_layer: Sequence,
    mesh: Mapping[str, int],
    *,
    axis: str = PIPE_AXIS,
    microbatches: Optional[int] = None,
) -> torch.Tensor:
    """Apply a chain of L layers as a GPipe pipeline over the pipe group of
    the current layout; returns every layer's output, taps [L, B, ...], on
    every rank.

    `block_apply(layer, h, aux, microbatch)` runs ONE layer on one
    microbatch: `layer` and `aux` are `layers[l]` and `per_layer[l]`,
    `microbatch` its index (fold it into any random draw, so that masks
    differ across microbatches).  `microbatches` is M (default: the stage
    count S); B % M == 0 and L % S == 0.  Stage s runs layers
    [s L/S, (s+1) L/S) alone: the others' parameters are not read.
    """
    if not len(layers):
        raise ValueError("pipeline_blocks: empty parameter tree")
    n_layers = len(layers)
    s = mesh[axis]
    m = int(microbatches) if microbatches else s
    if n_layers % s:
        raise ValueError(f"{n_layers} layers not divisible by {s} pipeline stages")
    batch = x.shape[0]
    if batch % m:
        raise ValueError(f"batch {batch} not divisible by {m} microbatches")
    if mesh_lib.pipe_size() != s:
        raise ValueError(f"the layout's pipe axis has {mesh_lib.pipe_size()} stages, the "
                         f"pipeline {s}: call parallel/mesh.py::setup_layout with its mesh")
    stage = _Stage(block_apply, layers, per_layer, x.shape, m)
    params = [t for j in range(stage.local)
              for t in _tensors(layers[stage.first + j]) if t.requires_grad]
    if torch.is_grad_enabled() and (x.requires_grad or params):
        return _PipelineFunction.apply(stage, x, *params)
    with torch.no_grad():
        return stage.forward(x, grad=False)


# --------------------------------------------------------------------------
# Blocks held by their stage
# --------------------------------------------------------------------------


class _FromOwner(torch.autograd.Function):
    """A parameter held by one stage, broadcast to the pipe group; the
    backward averages the ranks' gradients (the same replicated work) into
    the owner's."""

    @staticmethod
    def forward(ctx, local, shape, owner):
        group = mesh_lib.pipe_group()
        ctx.owner, ctx.shape = owner, local.shape
        full = local.detach().clone() if mesh_lib.pipe_rank() == owner else local.new_empty(shape)
        dist.broadcast(full, src=mesh_lib.global_rank(group, owner), group=group)
        return full

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=mesh_lib.pipe_group())
        grad.div_(mesh_lib.pipe_size())
        if mesh_lib.pipe_rank() != ctx.owner:
            grad = grad.new_zeros(ctx.shape)
        return grad, None, None


def gathered_block_params(block: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter of a block held by its stage (`StageSharding`),
    whole on every rank of the pipe group (differentiable)."""
    shapes = block._pipe_shapes
    return {name: _FromOwner.apply(p, shapes[name], block._pipe_owner)
            for name, p in block.named_parameters()}


class StageShard:
    """How a parameter of a pipelined state is held: whole on every rank
    (`owner` None), or whole on the ranks of stage `owner` and empty on the
    others."""

    def __init__(self, owner: Optional[int] = None):
        self.owner = owner

    def local(self, full: torch.Tensor) -> torch.Tensor:
        if self.owner is None or self.owner == mesh_lib.pipe_rank():
            return full
        return full.new_empty((0,) + tuple(full.shape[1:]))

    def full(self, local: torch.Tensor, shape: torch.Size) -> torch.Tensor:
        """The whole tensor: this rank's, or its stage's broadcast over the
        pipe group (collective)."""
        if self.owner is None:
            return local
        full = local.contiguous() if mesh_lib.pipe_rank() == self.owner else local.new_empty(shape)
        group = mesh_lib.pipe_group()
        dist.broadcast(full, src=mesh_lib.global_rank(group, self.owner), group=group)
        return full


class StageSharding(ShardedState):
    """The train state of a pipelined model: each block of a non-causal
    `Transformer` whose layers divide by the stages lives on its stage
    (block i on stage i // (L/S)); everything else is replicated.  What the
    step and the optimizer read (`gradient_groups`, `norm_weight`) and the
    one-process checkpoint (`ShardedState`)."""

    def __init__(self, model: nn.Module, mesh: Mapping[str, int]):
        from denseclip_vit_multimodal_tpu_torch.models.layers import Transformer

        self.mesh = dict(mesh)
        stages = self.mesh[PIPE_AXIS]
        self.shards = {name: StageShard() for name, _ in model.named_parameters()}
        self.stacks = []  # (the stack, its blocks' parameter names)
        for name, module in model.named_modules():
            if isinstance(module, Transformer) and not module.causal \
                    and len(module.blocks) % stages == 0:
                per = len(module.blocks) // stages
                names = []
                for i, block in enumerate(module.blocks):
                    names.append({n: f"{name}.blocks.{i}.{n}" for n, _ in block.named_parameters()})
                    for full in names[-1].values():
                        self.shards[full] = StageShard(i // per)
                self.stacks.append((module, names))
        self.shapes: Dict[str, torch.Size] = {}

    def apply(self, model: nn.Module) -> None:
        """Free the blocks of the other stages on this rank."""
        params = dict(model.named_parameters())
        self.shapes = {n: p.shape for n, p in params.items()}
        with torch.no_grad():
            for name, p in params.items():
                p.data = self.shards[name].local(p.data)
        for stack, names in self.stacks:
            for block, block_names in zip(stack.blocks, names):
                block._pipe_owner = self.shards[next(iter(block_names.values()))].owner
                block._pipe_shapes = {n: self.shapes[full] for n, full in block_names.items()}
            stack._pipe_staged = True
        model._port_sharding = self

    def staged(self, name: str) -> bool:
        return self.shards[name].owner is not None

    def norm_weight(self, name: str) -> float:
        """1 / the number of ranks that hold the same values of `name`."""
        copies = self.mesh.get(DATA_AXIS, 1)
        return 1.0 / (copies if self.staged(name) else copies * self.mesh[PIPE_AXIS])

    def gradient_groups(self, named: Mapping[str, nn.Parameter]) -> Dict[str, list]:
        """The trainable parameters by the group their gradients are averaged
        over: "data" (a block held by its stage), "world" (replicated)."""
        out: Dict[str, list] = {"world": [], "data": []}
        for name, p in named.items():
            out["data" if self.staged(name) else "world"].append(p)
        return out


def shard_pipeline_stages(state, mesh: Mapping[str, int]) -> StageSharding:
    """Hold each pipelined block of a TrainState built on full, replicated
    parameters on its stage alone; returns the `StageSharding`, also kept
    on the state and its optimizer."""
    sharding = StageSharding(state.model, mesh)
    sharding.apply(state.model)
    state.optimizer.sharding = sharding
    state.sharding = sharding
    return sharding
