"""The `tpu.mesh` spec over a `torch.distributed` process group (the port of
the JAX package's `parallel/mesh.py`).

JAX builds a `jax.sharding.Mesh` over every device from the spec
(``{data: -1}`` by default, or e.g. ``{data: 4, model: 2}``): at most one
axis may be -1 and takes the devices the fixed axes leave, which must divide
the device count (or, with no -1, equal it), with the same `ValueError`
texts as here.  JAX drives every local device from one process; the port
runs one process per card, as `torchrun` launches it (`tools/dist_train.sh`),
so its mesh spans the process group: one device per rank.  Without a group
the world is one process and ``{data: -1}`` resolves to ``{data: 1}``.

  * `maybe_initialize_distributed` reads `torchrun`'s environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` / `MASTER_PORT`) and joins the
    group: NCCL for CUDA, Gloo for the CPU, or the backend it is given.  It
    is a no-op without that environment;
  * a rank's mesh coordinates are the row-major index of its rank over the
    spec's axis order (JAX's reshape of the device list); `setup_layout`
    makes, on every rank and in the same order, one sub-group for each data
    group (the ranks that share every other coordinate), then for each model
    group, then for each pipe group (a stage chain).  `data_rank` /
    `data_size`, `model_rank` / `model_size` and `pipe_rank` / `pipe_size`
    read that layout; without one the data axis is the whole world;
  * `rank` / `world_size` read the group (0 / 1 without one), and every
    reduction below is the identity in a one-process world, so a run
    without a group is the one-process port's, bit for bit.  The batch
    reductions (`all_reduce_sum`, `sum_across`) run over the data group:
    the ranks of one model or pipe group hold the same rows;
  * `all_gather` / `reduce_scatter` over a sub-group are the backend's own
    collectives under NCCL and under Gloo on CPU tensors; under Gloo on
    CUDA tensors, which takes only `all_reduce` and `broadcast`, the gather
    is one broadcast of each rank's part and the scatter an all-reduce then
    a slice.  The point-to-point exchanges of the ring and the pipeline
    (`exchange`) are `batch_isend_irecv` pairs, through a host copy under
    Gloo on CUDA tensors (Gloo sends CPU tensors only).  The choice is made
    from the group's backend and the tensor's device;
  * `gather_replicated` / `split_replicated` are the pair of differentiable
    collectives the ring and the pipeline build on: one all-gathers along
    a dim and its backward keeps this rank's part of a gradient that every
    rank holds alike; the other keeps this rank's part and its backward
    all-gathers the parts;
  * `local_batch_size`, `data_axis_is_process_local` and `replicate` follow
    JAX's `parallel/mesh.py:150-262` over the data coordinate;
  * `check_ported` refuses what the port does not do yet, with
    `NotImplementedError` naming ROADMAP §1 item 2: an axis other than
    `data`, `model` and `pipe` over more than one device, a pipe axis
    together with a model axis or `tpu.fsdp`, and `attn_impl: ring` over
    more than one process together with a model or pipe axis.  The data
    axis, `tpu.fsdp`, the model axis (`train/step.py`, `parallel/fsdp.py`,
    `parallel/tensor_parallel.py`), the ring over the data axis
    (`parallel/ring_attention.py`) and GPipe over a pipe axis
    (`parallel/pipeline.py`) train.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
ROADMAP_ITEM = "ROADMAP §1 item 2"
LAUNCH_HINT = ("the port runs one process per card: launch one rank per card with "
               "tools/dist_train.sh (torchrun)")


def maybe_initialize_distributed(backend: Optional[str] = None, device="cuda",
                                 timeout_s: Optional[float] = None) -> bool:
    """Join the process group `torchrun` describes in the environment;
    returns whether a group exists.  `backend` None takes NCCL when `device`
    is CUDA and Gloo on the CPU.  Under NCCL, rank `LOCAL_RANK` takes card
    `LOCAL_RANK` (NCCL cannot put two ranks on one card); under Gloo, ranks
    go round the visible cards, so Gloo ranks may share one.  `timeout_s`
    bounds the rendezvous and every collective (PyTorch's default if None)."""
    if dist.is_available() and dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    local_rank = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    if cuda:
        cards = torch.cuda.device_count()
        if backend == "nccl" and local_rank >= cards:
            raise ValueError(f"LOCAL_RANK {local_rank} has no card of its own ({cards} visible): "
                             "NCCL takes one card a rank")
        torch.cuda.set_device(local_rank % cards)
    timeout = None if timeout_s is None else datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), timeout=timeout)
    return True


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_device(device) -> torch.device:
    """The device this rank runs on: the pinned card for a bare "cuda"."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(spec: Optional[Mapping[str, int]] = None, n_devices: int = 1) -> Dict[str, int]:
    """The axis sizes of `spec` over `n_devices` devices; a single -1 axis
    takes the devices the fixed axes leave."""
    spec = dict(spec or {DATA_AXIS: -1})
    sizes = list(spec.values())
    n_free = sizes.count(-1)
    if n_free > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {spec}")
    fixed = math.prod(s for s in sizes if s != -1)
    if n_free:
        if n_devices % fixed != 0:
            raise ValueError(f"{n_devices} devices not divisible by fixed axes {spec}")
        sizes = [n_devices // fixed if s == -1 else s for s in sizes]
    elif fixed != n_devices:
        raise ValueError(f"mesh {spec} needs {fixed} devices, have {n_devices}")
    return dict(zip(spec, sizes))


def mesh_from_config(tpu_cfg: Optional[Mapping[str, Any]], n_devices: int) -> Dict[str, int]:
    """The mesh of the `tpu:` config section (``mesh: {data: -1}``)."""
    spec = tpu_cfg.get("mesh") if tpu_cfg else None
    return make_mesh(None if spec is None else dict(spec), n_devices)


def mesh_over_group(tpu_cfg: Optional[Mapping[str, Any]]) -> Dict[str, int]:
    """`mesh_from_config` over the group's world size, with the launcher's
    hint added to JAX's `ValueError` where the spec needs more devices."""
    try:
        return mesh_from_config(tpu_cfg, world_size())
    except ValueError as e:
        raise ValueError(f"{e} ({LAUNCH_HINT})") from None


def check_ported(mesh: Mapping[str, int], tpu_cfg: Optional[Mapping[str, Any]],
                 world: Optional[int] = None) -> None:
    """Raise NotImplementedError for what the port does not do yet over
    more than one device: an axis but data, model and pipe; a pipe axis with
    a model axis or with tpu.fsdp; the ring with a model or pipe axis."""
    tpu_cfg = tpu_cfg or {}
    world = world_size() if world is None else world
    acting = [f"tpu.mesh axis {name!r} over {size} devices"
              for name, size in mesh.items()
              if name not in (DATA_AXIS, MODEL_AXIS, PIPE_AXIS) and size > 1]
    pipe, model = mesh.get(PIPE_AXIS, 1), mesh.get(MODEL_AXIS, 1)
    if pipe > 1 and model > 1:
        acting.append(f"a {pipe}-way pipe axis with a {model}-way model axis")
    if pipe > 1 and tpu_cfg.get("fsdp", False):
        acting.append(f"a {pipe}-way pipe axis with tpu.fsdp")
    if str(tpu_cfg.get("attn_impl", "auto")) == "ring" and world > 1:
        acting += [f"attn_impl: ring over {world} processes with a {size}-way {name} axis"
                   for name, size in ((MODEL_AXIS, model), (PIPE_AXIS, pipe)) if size > 1]
    if acting:
        raise NotImplementedError(
            f"{', '.join(acting)}: not ported yet ({ROADMAP_ITEM}); the port trains over the "
            "data and model axes with tpu.fsdp, the ring over the data axis, and GPipe over "
            "{data, pipe}")


# --------------------------------------------------------------------------
# The mesh over the ranks: coordinates, sub-groups
# --------------------------------------------------------------------------


def mesh_coords(mesh: Mapping[str, int], rank_: int) -> Dict[str, int]:
    """Rank `rank_`'s coordinate on each axis: the row-major index over the
    spec's axis order, as JAX reshapes its device list into the mesh."""
    coords = {}
    for name in reversed(list(mesh)):
        coords[name] = rank_ % mesh[name]
        rank_ //= mesh[name]
    return {name: coords[name] for name in mesh}


def axis_ranks(mesh: Mapping[str, int], rank_: int, axis: str) -> list:
    """The ranks that share every coordinate of `rank_` but `axis`'s, in
    the order of that axis (`rank_`'s group along `axis`)."""
    names = list(mesh)
    stride = math.prod(mesh[n] for n in names[names.index(axis) + 1:]) if axis in mesh else 1
    first = rank_ - mesh_coords(mesh, rank_).get(axis, 0) * stride
    return [first + i * stride for i in range(mesh.get(axis, 1))]


class Layout:
    """This rank's place on the mesh: its data, model and pipe coordinates
    and the sub-groups of those axes (None: the axis is the world, or the
    rank is alone on it)."""

    def __init__(self, mesh: Mapping[str, int], rank_: int, data_group=None, model_group=None,
                 pipe_group=None):
        self.mesh = dict(mesh)
        self.coords = mesh_coords(self.mesh, rank_)
        self.data_size = self.mesh.get(DATA_AXIS, 1)
        self.model_size = self.mesh.get(MODEL_AXIS, 1)
        self.pipe_size = self.mesh.get(PIPE_AXIS, 1)
        self.data_rank = self.coords.get(DATA_AXIS, 0)
        self.model_rank = self.coords.get(MODEL_AXIS, 0)
        self.pipe_rank = self.coords.get(PIPE_AXIS, 0)
        self.data_group, self.model_group = data_group, model_group
        self.pipe_group = pipe_group


_LAYOUT: Optional[Layout] = None


def setup_layout(mesh: Mapping[str, int]) -> Layout:
    """Make the layout of `mesh` over the group current: every rank creates,
    in the same order, one `dist.new_group` for each data group, then one
    for each model group, then one for each pipe group (a group of one
    rank, or the whole world, is not created).  In a one-process world the
    layout is the trivial one."""
    global _LAYOUT
    world, me = world_size(), rank()
    if math.prod(mesh.values()) != world:
        raise ValueError(f"mesh {dict(mesh)} does not span the {world} processes")
    groups = {}
    for axis in (DATA_AXIS, MODEL_AXIS, PIPE_AXIS):
        size = mesh.get(axis, 1)
        if world == 1 or size == 1:
            continue
        if size == world:
            groups[axis] = dist.group.WORLD
            continue
        seen = set()
        for r in range(world):
            ranks = tuple(axis_ranks(mesh, r, axis))
            if ranks in seen:
                continue
            seen.add(ranks)
            group = dist.new_group(list(ranks))
            if me in ranks:
                groups[axis] = group
    _LAYOUT = Layout(mesh, me, groups.get(DATA_AXIS), groups.get(MODEL_AXIS),
                     groups.get(PIPE_AXIS))
    return _LAYOUT


def reset_layout() -> None:
    """Forget the layout: the data axis is the whole world again."""
    global _LAYOUT
    _LAYOUT = None


def layout() -> Optional[Layout]:
    return _LAYOUT


def data_size() -> int:
    return _LAYOUT.data_size if _LAYOUT is not None else world_size()


def data_rank() -> int:
    return _LAYOUT.data_rank if _LAYOUT is not None else rank()


def model_size() -> int:
    return _LAYOUT.model_size if _LAYOUT is not None else 1


def model_rank() -> int:
    return _LAYOUT.model_rank if _LAYOUT is not None else 0


def pipe_size() -> int:
    return _LAYOUT.pipe_size if _LAYOUT is not None else 1


def pipe_rank() -> int:
    return _LAYOUT.pipe_rank if _LAYOUT is not None else 0


def pipe_group():
    return _LAYOUT.pipe_group if _LAYOUT is not None else None


def data_group():
    """The data axis's group (None: the default group, the whole world)."""
    return _LAYOUT.data_group if _LAYOUT is not None else None


def model_group():
    return _LAYOUT.model_group if _LAYOUT is not None else None


def data_axis_is_process_local(mesh: Mapping[str, int], axis: str = DATA_AXIS) -> bool:
    """True iff each process owns one device of the mesh, so that the ranks
    of data coordinate i read the contiguous, disjoint i-th 1/D slice of the
    `axis`-sharded batch (the ranks of one model group read the same rows)."""
    nproc = world_size()
    return nproc == 1 or math.prod(mesh.values()) == nproc


def local_batch_size(global_batch: int) -> int:
    """Per-process batch size for a global batch sharded over the data axis."""
    ways = data_size()
    if global_batch % ways:
        raise ValueError(f"global batch {global_batch} not divisible by {ways} processes")
    return global_batch // ways


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, then check
    that every rank holds them (one checksum all-reduced by max and min).
    The identity in a one-process world."""
    if not is_distributed():
        return module
    tensors = list(module.parameters()) + list(module.buffers())
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
        sums = torch.stack([t.detach().double().sum() for t in tensors])
        lo, hi = sums.clone(), sums.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    if not torch.equal(lo, hi):
        raise RuntimeError("replicate: the ranks' parameters differ after the broadcast")
    return module


# --------------------------------------------------------------------------
# Reductions over the data group (the batch): each is the identity where the
# data axis is one process
# --------------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the data group, differentiable: its backward sums the
    ranks' gradients, so that each rank's gradient is that of the sum of
    every rank's copy of a loss built on it (`train/losses.py`)."""
    if data_size() == 1:
        return x
    return _AllReduceSum.apply(x, data_group())


def sum_across(x: torch.Tensor, world: bool = False) -> torch.Tensor:
    """The sum over the data group (with `world`, over every rank) of a
    tensor outside autograd (metric sums, counts, votes)."""
    if (world_size() if world else data_size()) == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=None if world else data_group())
    return x


def gather_rows(x: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
    """Concatenate every rank's rows in rank order; rank r holds counts[r]
    rows of the same trailing shape.  Built on one all-reduce of a zeroed
    buffer (x + 0 is x), which every backend takes for CUDA tensors."""
    if not is_distributed():
        return x
    offsets = [0]
    for c in counts:
        offsets.append(offsets[-1] + int(c))
    full = x.new_zeros((offsets[-1],) + tuple(x.shape[1:]))
    r = rank()
    full[offsets[r]:offsets[r + 1]] = x
    dist.all_reduce(full)
    return full


# --------------------------------------------------------------------------
# Collectives over a sub-group (FSDP, tensor parallelism)
# --------------------------------------------------------------------------


def group_size(group) -> int:
    return dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 1


def _native(x: torch.Tensor, group) -> bool:
    """Whether the group's backend runs all-gather / reduce-scatter on `x`:
    NCCL, or Gloo on a CPU tensor (Gloo on CUDA tensors takes only
    all_reduce and broadcast)."""
    return dist.get_backend(group) != "gloo" or x.device.type == "cpu"


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ranks' `x` concatenated along dim 0 in group-rank order."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    if _native(x, group):
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    rows = x.shape[0]
    for i in range(n):  # each rank's part by one broadcast: exact, and half an all-reduce's bytes
        part = out[i * rows:(i + 1) * rows]
        if i == dist.get_rank(group):
            part.copy_(x)
        dist.broadcast(part, src=dist.get_global_rank(group or dist.group.WORLD, i), group=group)
    return out


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of `x`, of which this rank keeps its 1/n along dim 0."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    rows = x.shape[0] // n
    if _native(x, group):
        out = x.new_empty((rows,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=group)
        return out
    x = x.clone()
    dist.all_reduce(x, group=group)
    me = dist.get_rank(group)
    return x[me * rows:(me + 1) * rows].clone()


def all_gather_object(obj) -> list:
    if not is_distributed():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def global_rank(group, group_rank: int) -> int:
    """The global rank of `group`'s rank `group_rank` (None: the world)."""
    if group is None:
        return group_rank
    return dist.get_global_rank(group, group_rank)


class Exchange:
    """Point-to-point sends and receives posted together (`exchange`);
    `wait()` returns the received tensors, on their requested device."""

    def __init__(self, works, received, targets):
        self.works, self.received, self.targets = works, received, targets

    def wait(self) -> list:
        for w in self.works:
            w.wait()
        return [r if r.device == t.device else t.copy_(r)
                for r, t in zip(self.received, self.targets)]


def exchange(sends: Sequence, recvs: Sequence, group=None) -> Exchange:
    """Post `sends` ((tensor, group rank) each) and `recvs` ((tensor to fill,
    group rank) each) as one `batch_isend_irecv`; the i-th send of a rank
    meets the i-th receive of its peer (tag i).  Under Gloo a CUDA tensor
    travels through a host copy (Gloo sends CPU tensors only); NCCL sends it
    as it is."""
    ops, received, targets = [], [], []
    host = lambda t: not _native(t, group)
    for tag, (t, peer) in enumerate(sends):
        t = t.contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if host(t) else t,
                              global_rank(group, peer), group, tag))
    for tag, (t, peer) in enumerate(recvs):
        buf = torch.empty(t.shape, dtype=t.dtype) if host(t) else t
        ops.append(dist.P2POp(dist.irecv, buf, global_rank(group, peer), group, tag))
        received.append(buf)
        targets.append(t)
    return Exchange(dist.batch_isend_irecv(ops) if ops else [], received, targets)


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return all_gather(x.movedim(dim, 0).contiguous(), group).movedim(0, dim)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _own_part(grad, ctx.dim, ctx.group), None, None


class _SplitReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_part(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad, ctx.dim, ctx.group), None, None


def _own_part(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    part = x.shape[dim] // n
    me = dist.get_rank(group) if n > 1 else 0
    return x.narrow(dim, me * part, part).contiguous()


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ranks' `x` concatenated along `dim` in group-rank order.
    Its backward takes a gradient that every rank of the group holds alike
    (a replicated consumer) and keeps this rank's part: no sum, which would
    count it once a rank."""
    if group_size(group) == 1:
        return x
    return _GatherReplicated.apply(x, dim, group)


def split_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's 1/n of `x` along `dim`, where every rank of the group
    holds the same `x`; its backward all-gathers the ranks' gradients of
    their parts into the gradient of the whole, the same on every rank."""
    if group_size(group) == 1:
        return x
    return _SplitReplicated.apply(x, dim, group)
