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
  * `rank` / `world_size` read the group (0 / 1 without one), and every
    reduction below is the identity in a one-process world, so a run
    without a group is the one-process port's, bit for bit;
  * `local_batch_size`, `data_axis_is_process_local` and `replicate` follow
    JAX's `parallel/mesh.py:150-262`;
  * `check_ported` refuses what this slice does not do, with
    `NotImplementedError` naming ROADMAP §1 item 1: a `model` or `pipe`
    axis (or any other axis) over more than one device, `tpu.fsdp` over a
    data axis of more than one, `attn_impl: ring` over more than one
    process.  The data axis itself trains (`train/step.py`).
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
PIPE_AXIS = "pipe"
ROADMAP_ITEM = "ROADMAP §1 item 1"
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
    more than one device: any axis but `data`, FSDP, the ring."""
    tpu_cfg = tpu_cfg or {}
    world = world_size() if world is None else world
    acting = [f"tpu.mesh axis {name!r} over {size} devices (tensor / pipeline parallelism)"
              for name, size in mesh.items() if name != DATA_AXIS and size > 1]
    data = mesh.get(DATA_AXIS, 1)
    if tpu_cfg.get("fsdp") and data > 1:
        acting.append(f"tpu.fsdp over the {data}-way data axis")
    if tpu_cfg.get("pipeline") is not None and mesh.get(PIPE_AXIS, 1) > 1:
        acting.append(f"tpu.pipeline over the {mesh[PIPE_AXIS]}-way pipe axis")
    if str(tpu_cfg.get("attn_impl", "auto")) == "ring" and world > 1:
        acting.append(f"attn_impl: ring over {world} processes")
    if acting:
        raise NotImplementedError(
            f"{', '.join(acting)}: not ported yet (parallel/, {ROADMAP_ITEM}); the port trains "
            "over the data axis only")


def data_axis_is_process_local(mesh: Mapping[str, int], axis: str = DATA_AXIS) -> bool:
    """True iff each process owns a contiguous, disjoint 1/P slice of the
    `axis`-sharded batch: one device a process, `axis` over every process."""
    nproc = world_size()
    return nproc == 1 or mesh.get(axis, 1) == nproc


def local_batch_size(global_batch: int) -> int:
    """Per-process batch size for a global batch sharded over the data axis."""
    nproc = world_size()
    if global_batch % nproc:
        raise ValueError(f"global batch {global_batch} not divisible by {nproc} processes")
    return global_batch // nproc


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
# Reductions over the group: each is the identity in a one-process world
# --------------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks, differentiable: its backward sums the ranks'
    gradients, so that each rank's gradient is that of the sum of every
    rank's copy of a loss built on it (`train/losses.py`)."""
    if not is_distributed():
        return x
    return _AllReduceSum.apply(x)


def sum_across(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of a tensor outside autograd (metric sums, counts)."""
    if not is_distributed():
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
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


def all_gather_object(obj) -> list:
    if not is_distributed():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if is_distributed():
        dist.barrier()
