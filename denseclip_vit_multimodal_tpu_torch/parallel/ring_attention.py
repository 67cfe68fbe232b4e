"""Sequence-parallel ring attention over a `torch.distributed` group (the
port of the JAX package's `parallel/ring_attention.py`).

JAX shards the sequence over a mesh axis under a `shard_map` and rotates
the K/V shards round the ring with `ppermute`, keeping flash-style running
statistics, so that the result is the exact softmax attention with O(N/s)
memory a device.  Here the ring is a process group, one card a rank:

  * `ring_mesh(group)` pins the group `attn_impl: ring` rides;
    `current_ring_mesh()` is the pinned group, else the whole world, else
    None in a one-process world;
  * `ring_attention(q, k, v, group)` has JAX's global-array semantics: q, k
    and v [B, N, H, D] are the same on every rank of the group, each rank
    takes its sequence shard of N / s query rows and its K/V shard, runs the
    ring, and gets back the whole output; the gradients flow back to the
    whole inputs, the same on every rank (`split_replicated` /
    `gather_replicated`, `parallel/mesh.py`).  N must divide by the ring
    size (JAX's assertion text); pad and pass `valid_len`.

Each ring step runs the port's one-shot kernel K3 (`ops/mha_kernel.py`:
`_launch_mha` with its row statistics, the bf16 or fp32 kernel by dtype) on
the rank's query shard against the K/V shard it holds, never the [N/s, N/s]
fp32 scores of a block.  The blocks are merged by their statistics, which
are in log2 units: M = max_j m_j, L = sum_j 2^(m_j - M) l_j, O = sum_j
2^(m_j - M) l_j o_j / L, accumulated in fp32 and rounded once.  A K/V shard
that lies wholly past `valid_len` is skipped (the kernels take at least one
key).  The K/V shards travel by `isend` / `irecv` pairs (`mesh.exchange`:
through the host under Gloo on CUDA tensors), the next shard's exchange
posted before the current block runs, and the last rotation is skipped, as
JAX's scan does.

The backward launches K3's backward (`_launch_mha_bwd`, the TPU policy) on
each block with the merged statistics, the whole output O and its gradient
dO of the rank's rows: the kernel takes Dc = rowsum(dO O) from them and lets
every query row contribute, so each block's (dq, dk, dv) is its exact part.
dq accumulates on the rank in fp32; the fp32 dk / dv partials travel with
their K/V shard and come home to its owner in one last hop.  On the CPU the
kernels' plain versions (`mha_attention_reference(with_stats=True)`,
`mha_attention_bwd_reference(stats=)`) take their place; a CUDA tensor
launches the kernels or raises, with no fallback.  The softmax knobs do
not act here: JAX's ring is plain XLA.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel
from denseclip_vit_multimodal_tpu_torch.parallel import mesh as mesh_lib

_RING_STACK: list = []  # the groups pinned by `ring_mesh`, innermost last


@contextlib.contextmanager
def ring_mesh(group=None):
    """Pin the group `attn_impl: ring` shards the sequence over (None: the
    whole world)."""
    _RING_STACK.append(dist.group.WORLD if group is None else group)
    try:
        yield
    finally:
        _RING_STACK.pop()


def current_ring_mesh():
    """The group for ring dispatch: the pinned one if any, else the whole
    world; None when the world is one process."""
    if _RING_STACK:
        return _RING_STACK[-1]
    if mesh_lib.world_size() < 2:
        return None
    return dist.group.WORLD


def shard_kv_len(valid_len: Optional[int], shard: int, n: int) -> int:
    """The valid keys of K/V shard `shard` of `n` keys (0: all pad)."""
    if valid_len is None:
        return n
    return max(0, min(n, int(valid_len) - shard * n))


def block_forward(q, k, v, scale: float, kv_len: int):
    """(out, stats) of one block: K3 on CUDA, its plain version on the CPU."""
    if q.device.type == "cuda":
        b, n, heads, _ = q.shape
        stats = torch.empty(b, heads, n, 2, dtype=torch.float32, device=q.device)
        return mha_kernel._launch_mha(q, k, v, scale, kv_len, stats), stats
    mha_kernel.check_device(q, "ring attention")
    return mha_kernel.mha_attention_reference(q, k, v, sm_scale=scale, valid_len=kv_len,
                                              with_stats=True)


def block_backward(q, k, v, out, dout, stats, scale: float, kv_len: int):
    """One block's (dq, dk, dv) under the merged statistics: K3's backward
    on CUDA, its plain version on the CPU."""
    if q.device.type == "cuda":
        return mha_kernel._launch_mha_bwd(q, k, v, out, dout, stats, scale, kv_len)
    return mha_kernel.mha_attention_bwd_reference(q, k, v, out, dout, sm_scale=scale,
                                                  valid_len=kv_len, stats=stats)


def empty_merge(q: torch.Tensor):
    """The merge of no block for query rows q [B, n, H, D]: (O sum, M, L)."""
    b, n, heads, d = q.shape
    return (torch.zeros(b, n, heads, d, dtype=torch.float32, device=q.device),
            torch.full((b, heads, n), float("-inf"), dtype=torch.float32, device=q.device),
            torch.zeros(b, heads, n, dtype=torch.float32, device=q.device))


def merge_block(merged, o: torch.Tensor, stats: torch.Tensor):
    """Add one block's output o [B, n, H, D] and statistics [B, H, n, 2]
    (row max in log2 units, row sum) to the merge: M = max(M, m), L = L
    2^(M_old - M) + l 2^(m - M), O = O 2^(M_old - M) + o l 2^(m - M), in fp32."""
    acc, m_run, l_run = merged
    m_new = torch.maximum(m_run, stats[..., 0])
    keep, add = torch.exp2(m_run - m_new), torch.exp2(stats[..., 0] - m_new) * stats[..., 1]
    weight = lambda w: w.transpose(1, 2)[..., None]
    return acc * weight(keep) + o.float() * weight(add), m_new, l_run * keep + add


def merged_output(merged, dtype: torch.dtype):
    """(O / L rounded once to `dtype`, the merged statistics [B, H, n, 2])."""
    acc, m_run, l_run = merged
    return (acc / l_run.transpose(1, 2)[..., None]).to(dtype), torch.stack((m_run, l_run), dim=-1)


def _ring_forward(q, k, v, group, scale: float, valid_len: Optional[int]):
    """This rank's output rows and merged statistics (fp32 [B, H, n, 2])."""
    size, me = mesh_lib.group_size(group), _group_rank(group)
    n = q.shape[1]
    merged = empty_merge(q)
    cur = torch.stack((k, v))
    for t in range(size):
        pending = None
        if t < size - 1:  # the next shard travels while this block runs
            pending = mesh_lib.exchange([(cur, (me + 1) % size)],
                                        [(torch.empty_like(cur), (me - 1) % size)], group)
        kv_len = shard_kv_len(valid_len, (me - t) % size, n)
        if kv_len > 0:
            merged = merge_block(merged, *block_forward(q, cur[0], cur[1], scale, kv_len))
        if pending is not None:
            cur = pending.wait()[0]
    return merged_output(merged, q.dtype)


def _ring_backward(q, k, v, out, dout, stats, group, scale: float, valid_len: Optional[int]):
    """(dq, dk, dv) of this rank's query rows and its own K/V shard."""
    size, me = mesh_lib.group_size(group), _group_rank(group)
    n = q.shape[1]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32, device=q.device)
    dout = dout.to(q.dtype).contiguous()
    cur = torch.stack((k, v))
    nxt, prev = (me + 1) % size, (me - 1) % size
    for t in range(size):
        kv_len = shard_kv_len(valid_len, (me - t) % size, n)
        if kv_len > 0:
            gq, gk, gv = block_backward(q, cur[0], cur[1], out, dout, stats, scale, kv_len)
            dq += gq.float()
            dkv[0] += gk.float()
            dkv[1] += gv.float()
        if size > 1:  # the partials go on with their shard; the last hop takes them home
            sends, recvs = [(dkv, nxt)], [(torch.empty_like(dkv), prev)]
            if t < size - 1:
                sends.append((cur, nxt))
                recvs.append((torch.empty_like(cur), prev))
            got = mesh_lib.exchange(sends, recvs, group).wait()
            dkv = got[0]
            if t < size - 1:
                cur = got[1]
    return dq.to(q.dtype), dkv[0].to(q.dtype), dkv[1].to(q.dtype)


def _group_rank(group) -> int:
    return dist.get_rank(group) if mesh_lib.group_size(group) > 1 else 0


class _RingFunction(torch.autograd.Function):
    """The ring on this rank's shards: qkv [3, B, N/s, H, D] -> its output
    rows [B, N/s, H, D]; the backward returns the gradient of its query rows
    and of its own K/V shard (every rank's queries' part of it)."""

    @staticmethod
    def forward(ctx, qkv, group, scale, valid_len):
        q, k, v = qkv.unbind(0)
        out, stats = _ring_forward(q, k, v, group, scale, valid_len)
        ctx.save_for_backward(qkv, out, stats)
        ctx.attrs = (group, scale, valid_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, stats = ctx.saved_tensors
        group, scale, valid_len = ctx.attrs
        q, k, v = qkv.unbind(0)
        grads = _ring_backward(q, k, v, out, dout, stats, group, scale, valid_len)
        return torch.stack(grads), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None, *,
                   sm_scale: Optional[float] = None,
                   valid_len: Optional[int] = None) -> torch.Tensor:
    """Exact softmax attention with the sequence sharded over `group` (None:
    the world); q, k, v [B, N, H, D] are the same on every rank and so is
    the [B, N, H, D] output.  N must divide by the group's size (pad and
    pass `valid_len` otherwise, as the ViT's pad-once path already does)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    group = dist.group.WORLD if group is None and mesh_lib.world_size() > 1 else group
    size = mesh_lib.group_size(group)
    assert q.shape[1] % size == 0, (
        f"sequence {q.shape[1]} not divisible by ring axis ({size}); pad and pass valid_len")
    mha_kernel.check_bnhd(q, k, v, valid_len)
    qkv = mesh_lib.split_replicated(torch.stack((q, k, v)), 2, group)
    out = _RingFunction.apply(qkv, group, float(sm_scale), valid_len)
    return mesh_lib.gather_replicated(out, 1, group)
