"""The train and eval steps (PyTorch port of the JAX package's `train/step.py`:
`make_train_step`, `make_eval_step`).

One step: on-device augmentation (data/augment.py) -> training forward (bf16
hot path) -> CE + masked SILog -> backward over the trainable parameters ->
non-finite gate -> optimizer update.  Gradient accumulation runs the
microbatches one after the other and averages their gradients and losses.

The gate follows the JAX step: a non-finite total loss applies no update,
leaves the optimizer state (and so the schedule's count of applied updates)
as it was, restores the BatchNorm running statistics the forward updated,
and still advances `state.step`.  The lr reported is the one the update
applied, schedule(count).  Taking the decision reads the loss on the host:
one synchronisation per step.

Randomness: augmentation geometry comes from a host generator and dropout /
drop-path masks from a generator on the model's device, both reseeded every
step from (seed, state.step), so a resumed run draws what an uninterrupted
one would.  They cannot reproduce the JAX package's `jax.random` streams.

Data parallelism over a process group (`parallel/mesh.py`), with JAX's
global-batch semantics: `batch` holds this rank's rows of the global batch
(the ranks' batches in rank order).  Each microbatch i is the global rows
[i m, (i+1) m) of JAX's grouping, and rank r holds its m / P of them, as the
loader hands them over (`data/loader.py`, `microbatches`); a microbatch that
does not divide by the world size raises `ValueError`.  A rank draws every
global row's augmentation and every mask at the global (micro)batch's shape
and keeps its own (`augment_batch(rows=)`, `models/layers.py::batch_rows`).
The losses and BatchNorm reduce over the global batch by autograd
all-reduces (`train/losses.py`, `models/layers.py::batch_norm_nhwc`), so
the metrics are global, every rank takes the same skip decision, and the
sum of the ranks' gradients is P times the global gradient.  The gradients
are then all-reduced by hand and divided by P, once per step after the last
microbatch, where DistributedDataParallel would hook every backward: a
parameter the forward does not read keeps no gradient on any rank (the
optimizer counts it as 0, as JAX does), which DDP's unused-parameter check
refuses, and the one reduction per step is JAX's (`psum` of the
accumulated gradients).  On a skip no rank reduces anything.  In a
one-process world nothing of this runs: the step is the one-process port's.

With a model axis (`tpu.mesh: {data: D, model: M}`) P is the data axis:
the rows, the masks, the losses, BatchNorm and the gradient mean go by the
rank's data coordinate and over its data group, and the M ranks of a model
group hold the same rows (tensor parallelism, `parallel/tensor_parallel.py`).
Under `tpu.fsdp` the gradients of the parameters sharded over `data` are
reduce-scattered as the backward reaches them (`parallel/fsdp.py`; they are
reduced on a skip too), and the all-reduce takes the rest.  What a model
group holds whole (LayerNorms, biases after a row-parallel layer, the neck,
the heads) each of its ranks computes from the same values, but not to the
same bits on CUDA (the bilinear resizes' backward adds by atomics): those
gradients are averaged over the model group too, so that the copies never
drift apart (`Sharding.gradient_groups`).  Under GPipe (`tpu.mesh: {data:
D, pipe: S}`, `parallel/pipeline.py`) the S ranks of a pipe group hold the
same rows: a block's gradient stays on its stage and is averaged over the
data group, and what every stage holds is averaged over every rank
(`StageSharding.gradient_groups`).

The eval step follows the reference's validate protocol: the input resized to
the crop, predictions resized back to the labels' size, then the confusion
matrix, the depth error sums and the validation losses, all on the device.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from denseclip_vit_multimodal_tpu_torch.data.augment import (
    AugmentConfig,
    augment_batch,
    eval_preprocess_batch,
)
from denseclip_vit_multimodal_tpu_torch.models.layers import batch_rows, resize_bilinear
from denseclip_vit_multimodal_tpu_torch.parallel import mesh as mesh_lib
from denseclip_vit_multimodal_tpu_torch.train.losses import cross_entropy_loss, silog_loss
from denseclip_vit_multimodal_tpu_torch.train.metrics import confusion_matrix, depth_errors
from denseclip_vit_multimodal_tpu_torch.train.state import TrainState


def _step_seed(seed: int, step: int, stream: int) -> int:
    return (seed * 1_000_003 + step * 2 + stream) % (2**63)


_BUCKET = 1 << 24  # elements of one gradient all-reduce (64 MiB in fp32)


_GROUPS = {"data": lambda: (mesh_lib.data_group(), mesh_lib.data_size()),
           "model": lambda: (mesh_lib.model_group(), mesh_lib.model_size()),
           "world": lambda: (None, mesh_lib.world_size())}


def average_gradients(params, over: str = "data") -> None:
    """All-reduce the parameters' gradients over the data group (`over`:
    or the model group, or every rank) and divide by its size, in flat
    buckets of one dtype; gradients that are None stay None (they are None
    on every rank).  The identity where the group is one process."""
    group, world = _GROUPS[over]()
    if world == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    buckets: list = []
    for g in grads:
        if (not buckets or buckets[-1][0].dtype != g.dtype
                or sum(t.numel() for t in buckets[-1]) + g.numel() > _BUCKET):
            buckets.append([])
        buckets[-1].append(g)
    for bucket in buckets:
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        for g, reduced in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            g.copy_(reduced)


def microbatch_rows(local: int, grad_accum_steps: int, world: int, rank: int):
    """(global rows of each local row, global batch, global microbatch, the
    rank's rows of one microbatch) for `local` rows a rank, JAX's grouping."""
    total = local * world
    if total % grad_accum_steps:
        raise ValueError(f"batch {total} is not divisible by grad_accum_steps {grad_accum_steps}")
    micro = total // grad_accum_steps
    if micro % world:
        raise ValueError(f"a microbatch of {micro} rows (batch {total} / grad_accum_steps "
                         f"{grad_accum_steps}) does not divide by the {world} processes")
    per = micro // world
    rows = [i * micro + rank * per + k for i in range(grad_accum_steps) for k in range(per)]
    return rows, total, micro, per


def make_train_step(
    texts,
    aug_cfg: AugmentConfig,
    loss_weights: Optional[Dict[str, float]] = None,
    silog_lambd: float = 0.5,
    silog_eps: float = 1e-6,
    grad_accum_steps: int = 1,
    seed: int = 0,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Dict[str, float]]:
    """Build `step(state, batch) -> metrics`.

    `batch` holds device tensors at source size: image [B,H,W,3] uint8, seg
    [B,H,W], optional depth [B,H,W].  Loss weights default to seg 1.0 and
    silog 0.1, as in the JAX package.
    """
    weights = {"seg": 1.0, "silog": 0.1, **(loss_weights or {})}
    crop = tuple(aug_cfg.crop_size)

    def losses_on(out, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        parts: Dict[str, torch.Tensor] = {}
        total = torch.zeros((), dtype=torch.float32, device=batch["image"].device)
        if out.get("seg") is not None and "seg" in batch:
            parts["loss_seg"] = cross_entropy_loss(out["seg"], batch["seg"],
                                                   ignore_index=aug_cfg.ignore_index)
            total = total + weights["seg"] * parts["loss_seg"]
        if out.get("depth") is not None and "depth" in batch:
            parts["loss_silog"] = silog_loss(out["depth"], batch["depth"], batch.get("depth_mask"),
                                             lambd=silog_lambd, eps=silog_eps)
            total = total + weights["silog"] * parts["loss_silog"]
        parts["loss_total"] = total
        return total, parts

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        model, opt = state.model, state.optimizer
        device = batch["image"].device
        world, rank = mesh_lib.data_size(), mesh_lib.data_rank()
        aug_gen = torch.Generator().manual_seed(_step_seed(seed, state.step, 0))
        drop_gen = torch.Generator(device=device).manual_seed(_step_seed(seed, state.step, 1))
        rows, total, micro, per = microbatch_rows(batch["image"].shape[0], grad_accum_steps,
                                                  world, rank)
        aug = augment_batch(batch, aug_cfg, aug_gen, rows=rows, total=total)
        bn_stats = [buf.clone() for buf in model.buffers()]
        opt.zero_grad()
        sums: Dict[str, torch.Tensor] = {}
        for i in range(grad_accum_steps):
            mb = {k: v[i * per:(i + 1) * per] for k, v in aug.items()}
            rows_ctx = batch_rows(rank * per, micro) if world > 1 else contextlib.nullcontext()
            with rows_ctx:
                out = model(mb["image"], texts, train=True, gt_hw=crop, gen=drop_gen)
            total_loss, parts = losses_on(out, mb)
            (total_loss / grad_accum_steps).backward()
            for k, v in parts.items():
                sums[k] = sums.get(k, 0.0) + v.detach() / grad_accum_steps
        if state.sharding is not None:  # the data-sharded gradients, reduce-scattered
            state.sharding.finish_backward()
        names = sorted(sums)
        values = dict(zip(names, torch.stack([sums[k] for k in names]).tolist()))
        finite = math.isfinite(values["loss_total"])  # global: the same on every rank
        lr = opt.lr
        if finite:
            if state.sharding is None:  # a pipe axis without a pipeline: its ranks are copies
                average_gradients(opt.params, "world" if mesh_lib.pipe_size() > 1 else "data")
            else:
                for over, params in state.sharding.gradient_groups(opt._names).items():
                    average_gradients(params, over)
            opt.step()
        else:
            with torch.no_grad():
                for buf, old in zip(model.buffers(), bn_stats):
                    buf.copy_(old)
        opt.zero_grad()
        state.step += 1
        return {**values, "skipped": 0.0 if finite else 1.0, "lr": lr}

    return step


def make_eval_step(
    texts,
    aug_cfg: AugmentConfig,
    num_classes: int,
    depth_max: float = 80.0,
    silog_lambd: float = 0.5,
) -> Callable[..., Dict[str, Any]]:
    """Build `step(state, batch) -> results` for validation.

    `batch` holds device tensors: image [B,H,W,3] uint8, seg [B,H,W], optional
    depth [B,H,W].  Results (device tensors): seg_pred, confusion, loss_seg;
    depth_pred, depth_sums, depth_count, loss_silog.  The text tower runs only
    for a model whose forward reads the score map (a context decoder, score
    concatenation), once per batch; the flagship's eval forward computes no
    score map (the JAX step hoists the tower out of its program instead).
    """

    @torch.inference_mode()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        pre = eval_preprocess_batch(batch, aug_cfg)
        gt_hw = tuple((batch["seg"] if "seg" in batch else batch["image"]).shape[1:3])
        out = state.model(pre["image"], texts)
        results: Dict[str, Any] = {}
        if out.get("seg") is not None and "seg" in batch:
            logits = out["seg"].float()
            if tuple(logits.shape[1:3]) != gt_hw:
                logits = resize_bilinear(logits, gt_hw, antialias=True)
            preds = logits.argmax(dim=-1).to(torch.int32)
            results["seg_pred"] = preds
            results["confusion"] = confusion_matrix(preds, batch["seg"], num_classes,
                                                    aug_cfg.ignore_index)
            results["loss_seg"] = cross_entropy_loss(logits, batch["seg"],
                                                     ignore_index=aug_cfg.ignore_index)
        if out.get("depth") is not None and "depth" in batch:
            depth_pred = out["depth"].float()
            if tuple(depth_pred.shape[1:3]) != gt_hw:
                depth_pred = resize_bilinear(depth_pred, gt_hw, antialias=True)
            depth_pred = depth_pred[..., 0]
            results["depth_pred"] = depth_pred
            mask = batch["depth"] > 0.0
            results["depth_sums"], results["depth_count"] = depth_errors(
                depth_pred, batch["depth"], mask, max_depth=depth_max)
            results["loss_silog"] = silog_loss(depth_pred, batch["depth"], mask, lambd=silog_lambd)
        return results

    return step
