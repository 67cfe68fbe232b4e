"""The train step (PyTorch port of the JAX package's `train/step.py::make_train_step`).

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
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from denseclip_vit_multimodal_tpu_torch.data.augment import AugmentConfig, augment_batch
from denseclip_vit_multimodal_tpu_torch.train.losses import cross_entropy_loss, silog_loss
from denseclip_vit_multimodal_tpu_torch.train.state import TrainState


def _step_seed(seed: int, step: int, stream: int) -> int:
    return (seed * 1_000_003 + step * 2 + stream) % (2**63)


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
        aug_gen = torch.Generator().manual_seed(_step_seed(seed, state.step, 0))
        drop_gen = torch.Generator(device=device).manual_seed(_step_seed(seed, state.step, 1))
        aug = augment_batch(batch, aug_cfg, aug_gen)
        b = aug["image"].shape[0]
        if b % grad_accum_steps:
            raise ValueError(f"batch {b} is not divisible by grad_accum_steps {grad_accum_steps}")
        micro = b // grad_accum_steps
        bn_stats = [buf.clone() for buf in model.buffers()]
        opt.zero_grad()
        sums: Dict[str, torch.Tensor] = {}
        for i in range(grad_accum_steps):
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in aug.items()}
            out = model(mb["image"], texts, train=True, gt_hw=crop, gen=drop_gen)
            total, parts = losses_on(out, mb)
            (total / grad_accum_steps).backward()
            for k, v in parts.items():
                sums[k] = sums.get(k, 0.0) + v.detach() / grad_accum_steps
        names = sorted(sums)
        values = dict(zip(names, torch.stack([sums[k] for k in names]).tolist()))
        finite = math.isfinite(values["loss_total"])
        lr = opt.lr
        if finite:
            opt.step()
        else:
            with torch.no_grad():
                for buf, old in zip(model.buffers(), bn_stats):
                    buf.copy_(old)
        opt.zero_grad()
        state.step += 1
        return {**values, "skipped": 0.0 if finite else 1.0, "lr": lr}

    return step
