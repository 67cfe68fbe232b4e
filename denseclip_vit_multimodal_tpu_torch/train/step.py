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

The eval step follows the reference's validate protocol: the input resized to
the crop, predictions resized back to the labels' size, then the confusion
matrix, the depth error sums and the validation losses, all on the device.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from denseclip_vit_multimodal_tpu_torch.data.augment import (
    AugmentConfig,
    augment_batch,
    eval_preprocess_batch,
)
from denseclip_vit_multimodal_tpu_torch.models.layers import resize_bilinear
from denseclip_vit_multimodal_tpu_torch.train.losses import cross_entropy_loss, silog_loss
from denseclip_vit_multimodal_tpu_torch.train.metrics import confusion_matrix, depth_errors
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
    depth_pred, depth_sums, depth_count, loss_silog.  The text tower does not
    run: only the score map reads it, and the eval forward computes none (the
    JAX step hoists it out of its program instead).
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
