"""Learning-rate schedules (PyTorch port of the JAX package's `train/schedules.py`).

A schedule maps the optimizer's count of applied updates to a learning rate
(a Python float; the optimizer sets it on its groups before each update).

  * `cosine_per_epoch` — CosineAnnealingLR stepped once per epoch (the step
    count is floored to epoch boundaries);
  * `poly_with_warmup` — the mmseg-heritage schedule: poly power 0.9 after a
    linear warmup from `warmup_ratio * base_lr`;
  * `constant`.

The arithmetic is float32, as in the JAX versions: near the end of the poly
decay, 1 - step / total cancels, and float64 would give another lr (4.6e-6
relative at step 79999 of 80000).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]


def cosine_per_epoch(base_lr: float, steps_per_epoch: int, t_max_epochs: int,
                     eta_min: float = 0.0) -> Schedule:
    def schedule(step: int) -> float:
        epoch = min(int(step) // steps_per_epoch, t_max_epochs)
        frac = np.float32(epoch) / np.float32(max(t_max_epochs, 1))
        return float(np.float32(eta_min) + np.float32(0.5 * (base_lr - eta_min))
                     * (np.float32(1.0) + np.cos(np.float32(np.pi) * frac)))

    return schedule


def poly_with_warmup(base_lr: float, total_steps: int, power: float = 0.9,
                     warmup_steps: int = 1500, warmup_ratio: float = 1e-6,
                     min_lr: float = 0.0) -> Schedule:
    f32 = np.float32

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = np.clip(f32(step) / f32(max(warmup_steps, 1)), f32(0.0), f32(1.0))
            return float(f32(base_lr) * (f32(warmup_ratio) + f32(1.0 - warmup_ratio) * frac))
        decay = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0.0), f32(1.0))
        return float(f32(base_lr - min_lr) * (f32(1.0) - decay) ** f32(power) + f32(min_lr))

    return schedule


def constant(base_lr: float) -> Schedule:
    return lambda step: float(base_lr)


def build_schedule(training_cfg, steps_per_epoch: int) -> Schedule:
    """Schedule from the `training:` config section (the JAX package's schema)."""
    get = training_cfg.get
    base_lr = float((get("optimizer", {}) or {}).get("lr", 2e-5))
    sched = get("scheduler", {}) or {}
    stype = sched.get("type", "CosineAnnealingLR")
    if stype in ("CosineAnnealingLR", "cosine"):
        return cosine_per_epoch(
            base_lr, steps_per_epoch=steps_per_epoch,
            t_max_epochs=int(sched.get("T_max", get("epochs", 100))),
            eta_min=float(sched.get("eta_min", 0.0)),
        )
    if stype in ("PolyWarmup", "PolyLR", "poly"):
        iters = get("iters")
        total_steps = int(iters) if iters else steps_per_epoch * int(get("epochs", 100))
        return poly_with_warmup(
            base_lr,
            total_steps=int(sched.get("total_steps", total_steps)),
            power=float(sched.get("power", 0.9)),
            warmup_steps=int(sched.get("warmup_steps", sched.get("warmup_iters", 1500))),
            warmup_ratio=float(sched.get("warmup_ratio", 1e-6)),
            min_lr=float(sched.get("min_lr", 0.0)),
        )
    if stype in ("constant", "none", None):
        return constant(base_lr)
    raise ValueError(f"Unsupported scheduler type: {stype}")
