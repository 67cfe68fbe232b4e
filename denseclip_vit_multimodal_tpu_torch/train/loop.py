"""Training orchestration (PyTorch port of the JAX package's `train/loop.py`:
`train` and `validate`).

config -> data -> model -> train state -> epoch loop, on one device.  What
carries over from the reference loop:

  * `training.iters` makes the run iteration-based (ceil(iters / steps per
    epoch) epochs, at most `iters` steps); `max_steps` caps it further.  Both
    count the GLOBAL step, so a resumed run stops where an uninterrupted one
    would.  The budget is checked before each step: resuming a run whose
    budget is met takes no step;
  * SIGTERM (preemption): the current step finishes, then a resumable
    checkpoint is saved before anything else and the loop exits; a second
    SIGTERM falls through to the previous handler;
  * checkpoints every `save_interval` epochs and at the end (the epoch
    reached, so `--resume` continues from it);
  * validation every `eval_interval` epochs (not after a SIGTERM): mIoU,
    pixel accuracy, the depth errors and the validation losses, reduced on
    the device and read once per epoch; a better mIoU saves `best`.

Per-step metrics (and `step_s`, the host seconds of the step, from the batch
on the host to its losses read back) go to `<work_dir>/train_log.jsonl`, and
every `log_interval` steps to the log; validation metrics to the log.  CLIP
checkpoint import, orbax checkpoints, the validation PNG panels and the
mesh / FSDP / pipeline / multi-host branches are not ported.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import time
from typing import Dict, Optional

import torch

from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
from denseclip_vit_multimodal_tpu_torch.data.loader import DataLoader, build_dataset, to_device
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES, build_denseclip
from denseclip_vit_multimodal_tpu_torch.train import checkpoint as ckpt_lib
from denseclip_vit_multimodal_tpu_torch.train.metrics import (
    accuracy_from_confusion,
    finalize_depth_errors,
    miou_from_confusion,
)
from denseclip_vit_multimodal_tpu_torch.train.state import (
    count_params,
    create_train_state,
    frozen_modules_from_cfg,
)
from denseclip_vit_multimodal_tpu_torch.train.step import make_eval_step, make_train_step

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class GracefulShutdown:
    """SIGTERM sets `requested`; the loop polls it after each step.  A second
    SIGTERM goes to the previous handler (or the default action), so a stuck
    save can still be killed.  `restore()` reinstalls the previous handler."""

    def __init__(self, logger: Optional[logging.Logger] = None):
        self.requested = False
        self._logger = logger
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handle)
            self._installed = True
        except ValueError:  # not the main thread
            self._prev, self._installed = None, False

    def _handle(self, signum, frame):
        if self.requested:
            if callable(self._prev):
                self._prev(signum, frame)
            else:
                signal.signal(signum, signal.SIG_DFL)
                self._installed = False
                os.kill(os.getpid(), signum)
            return
        self.requested = True
        if self._logger is not None:
            self._logger.warning("SIGTERM received: finishing the current step, then "
                                 "checkpointing and exiting")

    def restore(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev or signal.SIG_DFL)
            self._installed = False


def setup_logger(work_dir: str) -> logging.Logger:
    logger = logging.getLogger("denseclip_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S")
    os.makedirs(work_dir, exist_ok=True)
    for handler in (logging.FileHandler(os.path.join(work_dir, "train.log")),
                    logging.StreamHandler()):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger


def validate(state, eval_step, val_loader: DataLoader, logger: logging.Logger
             ) -> Dict[str, float]:
    """Run the eval epoch; returns scalar metrics (miou, pixel_acc, depth_*,
    val_loss_*).  Every sum stays on the device until the end of the epoch."""
    device = next(state.model.parameters()).device
    cm_total = depth_sums = depth_count = None
    loss_sums: Dict[str, torch.Tensor] = {}
    n_batches = 0
    for batch in val_loader.epoch(0):
        results = eval_step(state, to_device(batch, device))
        if "confusion" in results:
            cm = results["confusion"]
            cm_total = cm if cm_total is None else cm_total + cm
        if "depth_sums" in results:
            ds, dc = results["depth_sums"], results["depth_count"]
            if depth_sums is None:
                depth_sums, depth_count = ds, dc
            else:
                depth_sums = {k: depth_sums[k] + ds[k] for k in depth_sums}
                depth_count = depth_count + dc
        for k in ("loss_seg", "loss_silog"):
            if k in results:
                loss_sums[k] = results[k] if k not in loss_sums else loss_sums[k] + results[k]
        n_batches += 1

    metrics: Dict[str, float] = {}
    if cm_total is not None:
        miou, _ = miou_from_confusion(cm_total)
        metrics["miou"] = float(miou)
        metrics["pixel_acc"] = float(accuracy_from_confusion(cm_total))
    if depth_sums is not None:
        depth = finalize_depth_errors(depth_sums, depth_count)
        metrics.update({f"depth_{k}": float(v) for k, v in depth.items()})
    for k, v in loss_sums.items():
        metrics[f"val_{k}"] = float(v) / max(n_batches, 1)
    logger.info("validation: %s", {k: round(v, 4) for k, v in metrics.items()})
    return metrics


def train(cfg, work_dir: str, resume: Optional[str] = None, max_steps: Optional[int] = None,
          no_validate: bool = False, device="cuda") -> Dict[str, float]:
    """Train from a config on one device; returns the last epoch's mean
    training metrics, the last validation's metrics and the global `step`."""
    logger = setup_logger(work_dir)
    shutdown = GracefulShutdown(logger)  # before the build: a SIGTERM then still stops cleanly
    try:
        return _train(cfg, work_dir, resume, max_steps, no_validate, torch.device(device), logger,
                      shutdown)
    finally:
        shutdown.restore()
        for handler in list(logger.handlers):
            handler.close()
            logger.removeHandler(handler)


def _train(cfg, work_dir, resume, max_steps, no_validate, device, logger, shutdown
           ) -> Dict[str, float]:
    tpu_cfg = cfg.get("tpu", {}) or {}
    training_cfg = cfg.get("training", {}) or {}
    data_cfg = cfg.get("data", {}) or {}
    seed = int(training_cfg.get("seed", 42))
    if "ADE20K" in str(data_cfg.get("dataset_type", "")):
        raise ValueError("ADE20K training is not yet ported to the PyTorch package")

    train_ds = build_dataset(data_cfg, "train")
    loader = DataLoader(train_ds, batch_size=int(training_cfg.get("batch_size", 8)), seed=seed,
                        num_threads=int(training_cfg.get("workers", 8)))
    val_loader = None
    if not no_validate:
        try:
            val_loader = DataLoader(build_dataset(data_cfg, "val"),
                                    batch_size=int(training_cfg.get("batch_size", 8)), seed=seed,
                                    num_threads=int(training_cfg.get("workers", 8)),
                                    shuffle=False, drop_last=False)
        except Exception as e:  # as in the JAX loop: train on without validation
            logger.warning("no validation data (%s); skipping validation", e)
    steps_per_epoch = max(len(loader), 1)
    epochs = int(training_cfg.get("epochs", 100))
    iters = training_cfg.get("iters")
    if iters:
        iters = int(iters)
        epochs = max(1, -(-iters // steps_per_epoch))
        max_steps = iters if not max_steps else min(int(max_steps), iters)

    model, texts = build_denseclip(
        cfg.model, CITYSCAPES_CLASSES, dtype=_DTYPES[str(tpu_cfg.get("compute_dtype", "bfloat16"))],
        attn_impl=str(tpu_cfg.get("attn_impl", "auto")), device=device, seed=seed,
        remat=tpu_cfg.get("remat", False))
    logger.info("params: %.2fM on %s", count_params(model) / 1e6, device)
    clip_path = cfg.model.get("clip_pretrained")
    if clip_path and os.path.exists(str(clip_path)):
        raise NotImplementedError("CLIP checkpoint import is not yet ported to the PyTorch "
                                  f"package ({clip_path})")
    if clip_path:
        logger.warning("clip_pretrained %s not found; training from scratch", clip_path)

    state = create_train_state(model, training_cfg, steps_per_epoch)
    logger.info("frozen modules: %s", list(frozen_modules_from_cfg(training_cfg)))
    lw = training_cfg.get("loss_weights", {}) or {}
    silog_cfg = training_cfg.get("silog_loss", {}) or {}
    train_step = make_train_step(
        texts, augment_config_from_data_cfg(data_cfg),
        loss_weights={k: float(v) for k, v in dict(lw).items()},
        silog_lambd=float(silog_cfg.get("lambd", 0.5)),
        silog_eps=float(silog_cfg.get("eps", 1e-6)),
        grad_accum_steps=int(training_cfg.get("grad_accum_steps", 1)),
        seed=seed,
    )
    eval_step = make_eval_step(
        texts, augment_config_from_data_cfg(data_cfg, train=False),
        num_classes=len(CITYSCAPES_CLASSES),
        depth_max=float(data_cfg.get("depth_max", 80.0)),
        silog_lambd=float(silog_cfg.get("lambd", 0.5)),  # comparable with the training loss
    )
    start_epoch, best_metric = 0, -1.0
    if resume:
        last_epoch, best_metric = ckpt_lib.restore_checkpoint(resume, state)
        start_epoch = last_epoch + 1
        logger.info("resumed from %s at epoch %d, step %d", resume, start_epoch, state.step)
    if hasattr(cfg, "dump"):
        cfg.dump(os.path.join(work_dir, "final_config.yaml"))

    eval_interval = int(training_cfg.get("eval_interval", 1))
    save_interval = int(training_cfg.get("save_interval", 5))
    log_interval = int(training_cfg.get("log_interval", 50))
    budget_met = lambda: bool(max_steps) and state.step >= max_steps
    epoch_means: Dict[str, float] = {}
    last_val: Dict[str, float] = {}
    reached_epoch = None
    with open(os.path.join(work_dir, "train_log.jsonl"), "a") as log_file:
        for epoch in range(start_epoch, epochs):
            if budget_met():
                break
            t_epoch = time.time()
            sums: Dict[str, float] = {}
            steps = 0
            for host_batch in loader.epoch(epoch):
                tick = time.perf_counter()
                metrics = train_step(state, to_device(host_batch, device))
                step_s = time.perf_counter() - tick  # the step reads its losses back: synced
                steps += 1
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + v
                log_file.write(json.dumps({"epoch": epoch, "step": state.step, **metrics,
                                           "step_s": step_s}) + "\n")
                if state.step % log_interval == 0:
                    logger.info("epoch %d step %d: %s", epoch, state.step,
                                {k: round(v, 4) for k, v in metrics.items()})
                if budget_met() or shutdown.requested:
                    break
            epoch_means = {k: v / max(steps, 1) for k, v in sums.items()}
            logger.info("epoch %d done in %.1fs: %s", epoch, time.time() - t_epoch,
                        {k: round(v, 4) for k, v in epoch_means.items()})
            reached_epoch = epoch
            if shutdown.requested:
                ckpt_lib.save_checkpoint(work_dir, state, epoch, best_metric)
                logger.info("shutdown requested: checkpoint saved at epoch %d, step %d",
                            epoch, state.step)
                break
            if val_loader is not None and (epoch + 1) % eval_interval == 0:
                last_val = validate(state, eval_step, val_loader, logger)
                score = last_val.get("miou", -1.0)
                if score > best_metric:
                    best_metric = score
                    ckpt_lib.save_checkpoint(work_dir, state, epoch, best_metric, is_best=True)
            if (epoch + 1) % save_interval == 0:
                ckpt_lib.save_checkpoint(work_dir, state, epoch, best_metric)
    if reached_epoch is not None and not shutdown.requested:
        ckpt_lib.save_checkpoint(work_dir, state, reached_epoch, best_metric)
    return {**epoch_means, **last_val, "step": float(state.step)}
