"""Training orchestration (PyTorch port of the JAX package's `train/loop.py`:
`train` and `validate`).

process group -> config -> data -> model -> train state -> epoch loop, on
one card a process.  What carries over from the reference loop:

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

  * `model.clip_pretrained`, where the file exists, is imported into the
    towers (`train/clip_import.py`) before anything else touches the
    weights; a missing file trains from the seeded init with a warning;
  * `load=` (`tools/train.py --load`) warm-starts: the model's weights and
    BatchNorm statistics from a checkpoint of the port's format, a fresh
    optimizer and step 0; a checkpoint of another model raises.

Per-step metrics (with `step_s`, the host seconds of the step, from the batch
on the host to its losses read back, and `data_s`, the host seconds spent
waiting for that batch) go to `<work_dir>/train_log.jsonl`, and every
`log_interval` steps to the log; validation metrics to the log, and, under
`training.save_visualizations` (default true), the validation panels to
`<work_dir>/visualizations/` (`validate`).

Data parallelism (`parallel/mesh.py`): `train` first joins the process group
`torchrun` describes (`tools/dist_train.sh`; none: one process), as JAX's
`:303` bootstraps.  The `tpu.mesh` spec resolves over the group's world
size, one card a rank, with JAX's `ValueError` texts, before the data and
the model are built; what the port does not do over several devices
(`parallel/mesh.py::check_ported`) raises `NotImplementedError`.  A `model`
axis and `tpu.fsdp` shard the train state after it is built, as JAX's
`:462-485` does (`parallel/fsdp.py::shard_train_state`: tensor parallelism
over the model groups, ZeRO-3 over the data groups); the data coordinate
then takes the place of the rank below.  `tpu.pipeline` over a `pipe` axis
turns the GPipe pipeline on after the layout is made, as JAX's `:332-340`
does (`parallel/pipeline.py`), and the ViT's blocks then live on their
stages (`shard_pipeline_stages`); `attn_impl: ring` runs the ring over the
data axis (`parallel/ring_attention.py`).
`training.batch_size` is the GLOBAL batch: it must divide by the data axis
(JAX's `ValueError`), and each rank's loader reads its rank-strided share
(`data/loader.py`).  Every rank checks that `model.clip_pretrained` exists
on every rank, starts from rank 0's weights (`replicate`), and logs to
`train_p{rank}.log` (the console on rank 0); rank 0 alone writes
`train_log.jsonl`, the config dump, the panels and the checkpoints, behind
a barrier.  Validation scores each rank's shard and sums the confusion
matrix and the depth-error sums over the group before any division.  In a
one-process world the log is `train.log` and the run is the one-process
port's.  A SIGTERM on any rank stops every rank after the same step.
Orbax checkpoints are not ported.
"""

from __future__ import annotations

import json
import logging
import math
import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
from denseclip_vit_multimodal_tpu_torch.data.loader import DataLoader, build_dataset, to_device
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES, build_denseclip
from denseclip_vit_multimodal_tpu_torch.parallel import mesh as mesh_lib
from denseclip_vit_multimodal_tpu_torch.parallel.fsdp import shard_train_state
from denseclip_vit_multimodal_tpu_torch.parallel.pipeline import (
    enable_pipeline_from_config,
    shard_pipeline_stages,
)
from denseclip_vit_multimodal_tpu_torch.parallel.sharding_rules import FSDP_MIN_SIZE
from denseclip_vit_multimodal_tpu_torch.train import checkpoint as ckpt_lib
from denseclip_vit_multimodal_tpu_torch.train.clip_import import load_clip_into_model
from denseclip_vit_multimodal_tpu_torch.train.metrics import (
    accuracy_from_confusion,
    finalize_depth_errors,
    miou_from_confusion,
    sum_confusion,
    sum_depth_errors,
)
from denseclip_vit_multimodal_tpu_torch.train.state import (
    count_params,
    create_train_state,
    frozen_modules_from_cfg,
)
from denseclip_vit_multimodal_tpu_torch.train.step import (
    make_eval_step,
    make_train_step,
    microbatch_rows,
)
from denseclip_vit_multimodal_tpu_torch.utils.env import collect_env_info
from denseclip_vit_multimodal_tpu_torch.utils.visualize import (
    save_comparison_panel,
    save_multi_task_panel,
)

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
    """`train.log` and the console in a one-process world; over a group a
    file a process, `train_p{rank}.log`, and the console on rank 0 (JAX's
    `setup_logger`)."""
    logger = logging.getLogger("denseclip_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S")
    os.makedirs(work_dir, exist_ok=True)
    rank = mesh_lib.rank()
    name = f"train_p{rank}.log" if mesh_lib.is_distributed() else "train.log"
    handlers = [logging.FileHandler(os.path.join(work_dir, name))]
    if rank == 0:
        handlers.append(logging.StreamHandler())
    for handler in handlers:
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger


def _panel_sample(batch: Dict[str, torch.Tensor], results: Dict[str, torch.Tensor]
                  ) -> Dict[str, Optional[torch.Tensor]]:
    """The first sample of a batch: what the panels show (device tensors)."""
    return {"image": batch["image"][0], "seg_pred": results["seg_pred"][0],
            "seg_gt": batch["seg"][0] if "seg" in batch else None,
            "depth_pred": results["depth_pred"][0] if "depth_pred" in results else None,
            "depth_gt": batch["depth"][0] if "depth" in batch else None}


def _fetch(sample: Dict[str, Optional[torch.Tensor]]) -> Dict[str, Optional[np.ndarray]]:
    return {k: None if v is None else v.cpu().numpy() for k, v in sample.items()}


def validate(state, eval_step, val_loader: DataLoader, logger: logging.Logger,
             visualize_to: Optional[str] = None, epoch: Optional[int] = None
             ) -> Dict[str, float]:
    """Run the eval epoch; returns scalar metrics (miou, pixel_acc, depth_*,
    val_loss_*).  Every sum stays on the device until the end of the epoch.

    `visualize_to` saves the first sample's panel there on the first batch,
    and after the loop `best_<name>` (the sample 0 of the batch with the
    highest seg accuracy) and, where there is seg ground truth,
    `comparison_<name>` (`utils/visualize.py`).  The best batch is tracked
    on the device (`torch.where` over the sample's tensors) and fetched
    once.  A failed panel is logged as a warning, as in the JAX package.
    Over a process group `val_loader` reads this rank's shard; the
    confusion matrix and the depth-error sums are summed over the ranks
    before any division, and the per-batch losses are global already."""
    device = next(state.model.parameters()).device
    cm_total = depth_sums = depth_count = None
    loss_sums: Dict[str, torch.Tensor] = {}
    n_batches = 0
    best_acc = best_sample = None
    for batch in val_loader.epoch(0):
        batch = to_device(batch, device)
        results = eval_step(state, batch)
        if visualize_to and n_batches == 0:
            try:
                first = _fetch(_panel_sample(batch, results))
                save_multi_task_panel(visualize_to, first["image"].astype(np.uint8),
                                      first["seg_pred"], seg_gt=first["seg_gt"],
                                      depth_pred=first["depth_pred"], depth_gt=first["depth_gt"])
            except Exception as e:  # a panel never stops the evaluation
                logger.warning("visualization failed: %s", e)
        if "confusion" in results:
            cm = results["confusion"]
            cm_total = cm if cm_total is None else cm_total + cm
            if visualize_to:
                acc, sample = accuracy_from_confusion(cm), _panel_sample(batch, results)
                if best_sample is None:
                    best_acc, best_sample = acc, sample
                else:
                    take = acc > best_acc
                    best_acc = torch.where(take, acc, best_acc)
                    best_sample = {k: None if v is None else torch.where(take, sample[k], v)
                                   for k, v in best_sample.items()}
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

    cm_total = sum_confusion(cm_total)  # each rank scored its own shard
    depth_sums, depth_count = sum_depth_errors(depth_sums, depth_count)
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
    if best_sample is not None:
        try:
            d, b = os.path.split(visualize_to)
            best = _fetch(best_sample)  # the one host fetch of the best batch
            image = best["image"].astype(np.uint8)
            save_multi_task_panel(os.path.join(d, f"best_{b}"), image, best["seg_pred"],
                                  seg_gt=best["seg_gt"], depth_pred=best["depth_pred"],
                                  depth_gt=best["depth_gt"],
                                  title=f"best batch accuracy {float(best_acc) * 100:.2f}%")
            if best["seg_gt"] is not None:
                save_comparison_panel(os.path.join(d, f"comparison_{b}"), image,
                                      best["seg_pred"], best["seg_gt"], epoch=epoch)
        except Exception as e:  # a panel never stops the evaluation
            logger.warning("best-image visualization failed: %s", e)
    logger.info("validation: %s", {k: round(v, 4) for k, v in metrics.items()})
    return metrics


def class_names_for(data_cfg) -> tuple:
    """The class list of the config's dataset: ADE20K's 150 or Cityscapes' 19."""
    get = data_cfg.get if hasattr(data_cfg, "get") else dict(data_cfg).get
    if "ADE20K" in str(get("dataset_type", "CityscapesDepthSegDataset")):
        from denseclip_vit_multimodal_tpu_torch.data.ade20k import ADE20K_CLASSES

        return ADE20K_CLASSES
    return CITYSCAPES_CLASSES


def train_step_from_cfg(texts, training_cfg, data_cfg, seed: int = 0):
    """`make_train_step` with the `training:` section's loss weights, SILog
    settings and gradient accumulation, and the `data:` section's augmentation."""
    lw = training_cfg.get("loss_weights", {}) or {}
    silog_cfg = training_cfg.get("silog_loss", {}) or {}
    return make_train_step(
        texts, augment_config_from_data_cfg(data_cfg),
        loss_weights={k: float(v) for k, v in dict(lw).items()},
        silog_lambd=float(silog_cfg.get("lambd", 0.5)),
        silog_eps=float(silog_cfg.get("eps", 1e-6)),
        grad_accum_steps=int(training_cfg.get("grad_accum_steps", 1)),
        seed=seed,
    )


def train(cfg, work_dir: str, resume: Optional[str] = None, max_steps: Optional[int] = None,
          no_validate: bool = False, device="cuda", load: Optional[str] = None
          ) -> Dict[str, float]:
    """Train from a config, on one card a process; returns the last epoch's
    mean training metrics, the last validation's metrics and the global
    `step`.  `resume` continues a run (weights, optimizer, step); `load`
    warm-starts from a checkpoint's weights alone.  Under `torchrun` it
    joins the group first (NCCL on CUDA, Gloo on the CPU)."""
    mesh_lib.maybe_initialize_distributed(device=device)
    device = mesh_lib.local_device(device)
    logger = setup_logger(work_dir)
    shutdown = GracefulShutdown(logger)  # before the build: a SIGTERM then still stops cleanly
    try:
        return _train(cfg, work_dir, resume, load, max_steps, no_validate, device, logger,
                      shutdown)
    finally:
        shutdown.restore()
        mesh_lib.reset_layout()
        enable_pipeline_from_config({}, {})
        for handler in list(logger.handlers):
            handler.close()
            logger.removeHandler(handler)


def _train(cfg, work_dir, resume, load, max_steps, no_validate, device, logger, shutdown
           ) -> Dict[str, float]:
    tpu_cfg = cfg.get("tpu", {}) or {}
    training_cfg = cfg.get("training", {}) or {}
    data_cfg = cfg.get("data", {}) or {}
    seed = int(training_cfg.get("seed", 42))
    class_names = class_names_for(data_cfg)
    world, rank = mesh_lib.world_size(), mesh_lib.rank()
    is_main = rank == 0
    if is_main:
        logger.info("environment:\n%s", collect_env_info())
    mesh = mesh_lib.mesh_over_group(tpu_cfg)
    logger.info("mesh %s over %d devices (%s)", mesh, math.prod(mesh.values()), device.type)
    if world == 1 and device.type == "cuda" and torch.cuda.device_count() > 1:
        logger.info("%d cards visible, one process trains on one: tools/dist_train.sh runs "
                    "a process a card", torch.cuda.device_count())
    mesh_lib.check_ported(mesh, tpu_cfg)
    mesh_lib.setup_layout(mesh)
    pipelined = enable_pipeline_from_config(tpu_cfg, mesh)
    if pipelined:
        logger.info("pipeline parallelism: %d stages over the pipe axis",
                    mesh[mesh_lib.PIPE_AXIS])
    world, rank = mesh_lib.data_size(), mesh_lib.data_rank()  # the batch goes by data coordinate
    if not mesh_lib.data_axis_is_process_local(mesh):
        raise ValueError(
            f"tpu.mesh {mesh} does not give each process a contiguous slice of the data axis "
            "— order the mesh data-first (e.g. {data: N, pipe: S}), which keeps pipeline/model "
            "hops intra-process, or feed full global batches via "
            "shard_batch(process_local=False) in a custom loop")

    train_ds = build_dataset(data_cfg, "train")
    global_batch = int(training_cfg.get("batch_size", 8))
    data_ways = mesh.get(mesh_lib.DATA_AXIS, 1)
    if global_batch % data_ways:
        raise ValueError(
            f"training.batch_size={global_batch} must be divisible by the data mesh axis "
            f"({data_ways} ways); adjust batch_size or tpu.mesh (batch_size is GLOBAL, unlike "
            "torch's per-process)")
    local_batch = mesh_lib.local_batch_size(global_batch)
    accum = int(training_cfg.get("grad_accum_steps", 1))
    microbatch_rows(local_batch, accum, world, rank)  # raises where the grouping cannot hold
    loader = DataLoader(train_ds, batch_size=local_batch, seed=seed,
                        num_threads=int(training_cfg.get("workers", 8)),
                        microbatches=accum if world > 1 else 1)
    val_loader = None
    if not no_validate:
        val_split = "validation" if "ADE20K" in str(data_cfg.get("dataset_type", "")) else "val"
        try:
            val_loader = DataLoader(build_dataset(data_cfg, val_split), batch_size=local_batch,
                                    seed=seed, num_threads=int(training_cfg.get("workers", 8)),
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
        cfg.model, class_names, dtype=_DTYPES[str(tpu_cfg.get("compute_dtype", "bfloat16"))],
        attn_impl=str(tpu_cfg.get("attn_impl", "auto")), device=device, seed=seed,
        remat=tpu_cfg.get("remat", False))
    logger.info("params: %.2fM on %s", count_params(model) / 1e6, device)
    clip_path = cfg.model.get("clip_pretrained")
    if clip_path and os.path.exists(str(clip_path)):
        n_vis, n_txt = load_clip_into_model(model, clip_path, cfg.model)
        logger.info("loaded CLIP weights from %s: %d visual / %d text tensors", clip_path,
                    n_vis, n_txt)
    elif clip_path:
        logger.warning("clip_pretrained %s not found; training from scratch", clip_path)
    if mesh_lib.is_distributed():
        # every rank builds its replica from its own disk: a file that some
        # ranks lack would leave the replicas different
        flags = mesh_lib.all_gather_object(bool(clip_path and os.path.exists(str(clip_path))))
        if any(flags) and not all(flags):
            raise RuntimeError(
                f"clip_pretrained {clip_path} exists on only {sum(flags)}/{len(flags)} processes "
                "— put the checkpoint on shared storage (or every host) so all replicas "
                "initialize identically")
    mesh_lib.replicate(model)

    state = create_train_state(model, training_cfg, steps_per_epoch)
    fsdp = bool(tpu_cfg.get("fsdp", False))
    if mesh_lib.MODEL_AXIS in mesh or fsdp:
        shard_train_state(state, mesh, fsdp=fsdp,
                          fsdp_min_size=int(tpu_cfg.get("fsdp_min_size", FSDP_MIN_SIZE)))
        if mesh_lib.MODEL_AXIS in mesh:
            logger.info("tensor-parallel params over %d-way model axis",
                        mesh[mesh_lib.MODEL_AXIS])
        if fsdp:
            logger.info("FSDP: params + optimizer state sharded over the %d-way data axis "
                        "(tpu.fsdp)", mesh.get(mesh_lib.DATA_AXIS, 1))
    elif pipelined:
        shard_pipeline_stages(state, mesh)
    logger.info("frozen modules: %s", list(frozen_modules_from_cfg(training_cfg)))
    silog_cfg = training_cfg.get("silog_loss", {}) or {}
    train_step = train_step_from_cfg(texts, training_cfg, data_cfg, seed)
    eval_step = make_eval_step(
        texts, augment_config_from_data_cfg(data_cfg, train=False),
        num_classes=len(class_names),
        depth_max=float(data_cfg.get("depth_max", 80.0)),
        silog_lambd=float(silog_cfg.get("lambd", 0.5)),  # comparable with the training loss
    )
    start_epoch, best_metric = 0, -1.0
    if resume:
        last_epoch, best_metric = ckpt_lib.restore_checkpoint(resume, state)
        start_epoch = last_epoch + 1
        logger.info("resumed from %s at epoch %d, step %d", resume, start_epoch, state.step)
    elif load:
        loaded_epoch = ckpt_lib.load_model_weights(load, state.model)
        logger.info("warm-started weights from %s (its epoch %d); optimizer fresh, step 0",
                    load, loaded_epoch)
    if is_main and hasattr(cfg, "dump"):
        cfg.dump(os.path.join(work_dir, "final_config.yaml"))

    eval_interval = int(training_cfg.get("eval_interval", 1))
    save_interval = int(training_cfg.get("save_interval", 5))
    log_interval = int(training_cfg.get("log_interval", 50))
    budget_met = lambda: bool(max_steps) and state.step >= max_steps
    epoch_means: Dict[str, float] = {}
    last_val: Dict[str, float] = {}
    reached_epoch = None
    stop_requested = lambda: (mesh_lib.sum_across(torch.tensor(
        [float(shutdown.requested)], device=device), world=True).item() > 0
        if mesh_lib.is_distributed() else shutdown.requested)
    log_path = os.path.join(work_dir, "train_log.jsonl" if is_main else os.devnull)
    with open(log_path, "a") as log_file:
        for epoch in range(start_epoch, epochs):
            if budget_met():
                break
            t_epoch = time.time()
            sums: Dict[str, float] = {}
            steps = 0
            tock = time.perf_counter()
            for host_batch in loader.epoch(epoch):
                tick = time.perf_counter()
                data_s = tick - tock  # waiting for the loader's threads
                metrics = train_step(state, to_device(host_batch, device))
                step_s = time.perf_counter() - tick  # the step reads its losses back: synced
                steps += 1
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + v
                log_file.write(json.dumps({"epoch": epoch, "step": state.step, **metrics,
                                           "step_s": step_s, "data_s": data_s}) + "\n")
                if state.step % log_interval == 0:
                    logger.info("epoch %d step %d: %s", epoch, state.step,
                                {k: round(v, 4) for k, v in metrics.items()})
                if budget_met() or stop_requested():
                    break
                tock = time.perf_counter()
            epoch_means = {k: v / max(steps, 1) for k, v in sums.items()}
            logger.info("epoch %d done in %.1fs: %s", epoch, time.time() - t_epoch,
                        {k: round(v, 4) for k, v in epoch_means.items()})
            reached_epoch = epoch
            if stop_requested():
                ckpt_lib.save_checkpoint(work_dir, state, epoch, best_metric)
                logger.info("shutdown requested: checkpoint saved at epoch %d, step %d",
                            epoch, state.step)
                break
            if val_loader is not None and (epoch + 1) % eval_interval == 0:
                vis_path = None
                if is_main and bool(training_cfg.get("save_visualizations", True)):
                    vis_path = os.path.join(work_dir, "visualizations", f"epoch_{epoch}.png")
                last_val = validate(state, eval_step, val_loader, logger,
                                    visualize_to=vis_path, epoch=epoch)
                score = last_val.get("miou", -1.0)
                if score > best_metric:
                    best_metric = score
                    ckpt_lib.save_checkpoint(work_dir, state, epoch, best_metric, is_best=True)
            if (epoch + 1) % save_interval == 0:
                ckpt_lib.save_checkpoint(work_dir, state, epoch, best_metric)
    if reached_epoch is not None and not stop_requested():
        ckpt_lib.save_checkpoint(work_dir, state, reached_epoch, best_metric)
    return {**epoch_means, **last_val, "step": float(state.step)}
