"""Checkpoints of the port: `epoch_N` + `latest` + `best`, with full resume.

The port's own format (reading the JAX package's orbax checkpoints is not
ported): one `torch.save` file per save holding the model's `state_dict`
(parameters and BatchNorm statistics), the optimizer's state (moments and its
count of applied updates), the global step, the epoch and the best metric.
Files are written to a temporary name and renamed, and `latest` / `best` are
symlinks repointed atomically, so a crash never leaves a torn file.  The
newest five epoch files are kept, and any an alias points at; `best` is the
epoch with the highest validation mIoU.  `load_model_weights` restores the
model alone (evaluation: `tools/test.py`).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from denseclip_vit_multimodal_tpu_torch.train.state import TrainState


def _ckpt_dir(work_dir: str) -> str:
    return os.path.join(os.path.abspath(work_dir), "checkpoints")


def _repoint_symlink(link_path: str, target_name: str) -> None:
    tmp = link_path + ".tmp"
    if os.path.lexists(tmp):
        os.unlink(tmp)
    os.symlink(target_name, tmp)
    os.replace(tmp, link_path)


_KEEP = 5


def save_checkpoint(work_dir: str, state: TrainState, epoch: int,
                    best_metric: Optional[float] = None, is_best: bool = False) -> str:
    """Save `epoch_{N}.pt`, repoint `latest` (and `best`), prune old epoch files."""
    base = _ckpt_dir(work_dir)
    os.makedirs(base, exist_ok=True)
    name = f"epoch_{epoch}.pt"
    path = os.path.join(base, name)
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "epoch": int(epoch),
        "best_metric": -1.0 if best_metric is None else float(best_metric),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for alias in ["latest"] + (["best"] if is_best else []):
        _repoint_symlink(os.path.join(base, alias), name)
    pinned = {os.readlink(os.path.join(base, a)) for a in ("latest", "best")
              if os.path.islink(os.path.join(base, a))}
    epochs = sorted(int(f[len("epoch_"):-len(".pt")]) for f in os.listdir(base)
                    if f.startswith("epoch_") and f.endswith(".pt") and f[6:-3].isdigit())
    for old in epochs[:-_KEEP]:
        if f"epoch_{old}.pt" not in pinned:
            os.remove(os.path.join(base, f"epoch_{old}.pt"))
    return path


def _load_payload(path_or_work_dir: str, which: str, device) -> dict:
    """A checkpoint file, or a work dir's `checkpoints/{which}` (latest or best)."""
    path = os.path.abspath(path_or_work_dir)
    if os.path.isdir(path):
        path = os.path.join(_ckpt_dir(path), which)
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(path_or_work_dir: str, state: TrainState, which: str = "latest"
                       ) -> Tuple[int, float]:
    """Load a checkpoint file, or a work dir's `checkpoints/{which}` (latest
    or best), into `state` in place.  Returns (epoch, best_metric)."""
    payload = _load_payload(path_or_work_dir, which, next(state.model.parameters()).device)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return int(payload["epoch"]), float(payload["best_metric"])


def load_model_weights(path_or_work_dir: str, model: torch.nn.Module, which: str = "latest"
                       ) -> int:
    """Load only the model's weights and BatchNorm statistics from a
    checkpoint (no optimizer); returns the checkpoint's epoch."""
    payload = _load_payload(path_or_work_dir, which, next(model.parameters()).device)
    model.load_state_dict(payload["model"])
    return int(payload["epoch"])
