"""Environment report, determinism, seeding and profiling hooks (PyTorch port
of the JAX package's `utils/env.py`).

  * `collect_env_info` — Python, torch, CUDA, cuDNN, nvcc, the visible cards,
    and each card's name and power limit as `nvidia-smi` gives them where
    that command exists (a card below its maximum power limit runs slower
    under load, so every measurement carries it).  Without a card it says
    so; it never raises.
  * `set_determinism` — the counterpart of the JAX `--deterministic`
    (highest matmul precision): TF32 off, deterministic algorithms where
    PyTorch has them, a fixed cuBLAS workspace, cuDNN deterministic and not
    benchmarking.
  * `seed_everything` — seeds Python, numpy and torch and returns an explicit
    `torch.Generator` (the JAX version returns a root PRNG key folded with
    the process index; the port runs one process).
  * `profiler_trace` — a `torch.profiler` trace (TensorBoard / Perfetto) of
    the block, or nothing when no directory is given.
  * `StepTimer` — rolling per-step wall-time statistics.

The JAX `apply_tpu_options` (its persistent compilation cache) has no
counterpart: eager PyTorch compiles nothing, and the kernels' builds are
cached by `ops/_build.py`.  `GracefulShutdown` lives in `train/loop.py`.
"""

from __future__ import annotations

import contextlib
import os
import platform
import shutil
import subprocess
import sys
import time
from typing import Iterator, List, Optional, Tuple

import torch

CUBLAS_WORKSPACE = ":4096:8"  # the setting cuBLAS documents for reproducible results


def nvidia_smi_cards() -> List[Tuple[str, str]]:
    """(name, power limit) of every card, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them; [] without nvidia-smi."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    proc = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30)
    if proc.returncode != 0:
        return []
    return [tuple(part.strip() for part in line.split(",", 1))
            for line in proc.stdout.strip().splitlines() if "," in line]


def power_limit_watts(limit: str) -> Optional[float]:
    """'700.00 W' -> 700.0; None where nvidia-smi gives no number."""
    try:
        return float(limit.split()[0])
    except (ValueError, IndexError):
        return None


def _nvcc_version() -> str:
    from denseclip_vit_multimodal_tpu_torch.ops._build import _nvcc

    try:
        exe = _nvcc()
    except RuntimeError:
        return "not found"
    out = subprocess.run([exe, "--version"], capture_output=True, text=True, timeout=60).stdout
    release = [line for line in out.splitlines() if "release" in line]
    return release[-1].strip() if release else out.strip()[-80:]


def collect_env_info() -> str:
    """Human-readable environment report."""
    import numpy

    cudnn = torch.backends.cudnn.version() if torch.backends.cudnn.is_available() else None
    lines = [
        f"python              : {sys.version.split()[0]} ({platform.platform()})",
        f"torch               : {torch.__version__}",
        f"torch cuda          : {torch.version.cuda or 'none (CPU build)'}",
        f"cudnn               : {cudnn if cudnn is not None else 'not available'}",
        f"nvcc                : {_nvcc_version()}",
        f"numpy               : {numpy.__version__}",
    ]
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        lines.append(f"cuda devices        : {names}")
    else:
        lines.append("cuda devices        : none")
    for i, (name, limit) in enumerate(nvidia_smi_cards()):
        lines.append(f"nvidia-smi card {i:<4}: {name}, power limit {limit}")
    return "\n".join(lines)


def set_determinism() -> None:
    """Make runs repeat bit for bit where PyTorch can: fp32 matmuls and
    convolutions without TF32, deterministic algorithms, a fixed cuBLAS
    workspace (read when cuBLAS starts, so call this before the first
    matmul on the card), cuDNN deterministic without autotuning.  An op
    with no deterministic CUDA implementation (bilinear upsampling's
    backward, `bincount`) warns instead of raising: training takes both."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)


def seed_everything(seed: int) -> torch.Generator:
    """Seed Python, numpy and torch (every card too); return a CPU
    `torch.Generator` seeded with `seed`, to be passed explicitly."""
    import random

    import numpy as np

    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block with `torch.profiler` (CPU, and CUDA where there is a
    card) into `log_dir` for TensorBoard / Perfetto; a no-op when `log_dir`
    is falsy, so call sites can stay in place."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


class StepTimer:
    """Rolling per-step wall-time stats for throughput logging."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def steps_per_sec(self) -> float:
        return 1.0 / self.mean if self.mean else 0.0
