"""Timing helpers for the port's benchmarks and kernel tools (PyTorch port of
the JAX package's `utils/benchtime.py`).

  * `adaptive_min_time` is the JAX module's stop rule: repeat a timed run
    until its two fastest timings agree within `rel_tol` (at most
    `max_rounds` runs) and report the fastest with the spread of all of them
    around it.  A run that returns its own seconds (CUDA events) is timed by
    them; one that returns None by the host clock.
  * `device_loop_time` times `iters` back-to-back calls of `fn(*args)` on
    the card between two CUDA events, after one warm-up call, and repeats
    that loop under the same rule.  The JAX version loops on the device and
    folds every output into a carry so that XLA can neither hoist nor drop
    the work; eager PyTorch does neither, so the calls are simply queued on
    the current stream.  It needs a CUDA device: without one it raises
    rather than time the CPU.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import torch


def adaptive_min_time(
    run_once: Callable[[], Optional[float]],
    max_rounds: int = 6,
    rel_tol: float = 0.02,
) -> Tuple[float, float]:
    """Repeat `run_once` until its two fastest timings agree within
    `rel_tol`; returns (best_seconds, drift_pct), drift_pct being the spread
    of all runs around the best ((max - min) / min * 100)."""
    times: List[float] = []
    for _ in range(max_rounds):
        t0 = time.perf_counter()
        seconds = run_once()
        times.append(time.perf_counter() - t0 if seconds is None else seconds)
        if len(times) >= 2:
            best, second = sorted(times)[:2]
            if second - best < rel_tol * best:
                break
    best = min(times)
    return best, (max(times) - best) / best * 100.0


def device_loop_time(fn, args, iters: int, stats: Optional[dict] = None) -> float:
    """Seconds per call of fn(*args) on the card: `iters` calls between two
    CUDA events, repeated by `adaptive_min_time`; returns min / iters.  Pass
    a dict as `stats` to receive {'runs': n, 'drift_pct': spread}."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_loop_time needs a CUDA device")
    fn(*args)  # warm-up: builds, plans, allocator
    torch.cuda.synchronize()
    n_runs = [0]

    def run_once() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        n_runs[0] += 1
        return start.elapsed_time(end) / 1e3

    best, drift = adaptive_min_time(run_once)
    if stats is not None:
        stats["runs"] = n_runs[0]
        stats["drift_pct"] = round(drift, 2)
    return best / iters
