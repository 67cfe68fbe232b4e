"""Timing helpers for the port's benchmarks and kernel tools (PyTorch port of
the JAX package's `utils/benchtime.py`).

  * `adaptive_min_time` is the JAX module's stop rule: repeat a timed run
    until its two fastest timings agree within `rel_tol` (at most
    `max_rounds` runs) and report the fastest with the spread of all of them
    around it.  A run that returns its own seconds (CUDA events) is timed by
    them; one that returns None by the host clock.
  * `timed_run` is one timed run: `iters` back-to-back calls of `fn(*args)`
    queued on the current stream with a CUDA event before the first and
    after each, and no host sync until the last event; it returns the run's
    seconds and each call's milliseconds (the time between its events: its
    device time, plus any wait for the host to queue it).  With
    `device="cpu"` it times the calls by the host clock instead.
  * `device_loop_time` times `iters` back-to-back calls of `fn(*args)` on
    the card with `timed_run`, after one warm-up call, and repeats that run
    under the same rule; given a list as `call_ms`, it adds every timed
    call's milliseconds to it.  The JAX version loops on the device and
    folds every output into a carry so that XLA can neither hoist nor drop
    the work; eager PyTorch does neither, so the calls are simply queued on
    the current stream.  It needs a CUDA device unless it is given
    `device="cpu"`: without one it raises rather than time the CPU.
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


def timed_run(fn, args, iters: int, device="cuda") -> Tuple[float, List[float]]:
    """One run of `iters` calls of fn(*args): (seconds, [ms of each call]).
    On CUDA the calls are bracketed by events with no host sync inside the
    run; on the CPU (`device="cpu"`) each call is timed by the host clock."""
    if torch.device(device).type == "cpu":
        ms = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            ms.append((time.perf_counter() - t0) * 1e3)
        return sum(ms) / 1e3, ms
    if not torch.cuda.is_available():
        raise RuntimeError("timing on the card needs a CUDA device")
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    events[0].record()
    for event in events[1:]:
        fn(*args)
        event.record()
    events[-1].synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return events[0].elapsed_time(events[-1]) / 1e3, ms


def device_loop_time(fn, args, iters: int, stats: Optional[dict] = None,
                     call_ms: Optional[List[float]] = None, device="cuda",
                     max_rounds: int = 6) -> float:
    """Seconds per call of fn(*args): `iters` calls by `timed_run`, repeated
    by `adaptive_min_time` (at most `max_rounds` runs); returns min / iters.
    Pass a dict as `stats` to receive {'runs': n, 'drift_pct': spread}, a
    list as `call_ms` to receive every timed call's milliseconds."""
    on_cpu = torch.device(device).type == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        raise RuntimeError("device_loop_time needs a CUDA device")
    fn(*args)  # warm-up: builds, plans, allocator
    if not on_cpu:
        torch.cuda.synchronize()
    n_runs = [0]

    def run_once() -> float:
        seconds, ms = timed_run(fn, args, iters, device)
        if call_ms is not None:
            call_ms.extend(ms)
        n_runs[0] += 1
        return seconds

    best, drift = adaptive_min_time(run_once, max_rounds=max_rounds)
    if stats is not None:
        stats["runs"] = n_runs[0]
        stats["drift_pct"] = round(drift, 2)
    return best / iters
