"""Spawned Gloo ranks for the port's data-parallel tests (not collected).

`start(payload)` starts `world` processes by `spawn`, each joining one Gloo
group at a free localhost port through the launcher's own bootstrap: the
environment `torchrun` sets (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`, `MASTER_PORT`), then
`parallel/mesh.py::maybe_initialize_distributed` with a rendezvous timeout;
for each key of `payload`, in order, a rank runs
`task(rank, world, payload[key])`, the task this module names in
`payload[key]["task"]`, and saves what it returns under the key.  The
parent waits at most `timeout` seconds: a hung rank is killed and fails the
test, and a rank that raised fails it with its traceback.  `start` / `Ranks.join` let the parent compute its references
(the JAX package's step, the port's one process) while the ranks run.

Every task is also callable in the parent with (0, 1, payload): outside a
group the port runs its one-process path, which is the reference the tasks
are held to.  This module imports nothing of JAX.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import socket
import tempfile
import time
import traceback

import numpy as np
import torch

N_THREADS = 2


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, tasks, payload_file: str, out_dir: str,
           timeout_s: float) -> None:
    torch.set_num_threads(N_THREADS)
    from denseclip_vit_multimodal_tpu_torch.parallel import mesh

    out = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        assert mesh.maybe_initialize_distributed(device="cpu", timeout_s=timeout_s)
        payload = torch.load(payload_file, weights_only=False)
        module = importlib.import_module(__name__)
        results = {key: getattr(module, payload[key]["task"])(rank, world, payload[key])
                   for key in tasks}
        torch.save(results, out)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    def __init__(self, procs, out_dir: str, deadline: float):
        self.procs, self.out_dir, self.deadline = procs, out_dir, deadline

    def join(self):
        """Every rank's results (a dict of task -> result), in rank order."""
        for p in self.procs:
            p.join(max(self.deadline - time.monotonic(), 0.1))
        hung = [i for i, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = []
        for i in range(len(self.procs)):
            err = os.path.join(self.out_dir, f"rank{i}.pt.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {i}:\n{f.read()}")
        assert not errors, "\n".join(errors)
        assert not hung, f"ranks {hung} did not finish in time"
        codes = [p.exitcode for p in self.procs]
        assert codes == [0] * len(codes), codes
        return [torch.load(os.path.join(self.out_dir, f"rank{i}.pt"), weights_only=False)
                for i in range(len(self.procs))]


def start(payload: dict, world: int = 2, timeout: float = 300.0) -> Ranks:
    """Start `world` ranks running the tasks of `payload`."""
    out_dir = tempfile.mkdtemp(prefix="torch_ddp_")
    payload_file = os.path.join(out_dir, "payload.pt")
    torch.save(payload, payload_file)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, list(payload), payload_file,
                                              out_dir, timeout), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return Ranks(procs, out_dir, time.monotonic() + timeout)


# --------------------------------------------------------------------------
# Tasks (each runs on every rank; in the parent with (0, 1, payload))
# --------------------------------------------------------------------------


def _model(cfg, state_dict=None, seed: int = 0):
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )

    model, texts = build_denseclip(cfg, CITYSCAPES_CLASSES, device="cpu", seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model, texts


def _local_rows(batch: dict, rank: int, world: int, accum: int) -> dict:
    from denseclip_vit_multimodal_tpu_torch.train.step import microbatch_rows

    local = batch["image"].shape[0] // world
    rows = microbatch_rows(local, accum, world, rank)[0]
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in batch.items()}


def _state(model, p):
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state

    return create_train_state(model, p["training"], 1, frozen_modules=tuple(p["frozen"]))


def step_grads(rank: int, world: int, p: dict) -> dict:
    """One train step of the port on this rank's rows of `p["batch"]`: the
    metrics, the gradients the optimizer applies (after the all-reduce) and
    the BatchNorm buffers after the step."""
    from denseclip_vit_multimodal_tpu_torch.data.augment import AugmentConfig
    from denseclip_vit_multimodal_tpu_torch.train.step import make_train_step

    model, texts = _model(p["cfg"], p["state_dict"])
    state = _state(model, p)
    captured = {}
    inner = state.optimizer.step

    def capture():
        captured.update({n: q.grad.clone() for n, q in model.named_parameters()
                         if q.grad is not None})
        inner()

    state.optimizer.step = capture
    step = make_train_step(texts, AugmentConfig(**p["aug"]), grad_accum_steps=p["accum"],
                           seed=p.get("seed", 0))
    metrics = step(state, _local_rows(p["batch"], rank, world, p["accum"]))
    return {"metrics": metrics, "grads": captured,
            "buffers": {n: b.clone() for n, b in model.named_buffers()}}


def train_steps(rank: int, world: int, p: dict) -> dict:
    """`p["steps"]` train steps (augmentation, dropout and drop path as the
    config says) on this rank's rows of each global batch of `p["batches"]`;
    the state after them and every step's metrics."""
    from denseclip_vit_multimodal_tpu_torch.data.augment import AugmentConfig
    from denseclip_vit_multimodal_tpu_torch.train.step import make_train_step

    model, texts = _model(p["cfg"], p["state_dict"])
    state = _state(model, p)
    step = make_train_step(texts, AugmentConfig(**p["aug"]), grad_accum_steps=p["accum"],
                           seed=p.get("seed", 0))
    metrics = [step(state, _local_rows(b, rank, world, p["accum"])) for b in p["batches"]]
    return {"metrics": metrics, "step": state.step, "count": state.optimizer.count,
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def slide_frame(rank: int, world: int, p: dict) -> dict:
    """One slide frame through `Inferencer.predict`, its windows spread over
    the group (`shard_windows`)."""
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer

    model, texts = _model(p["cfg"], p["state_dict"])
    out = Inferencer(model.eval(), texts).predict(
        p["frame"], mode="slide", crop=p["crop"], stride=p["stride"],
        window_batch=p["window_batch"], fetch="device", shard_windows=True)
    return {k: v.clone() for k, v in out.items()}


def evaluate_cli(rank: int, world: int, p: dict) -> dict:
    """`tools/test.py` `main()` on this rank's shard of the val set; the
    confusion matrix it scores (summed over the group) and its results."""
    from denseclip_vit_multimodal_tpu_torch.tools import test as test_cli
    from denseclip_vit_multimodal_tpu_torch.train import loop, metrics  # noqa: F401  bound
    # before the patch: a module imported under it would keep the spy

    seen = []
    inner = metrics.miou_from_confusion

    def capture(cm, *a, **k):
        seen.append(cm.clone())
        return inner(cm, *a, **k)

    metrics.miou_from_confusion = capture
    try:
        results = test_cli.main(p["argv"])
    finally:
        metrics.miou_from_confusion = inner
    return {"confusion": list(seen), "results": results}


def train_and_resume(rank: int, world: int, p: dict) -> dict:
    """`train/loop.py::train` over the group for `p["first"]` steps with
    validation, then resumed to `p["then"]`: every state that a checkpoint
    save saw on this rank, and the files of the work dir."""
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config
    from denseclip_vit_multimodal_tpu_torch.train import checkpoint, loop

    saved = []
    inner = checkpoint.save_checkpoint

    def spy(work_dir, state, *a, **k):
        saved.append({"model": {k2: v.clone() for k2, v in state.model.state_dict().items()},
                      "count": state.optimizer.count, "step": state.step})
        return inner(work_dir, state, *a, **k)

    loop.ckpt_lib.save_checkpoint = spy
    try:
        cfg = load_config(p["preset"], overrides=p["overrides"])
        first = loop.train(cfg, p["work_dir"], max_steps=p["first"], device="cpu")
        then = loop.train(cfg, p["work_dir"], resume=p["work_dir"], max_steps=p["then"],
                          no_validate=True, device="cpu")
    finally:
        loop.ckpt_lib.save_checkpoint = inner
    return {"saved": saved, "first": first, "then": then,
            "files": sorted(os.listdir(p["work_dir"]))}
