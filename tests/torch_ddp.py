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


def _model(cfg, state_dict=None, seed: int = 0, remat=False):
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )

    model, texts = build_denseclip(cfg, CITYSCAPES_CLASSES, device="cpu", seed=seed, remat=remat)
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


def sharded_steps(rank: int, world: int, p: dict) -> dict:
    """`len(p["batches"])` train steps of the port with the state sharded
    over `p["mesh"]` (tensor parallelism over a model axis, ZeRO-3 over the
    data axis under `p["fsdp"]`), each on this rank's rows by its data
    coordinate: every step's metrics, the full state after them (put back
    together from the ranks' parts), the elements this rank holds and the
    elements JAX's specs put on a device.  A checkpoint is saved to
    `p["save_to"]` where it is given; `p["remat"]` is the `tpu.remat` value.  In the parent (one process) the state
    is not sharded: the reference."""
    from denseclip_vit_multimodal_tpu_torch.data.augment import AugmentConfig
    from denseclip_vit_multimodal_tpu_torch.parallel import mesh
    from denseclip_vit_multimodal_tpu_torch.parallel.fsdp import (
        resident_elements,
        shard_train_state,
    )
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import save_checkpoint
    from denseclip_vit_multimodal_tpu_torch.train.step import make_train_step

    model, texts = _model(p["cfg"], p["state_dict"], remat=p.get("remat", False))
    state = _state(model, p)
    sharding = None
    if world > 1:
        mesh.setup_layout(p["mesh"])
        sharding = shard_train_state(state, p["mesh"], fsdp=p["fsdp"],
                                     fsdp_min_size=p.get("min_size", 2 ** 15))
    try:
        step = make_train_step(texts, AugmentConfig(**p["aug"]), grad_accum_steps=p["accum"],
                               seed=p.get("seed", 0))
        metrics = [step(state, _local_rows(b, mesh.data_rank(), mesh.data_size(), p["accum"]))
                   for b in p["batches"]]
        full = (sharding.full_state_dict(model) if sharding is not None
                else {k: v.clone() for k, v in model.state_dict().items()})
        out = {"metrics": metrics, "state": full, "count": state.optimizer.count,
               "resident": resident_elements(model, state.optimizer),
               "coords": (mesh.data_rank(), mesh.model_rank())}
        if sharding is not None:
            frozen = {n for n, q in model.named_parameters() if not q.requires_grad}
            out["jax_elements"] = sharding.jax_elements(frozen)
            out["heads"] = {n: m.num_heads for n, m in model.named_modules()
                            if hasattr(m, "tp_group") and hasattr(m, "num_heads")}
        if p.get("save_to"):
            save_checkpoint(p["save_to"], state, 0)
        return out
    finally:
        mesh.reset_layout()


def restore_sharded(rank: int, world: int, p: dict) -> dict:
    """`restore_checkpoint` of `p["path"]` into a fresh state sharded over
    `p["mesh"]` (one process: not sharded), then the full model and
    optimizer state put back together, and this rank's own tensors."""
    from denseclip_vit_multimodal_tpu_torch.parallel import mesh
    from denseclip_vit_multimodal_tpu_torch.parallel.fsdp import shard_train_state
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import restore_checkpoint

    model, _ = _model(p["cfg"], p["state_dict"])
    state = _state(model, p)
    sharding = None
    if world > 1:
        mesh.setup_layout(p["mesh"])
        sharding = shard_train_state(state, p["mesh"], fsdp=p["fsdp"],
                                     fsdp_min_size=p.get("min_size", 2 ** 15))
    try:
        epoch, _ = restore_checkpoint(p["path"], state)
        local = {k: v.clone() for k, v in model.state_dict().items()}
        if sharding is None:
            return {"model": local, "optimizer": state.optimizer.state_dict(), "epoch": epoch,
                    "step": state.step}
        return {"model": sharding.full_state_dict(model),
                "optimizer": sharding.full_optimizer_state(model, state.optimizer),
                "local": local, "epoch": epoch, "step": state.step}
    finally:
        mesh.reset_layout()


def ring_cases(rank: int, world: int, p: dict) -> list:
    """`ring_attention` over the world on each case's q, k, v (the same on
    every rank): the output and the gradients of sum(out ** 2)."""
    from denseclip_vit_multimodal_tpu_torch.parallel.ring_attention import ring_attention

    out = []
    for case in p["cases"]:
        q, k, v = (torch.from_numpy(case[x]).requires_grad_(True) for x in "qkv")
        o = ring_attention(q, k, v, valid_len=case["valid_len"])
        (o ** 2).sum().backward()
        out.append({"out": o.detach(), "grads": [x.grad for x in (q, k, v)]})
    return out


def ring_model_rows(rank: int, world: int, p: dict) -> dict:
    """The ViT of `p["cfg"]` built with `attn_impl: ring` on this rank's row
    of `p["images"]` (eval mode, with autograd): its seg and depth outputs and
    the backbone's gradients of a loss on them."""
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )

    model, texts = build_denseclip(p["cfg"], CITYSCAPES_CLASSES, device="cpu", attn_impl="ring")
    model.load_state_dict(p["state_dict"])
    model.eval()
    rows = p["rows"][rank] if world > 1 else p["rows"][p.get("as_rank", 0)]
    out = model(torch.from_numpy(p["images"][rows]), texts)
    (out["seg"].float().square().mean() + out["depth"].float().mean()).backward()
    return {"seg": out["seg"].detach(), "depth": out["depth"].detach(),
            "grads": {n: q.grad.clone() for n, q in model.named_parameters()
                      if n.startswith("backbone.") and q.grad is not None}}


def ring_rows_mismatch(rank: int, world: int, p: dict) -> list:
    """A stack built with `ring` on [B, N] that differ between the ranks
    (`p["shapes"]`: a list of per-rank shapes a case): each rank's error
    text, or None where the forward ran."""
    from denseclip_vit_multimodal_tpu_torch.models.layers import Transformer

    stack = Transformer(32, 2, 4, attn_impl="ring", gen=torch.Generator().manual_seed(0))
    out = []
    for shapes in p["shapes"]:
        b, n = shapes[rank]
        try:
            stack(torch.ones(b, n, 32))
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def toy_layers(p: dict):
    """`tests/test_pipeline.py`'s toy as the port's pipeline takes it: the
    stacked leaves (requiring grad), the L layers as views of them, x."""
    w, b = (torch.from_numpy(p[k]).requires_grad_(True) for k in ("w", "b"))
    return w, b, [(w[i], b[i]) for i in range(w.shape[0])]


def toy_block(layer, h, aux, microbatch=0):
    w, b = layer
    return torch.tanh(h @ w + b + aux)


def pipeline_toy(rank: int, world: int, p: dict) -> dict:
    """`pipeline_blocks` on the toy over `{pipe: world}` for each M of
    `p["microbatches"]`: the taps and the gradients of (taps[-1] ** 2).sum()
    + taps.sum() of w, b (this stage's layers) and x (every rank)."""
    from denseclip_vit_multimodal_tpu_torch.parallel import mesh
    from denseclip_vit_multimodal_tpu_torch.parallel.pipeline import pipeline_blocks

    spec = {"pipe": world}
    mesh.setup_layout(spec)
    try:
        out = {}
        for m in p["microbatches"]:
            w, b, layers = toy_layers(p)
            x = torch.from_numpy(p["x"]).requires_grad_(True)
            taps = pipeline_blocks(toy_block, layers, x, torch.from_numpy(p["rates"]), spec,
                                   microbatches=m)
            ((taps[-1] ** 2).sum() + taps.sum()).backward()
            out[m] = {"taps": taps.detach(), "w": w.grad, "b": b.grad, "x": x.grad,
                      "stage": mesh.pipe_rank()}
        return out
    finally:
        mesh.reset_layout()


def pipelined_steps(rank: int, world: int, p: dict) -> dict:
    """`len(p["batches"])` train steps of the port under GPipe over
    `p["mesh"]` (`tpu.pipeline: {microbatches: p["microbatches"]}`), each on
    this rank's rows by its data coordinate: every step's metrics, the full
    state after them (each block from its stage), the parameter and moment
    elements this rank holds.  In the parent (one process): no pipeline,
    the reference."""
    from denseclip_vit_multimodal_tpu_torch.data.augment import AugmentConfig
    from denseclip_vit_multimodal_tpu_torch.parallel import mesh
    from denseclip_vit_multimodal_tpu_torch.parallel.fsdp import resident_elements
    from denseclip_vit_multimodal_tpu_torch.parallel.pipeline import (
        enable_pipeline_from_config,
        shard_pipeline_stages,
    )
    from denseclip_vit_multimodal_tpu_torch.train.step import make_train_step

    model, texts = _model(p["cfg"], p["state_dict"], remat=p.get("remat", False))
    state = _state(model, p)
    sharding = None
    if world > 1:
        mesh.setup_layout(p["mesh"])
        enable_pipeline_from_config({"pipeline": {"microbatches": p["microbatches"]}}, p["mesh"])
        sharding = shard_pipeline_stages(state, p["mesh"])
    from denseclip_vit_multimodal_tpu_torch.models.layers import _PIPELINE_FALLBACK_WARNED

    warned = len(_PIPELINE_FALLBACK_WARNED)
    try:
        step = make_train_step(texts, AugmentConfig(**p["aug"]), seed=p.get("seed", 0))
        metrics = [step(state, _local_rows(b, mesh.data_rank(), mesh.data_size(), 1))
                   for b in p["batches"]]
        full = (sharding.full_state_dict(model) if sharding is not None
                else {k: v.clone() for k, v in model.state_dict().items()})
        out = {"metrics": metrics, "state": full,
               "resident": resident_elements(model, state.optimizer),
               "fallbacks": len(_PIPELINE_FALLBACK_WARNED) - warned}
        if p.get("odd_rows") is not None:  # 3 rows % 2 microbatches: the replicated stack
            seg = model.eval()(torch.from_numpy(p["odd_rows"]), texts)["seg"]
            seg.float().square().mean().backward()
            grads = {}
            for n, q in model.named_parameters():
                if n.startswith("backbone.transformer."):
                    g = q.grad if q.grad is not None else q.new_zeros(q.shape)
                    grads[n] = g if sharding is None else sharding.shards[n].full(
                        g, sharding.shapes[n])
            out["odd"] = {"seg": seg.detach(), "grads": grads}
        return out
    finally:
        enable_pipeline_from_config({}, {})
        mesh.reset_layout()
