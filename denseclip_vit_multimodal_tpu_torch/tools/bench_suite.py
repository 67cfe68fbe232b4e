"""Benchmark suite of the port: the JAX package's nine workloads, one JSON line
each (the JAX package's `tools/bench_suite.py`, on one card).

    python3 -m denseclip_vit_multimodal_tpu_torch.tools.bench_suite [--workloads 1 2 4]
    python3 -m denseclip_vit_multimodal_tpu_torch.tools.bench_suite --attn-impl int8  # _int8
    DENSECLIP_FUSED_LNQKV=1 python3 -m denseclip_vit_multimodal_tpu_torch.tools.bench_suite \
        --tag _fused

Workloads, under the JAX package's metric names (`{arch}` is `vit_b16` for
the flagship, `{task}` `multitask` with a depth head):
  1. {arch}_512x512_seg_forward          — one 512×512 forward
  2. slide_1024x2048_{task} (+ _mfu)     — full-frame slide inference, batch 1,
                                           and its share of the card's bf16 peak
  7. slide_1024x2048_{task}_batch4       — the same over 4 frames (40 windows)
  3. whole_1024x2048_{task}_batch4       — whole-frame forward, batch 4
  4. train_step_frozen_text_batch16      — a training step, batch 16
  6. train_step_unfrozen_backbone_batch8 — the heritage recipe (backbone lr ×0.1,
                                           its backward live: K2), batch 8
  8. loader_host_pipeline_batch16, loader_host_machinery_batch16,
     train_loader_included_batch16       — the threaded synthetic loader alone,
                                           with generation cached, and feeding
                                           workload 4 through the pinned upload
  9. eval_path_device_1024x2048_slide    — workload 2 + argmax + confusion
                                           matrix + depth error sums
  5. aug_test_slide_3scale_flip_1024x2048 — multi-scale (0.5, 0.75, 1.0) + flip
                                           slide `Inferencer.aug_test`

Timing: the device workloads by `utils/benchtime.py::device_loop_time`
(`--iters` calls between CUDA events, repeated until the two fastest runs
agree within 2%, at most `--rounds`), with the calls' median and 90th
percentile; the training and loader workloads by the host clock around
steps that read their losses back (`adaptive_min_time`, at most 4 rounds).
Every line names the device and, on the card, the peak memory of its
workload.  Batch sizes are JAX's and are not cut: a batch that does not fit
raises.  The MFU line uses `utils/flops.py::program_flops` of one frame; a
failed count fails the run (the JAX suite skips the line instead).

The results go to `--out` (default `bench_suite_results_torch{tag}.json`),
merged by metric with what the file holds; the JAX package's
`bench_suite_results*.json` files are refused.  `--attn-impl int8` tags its
metrics `_int8` unless `--tag` is given; `--tag` names a run with
`DENSECLIP_FUSED_LNQKV=1` set.  `--image H W` and `--set` shrink a run for
the CPU (`--device cpu`), where the MFU line is left out (no peak); the
metric names stay JAX's.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from typing import Callable, Dict, List

import numpy as np

# the order of the results file; {arch} and {task} as in the module docstring
ORDER = (
    "{arch}_512x512_seg_forward", "slide_1024x2048_{task}",
    "slide_1024x2048_{task}_mfu", "slide_1024x2048_{task}_batch4",
    "whole_1024x2048_{task}_batch4", "train_step_frozen_text_batch16",
    "train_step_unfrozen_backbone_batch8", "loader_host_pipeline_batch16",
    "loader_host_machinery_batch16", "train_loader_included_batch16",
    "eval_path_device_1024x2048_slide", "aug_test_slide_3scale_flip_1024x2048",
)
JAX_RESULTS_PREFIX = "bench_suite_results"
PORT_RESULTS_PREFIX = "bench_suite_results_torch"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Benchmark suite (PyTorch port)")
    p.add_argument("--config", default="configs/denseclip_vitb16_cityscapes_multitask.yaml")
    p.add_argument("--workloads", type=int, nargs="*", default=[1, 2, 3, 4, 5, 6, 7, 8, 9])
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--rounds", type=int, default=6, help="most timed runs per workload")
    # slide protocol defaults come from the config's `test:` section
    p.add_argument("--crop", type=int, nargs=2, default=None)
    p.add_argument("--stride", type=int, nargs=2, default=None)
    p.add_argument("--window-batch", type=int, default=None)
    p.add_argument("--image", type=int, nargs=2, default=[1024, 2048], metavar=("H", "W"),
                   help="frame size (the metric names keep 1024x2048)")
    p.add_argument("--tag", default="", help="suffix for metric names and the results file")
    p.add_argument("--attn-impl", default=None,
                   help="override tpu.attn_impl (int8: the quantized serving path)")
    p.add_argument("--out", default=None, help="results file (default "
                   f"{PORT_RESULTS_PREFIX}{{tag}}.json)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", dest="overrides", nargs="*", default=[],
                   metavar="KEY.PATH=VALUE", help="dotted config overrides")
    args = p.parse_args(argv)
    if args.attn_impl and not args.tag:
        args.tag = f"_{args.attn_impl}"
    args.out = args.out or results_path(args.tag)
    name = os.path.basename(args.out)
    if name.startswith(JAX_RESULTS_PREFIX) and not name.startswith(PORT_RESULTS_PREFIX):
        p.error(f"--out {args.out} would overwrite the JAX package's results")
    return args


def results_path(tag: str) -> str:
    """The default results file of a tag: never one of the JAX package's."""
    return f"{PORT_RESULTS_PREFIX}{tag}.json"


def arch_name(backbone_cfg) -> str:
    """JAX's metric prefix: vit_b16 for the flagship's ViT-B/16."""
    prefix = {768: "vit_b", 1024: "vit_l"}.get(int(backbone_cfg.get("width", 768)), "vit")
    return prefix + str(backbone_cfg.get("patch_size", 16))


def make_eval_one(engine, crop, stride, window_batch: int) -> Callable:
    """Workload 9's function: one slide frame, its argmax, the confusion
    matrix and the depth error sums (`Inferencer.eval_metrics`), all folded
    into one device scalar."""
    def eval_one(image, seg_gt, depth_gt):
        out = engine.predict(image, mode="slide", crop=crop, stride=stride,
                             window_batch=window_batch, preprocessed=True, fetch="device")
        cm, sums, count = engine.eval_metrics(out, seg_gt=seg_gt, depth_gt=depth_gt)
        total = cm.sum().float()
        if sums is not None:
            total = total + count + sum(s for s in sums.values())
        return total

    return eval_one


def train_batch(b: int, hw, device) -> Dict:
    """A seeded training batch in JAX's ranges: uint8 frames, seg in [0, 19),
    depth in [0.1, 80)."""
    import torch

    rng = np.random.RandomState(0)
    h, w = hw
    arrays = {"image": rng.randint(0, 255, (b, h, w, 3), dtype=np.uint8),
              "seg": rng.randint(0, 19, (b, h, w), dtype=np.uint8),
              "depth": rng.uniform(0.1, 80, (b, h, w)).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def make_step(cfg, model, texts, training_cfg=None, frozen_modules=None):
    """(TrainState, step) for `model` as `train/loop.py` builds them."""
    from denseclip_vit_multimodal_tpu_torch.train.loop import train_step_from_cfg
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state

    training_cfg = training_cfg if training_cfg is not None else (cfg.get("training", {}) or {})
    state = create_train_state(model, training_cfg, 100, frozen_modules=frozen_modules)
    return state, train_step_from_cfg(texts, training_cfg, cfg.get("data", {}) or {})


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    from denseclip_vit_multimodal_tpu_torch.bench import build_model, check_device

    check_device(args.device)
    import torch

    from denseclip_vit_multimodal_tpu_torch.core.config import (
        load_config,
        resolve_config_path,
        resolve_test_protocol,
    )
    from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.utils.benchtime import (
        adaptive_min_time,
        device_loop_time,
    )

    cfg = load_config(resolve_config_path(args.config), overrides=args.overrides)
    crop, stride, window_batch = resolve_test_protocol(cfg, args.crop, args.stride,
                                                       args.window_batch)
    crop, stride = tuple(crop), tuple(stride)
    device = torch.device(args.device)
    on_cuda = device.type == "cuda"
    model, texts = build_model(cfg, device, args.attn_impl)
    engine = Inferencer(model, texts, augment_config_from_data_cfg(cfg.get("data", {}) or {},
                                                                   train=False))
    arch = arch_name(cfg.model.get("backbone", {}))
    has_depth = model.depth_head is not None
    task = "multitask" if has_depth else "seg"
    h, w = args.image
    device_name = torch.cuda.get_device_name(device) if on_cuda else "cpu"
    with torch.inference_mode():
        cached_text = model.encode_text_base(texts)
    results: List[dict] = []

    def emit(name, value, unit, stats=None, call_ms=None):
        line = {"metric": name + args.tag, "value": round(value, 4), "unit": unit,
                "device": device_name}
        if stats:
            line["drift_pct"] = stats.get("drift_pct")
            line["timed_runs"] = stats.get("runs")
        if call_ms:
            p50, p90 = np.percentile(call_ms, [50, 90])
            line.update({"latency_ms_p50": round(float(p50), 4),
                         "latency_ms_p90": round(float(p90), 4),
                         "latency_samples": len(call_ms)})
        if on_cuda:
            line["peak_mem_gib"] = round(torch.cuda.max_memory_allocated(device) / 2**30, 3)
        results.append(line)
        print(json.dumps(line), flush=True)

    def start():  # each workload's peak memory is its own
        if on_cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)

    def timed(fn, fargs, iters):
        """(seconds per call, stats, call ms) of a device workload."""
        stats, call_ms = {}, []
        with torch.inference_mode():
            dt = device_loop_time(fn, fargs, iters, stats, call_ms, device=device,
                                  max_rounds=args.rounds)
        return dt, stats, call_ms

    def slide(image):
        return engine.predict(image, mode="slide", crop=crop, stride=stride,
                              window_batch=window_batch, preprocessed=True, fetch="device")

    def host_timed(run_once, max_rounds):
        """(best seconds, stats) of `run_once` by the host clock."""
        runs = [0]

        def counted():
            run_once()
            runs[0] += 1

        best, drift = adaptive_min_time(counted, max_rounds=min(max_rounds, args.rounds))
        return best, {"drift_pct": round(drift, 2), "runs": runs[0]}

    def timed_steps(state, step, batch, iters):
        """(best seconds for `iters` steps, stats) on one fixed batch; each
        step reads its losses back, so the host clock brackets the device."""
        step(state, batch)  # warm-up

        def run_once():
            for _ in range(iters):
                step(state, batch)

        return host_timed(run_once, 4)

    if 1 in args.workloads:
        start()
        img = torch.zeros(1, 512, 512, 3, device=device)
        dt, st, ms = timed(lambda im: model(im, texts, cached_text=cached_text)["seg"],
                           (img,), args.iters)
        emit(f"{arch}_512x512_seg_forward", 1.0 / dt, "images/sec", st, ms)

    if 2 in args.workloads:
        start()
        img = torch.zeros(1, h, w, 3, device=device)
        dt, st, ms = timed(slide, (img,), args.iters)
        emit(f"slide_1024x2048_{task}", 1.0 / dt, "images/sec", st, ms)
        if on_cuda:
            from denseclip_vit_multimodal_tpu_torch.utils.flops import (
                device_peak_bf16_tflops,
                program_flops,
            )

            flops = program_flops(slide, img).total
            emit(f"slide_1024x2048_{task}_mfu",
                 100.0 * flops / dt / (device_peak_bf16_tflops(device) * 1e12), "percent")

    if 7 in args.workloads:
        start()
        img = torch.zeros(4, h, w, 3, device=device)
        dt, st, ms = timed(slide, (img,), max(args.iters // 2, 2))
        emit(f"slide_1024x2048_{task}_batch4", 4.0 / dt, "images/sec", st, ms)

    if 3 in args.workloads:
        start()
        img = torch.zeros(4, h, w, 3, device=device)
        # both heads come back (resized to the frame): nothing of the
        # multitask forward is skipped
        dt, st, ms = timed(lambda im: model(im, texts, cached_text=cached_text), (img,),
                           max(args.iters // 2, 2))
        emit(f"whole_1024x2048_{task}_batch4", 4.0 / dt, "images/sec", st, ms)

    if 4 in args.workloads:
        start()
        b, iters = 16, max(args.iters // 2, 2)
        state, step = make_step(cfg, copy.deepcopy(model), texts)
        best, st = timed_steps(state, step, train_batch(b, (h, w), device), iters)
        emit("train_step_frozen_text_batch16", b * iters / best, "samples/sec", st)
        del state, step

    if 6 in args.workloads:
        # the heritage recipe: the backbone trains at lr x0.1, the text tower
        # is frozen, so the ViT's backward (K2) is live
        start()
        b, iters = 8, max(args.iters // 2, 2)
        tcfg = {**dict(cfg.get("training", {}) or {}), "lr_mults": {"backbone": 0.1}}
        state, step = make_step(cfg, copy.deepcopy(model), texts, tcfg,
                                frozen_modules=("text_encoder",))
        best, st = timed_steps(state, step, train_batch(b, (h, w), device), iters)
        emit("train_step_unfrozen_backbone_batch8", b * iters / best, "samples/sec", st)
        del state, step

    if 8 in args.workloads:
        from denseclip_vit_multimodal_tpu_torch.data.loader import DataLoader, to_device
        from denseclip_vit_multimodal_tpu_torch.data.synthetic import SyntheticDataset

        start()
        b, steps = 16, max(args.iters // 2, 2)
        threads = max(1, min(8, os.cpu_count() or 1))
        counted = [0]

        def drain(loader):
            counted[0] = 0
            for batch in loader.epoch(0):
                counted[0] += batch["image"].shape[0]

        # (a) the host pipeline alone: threaded generation and stacking
        loader = DataLoader(SyntheticDataset(length=b * (steps + 2), image_size=(h, w)),
                            batch_size=b, num_threads=threads)
        next(iter(loader.epoch(0)))  # lazy set-up
        best, st = host_timed(lambda: drain(loader), 4)
        emit("loader_host_pipeline_batch16", counted[0] / best, "samples/sec", st)
        # (b) generation cached: the loader's machinery (threads, batch stacking)
        loader = DataLoader(SyntheticDataset(length=b * (steps + 2), image_size=(h, w),
                                             cache=True), batch_size=b, num_threads=threads)
        drain(loader)  # fills the cache
        best, st = host_timed(lambda: drain(loader), 4)
        emit("loader_host_machinery_batch16", counted[0] / best, "samples/sec", st)
        # (c) the cached loader feeding workload 4's step through the pinned
        # upload; every timed epoch is a whole one
        state, step = make_step(cfg, copy.deepcopy(model), texts)
        epochs = iter(range(1, 1 << 30))
        for batch in loader.epoch(0):  # warm-up epoch
            step(state, to_device(batch, device))

        def run_e2e():
            counted[0] = 0
            for batch in loader.epoch(next(epochs)):
                step(state, to_device(batch, device))
                counted[0] += b
            if not counted[0]:
                raise RuntimeError("loader produced an empty epoch")

        best, st = host_timed(run_e2e, 3)
        emit("train_loader_included_batch16", counted[0] / best, "samples/sec", st)
        del state, step

    if 9 in args.workloads:
        start()
        rng = np.random.RandomState(0)
        nk = engine.num_classes
        im = torch.from_numpy(rng.rand(1, h, w, 3).astype(np.float32)).to(device)
        seg_gt = torch.from_numpy(rng.randint(0, nk, (1, h, w)).astype(np.int32)).to(device)
        depth_gt = torch.from_numpy(rng.uniform(0, 80, (1, h, w)).astype(np.float32)).to(device)
        dt, st, ms = timed(make_eval_one(engine, crop, stride, window_batch),
                           (im, seg_gt, depth_gt), args.iters)
        emit("eval_path_device_1024x2048_slide", 1.0 / dt, "images/sec", st, ms)

    if 5 in args.workloads:
        start()
        img = torch.zeros(1, h, w, 3, dtype=torch.uint8, device=device)
        dt, st, ms = timed(
            lambda im: engine.aug_test(im, scales=(0.5, 0.75, 1.0), flip=True, mode="slide",
                                       crop=crop, stride=stride, window_batch=window_batch,
                                       fetch="device"),
            (img,), max(args.iters // 4, 2))
        emit("aug_test_slide_3scale_flip_1024x2048", 1.0 / dt, "images/sec", st, ms)

    order = [name.format(arch=arch, task=task) + args.tag for name in ORDER]
    write_results(args.out, results, order)
    return results


def write_results(path: str, results: List[dict], order: List[str]) -> None:
    """Merge `results` into the JSON list at `path` by metric name, so that a
    partial `--workloads` run refreshes its own entries only; sorted by
    `order`."""
    merged = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                prior = json.load(f)
            fresh = {r["metric"] for r in results}
            merged = [r for r in prior if isinstance(r, dict) and r.get("metric") not in fresh]
        except (OSError, ValueError) as e:
            print(f"WARNING: could not merge existing {path}: {e}", file=sys.stderr)
    rank = {name: i for i, name in enumerate(order)}
    merged = sorted(merged + results, key=lambda r: rank.get(r["metric"], len(rank)))
    with open(path, "w") as f:
        json.dump(merged, f, indent=1)


if __name__ == "__main__":
    main()
