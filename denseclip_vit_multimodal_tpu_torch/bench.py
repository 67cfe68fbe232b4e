"""Benchmark of the port: Cityscapes 1024×2048 slide-window inference, img/s
on one card (the JAX package's root `bench.py`).

    python3 -m denseclip_vit_multimodal_tpu_torch.bench
    python3 -m denseclip_vit_multimodal_tpu_torch.bench --device cpu --image 128 256 \
        --iters 1 --set model.backbone.width=96 ...        # tiny, on the CPU

The north-star metric: full-frame sliding-window joint seg + depth inference
with the flagship preset (`configs/denseclip_vitb16_cityscapes_multitask.yaml`)
in its compute dtype (bf16), the weights random from a seed.  JAX's protocol:

  * one seeded uint8 frame (1024×2048), normalised once on the card; the
    text tower runs once and is cached (`Inferencer`'s cache, the serving
    path);
  * two protocols, both measured: `value` at the shipped crop 624 (39·39+1
    = 1522 tokens, padded to 1536) and `value_reference_protocol` at the
    reference's crop 640 (1601 → 1664), stride 426 each: the same 2×5
    windows;
  * a frame is `Inferencer.predict(..., mode="slide", fetch="device")`: the
    20-channel canvas, the argmax and the depth map of every frame stay on
    the card, which is what a serving frame computes before its copy to the
    host.  In eager mode nothing prunes work, so nothing needs a carry to
    pin it (the JAX bench's lesson at its `bench_loop`);
  * each timed run queues `--iters` frames (16) back to back between CUDA
    events, with no host sync inside (`utils/benchtime.py::timed_run`); the
    two protocols' runs alternate, up to `--rounds` rounds (6), until the
    two fastest runs of each protocol agree within 2%; img/s = frames ÷ the
    fastest run;
  * `latency_ms_p50` / `latency_ms_p90` are over every timed frame of the
    shipped protocol (`latency_samples` of them): the time between the
    events around each frame, i.e. its device time plus any wait for the
    host to queue it;
  * MFU: the forward FLOPs of one shipped frame by `utils/flops.py::
    program_flops` (aten ops plus the kernels launched), times img/s, over
    the card's dense bf16 peak.  A failed count fails the run.  The port's
    convention differs from XLA's (`utils/flops.py`), so this `mfu_pct` is
    not comparable with a TPU one.

Prints ONE JSON line: the JAX keys `metric`, `value`, `unit`,
`value_reference_protocol`, `crop_shipped`, `crop_reference`,
`model_tflops_per_image`, `mfu_pct`, `peak_bf16_tflops`, plus
`latency_ms_p50`, `latency_ms_p90`, `latency_samples`, `timed_runs`,
`drift_pct` (the shipped protocol's spread around its fastest run),
`device` and `power_limit_w` (nvidia-smi's).  JAX's `vs_baseline` is
dropped: its constant was an estimate for an unspecified GPU, never
measured.  With `--device cpu` the line names the CPU, times by the host
clock and has no MFU keys (no peak); without a card the default `cuda`
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Tuple

import numpy as np

METRIC = "cityscapes_1024x2048_slide_infer_images_per_sec_per_chip"
CONFIG = "configs/denseclip_vitb16_cityscapes_multitask.yaml"
CROP_SHIPPED = (624, 624)  # pad-exact serving protocol
CROP_REFERENCE = (640, 640)  # the reference's protocol
IMAGE_HW = (1024, 2048)
STRIDE = (426, 426)
ITERS = 16
ROUNDS = 6
REL_TOL = 0.02  # the two fastest runs of each protocol agree within this
SEED = 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Slide-inference benchmark (PyTorch port)")
    p.add_argument("--config", default=CONFIG, help="config YAML path or preset name")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--image", type=int, nargs=2, default=list(IMAGE_HW), metavar=("H", "W"))
    p.add_argument("--iters", type=int, default=ITERS, help="frames per timed run")
    p.add_argument("--rounds", type=int, default=ROUNDS, help="most interleaved rounds")
    p.add_argument("--set", dest="overrides", nargs="*", default=[],
                   metavar="KEY.PATH=VALUE", help="dotted config overrides")
    return p.parse_args(argv)


def build_model(cfg, device, attn_impl=None):
    """(model, texts) of a config on `device`, in its `tpu.compute_dtype`
    (bf16 by default) with its `tpu.attn_impl` unless `attn_impl` is given;
    weights random from `SEED`; the class list of the config's dataset."""
    import torch

    from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip
    from denseclip_vit_multimodal_tpu_torch.train.loop import class_names_for

    tpu_cfg = cfg.get("tpu", {}) or {}
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        str(tpu_cfg.get("compute_dtype", "bfloat16"))]
    return build_denseclip(cfg.model, class_names_for(cfg.get("data", {}) or {}), dtype=dtype,
                           attn_impl=attn_impl or str(tpu_cfg.get("attn_impl", "auto")),
                           device=device, seed=SEED)


def check_device(device: str) -> None:
    """SystemExit unless `device` is the CPU or CUDA is there: a measurement
    on the card never falls back to the CPU."""
    import torch

    if torch.device(device).type != "cpu" and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device for --device {device} (pass --device cpu)")


def setup(args) -> Tuple[object, Callable[[Tuple[int, int]], Callable[[], Dict]]]:
    """(engine, frame_fn): `frame_fn(crop)` returns the callable that runs
    one frame of the slide protocol at `crop` on the seeded, preprocessed
    frame."""
    import torch

    from denseclip_vit_multimodal_tpu_torch.core.config import (
        load_config,
        resolve_config_path,
        resolve_test_protocol,
    )
    from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer

    cfg = load_config(resolve_config_path(args.config), overrides=args.overrides)
    model, texts = build_model(cfg, args.device)
    _, _, window_batch = resolve_test_protocol(cfg)
    engine = Inferencer(model, texts, augment_config_from_data_cfg(cfg.get("data", {}),
                                                                   train=False),
                        num_classes=len(texts))
    h, w = args.image
    frame = np.random.RandomState(SEED).randint(0, 255, (1, h, w, 3), dtype=np.uint8)
    image = engine.preprocess(torch.from_numpy(frame).to(args.device))

    def frame_fn(crop):
        return lambda: engine.predict(image, mode="slide", crop=crop, stride=STRIDE,
                                      window_batch=window_batch, preprocessed=True,
                                      fetch="device")

    return engine, frame_fn


def _settled(times) -> bool:
    if len(times) < 2:
        return False
    best, second = sorted(times)[:2]
    return second - best < REL_TOL * best


def main(argv=None) -> dict:
    args = parse_args(argv)
    check_device(args.device)
    import torch

    from denseclip_vit_multimodal_tpu_torch.utils.benchtime import timed_run

    _, frame_fn = setup(args)
    frames = {"ref": frame_fn(CROP_REFERENCE), "shipped": frame_fn(CROP_SHIPPED)}
    on_cuda = torch.device(args.device).type == "cuda"
    for run in frames.values():  # warm-up: cuDNN plans, the text tower's cache, kernel builds
        run()
    if on_cuda:
        torch.cuda.synchronize()

    # The protocols' timed runs alternate, so that drift over the session
    # biases neither (the JAX bench's measurement rule).
    times = {key: [] for key in frames}
    latency_ms = {key: [] for key in frames}
    for _ in range(args.rounds):
        for key, run in frames.items():
            seconds, ms = timed_run(run, (), args.iters, args.device)
            times[key].append(seconds)
            latency_ms[key].extend(ms)
        if all(_settled(t) for t in times.values()):
            break
    ips = {key: args.iters / min(t) for key, t in times.items()}
    shipped = times["shipped"]
    p50, p90 = np.percentile(latency_ms["shipped"], [50, 90])

    line = {
        "metric": METRIC,
        "value": round(ips["shipped"], 4),
        "unit": "images/sec",
        "value_reference_protocol": round(ips["ref"], 4),
        "crop_shipped": list(CROP_SHIPPED),
        "crop_reference": list(CROP_REFERENCE),
        "latency_ms_p50": round(float(p50), 4),
        "latency_ms_p90": round(float(p90), 4),
        "latency_samples": len(latency_ms["shipped"]),
        "timed_runs": len(shipped),
        "drift_pct": round((max(shipped) - min(shipped)) / min(shipped) * 100.0, 2),
        "device": torch.cuda.get_device_name() if on_cuda else "cpu",
        "power_limit_w": None,
    }
    if on_cuda:
        from denseclip_vit_multimodal_tpu_torch.utils.env import (
            nvidia_smi_cards,
            power_limit_watts,
        )
        from denseclip_vit_multimodal_tpu_torch.utils.flops import (
            device_peak_bf16_tflops,
            program_flops,
        )

        cards = nvidia_smi_cards()
        index = torch.cuda.current_device()
        if index < len(cards):
            line["power_limit_w"] = power_limit_watts(cards[index][1])
        flops = program_flops(frames["shipped"]).total
        peak = device_peak_bf16_tflops()
        line.update({
            "model_tflops_per_image": round(flops / 1e12, 3),
            "mfu_pct": round(100.0 * flops * ips["shipped"] / (peak * 1e12), 2),
            "peak_bf16_tflops": peak,
        })
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
