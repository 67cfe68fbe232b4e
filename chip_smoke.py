"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port only (`denseclip_vit_multimodal_tpu_torch`; no JAX), in
phases that each print one JSON line:

  1. device    — card name and power limit, torch / CUDA versions, TF32 off;
  2. build     — compiles every kernel of the main path from `csrc/`;
  3. kernel    — each kernel against its plain PyTorch version on the card
                 (bf16, seeded unit-normal inputs) at the main path's shapes
                 and others, with kernel / plain / library / bound times;
  4. reference — the full-width model in bf16 on the card against the same
                 model in fp32 on the CPU (plain attention) on one 512x512
                 window;
  5. main_path — the flagship ViT-B/16 seg+depth preset at full width from a
                 seeded init, slide inference (crop 624, stride 426, window
                 batch 20) over 3 seeded 1024x2048 requests; launch counts,
                 img/s (CUDA events), peak memory, and one frame against
                 plain attention;
  6. profile   — the same 3 requests again under torch.profiler: device time
                 per frame by kernel group, the top kernels, and the device's
                 busy share (kernel time over CUDA-event wall time; one
                 stream, so kernels do not overlap).

Then the `kernels` line, the nvidia-smi line and, last, the result line.
Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
KERNEL_TOL = 2e-2  # max abs error, bf16 kernel vs bf16 plain version, unit-normal inputs
# Mean abs error and relative L2 of the same comparison, held tight so that a
# small systematic fault (unmasked pad keys, a softmax scale off by 0.5% or
# more) fails where the max abs limit alone would pass it.  Measured on an
# H100 80GB HBM3 at the four shapes below: mean abs <= 6.4e-5, relative L2
# 2.2e-3 to 2.4e-3 (bf16 rounding of the output).
KERNEL_MEAN_TOL = 5e-4
KERNEL_REL_TOL = 5e-3
PATH_TOL = 2e-2  # relative L2, flagship logits with the kernel vs plain attention, both bf16
# relative L2, bf16 on the card vs fp32 on the CPU through 12 layers: bf16
# rounds every activation to 8 bits of mantissa, so ~1e-2 is expected.
REFERENCE_TOL = 5e-2
CONFIG = "configs/denseclip_vitb16_cityscapes_multitask.yaml"
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return smi


def phase_build() -> None:
    from denseclip_vit_multimodal_tpu_torch.ops import _build

    start = time.perf_counter()
    _build.load_library("qkv_attention")
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("qkv_attention", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "kernel": "qkv_attention", "seconds": time.perf_counter() - start,
          "nvcc_seconds": _build.BUILD_SECONDS.get("qkv_attention"), "ptxas": ptxas})


def qkv_attention_case(b: int, n: int, heads: int, head_dim: int, valid_len, iters: int) -> dict:
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
        mha_qkv_attention,
        mha_qkv_attention_reference,
    )

    hd = heads * head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(torch.bfloat16)
    kv = n if valid_len is None else valid_len
    out = mha_qkv_attention(qkv, heads, valid_len=valid_len)
    ref = mha_qkv_attention_reference(qkv, heads, valid_len=valid_len)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    # the library yardstick: one fused-attention call on the head-split tensors
    q, k, v = (t.reshape(b, n, heads, head_dim).transpose(1, 2).contiguous()
               for t in qkv.split(hd, dim=-1))
    k, v = k[:, :, :kv].contiguous(), v[:, :, :kv].contiguous()
    flops = 4.0 * b * heads * n * kv * head_dim
    nbytes = 2.0 * (qkv.numel() + out.numel())
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    ms = cuda_ms(lambda: mha_qkv_attention(qkv, heads, valid_len=valid_len), iters)
    return {
        "phase": "kernel", "name": "qkv_attention", "shape": [b, n, 3 * hd], "heads": heads,
        "head_dim": head_dim, "valid_len": valid_len,
        "max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
        "rel_l2_err": rel_l2(out, ref),
        "ms": ms,
        "plain_ms": cuda_ms(lambda: mha_qkv_attention_reference(qkv, heads, valid_len=valid_len),
                            max(iters // 10, 2), warmup=1),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters),
        "bound_ms": bound_ms,
        "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes",
        "tflops": flops / (ms * 1e-3) / 1e12,
        "finite": bool(torch.isfinite(out).all()),
    }


def phase_kernels() -> dict:
    cases = [
        (10, 1536, 12, 64, 1522, 50),  # slide window batch (crop 624, padded once)
        (1, 8320, 12, 64, 8193, 10),  # whole 1024x2048 frame
        (2, 640, 8, 128, 640, 50),  # head dim 128
        (4, 777, 12, 64, None, 50),  # ragged N, valid_len None
    ]
    results = []
    for b, n, heads, d, valid_len, iters in cases:
        res = qkv_attention_case(b, n, heads, d, valid_len, iters)
        emit(res)
        if not (res["finite"] and res["max_abs_err"] <= KERNEL_TOL
                and res["mean_abs_err"] <= KERNEL_MEAN_TOL and res["rel_l2_err"] <= KERNEL_REL_TOL):
            raise AssertionError(f"qkv_attention disagrees with its plain version: {res}")
        results.append(res)
    return results[0]  # the slide shape is the main path's


def phase_reference(model, texts) -> None:
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )

    cfg = load_config(CONFIG)
    cpu_model, _ = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.float32,
                                   device="cpu", seed=SEED)
    image = torch.from_numpy(np.random.RandomState(SEED).randn(1, 512, 512, 3).astype(np.float32))
    with torch.inference_mode():
        ref = cpu_model(image, texts)
        got = model(image.cuda(), texts)
    res = {"phase": "reference", "image": [1, 512, 512, 3], "tokens": 32 * 32 + 1,
           "seg_rel_l2": rel_l2(got["seg"].cpu(), ref["seg"]),
           "depth_rel_l2": rel_l2(got["depth"].cpu(), ref["depth"]), "tol": REFERENCE_TOL}
    emit(res)
    if not max(res["seg_rel_l2"], res["depth_rel_l2"]) <= REFERENCE_TOL:
        raise AssertionError(f"bf16 model on the card disagrees with fp32 on the CPU: {res}")


def phase_main_path() -> dict:
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config, resolve_test_protocol
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.models.layers import set_attn_impl
    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import LAUNCHES

    cfg = load_config(CONFIG)
    crop, stride, window_batch = resolve_test_protocol(cfg)
    start = time.perf_counter()
    model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.bfloat16,
                                   device="cuda", seed=SEED)
    build_s = time.perf_counter() - start
    phase_reference(model, texts)
    engine = Inferencer(model, texts, num_classes=19)
    rs = np.random.RandomState(SEED)
    frames = [rs.randint(0, 256, (1, 1024, 2048, 3), dtype=np.uint8) for _ in range(3)]
    predict = lambda frame, fetch: engine.predict(
        frame, mode="slide", crop=crop, stride=stride, window_batch=window_batch, fetch=fetch)

    predict(frames[0], "argmax")  # warm-up: cuDNN plans, the cached text tower
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    outs = [predict(frame, fetch) for frame, fetch in zip(frames, ("argmax", "packed", "argmax"))]
    end.record()
    torch.cuda.synchronize()
    elapsed = start.elapsed_time(end) / 1e3  # every request ends in a device-to-host copy
    launches = dict(LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    for out in outs:
        for key in ("seg", "depth"):
            arr = out[key]
            if arr.shape != (1, 1024, 2048) or not np.isfinite(arr.astype(np.float32)).all():
                raise AssertionError(f"bad {key}: shape {arr.shape}")
        if not (0 <= out["seg"].min() and out["seg"].max() < 19):
            raise AssertionError("seg labels out of range")
    if launches["qkv_attention"] != 12 * len(frames):
        raise AssertionError(f"expected {12 * len(frames)} qkv_attention launches, got {launches}")

    # one frame against plain attention on the card
    kernel_out = predict(frames[0], "device")
    set_attn_impl(model, "xla")
    before = LAUNCHES["qkv_attention"]
    plain_out = predict(frames[0], "device")
    set_attn_impl(model, "auto")
    if LAUNCHES["qkv_attention"] != before:
        raise AssertionError("the plain-attention run launched the kernel")
    res = {
        "phase": "main_path", "config": CONFIG, "crop": crop, "stride": stride,
        "window_batch": window_batch, "frames": len(frames), "frame": [1024, 2048],
        "build_s": build_s, "launches": launches, "img_per_s": len(frames) / elapsed,
        "ms_per_frame": elapsed / len(frames) * 1e3, "peak_mem_gib": peak_gib,
        "seg_rel_l2_vs_plain": rel_l2(kernel_out["seg_logits"], plain_out["seg_logits"]),
        "depth_rel_l2_vs_plain": rel_l2(kernel_out["depth"], plain_out["depth"]),
        "tol": PATH_TOL,
    }
    emit(res)
    if not max(res["seg_rel_l2_vs_plain"], res["depth_rel_l2_vs_plain"]) <= PATH_TOL:
        raise AssertionError(f"kernel path disagrees with plain attention: {res}")
    phase_profile(lambda frame: predict(frame, "argmax"), frames)
    return res


PROFILE_GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("qkv_attention (K1)", ("qkv_attention_kernel",)),
    ("conv (cuDNN)", ("conv", "cudnn", "implicit", "winograd", "fprop", "dgrad")),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "wgmma", "sm90")),
    ("layer_norm", ("layer_norm",)),
    ("resize / overlap-add", ("upsample", "interpolate", "bilinear")),
    ("softmax / reduce", ("softmax", "reduce")),
)


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in PROFILE_GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise / copy / other"


def phase_profile(run, frames) -> None:
    """Where the device time of a flagship frame goes (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for frame in frames:
            run(frame)
        end.record()
        torch.cuda.synchronize()
    per_frame = lambda ms: ms / len(frames)
    by_name, calls = collections.defaultdict(float), collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
            calls[evt.name] += 1
    by_group = collections.defaultdict(float)
    for name, ms in by_name.items():
        by_group[kernel_group(name)] += ms
    wall_ms, busy_ms = start.elapsed_time(end), sum(by_name.values())
    if busy_ms <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    emit({"phase": "profile", "frames": len(frames), "wall_ms_per_frame": per_frame(wall_ms),
          "device_busy_ms_per_frame": per_frame(busy_ms), "device_busy_share": busy_ms / wall_ms,
          "groups_ms_per_frame": {g: per_frame(ms) for g, ms in
                                  sorted(by_group.items(), key=lambda kv: -kv[1])},
          "top_kernels": [{"name": name[:100], "ms_per_frame": per_frame(ms),
                           "calls_per_frame": calls[name] / len(frames),
                           "group": kernel_group(name)} for name, ms in top]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    slide = phase_kernels()
    main_res = phase_main_path()
    emit({"kernels": [{
        "name": "qkv_attention", "route": "cuda",
        "source": "denseclip_vit_multimodal_tpu_torch/csrc/qkv_attention.cu",
        "replaces": "denseclip_vit_multimodal_tpu/ops/mha_kernel.py:400",
        "launches": main_res["launches"]["qkv_attention"],
        "max_abs_err": slide["max_abs_err"], "ms": slide["ms"], "kernel_ms": slide["ms"],
        "plain_ms": slide["plain_ms"],
        "bound_ms": slide["bound_ms"], "bound_by": slide["bound_by"],
        "library_ms": slide["library_ms"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # any failed phase: report it and print no result line
        traceback.print_exc()
        code = 1
    sys.exit(code)
