"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port only (`denseclip_vit_multimodal_tpu_torch`; no JAX), in
phases that each print one JSON line:

  1. device     — card name and power limit, torch / CUDA versions, TF32 off;
  2. build      — compiles every kernel source under `csrc/` (one nvcc each,
                  all started together), with ptxas registers and spills;
  3. kernel     — K1 (attention forward) against its plain PyTorch version
                  on the card (bf16, seeded unit-normal inputs) at the main
                  path's shapes and others, with kernel / plain / library /
                  bound times;
  4. kernel_bwd — K2 (attention backward) the same way, per gradient dq, dk,
                  dv, with dk / dv of masked keys held to exactly 0;
  5. reference  — the full-width model in bf16 on the card against the same
                  model in fp32 on the CPU (plain attention) on one 512x512
                  window;
  6. main_path  — the flagship ViT-B/16 seg+depth preset at full width from a
                  seeded init, slide inference (crop 624, stride 426, window
                  batch 20) over 3 seeded 1024x2048 requests; launch counts,
                  img/s (CUDA events), peak memory, and one frame against
                  plain attention;
  7. profile    — the same 3 requests again under torch.profiler: device time
                  per frame by kernel group, the top kernels, and the device's
                  busy share (kernel time over CUDA-event wall time; one
                  stream, so kernels do not overlap);
  8. train_path — the heritage preset (backbone trained at lr x0.1) at full
                  width, batch 4, crop 640, on synthetic 1024x2048 frames
                  augmented on the card: 1 warm-up and 5 timed steps (CUDA
                  events; ms/step, samples/s, peak memory, K1 / K2 launches
                  per step, losses), one step with the kernels against plain
                  attention and fp32, a profile of 2 steps, and 2 steps
                  through the user entry point `train()`.

Then the `kernels` line, the nvidia-smi line and, last, the result line.
Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

from __future__ import annotations

import collections
import json
import os
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
# K2 against its plain version (bf16, unit-normal qkv and dO, on K1's output
# and statistics), per gradient dq / dk / dv: relative L2, and max abs error
# as a share of the largest reference magnitude.  Measured on an H100 80GB
# HBM3 at the four shapes below: relative L2 1.0e-4 to 2.2e-4, max abs error
# one bf16 ulp (<= 1.95e-3 at |ref| <= 0.83, i.e. <= 4.2e-3 of the largest).
KERNEL_BWD_REL_TOL = 2e-3
KERNEL_BWD_MAX_TOL = 1e-2
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


KERNEL_SOURCES = ("qkv_attention", "qkv_attention_bwd")  # csrc/<name>.cu


def phase_build() -> None:
    """Compile every kernel source, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from denseclip_vit_multimodal_tpu_torch.ops import _build

    start = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(_build.load_library, KERNEL_SOURCES))
    seconds = time.perf_counter() - start
    for name in KERNEL_SOURCES:
        ptxas = [ln.strip() for ln in _build.BUILD_LOG.get(name, "").splitlines()
                 if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
        emit({"phase": "build", "kernel": name, "seconds": seconds,
              "nvcc_seconds": _build.BUILD_SECONDS.get(name), "ptxas": ptxas})


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
        (4, 1664, 12, 64, 1601, 50),  # heritage training: batch 4, crop 640, padded once
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


def qkv_attention_bwd_case(b: int, n: int, heads: int, head_dim: int, valid_len,
                           iters: int) -> dict:
    """K2 against its plain version on K1's output and statistics."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
        _launch,
        _launch_bwd,
        mha_qkv_attention_bwd_reference,
    )

    hd = heads * head_dim
    scale = head_dim**-0.5
    kv = n if valid_len is None else valid_len
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(torch.bfloat16)
    dout = torch.randn(b, n, hd, generator=gen, device="cuda").to(torch.bfloat16)
    out, stats = _launch(qkv, heads, scale, kv, with_stats=True)
    bwd = lambda: _launch_bwd(qkv, out, dout, stats, heads, scale, kv)
    plain = lambda: mha_qkv_attention_bwd_reference(qkv, out, dout, heads, valid_len=kv)
    got, ref = bwd(), plain()
    torch.cuda.synchronize()
    res = {"phase": "kernel_bwd", "name": "qkv_attention_bwd", "shape": [b, n, 3 * hd],
           "heads": heads, "head_dim": head_dim, "valid_len": valid_len,
           "finite": bool(torch.isfinite(got.float()).all()),
           "masked_dkdv_exact_zero": bool((got[:, kv:, hd:] == 0).all())}
    for i, part in enumerate(("dq", "dk", "dv")):
        a, w = got[..., i * hd:(i + 1) * hd].float(), ref[..., i * hd:(i + 1) * hd].float()
        err = (a - w).abs()
        res[part] = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
                     "rel_l2_err": rel_l2(a, w), "max_abs_ref": float(w.abs().max())}
    # the library yardstick: the backward of one fused-attention call on
    # head-split copies (timed only; the port never calls it)
    q, k, v = (t.reshape(b, n, heads, head_dim).transpose(1, 2).contiguous()
               for t in qkv.split(hd, dim=-1))
    k, v = k[:, :, :kv].contiguous(), v[:, :, :kv].contiguous()
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(q, k, v)
    lib_grad = dout.reshape(b, n, heads, head_dim).transpose(1, 2).contiguous()
    library = lambda: torch.autograd.grad(lib_out, (q, k, v), lib_grad, retain_graph=True)
    flops = 10.0 * b * heads * n * kv * head_dim  # s, dp, dv, dq, dk
    nbytes = 2.0 * (2 * qkv.numel() + out.numel() + dout.numel()) + 4.0 * stats.numel()
    res["ms"] = cuda_ms(bwd, iters)
    res["plain_ms"] = cuda_ms(plain, max(iters // 10, 2), warmup=1)
    res["library_ms"] = cuda_ms(library, iters)
    res["bound_ms"] = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    res["bound_by"] = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    res["max_abs_err"] = max(res[p]["max_abs_err"] for p in ("dq", "dk", "dv"))
    return res


BWD_CASES = [
    (4, 1664, 12, 64, 1601, 20),  # heritage training: batch 4, crop 640 (1601 tokens, padded once)
    (10, 1536, 12, 64, 1522, 10),  # slide window batch shape
    (2, 640, 8, 128, None, 20),  # head dim 128
    (4, 777, 12, 64, None, 20),  # ragged N, valid_len None
]


def phase_kernel_bwd() -> dict:
    results = []
    for b, n, heads, d, valid_len, iters in BWD_CASES:
        res = qkv_attention_bwd_case(b, n, heads, d, valid_len, iters)
        emit(res)
        bad = [p for p in ("dq", "dk", "dv")
               if not (res[p]["rel_l2_err"] <= KERNEL_BWD_REL_TOL
                       and res[p]["max_abs_err"] <= KERNEL_BWD_MAX_TOL * res[p]["max_abs_ref"])]
        if bad or not (res["finite"] and res["masked_dkdv_exact_zero"]):
            raise AssertionError(f"qkv_attention_bwd disagrees with its plain version ({bad}): {res}")
        results.append(res)
    return results[0]  # the training shape is the main path's


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


TRAIN_CONFIG = "configs/denseclip_vitb16_640x640_80k.yaml"
# The heritage preset at its published widths and depth, with its batch (4)
# and crop (640); the data is the synthetic stand-in at the Cityscapes frame
# size (no Cityscapes in the repository), augmented on the card.
TRAIN_OVERRIDES = ["data.synthetic=true", "data.synthetic_options.image_size=[1024,2048]",
                   "data.synthetic_options.length=40"]
TRAIN_TIMED_STEPS = 5
# One training step on the same weights, batch and dropout masks with the
# kernels, with plain attention (both bf16) and in fp32 (plain attention):
#  * the total loss, kernels vs plain: relative difference <= TRAIN_TOL;
#  * the backbone gradients of the segmentation loss: the kernel path's
#    relative L2 to fp32 at most TRAIN_GRAD_RATIO times the plain bf16
#    path's.  bf16 itself moves them far more than 5e-2 at a random init
#    (measured on an H100: 0.117 kernels, 0.115 plain, 0.113 between them),
#    so the limit holds the kernels to adding no error of their own.
# The gradients of the total loss are printed, not held: at a random init a
# fifth of the depth predictions sit at SILog's eps clamp and the rest near
# 0, where d log(pred) = 1/pred turns rounding into large gradient
# differences (plain bf16 vs fp32 on an H100: 0.85 to 1.89; PERF.md §6).
TRAIN_TOL = 5e-2
TRAIN_GRAD_RATIO = 1.25


def phase_train_path() -> dict:
    """The heritage training path: 1 warm-up + 5 timed steps of the port's
    train step, K1 / K2 against plain attention on one step, then the user
    entry point `train()` for 2 steps."""
    import shutil

    from denseclip_vit_multimodal_tpu_torch.core.config import load_config
    from denseclip_vit_multimodal_tpu_torch.data.augment import (
        augment_batch,
        augment_config_from_data_cfg,
    )
    from denseclip_vit_multimodal_tpu_torch.data.loader import DataLoader, build_dataset, to_device
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.models.layers import set_attn_impl
    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import LAUNCHES
    from denseclip_vit_multimodal_tpu_torch.train.loop import train
    from denseclip_vit_multimodal_tpu_torch.train.losses import cross_entropy_loss, silog_loss
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state
    from denseclip_vit_multimodal_tpu_torch.train.step import make_train_step

    cfg = load_config(TRAIN_CONFIG, overrides=TRAIN_OVERRIDES)
    tcfg, dcfg = cfg.training, cfg.data
    seed, batch_size = int(tcfg.get("seed", 42)), int(tcfg.batch_size)
    loader = DataLoader(build_dataset(dcfg, "train"), batch_size=batch_size, seed=seed,
                        num_threads=int(tcfg.get("workers", 8)))
    start = time.perf_counter()
    model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.bfloat16,
                                   device="cuda", seed=seed)
    state = create_train_state(model, tcfg, len(loader))
    build_s = time.perf_counter() - start
    aug_cfg = augment_config_from_data_cfg(dcfg)
    step = make_train_step(texts, aug_cfg, seed=seed)
    batches = loader.epoch(0)
    step(state, to_device(next(batches), "cuda"))  # warm-up: cuDNN / cuBLAS plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    data_wait_s, metrics = 0.0, []
    begin.record()
    for _ in range(TRAIN_TIMED_STEPS):
        tick = time.perf_counter()
        host = next(batches)  # the loader's threads made it during the previous step
        data_wait_s += time.perf_counter() - tick
        metrics.append(step(state, to_device(host, "cuda")))
    end.record()
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    elapsed = begin.elapsed_time(end) / 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for m in metrics:
        if m["skipped"] or not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite training step: {m}")
    want = {"qkv_attention": 12 * TRAIN_TIMED_STEPS, "qkv_attention_bwd": 12 * TRAIN_TIMED_STEPS}
    if launches != want:
        raise AssertionError(f"expected {want} launches over {TRAIN_TIMED_STEPS} steps, got {launches}")

    # one step's loss and backbone gradients, kernels vs plain attention: the
    # same weights, the same augmented batch, the same dropout masks
    batch = augment_batch(to_device(next(batches), "cuda"), aug_cfg, torch.Generator().manual_seed(seed))

    def loss_and_grads(net):
        net.zero_grad(set_to_none=True)
        out = net(batch["image"], texts, train=True, gt_hw=tuple(aug_cfg.crop_size),
                  gen=torch.Generator(device="cuda").manual_seed(seed))
        seg = cross_entropy_loss(out["seg"], batch["seg"])
        silog = 0.1 * silog_loss(out["depth"], batch["depth"], batch["depth_mask"])
        grads = lambda: torch.cat([p.grad.float().flatten() for p in net.backbone.parameters()
                                   if p.grad is not None])  # `proj` is unused
        seg.backward(retain_graph=True)
        seg_grads = grads()
        silog.backward()
        return float((seg + silog).detach()), seg_grads, grads()

    before = dict(LAUNCHES)
    kernel_loss, kernel_grads, kernel_total_grads = loss_and_grads(model)
    if LAUNCHES["qkv_attention_bwd"] - before["qkv_attention_bwd"] != 24:
        raise AssertionError("the kernel step did not run K2 in every layer")
    set_attn_impl(model, "xla")
    plain_loss, plain_grads, plain_total_grads = loss_and_grads(model)
    set_attn_impl(model, "auto")
    model.zero_grad(set_to_none=True)
    # the same weights in fp32 (plain attention: the kernels take bf16) as the
    # yardstick both bf16 paths are measured against
    ref_model, _ = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.float32,
                                   device="cuda", seed=seed)
    ref_model.load_state_dict(model.state_dict())
    for (_, p), (_, q) in zip(model.named_parameters(), ref_model.named_parameters()):
        q.requires_grad_(p.requires_grad)
    ref_loss, ref_grads, ref_total_grads = loss_and_grads(ref_model)
    del ref_model
    res = {
        "phase": "train_path", "config": TRAIN_CONFIG, "overrides": TRAIN_OVERRIDES,
        "batch": batch_size, "crop": list(aug_cfg.crop_size), "tokens": 40 * 40 + 1,
        "padded_tokens": 1664, "build_s": build_s, "timed_steps": TRAIN_TIMED_STEPS,
        "ms_per_step": elapsed / TRAIN_TIMED_STEPS * 1e3,
        "samples_per_s": batch_size * TRAIN_TIMED_STEPS / elapsed, "peak_mem_gib": peak_gib,
        "launches": launches,
        "launches_per_step": {k: v / TRAIN_TIMED_STEPS for k, v in launches.items()},
        "losses": [{k: m[k] for k in ("loss_seg", "loss_silog", "loss_total", "lr")}
                   for m in metrics],
        "loss_kernel": kernel_loss, "loss_plain": plain_loss,
        "loss_rel_diff_vs_plain": abs(kernel_loss - plain_loss) / abs(plain_loss),
        "loss_fp32": ref_loss,
        "backbone_seg_grad_rel_l2_vs_plain": rel_l2(kernel_grads, plain_grads),
        "backbone_seg_grad_rel_l2_kernel_vs_fp32": rel_l2(kernel_grads, ref_grads),
        "backbone_seg_grad_rel_l2_plain_vs_fp32": rel_l2(plain_grads, ref_grads),
        "backbone_total_grad_rel_l2_vs_plain": rel_l2(kernel_total_grads, plain_total_grads),
        "backbone_total_grad_rel_l2_kernel_vs_fp32": rel_l2(kernel_total_grads, ref_total_grads),
        "backbone_total_grad_rel_l2_plain_vs_fp32": rel_l2(plain_total_grads, ref_total_grads),
        "host_data_wait_ms_per_step": data_wait_s / TRAIN_TIMED_STEPS * 1e3,
        "tol": TRAIN_TOL, "grad_ratio_limit": TRAIN_GRAD_RATIO,
    }
    del kernel_grads, plain_grads, kernel_total_grads, plain_total_grads, batch
    del ref_grads, ref_total_grads
    # where a training step's device time goes ("frames" are training steps)
    phase_profile(lambda host: step(state, to_device(host, "cuda")),
                  [next(batches) for _ in range(2)], path="training")
    del model, state
    torch.cuda.empty_cache()

    # the user entry point, end to end: loop, loader, checkpoint
    work_dir = "build/train_smoke"
    shutil.rmtree(work_dir, ignore_errors=True)
    summary = train(cfg, work_dir, max_steps=2, no_validate=True, device="cuda")
    ckpt_ok = os.path.exists(os.path.join(work_dir, "checkpoints", "latest"))
    shutil.rmtree(work_dir, ignore_errors=True)
    res["train_entry_point"] = {"summary": summary, "checkpoint_written": ckpt_ok}
    emit(res)
    if not (summary["step"] == 2 and ckpt_ok and np.isfinite(summary["loss_total"])):
        raise AssertionError(f"train() did not run 2 finite steps and save: {summary}")
    if not (res["loss_rel_diff_vs_plain"] <= TRAIN_TOL
            and res["backbone_seg_grad_rel_l2_kernel_vs_fp32"]
            <= TRAIN_GRAD_RATIO * res["backbone_seg_grad_rel_l2_plain_vs_fp32"]):
        raise AssertionError(f"training with the kernels disagrees with plain attention: {res}")
    return res


PROFILE_GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("qkv_attention_bwd (K2)", ("qkv_bwd_",)),
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


def phase_profile(run, frames, path: str = "slide_serving") -> None:
    """Where the device time of one item of `path` goes (torch.profiler):
    `run` is called on each of `frames` (serving frames, training batches)."""
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
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                evt, "is_user_annotation", False):
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
            calls[evt.name] += 1
    by_group = collections.defaultdict(float)
    for name, ms in by_name.items():
        by_group[kernel_group(name)] += ms
    wall_ms, busy_ms = start.elapsed_time(end), sum(by_name.values())
    if busy_ms <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    emit({"phase": "profile", "path": path, "frames": len(frames),
          "wall_ms_per_frame": per_frame(wall_ms),
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
    train_shape = phase_kernel_bwd()
    main_res = phase_main_path()
    train_res = phase_train_path()
    emit({"kernels": [{
        "name": "qkv_attention", "route": "cuda",
        "source": "denseclip_vit_multimodal_tpu_torch/csrc/qkv_attention.cu",
        "replaces": "denseclip_vit_multimodal_tpu/ops/mha_kernel.py:400",
        "launches": main_res["launches"]["qkv_attention"],
        "launches_by_path": {"slide_serving": main_res["launches"]["qkv_attention"],
                             "training": train_res["launches"]["qkv_attention"]},
        "max_abs_err": slide["max_abs_err"], "ms": slide["ms"], "kernel_ms": slide["ms"],
        "plain_ms": slide["plain_ms"],
        "bound_ms": slide["bound_ms"], "bound_by": slide["bound_by"],
        "library_ms": slide["library_ms"],
    }, {
        "name": "qkv_attention_bwd", "route": "cuda",
        "source": "denseclip_vit_multimodal_tpu_torch/csrc/qkv_attention_bwd.cu",
        "replaces": "denseclip_vit_multimodal_tpu/ops/mha_kernel.py:240",
        "launches": train_res["launches"]["qkv_attention_bwd"],
        "launches_by_path": {"slide_serving": main_res["launches"]["qkv_attention_bwd"],
                             "training": train_res["launches"]["qkv_attention_bwd"]},
        "max_abs_err": train_shape["max_abs_err"], "ms": train_shape["ms"],
        "kernel_ms": train_shape["ms"], "plain_ms": train_shape["plain_ms"],
        "bound_ms": train_shape["bound_ms"], "bound_by": train_shape["bound_by"],
        "library_ms": train_shape["library_ms"],
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
