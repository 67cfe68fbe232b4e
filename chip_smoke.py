"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port only (`denseclip_vit_multimodal_tpu_torch`; no JAX), in
phases that each print one JSON line:

  1. device     — card name and power limit, torch / CUDA versions, TF32 off;
  2. build      — compiles every kernel source under `csrc/` (one nvcc each,
                  all started together), with ptxas registers and spills;
  3. kernel     — K1 (qkv attention forward) against its plain PyTorch
                  version on the card (bf16, seeded unit-normal inputs) at the
                  paths' shapes and others, with kernel / plain / library /
                  bound times;
  4. kernel_bwd — K2 (attention backward) the same way, per gradient dq, dk,
                  dv, with dk / dv of masked keys held to exactly 0;
  5. kernel_flash — K4 (long-sequence flash attention forward) the same way
                  at the three long evaluation shapes (views of a fused qkv),
                  a ragged head-dim-128 case and a causal case;
  6. reference  — the full-width model in bf16 on the card against the same
                  model in fp32 on the CPU (plain attention) on one 512x512
                  window;
  7. main_path  — the flagship ViT-B/16 seg+depth preset at full width from a
                  seeded init, slide inference (crop 624, stride 426, window
                  batch 20) over 3 seeded 1024x2048 requests; launch counts,
                  img/s (CUDA events), peak memory, and one frame against
                  plain attention;
  8. profile    — the same 3 requests again under torch.profiler: device time
                  per frame by kernel group, the top kernels, and the device's
                  busy share (kernel time over CUDA-event wall time; one
                  stream, so kernels do not overlap);
  9. train_path — the heritage preset (backbone trained at lr x0.1) at full
                  width, batch 4, crop 640, on synthetic 1024x2048 frames
                  augmented on the card: 1 warm-up and 5 timed steps (CUDA
                  events; ms/step, samples/s, peak memory, K1 / K2 launches
                  per step, losses), one step with the kernels against plain
                  attention and fp32, a profile of 2 steps, and 2 steps plus
                  a validation through the user entry point `train()`, whose
                  checkpoint the next phase evaluates;
 10. eval_path  — the user entry point `tools/test.py` on that checkpoint
                  (the flagship model: the heritage preset's `_base_`):
                  multi-scale (0.5-1.75) + flip whole-frame evaluation with
                  mIoU and depth metrics over 3 synthetic 1024x2048 frames
                  (the first untimed); seconds per frame, peak memory, K1 /
                  K4 launches per frame; one frame at scale 1.25 with the
                  kernels against plain attention; a profile of one frame;
 11. kernel_int8 — K5 (int8 attention) against its plain version on the
                  same quantized operands at the serving shape, the whole
                  frame, head dim 128 and the adversarial pad case, with
                  kernel / prologue / plain / bound times and, for context,
                  the bf16 K1 and SDPA at the same shape;
 12. serve_path — the user entry points `tools/serve.py` (`build_service` on
                  the checkpoint of train_path, `--set tpu.attn_impl=int8`)
                  and `make_server` on 127.0.0.1: one warm-up, 3 seeded
                  1024x2048 frames POSTed as PNG (slide), one `mode=whole`
                  request, /healthz, /metrics, a bad request and one frame
                  with Paeth-filtered rows (the decoder's anti-diagonal
                  path); latency, img/s, PNG decode ms (filter 0 and
                  Paeth), device seconds, peak memory, K5 / K1 /
                  K4 launches per request; the HTTP answer against
                  `predict_array`; one frame with K5 against its plain
                  version (and, reported only, against the bf16 K1 path); a
                  profile of one int8 slide frame;
 13. kernel_oneshot — K3 (one-shot attention on [B, N, H, D]) against its
                  plain version at the slide shape (views of a fused qkv),
                  the self-test's shape, head dim 128 and head dim 256, with
                  kernel / plain / SDPA / bound times;
 14. kernel_lnqkv — K6 (fused LayerNorm + qkv projection + attention)
                  against its plain version at the slide shape, head dim 128
                  and the largest N its rule admits, with kernel / plain /
                  bound times, the unfused chain in PyTorch's own calls
                  (layer_norm + linear + SDPA: `library_ms`) and the port's
                  unfused chain (LayerNorm + Linear + K1);
 15. lnqkv_path — main_path's slide protocol with DENSECLIP_FUSED_LNQKV=1
                  (set only inside this phase): 3 requests, img/s, peak
                  memory, 12 K6 and 0 K1 launches per frame; one frame
                  against the unfused K1 path and against K6's plain
                  version; a `mode=whole` request (8193 tokens: the rule
                  sends it to K1) equal to its unfused answer; a profile;
 16. selftest   — the port's GPU self-test (`tools/selftest.py`), whose
                  checks must all pass;
 17. kernel_oneshot_bwd — K3's backward against its plain version on K3's
                  output and statistics, per gradient, at the heritage
                  training shape [8,1664,12,64] valid 1601 (views of a fused
                  qkv) and at head dim 128, with kernel / plain / SDPA
                  backward / bound times;
 18. kernel_flash_bwd — K4b (the flash backward) the same way at the long
                  training shape [2,9344,12,64] valid 9217, a causal case and
                  a ragged head-dim-128 case; dq of pad rows and dk / dv of
                  pad keys held to exactly 0;
 19. train_long — the heritage preset at full width through the user entry
                  point `train()` on a 1536x1536 crop (9217 tokens, padded
                  to 9344: past the one-shot limit), batch 2: 1 warm-up + 3
                  timed steps with `tpu.remat=false`, the same with
                  `tpu.remat=true`, and one step with plain attention (under
                  remat: its fp32 scores take 8.4 GB a layer); ms/step,
                  samples/s, peak memory, K4 / K4b launches per step; the
                  step-1 losses held against each other; then one step's
                  backbone gradients on fixed weights, batch and masks:
                  remat against none, the kernels (K4b) against plain
                  attention and fp32; what a rerun of the step moves and
                  which ops PyTorch names nondeterministic; a profile of one
                  step;
 20. outproj_path — the port's `tools/exp_outproj_epilogue.py` `main()`: K7
                  against its plain version and against path A (K1 +
                  matmul), the interleaved A / B / A2 / B2 times and the
                  verdict; K7's plain time and bound;
 21. profile_attn_bwd — the port's `tools/profile_attn_bwd.py` `main()` at
                  [8,12,1601,64]: K3, K3's backward, the autograd of plain
                  attention and SDPA's backward.

Then the `kernels` line, the nvidia-smi line and, last, the result line.
Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import struct
import subprocess
import sys
import time
import traceback
import zlib

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
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


def launch_tables():
    """Every kernel wrapper's launch counter (K1 / K2 / K5 / K3 / K3's
    backward, K4 / K4b, K6, K7)."""
    from denseclip_vit_multimodal_tpu_torch.ops.attention import LAUNCHES as FLASH_LAUNCHES
    from denseclip_vit_multimodal_tpu_torch.ops.lnqkv_kernel import LAUNCHES as LNQKV_LAUNCHES
    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import LAUNCHES
    from denseclip_vit_multimodal_tpu_torch.tools.exp_outproj_epilogue import (
        LAUNCHES as OUTPROJ_LAUNCHES,
    )

    return LAUNCHES, FLASH_LAUNCHES, LNQKV_LAUNCHES, OUTPROJ_LAUNCHES


def reset_launches() -> None:
    for table in launch_tables():
        for key in table:
            table[key] = 0


def read_launches() -> dict:
    return {k: v for table in launch_tables() for k, v in table.items()}


def expected_launches(**counts) -> dict:
    """Every counter at 0 but the ones named."""
    return {**{k: 0 for k in read_launches()}, **counts}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def grad_errors(res: dict, got, ref, rows: int, keys: int) -> dict:
    """Per-gradient errors of (dq, dk, dv): dq on rows < `rows`, dk / dv on
    keys < `keys`, into `res`; the largest max abs error in `res`."""
    for part, a, w, lim in zip(("dq", "dk", "dv"), got, ref, (rows, keys, keys)):
        a, w = a[:, :lim].float(), w[:, :lim].float()
        err = (a - w).abs()
        res[part] = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
                     "rel_l2_err": rel_l2(a, w), "max_abs_ref": float(w.abs().max())}
    res["max_abs_err"] = max(res[p]["max_abs_err"] for p in ("dq", "dk", "dv"))
    return res


def grads_out_of_limits(res: dict) -> list:
    """The gradients that break K2's limits (KERNEL_BWD_REL_TOL / _MAX_TOL)."""
    return [p for p in ("dq", "dk", "dv")
            if not (res[p]["rel_l2_err"] <= KERNEL_BWD_REL_TOL
                    and res[p]["max_abs_err"] <= KERNEL_BWD_MAX_TOL * res[p]["max_abs_ref"])]


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
    """Compile every kernel source, one nvcc each, all started together."""
    from denseclip_vit_multimodal_tpu_torch.ops import _build

    start = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - start
    for name in _build.SOURCES:
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
        (1, 8320, 12, 64, 8193, 10),  # whole 1024x2048 frame (and aug-test scale 1.0, at B 2)
        (2, 2176, 12, 64, 2049, 20),  # aug-test scale 0.5 with its flipped view
        (2, 4736, 12, 64, 4609, 10),  # aug-test scale 0.75
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
    return results  # the slide shape (the first) is the main path's


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
    grad_errors(res, got.split(hd, dim=-1), ref.split(hd, dim=-1), n, n)
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
        bad = grads_out_of_limits(res)
        if bad or not (res["finite"] and res["masked_dkdv_exact_zero"]):
            raise AssertionError(f"qkv_attention_bwd disagrees with its plain version ({bad}): {res}")
        results.append(res)
    return results[0]  # the training shape is the main path's


def flash_attention_case(b: int, n: int, heads: int, head_dim: int, valid_len, causal: bool,
                         iters: int) -> dict:
    """K4 (its launching wrapper: `flash_attention` would send a short
    non-causal case to the K3 branch) against its plain version on views of
    one fused qkv, as the ViT hands them over; errors on the rows below
    `valid_len` (the rest are unspecified), every row finite."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops.attention import (
        _launch,
        flash_attention_reference,
    )

    hd = heads * head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (t.view(b, n, heads, head_dim) for t in qkv.split(hd, dim=-1))
    kv = n if valid_len is None else valid_len
    run = lambda: _launch(q, k, v, causal, head_dim**-0.5, kv)
    plain = lambda: flash_attention_reference(q, k, v, causal=causal, valid_len=valid_len)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    err = (out[:, :kv].float() - ref[:, :kv].float())
    # the library yardstick: one fused-attention call on head-split copies
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kh, vh = kh[:, :, :kv].contiguous(), vh[:, :, :kv].contiguous()
    library = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    flops = 4.0 * b * heads * kv * kv * head_dim * (0.5 if causal else 1.0)
    nbytes = 2.0 * (qkv.numel() + out.numel())
    res = {
        "phase": "kernel_flash", "name": "flash_attention", "shape": [b, n, heads, head_dim],
        "valid_len": valid_len, "causal": causal,
        "max_abs_err": float(err.abs().max()), "mean_abs_err": float(err.abs().mean()),
        "rel_l2_err": float(err.norm() / ref[:, :kv].float().norm()),
        "finite": bool(torch.isfinite(out.float()).all()),
        "ms": cuda_ms(run, iters),
        "plain_ms": cuda_ms(plain, 2, warmup=1),
        "library_ms": cuda_ms(library, iters),
        "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
        "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes",
    }
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    return res


# The three long views of multi-scale evaluation on a 1024x2048 frame (scales
# 1.25 / 1.5 / 1.75, with the flipped view: B 2; tokens padded to 128), a
# ragged head-dim-128 case and a causal case.
FLASH_CASES = [
    (2, 12928, 12, 64, 12801, False, 10),
    (2, 18560, 12, 64, 18433, False, 5),
    (2, 25216, 12, 64, 25089, False, 3),
    (2, 1100, 8, 128, 1050, False, 50),
    (2, 2048, 12, 64, None, True, 50),
]


def phase_kernel_flash() -> list:
    results = []
    for case in FLASH_CASES:
        res = flash_attention_case(*case)
        emit(res)
        if not (res["finite"] and res["max_abs_err"] <= KERNEL_TOL
                and res["rel_l2_err"] <= KERNEL_REL_TOL):
            raise AssertionError(f"flash_attention disagrees with its plain version: {res}")
        results.append(res)
    return results


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
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    outs = [predict(frame, fetch) for frame, fetch in zip(frames, ("argmax", "packed", "argmax"))]
    end.record()
    torch.cuda.synchronize()
    elapsed = start.elapsed_time(end) / 1e3  # every request ends in a device-to-host copy
    launches = read_launches()
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
TRAIN_WORK_DIR = "build/train_smoke"  # gitignored; removed by phase serve_path
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


def step_grads(net, batch: dict, texts, crop, seed: int):
    """One training step's forward and backward on fixed weights, an
    augmented batch and the drop-path / dropout masks of `seed`: the total
    loss, the backbone's gradients of the segmentation loss and of the total
    loss (flat fp32), and every leaf's gradient of the total loss by name."""
    from denseclip_vit_multimodal_tpu_torch.train.losses import cross_entropy_loss, silog_loss

    net.zero_grad(set_to_none=True)
    out = net(batch["image"], texts, train=True, gt_hw=crop,
              gen=torch.Generator(device="cuda").manual_seed(seed))
    seg = cross_entropy_loss(out["seg"], batch["seg"])
    silog = 0.1 * silog_loss(out["depth"], batch["depth"], batch["depth_mask"])
    grads = lambda: torch.cat([p.grad.float().flatten() for p in net.backbone.parameters()
                               if p.grad is not None])  # `proj` is unused
    seg.backward(retain_graph=True)
    seg_grads = grads()
    silog.backward()
    leaves = {name: p.grad.float().clone() for name, p in net.named_parameters()
              if p.grad is not None}
    total = float((seg + silog).detach())
    net.zero_grad(set_to_none=True)
    return total, seg_grads, torch.cat([g.flatten() for name, g in leaves.items()
                                        if name.startswith("backbone.")]), leaves

def fp32_twin(model, model_cfg, seed: int, remat=False):
    """`model`'s weights in an fp32 model (plain attention: the kernels take
    bf16), trainable where `model` is."""
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )

    twin, _ = build_denseclip(model_cfg, CITYSCAPES_CLASSES, dtype=torch.float32, device="cuda",
                              seed=seed, remat=remat)
    twin.load_state_dict(model.state_dict())
    for (_, p), (_, q) in zip(model.named_parameters(), twin.named_parameters()):
        q.requires_grad_(p.requires_grad)
    return twin

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
    reset_launches()
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
    launches = read_launches()
    elapsed = begin.elapsed_time(end) / 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for m in metrics:
        if m["skipped"] or not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite training step: {m}")
    want = expected_launches(qkv_attention=12 * TRAIN_TIMED_STEPS,
                             qkv_attention_bwd=12 * TRAIN_TIMED_STEPS)
    if launches != want:
        raise AssertionError(f"expected {want} launches over {TRAIN_TIMED_STEPS} steps, got {launches}")

    # one step's loss and backbone gradients, kernels vs plain attention: the
    # same weights, the same augmented batch, the same dropout masks
    batch = augment_batch(to_device(next(batches), "cuda"), aug_cfg, torch.Generator().manual_seed(seed))
    loss_and_grads = lambda net: step_grads(net, batch, texts, tuple(aug_cfg.crop_size), seed)
    before = dict(LAUNCHES)
    kernel_loss, kernel_grads, kernel_total_grads = loss_and_grads(model)[:3]
    if LAUNCHES["qkv_attention_bwd"] - before["qkv_attention_bwd"] != 24:
        raise AssertionError("the kernel step did not run K2 in every layer")
    set_attn_impl(model, "xla")
    plain_loss, plain_grads, plain_total_grads = loss_and_grads(model)[:3]
    set_attn_impl(model, "auto")
    model.zero_grad(set_to_none=True)
    # the same weights in fp32 (plain attention: the kernels take bf16) as the
    # yardstick both bf16 paths are measured against
    ref_model = fp32_twin(model, cfg.model, seed)
    ref_loss, ref_grads, ref_total_grads = loss_and_grads(ref_model)[:3]
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

    # the user entry point, end to end: loop, loader, validation, checkpoint
    # (8 synthetic frames: 2 training batches, and 2 validation batches at crop 640);
    # the checkpoint stays for phase eval_path
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    entry_cfg = load_config(TRAIN_CONFIG,
                            overrides=TRAIN_OVERRIDES + ["data.synthetic_options.length=8"])
    summary = train(entry_cfg, TRAIN_WORK_DIR, max_steps=2, no_validate=False, device="cuda")
    ckpt_ok = os.path.exists(os.path.join(TRAIN_WORK_DIR, "checkpoints", "latest"))
    res["train_entry_point"] = {"summary": summary, "checkpoint_written": ckpt_ok}
    emit(res)
    val_keys = ("miou", "pixel_acc", "depth_abs_rel", "depth_rmse", "val_loss_seg")
    if not (summary["step"] == 2 and ckpt_ok and np.isfinite(summary["loss_total"])
            and all(np.isfinite(summary.get(k, float("nan"))) for k in val_keys)):
        raise AssertionError(f"train() did not run 2 finite steps, validate and save: {summary}")
    if not (res["loss_rel_diff_vs_plain"] <= TRAIN_TOL
            and res["backbone_seg_grad_rel_l2_kernel_vs_fp32"]
            <= TRAIN_GRAD_RATIO * res["backbone_seg_grad_rel_l2_plain_vs_fp32"]):
        raise AssertionError(f"training with the kernels disagrees with plain attention: {res}")
    return res


EVAL_FRAMES = 3  # the first pays the one-time set-up and is not timed
EVAL_OVERRIDES = ["data.synthetic=true", "data.synthetic_options.image_size=[1024,2048]",
                  f"data.synthetic_options.length={EVAL_FRAMES}"]
# per frame: 3 scales (0.5 / 0.75 / 1.0: K1; 1.25 / 1.5 / 1.75: K4) x 12 layers
AUG_VIEW_LAUNCHES = {"qkv_attention": 36, "flash_attention": 36}
TEXT_TOKENS = 22  # the text tower's context length (6 fixed + 16 learnable)


def phase_eval_path() -> dict:
    """Multi-scale + flip evaluation through the user entry point
    `tools/test.py`, on the checkpoint phase train_path wrote."""
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.models import layers
    from denseclip_vit_multimodal_tpu_torch.models.layers import set_attn_impl
    from denseclip_vit_multimodal_tpu_torch.ops import attention
    from denseclip_vit_multimodal_tpu_torch.ops.attention import LAUNCHES as FLASH_LAUNCHES
    from denseclip_vit_multimodal_tpu_torch.tools.test import main as test_main

    # count the plain-attention calls of the evaluation (the text tower's,
    # cached once per model, included): the ViT's must all go to K1 / K4
    plain_calls = collections.Counter()
    plain = attention.plain_attention

    def counted_plain(q, *args, **kwargs):
        plain_calls[q.shape[1]] += 1
        return plain(q, *args, **kwargs)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = time.perf_counter()
    layers.plain_attention = attention.plain_attention = counted_plain
    try:
        results = test_main([CONFIG, TRAIN_WORK_DIR, "--aug-test", "--mode", "whole",
                             "--eval", "mIoU", "depth", "--set", *EVAL_OVERRIDES])
    finally:
        layers.plain_attention = attention.plain_attention = plain
    wall_s = time.perf_counter() - start
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    keys = ["mIoU", "pixel_acc"] + [f"depth/{k}" for k in
                                    ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")]
    res = {
        "phase": "eval_path", "config": CONFIG, "checkpoint": "phase train_path's train()",
        "protocol": "aug_test whole, scales 0.5-1.75, flip", "frames": EVAL_FRAMES,
        "timed_frames": EVAL_FRAMES - 1, "frame": [1024, 2048],
        "s_per_frame": 1.0 / results["images_per_sec"],
        "images_per_sec": results["images_per_sec"], "entry_point_wall_s": wall_s,
        "peak_mem_gib": peak_gib, "launches": launches,
        "launches_per_frame": {k: v / EVAL_FRAMES for k, v in launches.items()},
        "plain_attention_calls_by_tokens": dict(plain_calls),
        "metrics": {k: results.get(k) for k in keys},
    }
    emit(res)
    want = {k: n * EVAL_FRAMES for k, n in AUG_VIEW_LAUNCHES.items()}
    if launches != expected_launches(**want):
        raise AssertionError(f"expected {want} launches over {EVAL_FRAMES} frames, got {launches}")
    if set(plain_calls) - {TEXT_TOKENS}:  # only the text tower's 22 tokens may take it
        raise AssertionError(f"ViT attention reached plain attention: {dict(plain_calls)}")
    if not all(results.get(k) is not None and np.isfinite(results[k]) for k in keys):
        raise AssertionError(f"non-finite evaluation metrics: {res['metrics']}")

    # one frame at scale 1.25 (12928 tokens: K4), kernels against plain attention
    cfg = load_config(CONFIG)
    model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.bfloat16,
                                   device="cuda", seed=SEED)
    engine = Inferencer(model, texts, num_classes=19)
    frame = np.random.RandomState(SEED).randint(0, 256, (1, 1024, 2048, 3), dtype=np.uint8)
    one_view = lambda: engine.aug_test(frame, scales=(1.25,), flip=False, fetch="device")
    before = FLASH_LAUNCHES["flash_attention"]
    kernel_out = one_view()
    flash_launched = FLASH_LAUNCHES["flash_attention"] - before
    set_attn_impl(model, "xla")
    plain_out = one_view()
    set_attn_impl(model, "auto")
    check = {
        "phase": "eval_path_vs_plain", "scale": 1.25, "flip": False, "tokens": 12801,
        "flash_launches": flash_launched,
        "seg_rel_l2_vs_plain": rel_l2(kernel_out["seg_logits"], plain_out["seg_logits"]),
        "depth_rel_l2_vs_plain": rel_l2(kernel_out["depth"], plain_out["depth"]),
        "tol": PATH_TOL,
    }
    emit(check)
    del kernel_out, plain_out
    if flash_launched != 12 or FLASH_LAUNCHES["flash_attention"] != before + 12:
        raise AssertionError(f"the kernel view did not run K4 in every layer: {check}")
    if not max(check["seg_rel_l2_vs_plain"], check["depth_rel_l2_vs_plain"]) <= PATH_TOL:
        raise AssertionError(f"aug_test with the kernels disagrees with plain attention: {check}")
    torch.cuda.empty_cache()
    phase_profile(lambda f: engine.aug_test(f, fetch="device"), [frame], path="aug_test")
    res["vs_plain"] = check
    return res


def qkv_attention_int8_case(b: int, n: int, heads: int, head_dim: int, valid_len,
                            adversarial: bool, iters: int) -> dict:
    """K5 (its launching wrapper) against its plain version on the same
    quantized operands; errors on the rows below `valid_len`, every row
    finite.  The prologue (quantization and V's key-major copy) is timed
    apart; the bf16 K1 and SDPA at the same shape are context."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
        _launch,
        _launch_int8,
        int8_attention_plain,
        quantize_qkv_int8,
        value_key_major,
    )

    hd = heads * head_dim
    kv = n if valid_len is None else valid_len
    scale = head_dim**-0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda")
    if adversarial:  # every real score far below zero; zero pad rows past valid_len
        qkv[..., :hd] = -qkv[..., :hd].abs() * 20.0
        qkv[..., hd:2 * hd] = qkv[..., hd:2 * hd].abs()
        qkv[:, kv:] = 0.0
    qkv = qkv.to(torch.bfloat16)
    prologue = lambda: quantize_qkv_int8(qkv, heads, kv)
    q8, scales = prologue()
    vt = value_key_major(q8, heads)
    run = lambda: _launch_int8(q8, vt, scales, heads, scale, kv, qkv.dtype)
    plain = lambda: int8_attention_plain(q8, scales, heads, scale, kv, qkv.dtype)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    err = out[:, :kv].float() - ref[:, :kv].float()
    ops = 4.0 * b * heads * n * kv * head_dim  # int8 Q K^T and P V
    nbytes = q8.numel() + 4.0 * scales.numel() + out.numel() * out.element_size()
    # the prologue reads qkv twice (amax, then the rounding) and writes q8 and V's copy
    prologue_bytes = 2.0 * qkv.numel() * qkv.element_size() + q8.numel() + vt.numel()
    qh, kh, vh = (t.reshape(b, n, heads, head_dim).transpose(1, 2).contiguous()
                  for t in qkv.split(hd, dim=-1))
    kh, vh = kh[:, :, :kv].contiguous(), vh[:, :, :kv].contiguous()
    res = {
        "phase": "kernel_int8", "name": "qkv_attention_int8", "shape": [b, n, 3 * hd],
        "heads": heads, "head_dim": head_dim, "valid_len": valid_len, "adversarial": adversarial,
        "max_abs_err": float(err.abs().max()), "mean_abs_err": float(err.abs().mean()),
        "rel_l2_err": float(err.norm() / ref[:, :kv].float().norm()),
        "max_abs_out": float(out[:, :kv].float().abs().max()),
        "finite": bool(torch.isfinite(out.float()).all()),
        "ms": cuda_ms(run, iters),
        "prologue_ms": cuda_ms(lambda: value_key_major(prologue()[0], heads), iters),
        "plain_ms": cuda_ms(plain, max(iters // 10, 2), warmup=1),
        "library_ms": None,  # no PyTorch call computes int8 attention
        "bound_ms": max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3,
        "bound_by": "operations" if ops / PEAK_INT8_OPS >= nbytes / PEAK_BYTES else "bytes",
        "prologue_bound_ms": prologue_bytes / PEAK_BYTES * 1e3,
        "k1_bf16_ms": cuda_ms(lambda: _launch(qkv, heads, scale, kv), iters),
        "sdpa_bf16_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters),
    }
    res["tops"] = ops / (res["ms"] * 1e-3) / 1e12
    return res


INT8_CASES = [
    # (b, n, heads, head_dim, valid_len, adversarial, iters)
    (10, 1536, 12, 64, 1522, False, 50),  # slide window batch: the serving shape
    (1, 8320, 12, 64, 8193, False, 10),  # a mode=whole request (8193 tokens, padded once)
    (2, 1100, 8, 128, 1050, False, 50),  # head dim 128
    (1, 256, 2, 64, 200, True, 50),  # adversarial pads (tests/test_int8_attention.py)
]


def phase_kernel_int8() -> list:
    results = []
    for case in INT8_CASES:
        res = qkv_attention_int8_case(*case)
        emit(res)
        if not (res["finite"] and res["max_abs_err"] <= KERNEL_TOL
                and res["rel_l2_err"] <= KERNEL_REL_TOL and res["max_abs_out"] > 1e-3):
            raise AssertionError(f"qkv_attention_int8 disagrees with its plain version: {res}")
        results.append(res)
    return results  # the serving shape (the first) is the main path's


def mha_attention_case(b: int, n: int, heads: int, head_dim: int, valid_len, strided: bool,
                       iters: int) -> dict:
    """K3 (through `mha_attention`) against its plain version; errors on the
    rows below `valid_len` (the rest are unspecified), every row finite."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
        mha_attention,
        mha_attention_reference,
    )

    hd = heads * head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if strided:  # views of one fused qkv projection, as the ViT hands them over
        qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = (t.view(b, n, heads, head_dim) for t in qkv.split(hd, dim=-1))
    else:
        q, k, v = (torch.randn(b, n, heads, head_dim, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
    kv = n if valid_len is None else valid_len
    run = lambda: mha_attention(q, k, v, valid_len=valid_len)
    plain = lambda: mha_attention_reference(q, k, v, valid_len=valid_len)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    err = out[:, :kv].float() - ref[:, :kv].float()
    # the library yardstick: one fused-attention call on head-split copies
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kh, vh = kh[:, :, :kv].contiguous(), vh[:, :, :kv].contiguous()
    flops = 4.0 * b * heads * n * kv * head_dim
    nbytes = 2.0 * (3 * q.numel() + out.numel())
    res = {
        "phase": "kernel_oneshot", "name": "mha_attention", "shape": [b, n, heads, head_dim],
        "valid_len": valid_len, "strided": strided,
        "max_abs_err": float(err.abs().max()), "mean_abs_err": float(err.abs().mean()),
        "rel_l2_err": float(err.norm() / ref[:, :kv].float().norm()),
        "finite": bool(torch.isfinite(out.float()).all()),
        "ms": cuda_ms(run, iters),
        "plain_ms": cuda_ms(plain, max(iters // 10, 2), warmup=1),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters),
        "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
        "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes",
    }
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    return res


ONESHOT_CASES = [
    # (b, n, heads, head_dim, valid_len, strided, iters)
    (10, 1536, 12, 64, 1522, True, 50),  # the slide shape, views of a fused qkv
    (2, 1601, 12, 64, None, False, 50),  # the self-test's shape
    (2, 1100, 8, 128, 1050, True, 50),  # head dim 128, ragged
    (2, 2048, 3, 256, None, False, 50),  # head dim 256 (the JAX rule admits it; K1 does not)
]


def phase_kernel_oneshot() -> list:
    results = []
    for case in ONESHOT_CASES:
        res = mha_attention_case(*case)
        emit(res)
        if not (res["finite"] and res["max_abs_err"] <= KERNEL_TOL
                and res["mean_abs_err"] <= KERNEL_MEAN_TOL and res["rel_l2_err"] <= KERNEL_REL_TOL):
            raise AssertionError(f"mha_attention disagrees with its plain version: {res}")
        results.append(res)
    return results  # the slide shape (the first) is the K3 row's


def ln_qkv_attention_case(b: int, n: int, dim: int, heads: int, valid_len, iters: int) -> dict:
    """K6 against its plain version on a seeded x and seeded ln_1 / qkv
    parameters at the scale of the model's init (W bf16, handed over as the
    transposed view of the torch Linear layout: no cast inside the timing);
    beside it, the same function unfused in PyTorch's own calls and in the
    port's (LayerNorm, Linear, K1)."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.models.layers import layer_norm_apply
    from denseclip_vit_multimodal_tpu_torch.ops.lnqkv_kernel import (
        ln_qkv_attention,
        ln_qkv_attention_reference,
    )
    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import mha_qkv_attention

    hd, d = dim, dim // heads
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(b, n, dim, generator=gen, device="cuda").to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(dim, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(dim, generator=gen, device="cuda")
    limit = (6.0 / (4 * dim)) ** 0.5  # xavier-uniform of the [D, 3D] kernel
    w16 = ((torch.rand(3 * dim, dim, generator=gen, device="cuda") * 2 - 1) * limit).to(torch.bfloat16)
    bias = 0.02 * torch.randn(3 * dim, generator=gen, device="cuda")
    kv = n if valid_len is None else valid_len
    args = (x, gamma, beta, w16.t(), bias, heads)
    run = lambda: ln_qkv_attention(*args, valid_len=valid_len)
    plain = lambda: ln_qkv_attention_reference(*args, valid_len=valid_len)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    err = out[:, :kv].float() - ref[:, :kv].float()
    g16, b16, bias16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16), bias.to(torch.bfloat16)

    def library():  # F.layer_norm + F.linear + SDPA, bf16 parameters
        qkv = F.linear(F.layer_norm(x, (dim,), g16, b16, 1e-5), w16, bias16)
        q, k, v = (t.view(b, n, heads, d).transpose(1, 2) for t in qkv.split(hd, dim=-1))
        return F.scaled_dot_product_attention(q, k[:, :, :kv], v[:, :, :kv])

    qkv = F.linear(layer_norm_apply(x, gamma, beta), w16, bias16)
    port_unfused = lambda: mha_qkv_attention(
        F.linear(layer_norm_apply(x, gamma, beta), w16, bias16), heads, valid_len=valid_len)
    proj_flops = 2.0 * b * n * dim * 3 * hd
    attn_flops = 4.0 * b * heads * n * kv * d
    flops = proj_flops + attn_flops
    nbytes = 2.0 * (x.numel() + w16.numel() + out.numel()) + 4.0 * (2 * dim + 3 * hd)
    res = {
        "phase": "kernel_lnqkv", "name": "ln_qkv_attention", "shape": [b, n, dim], "heads": heads,
        "head_dim": d, "valid_len": valid_len,
        "max_abs_err": float(err.abs().max()), "mean_abs_err": float(err.abs().mean()),
        "rel_l2_err": float(err.norm() / ref[:, :kv].float().norm()),
        "finite": bool(torch.isfinite(out.float()).all()),
        "ms": cuda_ms(run, iters),
        "plain_ms": cuda_ms(plain, max(iters // 10, 2), warmup=1),
        "library_ms": cuda_ms(library, iters),
        "port_unfused_ms": cuda_ms(port_unfused, iters),
        "k1_alone_ms": cuda_ms(lambda: mha_qkv_attention(qkv, heads, valid_len=valid_len), iters),
        "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
        "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes",
        "projection_bound_ms": proj_flops / PEAK_BF16_FLOPS * 1e3,
    }
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    return res


LNQKV_CASES = [
    # (b, n, dim, heads, valid_len, iters)
    (10, 1536, 768, 12, 1522, 50),  # the slide window batch: the fused path's shape
    (2, 1100, 768, 6, 1050, 50),  # head dim 128
    (1, 3968, 768, 12, None, 20),  # the largest N lnqkv_supported admits at D 768
]


def phase_kernel_lnqkv() -> list:
    results = []
    for case in LNQKV_CASES:
        res = ln_qkv_attention_case(*case)
        emit(res)
        if not (res["finite"] and res["max_abs_err"] <= KERNEL_TOL
                and res["mean_abs_err"] <= KERNEL_MEAN_TOL and res["rel_l2_err"] <= KERNEL_REL_TOL):
            raise AssertionError(f"ln_qkv_attention disagrees with its plain version: {res}")
        results.append(res)
    return results  # the slide shape (the first) is the main path's


FUSED_ENV = "DENSECLIP_FUSED_LNQKV"


def phase_lnqkv_path() -> dict:
    """main_path's slide protocol with the fused LN + qkv + attention kernel
    (DENSECLIP_FUSED_LNQKV=1, set here and unset on the way out)."""
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config, resolve_test_protocol
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.models import layers
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.ops.lnqkv_kernel import ln_qkv_attention_reference

    cfg = load_config(CONFIG)
    crop, stride, window_batch = resolve_test_protocol(cfg)
    model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.bfloat16,
                                   device="cuda", seed=SEED)
    engine = Inferencer(model, texts, num_classes=19)
    rs = np.random.RandomState(SEED)  # main_path's frames
    frames = [rs.randint(0, 256, (1, 1024, 2048, 3), dtype=np.uint8) for _ in range(3)]
    predict = lambda frame, fetch, mode="slide": engine.predict(
        frame, mode=mode, crop=crop, stride=stride, window_batch=window_batch, fetch=fetch)
    delta = lambda before: {k: v - before[k] for k, v in read_launches().items()}

    torch.cuda.empty_cache()
    previous = os.environ.get(FUSED_ENV)
    os.environ[FUSED_ENV] = "1"
    try:
        predict(frames[0], "argmax")  # warm-up: cuDNN plans, the cached text tower
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outs = [predict(f, fetch) for f, fetch in zip(frames, ("argmax", "packed", "argmax"))]
        end.record()
        torch.cuda.synchronize()
        elapsed = start.elapsed_time(end) / 1e3
        launches = read_launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        fused_out = predict(frames[0], "device")
        kernel_fn = layers.ln_qkv_attention
        layers.ln_qkv_attention = ln_qkv_attention_reference  # K6's plain version, same frame
        before = read_launches()
        try:
            plain_out = predict(frames[0], "device")
        finally:
            layers.ln_qkv_attention = kernel_fn
        plain_launches = delta(before)
        before = read_launches()
        whole_fused = predict(frames[0], "device", mode="whole")
        whole_launches = delta(before)
        phase_profile(lambda f: predict(f, "argmax"), frames[:2], path="fused_lnqkv_serving")
    finally:
        if previous is None:
            os.environ.pop(FUSED_ENV, None)
        else:
            os.environ[FUSED_ENV] = previous
    before = read_launches()
    unfused_out = predict(frames[0], "device")  # the K1 path: the variable unset
    unfused_launches = delta(before)
    whole_unfused = predict(frames[0], "device", mode="whole")

    for out in outs:
        for key in ("seg", "depth"):
            arr = out[key]
            if arr.shape != (1, 1024, 2048) or not np.isfinite(arr.astype(np.float32)).all():
                raise AssertionError(f"bad {key}: shape {arr.shape}")
        if not (0 <= out["seg"].min() and out["seg"].max() < 19):
            raise AssertionError("seg labels out of range")
    # the same unfused computation twice: equal up to any run-to-run order of the
    # library kernels' sums
    whole_diff = max(float((whole_fused[k].float() - whole_unfused[k].float()).abs().max())
                     for k in ("seg_logits", "depth"))
    whole_equal = max(rel_l2(whole_fused[k], whole_unfused[k]) for k in ("seg_logits", "depth")) <= 1e-6
    res = {
        "phase": "lnqkv_path", "config": CONFIG, "env": {FUSED_ENV: "1"}, "crop": crop,
        "stride": stride, "window_batch": window_batch, "frames": len(frames),
        "frame": [1024, 2048], "launches": launches,
        "launches_per_frame": {k: v / len(frames) for k, v in launches.items()},
        "img_per_s": len(frames) / elapsed, "ms_per_frame": elapsed / len(frames) * 1e3,
        "peak_mem_gib": peak_gib,
        "seg_rel_l2_vs_unfused": rel_l2(fused_out["seg_logits"], unfused_out["seg_logits"]),
        "depth_rel_l2_vs_unfused": rel_l2(fused_out["depth"], unfused_out["depth"]),
        "seg_rel_l2_vs_k6_plain": rel_l2(fused_out["seg_logits"], plain_out["seg_logits"]),
        "depth_rel_l2_vs_k6_plain": rel_l2(fused_out["depth"], plain_out["depth"]),
        "seg_argmax_agreement_vs_unfused": float(
            (fused_out["seg"] == unfused_out["seg"]).float().mean()),
        "k6_plain_run_launches": plain_launches, "unfused_run_launches": unfused_launches,
        "whole_request": {"tokens": 8193, "launches": whole_launches,
                          "equals_unfused": whole_equal, "max_abs_diff_vs_unfused": whole_diff},
        "tol": PATH_TOL,
    }
    emit(res)
    want = {k: 0 for k in launches}
    if launches != dict(want, ln_qkv_attention=12 * len(frames)):
        raise AssertionError(f"expected 12 ln_qkv_attention launches per frame and no other: "
                             f"{launches}")
    if plain_launches != want or unfused_launches != dict(want, qkv_attention=12):
        raise AssertionError(f"the comparison runs took the wrong route: {res}")
    if whole_launches != dict(want, qkv_attention=12) or not whole_equal:
        raise AssertionError(f"the whole-frame request did not take the unfused K1 path: {res}")
    if not max(res["seg_rel_l2_vs_unfused"], res["depth_rel_l2_vs_unfused"],
               res["seg_rel_l2_vs_k6_plain"], res["depth_rel_l2_vs_k6_plain"]) <= PATH_TOL:
        raise AssertionError(f"the fused path disagrees: {res}")
    return res


def phase_selftest() -> dict:
    """The port's GPU self-test through its `main()`: every check must pass."""
    import contextlib
    import io

    from denseclip_vit_multimodal_tpu_torch.tools.selftest import main as selftest_main

    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = selftest_main([])
    launches = read_launches()
    lines = buf.getvalue().splitlines()
    res = {"phase": "selftest", "rc": rc, "lines": lines, "launches": launches}
    emit(res)
    if rc != 0 or "SELFTEST OK" not in lines or not launches["mha_attention"]:
        raise AssertionError(f"the self-test failed: {res}")
    return res


SERVE_FRAMES = 3
SERVE_ARGS = ["--mode", "slide", "--device-timeout", "120", "--set", "tpu.attn_impl=int8"]


def _paeth_png(frame: np.ndarray) -> bytes:
    """`frame` as a PNG whose rows all carry the Paeth filter, as encoders
    pick it for most rows of a photograph: the decoder's anti-diagonal path
    (the server's own bodies above use filter 0)."""
    from denseclip_vit_multimodal_tpu_torch.utils import png

    x = frame.astype(np.int16)
    a = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1]  # left
    b = np.pad(x, ((1, 0), (0, 0), (0, 0)))[:-1]  # up
    c = np.pad(x, ((1, 0), (1, 0), (0, 0)))[:-1, :-1]  # upper left
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = ((x - pred) % 256).astype(np.uint8).reshape(frame.shape[0], -1)
    raw = np.concatenate([np.full((frame.shape[0], 1), 4, np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", frame.shape[1], frame.shape[0], 8, 2, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + png._chunk(b"IEND", b""))


def _http(port: int, method: str, path: str, body=None):
    from http.client import HTTPConnection

    conn = HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    out = resp.status, resp.getheader("Content-Type"), resp.read()
    conn.close()
    return out


def phase_serve_path() -> dict:
    """The flagship served over HTTP with the int8 attention: the user entry
    points `tools/serve.py` (`build_service`) and `make_server`, on the
    checkpoint phase train_path wrote."""
    import io
    import shutil
    import threading

    from denseclip_vit_multimodal_tpu_torch.infer.server import make_server
    from denseclip_vit_multimodal_tpu_torch.models import layers
    from denseclip_vit_multimodal_tpu_torch.models.layers import set_attn_impl
    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
        LAUNCHES,
        mha_qkv_attention_int8_reference,
    )
    from denseclip_vit_multimodal_tpu_torch.tools import serve as serve_tool
    from denseclip_vit_multimodal_tpu_torch.utils import png

    torch.cuda.empty_cache()
    start = time.perf_counter()
    service, epoch = serve_tool.build_service(
        serve_tool.parse_args([CONFIG, TRAIN_WORK_DIR] + SERVE_ARGS))
    build_s = time.perf_counter() - start
    shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    rs = np.random.RandomState(SEED + 1)
    frames = [rs.randint(0, 256, (1024, 2048, 3), dtype=np.uint8) for _ in range(SERVE_FRAMES)]
    bodies = [png.encode_png(f, level=1) for f in frames]  # the client's side, untimed
    decode_s = []
    for body in bodies:
        tick = time.perf_counter()
        png.decode_png(body)
        decode_s.append(time.perf_counter() - tick)
    paeth_body = _paeth_png(frames[0])
    paeth_decode_s = []
    for _ in range(3):
        tick = time.perf_counter()
        pixels = png.decode_png(paeth_body)
        paeth_decode_s.append(time.perf_counter() - tick)
    if not np.array_equal(pixels, frames[0]):
        raise AssertionError("the Paeth-filtered PNG does not decode to its frame")
    start = time.perf_counter()
    service.warmup((1024, 2048))
    warmup_s = time.perf_counter() - start
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        device_s0 = service.stats.device_seconds_total
        reset_launches()
        latencies, per_request, answers = [], [], []
        for body in bodies:
            before = read_launches()
            tick = time.perf_counter()
            status, ctype, data = _http(port, "POST", "/v1/predict", body)
            latencies.append(time.perf_counter() - tick)
            after = read_launches()
            per_request.append({k: after[k] - before[k] for k in after})
            if status != 200 or ctype != "application/octet-stream":
                raise AssertionError(f"slide request answered {status}: {data[:200]}")
            answers.append(np.load(io.BytesIO(data)))
        launches = read_launches()
        device_s = service.stats.device_seconds_total - device_s0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        before = read_launches()
        tick = time.perf_counter()
        status, _, data = _http(port, "POST", "/v1/predict?mode=whole", bodies[0])
        whole_s = time.perf_counter() - tick
        whole = {k: v - before[k] for k, v in read_launches().items()}
        whole_ok = status == 200 and np.load(io.BytesIO(data))["seg"].shape == (1024, 2048)
        health = json.loads(_http(port, "GET", "/healthz")[2])
        metrics = _http(port, "GET", "/metrics")[2].decode()
        bad_status = _http(port, "POST", "/v1/predict?format=bmp", bodies[0])[0]
        tick = time.perf_counter()
        status, _, data = _http(port, "POST", "/v1/predict", paeth_body)
        paeth_s = time.perf_counter() - tick
        paeth_ok = status == 200 and np.load(io.BytesIO(data))["seg"].shape == (1024, 2048)
    finally:
        server.shutdown()
        server.server_close()
        service.close()

    for ans in answers:
        for key in ("seg", "depth"):
            arr = ans[key]
            if arr.shape != (1024, 2048) or not np.isfinite(arr.astype(np.float32)).all():
                raise AssertionError(f"bad {key} over HTTP: shape {arr.shape}")
        if not (0 <= ans["seg"].min() and ans["seg"].max() < 19):
            raise AssertionError("seg labels out of range")
    direct = service.predict_array(frames[0], timeout=None)  # the same frame, no HTTP
    http_equal = (np.array_equal(answers[0]["seg"], direct["seg"])
                  and np.allclose(answers[0]["depth"], direct["depth"], rtol=1e-6, atol=0.0))

    # one frame: K5 against its plain version, then (reported only) the bf16 K1 path
    engine = service.inferencer
    predict = lambda: engine.predict(frames[0][None], mode="slide", crop=service.crop,
                                     stride=service.stride, window_batch=service.window_batch,
                                     fetch="device")
    kernel_out = predict()
    fused = layers.mha_qkv_attention_int8
    layers.mha_qkv_attention_int8 = mha_qkv_attention_int8_reference
    before = LAUNCHES["qkv_attention_int8"]
    try:
        plain_out = predict()
    finally:
        layers.mha_qkv_attention_int8 = fused
    plain_launched = LAUNCHES["qkv_attention_int8"] - before
    set_attn_impl(engine.model.backbone, "auto")
    before = LAUNCHES["qkv_attention"]
    bf16_out = predict()
    k1_launched = LAUNCHES["qkv_attention"] - before
    set_attn_impl(engine.model.backbone, "int8")
    res = {
        "phase": "serve_path", "config": CONFIG, "checkpoint": "phase train_path's train()",
        "epoch": epoch, "args": SERVE_ARGS, "crop": list(service.crop),
        "stride": list(service.stride), "window_batch": service.window_batch,
        "frames": SERVE_FRAMES, "frame": [1024, 2048], "build_s": build_s, "warmup_s": warmup_s,
        "latency_ms": [t * 1e3 for t in latencies],
        "img_per_s": SERVE_FRAMES / sum(latencies),
        "device_s_per_request": device_s / SERVE_FRAMES,
        "png_bytes": len(bodies[0]), "png_decode_ms": [t * 1e3 for t in decode_s],
        "paeth_png_bytes": len(paeth_body),
        "paeth_png_decode_ms": [t * 1e3 for t in paeth_decode_s],
        "paeth_request": {"ok": paeth_ok, "latency_ms": paeth_s * 1e3},
        "peak_mem_gib": peak_gib, "launches": launches, "launches_per_request": per_request,
        "whole_request": {"ok": whole_ok, "latency_ms": whole_s * 1e3, "launches": whole},
        "healthz": health, "metrics": metrics.splitlines(), "bad_request_status": bad_status,
        "http_equals_predict_array": http_equal,
        "seg_rel_l2_vs_int8_plain": rel_l2(kernel_out["seg_logits"], plain_out["seg_logits"]),
        "depth_rel_l2_vs_int8_plain": rel_l2(kernel_out["depth"], plain_out["depth"]),
        "int8_plain_launches": plain_launched,
        "seg_rel_l2_int8_vs_bf16_k1": rel_l2(kernel_out["seg_logits"], bf16_out["seg_logits"]),
        "depth_rel_l2_int8_vs_bf16_k1": rel_l2(kernel_out["depth"], bf16_out["depth"]),
        "seg_argmax_agreement_int8_vs_bf16_k1": float(
            (kernel_out["seg"] == bf16_out["seg"]).float().mean()),
        "k1_launches_bf16_run": k1_launched, "tol": PATH_TOL,
    }
    emit(res)
    del kernel_out, plain_out, bf16_out
    want = expected_launches(qkv_attention_int8=12)
    if any(r != want for r in per_request) or whole != want:
        raise AssertionError(f"expected {want} launches per request: {per_request}, whole {whole}")
    if not (whole_ok and paeth_ok and health["status"] == "ok" and bad_status == 400
            and http_equal and "denseclip_requests_total" in metrics):
        raise AssertionError(f"the server broke its contract: {res}")
    if plain_launched or k1_launched != 12:
        raise AssertionError(f"the comparison runs took the wrong route: {res}")
    if not max(res["seg_rel_l2_vs_int8_plain"], res["depth_rel_l2_vs_int8_plain"]) <= PATH_TOL:
        raise AssertionError(f"serving with K5 disagrees with its plain version: {res}")
    phase_profile(lambda frame: engine.predict(frame[None], mode="slide", crop=service.crop,
                                               stride=service.stride,
                                               window_batch=service.window_batch,
                                               fetch="argmax"),
                  frames[:2], path="int8_serving")
    return res


def sdpa_backward(q, k, v, dout, kv: int, causal: bool = False):
    """The library yardstick: the backward of one fused-attention call on
    head-split copies of the valid rows and keys (timed only; the port never
    calls it).  Returns the closure to time."""
    import torch.nn.functional as F

    qh, kh, vh = (t[:, :kv].transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    grad = dout[:, :kv].transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qh, kh, vh), grad, retain_graph=True)


def mha_attention_bwd_case(b: int, n: int, heads: int, head_dim: int, valid_len,
                           iters: int) -> dict:
    """K3's backward against its plain version on K3's output and statistics,
    q / k / v as views of one fused qkv (as the ViT hands them over)."""
    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
        _launch_mha,
        _launch_mha_bwd,
        mha_attention_bwd_reference,
    )

    hd = heads * head_dim
    scale = head_dim**-0.5
    kv = n if valid_len is None else valid_len
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (t.view(b, n, heads, head_dim) for t in qkv.split(hd, dim=-1))
    dout = torch.randn(b, n, heads, head_dim, generator=gen, device="cuda").to(torch.bfloat16)
    stats = torch.empty(b, heads, n, 2, dtype=torch.float32, device="cuda")
    out = _launch_mha(q, k, v, scale, kv, stats)
    bwd = lambda: _launch_mha_bwd(q, k, v, out, dout, stats, scale, kv)
    plain = lambda: mha_attention_bwd_reference(q, k, v, out, dout, valid_len=kv)
    got, ref = bwd(), plain()
    torch.cuda.synchronize()
    res = {"phase": "kernel_oneshot_bwd", "name": "mha_attention_bwd",
           "shape": [b, n, heads, head_dim], "valid_len": valid_len, "strided": True,
           "finite": all(bool(torch.isfinite(g.float()).all()) for g in got),
           "masked_dkdv_exact_zero": not (got[1][:, kv:].any() or got[2][:, kv:].any())}
    grad_errors(res, got, ref, n, n)
    del got, ref
    # the TPU kernel's five products (s, dp, dv, dq, dk), as for K2
    flops = 10.0 * b * heads * n * kv * head_dim
    nbytes = 2.0 * 8 * q.numel() + 4.0 * stats.numel()  # q, k, v, O, dO in; dq, dk, dv out
    res["ms"] = cuda_ms(bwd, iters)
    res["plain_ms"] = cuda_ms(plain, 2, warmup=1)
    res["library_ms"] = cuda_ms(sdpa_backward(q, k, v, dout, kv), iters)
    res["bound_ms"] = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    res["bound_by"] = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    return res


ONESHOT_BWD_CASES = [
    (8, 1664, 12, 64, 1601, 10),  # heritage training at the JAX tool's batch 8 (crop 640, padded once)
    (2, 1100, 8, 128, 1050, 20),  # head dim 128, ragged
]


def phase_kernel_oneshot_bwd() -> list:
    results = []
    for case in ONESHOT_BWD_CASES:
        res = mha_attention_bwd_case(*case)
        emit(res)
        bad = grads_out_of_limits(res)
        if bad or not (res["finite"] and res["masked_dkdv_exact_zero"]):
            raise AssertionError(f"mha_attention_bwd disagrees with its plain version ({bad}): {res}")
        results.append(res)
    return results  # the training shape (the first) is the K3 backward row's


def flash_attention_bwd_case(b: int, n: int, heads: int, head_dim: int, valid_len, causal: bool,
                             iters: int) -> dict:
    """K4b against its plain version on K4's output and residuals (views of
    one fused qkv): dq on rows and dk / dv on keys below `valid_len`, and
    exact zeros past it."""
    from denseclip_vit_multimodal_tpu_torch.ops.attention import (
        _launch,
        _launch_bwd,
        flash_attention_bwd_reference,
    )

    hd = heads * head_dim
    scale = head_dim**-0.5
    kv = n if valid_len is None else valid_len
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (t.view(b, n, heads, head_dim) for t in qkv.split(hd, dim=-1))
    dout = torch.randn(b, n, heads, head_dim, generator=gen, device="cuda").to(torch.bfloat16)
    stats = torch.empty(b, heads, n, 2, dtype=torch.float32, device="cuda")
    out = _launch(q, k, v, causal, scale, kv, stats)
    bwd = lambda: _launch_bwd(q, k, v, out, dout, stats, causal, scale, kv)
    plain = lambda: flash_attention_bwd_reference(q, k, v, out, dout, causal=causal,
                                                  valid_len=valid_len)
    got, ref = bwd(), plain()
    torch.cuda.synchronize()
    res = {"phase": "kernel_flash_bwd", "name": "flash_attention_bwd",
           "shape": [b, n, heads, head_dim], "valid_len": valid_len, "causal": causal,
           "finite": all(bool(torch.isfinite(g.float()).all()) for g in got),
           "pad_exact_zero": not any(g[:, kv:].any() for g in got)}
    grad_errors(res, got, ref, kv, kv)
    del got, ref
    # the function's five products (s, dp, dv, dk, dq), as for K2 and K3's
    # backward; the kernels' design does seven (the dq kernel redoes s and dp)
    flops = 10.0 * b * heads * kv * kv * head_dim * (0.5 if causal else 1.0)
    nbytes = 2.0 * 8 * q.numel() + 4.0 * stats.numel() * 1.5  # + di
    res["ms"] = cuda_ms(bwd, iters)
    res["plain_ms"] = cuda_ms(plain, 2, warmup=1)
    res["library_ms"] = cuda_ms(sdpa_backward(q, k, v, dout, kv, causal), iters)
    res["bound_ms"] = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    res["bound_by"] = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    return res


FLASH_BWD_CASES = [
    (2, 9344, 12, 64, 9217, False, 5),  # train_long: batch 2, crop 1536 (9217 tokens, padded once)
    (2, 2048, 12, 64, None, True, 20),  # causal
    (2, 1100, 8, 128, 1050, False, 20),  # head dim 128, ragged
]


def phase_kernel_flash_bwd() -> list:
    results = []
    for case in FLASH_BWD_CASES:
        res = flash_attention_bwd_case(*case)
        emit(res)
        bad = grads_out_of_limits(res)
        if bad or not (res["finite"] and res["pad_exact_zero"]):
            raise AssertionError(f"flash_attention_bwd disagrees with its plain version ({bad}): "
                                 f"{res}")
        results.append(res)
        torch.cuda.empty_cache()
    return results  # the training shape (the first) is the K4b row's


# The heritage preset on a crop past the one-shot limit: 96 x 96 patches + 1
# = 9217 tokens, padded once to 9344, which the dispatch sends to K4 / K4b.
LONG_CROP = 1536
LONG_BATCH = 2
LONG_OVERRIDES = ["data.synthetic=true", "data.synthetic_options.image_size=[1024,2048]",
                  "data.synthetic_options.length=8", f"data.crop_size=[{LONG_CROP},{LONG_CROP}]",
                  f"training.batch_size={LONG_BATCH}"]
LONG_STEPS = 4  # the first is the warm-up
LONG_WORK_DIR = "build/train_long"  # gitignored; removed at the end of the phase
# Remat against none: the step-1 loss (the forward: the same ops on the same
# drop-path masks), and on one step with fixed weights, batch and masks every
# leaf's gradient, which K4b and the recompute make.  A loss after the first
# cannot hold them: the preset's warm-up applies lr 1e-10 at step 1, so step
# 2's loss does not see step 1's gradients.  By default a rerun of the step
# alone moves the gradients (cuDNN's and PyTorch's nondeterministic
# algorithms), so they are compared under deterministic algorithms, where
# remat may change no leaf that a rerun leaves bitwise the same.
REMAT_LOSS_TOL = 1e-6  # relative
# Kernels against plain attention: the backbone's segmentation-loss gradients
# held as in train_path (TRAIN_GRAD_RATIO against the fp32 yardstick).


def _long_run(extra: list, steps: int) -> dict:
    """`train()` on the long crop; step times from its log, launches, peak memory."""
    import shutil

    from denseclip_vit_multimodal_tpu_torch.core.config import load_config
    from denseclip_vit_multimodal_tpu_torch.train.loop import train

    shutil.rmtree(LONG_WORK_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    summary = train(load_config(TRAIN_CONFIG, overrides=LONG_OVERRIDES + extra), LONG_WORK_DIR,
                    max_steps=steps, no_validate=True, device="cuda")
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(LONG_WORK_DIR, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    shutil.rmtree(LONG_WORK_DIR, ignore_errors=True)
    timed = [r["step_s"] for r in rows[1:]] or [rows[0]["step_s"]]
    ms = sum(timed) / len(timed) * 1e3
    return {"overrides": extra, "steps": len(rows), "summary": summary,
            "losses": [r["loss_total"] for r in rows], "step_ms": [r["step_s"] * 1e3 for r in rows],
            "ms_per_step": ms, "samples_per_s": LONG_BATCH / (ms / 1e3), "peak_mem_gib": peak_gib,
            "launches": launches,
            "launches_per_step": {k: v / len(rows) for k, v in launches.items()}}


@contextlib.contextmanager
def deterministic_algorithms():
    """`torch.use_deterministic_algorithms(True, warn_only=True)`: cuDNN and
    PyTorch's ops take deterministic algorithms, and an op that has none
    warns; yields the warnings caught.  Uninitialised memory is left as it
    is, so that the step computes what it computes outside."""
    import warnings

    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def nondeterminism_trace(net, batch: dict, texts, crop, seed: int):
    """What a rerun of one step moves: the leaves whose gradients differ
    between two identical runs, by default and under
    `deterministic_algorithms`, and the ops PyTorch names as having no
    deterministic implementation.  Returns (report, the gradients of the
    last deterministic run by leaf)."""
    def rerun():
        first, second = (step_grads(net, batch, texts, crop, seed)[3] for _ in range(2))
        rel = {name: rel_l2(second[name], g) for name, g in first.items()}
        return second, sorted((r, name) for name, r in rel.items() if r > 0.0)[::-1]

    leaves, differing = rerun()
    with deterministic_algorithms() as caught:
        det_leaves, det_differing = rerun()
    ops = sorted({str(w.message).split(" does not have a deterministic")[0][:120]
                  for w in caught if "deterministic" in str(w.message)})
    backbone = lambda named: torch.cat([g.flatten() for name, g in named.items()
                                       if name.startswith("backbone.")])
    report = {
        "leaves": len(leaves),
        "default": {"leaves_differing": len(differing),
                    "differing_by_module": dict(collections.Counter(
                        name.split(".")[0] for _, name in differing)),
                    "most_differing": [[name, r] for r, name in differing[:4]],
                    "least_differing": [[name, r] for r, name in differing[-4:]]},
        "deterministic_algorithms": {"leaves_differing": [[name, r] for r, name in det_differing],
                                     "ops_without_deterministic_implementation": ops},
    }
    del leaves
    return report, det_leaves


def phase_train_long() -> dict:
    """Backbone training past the one-shot limit through `train()`: K4 + K4b,
    without and with `tpu.remat`, and one step with plain attention; then
    one step's gradients on fixed weights, batch and masks: remat against
    none and the kernels against plain attention; a rerun's trace; a
    profile."""
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
    from denseclip_vit_multimodal_tpu_torch.ops.attention import LAUNCHES
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state
    from denseclip_vit_multimodal_tpu_torch.train.step import make_train_step

    tokens = (LONG_CROP // 16) ** 2 + 1
    kernels = _long_run(["tpu.remat=false"], LONG_STEPS)
    remat = _long_run(["tpu.remat=true"], LONG_STEPS)
    # plain attention keeps [2, 12, 9344, 9344] fp32 scores (8.4 GB) per layer:
    # under remat one layer's live at a time
    plain = _long_run(["tpu.remat=true", "tpu.attn_impl=xla"], 1)

    # one step's gradients on the same weights, augmented batch and masks
    cfg = load_config(TRAIN_CONFIG, overrides=LONG_OVERRIDES)
    seed = int(cfg.training.get("seed", 42))
    loader = DataLoader(build_dataset(cfg.data, "train"), batch_size=LONG_BATCH, seed=seed,
                        num_threads=int(cfg.training.get("workers", 8)))
    model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.bfloat16,
                                   device="cuda", seed=seed)
    aug_cfg = augment_config_from_data_cfg(cfg.data)
    crop = tuple(aug_cfg.crop_size)
    batches = loader.epoch(0)
    batch = augment_batch(to_device(next(batches), "cuda"), aug_cfg,
                          torch.Generator().manual_seed(seed))
    grads_of = lambda net: step_grads(net, batch, texts, crop, seed)[:3]
    before = dict(LAUNCHES)
    kernel_loss, kernel_seg, kernel_total = grads_of(model)
    bwd_launches = LAUNCHES["flash_attention_bwd"] - before["flash_attention_bwd"]
    trace, det_leaves = nondeterminism_trace(model, batch, texts, crop, seed)
    model.backbone.transformer.remat = "full"
    remat_loss, remat_seg, remat_total = grads_of(model)
    with deterministic_algorithms():
        remat_det = step_grads(model, batch, texts, crop, seed)[3]
    remat_changed = [name for name, g in det_leaves.items() if not torch.equal(remat_det[name], g)]
    del det_leaves, remat_det
    set_attn_impl(model, "xla")  # under remat, as above
    plain_loss, plain_seg, plain_total = grads_of(model)
    set_attn_impl(model, "auto")
    model.backbone.transformer.remat = None
    torch.cuda.empty_cache()
    ref_model = fp32_twin(model, cfg.model, seed, remat=True)
    ref_loss, ref_seg, ref_total = grads_of(ref_model)
    del ref_model
    torch.cuda.empty_cache()
    grads = {
        "entry_point": "the model and losses of train/step.py, one step, no update",
        "k4b_launches": bwd_launches,  # two backward passes (segmentation loss, then SILog)
        "loss_kernel": kernel_loss, "loss_remat": remat_loss, "loss_plain": plain_loss,
        "loss_fp32": ref_loss,
        "backbone_total_grad_rel_l2_remat_vs_false": rel_l2(remat_total, kernel_total),
        "backbone_seg_grad_rel_l2_remat_vs_false": rel_l2(remat_seg, kernel_seg),
        "backbone_seg_grad_rel_l2_vs_plain": rel_l2(kernel_seg, plain_seg),
        "backbone_seg_grad_rel_l2_kernel_vs_fp32": rel_l2(kernel_seg, ref_seg),
        "backbone_seg_grad_rel_l2_plain_vs_fp32": rel_l2(plain_seg, ref_seg),
        "backbone_total_grad_rel_l2_vs_plain": rel_l2(kernel_total, plain_total),
        "backbone_total_grad_rel_l2_kernel_vs_fp32": rel_l2(kernel_total, ref_total),
        "backbone_total_grad_rel_l2_plain_vs_fp32": rel_l2(plain_total, ref_total),
        "rerun": trace,
        # under deterministic algorithms: the leaves remat changes, and the
        # ones a rerun changes too
        "remat_vs_false_leaves_differing_deterministic": remat_changed,
        "rerun_leaves_differing_deterministic": [
            name for name, _ in trace["deterministic_algorithms"]["leaves_differing"]],
    }
    del kernel_seg, kernel_total, remat_seg, remat_total, plain_seg, plain_total
    del ref_seg, ref_total
    step_rel = lambda a, b: [abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"])]
    res = {
        "phase": "train_long", "config": TRAIN_CONFIG, "overrides": LONG_OVERRIDES,
        "entry_point": "train/loop.py train()", "batch": LONG_BATCH, "crop": [LONG_CROP, LONG_CROP],
        "tokens": tokens, "padded_tokens": -(-tokens // 128) * 128,
        "timed_steps": LONG_STEPS - 1, "remat_false": kernels, "remat_true": remat,
        "plain_side": {"how": "tpu.attn_impl=xla under tpu.remat=true, full depth, 1 step",
                       **plain},
        "loss_rel_diff_kernels_vs_plain": abs(kernels["losses"][0] - plain["losses"][0])
        / abs(plain["losses"][0]),
        "loss_rel_diff_remat_vs_false": step_rel(remat, kernels)[0],
        "loss_rel_diff_by_step_remat_vs_false": step_rel(remat, kernels),
        "gradients": grads,
        "tol": TRAIN_TOL, "grad_ratio_limit": TRAIN_GRAD_RATIO, "remat_tol": REMAT_LOSS_TOL,
    }
    emit(res)
    per_step = LONG_STEPS * 12
    if kernels["launches"] != expected_launches(flash_attention=per_step,
                                                flash_attention_bwd=per_step):
        raise AssertionError(f"expected 12 K4 and 12 K4b launches per step: {kernels['launches']}")
    # remat runs each layer's attention forward again in the backward
    if remat["launches"] != expected_launches(flash_attention=2 * per_step,
                                              flash_attention_bwd=per_step):
        raise AssertionError(f"remat: expected 24 K4 and 12 K4b per step: {remat['launches']}")
    if plain["launches"] != expected_launches():
        raise AssertionError(f"the plain-attention step launched a kernel: {plain['launches']}")
    if bwd_launches != 24:
        raise AssertionError(f"the gradient step did not run K4b in every layer: {bwd_launches}")
    if not all(np.isfinite(x) for r in (kernels, remat, plain) for x in r["losses"]):
        raise AssertionError(f"non-finite long-crop training losses: {res}")
    if not (res["loss_rel_diff_kernels_vs_plain"] <= TRAIN_TOL
            and res["loss_rel_diff_remat_vs_false"] <= REMAT_LOSS_TOL):
        raise AssertionError(f"long-crop training losses disagree: {res}")
    if not (set(remat_changed) <= set(grads["rerun_leaves_differing_deterministic"])
            and grads["backbone_seg_grad_rel_l2_kernel_vs_fp32"]
            <= TRAIN_GRAD_RATIO * grads["backbone_seg_grad_rel_l2_plain_vs_fp32"]):
        raise AssertionError(f"long-crop gradients disagree: {grads}")
    if not remat["peak_mem_gib"] < kernels["peak_mem_gib"]:
        raise AssertionError(f"remat did not lower the peak memory: {res}")

    # where a long step's device time goes (no remat), on the same weights
    state = create_train_state(model, cfg.training, len(loader))
    step = make_train_step(texts, aug_cfg, seed=seed)
    step(state, to_device(next(batches), "cuda"))  # warm-up
    phase_profile(lambda host: step(state, to_device(host, "cuda")), [next(batches)],
                  path="training_long")
    del model, state, step
    torch.cuda.empty_cache()
    return res


def phase_outproj_path() -> dict:
    """The out-projection epilogue experiment through the port's tool `main()`."""
    from denseclip_vit_multimodal_tpu_torch.tools import exp_outproj_epilogue as exp

    torch.cuda.empty_cache()
    reset_launches()
    res = exp.main([])
    launches = read_launches()
    b, n, hd = res["shape"][0], res["shape"][1], res["shape"][2] // 3
    heads, d = res["heads"], res["head_dim"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(hd, hd, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    flops = 4.0 * b * heads * n * n * d + 2.0 * b * n * hd * hd
    nbytes = 2.0 * (qkv.numel() + w.numel()) + 4.0 * b * n * hd
    res.update({
        "phase": "outproj_path", "entry_point": "tools/exp_outproj_epilogue.py main()",
        "launches": launches,
        "plain_ms": cuda_ms(lambda: exp.qkv_out_attention_reference(qkv, w, heads), 2, warmup=1),
        "ms": min(res["B_ms"], res["B2_ms"]), "max_abs_err": res["max_abs_err_b_vs_plain"],
        "library_ms": None,  # no one PyTorch call computes attention + out-projection
        "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
        "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes",
    })
    emit(res)
    if not (res["finite"] and res["rel_l2_b_vs_plain"] <= KERNEL_REL_TOL
            and res["rel_err_b_vs_plain"] <= KERNEL_TOL and res["rel_err_a_vs_b"] <= KERNEL_TOL):
        raise AssertionError(f"the out-projection epilogue kernel disagrees: {res}")
    if not launches["qkv_out_attention"] or not launches["qkv_attention"]:
        raise AssertionError(f"the experiment did not run K7 and K1: {launches}")
    return res


def phase_profile_attn_bwd() -> dict:
    """The backward microbenchmark through the port's tool `main()`."""
    from denseclip_vit_multimodal_tpu_torch.tools.profile_attn_bwd import main as pab_main

    torch.cuda.empty_cache()
    reset_launches()
    res = pab_main(["--out", "build/profile_attn_bwd.json"])
    launches = read_launches()
    res = {"phase": "profile_attn_bwd", **res, "launches": launches}
    emit(res)
    # K3's backward against the autograd of plain attention (fp32 softmax):
    # bf16 rounding of ds, p and dO * r, relative to the largest gradient
    if not all(res[f"relerr_{g}"] <= 5e-2 for g in ("dq", "dk", "dv")):
        raise AssertionError(f"K3's backward disagrees with plain autograd: {res}")
    if not (launches["mha_attention"] and launches["mha_attention_bwd"]):
        raise AssertionError(f"the tool did not run K3 and its backward: {launches}")
    return res


PROFILE_GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("ln_qkv_attention (K6)", ("ln_qkv_",)),
    ("mha_attention (K3)", ("mha_attention_kernel",)),
    ("qkv_attention_bwd (K2; K3's backward)", ("qkv_bwd_",)),
    ("flash_attention_bwd (K4b)", ("flash_bwd_",)),
    ("qkv_out_attention (K7)", ("qkv_out_attention_kernel",)),
    ("qkv_attention_int8 (K5)", ("qkv_attention_int8_kernel",)),
    ("qkv_attention (K1)", ("qkv_attention_kernel",)),
    ("flash_attention (K4)", ("flash_attention_kernel",)),
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
    slide = phase_kernels()[0]
    train_shape = phase_kernel_bwd()
    longest = phase_kernel_flash()[2]  # the aug-test scale 1.75 shape
    serving = phase_kernel_int8()[0]
    oneshot = phase_kernel_oneshot()[0]
    fused = phase_kernel_lnqkv()[0]
    main_res = phase_main_path()
    lnqkv_res = phase_lnqkv_path()
    train_res = phase_train_path()
    eval_res = phase_eval_path()
    serve_res = phase_serve_path()
    selftest_res = phase_selftest()
    oneshot_bwd = phase_kernel_oneshot_bwd()[0]
    flash_bwd = phase_kernel_flash_bwd()[0]
    long_res = phase_train_long()
    outproj_res = phase_outproj_path()
    pab_res = phase_profile_attn_bwd()
    by_path = lambda name: {"slide_serving": main_res["launches"][name],
                            "training": train_res["launches"][name],
                            "aug_test": eval_res["launches"][name],
                            "int8_http_serving": serve_res["launches"][name],
                            "fused_lnqkv_serving": lnqkv_res["launches"][name],
                            "selftest": selftest_res["launches"][name],
                            "training_long": long_res["remat_false"]["launches"][name],
                            "training_long_remat": long_res["remat_true"]["launches"][name],
                            "outproj_experiment": outproj_res["launches"][name],
                            "profile_attn_bwd": pab_res["launches"][name]}
    entry = lambda name, source, replaces, res, launches: {
        "name": name, "route": "cuda",
        "source": f"denseclip_vit_multimodal_tpu_torch/csrc/{source}",
        "replaces": replaces if replaces.startswith(("jax/", "tools/")) else
        f"denseclip_vit_multimodal_tpu/{replaces}",
        "launches": launches, "launches_by_path": by_path(name),
        "max_abs_err": res["max_abs_err"], "ms": res["ms"], "kernel_ms": res["ms"],
        "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
        "library_ms": res["library_ms"],
    }
    emit({"kernels": [
        entry("qkv_attention", "qkv_attention.cu", "ops/mha_kernel.py:400", slide,
              main_res["launches"]["qkv_attention"]),
        entry("qkv_attention_bwd", "qkv_attention_bwd.cu", "ops/mha_kernel.py:240", train_shape,
              train_res["launches"]["qkv_attention_bwd"]),
        entry("flash_attention", "flash_attention.cu", "ops/attention.py:130", longest,
              eval_res["launches"]["flash_attention"]),
        entry("qkv_attention_int8", "qkv_attention_int8.cu", "ops/mha_kernel.py:586", serving,
              serve_res["launches"]["qkv_attention_int8"]),
        entry("mha_attention", "mha_attention.cu", "ops/mha_kernel.py:164", oneshot,
              selftest_res["launches"]["mha_attention"]),
        entry("ln_qkv_attention", "ln_qkv_attention.cu", "ops/lnqkv_kernel.py:81", fused,
              lnqkv_res["launches"]["ln_qkv_attention"]),
        entry("flash_attention_bwd", "flash_attention_bwd.cu",
              "jax/experimental/pallas/ops/tpu/flash_attention.py:796 (dkv, call :1121) and "
              ":1146 (dq, call :1456)", flash_bwd,
              long_res["remat_false"]["launches"]["flash_attention_bwd"]),
        entry("mha_attention_bwd", "qkv_attention_bwd.cu", "ops/mha_kernel.py:240 (via :308, :359)",
              oneshot_bwd, pab_res["launches"]["mha_attention_bwd"]),
        entry("qkv_out_attention", "qkv_out_attention.cu", "tools/exp_outproj_epilogue.py:46",
              outproj_res, outproj_res["launches"]["qkv_out_attention"]),
    ]})
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
