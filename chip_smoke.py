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
                  bound times; the row statistics it writes for the backward
                  against the plain row max and sum; NaN in the K / V rows
                  past valid_len in one case;
  4. kernel_bwd — K2 (attention backward) the same way, per gradient dq, dk,
                  dv, with dk / dv of masked keys held to exactly 0 and a
                  second launch held bitwise equal to the first; TFLOP/s on
                  the function's five products and the design's seven;
  5. kernel_flash — K4 (long-sequence flash attention forward, the forward
                  core under the bundled kernel's numerics) the same way at
                  the three long evaluation shapes (views of a fused qkv), a
                  ragged head-dim-128 case and a causal case, a causal case
                  with pad keys and head dim 256 past the one-shot limit
                  (NaN in the K / V rows past valid_len in the last three);
                  its row statistics as K1's;
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
                  attention and fp32 (under `attn_impl: xla`), a profile of 2 steps, and 2 steps plus
                  a validation through the user entry point `train()`, whose
                  checkpoint the next phase evaluates;
 10. eval_path  — the user entry point `tools/test.py` on that checkpoint
                  (the flagship model: the heritage preset's `_base_`):
                  multi-scale (0.5-1.75) + flip whole-frame evaluation with
                  mIoU and depth metrics over 3 synthetic 1024x2048 frames
                  (the first untimed); seconds per frame, peak memory, K1 /
                  K4 launches per frame; one frame at scale 1.25 with the
                  kernels against plain attention; a profile of one frame;
 11. kernel_int8 — K5's prologue kernel (quantization and V's key-major
                  copy) held bitwise against its plain version (q8's q
                  and k thirds, V's copy, scales), then K5 (int8 attention)
                  against its plain version, at the serving shape, the
                  whole frame, head dim 128 (bf16 and fp32 qkv) and the
                  adversarial pad case, with kernel / plain / bound times of
                  both and, for context, the bf16 K1 and SDPA at the same
                  shape;
 12. serve_path — the user entry points `tools/serve.py` (`build_service` on
                  the checkpoint of train_path, `--set tpu.attn_impl=int8`)
                  and `make_server` on 127.0.0.1: one warm-up, 3 seeded
                  1024x2048 frames POSTed as PNG (slide), one `mode=whole`
                  request, /healthz, /metrics, a bad request and one frame
                  with Paeth-filtered rows (the decoder's anti-diagonal
                  path); latency, img/s, PNG decode ms (filter 0 and
                  Paeth), device seconds, peak memory, K5 / prologue / K1 /
                  K4 launches per request; the HTTP answer against
                  `predict_array`; one frame with K5 against its plain
                  version (and, reported only, against the bf16 K1 path); a
                  profile of one int8 slide frame;
 13. kernel_oneshot — K3 (one-shot attention on [B, N, H, D]) against its
                  plain version at the slide shape (views of a fused qkv),
                  the self-test's shape, head dim 128 (with NaN in the K / V
                  rows past valid_len) and head dim 256, with kernel / plain
                  / SDPA / bound times, and its row statistics as K1's;
 14. kernel_lnqkv — K6 (fused LayerNorm + qkv projection + attention)
                  against its plain version at the slide shape, head dim 128
                  (with NaN in the rows of x past valid_len, hence in those
                  of K and V) and the largest N its rule admits, with kernel / plain /
                  bound times, the unfused chain in PyTorch's own calls
                  (layer_norm + linear + SDPA: `library_ms`) and the port's
                  unfused chain (LayerNorm + Linear + K1); a rerun held
                  bitwise equal; the statistics pass bitwise against its
                  plain version, the first stage's q/k/v workspace against
                  the plain projection (within the last bf16 rounding) and
                  the second stage on it bitwise equal to the whole kernel;
                  the split (statistics, projection, first stage, second
                  stage) beside `F.linear` and the projection's bound;
 15. lnqkv_path — main_path's slide protocol with DENSECLIP_FUSED_LNQKV=1
                  (set only inside this phase): 3 requests, img/s, peak
                  memory, 12 K6 and 0 K1 launches per frame; one frame
                  against the unfused K1 path and against K6's plain
                  version; a `mode=whole` request (8193 tokens: the rule
                  sends it to K1) equal to its unfused answer; a profile,
                  whose device time per frame is printed beside
                  main_path's;
 16. selftest   — the port's GPU self-test (`tools/selftest.py`), whose
                  checks must all pass;
 17. kernel_oneshot_bwd — K3's backward against its plain version on K3's
                  output and statistics, per gradient, at the heritage
                  training shape [8,1664,12,64] valid 1601 (views of a fused
                  qkv), at head dim 128 and at head dim 256, with kernel /
                  plain / SDPA backward / bound times, TFLOP/s and the
                  bitwise rerun check, as K2;
 18. kernel_flash_bwd — K4b (the flash backward) the same way at the long
                  training shape [2,9344,12,64] valid 9217, a causal case, a
                  ragged head-dim-128 case and head dim 256 past the
                  one-shot limit; dq of pad rows and dk / dv of pad keys held
                  to exactly 0; TFLOP/s and the rerun check;
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
                  attention and fp32 (under `attn_impl: xla`, the plain
                  yardstick, though the kernels take fp32 too); what a rerun of the step moves and
                  which ops PyTorch names nondeterministic; a profile of one
                  step;
 20. outproj_path — the port's `tools/exp_outproj_epilogue.py` `main()`: K7
                  against its plain version and against path A (K1 +
                  matmul + the cast to fp32), the interleaved A / B / A2 /
                  B2 times, A's parts each alone and the verdict; K7's
                  plain time, TFLOP/s and bound;
 21. profile_attn_bwd — the port's `tools/profile_attn_bwd.py` `main()` at
                  [8,12,1601,64]: K3, K3's backward, the autograd of plain
                  attention and SDPA's backward;
 22. bench_path — the port's benchmark `bench.py` `main()` at full width on
                  both protocols (crop 624 and 640, 4 frames a run, at most 3
                  interleaved rounds; its JSON line, with 0 < mfu_pct <= 100);
                  one slide frame's FLOPs by `utils/flops.py::program_flops`
                  as served (the kernels' make-up from their launches) and
                  with `ops/attention.py::_on_cuda` patched to False (every
                  attention branch plain, counted by FlopCounterMode), on the
                  unfused, fused and int8 paths: within 0.5%, the gap exactly
                  the pad keys' N x (N - kv_len) scores; the suite
                  (`tools/bench_suite.py`) workloads 2 (with its MFU line) and
                  9 at few iterations;
 23. cityscapes_path — the flagship fine-tuned from an OpenAI CLIP checkpoint
                  on an on-disk Cityscapes tree, both written here from the
                  seed (16 train and 4 val 1024x2048 triplets over two cities
                  a split, every PNG row Paeth-filtered by the port's
                  encoder: RGB, 8-bit labelIds, 16-bit disparity with zeros;
                  a stub ViT-B/16 archive under OpenAI's names at the
                  published shapes in fp16): the host ops built by g++ into
                  build/host/ and held bitwise against numpy; decode ms per
                  sample by file, and the loader alone at 1 and 8 threads;
                  `tools/train.py` (CLIP import, 1 warm-up + 1 step at
                  batch 8, crop 512x1024: ms/step, data wait, peak memory,
                  12 K1 a step; the preset freezes both towers, so no K2),
                  the import's tensors against the archive's, the first
                  step's loss with the kernels against plain attention, a
                  profile of a step with its data wait; `tools/test.py` on
                  val (slide, crop 624 / stride 426: s/frame, 12 K1 a
                  frame, finite mIoU and depth metrics);
                  `tools/train.py --load` (1 step from step
                  0, the checkpoint's weights); `tools/import_checkpoint.py`
                  on a reference-format checkpoint, then `tools/test.py` on
                  one frame of it;
 24. rn50_path  — the original DenseCLIP (CLIP RN50 + attention pool,
                  context decoder, FPN with the score map concatenated into
                  c4) on `configs/denseclip_rn50_cityscapes.yaml` at full
                  width, on cityscapes_path's tree, from a stub OpenAI RN50
                  archive (its key names and shapes, fp16): `tools/train.py`
                  at batch 16, crop 512x512, 1 warm-up + 1 timed step
                  (ms/step, data wait, peak memory, losses); the checkpoint
                  in bf16 on the card against fp32 on the CPU (a 512x512
                  window and a 2-sample training loss, rel. 5e-2);
                  a profile of one step on a batch decoded beforehand;
                  `tools/test.py` whole and slide (crop 640, stride 426) on
                  the 4 val frames (s/frame, peak memory); a served whole
                  frame's FLOPs and its profile.  No kernel of the port is
                  on this path: every launch count must stay 0;
 25. ade20k_path — the three ADE20K presets on a tree written here (16
                  training and 4 validation baseline 4:2:0 JPEGs of ADE20K's
                  varied sizes by the numpy encoder `utils/_jpeg_writer.py`,
                  8-bit label PNGs over 0..150; stub ViT-B/16 and RN50
                  archives): the host's JPEG decode, resize and label ms a
                  sample and the loader's samples/s at 1 and 8 threads;
                  `configs/denseclip_vitb16_ade20k.yaml` through
                  `tools/train.py` (batch 8, crop 512, the backbone at lr
                  x0.1 as the RN presets ship it, 1 warm-up + 3 steps:
                  ms/step, data wait, peak memory; 12 K1 forward and 12 K2
                  backward launches a step, every one at [8,1152,2304] valid
                  1025), the first step's loss with the kernels against plain
                  attention (and the training forward's seg logits), a
                  profiled step (busy share); `tools/test.py` on
                  the validation split, slide at crop 640 / stride 426 on the
                  512x683 canvas (s/frame, 12 K1 a frame at [2,1408,2304]
                  valid 1281, 150 class IoUs; whole mode refused as the JAX
                  ViT refuses it: 683 is not a multiple of the patch), one
                  frame's seg logits against plain attention; `build_service`
                  answering one JPEG of the tree as `predict_array` answers
                  its decoded pixels; `configs/denseclip_rn50_512x512_80k.yaml`
                  from the stub RN50 archive through `tools/train.py` (batch
                  16, crop 512, 3 steps) and `tools/test.py` whole on the 4
                  frames; one whole 512x683 frame of
                  `configs/denseclip_rn101_512x512_80k.yaml` at full width
                  from seeded weights.  No kernel launches on the RN paths;
 26. flash_path — the flagship built with `attn_impl: flash` beside `auto`
                  on one seeded 1024x2048 slide frame: at the shipped crop
                  624 both take 12 K1 at [10,1536,2304] and agree bitwise;
                  at crop 384 (577 tokens, below K1's 1024-token floor under
                  `auto`) `auto` takes plain attention and `flash` 24 K1 at
                  [10,577,2304]: logits within PATH_TOL, ms a frame each;
 27. vitl14_seg_path — on cityscapes_path's tree, through `tools/train.py`
                  (2 steps at batch 8 with one loader thread, then
                  validation with its panels), `tools/test.py --mode slide
                  --show-dir --out --format-dir` (2 frames, both protocols)
                  and `tools/infer.py --mode slide` (one val image):
                  `configs/denseclip_vitl14_cityscapes_multitask.yaml` at
                  full width and depth (24 layers of 16 heads, remat as
                  shipped, the backbone at lr x0.1, seeded init: no ViT-L-14
                  archive, the missing-file path): 48 K1 + 24 K2 a step at
                  [8,2688,3072] valid 2593 (remat runs K1 again in the
                  backward), 24 K1 a window chunk at [10,2048,3072] valid
                  2026 (crop 630) and [10,2176,3072] valid 2117 (644); whole
                  mode refused on the frame as the JAX ViT refuses it, a
                  slide aug-test frame run; then
                  `configs/denseclip_vitb16_cityscapes_seg.yaml` the same
                  way, with no depth output anywhere.  Each held against
                  the phase's own model on the checkpoint: the panels' tiles
                  (decoded by the port's decoder) against the colourisers on
                  its eval step's predictions, the npz against
                  `predict(fetch="packed")`, the labelId PNGs against
                  `labelids_from_trainids` of the npz, infer's PNGs against
                  the colourisers, and one slide frame's logits against
                  plain attention.  ms/step, data wait, peak memory,
                  s/frame, every launch's shape; then ViT-L/14's training
                  step alone on a decoded batch by CUDA events (1 warm-up +
                  3).

 28. export_path — the flagship served from exported programs:
                  `tools/export.py`'s `main()` on a seeded checkpoint at full
                  width (slide 624 / 426 / window batch 20, 1024x2048) with
                  `--fetch logits` and `packed` (export seconds, bundle MiB,
                  the graph's kernel ops); the packed bundle in a fresh
                  process that imports the loader only (load s, 3 frames by
                  CUDA events after a warm-up, 12 K1 a frame, no model
                  module in `sys.modules`); one frame of each bundle against
                  the live `Inferencer` (logits rel. L2 <= 1e-4, and whether
                  bitwise; packed seg equal on >= 99.99% of pixels); the
                  exported frame against the live one in this process (4
                  interleaved turns of 3 frames, packed, CUDA events; also
                  the program with its metadata asserts kept) and a profile
                  of each; a simulated failed kernel build inside the
                  program raising;
                  int8 (12 K5 + 12 prologue a frame) and fused (12 K6)
                  exports against the live path under the same setting;
                  `tools/serve.py --from-export` over HTTP (3 timed PNG
                  requests, each npz equal to `predict` of the decoded
                  frame); host microseconds of a K1 call through its op and
                  direct; `tools/exp_serving_concurrency.py`'s `main()` at
                  --clients 1 4 --requests 3.
 29. fp32_path  — `tpu.compute_dtype: float32` through the kernels (TF32 off,
                  printed): the six fp32 kernels (K1, K3, K4 in
                  `csrc/attention_fp32.cu`; K2, K3's backward, K4b in
                  `csrc/attention_bwd_fp32.cu`; all 3xTF32 on the tensor
                  cores, but K3 / K4 at head dim 256 on the SIMT core)
                  against their plain versions
                  at the fp32 paths' shapes (outputs max abs <= 1e-4, rel. L2
                  <= 1e-5; row statistics as the bf16 kernels'; gradients rel.
                  L2 <= 1e-4 and max abs <= 1e-4 of the largest, masked keys
                  exactly 0, a rerun bitwise; NaN in the pad keys of most
                  cases), with SDPA's fp32 time and the bounds at the 3xTF32
                  ceiling and at 66.9 TFLOP/s; K6 fp32 (and its stages one at
                  a time beside layer_norm and F.linear in fp32); then the
                  flagship in fp32: a slide
                  frame (12 K1 fp32, logits within 1e-4 of `attn_impl: xla`),
                  `flash` at crop 384 (24 K1 fp32), the heritage preset
                  through `train()` (1 warm-up + 2 steps: 12 K1 + 12 K2 fp32 a
                  step; step-1 loss within 1e-5 of one xla step; backbone
                  seg-loss gradients within 1e-3 of xla under deterministic
                  algorithms, a rerun's motion and xla's on an image nudged
                  by 1e-6 beside), `tools/test.py
                  --aug-test` on its checkpoint (2 frames: 36 K1 + 36 K4 fp32
                  a frame), the 1536 crop through `train()` (1 warm-up + 2
                  steps: 12 K4 + 12 K4b fp32 a step, step-1 loss within 5e-2
                  of train_long's bf16 run), the self-test's fp32 lines, and
                  `tools/profile_attn_bwd.py --dtype float32`; each path's
                  launches by name, times and peak memory.
 30. ddp_path   — data parallelism over a torch.distributed process group
                  at full width: (1) the heritage preset through
                  `tools/dist_train.sh` (torchrun, NCCL, world 1) and through
                  `tools/train.py` without a group (each a fresh process),
                  1 warm-up + 3 steps each: the step-1 loss bitwise equal,
                  ms/step side by side (DDP's cost on one card); (2) two
                  Gloo ranks joined through torchrun's environment (both on
                  card 0 of a one-card machine) against this process on the
                  same global batch: the heritage step in fp32 (seg loss, deterministic algorithms:
                  loss <= 1e-5, backbone gradients <= 1e-3 rel. L2, against
                  the process running its backbone over the ranks' halves of
                  the batch, as cuBLAS's fp32 products of a part depend on
                  its rows; the whole-batch reference printed beside, with
                  the gradients reaching the neck's output and its fusion
                  layer's input, and the one process's own halves against
                  its whole batch) and in bf16 (loss <= 5e-2; 12 K1 + 12 K2 a
                  rank), the RN50 preset at batch 16 (BatchNorm statistics
                  <= 1e-5), a 1024x2048 flagship slide frame with its windows
                  spread over the ranks (logits <= 2e-2 and packed seg >=
                  99.99% equal against the process running the windows in
                  the ranks' chunks; against the protocol's one chunk
                  printed; 12 K1 a rank) and `tools/test.py` on 4 frames
                  (the confusion matrix exactly equal), every rank holding
                  the same numbers; (3) where two cards are visible, (2)'s
                  fp32 step under NCCL over them, with ms per step per rank
                  and the all-reduce's share of the device time
                  (torch.profiler); else one line says why it was not run.

rn50_path and cityscapes_path's `tools/train.py` run 2 steps each (1
warm-up + 1 timed; 3 before the ViT-L/14 phase came), cityscapes_path's
profiled step warms up on a batch it already decoded and its `--load` run
decodes on one thread, to keep the script near 700 s; since ddp_path came,
cityscapes_path times its loader over one batch a thread count (not the
epoch), and the paths after it (rn50_path, vitl14_seg_path) read the tree's
arrays from filter-0 PNGs (Paeth's unfilter, which cityscapes_path measures,
took most of their time); the seconds of every phase are printed before the
`kernels` line.

Then the `kernels` line, the nvidia-smi line and, last, the result line.
Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

from __future__ import annotations

import collections
import contextlib
import io
import itertools
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
LOG2E = 1.4426950408889634
KERNEL_TOL = 2e-2  # max abs error, bf16 kernel vs bf16 plain version, unit-normal inputs
# Mean abs error and relative L2 of the same comparison, held tight so that a
# small systematic fault (unmasked pad keys, a softmax scale off by 0.5% or
# more) fails where the max abs limit alone would pass it.  Measured on an
# H100 80GB HBM3 at the four shapes below: mean abs <= 6.4e-5, relative L2
# 2.2e-3 to 2.4e-3 (bf16 rounding of the output).
KERNEL_MEAN_TOL = 5e-4
KERNEL_REL_TOL = 5e-3
# K1's / K3's row statistics against the plain row max (log2 units) and sum.
# Measured on an H100 80GB HBM3 over every case of phases kernel and
# kernel_oneshot: row max <= 4.8e-6 abs, row sum <= 3.0e-6 relative (fp32
# sums in another order); the limits keep ~10x.
STATS_M_TOL = 5e-5  # max abs error of the row max
STATS_L_TOL = 3e-5  # max relative error of the row sum
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


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaN payloads included (torch.equal fails on NaN)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int16 if a.element_size() == 2 else torch.int32),
        b.view(torch.int16 if b.element_size() == 2 else torch.int32))


def rerun_bitwise_equal(bwd, got) -> bool:
    """Whether a second launch of the backward `bwd` on the same inputs gives
    `got` bit for bit (the kernels have no atomics: their sums run in one
    order)."""
    again = bwd()
    pair = zip(got, again) if isinstance(got, tuple) else [(got, again)]
    return all(torch.equal(a, b) for a, b in pair)


def bwd_rates(res: dict, flops: float, head_dim: int) -> dict:
    """A backward kernel's TFLOP/s on the function's five products and on the
    seven its design does (the dq kernel computes s and dp again; eight at
    head dim 256, whose dk/dv kernel computes s again for dv)."""
    rate = flops / (res["ms"] * 1e-3) / 1e12
    res["tflops_5_products"] = rate
    res["tflops_7_products"] = rate * 7 / 5
    if head_dim > 128:
        res["tflops_8_products"] = rate * 8 / 5
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


def row_stats_errors(stats: torch.Tensor, q: torch.Tensor, k: torch.Tensor, kv: int,
                     scale: float, prescaled: bool = True, causal: bool = False) -> dict:
    """A forward kernel's row statistics [B, H, N, 2] against the plain row
    max (log2 units) and row sum over the first kv keys: K1's / K3's logits
    (`prescaled`) or K4's."""
    from denseclip_vit_multimodal_tpu_torch.tools.time_fwd_trees import plain_stats, stats_errors

    return stats_errors(stats, plain_stats(q, k, kv, scale, prescaled, causal))


def stats_in_limits(res: dict) -> bool:
    return (res["stats_m_max_abs_err"] <= STATS_M_TOL
            and res["stats_l_max_rel_err"] <= STATS_L_TOL)


def poison_pad_keys(k: torch.Tensor, v: torch.Tensor, kv: int) -> None:
    """NaN in every K / V row at or past kv, which must never reach a real row."""
    k[:, kv:] = float("nan")
    v[:, kv:] = float("nan")


def qkv_attention_case(b: int, n: int, heads: int, head_dim: int, valid_len, iters: int,
                       poison: bool = False) -> dict:
    """K1 against its plain version, its row statistics against the plain
    ones; with `poison`, NaN in the K / V rows past valid_len."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
        _launch,
        mha_qkv_attention,
        mha_qkv_attention_reference,
    )

    hd = heads * head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(torch.bfloat16)
    kv = n if valid_len is None else valid_len
    q4, k4, v4 = (t.view(b, n, heads, head_dim) for t in qkv.split(hd, dim=-1))
    if poison:
        poison_pad_keys(k4, v4, kv)
    out = mha_qkv_attention(qkv, heads, valid_len=valid_len)
    ref = mha_qkv_attention_reference(qkv, heads, valid_len=valid_len)
    out_s, stats = _launch(qkv, heads, head_dim**-0.5, kv, with_stats=True)
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
        "poisoned_pad_keys": poison,
        **row_stats_errors(stats, q4, k4, kv, head_dim**-0.5),
        "stats_call_output_bitwise_equal": torch.equal(out, out_s),
    }


def phase_kernels() -> dict:
    cases = [
        (10, 1536, 12, 64, 1522, 50),  # slide window batch (crop 624, padded once)
        (4, 1664, 12, 64, 1601, 50, True),  # heritage training: batch 4, crop 640, NaN pad keys
        (1, 8320, 12, 64, 8193, 10),  # whole 1024x2048 frame (and aug-test scale 1.0, at B 2)
        (2, 2176, 12, 64, 2049, 20),  # aug-test scale 0.5 with its flipped view
        (2, 4736, 12, 64, 4609, 10),  # aug-test scale 0.75
        (2, 640, 8, 128, 640, 50),  # head dim 128
        (4, 777, 12, 64, None, 50),  # ragged N, valid_len None
        (8, 2176, 12, 64, 2049, 20),  # the flagship's training: batch 8, crop 512x1024
        (8, 1152, 12, 64, 1025, 20),  # the ADE20K ViT preset's training: batch 8, crop 512
        (2, 1408, 12, 64, 1281, 50),  # its slide frame: two 512x640 windows of the 512x683 canvas
        (8, 2688, 16, 64, 2593, 10),  # ViT-L/14 training: batch 8, crop 504x1008, 16 heads
        (10, 2048, 16, 64, 2026, 20),  # its slide window batch (crop 630, window batch 10)
        (10, 2176, 16, 64, 2117, 20),  # its reference protocol (crop 644)
        (10, 577, 12, 64, None, 50),  # attn_impl flash: crop-384 windows, 577 tokens, unpadded
    ]
    results = []
    for case in cases:
        res = qkv_attention_case(*case)
        emit(res)
        if not (res["finite"] and res["max_abs_err"] <= KERNEL_TOL
                and res["mean_abs_err"] <= KERNEL_MEAN_TOL and res["rel_l2_err"] <= KERNEL_REL_TOL
                and stats_in_limits(res) and res["stats_call_output_bitwise_equal"]):
            raise AssertionError(f"qkv_attention disagrees with its plain version: {res}")
        results.append(res)
    return results  # the slide shape, ..., the two ADE20K shapes, the three ViT-L/14, flash's


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
           "masked_dkdv_exact_zero": bool((got[:, kv:, hd:] == 0).all()),
           "rerun_bitwise_equal": rerun_bitwise_equal(bwd, got)}
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
    return bwd_rates(res, flops, head_dim)


BWD_CASES = [
    (4, 1664, 12, 64, 1601, 20),  # heritage training: batch 4, crop 640 (1601 tokens, padded once)
    (10, 1536, 12, 64, 1522, 10),  # slide window batch shape
    (2, 640, 8, 128, None, 20),  # head dim 128
    (4, 777, 12, 64, None, 20),  # ragged N, valid_len None
    (8, 2176, 12, 64, 2049, 10),  # the flagship's training shape (an unfrozen backbone's K2)
    (8, 1152, 12, 64, 1025, 10),  # the ADE20K ViT preset's training: batch 8, crop 512
    (8, 2688, 16, 64, 2593, 10),  # ViT-L/14 training: batch 8, crop 504x1008, 16 heads
]


def phase_kernel_bwd() -> dict:
    results = []
    for b, n, heads, d, valid_len, iters in BWD_CASES:
        res = qkv_attention_bwd_case(b, n, heads, d, valid_len, iters)
        emit(res)
        bad = grads_out_of_limits(res)
        if bad or not (res["finite"] and res["masked_dkdv_exact_zero"]
                       and res["rerun_bitwise_equal"]):
            raise AssertionError(f"qkv_attention_bwd disagrees with its plain version ({bad}): {res}")
        results.append(res)
    return results  # the heritage training shape, ..., the flagship's, ADE20K's, ViT-L/14's


def flash_attention_case(b: int, n: int, heads: int, head_dim: int, valid_len, causal: bool,
                         iters: int, poison: bool = False) -> dict:
    """K4 (its launching wrapper: `flash_attention` would send a short
    non-causal case to the K3 branch) against its plain version on views of
    one fused qkv, as the ViT hands them over; errors on the rows below
    `valid_len` (the rest are unspecified), every row finite; its row
    statistics against the plain row max and sum; with `poison`, NaN in the
    K / V rows past valid_len."""
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
    if poison:
        poison_pad_keys(k, v, kv)
    run = lambda: _launch(q, k, v, causal, head_dim**-0.5, kv)
    plain = lambda: flash_attention_reference(q, k, v, causal=causal, valid_len=valid_len)
    out, ref = run(), plain()
    stats = torch.empty(b, heads, n, 2, dtype=torch.float32, device="cuda")
    out_s = _launch(q, k, v, causal, head_dim**-0.5, kv, stats)
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
        "valid_len": valid_len, "causal": causal, "poisoned_pad_keys": poison,
        "max_abs_err": float(err.abs().max()), "mean_abs_err": float(err.abs().mean()),
        "rel_l2_err": float(err.norm() / ref[:, :kv].float().norm()),
        "finite": bool(torch.isfinite(out.float()).all()),
        **row_stats_errors(stats, q, k, kv, head_dim**-0.5, prescaled=False, causal=causal),
        "stats_call_output_bitwise_equal": torch.equal(out, out_s),
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
# ragged head-dim-128 case, a causal case, a causal case with pad keys and
# head dim 256 past the one-shot limit (NaN in the pad keys of the last three).
FLASH_CASES = [
    (2, 12928, 12, 64, 12801, False, 10),
    (2, 18560, 12, 64, 18433, False, 5),
    (2, 25216, 12, 64, 25089, False, 3),
    (2, 1100, 8, 128, 1050, False, 50, True),
    (2, 2048, 12, 64, None, True, 50),
    (2, 2100, 12, 64, 2000, True, 50, True),
    (2, 8704, 4, 256, 8600, False, 10, True),
]


def phase_kernel_flash() -> list:
    results = []
    for case in FLASH_CASES:
        res = flash_attention_case(*case)
        emit(res)
        if not (res["finite"] and res["max_abs_err"] <= KERNEL_TOL
                and res["rel_l2_err"] <= KERNEL_REL_TOL and stats_in_limits(res)
                and res["stats_call_output_bitwise_equal"]):
            raise AssertionError(f"flash_attention disagrees with its plain version: {res}")
        results.append(res)
        torch.cuda.empty_cache()
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
    res["profile"] = phase_profile(lambda frame: predict(frame, "argmax"), frames)
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
    """`model`'s weights in an fp32 model under `attn_impl: xla` (plain
    attention: the yardstick of both bf16 routes, though the kernels take
    fp32 too), trainable where `model` is."""
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.models.layers import set_attn_impl

    twin, _ = build_denseclip(model_cfg, CITYSCAPES_CLASSES, dtype=torch.float32, device="cuda",
                              seed=seed, remat=remat)
    set_attn_impl(twin, "xla")
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
    # the same weights in fp32 under attn_impl xla (plain attention) as the
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
    from denseclip_vit_multimodal_tpu_torch.models.layers import set_attn_impl
    from denseclip_vit_multimodal_tpu_torch.ops.attention import LAUNCHES as FLASH_LAUNCHES
    from denseclip_vit_multimodal_tpu_torch.tools.test import main as test_main

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = time.perf_counter()
    # the plain-attention calls of the evaluation (the text tower's, cached
    # once per model, included): the ViT's must all go to K1 / K4
    with counted_plain_attention() as plain_calls:
        results = test_main([CONFIG, TRAIN_WORK_DIR, "--aug-test", "--mode", "whole",
                             "--eval", "mIoU", "depth", "--set", *EVAL_OVERRIDES])
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
                            adversarial: bool, iters: int, dtype=torch.bfloat16) -> dict:
    """K5's prologue kernel held bitwise against its plain version (q8's q
    and k thirds, V's key-major copy, scales; the kernel leaves q8's v third
    unwritten, as K5 never reads it), then K5 (its launching wrapper) on the
    kernel's operands against its plain version on the plain prologue's;
    errors on the rows below `valid_len`, every row finite.  The bf16 K1 and
    SDPA at the same shape are context."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
        _launch,
        _launch_int8,
        _launch_quantize_int8,
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
    qkv = qkv.to(dtype)
    prologue = lambda: _launch_quantize_int8(qkv, heads, kv)

    def plain_prologue():
        q8, scales = quantize_qkv_int8(qkv, heads, kv)
        return q8, value_key_major(q8, heads), scales

    q8, vt, scales = prologue()
    plain_q8, plain_vt, plain_scales = plain_prologue()
    torch.cuda.synchronize()
    got = (q8[..., :2 * hd], vt, scales)
    want = (plain_q8[..., :2 * hd], plain_vt, plain_scales)
    prologue_equal = all(torch.equal(a, w) for a, w in zip(got, want))
    prologue_err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
    run = lambda: _launch_int8(q8, vt, scales, heads, scale, kv, qkv.dtype)
    plain = lambda: int8_attention_plain(plain_q8, plain_scales, heads, scale, kv, qkv.dtype)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    rerun_equal = torch.equal(out, run())
    err = out[:, :kv].float() - ref[:, :kv].float()
    ops = 4.0 * b * heads * n * kv * head_dim  # int8 Q K^T and P V
    qk_bytes = 2.0 * b * n * hd  # q8's q and k thirds: what K5 reads of q8, what the prologue writes
    nbytes = qk_bytes + vt.numel() + 4.0 * scales.numel() + out.numel() * out.element_size()
    # the prologue's function: one read of qkv, the writes of q8's q / k thirds,
    # V's copy and the scales; its two-pass design reads qkv a second time
    prologue_bytes = qkv.numel() * qkv.element_size() + qk_bytes + vt.numel() + 4.0 * scales.numel()
    design_bytes = prologue_bytes + qkv.numel() * qkv.element_size()
    qh, kh, vh = (t.reshape(b, n, heads, head_dim).transpose(1, 2).contiguous()
                  for t in qkv.to(torch.bfloat16).split(hd, dim=-1))
    kh, vh = kh[:, :, :kv].contiguous(), vh[:, :, :kv].contiguous()
    res = {
        "phase": "kernel_int8", "name": "qkv_attention_int8", "shape": [b, n, 3 * hd],
        "dtype": str(dtype).replace("torch.", ""),
        "heads": heads, "head_dim": head_dim, "valid_len": valid_len, "adversarial": adversarial,
        "max_abs_err": float(err.abs().max()), "mean_abs_err": float(err.abs().mean()),
        "rel_l2_err": float(err.norm() / ref[:, :kv].float().norm()),
        "max_abs_out": float(out[:, :kv].float().abs().max()),
        "finite": bool(torch.isfinite(out.float()).all()),
        "rerun_bitwise_equal": rerun_equal,
        "ms": cuda_ms(run, iters),
        "plain_ms": cuda_ms(plain, max(iters // 10, 2), warmup=1),
        "library_ms": None,  # no PyTorch call computes int8 attention
        "bound_ms": max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3,
        "bound_by": "operations" if ops / PEAK_INT8_OPS >= nbytes / PEAK_BYTES else "bytes",
        "prologue": {
            "name": "quantize_qkv_int8", "bitwise_equal": prologue_equal,
            "max_abs_err": prologue_err, "ms": cuda_ms(prologue, iters),
            "plain_ms": cuda_ms(plain_prologue, max(iters // 5, 2), warmup=1),
            "library_ms": None,  # no one PyTorch call quantizes per (batch, q/k/v, head)
            "bound_ms": prologue_bytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "design_bytes_ms": design_bytes / PEAK_BYTES * 1e3,  # two reads of qkv
        },
        "k1_bf16_ms": cuda_ms(lambda: _launch(qkv.to(torch.bfloat16), heads, scale, kv), iters),
        "sdpa_bf16_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters),
    }
    res["tops"] = ops / (res["ms"] * 1e-3) / 1e12
    return res


INT8_CASES = [
    # (b, n, heads, head_dim, valid_len, adversarial, iters[, qkv dtype])
    (10, 1536, 12, 64, 1522, False, 50),  # slide window batch: the serving shape
    (1, 8320, 12, 64, 8193, False, 10),  # a mode=whole request (8193 tokens, padded once)
    (2, 1100, 8, 128, 1050, False, 50),  # head dim 128
    (2, 1100, 8, 128, 1050, False, 50, torch.float32),  # fp32 qkv (the prologue's second type)
    (1, 256, 2, 64, 200, True, 50),  # adversarial pads (tests/test_int8_attention.py)
]


def phase_kernel_int8() -> list:
    results = []
    for case in INT8_CASES:
        res = qkv_attention_int8_case(*case)
        emit(res)
        if not res["prologue"]["bitwise_equal"]:
            raise AssertionError(f"quantize_qkv_int8 differs from its plain version: {res}")
        if not (res["finite"] and res["max_abs_err"] <= KERNEL_TOL and res["rerun_bitwise_equal"]
                and res["rel_l2_err"] <= KERNEL_REL_TOL and res["max_abs_out"] > 1e-3):
            raise AssertionError(f"qkv_attention_int8 disagrees with its plain version: {res}")
        results.append(res)
    return results  # the serving shape (the first) is the main path's


def mha_attention_case(b: int, n: int, heads: int, head_dim: int, valid_len, strided: bool,
                       iters: int, poison: bool = False) -> dict:
    """K3 (through `mha_attention`) against its plain version; errors on the
    rows below `valid_len` (the rest are unspecified), every row finite; its
    row statistics against the plain ones; with `poison`, NaN in the K / V
    rows past valid_len."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
        _launch_mha,
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
    if poison:
        poison_pad_keys(k, v, kv)
    run = lambda: mha_attention(q, k, v, valid_len=valid_len)
    plain = lambda: mha_attention_reference(q, k, v, valid_len=valid_len)
    out, ref = run(), plain()
    stats = torch.empty(b, heads, n, 2, device="cuda")
    out_s = _launch_mha(q, k, v, head_dim**-0.5, kv, stats)
    torch.cuda.synchronize()
    err = out[:, :kv].float() - ref[:, :kv].float()
    # the library yardstick: one fused-attention call on head-split copies
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kh, vh = kh[:, :, :kv].contiguous(), vh[:, :, :kv].contiguous()
    flops = 4.0 * b * heads * n * kv * head_dim
    nbytes = 2.0 * (3 * q.numel() + out.numel())
    res = {
        "phase": "kernel_oneshot", "name": "mha_attention", "shape": [b, n, heads, head_dim],
        "valid_len": valid_len, "strided": strided, "poisoned_pad_keys": poison,
        **row_stats_errors(stats, q, k, kv, head_dim**-0.5),
        "stats_call_output_bitwise_equal": torch.equal(out, out_s),
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
    (2, 1100, 8, 128, 1050, True, 50, True),  # head dim 128, ragged, NaN pad keys
    (2, 2048, 3, 256, None, False, 50),  # head dim 256 (the JAX rule admits it; K1 does not)
]


def phase_kernel_oneshot() -> list:
    results = []
    for case in ONESHOT_CASES:
        res = mha_attention_case(*case)
        emit(res)
        if not (res["finite"] and res["max_abs_err"] <= KERNEL_TOL
                and res["mean_abs_err"] <= KERNEL_MEAN_TOL and res["rel_l2_err"] <= KERNEL_REL_TOL
                and stats_in_limits(res) and res["stats_call_output_bitwise_equal"]):
            raise AssertionError(f"mha_attention disagrees with its plain version: {res}")
        results.append(res)
    return results  # the slide shape (the first) is the K3 row's


def ln_qkv_attention_case(b: int, n: int, dim: int, heads: int, valid_len, iters: int,
                          poison: bool = False) -> dict:
    """K6 against its plain version on a seeded x and seeded ln_1 / qkv
    parameters at the scale of the model's init (W bf16, handed over as the
    transposed view of the torch Linear layout: no cast inside the timing);
    beside it, the same function unfused in PyTorch's own calls and in the
    port's (LayerNorm, Linear, K1).  With `poison`, the rows of x past
    valid_len are NaN, so are the K / V rows the first stage writes there:
    the valid rows must stay finite.  Then K6's stages alone: the
    statistics against the plain ones and the second stage on the first
    stage's workspace against the whole kernel's output (both bitwise), the
    workspace against the plain projection, a rerun of the whole kernel
    (bitwise), and the split of its time: statistics, projection, the first
    stage, the second stage, beside `F.linear` at the projection's shape."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.models.layers import layer_norm_apply
    from denseclip_vit_multimodal_tpu_torch.ops.lnqkv_kernel import (
        kernel_fns,
        ln_qkv_attention,
        ln_qkv_attention_reference,
        ln_qkv_projection,
        ln_qkv_stats_reference,
        workspace_errors,
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
    if poison:
        x[:, kv:] = float("nan")
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

    # the first stage's workspace (valid rows: the pad rows of a poisoned x
    # are NaN), within one bf16 step plus the fp32 sums' error bound
    ws_errs = workspace_errors(ln_qkv_projection(*args), *args, rows=kv)
    # the stages through their entry points, on buffers of their own
    fns, rows = kernel_fns(), b * n
    stats = torch.empty(rows, 2, device="cuda")
    work = torch.empty(b, n, 3 * hd, dtype=torch.bfloat16, device="cuda")
    out2 = torch.empty(b, n, hd, dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def check(err_code):
        if err_code != 0:
            raise RuntimeError(f"K6 stage launch failed: cudaError {err_code}")

    stats_run = lambda: check(fns["stats"](x.data_ptr(), stats.data_ptr(), rows, dim, 1e-5, stream))
    proj_run = lambda: check(fns["projection"](
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w16.data_ptr(), bias.data_ptr(),
        stats.data_ptr(), work.data_ptr(), rows, dim, hd, d**-0.5 * LOG2E, stream))
    stage2_run = lambda: check(fns["stage2"](work.data_ptr(), out2.data_ptr(), b, n, heads, d, kv,
                                             stream))
    stats_run()
    proj_run()
    stage2_run()
    again = run()
    torch.cuda.synchronize()
    valid_stats = stats.view(b, n, 2)[:, :kv]
    stats_equal = torch.equal(valid_stats, ln_qkv_stats_reference(x[:, :kv]))
    split = {
        "stats_ms": cuda_ms(stats_run, iters),
        "projection_ms": cuda_ms(proj_run, iters),
        "first_stage_ms": cuda_ms(lambda: (stats_run(), proj_run()), iters),
        "stage2_ms": cuda_ms(stage2_run, iters),
        "linear_ms": cuda_ms(lambda: F.linear(x, w16, bias16), iters),
        "projection_bound_ms": proj_flops / PEAK_BF16_FLOPS * 1e3,
        "stats_bound_ms": (2.0 * x.numel() + 8.0 * rows) / PEAK_BYTES * 1e3,
    }
    split["projection_tflops"] = proj_flops / (split["projection_ms"] * 1e-3) / 1e12
    res = {
        "phase": "kernel_lnqkv", "name": "ln_qkv_attention", "shape": [b, n, dim], "heads": heads,
        "head_dim": d, "valid_len": valid_len, "poisoned_pad_rows": poison,
        "max_abs_err": float(err.abs().max()), "mean_abs_err": float(err.abs().mean()),
        "rel_l2_err": float(err.norm() / ref[:, :kv].float().norm()),
        "finite": bool(torch.isfinite(out[:, :kv].float()).all()),
        "rerun_bitwise_equal": bitwise_equal(out, again),
        "workspace": ws_errs, "workspace_in_limits": ws_errs["max_share_of_limit"] <= 1.0,
        "stats_bitwise_equal": stats_equal, "stage2_bitwise_equal": bitwise_equal(out2, out),
        "ms": cuda_ms(run, iters),
        "plain_ms": cuda_ms(plain, max(iters // 10, 2), warmup=1),
        "library_ms": cuda_ms(library, iters),
        "port_unfused_ms": cuda_ms(port_unfused, iters),
        "k1_alone_ms": cuda_ms(lambda: mha_qkv_attention(qkv, heads, valid_len=valid_len), iters),
        "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
        "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes",
        "projection_bound_ms": split["projection_bound_ms"], "split": split,
    }
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    return res


LNQKV_CASES = [
    # (b, n, dim, heads, valid_len, iters)
    (10, 1536, 768, 12, 1522, 50),  # the slide window batch: the fused path's shape
    (2, 1100, 768, 6, 1050, 50, True),  # head dim 128, NaN in the pad rows of x
    (1, 3968, 768, 12, None, 20),  # the largest N lnqkv_supported admits at D 768
]


def phase_kernel_lnqkv() -> list:
    results = []
    for case in LNQKV_CASES:
        res = ln_qkv_attention_case(*case)
        emit(res)
        if not (res["finite"] and res["max_abs_err"] <= KERNEL_TOL
                and res["mean_abs_err"] <= KERNEL_MEAN_TOL and res["rel_l2_err"] <= KERNEL_REL_TOL
                and res["rerun_bitwise_equal"] and res["workspace_in_limits"]
                and res["stats_bitwise_equal"] and res["stage2_bitwise_equal"]):
            raise AssertionError(f"ln_qkv_attention disagrees with its plain version: {res}")
        results.append(res)
    return results  # the slide shape, ..., the two ADE20K shapes, the three ViT-L/14, flash's


FUSED_ENV = "DENSECLIP_FUSED_LNQKV"


@contextlib.contextmanager
def fused_lnqkv(on: bool):
    """DENSECLIP_FUSED_LNQKV set to 1 (or 0) inside the block only."""
    before = os.environ.get(FUSED_ENV)
    os.environ[FUSED_ENV] = "1" if on else "0"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(FUSED_ENV, None)
        else:
            os.environ[FUSED_ENV] = before


def phase_lnqkv_path(unfused_profile: dict) -> dict:
    """main_path's slide protocol with the fused LN + qkv + attention kernel
    (DENSECLIP_FUSED_LNQKV=1, set here and unset on the way out); its device
    time per frame beside main_path's (`unfused_profile`, the same run)."""
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
    with fused_lnqkv(True):
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
        profile = phase_profile(lambda f: predict(f, "argmax"), frames[:2],
                                path="fused_lnqkv_serving")
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
        "device_busy_ms_per_frame": profile["device_busy_ms_per_frame"],
        "unfused_device_busy_ms_per_frame": unfused_profile["device_busy_ms_per_frame"],
        "k6_ms_per_frame": profile["groups_ms_per_frame"].get("ln_qkv_attention (K6)"),
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
    """`frame` (uint8 [H, W, 3] RGB or [H, W] gray, or uint16 [H, W] gray) as a
    PNG whose rows all carry the Paeth filter, as encoders pick it for most
    rows of a photograph: the decoder's anti-diagonal path (the server's own
    bodies above use filter 0).  The filter works on bytes, with bpp =
    channels x bytes per sample: 2 for 16-bit gray, stored big-endian."""
    from denseclip_vit_multimodal_tpu_torch.utils import png

    h, w = frame.shape[:2]
    channels = 1 if frame.ndim == 2 else frame.shape[2]
    size = frame.dtype.itemsize
    x = np.ascontiguousarray(frame.astype(frame.dtype.newbyteorder(">"))).view(np.uint8)
    x = x.reshape(h, w, channels * size).astype(np.int16)
    a = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1]  # left
    b = np.pad(x, ((1, 0), (0, 0), (0, 0)))[:-1]  # up
    c = np.pad(x, ((1, 0), (1, 0), (0, 0)))[:-1, :-1]  # upper left
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = ((x - pred) % 256).astype(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.full((h, 1), 4, np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * size, 2 if channels == 3 else 0, 0, 0, 0)
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
    want = expected_launches(qkv_attention_int8=12, quantize_qkv_int8=12)
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
           "masked_dkdv_exact_zero": not (got[1][:, kv:].any() or got[2][:, kv:].any()),
           "rerun_bitwise_equal": rerun_bitwise_equal(bwd, got)}
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
    return bwd_rates(res, flops, head_dim)


ONESHOT_BWD_CASES = [
    (8, 1664, 12, 64, 1601, 10),  # heritage training at the JAX tool's batch 8 (crop 640, padded once)
    (2, 1100, 8, 128, 1050, 20),  # head dim 128, ragged
    (2, 2048, 3, 256, 2000, 20),  # head dim 256 (K3's own case at 256), ragged
]


def phase_kernel_oneshot_bwd() -> list:
    results = []
    for case in ONESHOT_BWD_CASES:
        res = mha_attention_bwd_case(*case)
        emit(res)
        bad = grads_out_of_limits(res)
        if bad or not (res["finite"] and res["masked_dkdv_exact_zero"]
                       and res["rerun_bitwise_equal"]):
            raise AssertionError(f"mha_attention_bwd disagrees with its plain version ({bad}): {res}")
        results.append(res)
    return results  # the training shape (the first) is the K3 backward row's; the last D = 256


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
           "pad_exact_zero": not any(g[:, kv:].any() for g in got),
           "rerun_bitwise_equal": rerun_bitwise_equal(bwd, got)}
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
    return bwd_rates(res, flops, head_dim)


FLASH_BWD_CASES = [
    (2, 9344, 12, 64, 9217, False, 5),  # train_long: batch 2, crop 1536 (9217 tokens, padded once)
    (2, 2048, 12, 64, None, True, 20),  # causal
    (2, 1100, 8, 128, 1050, False, 20),  # head dim 128, ragged
    (2, 8704, 4, 256, 8600, False, 5),  # head dim 256 past the one-shot limit: two dk/dv passes
]


def phase_kernel_flash_bwd() -> list:
    results = []
    for case in FLASH_BWD_CASES:
        res = flash_attention_bwd_case(*case)
        emit(res)
        bad = grads_out_of_limits(res)
        if bad or not (res["finite"] and res["pad_exact_zero"] and res["rerun_bitwise_equal"]):
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
    heads = res["heads"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(hd, hd, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    # the tool's main() reports A's parts (K1, the matmul, the cast), K7's
    # TFLOP/s and the bound, from this run's shapes
    res.update({
        "phase": "outproj_path", "entry_point": "tools/exp_outproj_epilogue.py main()",
        "launches": launches,
        "plain_ms": cuda_ms(lambda: exp.qkv_out_attention_reference(qkv, w, heads), 2, warmup=1),
        "ms": min(res["B_ms"], res["B2_ms"]), "a_ms": min(res["A_ms"], res["A2_ms"]),
        "max_abs_err": res["max_abs_err_b_vs_plain"],
        "library_ms": None,  # no one PyTorch call computes attention + out-projection
    })
    emit(res)
    if not (res["finite"] and res["rel_l2_b_vs_plain"] <= KERNEL_REL_TOL
            and res["rel_err_b_vs_plain"] <= KERNEL_TOL and res["rel_err_a_vs_b"] <= KERNEL_TOL):
        raise AssertionError(f"the out-projection epilogue kernel disagrees: {res}")
    if not launches["qkv_out_attention"] or not launches["qkv_attention"]:
        raise AssertionError(f"the experiment did not run K7 and K1: {launches}")
    # K7 in fp32 at the experiment's shape, called directly (the tool has no
    # dtype flag, as the JAX script has none), beside K1 fp32 + torch.matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launches()
    res["fp32"] = outproj_mode_case(torch.float32, None, b, n, heads, hd // heads, None, 3)
    res["fp32"]["launches"] = read_launches()
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


BENCH_ARGS = ["--iters", "4", "--rounds", "3"]  # the full protocol at fewer frames
BENCH_KEYS = ("value", "value_reference_protocol", "latency_ms_p50", "latency_ms_p90",
              "model_tflops_per_image", "mfu_pct", "peak_bf16_tflops", "device",
              "power_limit_w")
# served (kernels + their FLOP make-up) against the plain route (aten counts
# plain attention) on one slide frame, relative
FLOP_TOL = 5e-3
FLOP_ROUTES = (  # (route, attn_impl, DENSECLIP_FUSED_LNQKV, the kernel it launches)
    ("unfused", "auto", False, "qkv_attention"),
    ("fused", "auto", True, "ln_qkv_attention"),
    ("int8", "int8", False, "qkv_attention_int8"),
)
SUITE_SMOKE_ARGS = ["--workloads", "2", "9", "--iters", "2", "--rounds", "2",
                    "--out", "build/bench_suite_smoke.json"]


@contextlib.contextmanager
def plain_attention_route():
    """`ops/attention.py::_on_cuda` answers False: every attention branch of
    the model takes plain attention, which FlopCounterMode counts."""
    from denseclip_vit_multimodal_tpu_torch.ops import attention

    on_cuda = attention._on_cuda
    attention._on_cuda = lambda x: False
    try:
        yield
    finally:
        attention._on_cuda = on_cuda


def phase_bench_path() -> dict:
    """The port's benchmark through its user entry points: `bench.py`
    `main()` at full width on both protocols (fewer frames), the FLOP
    accounting held against FlopCounterMode's count of the plain route on
    the unfused, fused and int8 paths, and the suite's workloads 2 and 9."""
    from denseclip_vit_multimodal_tpu_torch import bench
    from denseclip_vit_multimodal_tpu_torch.models.layers import set_attn_impl
    from denseclip_vit_multimodal_tpu_torch.tools import bench_suite
    from denseclip_vit_multimodal_tpu_torch.utils.flops import attention_flops, program_flops

    torch.cuda.empty_cache()
    start = time.perf_counter()
    reset_launches()
    line = bench.main(BENCH_ARGS)  # prints the bench line
    launches = read_launches()
    bench_s = time.perf_counter() - start
    missing = [k for k in BENCH_KEYS if line.get(k) is None]
    if missing or not 0.0 < line["mfu_pct"] <= 100.0:
        raise AssertionError(f"bench line: missing {missing} or MFU out of (0, 100]: {line}")
    if not launches["qkv_attention"] or any(
            v for k, v in launches.items() if k != "qkv_attention"):
        raise AssertionError(f"the bench ran no K1, or another kernel: {launches}")

    # one slide frame counted as served (kernels launched, the tally adding
    # their FLOPs) and on the plain route; the kernels score N x kv_len,
    # plain attention (masking the pad keys) N x N
    engine, frame_fn = bench.setup(bench.parse_args([]))
    frame = frame_fn(bench.CROP_SHIPPED)
    backbone = engine.model.backbone
    layers, width = backbone.layers, backbone.width
    grid = bench.CROP_SHIPPED[0] // backbone.patch_size
    kv = grid * grid + 1
    n = -(-kv // 128) * 128
    windows = 10
    gap = layers * windows * attention_flops(1, n, n - kv, width)
    cause = (f"plain attention scores N x N ({n} x {n}) where the kernels score N x kv_len "
             f"({n} x {kv}): {layers} layers x {windows} windows x 4 x {n} x {n - kv} x {width}")
    flop_checks = {}
    for route, attn_impl, fused, kernel in FLOP_ROUTES:
        set_attn_impl(engine.model, attn_impl)
        with fused_lnqkv(fused):
            frame()  # warm-up
            reset_launches()
            served = program_flops(frame)
            served_launches = read_launches()
            with plain_attention_route():
                plain = program_flops(frame)
                plain_launches = read_launches()
        check = {"served_flops": served.total, "served_aten_flops": served.aten,
                 "served_kernel_flops": served.kernels, "by_kernel": served.by_kernel,
                 "plain_flops": plain.total, "rel_gap": (plain.total - served.total) / plain.total,
                 "gap_explained_by_pad_keys": plain.total - served.total == gap,
                 "kernel_launches": served_launches[kernel]}
        flop_checks[route] = check
        if not (abs(check["rel_gap"]) <= FLOP_TOL and check["gap_explained_by_pad_keys"]
                and served_launches[kernel] == layers and plain_launches == served_launches
                and plain.kernels == 0):
            raise AssertionError(f"{route}: served and plain FLOP counts disagree ({cause}): "
                                 f"{check}, launches {served_launches} / {plain_launches}")
    set_attn_impl(engine.model, "auto")
    del engine, frame
    torch.cuda.empty_cache()

    suite = bench_suite.main(SUITE_SMOKE_ARGS)
    by_metric = {r["metric"]: r for r in suite}
    for name in ("slide_1024x2048_multitask", "slide_1024x2048_multitask_mfu",
                 "eval_path_device_1024x2048_slide"):
        if not by_metric.get(name, {}).get("value", 0) > 0:
            raise AssertionError(f"suite workload {name} missing or not positive: {suite}")
    if not by_metric["slide_1024x2048_multitask_mfu"]["value"] <= 100.0:
        raise AssertionError(f"suite MFU above 100%: {suite}")
    res = {"phase": "bench_path", "entry_points": ["bench.py main()",
                                                   "tools/bench_suite.py main()"],
           "bench": line, "bench_s": bench_s, "launches": launches,
           "flop_checks": flop_checks, "flop_gap_cause": cause, "flop_tol": FLOP_TOL,
           "suite": suite, "seconds": time.perf_counter() - start}
    emit(res)
    return res


CITY_TRAIN, CITY_VAL = 16, 4  # triplets of the written tree, over two cities a split
CITY_HW = (1024, 2048)
CITY_STEPS = 2  # through tools/train.py; the first is the warm-up (3 until the ViT-L/14 phase)
CITY_DECODE_SAMPLES = 4  # timed one by one, in one thread
# 512x1024 crops: 32 x 64 + 1 = 2049 tokens, padded once to 2176
CITY_TOKENS, CITY_PADDED = 32 * 64 + 1, 2176
CITY_SLIDE_LAUNCHES = 12  # per 1024x2048 frame: one slide batch of 10 windows, 12 layers
CITY_VISUAL = (768, 12, 16, 197, 512)  # ViT-B/16: width, layers, patch, positions, proj
CITY_TEXT = (512, 12, 49408, 77, 512)  # width, layers, vocab, positions, projection
CITY_CONTEXT = 22  # the text tower's capacity: the pos-embed keeps archive[:22]


class _FirstSamples:
    """The first `n` samples of a dataset, as a dataset."""

    def __init__(self, dataset, n: int):
        self.dataset, self.n = dataset, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        return self.dataset[i]


def write_cityscapes_tree(root: str, seed: int, encode=None) -> None:
    """A seeded Cityscapes tree written by the port's own encoder, every row
    Paeth-filtered (`encode` another encoder of the same arrays):
    `leftImg8bit` RGB, `gtFine_labelIds` 8-bit gray over ids 0..33,
    `disparity` uint16 with zeros (a fifth of the pixels)."""
    encode = encode or _paeth_png
    rs = np.random.RandomState(seed)
    h, w = CITY_HW
    for split, n, cities in (("train", CITY_TRAIN, ("aachen", "bochum")),
                             ("val", CITY_VAL, ("frankfurt", "lindau"))):
        for i in range(n):
            city = cities[i % 2]
            disparity = rs.randint(1, 30000, (h, w)).astype(np.uint16)
            disparity[rs.rand(h, w) < 0.2] = 0
            for top, suffix, arr in (
                    ("leftImg8bit", "leftImg8bit", rs.randint(0, 256, (h, w, 3), dtype=np.uint8)),
                    ("gtFine", "gtFine_labelIds", rs.randint(0, 34, (h, w)).astype(np.uint8)),
                    ("disparity", "disparity", disparity)):
                folder = os.path.join(root, top, split, city)
                os.makedirs(folder, exist_ok=True)
                with open(os.path.join(folder, f"{city}_{i:06d}_000019_{suffix}.png"), "wb") as f:
                    f.write(encode(arr))


def _stub_draws(seed: int):
    """Seeded fp16 draws of a stub archive: small normals and LayerNorm /
    BatchNorm scales near 1."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: (0.02 * torch.randn(*shape, generator=gen)).half()
    one = lambda n: (1.0 + 0.02 * torch.randn(n, generator=gen)).half()
    return gen, rnd, one


def _stub_tower(rnd, one, prefix: str, w: int, layers: int) -> dict:
    out = {}
    for i in range(layers):
        b = f"{prefix}.resblocks.{i}."
        out.update({b + "ln_1.weight": one(w), b + "ln_1.bias": rnd(w),
                    b + "attn.in_proj_weight": rnd(3 * w, w), b + "attn.in_proj_bias": rnd(3 * w),
                    b + "attn.out_proj.weight": rnd(w, w), b + "attn.out_proj.bias": rnd(w),
                    b + "ln_2.weight": one(w), b + "ln_2.bias": rnd(w),
                    b + "mlp.c_fc.weight": rnd(4 * w, w), b + "mlp.c_fc.bias": rnd(4 * w),
                    b + "mlp.c_proj.weight": rnd(w, 4 * w), b + "mlp.c_proj.bias": rnd(w)})
    return out


def _stub_text(rnd, one, text) -> dict:
    tw, tl, vocab, tpos, tproj = text
    return {"token_embedding.weight": rnd(vocab, tw), "positional_embedding": rnd(tpos, tw),
            **_stub_tower(rnd, one, "transformer", tw, tl), "ln_final.weight": one(tw),
            "ln_final.bias": rnd(tw), "text_projection": rnd(tw, tproj),
            "logit_scale": torch.tensor(4.6052).half()}


def write_stub_clip(path: str, seed: int) -> dict:
    """A stub OpenAI CLIP ViT-B/16 checkpoint: OpenAI's key names at the
    published shapes, seeded, in fp16 as released, pickled by torch.save."""
    _, rnd, one = _stub_draws(seed)
    vw, vl, patch, vpos, vproj = CITY_VISUAL
    state = {"visual.conv1.weight": rnd(vw, 3, patch, patch), "visual.class_embedding": rnd(vw),
             "visual.positional_embedding": rnd(vpos, vw), "visual.ln_pre.weight": one(vw),
             "visual.ln_pre.bias": rnd(vw), **_stub_tower(rnd, one, "visual.transformer", vw, vl),
             "visual.ln_post.weight": one(vw), "visual.ln_post.bias": rnd(vw),
             "visual.proj": rnd(vw, vproj), **_stub_text(rnd, one, CITY_TEXT)}
    torch.save(state, path)
    return state


def write_stub_rn50_clip(path: str, seed: int) -> dict:
    """A stub OpenAI CLIP RN50 checkpoint: `ModifiedResNet`'s key names at the
    published shapes (3-conv stem, [3, 4, 6, 3] bottlenecks with
    `downsample.0` / `.1`, `attnpool` with its [50, 2048] pos-embed and
    c_proj to 1024) and the 512-wide text tower projecting to 1024, seeded,
    in fp16, pickled by torch.save.  Each conv's weights are scaled by
    1 / sqrt(fan-in), so the activations keep their size through the stages."""
    gen, rnd, one = _stub_draws(seed)
    width, layers, grid, out_dim = RN50_VISUAL
    state = {}

    def conv_bn(conv: str, bn: str, cout: int, cin: int, k: int) -> None:
        w = torch.randn(cout, cin, k, k, generator=gen) / (cin * k * k) ** 0.5
        state[f"visual.{conv}.weight"] = w.half()
        state.update({f"visual.{bn}.weight": one(cout), f"visual.{bn}.bias": rnd(cout),
                      f"visual.{bn}.running_mean": rnd(cout),
                      f"visual.{bn}.running_var": (0.5 + torch.rand(cout, generator=gen)).half(),
                      f"visual.{bn}.num_batches_tracked": torch.tensor(0)})

    conv_bn("conv1", "bn1", width // 2, 3, 3)
    conv_bn("conv2", "bn2", width // 2, width // 2, 3)
    conv_bn("conv3", "bn3", width, width // 2, 3)
    cin = width
    for li, (blocks, mult) in enumerate(zip(layers, (1, 2, 4, 8)), start=1):
        planes = width * mult
        for bi in range(blocks):
            b = f"layer{li}.{bi}"
            conv_bn(f"{b}.conv1", f"{b}.bn1", planes, cin, 1)
            conv_bn(f"{b}.conv2", f"{b}.bn2", planes, planes, 3)
            conv_bn(f"{b}.conv3", f"{b}.bn3", planes * 4, planes, 1)
            if bi == 0:
                conv_bn(f"{b}.downsample.0", f"{b}.downsample.1", planes * 4, cin, 1)
            cin = planes * 4
    embed = width * 32
    state["visual.attnpool.positional_embedding"] = (
        torch.randn(grid * grid + 1, embed, generator=gen) / embed**0.5).half()
    for name, cout in (("q_proj", embed), ("k_proj", embed), ("v_proj", embed),
                       ("c_proj", out_dim)):
        state[f"visual.attnpool.{name}.weight"] = (
            torch.randn(cout, embed, generator=gen) / embed**0.5).half()
        state[f"visual.attnpool.{name}.bias"] = rnd(cout)
    state.update(_stub_text(rnd, one, RN50_TEXT))
    torch.save(state, path)
    return state


_REFERENCE_NAMES = (  # the port's module names -> the reference trainer's
    (r"^neck\.process\.(\d+)\.conv\.", r"neck.process_layers.\1.0."),
    (r"^neck\.process\.(\d+)\.bn\.", r"neck.process_layers.\1.1."),
    (r"^neck\.fuse\.conv\.", "neck.fusion_layer.0."), (r"^neck\.fuse\.bn\.", "neck.fusion_layer.1."),
    (r"^(decode_head|depth_head)\.conv0\.", r"\1.0."), (r"^(decode_head|depth_head)\.bn0\.", r"\1.1."),
    (r"^(decode_head|depth_head)\.conv1\.", r"\1.4."),
)


def reference_checkpoint(clip: dict, model_state: dict, epoch: int) -> dict:
    """A reference trainer's checkpoint (`module.`-prefixed state_dict under
    the reference's names): the towers from the CLIP archive's tensors, the
    neck, heads, projections and contexts from `model_state`, and `gamma`."""
    import re

    ref = {f"backbone.{k[len('visual.'):]}": v for k, v in clip.items() if k.startswith("visual.")}
    ref.update({f"text_encoder.{k}": v for k, v in clip.items()
                if not k.startswith("visual.") and k != "logit_scale"})
    ref["text_encoder.positional_embedding"] = clip["positional_embedding"][:CITY_CONTEXT]
    for key, value in model_state.items():
        if key.split(".")[0] in ("neck", "decode_head", "depth_head", "vis_proj", "global_proj",
                                 "contexts"):
            for pattern, repl in _REFERENCE_NAMES:
                key = re.sub(pattern, repl, key)
            ref[key] = value.cpu()
    ref["gamma"] = torch.full((CITY_TEXT[4],), 1e-4)
    return {"epoch": epoch, "best_metric": None,
            "state_dict": {f"module.{k}": v for k, v in ref.items()}}


def endless(loader):
    """The loader's batches epoch after epoch (closing it closes the epoch's threads)."""
    for epoch in itertools.count():
        yield from loader.epoch(epoch)


def phase_cityscapes_path(tmp=None) -> dict:
    """The flagship fine-tuned from a (stub) OpenAI CLIP checkpoint on an
    on-disk Cityscapes tree, through the user entry points: `tools/train.py`
    (CLIP import, CITY_STEPS steps), `tools/test.py` on `val` (slide, crop
    624 / stride 426), `tools/train.py --load` (1 step), and
    `tools/import_checkpoint.py` on a reference-format checkpoint, then
    `tools/test.py` on one frame of it.  The tree (`<tmp>/cityscapes`), the
    archive and every work dir live in `tmp`, a temporary dir removed at the
    end unless the caller gives one."""
    import tempfile

    if tmp is not None:
        return _cityscapes_path(tmp)
    with tempfile.TemporaryDirectory(prefix="cityscapes_smoke_") as tmp:
        return _cityscapes_path(tmp)


def _cityscapes_path(tmp: str) -> dict:
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config
    from denseclip_vit_multimodal_tpu_torch.data import _native
    from denseclip_vit_multimodal_tpu_torch.data import cityscapes as cs
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
    from denseclip_vit_multimodal_tpu_torch.tools import import_checkpoint
    from denseclip_vit_multimodal_tpu_torch.tools import test as test_tool
    from denseclip_vit_multimodal_tpu_torch.tools import train as train_tool
    from denseclip_vit_multimodal_tpu_torch.train import checkpoint as ckpt_lib
    from denseclip_vit_multimodal_tpu_torch.train.clip_import import load_clip_into_model
    from denseclip_vit_multimodal_tpu_torch.train.loop import train_step_from_cfg
    from denseclip_vit_multimodal_tpu_torch.train.losses import cross_entropy_loss, silog_loss
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state

    tree, archive = os.path.join(tmp, "cityscapes"), os.path.join(tmp, "ViT-B-16.pt")
    work_dir, load_dir = os.path.join(tmp, "wd"), os.path.join(tmp, "wd_load")
    import_dir, ref_path = os.path.join(tmp, "wd_import"), os.path.join(tmp, "reference.pth")
    sets = ["--set", f"data.path={tree}", f"model.clip_pretrained={archive}"]
    cfg = load_config(CONFIG, overrides=sets[1:])
    seed, batch_size = int(cfg.training.seed), int(cfg.training.batch_size)
    start = time.perf_counter()
    write_cityscapes_tree(tree, SEED)
    clip = write_stub_clip(archive, SEED)
    written_s = time.perf_counter() - start
    res = {"phase": "cityscapes_path", "config": CONFIG, "tree": {
        "train": CITY_TRAIN, "val": CITY_VAL, "frame": list(CITY_HW), "filter": "Paeth",
        "bytes": sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tree) for f in fs)},
        "archive_bytes": os.path.getsize(archive), "write_s": written_s,
        "batch": batch_size, "crop": list(cfg.data.crop_size), "tokens": CITY_TOKENS,
        "padded_tokens": CITY_PADDED}
    part = lambda *keys: emit({"phase": "cityscapes_path", **{k: res[k] for k in keys}})

    # the host ops: built by g++ into build/host/, bitwise equal to numpy on the tree's files
    native = _native.status()
    train_ds = build_dataset(cfg.data, "train")
    labels = [cs.read_label_ids(t[1]) for t in train_ds.samples[:2]]
    disparities = [cs.read_disparity(t[2]) for t in train_ds.samples[:2]]
    native_ok = native["loaded"] and os.sep + os.path.join("build", "host") in native["path"]
    native_ok = native_ok and all(
        np.array_equal(_native.remap_labels(lab, cs.ID_TO_TRAIN_ID, cs.IGNORE_INDEX),
                       cs.remap_labels_numpy(lab)) for lab in labels)
    native_ok = native_ok and all(
        np.array_equal(cs.disparity_to_depth(d)[0], cs.disparity_to_depth_numpy(d)[0])
        for d in disparities)
    res["native"] = {**native, "bitwise_equal_to_numpy": native_ok}
    if not native_ok:
        raise AssertionError(f"native host ops missing or unequal to numpy: {res['native']}")

    # decode ms per sample (one thread), and the loader alone: one thread and
    # the preset's `workers` (the decode is Python under the GIL)
    parts = {"image": cs.read_image, "labels": cs.read_label_ids, "disparity": cs.read_disparity}
    decode_ms = {name: 0.0 for name in parts}
    for triplet in train_ds.samples[:CITY_DECODE_SAMPLES]:
        for (name, read), path in zip(parts.items(), triplet):
            tick = time.perf_counter()
            read(path)
            decode_ms[name] += (time.perf_counter() - tick) * 1e3 / CITY_DECODE_SAMPLES
    res["decode_ms_per_sample"] = {**decode_ms, "total": sum(decode_ms.values())}
    workers = int(cfg.training.get("workers", 8))
    res["loader"] = {"samples": batch_size, "samples_per_s_by_threads": {}}
    first_batch = _FirstSamples(train_ds, batch_size)  # one batch, not the epoch: a cut of time
    for threads in (1, workers):
        loader = DataLoader(first_batch, batch_size=batch_size, seed=seed, num_threads=threads)
        tick = time.perf_counter()
        n = sum(b["image"].shape[0] for b in loader.epoch(0))
        res["loader"]["samples_per_s_by_threads"][threads] = n / (time.perf_counter() - tick)

    # 1. tools/train.py: CLIP import + CITY_STEPS steps on the tree
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tick = time.perf_counter()
    summary = train_tool.main([CONFIG, "--work-dir", work_dir, "--no-validate",
                               "--max-steps", str(CITY_STEPS), *sets])
    train_s = time.perf_counter() - tick
    launches = read_launches()
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    timed = log[1:]  # the first step pays the set-up
    res["training"] = {
        "entry_point": "tools/train.py main()", "steps": len(log), "wall_s": train_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
        "launches_per_step": {k: v / len(log) for k, v in launches.items()},
        "ms_per_step": 1e3 * sum(e["step_s"] for e in timed) / len(timed),
        "data_wait_ms_per_step": 1e3 * sum(e["data_s"] for e in timed) / len(timed),
        "first_step": {"step_ms": 1e3 * log[0]["step_s"], "data_wait_ms": 1e3 * log[0]["data_s"]},
        "samples_per_s": batch_size * len(timed) / sum(e["step_s"] + e["data_s"] for e in timed),
        "losses": [{k: e[k] for k in ("loss_seg", "loss_silog", "loss_total")} for e in log]}
    emit(res)  # the set-up, the host ops, decode, the loader and the training run
    if not (summary["step"] == CITY_STEPS == len(log) and all(
            np.isfinite(e[k]) and not e["skipped"] for e in log
            for k in ("loss_seg", "loss_silog", "loss_total"))):
        raise AssertionError(f"tools/train.py did not take {CITY_STEPS} finite steps: {summary}")
    # the preset trains the neck and heads on frozen towers (no lr_mults: the
    # backbone and the text tower stay frozen), so the ViT runs K1 forward only
    if launches != expected_launches(qkv_attention=12 * CITY_STEPS):
        raise AssertionError(f"expected {12 * CITY_STEPS} K1 launches in training: {launches}")

    # the import on its own: the archive's tensors under the mapping, fp16 -> fp32
    model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.bfloat16,
                                   device="cuda", seed=seed)
    n_vis, n_txt = load_clip_into_model(model, archive, cfg.model)
    own = model.state_dict()
    vw, vl, patch = CITY_VISUAL[:3]
    want = {
        "backbone.patch_embed.weight": clip["visual.conv1.weight"].permute(0, 2, 3, 1).reshape(vw, -1),
        f"backbone.transformer.blocks.{vl // 2}.attn.qkv.weight":
            clip[f"visual.transformer.resblocks.{vl // 2}.attn.in_proj_weight"],
        "text_encoder.positional_embedding": clip["positional_embedding"][:CITY_CONTEXT],
        # shapes match ([768, 512]): taken, as the JAX importer takes it
        "backbone.proj": clip["visual.proj"],
    }
    import_ok = {k: torch.equal(own[k].cpu(), v.float()) for k, v in want.items()}
    res["import"] = {"visual_tensors": n_vis, "text_tensors": n_txt, "equal": import_ok}
    if not (all(import_ok.values()) and n_vis == 12 * vl + 8 and n_txt == 12 * CITY_TEXT[1] + 5):
        raise AssertionError(f"the CLIP import does not place the archive's tensors: {res['import']}")

    # the first step's total loss, kernels against plain attention: the same
    # CLIP-imported weights, augmented batch and dropout masks
    aug_cfg = augment_config_from_data_cfg(cfg.data)
    loader_iter = endless(loader)
    try:
        first = next(loader_iter)
        batch = augment_batch(to_device(first, "cuda"), aug_cfg,
                              torch.Generator().manual_seed(seed))

        def total_loss() -> float:
            with torch.no_grad():
                out = model(batch["image"], texts, train=True, gt_hw=tuple(aug_cfg.crop_size),
                            gen=torch.Generator(device="cuda").manual_seed(seed))
                return float(cross_entropy_loss(out["seg"], batch["seg"]) + 0.1 * silog_loss(
                    out["depth"], batch["depth"], batch["depth_mask"]))

        before = read_launches()["qkv_attention"]
        kernel_loss = total_loss()
        kernel_launched = read_launches()["qkv_attention"] - before
        set_attn_impl(model, "xla")
        plain_loss = total_loss()
        set_attn_impl(model, "auto")
        del batch
        res["vs_plain"] = {"loss_kernel": kernel_loss, "loss_plain": plain_loss,
                           "loss_rel_diff": abs(kernel_loss - plain_loss) / abs(plain_loss),
                           "k1_launches": kernel_launched, "tol": TRAIN_TOL}
        if not (kernel_launched == 12 and res["vs_plain"]["loss_rel_diff"] <= TRAIN_TOL):
            raise AssertionError(f"the first step disagrees with plain attention: {res['vs_plain']}")

        # where a step's time goes, data wait included (the "frame" is a step)
        state = create_train_state(model, cfg.training, len(loader))
        step = train_step_from_cfg(texts, cfg.training, cfg.data, seed)
        step(state, to_device(first, "cuda"))  # warm-up, on the batch decoded above
        res["profile"] = phase_profile(lambda _: step(state, to_device(next(loader_iter), "cuda")),
                                       [0], path="cityscapes_training")
    finally:
        loader_iter.close()
    del model, state, step
    torch.cuda.empty_cache()

    # 2. tools/test.py on val: the flagship's slide protocol
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tick = time.perf_counter()
    results = test_tool.main([CONFIG, work_dir, "--mode", "slide", "--single-protocol",
                              "--eval", "mIoU", "depth", *sets])
    launches = read_launches()
    keys = ["mIoU", "pixel_acc"] + [f"depth/{k}" for k in
                                    ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")]
    res["eval"] = {"entry_point": "tools/test.py main()", "frames": CITY_VAL,
                   "timed_frames": CITY_VAL - 1, "wall_s": time.perf_counter() - tick,
                   "s_per_frame": 1.0 / results["images_per_sec"],
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
                   "metrics": {k: results.get(k) for k in keys}}
    part("import", "vs_plain", "eval")
    if launches != expected_launches(qkv_attention=CITY_SLIDE_LAUNCHES * CITY_VAL):
        raise AssertionError(f"expected {CITY_SLIDE_LAUNCHES} K1 launches a frame: {launches}")
    if not all(results.get(k) is not None and np.isfinite(results[k]) for k in keys):
        raise AssertionError(f"non-finite evaluation metrics: {res['eval']['metrics']}")

    # 3. tools/train.py --load: the checkpoint's weights, a fresh optimizer, step 0
    source = torch.load(os.path.join(work_dir, "checkpoints", "latest"), map_location="cpu",
                        weights_only=True)
    loaded = {}
    load_model_weights = ckpt_lib.load_model_weights

    def capture(path, model, which="latest"):
        epoch = load_model_weights(path, model, which)
        loaded.update({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
        return epoch

    ckpt_lib.load_model_weights = capture
    reset_launches()
    try:
        # one loader thread: this run checks the weights and the step, and
        # one thread decodes the Paeth files ~5x faster than eight (GIL)
        summary = train_tool.main([CONFIG, "--work-dir", load_dir, "--no-validate",
                                   "--max-steps", "1", "--load", work_dir, *sets,
                                   "training.workers=1"])
    finally:
        ckpt_lib.load_model_weights = load_model_weights
    launches = read_launches()
    with open(os.path.join(load_dir, "train_log.jsonl")) as f:
        load_log = [json.loads(line) for line in f]
    res["load"] = {"entry_point": "tools/train.py --load", "source_step": source["step"],
                   "steps": [e["step"] for e in load_log], "launches": launches,
                   "weights_equal_checkpoint": sorted(loaded) == sorted(source["model"]) and all(
                       torch.equal(loaded[k], source["model"][k]) for k in loaded),
                   "loss_total": load_log[0]["loss_total"]}
    part("load")
    if not (res["load"]["weights_equal_checkpoint"] and summary["step"] == 1
            and [e["step"] for e in load_log] == [1] and np.isfinite(load_log[0]["loss_total"])
            and launches == expected_launches(qkv_attention=12)):
        raise AssertionError(f"--load did not start at step 0 from the checkpoint: {res['load']}")

    # 4. tools/import_checkpoint.py on a reference-format checkpoint, then one frame of it
    torch.save(reference_checkpoint(clip, source["model"], epoch=3), ref_path)
    import_checkpoint.main([CONFIG, ref_path, "--out", import_dir, *sets])
    imported = torch.load(os.path.join(import_dir, "checkpoints", "latest"), map_location="cpu",
                          weights_only=True)["model"]
    same = ("neck.fuse.bn.running_var", "decode_head.classifier.weight", "depth_head.conv1.bias",
            "vis_proj.weight", "contexts")
    import_ok = {k: torch.equal(imported[k], want[k].float()) for k in want}
    import_ok.update({k: torch.equal(imported[k], source["model"][k]) for k in same})
    reset_launches()
    results = test_tool.main([CONFIG, import_dir, "--mode", "slide", "--single-protocol",
                              "--max-samples", "1", "--eval", "mIoU", "depth", *sets])
    launches = read_launches()
    res["import_checkpoint"] = {"entry_point": "tools/import_checkpoint.py main()",
                                "equal": import_ok, "launches": launches,
                                "metrics": {k: results.get(k) for k in keys}}
    part("import_checkpoint")
    if not all(import_ok.values()):
        raise AssertionError(f"import_checkpoint misplaced tensors: {import_ok}")
    if launches != expected_launches(qkv_attention=CITY_SLIDE_LAUNCHES) or not all(
            results.get(k) is not None and np.isfinite(results[k]) for k in keys):
        raise AssertionError(f"tools/test.py on the imported checkpoint: {res['import_checkpoint']}")
    torch.cuda.empty_cache()
    return res


RN50_CONFIG = "configs/denseclip_rn50_cityscapes.yaml"
RN50_VISUAL = (64, (3, 4, 6, 3), 7, 1024)  # RN50: width, blocks, pool grid, output dim
RN50_TEXT = (512, 12, 49408, 77, 1024)  # width, layers, vocab, positions, projection
RN50_STEPS = 2  # at the preset's batch 16: 1 warm-up + 1 timed (the cut: fewer steps)
RN50_CPU_BATCH = 2  # samples of the step's loss held against fp32 on the CPU


def phase_rn50_path(tree=None) -> dict:
    """The original DenseCLIP (CLIP RN50 + attention pool, context decoder,
    FPN with the score map concatenated into c4) on its Cityscapes preset at
    full width, through the user entry points, from a stub OpenAI RN50
    archive: `tools/train.py` at batch 16 and crop 512x512, `tools/test.py`
    whole and slide (crop 640, stride 426) on the val frames.  No kernel of
    the port is on this path (the JAX package sends the pool, the decoder
    and the text tower to XLA attention): every count must stay 0.  `tree`
    is a written Cityscapes tree (cityscapes_path's); without one, one is
    written here."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="rn50_smoke_") as tmp:
        if tree is None:
            tree = os.path.join(tmp, "cityscapes")
            write_cityscapes_tree(tree, SEED)
        return _rn50_path(tmp, tree)


def _rn50_path(tmp: str, tree: str) -> dict:
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config
    from denseclip_vit_multimodal_tpu_torch.data.augment import (
        augment_batch,
        augment_config_from_data_cfg,
    )
    from denseclip_vit_multimodal_tpu_torch.data.loader import DataLoader, build_dataset, to_device
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.tools import test as test_tool
    from denseclip_vit_multimodal_tpu_torch.tools import train as train_tool
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import load_model_weights
    from denseclip_vit_multimodal_tpu_torch.train.loop import train_step_from_cfg
    from denseclip_vit_multimodal_tpu_torch.train.losses import cross_entropy_loss
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state
    from denseclip_vit_multimodal_tpu_torch.utils.flops import program_flops

    archive, work_dir = os.path.join(tmp, "RN50.pt"), os.path.join(tmp, "wd")
    sets = ["--set", f"data.path={tree}", f"model.clip_pretrained={archive}"]
    cfg = load_config(RN50_CONFIG, overrides=sets[1:])
    seed, batch_size = int(cfg.training.seed), int(cfg.training.batch_size)
    tick = time.perf_counter()
    write_stub_rn50_clip(archive, SEED)
    res = {"phase": "rn50_path", "config": RN50_CONFIG, "archive_bytes": os.path.getsize(archive),
           "archive_write_s": time.perf_counter() - tick, "batch": batch_size,
           "crop": list(cfg.data.crop_size), "cut": f"{RN50_STEPS} steps (1 warm-up)"}
    launches_total = collections.Counter()

    # 1. tools/train.py: the RN50 recipe (backbone lr x0.1, text tower frozen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tick = time.perf_counter()
    summary = train_tool.main([RN50_CONFIG, "--work-dir", work_dir, "--no-validate",
                               "--max-steps", str(RN50_STEPS), *sets])
    train_s = time.perf_counter() - tick
    launches = read_launches()
    launches_total.update(launches)
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    with open(os.path.join(work_dir, "train.log")) as f:
        imported = [line.strip() for line in f if "loaded CLIP weights" in line]
    timed = log[1:]  # the first step pays the set-up
    step_ms = 1e3 * sum(e["step_s"] for e in timed) / len(timed)
    wait_ms = 1e3 * sum(e["data_s"] for e in timed) / len(timed)
    res["training"] = {
        "entry_point": "tools/train.py main()", "steps": len(log), "wall_s": train_s,
        "import": imported, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "ms_per_step": step_ms, "data_wait_ms_per_step": wait_ms,
        "first_step": {"step_ms": 1e3 * log[0]["step_s"], "data_wait_ms": 1e3 * log[0]["data_s"]},
        "samples_per_s": batch_size * len(timed) / sum(e["step_s"] + e["data_s"] for e in timed),
        "losses": [{k: e[k] for k in ("loss_seg", "loss_total", "lr")} for e in log]}
    emit({"phase": "rn50_path", "training": res["training"]})
    if not (summary["step"] == RN50_STEPS == len(log) and len(imported) == 1 and all(
            np.isfinite(e["loss_total"]) and not e["skipped"] for e in log)):
        raise AssertionError(f"tools/train.py did not take {RN50_STEPS} finite steps: {summary}")
    if launches != expected_launches():
        raise AssertionError(f"a kernel launched on the RN50 training path: {launches}")

    # 2. where a step's device time goes: the trainer's step on one batch
    #    decoded beforehand (one thread: on the card one decode thread ran
    #    4.9x faster than eight, cityscapes_path)
    model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.bfloat16,
                                   device="cuda", seed=seed)
    load_model_weights(work_dir, model)
    loader = DataLoader(build_dataset(cfg.data, "train"), batch_size=batch_size, seed=seed,
                        num_threads=1)
    samples = loader.epoch(0)
    try:
        host_batch = next(samples)
    finally:
        samples.close()
    state = create_train_state(model, cfg.training, len(loader))
    step = train_step_from_cfg(texts, cfg.training, cfg.data, seed)
    reset_launches()
    step(state, to_device(host_batch, "cuda"))  # warm-up
    prof = phase_profile(lambda b: step(state, to_device(b, "cuda")), [host_batch],
                         path="rn50_training_step")
    res["training"]["profile"] = {
        "device_busy_ms": prof["device_busy_ms_per_frame"],
        "busy_share_of_the_step": prof["device_busy_share"],
        "busy_share_with_data_wait": prof["device_busy_ms_per_frame"] / (step_ms + wait_ms)}
    emit({"phase": "rn50_path", "training_profile": res["training"]["profile"]})
    del state, step

    # 3. the checkpoint in bf16 on the card against fp32 on the CPU: one
    #    512x512 window (inference), and the training loss of RN50_CPU_BATCH
    #    augmented samples of that batch (batch statistics)
    load_model_weights(work_dir, model)
    cpu_model, _ = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.float32,
                                   device="cpu", seed=seed)
    load_model_weights(work_dir, cpu_model)
    window = torch.from_numpy(np.random.RandomState(SEED).randn(1, 512, 512, 3).astype(np.float32))
    aug_cfg = augment_config_from_data_cfg(cfg.data)
    few = {k: v[:RN50_CPU_BATCH] for k, v in host_batch.items()}
    batch = augment_batch(to_device(few, "cpu"), aug_cfg, torch.Generator().manual_seed(seed))
    crop = tuple(aug_cfg.crop_size)
    losses = {}
    with torch.no_grad():
        ref, got = cpu_model(window, texts), model(window.cuda(), texts)
        for name, net, dev in (("card_bf16", model, "cuda"), ("cpu_fp32", cpu_model, "cpu")):
            out = net(batch["image"].to(dev), texts, train=True, gt_hw=crop)
            losses[name] = float(cross_entropy_loss(out["seg"], batch["seg"].to(dev)))
    res["reference"] = {"window": [1, 512, 512, 3], "seg_rel_l2": rel_l2(got["seg"].cpu(),
                                                                          ref["seg"]),
                        "train_loss": losses, "train_samples": RN50_CPU_BATCH,
                        "train_loss_rel_diff": abs(losses["card_bf16"] - losses["cpu_fp32"])
                        / abs(losses["cpu_fp32"]), "tol": REFERENCE_TOL}
    emit({"phase": "rn50_path", "reference": res["reference"]})
    if not (res["reference"]["seg_rel_l2"] <= REFERENCE_TOL
            and res["reference"]["train_loss_rel_diff"] <= REFERENCE_TOL):
        raise AssertionError(f"bf16 RN50 on the card disagrees with fp32 on the CPU: "
                             f"{res['reference']}")
    launches_total.update(read_launches())
    del cpu_model, ref, got, batch, host_batch

    # 4. tools/test.py on val, whole frames and the slide protocol
    keys = ["mIoU", "pixel_acc"]
    res["eval"] = {}
    for mode in ("whole", "slide"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        tick = time.perf_counter()
        results = test_tool.main([RN50_CONFIG, work_dir, "--mode", mode, "--single-protocol",
                                  "--eval", "mIoU", *sets])
        launches = read_launches()
        launches_total.update(launches)
        res["eval"][mode] = {"entry_point": "tools/test.py main()", "frames": CITY_VAL,
                             "timed_frames": CITY_VAL - 1, "wall_s": time.perf_counter() - tick,
                             "s_per_frame": 1.0 / results["images_per_sec"],
                             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                             "launches": launches,
                             "metrics": {k: results.get(k) for k in keys}}
        if launches != expected_launches():
            raise AssertionError(f"a kernel launched on the RN50 {mode} evaluation: {launches}")
        if not all(results.get(k) is not None and np.isfinite(results[k]) for k in keys):
            raise AssertionError(f"non-finite evaluation metrics: {res['eval'][mode]}")
    emit({"phase": "rn50_path", "eval": res["eval"]})

    # 5. one whole frame as served (the tower cached): its FLOPs, and a profile
    engine = Inferencer(model, texts, num_classes=len(CITYSCAPES_CLASSES))
    frame = np.random.RandomState(SEED).randint(0, 256, (1,) + CITY_HW + (3,), dtype=np.uint8)
    whole = lambda f: engine.predict(f, mode="whole", fetch="device")
    whole(frame)  # warm-up: caches the text tower
    flops = program_flops(whole, frame)
    res["whole_frame_tflop"] = flops.total / 1e12
    res["whole_frame_tokens_at_the_pool"] = (CITY_HW[0] // 32) * (CITY_HW[1] // 32) + 1
    reset_launches()
    res["profile"] = phase_profile(whole, [frame], path="rn50_whole_frame")
    launches_total.update(read_launches())
    res["launches"] = dict(launches_total)
    part = {k: res[k] for k in ("whole_frame_tflop", "whole_frame_tokens_at_the_pool", "launches")}
    emit({"phase": "rn50_path", **part})
    if res["launches"] != expected_launches():
        raise AssertionError(f"a kernel launched on the RN50 path: {res['launches']}")
    del model, engine
    torch.cuda.empty_cache()
    return res


ADE_VIT_CONFIG = "configs/denseclip_vitb16_ade20k.yaml"
ADE_RN50_CONFIG = "configs/denseclip_rn50_512x512_80k.yaml"
ADE_RN101_CONFIG = "configs/denseclip_rn101_512x512_80k.yaml"
# (height, width) of the written tree: ADE20K's varied sizes, landscape and
# portrait; 16 training images so that the RN preset's batch of 16 is one step
ADE_TRAIN_HW = [(512, 683), (683, 512), (480, 640), (768, 1024), (1400, 2100), (375, 500),
                (512, 512), (600, 800)] * 2
ADE_VAL_HW = [(512, 683), (683, 512), (768, 1024), (640, 480)]
ADE_CANVAS = (512, 683)  # the dataset's fixed canvas (h, w)
ADE_VIT_STEPS = 4  # at the preset's batch 8, crop 512: 1 warm-up + 3 timed
ADE_RN50_STEPS = 3  # at the preset's batch 16: 1 warm-up + 2 timed
# crop 512: 32 x 32 + 1 = 1025 tokens, padded once to 1152
ADE_TOKENS, ADE_PADDED = 32 * 32 + 1, 1152
# the preset's slide protocol (crop 640 / stride 426) on the 512x683 canvas:
# two 512x640 windows, 32 x 40 + 1 = 1281 tokens, padded to 1408, one batch
ADE_EVAL_TOKENS, ADE_EVAL_PADDED, ADE_EVAL_WINDOWS = 32 * 40 + 1, 1408, 2


def write_ade20k_tree(root: str, seed: int) -> None:
    """A seeded ADE20K tree: baseline 4:2:0 JPEGs written by the numpy
    encoder (`utils/_jpeg_writer.py`: the card has no Pillow) of smooth
    gradients with noise, and 8-bit label PNGs of 16x16-pixel blocks over
    0..150 (0: background) by the port's PNG encoder."""
    from denseclip_vit_multimodal_tpu_torch.utils._jpeg_writer import encode_jpeg
    from denseclip_vit_multimodal_tpu_torch.utils.png import encode_png

    rs = np.random.RandomState(seed)
    for split, sizes, prefix in (("training", ADE_TRAIN_HW, "ADE_train"),
                                 ("validation", ADE_VAL_HW, "ADE_val")):
        img_dir = os.path.join(root, "ADEChallengeData2016", "images", split)
        ann_dir = os.path.join(root, "ADEChallengeData2016", "annotations", split)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(ann_dir, exist_ok=True)
        for i, (h, w) in enumerate(sizes):
            y, x = np.mgrid[0:h, 0:w]
            base = np.stack([x * 255 // w, y * 255 // h, (x + 2 * y) * 255 // (w + 2 * h)], -1)
            img = np.clip(base + rs.randint(-24, 25, (h, w, 3)), 0, 255).astype(np.uint8)
            blocks = rs.randint(0, 151, (-(-h // 16), -(-w // 16))).astype(np.uint8)
            label = np.repeat(np.repeat(blocks, 16, 0), 16, 1)[:h, :w]
            name = f"{prefix}_{i + 1:08d}"
            with open(os.path.join(img_dir, name + ".jpg"), "wb") as f:
                f.write(encode_jpeg(img, quality=90))
            with open(os.path.join(ann_dir, name + ".png"), "wb") as f:
                f.write(encode_png(label))


@contextlib.contextmanager
def recorded_k1_k2_shapes():
    """Counts (qkv shape, valid length) of every K1 and K2 launch while open."""
    from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel

    seen = {"qkv_attention": collections.Counter(), "qkv_attention_bwd": collections.Counter()}
    fwd, bwd = mha_kernel._launch, mha_kernel._launch_bwd

    def launch(qkv, num_heads, scale, kv_len, *args, **kwargs):
        seen["qkv_attention"][(tuple(qkv.shape), kv_len)] += 1
        return fwd(qkv, num_heads, scale, kv_len, *args, **kwargs)

    def launch_bwd(qkv, out, dout, stats, num_heads, scale, kv_len, *args):
        seen["qkv_attention_bwd"][(tuple(qkv.shape), kv_len)] += 1
        return bwd(qkv, out, dout, stats, num_heads, scale, kv_len, *args)

    mha_kernel._launch, mha_kernel._launch_bwd = launch, launch_bwd
    try:
        yield seen
    finally:
        mha_kernel._launch, mha_kernel._launch_bwd = fwd, bwd


def shapes_json(seen: dict) -> dict:
    return {k: [{"shape": list(s), "valid_len": kv, "launches": n} for (s, kv), n in c.items()]
            for k, c in seen.items()}


def ade20k_host_numbers(tree: str) -> dict:
    """The host's part of an ADE20K sample, one thread: JPEG decode, the
    bilinear resize to the canvas, the label (PNG decode, nearest resize,
    remap) in ms per sample; the loader alone at 1 and 8 threads."""
    from denseclip_vit_multimodal_tpu_torch.data import ade20k
    from denseclip_vit_multimodal_tpu_torch.data.loader import DataLoader
    from denseclip_vit_multimodal_tpu_torch.utils import imageio
    from denseclip_vit_multimodal_tpu_torch.utils.png import decode_png_array

    ds = ade20k.ADE20KSegmentation(tree, split="train")
    ch, cw = ds.canvas_size
    ms = {"jpeg_decode": 0.0, "resize_bilinear": 0.0, "label": 0.0}
    for img_path, label_path in ds.samples:
        with open(img_path, "rb") as f:
            data = f.read()
        tick = time.perf_counter()
        img = imageio.decode_jpeg(data)
        mid = time.perf_counter()
        imageio.resize_bilinear_u8(img, (cw, ch))
        end = time.perf_counter()
        with open(label_path, "rb") as f:
            ldata = f.read()
        ade20k.remap_labels(imageio.resize_nearest(decode_png_array(ldata), (cw, ch)))
        ms["jpeg_decode"] += (mid - tick) * 1e3 / len(ds)
        ms["resize_bilinear"] += (end - mid) * 1e3 / len(ds)
        ms["label"] += (time.perf_counter() - end) * 1e3 / len(ds)
    rates = {}
    for threads in (1, 8):  # 4 epochs of the tree: 64 samples in batches of 8
        loader = DataLoader(ds, batch_size=8, seed=SEED, num_threads=threads)
        tick = time.perf_counter()
        n = sum(b["image"].shape[0] for epoch in range(4) for b in loader.epoch(epoch))
        rates[threads] = n / (time.perf_counter() - tick)
    return {"samples": len(ds), "ms_per_sample": {**ms, "total": sum(ms.values())},
            "loader_samples_per_s_by_threads": rates,  # cityscapes_path prints its PNG loader's
            "library": str(imageio._LIBRARY.lib._name)}


def phase_ade20k_path() -> dict:
    """The three ADE20K presets on a JPEG tree written here, through the user
    entry points (see the module note, phase 25)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="ade20k_smoke_") as tmp:
        return _ade20k_path(tmp)


def _ade20k_path(tmp: str) -> dict:
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config
    from denseclip_vit_multimodal_tpu_torch.data.ade20k import ADE20K_CLASSES, ADE20KSegmentation
    from denseclip_vit_multimodal_tpu_torch.data.augment import (
        augment_batch,
        augment_config_from_data_cfg,
    )
    from denseclip_vit_multimodal_tpu_torch.data.loader import DataLoader, build_dataset, to_device
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip
    from denseclip_vit_multimodal_tpu_torch.models.layers import set_attn_impl
    from denseclip_vit_multimodal_tpu_torch.tools import serve
    from denseclip_vit_multimodal_tpu_torch.tools import test as test_tool
    from denseclip_vit_multimodal_tpu_torch.tools import train as train_tool
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import load_model_weights
    from denseclip_vit_multimodal_tpu_torch.train.loop import train_step_from_cfg
    from denseclip_vit_multimodal_tpu_torch.train.losses import cross_entropy_loss
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state
    from denseclip_vit_multimodal_tpu_torch.utils import imageio

    start = time.perf_counter()
    tree = os.path.join(tmp, "ade20k")
    vit_archive, rn_archive = os.path.join(tmp, "ViT-B-16.pt"), os.path.join(tmp, "RN50.pt")
    vit_wd, rn_wd = os.path.join(tmp, "wd_vit"), os.path.join(tmp, "wd_rn50")
    write_ade20k_tree(tree, SEED)
    write_stub_clip(vit_archive, SEED)
    write_stub_rn50_clip(rn_archive, SEED)
    res = {"phase": "ade20k_path", "tree": {
        "train": len(ADE_TRAIN_HW), "val": len(ADE_VAL_HW), "canvas": list(ADE_CANVAS),
        "jpeg": "baseline 4:2:0, quality 90 (utils/_jpeg_writer.py)",
        "bytes": sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tree) for f in fs)},
        "write_s": time.perf_counter() - start}
    res["host"] = ade20k_host_numbers(tree)
    emit(res)

    # 1. the ViT-B/16 preset through tools/train.py (CLIP import), K1 + K2 on every layer.
    #    As shipped it sets no lr_mults, so both towers stay frozen (as in the JAX
    #    package) and no backward runs through the ViT: the smoke trains the
    #    backbone at lr x0.1, the paper's recipe (the RN50 / RN101 presets ship it)
    sets = ["--set", f"data.path={tree}", f"model.clip_pretrained={vit_archive}",
            "training.save_interval=1000", "training.lr_mults.backbone=0.1"]
    cfg = load_config(ADE_VIT_CONFIG, overrides=sets[1:])
    seed, batch_size = int(cfg.training.seed), int(cfg.training.batch_size)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tick = time.perf_counter()
    with recorded_k1_k2_shapes() as seen:
        summary = train_tool.main([ADE_VIT_CONFIG, "--work-dir", vit_wd, "--no-validate",
                                   "--max-steps", str(ADE_VIT_STEPS), *sets])
    train_s = time.perf_counter() - tick
    launches = read_launches()
    with open(os.path.join(vit_wd, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    timed = log[1:]
    step_ms = 1e3 * sum(e["step_s"] for e in timed) / len(timed)
    wait_ms = 1e3 * sum(e["data_s"] for e in timed) / len(timed)
    vit = {"config": ADE_VIT_CONFIG, "entry_point": "tools/train.py main()", "batch": batch_size,
           "overrides": sets[1:],
           "crop": list(cfg.data.crop_size), "steps": len(log), "wall_s": train_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
           "launch_shapes": shapes_json(seen), "ms_per_step": step_ms,
           "data_wait_ms_per_step": wait_ms,
           "samples_per_s": batch_size * len(timed) / sum(e["step_s"] + e["data_s"] for e in timed),
           "losses": [e["loss_total"] for e in log]}
    res["vit_training"] = vit
    emit({"phase": "ade20k_path", "vit_training": vit})
    k_shape = ((batch_size, ADE_PADDED, 3 * 768), ADE_TOKENS)
    want = {"qkv_attention": {k_shape: 12 * ADE_VIT_STEPS},
            "qkv_attention_bwd": {k_shape: 12 * ADE_VIT_STEPS}}
    if not (summary["step"] == ADE_VIT_STEPS == len(log)
            and all(np.isfinite(e["loss_total"]) and not e["skipped"] for e in log)):
        raise AssertionError(f"tools/train.py did not take {ADE_VIT_STEPS} finite steps: {summary}")
    if launches != expected_launches(qkv_attention=12 * ADE_VIT_STEPS,
                                     qkv_attention_bwd=12 * ADE_VIT_STEPS) or {
            k: dict(c) for k, c in seen.items()} != want:
        raise AssertionError(f"expected 12 K1 forward and 12 K2 backward launches a step at "
                             f"{k_shape}: {launches} {vit['launch_shapes']}")

    # the first step's loss with the kernels against plain attention (the same
    # weights, augmented batch and dropout masks), and a profiled step with its wait
    model, texts = build_denseclip(cfg.model, ADE20K_CLASSES, dtype=torch.bfloat16, device="cuda",
                                   seed=seed)
    load_model_weights(vit_wd, model)
    aug_cfg = augment_config_from_data_cfg(cfg.data)
    train_ds = build_dataset(cfg.data, "train")
    loader = DataLoader(train_ds, batch_size=batch_size, seed=seed,
                        num_threads=int(cfg.training.get("workers", 4)))
    loader_iter = endless(loader)
    try:
        batch = augment_batch(to_device(next(loader_iter), "cuda"), aug_cfg,
                              torch.Generator().manual_seed(seed))

        def loss_of(backward: bool):
            model.zero_grad(set_to_none=True)
            out = model(batch["image"], texts, train=True, gt_hw=tuple(aug_cfg.crop_size),
                        gen=torch.Generator(device="cuda").manual_seed(seed))
            loss = cross_entropy_loss(out["seg"], batch["seg"])
            if backward:
                loss.backward()
            return float(loss), out["seg"].detach().float()

        reset_launches()
        kernel_loss, kernel_seg = loss_of(True)
        kernel_launched = read_launches()
        set_attn_impl(model, "xla")
        with torch.no_grad():
            plain_loss, plain_seg = loss_of(False)
        set_attn_impl(model, "auto")
        model.zero_grad(set_to_none=True)
        res["vit_vs_plain"] = {"loss_kernel": kernel_loss, "loss_plain": plain_loss,
                               "loss_rel_diff": abs(kernel_loss - plain_loss) / abs(plain_loss),
                               "seg_rel_l2": rel_l2(kernel_seg, plain_seg),
                               "launches": kernel_launched, "tol": TRAIN_TOL,
                               "seg_tol": PATH_TOL}
        del batch, kernel_seg, plain_seg
        if not (kernel_launched == expected_launches(qkv_attention=12, qkv_attention_bwd=12)
                and res["vit_vs_plain"]["loss_rel_diff"] <= TRAIN_TOL
                and res["vit_vs_plain"]["seg_rel_l2"] <= PATH_TOL):
            raise AssertionError(f"the ADE20K step disagrees with plain attention: "
                                 f"{res['vit_vs_plain']}")
        state = create_train_state(model, cfg.training, len(loader))
        step = train_step_from_cfg(texts, cfg.training, cfg.data, seed)
        step(state, to_device(next(loader_iter), "cuda"))  # warm-up
        prof = phase_profile(lambda _: step(state, to_device(next(loader_iter), "cuda")), [0],
                             path="ade20k_vit_training")
    finally:
        loader_iter.close()
    vit["profile"] = {"device_busy_ms": prof["device_busy_ms_per_frame"],
                      "busy_share_of_the_step_with_its_wait": prof["device_busy_share"],
                      "busy_share_timed_steps": prof["device_busy_ms_per_frame"] / (step_ms + wait_ms)}
    emit({"phase": "ade20k_path", "vit_vs_plain": res["vit_vs_plain"],
          "vit_training_profile": vit["profile"]})
    del state, step
    torch.cuda.empty_cache()

    # 2. tools/test.py on the validation split: slide at the preset's protocol
    #    (crop 640 / stride 426 on the 512x683 canvas); whole mode is refused
    #    there, as the JAX ViT refuses it (683 is not a multiple of the patch)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tick = time.perf_counter()
    with recorded_k1_k2_shapes() as seen:
        results = test_tool.main([ADE_VIT_CONFIG, vit_wd, "--mode", "slide", "--single-protocol",
                                  *sets])
    launches = read_launches()
    e_shape = ((ADE_EVAL_WINDOWS, ADE_EVAL_PADDED, 3 * 768), ADE_EVAL_TOKENS)
    res["vit_eval"] = {"entry_point": "tools/test.py main()", "mode": "slide", "crop": [640, 640],
                       "stride": [426, 426], "frames": len(ADE_VAL_HW),
                       "timed_frames": len(ADE_VAL_HW) - 1, "wall_s": time.perf_counter() - tick,
                       "s_per_frame": 1.0 / results["images_per_sec"],
                       "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "launches": launches, "launch_shapes": shapes_json(seen),
                       "mIoU": results.get("mIoU"), "pixel_acc": results.get("pixel_acc"),
                       "class_ious": sum(k.startswith("iou/") for k in results)}
    try:
        test_tool.main([ADE_VIT_CONFIG, vit_wd, "--mode", "whole", "--max-samples", "1", *sets])
        whole = "ran"
    except ValueError as e:
        whole = f"refused: {e}"
    res["vit_eval"]["whole"] = whole
    if not (launches == expected_launches(qkv_attention=12 * len(ADE_VAL_HW))
            and {k: dict(c) for k, c in seen.items()} == {
                "qkv_attention": {e_shape: 12 * len(ADE_VAL_HW)}, "qkv_attention_bwd": {}}):
        raise AssertionError(f"expected 12 K1 launches a frame at {e_shape}: {res['vit_eval']}")
    if not (np.isfinite(results["mIoU"]) and res["vit_eval"]["class_ious"] == 150
            and "not divisible by patch 16" in whole):
        raise AssertionError(f"tools/test.py on the ADE20K preset: {res['vit_eval']}")

    # the seg logits of one val frame with the kernels against plain attention
    val_ds = ADE20KSegmentation(tree, split="val")
    frame = val_ds[0]["image"][None]
    engine = Inferencer(model, texts, num_classes=len(ADE20K_CLASSES))
    slide = lambda: engine.predict(frame, mode="slide", crop=(640, 640), stride=(426, 426),
                                   fetch="device")["seg_logits"].float()
    got = slide()
    set_attn_impl(model, "xla")
    ref = slide()
    set_attn_impl(model, "auto")
    res["vit_eval"]["vs_plain"] = {"seg_rel_l2": rel_l2(got, ref), "tol": PATH_TOL,
                                   "shape": list(got.shape)}
    emit({"phase": "ade20k_path", "vit_eval": res["vit_eval"]})
    if not (res["vit_eval"]["vs_plain"]["seg_rel_l2"] <= PATH_TOL
            and tuple(got.shape) == (1, *ADE_CANVAS, 150)):
        raise AssertionError(f"ADE20K slide logits disagree with plain attention: "
                             f"{res['vit_eval']['vs_plain']}")
    del model, engine, got, ref
    torch.cuda.empty_cache()

    # 3. build_service on the preset; one JPEG of the tree as an HTTP body
    args = serve.parse_args([ADE_VIT_CONFIG, vit_wd, "--mode", "slide", *sets])
    service, _ = serve.build_service(args)
    try:
        with open(val_ds.samples[1][0], "rb") as f:
            body = f.read()
        hdr = imageio.read_jpeg_header(body)
        reset_launches()
        tick = time.perf_counter()
        status, ctype, payload = service.handle_predict(body, {})
        http_s = time.perf_counter() - tick
        answer = np.load(io.BytesIO(payload)) if status == 200 else None
        want_seg = service.predict_array(imageio.decode_jpeg(body))["seg"]
        res["serve"] = {"entry_point": "tools/serve.py build_service + handle_predict",
                        "body": {"bytes": len(body), "width": hdr.width, "height": hdr.height,
                                 "mode": hdr.mode}, "status": status, "content_type": ctype,
                        "seconds": http_s, "launches": read_launches(),
                        "equal_to_predict_array": answer is not None
                        and np.array_equal(answer["seg"], want_seg)}
    finally:
        service.close()
    emit({"phase": "ade20k_path", "serve": res["serve"]})
    if not (status == 200 and res["serve"]["equal_to_predict_array"]
            and want_seg.shape == (hdr.height, hdr.width)):
        raise AssertionError(f"the JPEG body's answer is not predict_array's: {res['serve']}")
    torch.cuda.empty_cache()

    # 4. the RN50 preset (the paper's ADE20K setting) from the stub RN50 archive:
    #    tools/train.py at batch 16, crop 512, then tools/test.py whole on the val frames
    rn_sets = ["--set", f"data.path={tree}", f"model.clip_pretrained={rn_archive}",
               "training.save_interval=1000"]
    rn_cfg = load_config(ADE_RN50_CONFIG, overrides=rn_sets[1:])
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tick = time.perf_counter()
    summary = train_tool.main([ADE_RN50_CONFIG, "--work-dir", rn_wd, "--no-validate",
                               "--max-steps", str(ADE_RN50_STEPS), *rn_sets])
    with open(os.path.join(rn_wd, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    timed = log[1:]
    rn = {"config": ADE_RN50_CONFIG, "batch": int(rn_cfg.training.batch_size),
          "crop": list(rn_cfg.data.crop_size), "steps": len(log),
          "wall_s": time.perf_counter() - tick,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "ms_per_step": 1e3 * sum(e["step_s"] for e in timed) / len(timed),
          "data_wait_ms_per_step": 1e3 * sum(e["data_s"] for e in timed) / len(timed),
          "losses": [e["loss_total"] for e in log], "launches": read_launches()}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    results = test_tool.main([ADE_RN50_CONFIG, rn_wd, "--mode", "whole", *rn_sets])
    rn["eval_whole"] = {"frames": len(ADE_VAL_HW), "s_per_frame": 1.0 / results["images_per_sec"],
                        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "mIoU": results.get("mIoU"), "launches": read_launches()}
    res["rn50"] = rn
    emit({"phase": "ade20k_path", "rn50": rn})
    if not (summary["step"] == ADE_RN50_STEPS == len(log)
            and all(np.isfinite(e["loss_total"]) and not e["skipped"] for e in log)
            and np.isfinite(results["mIoU"])):
        raise AssertionError(f"the RN50 ADE20K preset did not train and evaluate: {rn}")
    if rn["launches"] != expected_launches() or rn["eval_whole"]["launches"] != expected_launches():
        raise AssertionError(f"a kernel launched on the RN50 ADE20K path: {rn}")
    torch.cuda.empty_cache()

    # 5. the RN101 preset: one whole 512x683 frame at full width from seeded weights
    rn101_cfg = load_config(ADE_RN101_CONFIG)
    model, texts = build_denseclip(rn101_cfg.model, ADE20K_CLASSES, dtype=torch.bfloat16,
                                   device="cuda", seed=SEED)
    engine = Inferencer(model, texts, augment_config_from_data_cfg(rn101_cfg.data, train=False),
                        num_classes=len(ADE20K_CLASSES))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    whole = lambda: engine.predict(frame, mode="whole", fetch="device")["seg_logits"]
    out = whole().float()
    ms = cuda_ms(whole, iters=3, warmup=1)
    res["rn101"] = {"config": ADE_RN101_CONFIG, "frame": list(frame.shape),
                    "logits": list(out.shape), "finite": bool(torch.isfinite(out).all()),
                    "ms_per_frame": ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": read_launches()}
    emit({"phase": "ade20k_path", "rn101": res["rn101"]})
    if not (res["rn101"]["finite"] and tuple(out.shape) == (1, *ADE_CANVAS, 150)
            and res["rn101"]["launches"] == expected_launches()):
        raise AssertionError(f"the RN101 ADE20K frame: {res['rn101']}")
    del model, engine, out
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - start
    emit({"phase": "ade20k_path", "seconds": res["seconds"]})
    return res


VITL_CONFIG = "configs/denseclip_vitl14_cityscapes_multitask.yaml"
SEG_CONFIG = "configs/denseclip_vitb16_cityscapes_seg.yaml"
PRESET_STEPS = 2  # one epoch of the tree at batch 8 (1 warm-up + 1 timed), then validation
PRESET_EVAL_FRAMES = 2  # tools/test.py --max-samples per protocol (the first untimed)
PRESET_TIMED_STEPS = 3  # the step alone, by CUDA events, after a warm-up


def _k1_key(batch: int, tokens: int, width: int) -> tuple:
    """(qkv shape, valid_len) of a K1 / K2 launch on `tokens` ViT tokens, padded
    once to a multiple of 128 from 1024 tokens on (models/vit.py)."""
    padded = tokens if tokens < 1024 or tokens % 128 == 0 else -(-tokens // 128) * 128
    return ((batch, padded, 3 * width), tokens)


def _panel_expectations(model, texts, cfg, class_names) -> dict:
    """The validation panels `train()` should have written for epoch 0: the
    phase's own eval step on the same val batches and weights, the first
    sample and the best batch's sample 0 (seg accuracy, first strict max)."""
    import types

    from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
    from denseclip_vit_multimodal_tpu_torch.data.loader import DataLoader, build_dataset, to_device
    from denseclip_vit_multimodal_tpu_torch.train.metrics import accuracy_from_confusion
    from denseclip_vit_multimodal_tpu_torch.train.step import make_eval_step
    from denseclip_vit_multimodal_tpu_torch.utils import visualize as vis

    eval_step = make_eval_step(texts, augment_config_from_data_cfg(cfg.data, train=False),
                               num_classes=len(class_names),
                               depth_max=float(cfg.data.get("depth_max", 80.0)))
    loader = DataLoader(build_dataset(cfg.data, "val"), batch_size=int(cfg.training.batch_size),
                        shuffle=False, drop_last=False, num_threads=1)
    first = best = best_acc = None
    for batch in loader.epoch(0):
        dev = to_device(batch, "cuda")
        results = eval_step(types.SimpleNamespace(model=model), dev)
        sample = {"image": batch["image"][0], "seg_pred": results["seg_pred"][0].cpu().numpy(),
                  "seg_gt": np.asarray(batch["seg"][0]),
                  "depth_pred": (results["depth_pred"][0].float().cpu().numpy()
                                 if "depth_pred" in results else None),
                  "depth_gt": np.asarray(batch["depth"][0]) if "depth" in batch else None}
        acc = float(accuracy_from_confusion(results["confusion"]))
        first = sample if first is None else first
        if best is None or acc > best_acc:
            best, best_acc = sample, acc

    def multi_task(s):
        tiles = [("input", s["image"]), ("seg pred", vis.colorize_seg(s["seg_pred"])),
                 ("seg gt", vis.colorize_seg(s["seg_gt"]))]
        if s["depth_pred"] is not None:
            tiles.append(("depth pred", vis.colorize_depth(s["depth_pred"])))
        if s["depth_gt"] is not None:
            tiles.append(("depth gt", vis.colorize_depth(s["depth_gt"])))
        return tiles

    return {"epoch_0.png": ("", multi_task(first)),
            "best_epoch_0.png": (f"best batch accuracy {best_acc * 100:.2f}%", multi_task(best)),
            "comparison_epoch_0.png": ("Validation Epoch 0 - Best Accuracy Image", [
                ("Input Image", best["image"]),
                ("Prediction", vis.colorize_scaled(best["seg_pred"])),
                ("Ground Truth", vis.colorize_scaled(best["seg_gt"]))])}


def _panels_match(vis_dir: str, expected: dict) -> dict:
    """Each panel decoded by the port's own PNG decoder, cut into its tiles,
    against the expected titles and tiles (bitwise)."""
    from denseclip_vit_multimodal_tpu_torch.utils.visualize import read_panels

    out = {}
    for name, (title, tiles) in expected.items():
        path = os.path.join(vis_dir, name)
        if not os.path.exists(path):
            out[name] = "missing"
            continue
        with open(path, "rb") as f:
            got_title, got = read_panels(f.read())
        out[name] = {"bytes": os.path.getsize(path), "tiles": [n for n, _ in got],
                     "title": got_title,
                     "equal": got_title == title and [n for n, _ in got] == [n for n, _ in tiles]
                     and all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, tiles))}
    return out


def _preset_path(tmp: str, tree: str, config: str, tag: str, train_sets: list,
                 expect_train: dict, expect_eval: dict, expect_infer: dict,
                 device_step: bool = False) -> dict:
    """One Cityscapes preset through the three user entry points on `tree`:
    `tools/train.py` (PRESET_STEPS steps, then validation with its panels),
    `tools/test.py --mode slide` at the preset's protocol and the reference
    one with `--show-dir --out --format-dir`, and `tools/infer.py --mode
    slide` on one val image; each output held against what this phase
    computes on the same weights, and every K1 / K2 launch's shape counted."""
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config, resolve_test_protocol
    from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
    from denseclip_vit_multimodal_tpu_torch.data.cityscapes import labelids_from_trainids
    from denseclip_vit_multimodal_tpu_torch.data.loader import DataLoader, build_dataset, to_device
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.models.layers import set_attn_impl
    from denseclip_vit_multimodal_tpu_torch.tools import infer as infer_tool
    from denseclip_vit_multimodal_tpu_torch.tools import test as test_tool
    from denseclip_vit_multimodal_tpu_torch.tools import train as train_tool
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import load_model_weights
    from denseclip_vit_multimodal_tpu_torch.train.loop import train_step_from_cfg
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state
    from denseclip_vit_multimodal_tpu_torch.utils.png import decode_png, decode_png_array
    from denseclip_vit_multimodal_tpu_torch.utils.visualize import (
        colorize_depth,
        colorize_seg,
        read_panels,
    )

    start = time.perf_counter()
    wd = os.path.join(tmp, f"wd_{tag}")
    sets = ["--set", f"data.path={tree}", "training.save_interval=1000",
            "training.workers=1", *train_sets]  # one loader thread: the PNG decode's fastest
    cfg = load_config(config, overrides=sets[1:])
    res = {"config": config, "overrides": sets[1:]}

    # 1. tools/train.py: PRESET_STEPS steps, then validation with its panels
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tick = time.perf_counter()
    with recorded_k1_k2_shapes() as seen:
        summary = train_tool.main([config, "--work-dir", wd, "--max-steps", str(PRESET_STEPS),
                                   *sets])
    with open(os.path.join(wd, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    with open(os.path.join(wd, "train.log")) as f:
        train_log = f.read()
    timed = log[1:]
    training = {
        "entry_point": "tools/train.py main()", "batch": int(cfg.training.batch_size),
        "crop": list(cfg.data.crop_size), "remat": cfg.tpu.get("remat", False),
        "steps": len(log), "wall_s": time.perf_counter() - tick,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "ms_per_step": 1e3 * sum(e["step_s"] for e in timed) / len(timed),
        "data_wait_ms_per_step": 1e3 * sum(e["data_s"] for e in timed) / len(timed),
        "losses": [e["loss_total"] for e in log], "launches": read_launches(),
        "launch_shapes": shapes_json(seen), "miou": summary.get("miou"),
        "clip_missing_warning": "not found; training from scratch" in train_log}
    res["training"] = training
    emit({"phase": f"{tag}_path", "training": training})
    if not (summary["step"] == PRESET_STEPS == len(log) and np.isfinite(summary["miou"])
            and training["clip_missing_warning"]
            and all(np.isfinite(e["loss_total"]) and not e["skipped"] for e in log)):
        raise AssertionError(f"{config}: tools/train.py did not train and validate: {training}")
    if {k: dict(c) for k, c in seen.items()} != expect_train:
        raise AssertionError(f"{config}: training launches {training['launch_shapes']}, "
                             f"expected {expect_train}")

    # the phase's own model on the checkpoint: panels, logits, npz and PNGs
    model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.bfloat16,
                                   device="cuda", seed=SEED, remat=cfg.tpu.get("remat", False))
    load_model_weights(wd, model)
    vis_dir = os.path.join(wd, "visualizations")
    panels = _panels_match(vis_dir, _panel_expectations(model, texts, cfg, CITYSCAPES_CLASSES))
    res["panels"] = panels
    emit({"phase": f"{tag}_path", "panels": panels})
    if not all(isinstance(p, dict) and p["equal"] for p in panels.values()):
        raise AssertionError(f"{config}: the validation panels disagree: {panels}")

    # 2. tools/test.py slide on val, both protocols, with the three outputs
    crop, stride, window_batch = resolve_test_protocol(cfg, None, None, None)
    out_npz, show, fmt = (os.path.join(tmp, f"{tag}_{n}") for n in ("preds.npz", "show", "fmt"))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tick = time.perf_counter()
    with recorded_k1_k2_shapes() as seen:
        results = test_tool.main([config, wd, "--mode", "slide", "--max-samples",
                                  str(PRESET_EVAL_FRAMES), "--show-dir", show, "--out", out_npz,
                                  "--format-dir", fmt, *sets])
    evaluation = {"entry_point": "tools/test.py main()", "crop": list(crop),
                  "stride": list(stride), "window_batch": window_batch,
                  "frames": PRESET_EVAL_FRAMES, "wall_s": time.perf_counter() - tick,
                  "s_per_frame": 1.0 / results["images_per_sec"],
                  "ref_s_per_frame": 1.0 / results["ref/images_per_sec"],
                  "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "launches": read_launches(), "launch_shapes": shapes_json(seen),
                  "mIoU": results.get("mIoU"), "ref_mIoU": results.get("ref/mIoU"),
                  "depth_abs_rel": results.get("depth/abs_rel")}
    saved = np.load(out_npz)
    engine = Inferencer(model, texts, augment_config_from_data_cfg(cfg.data, train=False),
                        num_classes=len(CITYSCAPES_CLASSES))
    val_ds = build_dataset(cfg.data, "val")
    npz_equal = formats_equal = shows_equal = True
    for i in range(PRESET_EVAL_FRAMES):
        want = engine.predict(val_ds[i]["image"][None], mode="slide", crop=tuple(crop),
                              stride=tuple(stride), window_batch=window_batch, fetch="packed")
        npz_equal &= np.array_equal(saved[f"seg_{i}"], want["seg"][0]) and (
            np.array_equal(saved[f"depth_{i}"], want["depth"][0]) if "depth" in want
            else f"depth_{i}" not in saved)
        with open(os.path.join(fmt, f"frame_{i:05d}_labelIds.png"), "rb") as f:
            formats_equal &= np.array_equal(decode_png_array(f.read()),
                                            labelids_from_trainids(saved[f"seg_{i}"]))
        with open(os.path.join(show, f"frame_{i:05d}.png"), "rb") as f:
            title, tiles = read_panels(f.read())
        shows_equal &= title == f"frame {i}" and np.array_equal(
            dict(tiles)["seg pred"], colorize_seg(saved[f"seg_{i}"]))
    evaluation.update({"npz_keys": sorted(saved.files), "npz_equal_to_packed": bool(npz_equal),
                       "labelids_equal": bool(formats_equal),
                       "show_dir_seg_tiles_equal": bool(shows_equal)})
    res["eval"] = evaluation
    emit({"phase": f"{tag}_path", "eval": evaluation})
    if {k: dict(c) for k, c in seen.items()} != expect_eval:
        raise AssertionError(f"{config}: evaluation launches {evaluation['launch_shapes']}, "
                             f"expected {expect_eval}")
    if not (npz_equal and formats_equal and shows_equal and np.isfinite(results["mIoU"])
            and np.isfinite(results["ref/mIoU"])):
        raise AssertionError(f"{config}: tools/test.py's outputs disagree: {evaluation}")

    # 3. tools/infer.py on one val image (slide at the preset's protocol)
    image_path = val_ds.samples[0][0]
    reset_launches()
    with recorded_k1_k2_shapes() as seen:
        written = infer_tool.main([config, wd, image_path, "-o", os.path.join(tmp, f"{tag}_inf"),
                                   "--mode", "slide", *sets])
    infer_launches = read_launches()
    with open(image_path, "rb") as f:
        frame = decode_png(f.read())[None]
    want = engine.predict(frame, mode="slide", crop=tuple(crop), stride=tuple(stride),
                          window_batch=window_batch, fetch="argmax")
    arrays = {"seg": colorize_seg(want["seg"][0])}
    if "depth" in want:
        arrays["depth"] = colorize_depth(want["depth"][0], float(cfg.data.get("depth_max", 80.0)))
    decoded = {}
    for path in written:
        with open(path, "rb") as f:
            decoded[path.rsplit("_", 1)[1][:-len(".png")]] = decode_png(f.read())
    infer_res = {"entry_point": "tools/infer.py main()", "written": [os.path.basename(p)
                                                                     for p in written],
                 "launches": infer_launches, "launch_shapes": shapes_json(seen),
                 "pngs_equal": decoded.keys() == arrays.keys()
                 and all(np.array_equal(decoded[k], arrays[k]) for k in arrays)}
    res["infer"] = infer_res
    if {k: dict(c) for k, c in seen.items()} != expect_infer or not infer_res["pngs_equal"]:
        raise AssertionError(f"{config}: tools/infer.py: {infer_res}, expected {expect_infer}")

    # 4. one slide frame's seg logits with the kernels against plain attention
    slide = lambda: engine.predict(frame, mode="slide", crop=tuple(crop), stride=tuple(stride),
                                   window_batch=window_batch, fetch="device")["seg_logits"].float()
    got = slide()
    torch.cuda.synchronize()
    tick = time.perf_counter()
    got = slide()
    torch.cuda.synchronize()
    slide_s = time.perf_counter() - tick
    set_attn_impl(model.backbone, "xla")
    ref = slide()
    set_attn_impl(model.backbone, "auto")
    res["vs_plain"] = {"seg_rel_l2": rel_l2(got, ref), "tol": PATH_TOL,
                       "kernel_slide_frame_s": slide_s}
    res["infer"]["vs_plain"] = res["vs_plain"]
    emit({"phase": f"{tag}_path", "infer": infer_res})
    if not res["vs_plain"]["seg_rel_l2"] <= PATH_TOL:
        raise AssertionError(f"{config}: slide logits disagree with plain attention: "
                             f"{res['vs_plain']}")
    res["model"], res["engine"], res["frame"] = model, engine, frame
    res["seconds"] = time.perf_counter() - start
    if not device_step:
        return res

    # 5. the training step alone on one batch decoded beforehand, by CUDA events
    #    (the CLI's `step_s` also holds the loader thread's decode under the GIL);
    #    it trains the phase's model, so it comes after every check on the weights
    samples = DataLoader(build_dataset(cfg.data, "train"), batch_size=int(cfg.training.batch_size),
                         seed=SEED, num_threads=1).epoch(0)
    try:
        batch = to_device(next(samples), "cuda")
    finally:
        samples.close()
    state = create_train_state(model, cfg.training, 2)
    step = train_step_from_cfg(texts, cfg.training, cfg.data, SEED)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    training["device_step_ms"] = cuda_ms(lambda: step(state, dict(batch)), iters=PRESET_TIMED_STEPS,
                                         warmup=1)
    training["device_step_launches"] = {k: v / (PRESET_TIMED_STEPS + 1)
                                        for k, v in read_launches().items() if v}
    training["device_step_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    emit({"phase": f"{tag}_path", "device_step": {k: training[k] for k in (
        "device_step_ms", "device_step_launches", "device_step_peak_mem_gib")}})
    del state, step, batch
    res["seconds"] = time.perf_counter() - start
    return res


def phase_vitl14_seg_path(tree: str) -> dict:
    """The ViT-L/14 preset (24 layers of 16 heads, remat as shipped, the
    backbone at lr x0.1 so that K2 runs) and the seg-only preset on
    cityscapes_path's tree, through `tools/train.py`, `tools/test.py` and
    `tools/infer.py` (`_preset_path`); ViT-L/14's whole mode on the frame
    refused as the JAX ViT refuses it (1024 is not a multiple of patch 14),
    its slide aug-test (sizes rounded to the patch grid) run once."""
    import tempfile

    start = time.perf_counter()
    res = {"phase": "vitl14_seg_path"}
    with tempfile.TemporaryDirectory(prefix="vitl14_seg_smoke_") as tmp:
        w = 1024
        train_k = _k1_key(8, 36 * 72 + 1, w)  # crop 504x1008, batch 8
        res["vitl14"] = vitl = _preset_path(
            tmp, tree, VITL_CONFIG, "vitl14", ["training.lr_mults.backbone=0.1"],
            # remat: each layer's K1 runs again in the backward's recompute
            {"qkv_attention": {train_k: 2 * 24 * PRESET_STEPS,
                               _k1_key(4, 36 * 72 + 1, w): 24},  # validation: 4 val frames
             "qkv_attention_bwd": {train_k: 24 * PRESET_STEPS}},
            {"qkv_attention": {_k1_key(10, 45 * 45 + 1, w): 24 * PRESET_EVAL_FRAMES,  # crop 630
                               _k1_key(10, 46 * 46 + 1, w): 24 * PRESET_EVAL_FRAMES},  # 644
             "qkv_attention_bwd": {}},
            {"qkv_attention": {_k1_key(10, 45 * 45 + 1, w): 24}, "qkv_attention_bwd": {}},
            device_step=True)
        # whole mode on the 1024x2048 frame is refused, as the JAX ViT refuses
        # it (1024 = 73 x 14 + 2); aug-test rounds every scaled size to the
        # patch grid (both packages), so it runs
        try:
            vitl["engine"].predict(vitl["frame"], mode="whole", fetch="device")
            whole = "ran"
        except ValueError as e:
            whole = f"refused: {e}"
        reset_launches()
        with recorded_k1_k2_shapes() as seen:
            tick = time.perf_counter()
            aug = vitl["engine"].aug_test(vitl["frame"], mode="slide", crop=(630, 630),
                                          stride=(426, 426), window_batch=10, fetch="device")
            finite = bool(torch.isfinite(aug["seg_logits"]).all()
                          and torch.isfinite(aug["depth"]).all())
            aug_s = time.perf_counter() - tick
        vitl["modes"] = {"whole": whole, "aug_test_slide": {
            "finite": finite, "shape": list(aug["seg_logits"].shape), "s_per_frame": aug_s,
            "launches": read_launches(), "launch_shapes": shapes_json(seen)}}
        del aug
        emit({"phase": "vitl14_seg_path", "vitl14_modes": vitl["modes"]})
        if not ("not divisible by patch 14" in whole and finite):
            raise AssertionError(f"ViT-L/14 whole mode / aug-test: {vitl['modes']}")
        for k in ("model", "engine", "frame"):
            vitl.pop(k)
        torch.cuda.empty_cache()

        w = 768
        res["seg_only"] = seg = _preset_path(
            tmp, tree, SEG_CONFIG, "seg_only", [],
            {"qkv_attention": {_k1_key(8, 32 * 64 + 1, w): 12 * PRESET_STEPS,  # frozen towers
                               _k1_key(4, 32 * 64 + 1, w): 12},
             "qkv_attention_bwd": {}},
            {"qkv_attention": {_k1_key(10, 39 * 39 + 1, w): 12 * PRESET_EVAL_FRAMES,  # crop 624
                               _k1_key(10, 40 * 40 + 1, w): 12 * PRESET_EVAL_FRAMES},  # 640
             "qkv_attention_bwd": {}},
            {"qkv_attention": {_k1_key(10, 39 * 39 + 1, w): 12}, "qkv_attention_bwd": {}})
        for k in ("model", "engine", "frame"):
            seg.pop(k)
        if (any(k.startswith("depth") for k in seg["eval"]["npz_keys"])
                or seg["infer"]["written"] != [os.path.basename(seg["infer"]["written"][0])]
                or any(t.startswith("depth") for p in seg["panels"].values() for t in p["tiles"])):
            raise AssertionError(f"the seg-only preset wrote a depth output: {seg}")
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - start
    emit({"phase": "vitl14_seg_path", "seconds": res["seconds"]})
    return res


FLASH_CROPS = ((624, 20), (384, 10))  # the shipped window (1522 tokens); 577 tokens, below 1024
FLASH_ROUNDS = 6  # interleaved timings of each impl a crop (a frame's wall time is host-noisy)


def phase_flash_path() -> dict:
    """The flagship built with `attn_impl: flash` beside `auto` on one seeded
    1024x2048 slide frame, at the shipped crop (both take K1) and at crop 384
    (577 tokens: `auto` takes plain attention, `flash` K1 at any length):
    the same logits within PATH_TOL, K1 launches and shapes, ms a frame
    (CUDA events around 3 queued frames, FLASH_ROUNDS rounds interleaved,
    the median; the frame is on the card before the clock starts)."""
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config
    from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )

    cfg = load_config(CONFIG)
    frame = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, 256, (1, 1024, 2048, 3), dtype=np.uint8)).cuda()  # uploaded once, outside the timing
    engines = {}
    for impl in ("auto", "flash"):
        model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.bfloat16,
                                       attn_impl=impl, device="cuda", seed=SEED)
        engines[impl] = Inferencer(model, texts, augment_config_from_data_cfg(cfg.data, False),
                                   num_classes=len(CITYSCAPES_CLASSES))
    res = {"phase": "flash_path", "config": CONFIG, "frame": list(frame.shape), "crops": []}
    total = expected_launches()
    for crop, wb in FLASH_CROPS:
        row = {"crop": crop, "window_batch": wb}
        logits = {}
        for impl, engine in engines.items():
            run = lambda: engine.predict(frame, mode="slide", crop=(crop, crop), stride=(426, 426),
                                         window_batch=wb, fetch="device")["seg_logits"]
            run()  # warm-up
            reset_launches()
            with recorded_k1_k2_shapes() as seen:
                logits[impl] = run().float()
                torch.cuda.synchronize()
            launched = read_launches()
            if impl == "flash":
                total = {k: total[k] + v for k, v in launched.items()}
            row[impl] = {"launches": launched, "launch_shapes": shapes_json(seen), "ms": []}
        for r in range(FLASH_ROUNDS):  # interleaved, the order alternating (ABBA ...)
            for impl in (("auto", "flash") if r % 2 == 0 else ("flash", "auto")):
                run = lambda: engines[impl].predict(frame, mode="slide", crop=(crop, crop),
                                                    stride=(426, 426), window_batch=wb,
                                                    fetch="device")["seg_logits"]
                row[impl]["ms"].append(cuda_ms(run, iters=3, warmup=1))
        for impl in engines:
            row[impl]["ms_per_frame"] = float(np.median(row[impl]["ms"]))
        row["flash_wins_rounds"] = sum(f < a for f, a in zip(row["flash"]["ms"], row["auto"]["ms"]))
        row["seg_rel_l2_flash_vs_auto"] = rel_l2(logits["flash"], logits["auto"])
        res["crops"].append(row)
        emit({"phase": "flash_path", **row})
        tokens = (crop // 16) ** 2 + 1
        windows = 15 if crop == 384 else 10  # the 3 x 5 and 2 x 5 grids at stride 426
        flash_k1 = {_k1_key(min(wb, windows), tokens, 768): 12 * -(-windows // wb)}
        auto_k1 = flash_k1 if tokens >= 1024 else {}
        got = lambda impl: {(tuple(d["shape"]), d["valid_len"]): d["launches"]
                            for d in row[impl]["launch_shapes"]["qkv_attention"]}
        if not (row["seg_rel_l2_flash_vs_auto"] <= PATH_TOL and got("flash") == flash_k1
                and got("auto") == auto_k1):
            raise AssertionError(f"flash vs auto at crop {crop}: {row}, expected K1 {flash_k1} "
                                 f"under flash and {auto_k1} under auto")
    res["launches"] = total
    del engines
    torch.cuda.empty_cache()
    return res


EXPORT_DIR = "build/export_smoke"  # gitignored; removed at the end of the phase
EXPORT_FRAMES = 3  # after a warm-up, in the fresh process
EXPORT_TOL = 1e-4  # rel. L2 of the bundle's logits canvas against the live path's
EXPORT_SEG_AGREE = 0.9999  # share of pixels where the packed seg equals the live one
# The fresh process: the loader alone, no model code, 3 timed frames (stdout: one JSON line)
EXPORT_CHILD = """
import json, sys, time
import numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from denseclip_vit_multimodal_tpu_torch.infer.exported import ExportedInferencer
from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import LAUNCHES
bundle, seed, frames = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
tick = time.perf_counter()
infer = ExportedInferencer(bundle)
load_s = time.perf_counter() - tick
kw = dict(mode=infer.mode, crop=infer.crop, stride=infer.stride, fetch=infer.export_fetch)
rs = np.random.RandomState(seed)
imgs = [rs.randint(0, 256, infer.input_shape, dtype=np.uint8) for _ in range(frames)]
tick = time.perf_counter()
infer.predict(imgs[0], **kw)  # warm-up: the kernels' build and first launches
torch.cuda.synchronize()
first_s = time.perf_counter() - tick
torch.cuda.reset_peak_memory_stats()
LAUNCHES["qkv_attention"] = 0
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
start.record()
outs = [infer.predict(img, **kw) for img in imgs]
end.record()
torch.cuda.synchronize()
pkg = "denseclip_vit_multimodal_tpu_torch."
print(json.dumps({
    "load_s": load_s, "first_frame_s": first_s,
    "ms_per_frame": start.elapsed_time(end) / frames,
    "k1_launches_per_frame": LAUNCHES["qkv_attention"] / frames,
    "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    "seg_sums": [int(o["seg"].astype(np.int64).sum()) for o in outs],
    "model_modules_loaded": sorted(m for m in ("models", "models.vit", "models.denseclip",
                                                "core.config") if pkg + m in sys.modules)}))
"""


def _bundle_mib(path: str) -> float:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 2**20


def _op_dispatch_us(calls: int = 2000) -> dict:
    """Host microseconds a call of K1 through its op and through the launch
    it wraps, at a shape whose kernel is tiny ([1,128,384]: the host's
    share), in turns (op, direct, direct, op)."""
    from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel

    qkv = torch.randn(1, 128, 384, device="cuda", dtype=torch.bfloat16)
    runs = {"op": lambda: mha_kernel.QKV_ATTENTION_OP(qkv, 2, 0.125, 128),
            "direct": lambda: mha_kernel._launch(qkv, 2, 0.125, 128)[0]}
    us = collections.defaultdict(list)
    for name in ("op", "direct", "direct", "op"):
        runs[name]()
        torch.cuda.synchronize()
        tick = time.perf_counter()
        for _ in range(calls):
            runs[name]()
        torch.cuda.synchronize()
        us[name].append((time.perf_counter() - tick) / calls * 1e6)
    return {f"{name}_us_per_call": min(v) for name, v in us.items()}


def phase_export_path() -> dict:
    """The flagship served from exported programs: `tools/export.py`'s
    `main()` on a seeded checkpoint at full width (slide 624 / 426 / window
    batch 20 on 1024x2048 frames), the bundle loaded in a fresh process that
    imports no model code, each bundle against the live `Inferencer`, the
    int8 and fused exports, `tools/serve.py --from-export` over HTTP and
    `tools/exp_serving_concurrency.py`'s `main()`."""
    import io
    import shutil
    import threading

    from denseclip_vit_multimodal_tpu_torch.core.config import load_config, resolve_test_protocol
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.infer.exported import ExportedInferencer
    from denseclip_vit_multimodal_tpu_torch.infer.server import make_server
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.models.layers import set_attn_impl
    from denseclip_vit_multimodal_tpu_torch.ops import _build, mha_kernel
    from denseclip_vit_multimodal_tpu_torch.tools import exp_serving_concurrency
    from denseclip_vit_multimodal_tpu_torch.tools import export as export_tool
    from denseclip_vit_multimodal_tpu_torch.tools import serve as serve_tool
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import save_checkpoint
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state
    from denseclip_vit_multimodal_tpu_torch.utils import png

    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    cfg = load_config(CONFIG)
    crop, stride, window_batch = resolve_test_protocol(cfg)
    model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.bfloat16,
                                   device="cuda", seed=SEED)
    work = os.path.join(EXPORT_DIR, "work")
    save_checkpoint(work, create_train_state(model, cfg.training, 1), epoch=0)
    engine = Inferencer(model, texts, num_classes=19)
    live = lambda frame, fetch: engine.predict(frame, mode="slide", crop=crop, stride=stride,
                                               window_batch=window_batch, fetch=fetch)
    res = {"phase": "export_path", "config": CONFIG, "crop": crop, "stride": stride,
           "window_batch": window_batch, "frame": [1024, 2048]}

    def export(tag: str, fetch: str, *sets: str) -> str:
        out = os.path.join(EXPORT_DIR, tag)
        tick = time.perf_counter()
        meta = export_tool.main([CONFIG, work, out, "--shape", "1024", "2048", "--mode", "slide",
                                 "--fetch", fetch, *(["--set", *sets] if sets else [])])
        res[tag] = {"export_s": time.perf_counter() - tick, "bundle_mib": _bundle_mib(out),
                    "graph_ops": meta["ops"]}
        return out

    def against_live(tag: str, bundle: str, frame) -> dict:
        """One frame through the bundle (in this process) and the live path:
        launches of the bundle's frame, logits canvas rel. L2, bitwise flag."""
        infer = ExportedInferencer(bundle)
        kw = dict(mode="slide", crop=crop, stride=stride, fetch="logits")
        infer.predict(frame, **kw)  # warm-up
        reset_launches()
        got = infer.predict(frame, **kw)
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        want = live(frame, "logits")
        a = torch.from_numpy(np.concatenate([got["seg_logits"], got["depth"][..., None]], -1))
        b = torch.from_numpy(np.concatenate([want["seg_logits"], want["depth"][..., None]], -1))
        res[tag].update({"launches_per_frame": launches, "logits_rel_l2_vs_live": rel_l2(a, b),
                         "bitwise_equal_to_live": bool(torch.equal(a, b))})
        if not res[tag]["logits_rel_l2_vs_live"] <= EXPORT_TOL:
            raise AssertionError(f"{tag} bundle disagrees with the live path: {res[tag]}")
        return infer

    rs = np.random.RandomState(SEED + 7)
    frame = rs.randint(0, 256, (1, 1024, 2048, 3), dtype=np.uint8)
    logits_dir = export("logits", "logits")
    packed_dir = export("packed", "packed")

    # 2. the packed bundle in a fresh process that imports the loader only
    env = {**os.environ, "PYTHONPATH": os.getcwd()}
    proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, packed_dir, str(SEED + 8),
                           str(EXPORT_FRAMES)], capture_output=True, text=True, timeout=600,
                          env=env)
    if proc.returncode != 0:
        raise AssertionError(f"the fresh process failed:\n{proc.stdout}{proc.stderr}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    res["fresh_process"] = child
    if child["k1_launches_per_frame"] != 12 or child["model_modules_loaded"]:
        raise AssertionError(f"fresh process: {child}")

    # 3. parity with the live Inferencer on one frame
    logits_infer = against_live("logits", logits_dir, frame)
    packed = ExportedInferencer(packed_dir).predict(frame, mode="slide", crop=crop,
                                                    stride=stride, fetch="packed")
    want = live(frame, "packed")
    res["packed"]["seg_agree_share_vs_live"] = float((packed["seg"] == want["seg"]).mean())
    res["packed"]["depth_bitwise_equal_to_live"] = bool(np.array_equal(packed["depth"],
                                                                       want["depth"]))
    if res["packed"]["seg_agree_share_vs_live"] < EXPORT_SEG_AGREE:
        raise AssertionError(f"packed bundle's seg disagrees with the live path: {res['packed']}")

    # the exported frame against the live one in this process: packed fetch,
    # 3 frames a turn, turns interleaved (live, exported, exported, live, ...)
    packed_infer = ExportedInferencer(packed_dir)
    # the program as torch.export.load gives it, with its metadata asserts
    # (the loader drops them: infer/exported.py::without_metadata_asserts)
    with_asserts = torch.export.load(os.path.join(packed_dir, "program.pt2")).module()
    runs = {"live": lambda f: live(f, "packed"),
            "exported": lambda f: packed_infer.predict(f, mode="slide", crop=crop, stride=stride,
                                                       fetch="packed"),
            "exported_with_asserts": lambda f: [t.cpu().numpy() for t in with_asserts(
                torch.from_numpy(f).to("cuda"))]}
    turn_frames = [rs.randint(0, 256, (1, 1024, 2048, 3), dtype=np.uint8)
                   for _ in range(EXPORT_FRAMES)]
    turns = collections.defaultdict(list)
    for name in ("live", "exported", "exported_with_asserts") * 2 + (
            "exported_with_asserts", "exported", "live") * 2:
        runs[name](turn_frames[0])  # warm-up of the turn
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for f in turn_frames:
            runs[name](f)
        end.record()
        torch.cuda.synchronize()
        turns[name].append(start.elapsed_time(end) / len(turn_frames))
    res["frame_ms"] = {name: {"turns": ms, "median": float(np.median(ms))}
                       for name, ms in turns.items()}
    res["frame_ms"]["exported_over_live"] = (res["frame_ms"]["exported"]["median"]
                                             / res["frame_ms"]["live"]["median"])
    res["profile_live"] = phase_profile(runs["live"], turn_frames, path="live_slide_packed")
    res["profile_exported"] = phase_profile(runs["exported"], turn_frames,
                                            path="exported_slide_packed")
    del packed_infer, with_asserts

    # no fallback: a kernel that cannot be built inside the program raises
    load_library = _build.load_library

    def no_build(name):
        raise RuntimeError(f"nvcc failed for {name} (simulated)")

    mha_kernel._kernel_fn.cache_clear()
    _build.load_library = no_build
    try:
        logits_infer.predict(frame, mode="slide", crop=crop, stride=stride, fetch="logits")
        raise AssertionError("the exported program ran without its kernel")
    except RuntimeError as e:
        res["failed_build_raises"] = str(e)[:80]
    finally:
        _build.load_library = load_library
        mha_kernel._kernel_fn.cache_clear()
    del logits_infer

    # 4. the int8 and fused exports, each against the live path under its setting
    int8_dir = export("int8", "logits", "tpu.attn_impl=int8")
    set_attn_impl(model, "int8")
    try:
        against_live("int8", int8_dir, frame)
    finally:
        set_attn_impl(model, "auto")
    with fused_lnqkv(True):
        against_live("fused", export("fused", "logits"), frame)
    for tag, want in (("logits", {"qkv_attention": 12}),
                      ("int8", {"qkv_attention_int8": 12, "quantize_qkv_int8": 12}),
                      ("fused", {"ln_qkv_attention": 12})):
        if res[tag]["launches_per_frame"] != want:
            raise AssertionError(f"{tag} bundle launches a frame: {res[tag]}, want {want}")

    # 5. tools/serve.py --from-export over HTTP: each npz equals predict of the decoded frame
    service, epoch = serve_tool.build_service(serve_tool.parse_args(
        ["--from-export", packed_dir, "--fetch", "packed", "--device-timeout", "120"]))
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    latencies, equal = [], []
    try:
        frames = [rs.randint(0, 256, (1024, 2048, 3), dtype=np.uint8) for _ in range(4)]
        bodies = [png.encode_png(f) for f in frames]
        for i, (img, body) in enumerate(zip(frames, bodies)):
            tick = time.perf_counter()
            status, _, data = _http(server.server_address[1], "POST", "/v1/predict", body)
            if i:  # the first warms up
                latencies.append(time.perf_counter() - tick)
            if status != 200:
                raise AssertionError(f"HTTP {status}: {data[:200]}")
            got = np.load(io.BytesIO(data))
            want = service.inferencer.predict(png.decode_png(body)[None], mode="slide", crop=crop,
                                              stride=stride, fetch="packed")
            equal.append(bool(np.array_equal(got["seg"], want["seg"][0])
                              and np.array_equal(got["depth"], want["depth"][0])))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        service.close()
    res["serve_from_export"] = {"epoch": epoch, "http_latency_s": latencies,
                                "npz_equal_to_predict": equal,
                                "device_s_total": service.stats.device_seconds_total}
    if not all(equal) or epoch is not None:
        raise AssertionError(f"serve --from-export: {res['serve_from_export']}")
    res["op_dispatch"] = _op_dispatch_us()
    del engine, model, service
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # 6. the concurrency tool on the live flagship
    reset_launches()
    res["serving_concurrency"] = exp_serving_concurrency.main(
        ["--clients", "1", "4", "--requests", "3"])
    res["launches"] = read_launches()
    emit(res)
    return res


# --------------------------------------------------------------------------
# fp32 through the attention kernels (`tpu.compute_dtype: float32`)
# --------------------------------------------------------------------------

PEAK_FP32_FLOPS = 66.9e12  # H100 SXM fp32 FMA rate outside the tensor cores
PEAK_3XTF32_FLOPS = 495e12 / 3  # the 3xTF32 ceiling: three TF32 products per fp32 one
# The fp32 kernels against their fp32 plain versions (TF32 off): outputs max
# abs and relative L2 on the rows below valid_len; gradients relative L2 and
# max abs as a share of the largest reference magnitude, per gradient.
FP32_MAX_TOL, FP32_REL_TOL = 1e-4, 1e-5
FP32_BWD_REL_TOL, FP32_BWD_MAX_TOL = 1e-4, 1e-4
FP32_PATH_TOL = 1e-4  # rel. L2, the fp32 slide frame's logits, kernels vs attn_impl xla
FP32_LOSS_TOL = 1e-5  # relative, the fp32 step-1 total loss, kernels vs xla
FP32_GRAD_TOL = 1e-3  # rel. L2, backbone seg-loss gradients, kernels vs xla, fp32
FP32_LONG_TOL = 5e-2  # relative, the fp32 long-crop step-1 loss against the bf16 kernel route's
FP32_SET = "tpu.compute_dtype=float32"
FP32_STEPS = 3  # train() on the crop-640 and long-crop paths: 1 warm-up + 2 (bf16: 6 and 4)
FP32_WORK_DIR = "build/train_fp32"  # gitignored; removed at the end of the phase
FP32_AUG_FRAMES = 2  # tools/test.py --aug-test in fp32: the first pays the set-up (bf16: 3)

# (kernel, b, n, heads, head_dim, valid_len, causal, iters, NaN in the pad keys)
FP32_FWD_CASES = [
    ("qkv_attention_fp32", 10, 1536, 12, 64, 1522, False, 5, False),  # slide window batch
    ("qkv_attention_fp32", 4, 1664, 12, 64, 1601, False, 5, True),  # crop-640 training
    ("qkv_attention_fp32", 2, 8320, 12, 64, 8193, False, 2, False),  # aug-test scale 1.0
    ("qkv_attention_fp32", 10, 577, 12, 64, None, False, 10, False),  # flash, crop 384
    ("qkv_attention_fp32", 2, 1024, 12, 64, None, False, 10, False),  # the self-test's case
    ("mha_attention_fp32", 2, 1024, 12, 64, None, False, 10, False),  # the self-test's case
    ("mha_attention_fp32", 2, 1100, 8, 128, 1050, False, 5, True),  # head dim 128
    ("mha_attention_fp32", 1, 1030, 2, 256, 1025, False, 5, True),  # head dim 256
    ("flash_attention_fp32", 2, 25216, 12, 64, 25089, False, 2, False),  # aug-test scale 1.75
    ("flash_attention_fp32", 2, 18560, 12, 64, 18433, False, 2, False),  # aug-test scale 1.5
    ("flash_attention_fp32", 2, 12928, 12, 64, 12801, False, 2, False),  # aug-test scale 1.25
    ("flash_attention_fp32", 2, 9344, 12, 64, 9217, False, 3, True),  # long-crop training
    ("flash_attention_fp32", 2, 2100, 12, 64, 2000, True, 5, True),  # causal, pad keys
    ("flash_attention_fp32", 2, 8704, 4, 256, 8600, False, 3, True),  # head dim 256
]
FP32_LNQKV_CASES = [  # (b, n, dim, heads, valid_len, iters): K6 in fp32
    (10, 1536, 768, 12, 1522, 3),  # the fused slide window batch
    (2, 1100, 768, 6, 1050, 3),  # head dim 128
]
FP32_BWD_CASES = [
    ("qkv_attention_bwd_fp32", 4, 1664, 12, 64, 1601, False, 3, True),  # crop-640 training
    ("mha_attention_bwd_fp32", 8, 1601, 12, 64, None, False, 2, False),  # profile_attn_bwd's
    ("mha_attention_bwd_fp32", 2, 1100, 8, 128, 1050, False, 3, True),  # head dim 128
    ("mha_attention_bwd_fp32", 1, 1030, 2, 256, 1025, False, 3, True),  # head dim 256
    ("flash_attention_bwd_fp32", 2, 9344, 12, 64, 9217, False, 2, True),  # long-crop training
    ("flash_attention_bwd_fp32", 1, 2048, 4, 64, 2000, True, 3, True),  # causal, pad keys
    ("flash_attention_bwd_fp32", 1, 1100, 2, 256, 1050, True, 3, True),  # head dim 256
]


def fp32_bounds(flops: float, nbytes: float) -> dict:
    """The least time of an fp32 kernel on an H100 SXM: the fp32 kernels run
    their products on the tensor cores by 3xTF32 (the forward at head dim
    256 excepted), so at the 3xTF32 ceiling; the fp32 FMA peak's bound
    beside it."""
    ops_s, bytes_s = flops / PEAK_3XTF32_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "bound_fp32_fma_ms": max(flops / PEAK_FP32_FLOPS, bytes_s) * 1e3,
            "bound_3xtf32_ms": max(flops / PEAK_3XTF32_FLOPS, bytes_s) * 1e3}


def kernel_bounds(dtype, flops: float, nbytes: float) -> dict:
    """A bf16 kernel's bound at the bf16 tensor-core peak, an fp32 one's by
    fp32_bounds."""
    if dtype != torch.bfloat16:
        return fp32_bounds(flops, nbytes)
    ops_s, bytes_s = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def _fp32_forward(kernel: str, b: int, n: int, heads: int, d: int, kv: int, causal: bool,
                  poison: bool):
    """Seeded fp32 q / k / v (views of one fused qkv, NaN in the pad keys
    with `poison`) and the kernel's launch: (qkv, q, k, v, run(stats) ->
    [B, N, H, D] output, plain() -> its plain version's)."""
    from denseclip_vit_multimodal_tpu_torch.ops import attention, mha_kernel

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen, device="cuda")
    q, k, v = (t.view(b, n, heads, d) for t in qkv.split(heads * d, dim=-1))
    if poison:
        poison_pad_keys(k, v, kv)
    scale = d**-0.5
    if kernel == "qkv_attention_fp32":
        def run(stats=None):
            out, st = mha_kernel._launch(qkv, heads, scale, kv, with_stats=stats is not None)
            if stats is not None:
                stats.copy_(st)
            return out.view(b, n, heads, d)

        plain = lambda: mha_kernel.mha_qkv_attention_reference(qkv, heads, valid_len=kv).view(
            b, n, heads, d)
    elif kernel == "mha_attention_fp32":
        run = lambda stats=None: mha_kernel._launch_mha(q, k, v, scale, kv, stats)
        plain = lambda: mha_kernel.mha_attention_reference(q, k, v, valid_len=kv)
    else:
        run = lambda stats=None: attention._launch(q, k, v, causal, scale, kv, stats)
        plain = lambda: attention.flash_attention_reference(q, k, v, causal=causal, valid_len=kv)
    return qkv, q, k, v, run, plain


def fp32_forward_case(kernel: str, b: int, n: int, heads: int, d: int, valid_len, causal: bool,
                      iters: int, poison: bool) -> dict:
    """An fp32 forward kernel (K1, K3 or K4) against its plain version, its
    row statistics against the plain ones, with SDPA's fp32 time beside."""
    import torch.nn.functional as F

    kv = n if valid_len is None else valid_len
    qkv, q, k, v, run, plain = _fp32_forward(kernel, b, n, heads, d, kv, causal, poison)
    stats = torch.empty(b, heads, n, 2, device="cuda")
    out, ref = run(stats), plain()
    again = run()
    torch.cuda.synchronize()
    err = out[:, :kv] - ref[:, :kv]
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kh, vh = kh[:, :, :kv].contiguous(), vh[:, :, :kv].contiguous()
    library = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    rows = kv if kernel == "flash_attention_fp32" else n  # K4's work: the valid rows
    flops = 4.0 * b * heads * rows * kv * d * (0.5 if causal else 1.0)
    nbytes = 4.0 * (qkv.numel() + b * n * heads * d)
    res = {
        "phase": "fp32_path", "part": "kernel", "name": kernel, "shape": [b, n, heads, d],
        "valid_len": valid_len, "causal": causal, "poisoned_pad_keys": poison,
        "max_abs_err": float(err.abs().max()), "mean_abs_err": float(err.abs().mean()),
        "rel_l2_err": float(err.norm() / ref[:, :kv].norm()),
        "finite": bool(torch.isfinite(out[:, :kv]).all()),
        "stats_call_output_bitwise_equal": bitwise_equal(out, again),
        **row_stats_errors(stats[:, :, :kv], q[:, :kv], k, kv, d**-0.5,
                           prescaled=kernel != "flash_attention_fp32", causal=causal),
        "ms": cuda_ms(run, iters), "plain_ms": cuda_ms(plain, 1, warmup=1),
        "library_ms": cuda_ms(library, iters), **fp32_bounds(flops, nbytes),
    }
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    return res


def fp32_backward_case(kernel: str, b: int, n: int, heads: int, d: int, valid_len, causal: bool,
                       iters: int, poison: bool) -> dict:
    """An fp32 backward kernel (K2, K3's backward or K4b; 3xTF32 on the
    tensor cores) against its plain version on the fp32 forward's output and
    statistics, per gradient, with the masked keys held to exactly 0, a rerun
    held bitwise equal, and SDPA's fp32 backward time beside."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops import attention, mha_kernel

    fwd = kernel.replace("_bwd", "")
    kv = n if valid_len is None else valid_len
    qkv, q, k, v, run, _ = _fp32_forward(fwd, b, n, heads, d, kv, causal, poison)
    stats = torch.empty(b, heads, n, 2, device="cuda")
    out = run(stats)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dout = torch.randn(b, n, heads, d, generator=gen, device="cuda")
    scale, hd = d**-0.5, heads * d
    if kernel == "qkv_attention_bwd_fp32":
        o2, do2 = out.reshape(b, n, hd), dout.reshape(b, n, hd)
        bwd = lambda: tuple(mha_kernel._launch_bwd(qkv, o2, do2, stats, heads, scale, kv).split(
            hd, dim=-1))
        plain = lambda: tuple(mha_kernel.mha_qkv_attention_bwd_reference(
            qkv, o2, do2, heads, valid_len=kv).split(hd, dim=-1))
    elif kernel == "mha_attention_bwd_fp32":
        bwd = lambda: mha_kernel._launch_mha_bwd(q, k, v, out, dout, stats, scale, kv)
        plain = lambda: mha_kernel.mha_attention_bwd_reference(q, k, v, out, dout, valid_len=kv)
    else:
        bwd = lambda: attention._launch_bwd(q, k, v, out, dout, stats, causal, scale, kv)
        plain = lambda: attention.flash_attention_bwd_reference(q, k, v, out, dout,
                                                                causal=causal, valid_len=kv)
    got, ref = bwd(), plain()
    torch.cuda.synchronize()
    rows = kv if kernel == "flash_attention_bwd_fp32" else n
    res = {"phase": "fp32_path", "part": "kernel_bwd", "name": kernel,
           "shape": [b, n, heads, d], "valid_len": valid_len, "causal": causal,
           "poisoned_pad_keys": poison,
           "finite": all(bool(torch.isfinite(g[:, :kv]).all()) for g in got),
           "masked_dkdv_exact_zero": bool((got[1][:, kv:] == 0).all() and (got[2][:, kv:] == 0).all()),
           "rerun_bitwise_equal": rerun_bitwise_equal(bwd, got)}
    grad_errors(res, got, ref, rows, kv)
    del ref
    lib = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    lib[1], lib[2] = lib[1][:, :, :kv].contiguous(), lib[2][:, :, :kv].contiguous()
    lib = [t.requires_grad_(True) for t in lib]
    lib_out = F.scaled_dot_product_attention(*lib, is_causal=causal)
    lib_grad = dout.transpose(1, 2).contiguous()
    library = lambda: torch.autograd.grad(lib_out, lib, lib_grad, retain_graph=True)
    flops = 10.0 * b * heads * rows * kv * d * (0.5 if causal else 1.0)
    nbytes = 4.0 * 8 * b * n * hd + 4.0 * stats.numel()  # q, k, v, O, dO in; dq, dk, dv out
    res.update({"ms": cuda_ms(bwd, iters), "plain_ms": cuda_ms(plain, 1, warmup=1),
                "library_ms": cuda_ms(library, iters),
                **fp32_bounds(flops, nbytes)})
    res["tflops_5_products"] = flops / (res["ms"] * 1e-3) / 1e12
    res["tflops_7_products"] = res["tflops_5_products"] * 7 / 5
    return res


def _fp32_kernel_checks() -> dict:
    """Every fp32 kernel against its plain version at the fp32 paths' shapes."""
    results = collections.defaultdict(list)
    for case in FP32_FWD_CASES:
        res = fp32_forward_case(*case)
        emit(res)
        if not (res["finite"] and res["max_abs_err"] <= FP32_MAX_TOL
                and res["rel_l2_err"] <= FP32_REL_TOL and stats_in_limits(res)
                and res["stats_call_output_bitwise_equal"]):
            raise AssertionError(f"{res['name']} disagrees with its plain version: {res}")
        results[res["name"]].append(res)
        torch.cuda.empty_cache()
    for case in FP32_BWD_CASES:
        res = fp32_backward_case(*case)
        emit(res)
        bad = [p for p in ("dq", "dk", "dv")
               if not (res[p]["rel_l2_err"] <= FP32_BWD_REL_TOL
                       and res[p]["max_abs_err"] <= FP32_BWD_MAX_TOL * res[p]["max_abs_ref"])]
        if bad or not (res["finite"] and res["masked_dkdv_exact_zero"]
                       and res["rerun_bitwise_equal"]):
            raise AssertionError(f"{res['name']} disagrees with its plain version ({bad}): {res}")
        results[res["name"]].append(res)
        torch.cuda.empty_cache()
    return dict(results)


@contextlib.contextmanager
def counted_plain_attention():
    """Counts plain-attention calls (the module-level function the ViT and
    the text tower call) by token count while open."""
    from denseclip_vit_multimodal_tpu_torch.models import layers
    from denseclip_vit_multimodal_tpu_torch.ops import attention

    calls = collections.Counter()
    plain = attention.plain_attention

    def counted(q, *args, **kwargs):
        calls[q.shape[1]] += 1
        return plain(q, *args, **kwargs)

    layers.plain_attention = attention.plain_attention = counted
    try:
        yield calls
    finally:
        layers.plain_attention = attention.plain_attention = plain


def _fp32_slide_and_flash() -> dict:
    """The flagship in fp32 on one seeded 1024x2048 slide frame: 12 K1 fp32
    launches (crop 624 / stride 426 / window batch 20), no plain attention
    but the text tower's, logits against `attn_impl: xla`; the same frame
    with DENSECLIP_FUSED_LNQKV=1 (12 K6 fp32, no K1), against xla too; then
    `flash` at crop 384 (24 K1 fp32 at [10,577,2304] and [5,577,2304])."""
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config, resolve_test_protocol
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.models.layers import set_attn_impl

    cfg = load_config(CONFIG, overrides=[FP32_SET])
    crop, stride, window_batch = resolve_test_protocol(cfg)
    model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.float32,
                                   device="cuda", seed=SEED)
    engine = Inferencer(model, texts, num_classes=19)
    frame = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, 256, (1, 1024, 2048, 3), dtype=np.uint8)).cuda()
    predict = lambda **kw: engine.predict(frame, mode="slide", fetch="device", **kw)
    predict(crop=crop, stride=stride, window_batch=window_batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with counted_plain_attention() as plain_calls, recorded_k1_k2_shapes() as seen:
        kernel_out = predict(crop=crop, stride=stride, window_batch=window_batch)
        torch.cuda.synchronize()
    slide = {"crop": crop, "stride": stride, "window_batch": window_batch,
             "launches": read_launches(), "launch_shapes": shapes_json(seen),
             "plain_attention_calls_by_tokens": dict(plain_calls),
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "ms_per_frame": cuda_ms(lambda: predict(crop=crop, stride=stride,
                                                     window_batch=window_batch), 3, warmup=0)}
    with fused_lnqkv(True):  # K6 in fp32: the fused slide frame
        predict(crop=crop, stride=stride, window_batch=window_batch)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        fused_out = predict(crop=crop, stride=stride, window_batch=window_batch)
        torch.cuda.synchronize()
        fused = {"crop": crop, "env": {FUSED_ENV: "1"}, "launches": read_launches(),
                 "ms_per_frame": cuda_ms(lambda: predict(crop=crop, stride=stride,
                                                         window_batch=window_batch), 3, warmup=0)}
    set_attn_impl(model, "xla")
    plain_out = predict(crop=crop, stride=stride, window_batch=window_batch)
    slide["plain_ms_per_frame"] = cuda_ms(lambda: predict(crop=crop, stride=stride,
                                                          window_batch=window_batch), 2, warmup=0)
    slide["seg_rel_l2_vs_xla"] = rel_l2(kernel_out["seg_logits"], plain_out["seg_logits"])
    slide["depth_rel_l2_vs_xla"] = rel_l2(kernel_out["depth"], plain_out["depth"])
    fused["seg_rel_l2_vs_xla"] = rel_l2(fused_out["seg_logits"], plain_out["seg_logits"])
    fused["depth_rel_l2_vs_xla"] = rel_l2(fused_out["depth"], plain_out["depth"])
    fused["plain_ms_per_frame"] = slide["plain_ms_per_frame"]
    del kernel_out, plain_out, fused_out
    set_attn_impl(model, "flash")
    flash_crop, flash_wb = FLASH_CROPS[1]
    run = lambda: predict(crop=(flash_crop, flash_crop), stride=(426, 426), window_batch=flash_wb)
    run()  # warm-up
    reset_launches()
    with recorded_k1_k2_shapes() as seen:
        run()
        torch.cuda.synchronize()
    flash = {"crop": flash_crop, "window_batch": flash_wb, "launches": read_launches(),
             "launch_shapes": shapes_json(seen), "ms_per_frame": cuda_ms(run, 3, warmup=0)}
    del engine, model
    torch.cuda.empty_cache()
    if slide["launches"] != expected_launches(qkv_attention_fp32=12):
        raise AssertionError(f"fp32 slide frame: expected 12 K1 fp32 launches: {slide}")
    if set(plain_calls) - {TEXT_TOKENS}:
        raise AssertionError(f"fp32 ViT attention reached plain attention: {slide}")
    if not max(slide["seg_rel_l2_vs_xla"], slide["depth_rel_l2_vs_xla"]) <= FP32_PATH_TOL:
        raise AssertionError(f"fp32 slide frame disagrees with attn_impl xla: {slide}")
    if flash["launches"] != expected_launches(qkv_attention_fp32=24):
        raise AssertionError(f"fp32 flash crop-384 frame: expected 24 K1 fp32 launches: {flash}")
    if fused["launches"] != expected_launches(ln_qkv_attention_fp32=12):
        raise AssertionError(f"fp32 fused slide frame: expected 12 K6 fp32 and no K1: {fused}")
    if not max(fused["seg_rel_l2_vs_xla"], fused["depth_rel_l2_vs_xla"]) <= FP32_PATH_TOL:
        raise AssertionError(f"fp32 fused slide frame disagrees with attn_impl xla: {fused}")
    return {"slide": slide, "flash": flash, "fused_slide": fused}


def _fp32_training() -> dict:
    """The heritage preset in fp32 through `train()` (batch 4, crop 640, 1
    warm-up + 2 steps: 12 K1 fp32 + 12 K2 fp32 a step), its step-1 loss
    against one `attn_impl: xla` step, and one step's backbone gradients of
    the segmentation loss, kernels against xla, on fixed weights and batch."""
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
    from denseclip_vit_multimodal_tpu_torch.train.loop import train

    overrides = TRAIN_OVERRIDES + [FP32_SET, "data.synthetic_options.length=12"]

    def run(extra, steps, work_dir):
        shutil.rmtree(work_dir, ignore_errors=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        summary = train(load_config(TRAIN_CONFIG, overrides=overrides + extra), work_dir,
                        max_steps=steps, no_validate=True, device="cuda")
        with open(os.path.join(work_dir, "train_log.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        return {"summary": summary, "launches": read_launches(),
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "losses": [r["loss_total"] for r in rows],
                "step_ms": [r["step_s"] * 1e3 for r in rows],
                "ms_per_step": float(np.mean([r["step_s"] for r in rows[1:]] or
                                             [rows[0]["step_s"]])) * 1e3}

    kernels = run([], FP32_STEPS, FP32_WORK_DIR)  # its checkpoint serves the aug-test
    plain = run(["tpu.attn_impl=xla"], 1, FP32_WORK_DIR + "_xla")
    shutil.rmtree(FP32_WORK_DIR + "_xla", ignore_errors=True)

    cfg = load_config(TRAIN_CONFIG, overrides=overrides)
    seed = int(cfg.training.get("seed", 42))
    loader = DataLoader(build_dataset(cfg.data, "train"), batch_size=int(cfg.training.batch_size),
                        seed=seed, num_threads=int(cfg.training.get("workers", 8)))
    model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.float32,
                                   device="cuda", seed=seed)
    aug_cfg = augment_config_from_data_cfg(cfg.data)
    batch = augment_batch(to_device(next(loader.epoch(0)), "cuda"), aug_cfg,
                          torch.Generator().manual_seed(seed))
    crop = tuple(aug_cfg.crop_size)
    # under deterministic algorithms, so that a rerun's own motion (PyTorch's
    # nondeterministic backward ops) is measured apart and not charged to the kernels
    with deterministic_algorithms() as caught:
        reset_launches()
        k_loss, k_seg = step_grads(model, batch, texts, crop, seed)[:2]
        grad_launches = read_launches()
        k_seg_again = step_grads(model, batch, texts, crop, seed)[1]
        set_attn_impl(model, "xla")
        p_loss, p_seg = step_grads(model, batch, texts, crop, seed)[:2]
        # the step's own conditioning: xla again on the image nudged by 1e-6
        # relative noise, a change of the size fp32 rounding makes
        noise = torch.randn(batch["image"].shape, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(seed))
        nudged = dict(batch, image=batch["image"] * (1.0 + 1e-6 * noise))
        p_seg_nudged = step_grads(model, nudged, texts, crop, seed)[1]
    res = {"config": TRAIN_CONFIG, "overrides": overrides, "steps": FP32_STEPS,
           "kernels": kernels, "xla": plain,
           "loss_rel_diff_step1_vs_xla": abs(kernels["losses"][0] - plain["losses"][0])
           / abs(plain["losses"][0]),
           "grad_step_launches": grad_launches, "grad_step_loss_kernel": k_loss,
           "grad_step_loss_xla": p_loss,
           "backbone_seg_grad_rel_l2_vs_xla": rel_l2(k_seg, p_seg),
           "backbone_seg_grad_rel_l2_rerun": rel_l2(k_seg_again, k_seg),
           "backbone_seg_grad_rel_l2_xla_vs_image_nudged_1e-6": rel_l2(p_seg_nudged, p_seg),
           "ops_without_deterministic_implementation": sorted(
               {str(w.message).split(" does not have a deterministic")[0][:120]
                for w in caught if "deterministic" in str(w.message)})}
    del model, batch, nudged, k_seg, p_seg, k_seg_again, p_seg_nudged
    torch.cuda.empty_cache()
    per_step = 12 * FP32_STEPS
    if kernels["launches"] != expected_launches(qkv_attention_fp32=per_step,
                                                qkv_attention_bwd_fp32=per_step):
        raise AssertionError(f"fp32 training: expected 12 K1 + 12 K2 fp32 a step: {res}")
    if plain["launches"] != expected_launches():
        raise AssertionError(f"the fp32 xla step launched a kernel: {plain['launches']}")
    if not (res["loss_rel_diff_step1_vs_xla"] <= FP32_LOSS_TOL
            and res["backbone_seg_grad_rel_l2_vs_xla"] <= FP32_GRAD_TOL
            and all(np.isfinite(x) for x in kernels["losses"])):
        raise AssertionError(f"fp32 training with the kernels disagrees with xla: {res}")
    return res


def _fp32_aug_test() -> dict:
    """`tools/test.py --aug-test --mode whole` in fp32 on two synthetic
    1024x2048 frames (the first pays the set-up and is not timed), on the
    fp32 training's checkpoint: 36 K1 fp32 + 36 K4 fp32 launches a frame, no
    plain attention but the text tower's."""
    from denseclip_vit_multimodal_tpu_torch.tools.test import main as test_main

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = time.perf_counter()
    with counted_plain_attention() as plain_calls:
        results = test_main([CONFIG, FP32_WORK_DIR, "--aug-test", "--mode", "whole", "--eval",
                             "mIoU", "depth", "--set", *EVAL_OVERRIDES,
                             f"data.synthetic_options.length={FP32_AUG_FRAMES}", FP32_SET])
    res = {"protocol": "aug_test whole, scales 0.5-1.75, flip", "frames": FP32_AUG_FRAMES,
           "entry_point_wall_s": time.perf_counter() - start,
           "s_per_frame": 1.0 / results["images_per_sec"], "launches": read_launches(),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "plain_attention_calls_by_tokens": dict(plain_calls),
           "mIoU": results.get("mIoU")}
    res["launches_per_frame"] = {k: v / FP32_AUG_FRAMES for k, v in res["launches"].items()}
    want = {f"{k}_fp32": n * FP32_AUG_FRAMES for k, n in AUG_VIEW_LAUNCHES.items()}
    if res["launches"] != expected_launches(**want):
        raise AssertionError(f"fp32 aug-test: expected {want}: {res}")
    if set(plain_calls) - {TEXT_TOKENS} or not np.isfinite(results.get("mIoU", float("nan"))):
        raise AssertionError(f"fp32 aug-test reached plain attention or failed: {res}")
    return res


FP32_FWD_DESIGN = ("3xTF32 mma.sync m16n8k8 (attention_fp32.cuh), a warp on 16 query rows; "
                   "K / V tiles through a three-stage cp.async ring into split planes, each "
                   "element split once a tile by the thread that copied it (tf32_frag.cuh), "
                   "tile t + 1 split after tile t's branch-free work; Q split once (in "
                   "registers at head dim 64); P V from the C fragments, each tile's sum one "
                   "fmaf into O; head dim 256 on the SIMT core (attention_fp32_simt.cuh)")
FP32_LNQKV_DESIGN = ("row statistics pass; 3xTF32 mma.sync projection (gemm_fp32.cuh: 128 x 128 "
                     "tiles on 8 warps, a four-stage cp.async ring of 16-deep k-tiles into "
                     "split planes, the LayerNorm applied to each A chunk before its split); "
                     "K1's fp32 body on the q/k/v workspace")

# The fp32 kernels' entries of the `kernels` line: (name, source, the TPU
# kernel replaced, the fp32 path whose launches it reports).
FP32_ENTRIES = (
    ("qkv_attention_fp32", "attention_fp32.cu", "ops/mha_kernel.py:400", "fp32_slide"),
    ("qkv_attention_bwd_fp32", "attention_bwd_fp32.cu", "ops/mha_kernel.py:240",
     "fp32_training"),
    ("mha_attention_fp32", "attention_fp32.cu", "ops/mha_kernel.py:164", "fp32_selftest"),
    ("mha_attention_bwd_fp32", "attention_bwd_fp32.cu", "ops/mha_kernel.py:240 (via :308, :359)",
     "fp32_profile_attn_bwd"),
    ("flash_attention_fp32", "attention_fp32.cu", "ops/attention.py:130", "fp32_aug_test"),
    ("flash_attention_bwd_fp32", "attention_bwd_fp32.cu",
     "jax/experimental/pallas/ops/tpu/flash_attention.py:796 (dkv, call :1121) and :1146 "
     "(dq, call :1456)", "fp32_training_long"),
    ("ln_qkv_attention_fp32", "ln_qkv_attention_fp32.cu", "ops/lnqkv_kernel.py:81",
     "fp32_fused_slide"),
)


def fp32_entries(entry, at_shape, fp32_res: dict, knobs_res: dict) -> list:
    """The seven fp32 kernels' entries: the first case of each (a path's
    shape) in the entry, the rest by shape, and the knob variants' fields."""
    out = []
    for name, source, replaces, path in FP32_ENTRIES:
        first, *rest = fp32_res["kernels"][name]
        design = (FP32_LNQKV_DESIGN if name.startswith("ln_qkv") else
                  "3xTF32 mma.sync m16n8k8 (operands split in registers), a warp on 16 rows, "
                  "p and ds in registers, two-stage cp.async ring (one stage at head dim 256)"
                  if "_bwd" in name else FP32_FWD_DESIGN)
        out.append({**entry(name, source, replaces, first,
                            fp32_res["launches_by_path"][path][name]),
                    "design": design, "path": path, "shape": first["shape"],
                    "valid_len": first["valid_len"],
                    "other_shapes": [at_shape(r) for r in rest],
                    **({"split": first["split"]} if "split" in first else {}),
                    **knob_fields(knobs_res, name)})
    return out


def phase_fp32_path(bf16_long: dict, selftest_res: dict) -> dict:
    """`tpu.compute_dtype: float32` through the kernels: every fp32 kernel
    against its plain version, then each fp32 path with its launches by name,
    times and peak memory (TF32 off for the phase, printed).  `bf16_long` is
    train_long's bf16 kernel run (the long-crop loss is held against its
    step 1); `selftest_res` the selftest phase's line (JAX's fp32 case)."""
    import shutil

    from denseclip_vit_multimodal_tpu_torch.tools.profile_attn_bwd import main as pab_main

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tf32 = {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    emit({"phase": "fp32_path", "part": "settings", **tf32})
    res = {"phase": "fp32_path", **tf32, "kernels": _fp32_kernel_checks(), "paths": {}}
    res["kernels"]["ln_qkv_attention_fp32"] = [lnqkv_mode_case(torch.float32, None, *case)
                                               for case in FP32_LNQKV_CASES]
    res["kernels"]["ln_qkv_attention_fp32"][0]["split"] = lnqkv_fp32_split(
        *FP32_LNQKV_CASES[0])
    paths = res["paths"]
    paths.update(_fp32_slide_and_flash())
    emit({"phase": "fp32_path", "part": "slide_and_flash", **paths})
    paths["training"] = _fp32_training()
    emit({"phase": "fp32_path", "part": "training", **paths["training"]})
    paths["aug_test"] = _fp32_aug_test()
    emit({"phase": "fp32_path", "part": "aug_test", **paths["aug_test"]})
    shutil.rmtree(FP32_WORK_DIR, ignore_errors=True)
    long = _long_run(["tpu.remat=false", FP32_SET], FP32_STEPS)
    long["loss_rel_diff_step1_vs_bf16_kernels"] = (
        abs(long["losses"][0] - bf16_long["losses"][0]) / abs(bf16_long["losses"][0]))
    paths["training_long"] = long
    emit({"phase": "fp32_path", "part": "training_long", **long})
    per_step = 12 * FP32_STEPS
    if long["launches"] != expected_launches(flash_attention_fp32=per_step,
                                             flash_attention_bwd_fp32=per_step):
        raise AssertionError(f"fp32 long crop: expected 12 K4 + 12 K4b fp32 a step: {long}")
    if not (all(np.isfinite(x) for x in long["losses"])
            and long["loss_rel_diff_step1_vs_bf16_kernels"] <= FP32_LONG_TOL):
        raise AssertionError(f"fp32 long-crop loss disagrees with the bf16 route's: {long}")
    fp32_lines = [ln for ln in selftest_res["lines"] if "float32" in ln]
    paths["selftest"] = {"lines": fp32_lines, "launches": selftest_res["launches"]}
    if not (len(fp32_lines) == 2 and all(ln.startswith("PASS") for ln in fp32_lines)
            and selftest_res["launches"]["mha_attention_fp32"] == 1
            and selftest_res["launches"]["qkv_attention_fp32"] == 1):
        raise AssertionError(f"the self-test's fp32 case did not pass on the fp32 kernels: "
                             f"{paths['selftest']}")
    torch.cuda.empty_cache()
    reset_launches()
    pab = pab_main(["--out", "build/profile_attn_bwd_fp32.json", "--dtype", "float32",
                    "--iters", "3"])
    paths["profile_attn_bwd"] = {**pab, "launches": read_launches()}
    emit({"phase": "fp32_path", "part": "profile_attn_bwd", **paths["profile_attn_bwd"]})
    if not (all(pab[f"relerr_{g}"] <= FP32_BWD_MAX_TOL for g in ("dq", "dk", "dv"))
            and paths["profile_attn_bwd"]["launches"]["mha_attention_fp32"]
            and paths["profile_attn_bwd"]["launches"]["mha_attention_bwd_fp32"]):
        raise AssertionError(f"profile_attn_bwd in fp32: {paths['profile_attn_bwd']}")
    res["launches_by_path"] = {
        "fp32_slide": paths["slide"]["launches"], "fp32_flash": paths["flash"]["launches"],
        "fp32_fused_slide": paths["fused_slide"]["launches"],
        "fp32_training": paths["training"]["kernels"]["launches"],
        "fp32_aug_test": paths["aug_test"]["launches"],
        "fp32_training_long": paths["training_long"]["launches"],
        "fp32_selftest": paths["selftest"]["launches"],
        "fp32_profile_attn_bwd": paths["profile_attn_bwd"]["launches"]}
    return res


# ---------------------------------------------------------------------------
# The softmax knobs (DENSECLIP_FAST_EXP2, DENSECLIP_EXP_BF16) and the fp32
# K6 / K7
# ---------------------------------------------------------------------------

KNOB_ENVS = ("DENSECLIP_FAST_EXP2", "DENSECLIP_EXP_BF16")
# A kernel under a knob against its plain version under the same knob: the
# fp32 / bf16 limits above, and the check must see the knob: the kernel at
# most a fifth as far from the plain version in its mode as from the exact
# one (outputs in fp32 and under EXP_BF16; bf16 outputs under FAST_EXP2, where
# the polynomial's 8.4e-5 hides under the rounding, through the row sums).
KNOB_SEES = 5.0
# EXP_BF16's row sums: one flipped bf16 rounding of s - m (the scores' fp32
# sums run in another order than the plain version's) moves its p by up to
# 2^-8 |s - m| ln 2
KNOB_STATS_L_BF16_TOL = 2e-3


@contextlib.contextmanager
def softmax_knob(name=None):
    """The softmax knob `name` set to 1 inside the block only, the other to 0."""
    before = {k: os.environ.get(k) for k in KNOB_ENVS}
    for k in KNOB_ENVS:
        os.environ[k] = "1" if k == name else "0"
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def knob_stats(q, k, kv: int, scale: float, mode: int):
    """The plain row max and sum [B, H, N] of K1's / K3's logits under `mode`,
    one head at a time."""
    from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as M

    qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    ms, ls = [], []
    for h in range(q.shape[2]):
        s = qs[:, :, h] @ k[:, :kv, h].float().transpose(-1, -2)
        m = M.row_max(s, mode)
        ms.append(m[..., 0])
        ls.append(M.softmax_exp(s - m, mode).sum(-1))
        del s
    return torch.stack(ms, 1), torch.stack(ls, 1)


def knob_forward_case(kernel: str, dtype, knob: str, b: int, n: int, heads: int, d: int,
                      valid_len, iters: int) -> dict:
    """K1 ("qkv") or K3 ("mha") under `knob` against its plain version in the
    same mode (outputs on the rows below valid_len, row statistics), beside
    the plain version without the knob and the same launch with the knob off
    (`default_ms`, timed in this run)."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as M

    hd, scale = heads * d, d**-0.5
    kv = n if valid_len is None else valid_len
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(dtype)
    q, k, v = (t.view(b, n, heads, d) for t in qkv.split(hd, dim=-1))
    with softmax_knob(knob):
        mode = M.softmax_modes(kernel, dtype, n, valid_len)[0]
    name = M.kernel_name(f"{kernel}_attention", dtype, mode)
    if kernel == "qkv":
        run = lambda m: M._launch(qkv, heads, scale, kv, with_stats=True, exp_mode=m)
        plain = lambda m: M.mha_qkv_attention_reference(qkv, heads, valid_len=kv, exp_mode=m)
    else:
        def run(m):
            stats = torch.empty(b, heads, n, 2, device="cuda")
            return M._launch_mha(q, k, v, scale, kv, stats, m).reshape(b, n, hd), stats
        plain = lambda m: M.mha_attention_reference(q, k, v, valid_len=kv,
                                                    exp_mode=m).reshape(b, n, hd)
    before = M.LAUNCHES[name]
    out, stats = run(mode)
    launches = M.LAUNCHES[name] - before
    again = run(mode)[0]
    ref, ref_exact = plain(mode)[:, :kv].float(), plain(M.EXP_EXACT)[:, :kv].float()
    got = out[:, :kv].float()
    m_plain, l_plain = knob_stats(q, k, kv, scale, mode)
    m_exact, l_exact = knob_stats(q, k, kv, scale, M.EXP_EXACT)
    l_exact = l_exact * torch.exp2(m_exact - m_plain)  # the exp2 sums at the same max
    st = stats[:, :, :kv]
    res = {
        "phase": "knobs_path", "part": "kernel", "name": name, "knob": knob, "exp_mode": mode,
        "dtype": str(dtype), "shape": [b, n, 3 * hd] if kernel == "qkv" else [b, n, heads, d],
        "valid_len": valid_len, "launches_one_call": launches,
        "max_abs_err": float((got - ref).abs().max()), "rel_l2_err": rel_l2(got, ref),
        "rel_l2_vs_exact_plain": rel_l2(got, ref_exact),
        "stats_m_max_abs_err": float((st[..., 0] - m_plain[:, :, :kv]).abs().max()),
        "stats_l_max_rel_err": float(((st[..., 1] - l_plain[:, :, :kv])
                                      / l_plain[:, :, :kv]).abs().max()),
        "stats_l_max_rel_vs_exact": float(((st[..., 1] - l_exact[:, :, :kv])
                                           / l_plain[:, :, :kv]).abs().max()),
        "rerun_bitwise_equal": bitwise_equal(out, again),
        "finite": bool(torch.isfinite(got).all()),
    }
    del ref, ref_exact, got, m_plain, l_plain, m_exact, l_exact
    flops = 4.0 * b * heads * n * kv * d
    nbytes = qkv.element_size() * (qkv.numel() + out.numel())
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kh, vh = kh[:, :, :kv].contiguous(), vh[:, :, :kv].contiguous()
    default_ms = cuda_ms(lambda: run(0), iters)  # first: it also warms the card up
    res.update({
        "ms": cuda_ms(lambda: run(mode), iters), "default_ms": default_ms,
        "plain_ms": cuda_ms(lambda: plain(mode), 1, warmup=1),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters),
        **kernel_bounds(dtype, flops, nbytes)})
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    fp32 = dtype == torch.float32
    out_ok = (res["max_abs_err"] <= (FP32_MAX_TOL if fp32 else KERNEL_TOL)
              and res["rel_l2_err"] <= (FP32_REL_TOL if fp32 else KERNEL_REL_TOL))
    stats_ok = (res["stats_m_max_abs_err"] <= STATS_M_TOL and res["stats_l_max_rel_err"]
                <= (KNOB_STATS_L_BF16_TOL if mode == M.EXP_BF16 else STATS_L_TOL))
    if fp32 or mode == M.EXP_BF16:
        sees = res["rel_l2_err"] * KNOB_SEES <= res["rel_l2_vs_exact_plain"]
    else:
        sees = res["stats_l_max_rel_err"] * KNOB_SEES <= res["stats_l_max_rel_vs_exact"]
    res["sees_the_knob"] = bool(sees)
    emit(res)
    if not (out_ok and stats_ok and sees and launches == 1 and res["finite"]
            and res["rerun_bitwise_equal"]):
        raise AssertionError(f"{name} disagrees with its plain version under {knob}: {res}")
    return res


def knob_backward_case(kernel: str, dtype, b: int, n: int, heads: int, d: int, valid_len,
                       iters: int) -> dict:
    """K2 ("qkv") or K3's backward ("mha") under DENSECLIP_FAST_EXP2 on the
    forward's output and statistics under the knob, against the plain
    backward in the same mode, per gradient."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as M

    hd, scale = heads * d, d**-0.5
    kv = n if valid_len is None else valid_len
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(dtype)
    dout = torch.randn(b, n, hd, generator=gen, device="cuda").to(dtype)
    q, k, v = (t.view(b, n, heads, d) for t in qkv.split(hd, dim=-1))
    with softmax_knob("DENSECLIP_FAST_EXP2"):
        mode = M.softmax_modes(kernel, dtype, n, valid_len)[1]
    name = M.kernel_name(f"{kernel}_attention_bwd", dtype, mode)
    split = lambda g: tuple(g.split(hd, dim=-1))
    view = lambda t: t.view(b, n, heads, d)
    flat = lambda gs: tuple(g.reshape(b, n, hd) for g in gs)
    if kernel == "qkv":
        out, stats = M._launch(qkv, heads, scale, kv, with_stats=True, exp_mode=mode)
        bwd = lambda: split(M._launch_bwd(qkv, out, dout, stats, heads, scale, kv, mode))
        plain = lambda m: split(M.mha_qkv_attention_bwd_reference(
            qkv, M.mha_qkv_attention_reference(qkv, heads, valid_len=kv, exp_mode=m), dout, heads,
            valid_len=kv, exp_mode=m))
    else:
        stats = torch.empty(b, heads, n, 2, device="cuda")
        out = M._launch_mha(q, k, v, scale, kv, stats, mode)
        bwd = lambda: flat(M._launch_mha_bwd(q, k, v, out, view(dout), stats, scale, kv, mode))
        plain = lambda m: flat(M.mha_attention_bwd_reference(
            q, k, v, M.mha_attention_reference(q, k, v, valid_len=kv, exp_mode=m), view(dout),
            valid_len=kv, exp_mode=m))
    before = M.LAUNCHES[name]
    got = bwd()
    launches = M.LAUNCHES[name] - before
    ref, ref_exact = plain(mode), plain(M.EXP_EXACT)
    torch.cuda.synchronize()
    res = {"phase": "knobs_path", "part": "kernel_bwd", "name": name,
           "knob": "DENSECLIP_FAST_EXP2", "exp_mode": mode, "dtype": str(dtype),
           "shape": [b, n, 3 * hd], "valid_len": valid_len, "launches_one_call": launches,
           "rerun_bitwise_equal": rerun_bitwise_equal(bwd, got),
           "finite": all(bool(torch.isfinite(g).all()) for g in got)}
    grad_errors(res, got, ref, n, kv)
    res["rel_l2_vs_exact_plain"] = {p: rel_l2(g[:, :lim], r[:, :lim]) for p, g, r, lim in zip(
        ("dq", "dk", "dv"), got, ref_exact, (n, kv, kv))}
    del ref, ref_exact
    lib = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    lib[1], lib[2] = lib[1][:, :, :kv].contiguous(), lib[2][:, :, :kv].contiguous()
    lib = [t.requires_grad_(True) for t in lib]
    lib_out = F.scaled_dot_product_attention(*lib)
    lib_grad = view(dout).transpose(1, 2).contiguous()
    flops = 10.0 * b * heads * n * kv * d
    nbytes = qkv.element_size() * 8 * b * n * hd
    res.update({"ms": cuda_ms(bwd, iters), "plain_ms": cuda_ms(lambda: plain(mode), 1, warmup=1),
                "library_ms": cuda_ms(lambda: torch.autograd.grad(lib_out, lib, lib_grad,
                                                                  retain_graph=True), iters),
                **kernel_bounds(dtype, flops, nbytes)})
    res["tflops_5_products"] = flops / (res["ms"] * 1e-3) / 1e12
    if kernel == "qkv":
        res["default_ms"] = cuda_ms(lambda: M._launch_bwd(qkv, out, dout, stats, heads, scale, kv),
                                    iters)
    else:
        res["default_ms"] = cuda_ms(lambda: M._launch_mha_bwd(q, k, v, out, view(dout), stats,
                                                              scale, kv), iters)
    fp32 = dtype == torch.float32
    rel_tol, max_tol = ((FP32_BWD_REL_TOL, FP32_BWD_MAX_TOL) if fp32
                        else (KERNEL_BWD_REL_TOL, KERNEL_BWD_MAX_TOL))
    bad = [p for p in ("dq", "dk", "dv") if not (res[p]["rel_l2_err"] <= rel_tol and
                                                 res[p]["max_abs_err"] <= max_tol * res[p]["max_abs_ref"])]
    # fp32 gradients see the knob; bf16 ones carry it under their rounding (the
    # forward's row sums show it)
    sees = (not fp32) or sum(res[p]["rel_l2_err"] for p in ("dq", "dk", "dv")) * KNOB_SEES <= sum(
        res["rel_l2_vs_exact_plain"].values())
    res["sees_the_knob"] = bool(sees)
    emit(res)
    if bad or not (sees and launches == 1 and res["finite"] and res["rerun_bitwise_equal"]):
        raise AssertionError(f"{name} disagrees with its plain backward ({bad}): {res}")
    return res


def _lnqkv_operands(b: int, n: int, dim: int, dtype):
    """ln_qkv_attention_case's seeded x and ln_1 / qkv parameters, W in `dtype`."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(b, n, dim, generator=gen, device="cuda").to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(dim, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(dim, generator=gen, device="cuda")
    limit = (6.0 / (4 * dim)) ** 0.5
    w = ((torch.rand(3 * dim, dim, generator=gen, device="cuda") * 2 - 1) * limit).to(dtype)
    bias = 0.02 * torch.randn(3 * dim, generator=gen, device="cuda")
    return x, gamma, beta, w, bias


def lnqkv_mode_case(dtype, knob, b: int, n: int, dim: int, heads: int, valid_len,
                    iters: int) -> dict:
    """K6 (bf16 or fp32) with the knob `knob` (or none) against its plain
    version in the same mode; under the knob, the attention on K6's own
    first-stage workspace in that mode shows it (bf16 workspace rounding
    hides the polynomial in the whole kernel's comparison).  Beside it the
    unfused chain in PyTorch's own calls (LayerNorm, Linear, SDPA; TF32 off)."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as M
    from denseclip_vit_multimodal_tpu_torch.ops.lnqkv_kernel import (
        LAUNCHES,
        ln_qkv_attention,
        ln_qkv_attention_reference,
        ln_qkv_projection,
    )

    d = dim // heads
    kv = n if valid_len is None else valid_len
    x, gamma, beta, w, bias = _lnqkv_operands(b, n, dim, dtype)
    args = (x, gamma, beta, w.t(), bias, heads)
    # the knob-off launch first: it also warms the card up
    default_ms = cuda_ms(lambda: ln_qkv_attention(*args, valid_len=valid_len), iters)
    with softmax_knob(knob):
        mode = M.softmax_modes("ln_qkv", dtype, n, valid_len)[0]
        run = lambda: ln_qkv_attention(*args, valid_len=valid_len)
        name = M.kernel_name("ln_qkv_attention", dtype, mode)
        before = LAUNCHES[name]
        out = run()
        launches = LAUNCHES[name] - before
        again = run()
        ms = cuda_ms(run, iters)
    ref = ln_qkv_attention_reference(*args, valid_len=valid_len, exp_mode=mode)
    got, ref = out[:, :kv].float(), ref[:, :kv].float()
    res = {"phase": "knobs_path" if knob else "fp32_path", "part": "kernel_lnqkv", "name": name,
           "knob": knob, "exp_mode": mode, "dtype": str(dtype), "shape": [b, n, dim],
           "heads": heads, "valid_len": valid_len, "launches_one_call": launches,
           "max_abs_err": float((got - ref).abs().max()), "rel_l2_err": rel_l2(got, ref),
           "rerun_bitwise_equal": bitwise_equal(out, again),
           "finite": bool(torch.isfinite(got).all())}
    if mode != M.EXP_EXACT:
        ws = ln_qkv_projection(*args)
        qw, kw, vw = (t.view(b, n, heads, d) for t in ws.split(dim, dim=-1))
        on_ws = M.attention_prescaled(qw, kw, vw, kv, mode).reshape(b, n, dim)[:, :kv].float()
        off_ws = M.attention_prescaled(qw, kw, vw, kv).reshape(b, n, dim)[:, :kv].float()
        res["own_workspace_rel_l2"] = rel_l2(got, on_ws)
        res["own_workspace_rel_l2_vs_exact"] = rel_l2(got, off_ws)
        del ws, qw, kw, vw, on_ws, off_ws
    del got, ref
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    def library():  # F.layer_norm + F.linear + SDPA in x's dtype
        qkv = F.linear(F.layer_norm(x, (dim,), gamma.to(dtype), beta.to(dtype), 1e-5), w,
                       bias.to(dtype))
        q, k, v = (t.view(b, n, heads, d).transpose(1, 2) for t in qkv.split(dim, dim=-1))
        return F.scaled_dot_product_attention(q, k[:, :, :kv], v[:, :, :kv])

    flops = 2.0 * b * n * dim * 3 * dim + 4.0 * b * heads * n * kv * d
    nbytes = x.element_size() * (x.numel() + w.numel() + out.numel()) + 4.0 * (2 * dim + 3 * dim)
    bounds = kernel_bounds(dtype, flops, nbytes)
    res.update({"ms": ms, "default_ms": default_ms,
                "plain_ms": cuda_ms(lambda: ln_qkv_attention_reference(
                    *args, valid_len=valid_len, exp_mode=mode), 1, warmup=1),
                "library_ms": cuda_ms(library, iters), **bounds})
    torch.backends.cuda.matmul.allow_tf32 = prev
    res["tflops"] = flops / (ms * 1e-3) / 1e12
    fp32 = dtype == torch.float32
    ok = (res["max_abs_err"] <= (FP32_MAX_TOL if fp32 else KERNEL_TOL)
          and res["rel_l2_err"] <= (FP32_REL_TOL if fp32 else KERNEL_REL_TOL))
    sees = mode == M.EXP_EXACT or (
        res["own_workspace_rel_l2"] * KNOB_SEES <= res["own_workspace_rel_l2_vs_exact"])
    res["sees_the_knob"] = bool(sees)
    emit(res)
    if not (ok and sees and launches == 1 and res["finite"] and res["rerun_bitwise_equal"]):
        raise AssertionError(f"{name} disagrees with its plain version: {res}")
    return res


def lnqkv_fp32_split(b: int, n: int, dim: int, heads: int, valid_len, iters: int) -> dict:
    """K6 in fp32 one stage at a time (its stage entry points, which count no
    launch), on lnqkv_mode_case's operands: the statistics bitwise
    `ln_qkv_stats_reference`'s, the projection's workspace against
    `ln_qkv_projection_reference` (the fp32 output limits), the second stage
    bitwise the whole kernel's output; each stage's time beside
    `F.layer_norm` and `F.linear` in fp32 (TF32 off) and the projection's
    bounds."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops.lnqkv_kernel import (
        kernel_fns,
        ln_qkv_attention,
        ln_qkv_projection_reference,
        ln_qkv_stats_reference,
    )

    d, rows = dim // heads, b * n
    kv = n if valid_len is None else valid_len
    x, gamma, beta, w, bias = _lnqkv_operands(b, n, dim, torch.float32)
    fns = kernel_fns(torch.float32)
    stats = torch.empty(rows, 2, device="cuda")
    work = torch.empty(b, n, 3 * dim, device="cuda")
    out = torch.empty(b, n, dim, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def check(err_code):
        if err_code != 0:
            raise RuntimeError(f"K6 fp32 stage launch failed: cudaError {err_code}")

    params = [t.data_ptr() for t in (x, gamma, beta, w, bias)]
    stats_run = lambda: check(fns["stats"](x.data_ptr(), stats.data_ptr(), rows, dim, 1e-5,
                                           stream))
    gemm_run = lambda: check(fns["gemm"](*params, stats.data_ptr(), work.data_ptr(), rows, dim,
                                         dim, d**-0.5 * LOG2E, stream))
    stage2_run = lambda: check(fns["stage2"](work.data_ptr(), out.data_ptr(), b, n, heads, d, kv,
                                             stream))
    stats_run()
    gemm_run()
    stage2_run()
    whole = ln_qkv_attention(x, gamma, beta, w.t(), bias, heads, valid_len=valid_len)
    torch.cuda.synchronize()
    ws_ref = ln_qkv_projection_reference(x, gamma, beta, w.t(), bias, heads)
    ws_err = work[:, :kv].double() - ws_ref[:, :kv].double()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ln = lambda: F.layer_norm(x, (dim,), gamma, beta, 1e-5)
    lnx = ln()
    proj_flops = 2.0 * rows * dim * 3 * dim
    split = {
        "stats_bitwise_equal": torch.equal(stats.view(b, n, 2)[:, :kv],
                                           ln_qkv_stats_reference(x[:, :kv])),
        "workspace_max_abs_err": float(ws_err.abs().max()),
        "workspace_rel_l2_err": float(ws_err.norm() / ws_ref[:, :kv].double().norm()),
        "stage2_bitwise_equal": bitwise_equal(out, whole),
        "stats_ms": cuda_ms(stats_run, iters), "projection_ms": cuda_ms(gemm_run, iters),
        "stage2_ms": cuda_ms(stage2_run, iters),
        "layer_norm_ms": cuda_ms(ln, iters),
        "linear_ms": cuda_ms(lambda: F.linear(lnx, w, bias), iters),
        **{f"projection_{k}": v for k, v in fp32_bounds(
            proj_flops, 4.0 * (2 * x.numel() + w.numel())).items()},
    }
    torch.backends.cuda.matmul.allow_tf32 = prev
    split["projection_tflops"] = proj_flops / (split["projection_ms"] * 1e-3) / 1e12
    emit({"phase": "fp32_path", "part": "kernel_lnqkv_split", "shape": [b, n, dim], **split})
    if not (split["stats_bitwise_equal"] and split["stage2_bitwise_equal"]
            and split["workspace_max_abs_err"] <= FP32_MAX_TOL
            and split["workspace_rel_l2_err"] <= FP32_REL_TOL):
        raise AssertionError(f"K6 fp32's stages disagree: {split}")
    return split


def outproj_mode_case(dtype, knob, b: int, n: int, heads: int, d: int, valid_len,
                      iters: int) -> dict:
    """K7 (bf16 or fp32) with the knob `knob` (or none) against its plain
    version in the same mode, outputs in fp32 (the knob shows there); beside
    it the yardstick K1 + torch.matmul (TF32 off) and the default launch."""
    from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as M
    from denseclip_vit_multimodal_tpu_torch.tools import exp_outproj_epilogue as exp

    hd = heads * d
    kv = n if valid_len is None else valid_len
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(hd, hd, generator=gen, device="cuda") * 0.02).to(dtype)
    # the knob-off launch first: it also warms the card up
    default_ms = cuda_ms(lambda: exp.qkv_out_attention(qkv, w, heads, valid_len=valid_len), iters)
    with softmax_knob(knob):
        mode = M.softmax_modes("qkv_out", dtype, n, valid_len)[0]
        run = lambda: exp.qkv_out_attention(qkv, w, heads, valid_len=valid_len)
        name = M.kernel_name("qkv_out_attention", dtype, mode)
        before = exp.LAUNCHES[name]
        out = run()
        launches = exp.LAUNCHES[name] - before
        again = run()
        ms = cuda_ms(run, iters)
        yard = lambda: torch.matmul(M.mha_qkv_attention(qkv, heads, valid_len=valid_len),
                                    w).float()
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        yard_ms = cuda_ms(yard, iters)
        torch.backends.cuda.matmul.allow_tf32 = prev
    ref = exp.qkv_out_attention_reference(qkv, w, heads, valid_len=valid_len, exp_mode=mode)
    ref_exact = exp.qkv_out_attention_reference(qkv, w, heads, valid_len=valid_len)
    torch.cuda.synchronize()
    got, ref, ref_exact = out[:, :kv], ref[:, :kv], ref_exact[:, :kv]
    flops = 4.0 * b * heads * n * kv * d + 2.0 * b * n * hd * hd
    nbytes = qkv.element_size() * (qkv.numel() + w.numel()) + 4.0 * b * n * hd
    bounds = kernel_bounds(dtype, flops, nbytes)
    res = {"phase": "outproj_path", "part": "kernel", "name": name, "knob": knob,
           "exp_mode": mode, "dtype": str(dtype), "shape": [b, n, 3 * hd], "valid_len": valid_len,
           "launches_one_call": launches, "max_abs_err": float((got - ref).abs().max()),
           "rel_l2_err": rel_l2(got, ref), "rel_l2_vs_exact_plain": rel_l2(got, ref_exact),
           "rerun_bitwise_equal": bitwise_equal(out, again),
           "finite": bool(torch.isfinite(got).all()), "ms": ms, "default_ms": default_ms,
           "k1_matmul_ms": yard_ms,
           "plain_ms": cuda_ms(lambda: exp.qkv_out_attention_reference(
               qkv, w, heads, valid_len=valid_len, exp_mode=mode), 1, warmup=1),
           "library_ms": None,  # no one PyTorch call computes attention + out-projection
           **bounds}
    res["tflops"] = flops / (ms * 1e-3) / 1e12
    fp32 = dtype == torch.float32
    scale = float(ref.abs().max())
    ok = ((res["max_abs_err"] <= FP32_MAX_TOL and res["rel_l2_err"] <= FP32_REL_TOL) if fp32 else
          (res["max_abs_err"] <= KERNEL_TOL * scale and res["rel_l2_err"] <= KERNEL_REL_TOL))
    sees = mode == M.EXP_EXACT or res["rel_l2_err"] * KNOB_SEES <= res["rel_l2_vs_exact_plain"]
    res["sees_the_knob"] = bool(sees)
    emit(res)
    if not (ok and sees and launches == 1 and res["finite"] and res["rerun_bitwise_equal"]):
        raise AssertionError(f"{name} disagrees with its plain version: {res}")
    return res


def knob_controls() -> dict:
    """K4, K4b, K5 and its prologue read neither knob: with both set, their
    outputs are bitwise those of the same calls with both off."""
    from denseclip_vit_multimodal_tpu_torch.ops import attention, mha_kernel as M

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(10, 1536, 2304, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (t.view(10, 1536, 12, 64)[:2] for t in qkv.split(768, dim=-1))
    dout = torch.randn(2, 1536, 12, 64, generator=gen, device="cuda").to(torch.bfloat16)

    def run():
        out = {"int8": M.mha_qkv_attention_int8(qkv, 12, valid_len=1522),
               "prologue": M.QUANTIZE_QKV_INT8_OP(qkv, 12, 1522)}
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        k4 = attention.flash_attention(*leaves, causal=True, valid_len=1500)
        k4.backward(dout)
        out.update(k4=k4.detach(), k4b=[t.grad for t in leaves])
        torch.cuda.synchronize()
        return out

    off = run()
    reset_launches()
    with softmax_knob("DENSECLIP_FAST_EXP2"):
        os.environ["DENSECLIP_EXP_BF16"] = "1"
        on = run()
    launches = read_launches()
    res = {"phase": "knobs_path", "part": "controls", "launches": launches}
    res["bitwise_equal"] = {
        "qkv_attention_int8": torch.equal(on["int8"], off["int8"]),
        # q8's q and k thirds, V's key-major copy, the scales (the kernel
        # leaves q8's v third unwritten: nothing reads it)
        "quantize_qkv_int8": all(torch.equal(a, b) for a, b in zip(
            (on["prologue"][0][..., :1536], *on["prologue"][1:]),
            (off["prologue"][0][..., :1536], *off["prologue"][1:]))),
        "flash_attention": torch.equal(on["k4"], off["k4"]),
        "flash_attention_bwd": all(torch.equal(a, b) for a, b in zip(on["k4b"], off["k4b"]))}
    emit(res)
    want = expected_launches(qkv_attention_int8=1, quantize_qkv_int8=2, flash_attention=1,
                             flash_attention_bwd=1)
    if launches != want or not all(res["bitwise_equal"].values()):
        raise AssertionError(f"K4 / K4b / K5 moved under the knobs (or took another route): {res}")
    return res


class PlainQKVAttention(torch.autograd.Function):
    """K1's and K2's plain versions under the knobs' modes on CUDA tensors
    (the yardstick of the training step under a knob)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, valid_len, modes):
        from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as M

        ctx.save_for_backward(qkv)
        ctx.attrs = (num_heads, valid_len, modes[1])
        return M.mha_qkv_attention_reference(qkv, num_heads, valid_len=valid_len,
                                             exp_mode=modes[0])

    @staticmethod
    def backward(ctx, dout):
        from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as M

        (qkv,) = ctx.saved_tensors
        num_heads, valid_len, mode = ctx.attrs
        out = M.mha_qkv_attention_reference(qkv, num_heads, valid_len=valid_len, exp_mode=mode)
        return M.mha_qkv_attention_bwd_reference(qkv, out, dout, num_heads, valid_len=valid_len,
                                                 exp_mode=mode), None, None, None


@contextlib.contextmanager
def plain_kernels_under_knobs():
    """The ViT's K1 (with K2 under autograd) and K6 calls run their plain
    versions on the card, in the modes the knobs give each call."""
    from denseclip_vit_multimodal_tpu_torch.models import layers
    from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as M
    from denseclip_vit_multimodal_tpu_torch.ops.lnqkv_kernel import ln_qkv_attention_reference

    def k1(qkv, num_heads, *, valid_len=None, sm_scale=None):
        modes = M.softmax_modes("qkv", qkv.dtype, qkv.shape[1], valid_len)
        kv = qkv.shape[1] if valid_len is None else valid_len
        if torch.is_grad_enabled() and qkv.requires_grad:
            return PlainQKVAttention.apply(qkv, num_heads, kv, modes)
        return M.mha_qkv_attention_reference(qkv, num_heads, valid_len=kv, exp_mode=modes[0])

    def k6(x, gamma, beta, w, b, num_heads, *, eps=1e-5, valid_len=None, sm_scale=None):
        mode = M.softmax_modes("ln_qkv", x.dtype, x.shape[1], valid_len)[0]
        return ln_qkv_attention_reference(x, gamma, beta, w, b, num_heads, eps=eps,
                                          valid_len=valid_len, exp_mode=mode)

    saved = layers.mha_qkv_attention, layers.ln_qkv_attention
    layers.mha_qkv_attention, layers.ln_qkv_attention = k1, k6
    try:
        yield
    finally:
        layers.mha_qkv_attention, layers.ln_qkv_attention = saved


def knob_frame(model, texts, frame, knob, fused: bool, want: dict, tol: float,
               impl: str = "auto") -> dict:
    """One seeded slide frame of the flagship under `knob` (fused: K6's
    route): its launches by name (exactly `want`), its logits against the
    same frame with each kernel's plain version under the same knob, and
    against the kernels with the knob off."""
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config, resolve_test_protocol
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.models.layers import set_attn_impl

    crop, stride, window_batch = resolve_test_protocol(load_config(CONFIG))
    set_attn_impl(model, impl)
    engine = Inferencer(model, texts, num_classes=19)
    predict = lambda: engine.predict(frame, mode="slide", crop=crop, stride=stride,
                                     window_batch=window_batch, fetch="device")
    with fused_lnqkv(fused):
        off = predict()
        with softmax_knob(knob):
            predict()  # warm-up under the knob
            torch.cuda.synchronize()
            reset_launches()
            on = predict()
            torch.cuda.synchronize()
            launches = read_launches()
            ms = cuda_ms(predict, 2, warmup=0)
            with plain_kernels_under_knobs():
                reset_launches()
                plain = predict()
                plain_launches = read_launches()
    set_attn_impl(model, "auto")
    res = {"knob": knob, "fused": fused, "attn_impl": impl, "launches": launches,
           "plain_run_launches": plain_launches, "ms_per_frame": ms,
           "seg_rel_l2_vs_plain": rel_l2(on["seg_logits"], plain["seg_logits"]),
           "depth_rel_l2_vs_plain": rel_l2(on["depth"], plain["depth"]),
           "seg_rel_l2_vs_knob_off": rel_l2(on["seg_logits"], off["seg_logits"]),
           "seg_bitwise_equal_to_knob_off": bitwise_equal(on["seg_logits"], off["seg_logits"]),
           "tol": tol}
    if launches != expected_launches(**want):
        raise AssertionError(f"frame under {knob}: expected {want}: {res}")
    if impl == "int8":
        if not res["seg_bitwise_equal_to_knob_off"]:
            raise AssertionError(f"the int8 request moved under {knob}: {res}")
    elif not max(res["seg_rel_l2_vs_plain"], res["depth_rel_l2_vs_plain"]) <= tol:
        raise AssertionError(f"frame under {knob} disagrees with the plain versions: {res}")
    return res


def knob_training_step() -> dict:
    """One crop-640 step of the heritage preset (batch 4) under
    DENSECLIP_FAST_EXP2 on fixed weights and batch: 12 K1 + 12 K2 under the
    knob; its loss against the same step with K1's / K2's plain versions
    under the knob, and its backbone seg-loss gradients beside."""
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

    cfg = load_config(TRAIN_CONFIG, overrides=TRAIN_OVERRIDES)
    tcfg, dcfg = cfg.training, cfg.data
    seed, batch_size = int(tcfg.get("seed", 42)), int(tcfg.batch_size)
    loader = DataLoader(build_dataset(dcfg, "train"), batch_size=batch_size, seed=seed,
                        num_threads=2)
    model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.bfloat16,
                                   device="cuda", seed=seed)
    aug_cfg = augment_config_from_data_cfg(dcfg)
    batch = augment_batch(to_device(next(loader.epoch(0)), "cuda"), aug_cfg,
                          torch.Generator().manual_seed(seed))
    crop = tuple(aug_cfg.crop_size)
    with softmax_knob("DENSECLIP_FAST_EXP2"):
        step_grads(model, batch, texts, crop, seed)  # warm-up
        reset_launches()
        loss, grads = step_grads(model, batch, texts, crop, seed)[:2]
        launches = read_launches()
        with plain_kernels_under_knobs():
            reset_launches()
            plain_loss, plain_grads = step_grads(model, batch, texts, crop, seed)[:2]
            plain_launches = read_launches()
    off_loss, off_grads = step_grads(model, batch, texts, crop, seed)[:2]
    res = {"batch": batch_size, "crop": list(crop), "launches": launches,
           "plain_run_launches": plain_launches, "loss": loss, "loss_plain": plain_loss,
           "loss_knob_off": off_loss,
           "loss_rel_diff_vs_plain": abs(loss - plain_loss) / abs(plain_loss),
           "backbone_seg_grad_rel_l2_vs_plain": rel_l2(grads, plain_grads),
           "backbone_seg_grad_rel_l2_vs_knob_off": rel_l2(grads, off_grads), "tol": TRAIN_TOL}
    del model, grads, plain_grads, off_grads, batch
    torch.cuda.empty_cache()
    # step_grads runs the backward twice (the seg loss, then the rest)
    if launches != expected_launches(qkv_attention_fast_exp2=12, qkv_attention_bwd_fast_exp2=24):
        raise AssertionError(f"the training step under FAST_EXP2 took another route: {res}")
    if any(plain_launches.values()) or not res["loss_rel_diff_vs_plain"] <= TRAIN_TOL:
        raise AssertionError(f"the training step under FAST_EXP2 disagrees: {res}")
    return res


# (kernel, dtype, knob, b, n, heads, head_dim, valid_len, iters): the table's shapes
KNOB_FWD_CASES = [
    ("qkv", torch.bfloat16, "DENSECLIP_FAST_EXP2", 10, 1536, 12, 64, 1522, 20),  # slide window
    ("qkv", torch.bfloat16, "DENSECLIP_EXP_BF16", 10, 1536, 12, 64, 1522, 20),
    ("qkv", torch.bfloat16, "DENSECLIP_FAST_EXP2", 4, 777, 12, 64, None, 20),  # zero-pad max
    ("qkv", torch.float32, "DENSECLIP_FAST_EXP2", 10, 1536, 12, 64, 1522, 3),
    ("mha", torch.bfloat16, "DENSECLIP_FAST_EXP2", 2, 1024, 12, 64, None, 20),  # self-test's
    ("mha", torch.bfloat16, "DENSECLIP_EXP_BF16", 2, 1024, 12, 64, None, 20),
    ("mha", torch.float32, "DENSECLIP_FAST_EXP2", 2, 1024, 12, 64, None, 5),
]
KNOB_BWD_CASES = [  # (kernel, dtype, b, n, heads, head_dim, valid_len, iters)
    ("qkv", torch.bfloat16, 4, 1664, 12, 64, 1601, 10),  # crop-640 training
    ("qkv", torch.float32, 4, 1664, 12, 64, 1601, 2),
    ("mha", torch.bfloat16, 8, 1601, 12, 64, None, 5),  # profile_attn_bwd's (zero-pad max)
    ("mha", torch.float32, 8, 1601, 12, 64, None, 1),
]


def phase_knobs_path() -> dict:
    """The JAX package's softmax knobs through the port: every knob-reading
    kernel under each knob it reads, against its plain version in the same
    mode, at the table's shapes; the controls (K4, K4b, K5); then the
    flagship's full-width paths under each knob."""
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config

    res = {"phase": "knobs_path", "kernels": collections.defaultdict(list), "paths": {}}
    for case in KNOB_FWD_CASES:
        r = knob_forward_case(*case)
        res["kernels"][r["name"]].append(r)
        torch.cuda.empty_cache()
    for case in KNOB_BWD_CASES:
        r = knob_backward_case(*case)
        res["kernels"][r["name"]].append(r)
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        r = lnqkv_mode_case(dtype, "DENSECLIP_FAST_EXP2", 10, 1536, 768, 12, 1522,
                            10 if dtype == torch.bfloat16 else 2)
        res["kernels"][r["name"]].append(r)
        r = outproj_mode_case(dtype, "DENSECLIP_FAST_EXP2", 10, 1601, 12, 64, None,
                              10 if dtype == torch.bfloat16 else 2)
        res["kernels"][r["name"]].append(r)
        torch.cuda.empty_cache()
    res["controls"] = knob_controls()
    cfg = load_config(CONFIG)
    frame = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, 256, (1, 1024, 2048, 3), dtype=np.uint8)).cuda()
    paths = res["paths"]
    model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.bfloat16,
                                   device="cuda", seed=SEED)
    fast = "DENSECLIP_FAST_EXP2"
    paths["fast_exp2_slide"] = knob_frame(model, texts, frame, fast, False,
                                          {"qkv_attention_fast_exp2": 12}, PATH_TOL)
    paths["fast_exp2_fused"] = knob_frame(model, texts, frame, fast, True,
                                          {"ln_qkv_attention_fast_exp2": 12}, PATH_TOL)
    paths["exp_bf16_slide"] = knob_frame(model, texts, frame, "DENSECLIP_EXP_BF16", False,
                                         {"qkv_attention_exp_bf16": 12}, PATH_TOL)
    paths["fast_exp2_int8"] = knob_frame(model, texts, frame, fast, False,
                                         {"qkv_attention_int8": 12, "quantize_qkv_int8": 12},
                                         PATH_TOL, impl="int8")
    del model
    torch.cuda.empty_cache()
    model, texts = build_denseclip(load_config(CONFIG, overrides=[FP32_SET]).model,
                                   CITYSCAPES_CLASSES, dtype=torch.float32, device="cuda",
                                   seed=SEED)
    paths["fast_exp2_fp32_slide"] = knob_frame(model, texts, frame, fast, False,
                                               {"qkv_attention_fp32_fast_exp2": 12},
                                               FP32_PATH_TOL)
    del model
    torch.cuda.empty_cache()
    paths["fast_exp2_training"] = knob_training_step()
    for name, path in paths.items():
        emit({"phase": "knobs_path", "part": name, **path})
    res["launches_by_path"] = {f"knobs_{name}": path["launches"] for name, path in paths.items()}
    res["kernels"] = dict(res["kernels"])
    return res


def knob_fields(knobs_res: dict, name: str) -> dict:
    """The per-knob fields of kernel `name`'s entry in the kernels line: for
    each of its variants that knobs_path ran, the launches on each path, the
    times and the errors against the plain version under the knob."""
    out = {}
    for suffix in ("_fast_exp2", "_exp_bf16"):
        runs = knobs_res["kernels"].get(name + suffix)
        if not runs:
            continue
        first = runs[0]
        out[suffix.lstrip("_")] = {
            "name": name + suffix,
            "launches_by_path": {p: launches.get(name + suffix, 0) for p, launches
                                 in knobs_res["launches_by_path"].items()},
            "ms": first["ms"], "default_ms": first.get("default_ms"), "plain_ms": first["plain_ms"],
            "max_abs_err": first.get("max_abs_err"), "rel_l2_err": first.get("rel_l2_err"),
            "sees_the_knob": first["sees_the_knob"], "shape": first["shape"],
            "valid_len": first["valid_len"],
            "other_shapes": [{k: r.get(k) for k in ("shape", "valid_len", "ms", "default_ms",
                                                     "max_abs_err", "rel_l2_err")}
                             for r in runs[1:]]}
    return out


PROFILE_GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("attention under a softmax knob (K1 / K3 / K2)", ("_knob_kernel", "bwd_poly_")),
    ("fp32 projections (K6 / K7 fp32)", ("gemm_fp32_kernel",)),
    ("attention fp32 (K1 / K3 / K4 fp32)", ("attention_fp32_kernel",)),
    ("attention backward fp32 (K2 / K3's / K4b fp32)", ("bwd_fp32_",)),
    ("ln_qkv_attention (K6)", ("ln_qkv_",)),
    ("mha_attention (K3)", ("mha_attention_kernel",)),
    ("qkv_attention_bwd (K2; K3's backward)", ("qkv_bwd_",)),
    ("flash_attention_bwd (K4b)", ("flash_bwd_",)),
    ("qkv_out_attention (K7)", ("qkv_out_attention_kernel",)),
    ("qkv_attention_int8 (K5)", ("qkv_attention_int8_kernel",)),
    ("quantize_qkv_int8 (K5's prologue)", ("int8_prologue_",)),
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


DDP_WORK_DIR = "build/ddp_smoke"  # gitignored; removed at the end of the phase
DDP_TORCHRUN_STEPS = 4  # tools/dist_train.sh at world 1: 1 warm-up + 3 timed
DDP_BN_TOL = 1e-5  # relative L2 of every BatchNorm running statistic, 2 ranks vs 1 process
DDP_SEG_AGREE = 0.9999  # share of the sharded frame's pixels whose seg equals the unsharded
DDP_TIMEOUT_S = 300  # the ranks' whole run, the Gloo / NCCL rendezvous included
DDP_RN50_SETS = ["data.synthetic=true", "data.synthetic_options.image_size=[512,1024]",
                 "data.synthetic_options.length=16", FP32_SET]
DDP_EVAL_SETS = TRAIN_OVERRIDES[:2] + ["data.synthetic_options.length=4"]
# The fp32 step holds the backbone gradients of the segmentation loss, as
# fp32_path does: at a random init a fifth of the depth predictions sit at
# SILog's eps clamp, where fp32 rounding decides the gradient (PERF.md §6).
DDP_FP32_SETS = [FP32_SET, "training.loss_weights.silog=0.0"]


def _ddp_free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ddp_train_case(cfg, dtype, batch: dict, deterministic: bool, device: str,
                    built=None, backbone_parts: int = 1, probe: bool = False) -> dict:
    """One step of the port's train step on this rank's rows of the global
    `batch` (all of it without a group): the metrics, the flat backbone
    gradients the optimizer applies (after the all-reduce), every BatchNorm
    running statistic after the step, and the kernels' launches.  `built`:
    the (model, texts) of `cfg` at its seed, where the caller holds them.
    `backbone_parts` runs the backbone (no op of which mixes samples) over
    that many equal parts of the batch, as the ranks run it over theirs.
    `probe` keeps the gradients that reach the neck's output and the input
    of its fusion layer.  The optimizer's update is not applied: `built`
    weights stay the seeded ones (BatchNorm's running statistics move)."""
    from denseclip_vit_multimodal_tpu_torch.data.loader import to_device
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.parallel import mesh
    from denseclip_vit_multimodal_tpu_torch.train.loop import train_step_from_cfg
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state
    from denseclip_vit_multimodal_tpu_torch.train.step import microbatch_rows

    seed = int(cfg.training.get("seed", 42))
    model, texts = built or build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=dtype,
                                            device=device, seed=seed)
    state = create_train_state(model, cfg.training, 1)
    captured = {}

    def capture():  # the gradients the update would apply; no check needs the update
        captured["backbone"] = torch.cat([q.grad.float().flatten()
                                          for n, q in model.named_parameters()
                                          if n.startswith("backbone.") and q.grad is not None])

    state.optimizer.step = capture
    whole = model.backbone.forward
    if backbone_parts > 1:
        model.backbone.forward = lambda x, *a, **k: tuple(
            torch.cat(taps) for taps in zip(*(whole(c, *a, **k) for c in x.chunk(backbone_parts))))
    probes, hooks = {}, []
    if probe:
        def grad_of(name, t):
            t.register_hook(lambda g: probes.__setitem__(name, g.detach().float().cpu()))

        hooks = [model.neck.register_forward_hook(lambda m, a, out: grad_of("neck_out", out)),
                 model.neck.fuse.register_forward_pre_hook(lambda m, a: grad_of("fuse_in", a[0]))]
    step = train_step_from_cfg(texts, cfg.training, cfg.data, seed)
    world, rank = mesh.world_size(), mesh.rank()
    rows = microbatch_rows(batch["image"].shape[0] // world, 1, world, rank)[0]
    local = to_device({k: v[rows] for k, v in batch.items()}, device)
    guard = deterministic_algorithms() if deterministic else contextlib.nullcontext()
    with guard:
        reset_launches()
        metrics = step(state, local)
        if device != "cpu":
            torch.cuda.synchronize()
        launches = read_launches()
    for hook in hooks:
        hook.remove()
    model.backbone.forward = whole
    out = {"metrics": metrics, "launches": launches, "grads": captured["backbone"],
           "probes": {k: v / world for k, v in probes.items()},  # a rank's are world x its rows'
           "buffers": {n: b.clone() for n, b in model.named_buffers()
                       if n.endswith(("running_mean", "running_var"))}}
    del model, state, step, local
    torch.cuda.empty_cache()
    return out


def _ddp_work(inputs: dict) -> dict:
    """(2)'s work on this process: the heritage step in fp32 and in bf16,
    the RN50 step, a flagship slide frame (its windows spread over the group
    where there is one) and `tools/test.py` on 4 frames.  `inputs["sets"]` /
    `["rn50_sets"]` are extra config overrides (none on the card: full
    width) and `inputs["device"]` the device ("cuda" on the card)."""
    from denseclip_vit_multimodal_tpu_torch.core.config import load_config, resolve_test_protocol
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.infer.slide import slide_grid
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.parallel import mesh
    from denseclip_vit_multimodal_tpu_torch.tools import test as test_tool
    from denseclip_vit_multimodal_tpu_torch.train import loop, metrics  # noqa: F401  (before the spy)

    res, sets, device = {}, list(inputs["sets"]), inputs["device"]
    fp32_cfg = load_config(TRAIN_CONFIG, overrides=TRAIN_OVERRIDES + DDP_FP32_SETS + sets)
    built = build_denseclip(fp32_cfg.model, CITYSCAPES_CLASSES, dtype=torch.float32,
                            device=device, seed=int(fp32_cfg.training.get("seed", 42)))
    res["fp32"] = _ddp_train_case(fp32_cfg, torch.float32, inputs["heritage"], True, device,
                                  built=built, probe=True)
    if mesh.world_size() == 1:
        # the reference whose backbone runs over the ranks' halves: the cuBLAS
        # products of a part depend on its rows, and through the ReLU gates
        # of the neck a 1e-6 change in the forward moves the gradients 1e-3
        res["fp32_ranks_parts"] = _ddp_train_case(fp32_cfg, torch.float32, inputs["heritage"],
                                                  True, device, built=built,
                                                  backbone_parts=inputs["ranks"])
    del built
    res["rn50"] = _ddp_train_case(
        load_config(RN50_CONFIG, overrides=DDP_RN50_SETS + inputs["rn50_sets"]), torch.float32,
        inputs["rn50"], True, device)
    res["rn50"].pop("grads")

    # the heritage model is the flagship's (the presets' `model:` sections are
    # the same): its seeded weights slide the frame, then take the bf16 step
    heritage = load_config(TRAIN_CONFIG, overrides=TRAIN_OVERRIDES + sets)
    crop, stride, window_batch = resolve_test_protocol(load_config(CONFIG, overrides=sets))
    model, texts = build_denseclip(heritage.model, CITYSCAPES_CLASSES, dtype=torch.bfloat16,
                                   device=device, seed=int(heritage.training.get("seed", 42)))
    engine = Inferencer(model, texts, num_classes=19)
    frame = lambda chunk: engine.predict(inputs["frame"], mode="slide", crop=crop, stride=stride,
                                         window_batch=chunk, fetch="device",
                                         shard_windows=mesh.world_size() > 1)
    keep = lambda out: {"seg_logits": out["seg_logits"].float().cpu(),
                        "depth": out["depth"].float().cpu(), "seg": out["seg"].cpu()}
    reset_launches()
    res["slide"] = {**keep(frame(window_batch)), "launches": read_launches()}
    if mesh.world_size() == 1:
        # the windows in the chunks the ranks run (the cuBLAS products of a
        # chunk depend on its size; sharding must not change anything else)
        n_win = len(slide_grid(tuple(inputs["frame"].shape[1:3]), crop, stride))
        res["slide_ranks_chunks"] = keep(frame(-(-n_win // inputs["ranks"])))
    del engine
    res["bf16"] = _ddp_train_case(heritage, torch.bfloat16, inputs["heritage"], False, device,
                                  built=(model, texts))
    res["bf16"].pop("grads")
    del model
    torch.cuda.empty_cache()

    seen = []
    inner = metrics.miou_from_confusion
    metrics.miou_from_confusion = lambda cm, *a, **k: (seen.append(cm.cpu()), inner(cm, *a, **k))[1]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            results = test_tool.main([TRAIN_CONFIG, inputs["checkpoint"], "--device", device,
                                      "--set", *DDP_EVAL_SETS, *sets])
    finally:
        metrics.miou_from_confusion = inner
    res["eval"] = {"confusion": seen, "mIoU": results["mIoU"]}
    return res


def _ddp_rank(rank: int, world: int, port: int, backend: str, inputs_path: str,
              out_dir: str) -> None:
    """One rank of (2) (Gloo; the ranks go round the visible cards, so both
    share card 0 on a one-card machine) or (3) (NCCL, rank r on card r):
    joins the group as `torchrun`'s workers do (its environment, then
    `parallel/mesh.py::maybe_initialize_distributed`), runs `_ddp_work` (or,
    under NCCL, the fp32 step timed), and saves what rank 0 keeps and every
    rank's numbers."""
    from denseclip_vit_multimodal_tpu_torch.parallel import mesh

    out = os.path.join(out_dir, f"rank{rank}.pt")
    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_device sets the parent
    torch.backends.cudnn.allow_tf32 = False
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        if not mesh.maybe_initialize_distributed(backend, inputs["device"], DDP_TIMEOUT_S):
            raise AssertionError("the rank did not join its group")
        res = _ddp_work(inputs) if backend == "gloo" else _ddp_nccl_work(inputs)
        if rank:  # the other ranks keep their numbers; rank 0's tensors are compared
            for case in res.values():
                case.pop("probes", None)
                for key in ("grads", "buffers", "seg_logits", "depth", "seg"):
                    if key in case:
                        case[key] = _digest(case[key])
        torch.save(res, out)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _digest(x):
    """A rank's tensor (or dict of them) reduced to float64 sums, to show that
    every rank holds the same values without copying them all."""
    if isinstance(x, dict):
        return {k: _digest(v) for k, v in x.items()}
    return float(x.double().sum()), float(x.double().abs().sum())


def _ddp_spawn(world: int, backend: str, inputs_path: str, out_dir: str):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = _ddp_free_port()
    procs = [ctx.Process(target=_ddp_rank, args=(r, world, port, backend, inputs_path, out_dir),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DDP_TIMEOUT_S

    def join():
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = [open(os.path.join(out_dir, f"rank{i}.pt.err")).read() for i in range(world)
                  if os.path.exists(os.path.join(out_dir, f"rank{i}.pt.err"))]
        if errors or hung or any(p.exitcode for p in procs):
            raise AssertionError(f"{backend} ranks failed (hung: {hung}, exit codes "
                                 f"{[p.exitcode for p in procs]}):\n" + "\n".join(errors))
        return [torch.load(os.path.join(out_dir, f"rank{i}.pt"), weights_only=False)
                for i in range(world)]

    return join


def _ddp_nccl_work(inputs: dict) -> dict:
    """(3): the fp32 heritage step under NCCL, one card a rank: the step's
    numbers as in (2), 3 timed steps after it (CUDA events), and one more
    under torch.profiler for the all-reduce's share of the device time."""
    from torch.profiler import ProfilerActivity, profile

    from denseclip_vit_multimodal_tpu_torch.core.config import load_config
    from denseclip_vit_multimodal_tpu_torch.data.loader import to_device
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.parallel import mesh
    from denseclip_vit_multimodal_tpu_torch.train.loop import train_step_from_cfg
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state
    from denseclip_vit_multimodal_tpu_torch.train.step import microbatch_rows

    cfg = load_config(TRAIN_CONFIG, overrides=TRAIN_OVERRIDES + DDP_FP32_SETS)
    res = {"fp32": _ddp_train_case(cfg, torch.float32, inputs["heritage"], True, "cuda")}
    seed = int(cfg.training.get("seed", 42))
    model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, dtype=torch.float32,
                                   device="cuda", seed=seed)
    state = create_train_state(model, cfg.training, 1)
    step = train_step_from_cfg(texts, cfg.training, cfg.data, seed)
    rows = microbatch_rows(inputs["heritage"]["image"].shape[0] // mesh.world_size(), 1,
                           mesh.world_size(), mesh.rank())[0]
    local = to_device({k: v[rows] for k, v in inputs["heritage"].items()}, "cuda")
    step(state, local)  # warm-up
    torch.cuda.synchronize()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(3):
        step(state, local)
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, local)
        torch.cuda.synchronize()
    total = comm = 0.0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = evt.device_time if hasattr(evt, "device_time") else evt.cuda_time
            total += us
            if "nccl" in evt.name.lower():
                comm += us
    res["timing"] = {"ms_per_step": begin.elapsed_time(end) / 3, "device_ms_profiled": total / 1e3,
                     "all_reduce_ms": comm / 1e3, "all_reduce_share": comm / max(total, 1e-9),
                     "card": torch.cuda.get_device_name()}
    return res


def phase_ddp_path(device: str = "cuda", sets=(), rn50_sets=()) -> dict:
    """Data parallelism over a torch.distributed process group at full width:
    (1) NCCL at world 1 through `tools/dist_train.sh` (torchrun) beside the
    same run without a group, (2) two Gloo ranks (sharing this card on a
    one-card machine) against one process on the same global batch, (3) NCCL over two cards where two are
    visible.  `device="cpu"` with `sets` / `rn50_sets` that cut the widths
    rehearses the phase's control flow on a machine with no card (Gloo for
    (1) too; no kernel launches, so its checks are not met)."""
    import shutil

    from denseclip_vit_multimodal_tpu_torch.core.config import load_config
    from denseclip_vit_multimodal_tpu_torch.data.loader import DataLoader, build_dataset
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import save_checkpoint
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state

    shutil.rmtree(DDP_WORK_DIR, ignore_errors=True)
    os.makedirs(DDP_WORK_DIR)
    torch.cuda.empty_cache()
    res = {"phase": "ddp_path", "config": TRAIN_CONFIG, "rn50_config": RN50_CONFIG,
           "slide_config": CONFIG}

    # (1) tools/dist_train.sh at world 1 (NCCL) and tools/train.py without a
    # group, each a fresh process on the same command line
    sets = list(sets)

    def run(tag, launcher, env):
        tick, wd = time.perf_counter(), os.path.join(DDP_WORK_DIR, tag)
        proc = subprocess.run(
            launcher + [TRAIN_CONFIG, "--work-dir", wd, "--no-validate", "--max-steps",
                        str(DDP_TORCHRUN_STEPS), "--device", device, "--set", *TRAIN_OVERRIDES,
                        *sets], env=env, capture_output=True, text=True, timeout=DDP_TIMEOUT_S)
        if proc.returncode:
            raise AssertionError(f"{tag} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        with open(os.path.join(wd, "train_log.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        return {"wall_s": time.perf_counter() - tick, "loss_step1": rows[0]["loss_total"],
                "step_ms": [r["step_s"] * 1e3 for r in rows],
                "ms_per_step": float(np.median([r["step_s"] for r in rows[1:]])) * 1e3,
                "logs": sorted(f for f in os.listdir(wd) if f.endswith(".log"))}

    phase_tick = time.perf_counter()
    torchrun = run("torchrun", ["bash", "denseclip_vit_multimodal_tpu_torch/tools/dist_train.sh"],
                   {**os.environ, "NPROC": "1"})
    plain = run("no_group", [sys.executable, "-m", "denseclip_vit_multimodal_tpu_torch.tools.train"],
                {k: v for k, v in os.environ.items()
                 if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")})
    res["torchrun_world1"] = {"nccl": torchrun, "no_group": plain,
                              "step1_loss_bitwise_equal": torchrun["loss_step1"]
                              == plain["loss_step1"],
                              "ms_per_step_vs_no_group": torchrun["ms_per_step"]
                              / plain["ms_per_step"]}

    # (2) inputs of both sides: the global batches, a frame and a checkpoint
    def global_batch(cfg, n):
        loader = DataLoader(build_dataset(cfg.data, "train"), batch_size=n,
                            seed=int(cfg.training.get("seed", 42)), num_threads=4,
                            process_index=0, process_count=1)
        return next(loader.epoch(0))

    heritage = load_config(TRAIN_CONFIG, overrides=TRAIN_OVERRIDES + sets)
    eval_cfg = load_config(TRAIN_CONFIG, overrides=DDP_EVAL_SETS + sets)
    model, _ = build_denseclip(eval_cfg.model, CITYSCAPES_CLASSES, dtype=torch.bfloat16,
                               device=device, seed=SEED)
    ckpt = os.path.join(DDP_WORK_DIR, "eval")
    save_checkpoint(ckpt, create_train_state(model, eval_cfg.training, 1), 0)
    del model
    inputs = {"heritage": global_batch(heritage, 4),
              "rn50": global_batch(load_config(RN50_CONFIG,
                                               overrides=DDP_RN50_SETS + list(rn50_sets)), 16),
              "frame": np.random.RandomState(SEED).randint(0, 256, (1, 1024, 2048, 3),
                                                           dtype=np.uint8),
              "checkpoint": ckpt, "device": device, "sets": sets, "rn50_sets": list(rn50_sets),
              "ranks": 2}
    inputs_path = os.path.join(DDP_WORK_DIR, "inputs.pt")
    torch.save(inputs, inputs_path)
    tick = time.perf_counter()
    join = _ddp_spawn(2, "gloo", inputs_path, DDP_WORK_DIR)
    one = _ddp_work(inputs)  # the one-process reference, while the ranks run
    ranks = join()
    two, other = ranks
    gloo = {"wall_s": time.perf_counter() - tick,  # the ranks go round the visible cards
            "cards": min(2, torch.cuda.device_count()) if device != "cpu" else 0}
    for case in ("fp32", "bf16", "rn50"):
        loss_1, loss_2 = one[case]["metrics"]["loss_total"], two[case]["metrics"]["loss_total"]
        gloo[case] = {"loss_one_process": loss_1, "loss_two_ranks": loss_2,
                      "loss_rel_diff": abs(loss_2 - loss_1) / abs(loss_1),
                      "ranks_agree": two[case]["metrics"] == other[case]["metrics"],
                      "launches_per_rank": two[case]["launches"]}
    gloo["fp32"]["loss_one_process_ranks_parts"] = one["fp32_ranks_parts"]["metrics"]["loss_total"]
    gloo["fp32"]["backbone_grad_rel_l2"] = rel_l2(two["fp32"]["grads"],
                                                  one["fp32_ranks_parts"]["grads"])
    gloo["fp32"]["loss_rel_diff"] = abs(
        two["fp32"]["metrics"]["loss_total"] - one["fp32_ranks_parts"]["metrics"]["loss_total"]) \
        / abs(one["fp32_ranks_parts"]["metrics"]["loss_total"])
    rows = two["fp32"]["probes"]["neck_out"].shape[0]
    gloo["fp32"]["against_the_whole_batch_backbone"] = {
        "loss_rel_diff": abs(two["fp32"]["metrics"]["loss_total"]
                             - one["fp32"]["metrics"]["loss_total"])
        / abs(one["fp32"]["metrics"]["loss_total"]),
        "backbone_grad_rel_l2": rel_l2(two["fp32"]["grads"], one["fp32"]["grads"]),
        # the same gap without a group: one process, its backbone over halves
        "one_process_halves_backbone_grad_rel_l2": rel_l2(one["fp32_ranks_parts"]["grads"],
                                                          one["fp32"]["grads"]),
        **{f"{k}_grad_rel_l2": rel_l2(v, one["fp32"]["probes"][k][:rows])
           for k, v in two["fp32"]["probes"].items()}}
    gloo["fp32"]["ranks_same_grads"] = _digest(two["fp32"]["grads"]) == other["fp32"]["grads"]
    gloo["rn50"]["bn_stat_rel_l2_max"] = max(
        rel_l2(two["rn50"]["buffers"][k], v) for k, v in one["rn50"]["buffers"].items())
    gloo["rn50"]["ranks_same_bn_stats"] = _digest(two["rn50"]["buffers"]) \
        == other["rn50"]["buffers"]
    s1, s2, s1_protocol = one["slide_ranks_chunks"], two["slide"], one["slide"]
    gloo["slide"] = {"seg_rel_l2": rel_l2(s2["seg_logits"], s1["seg_logits"]),
                     "depth_rel_l2": rel_l2(s2["depth"], s1["depth"]),
                     "seg_equal_share": float((s2["seg"] == s1["seg"]).float().mean()),
                     "bitwise_equal": bool(torch.equal(s2["seg_logits"], s1["seg_logits"])),
                     "protocol_chunk_seg_rel_l2": rel_l2(s2["seg_logits"],
                                                         s1_protocol["seg_logits"]),
                     "protocol_chunk_seg_equal_share": float(
                         (s2["seg"] == s1_protocol["seg"]).float().mean()),
                     "one_process_chunks_5_vs_protocol_seg_equal_share": float(
                         (s1["seg"] == s1_protocol["seg"]).float().mean()),
                     "ranks_same_frame": _digest(s2["seg_logits"]) == other["slide"]["seg_logits"],
                     "k1_launches_one_process": s1_protocol["launches"]["qkv_attention"],
                     "k1_launches_per_rank": [s2["launches"]["qkv_attention"],
                                              other["slide"]["launches"]["qkv_attention"]]}
    cm1, cm2 = one["eval"]["confusion"][0], two["eval"]["confusion"][0]
    gloo["eval"] = {"confusion_equal": bool(torch.equal(cm1, cm2)),
                    "ranks_agree": two["eval"]["mIoU"] == other["eval"]["mIoU"],
                    "pixels": int(cm1.sum())}
    res["gloo_two_ranks"] = gloo
    res["seconds"] = {"torchrun_and_no_group": torchrun["wall_s"] + plain["wall_s"],
                      "inputs": tick - phase_tick - torchrun["wall_s"] - plain["wall_s"],
                      "two_ranks_and_one_process": gloo["wall_s"],
                      "total_so_far": time.perf_counter() - phase_tick}

    # (3) NCCL over two cards
    if device != "cpu" and torch.cuda.device_count() >= 2:
        nccl_dir = DDP_WORK_DIR + "_nccl"
        os.makedirs(nccl_dir, exist_ok=True)
        ranks = _ddp_spawn(2, "nccl", inputs_path, nccl_dir)()
        two = ranks[0]["fp32"]
        res["nccl_two_cards"] = {
            "loss_rel_diff": abs(two["metrics"]["loss_total"] - one["fp32"]["metrics"]["loss_total"])
            / abs(one["fp32"]["metrics"]["loss_total"]),
            "backbone_grad_rel_l2": rel_l2(two["grads"], one["fp32"]["grads"]),
            "timing_per_rank": [r["timing"] for r in ranks]}
        shutil.rmtree(nccl_dir, ignore_errors=True)
    else:
        res["nccl_two_cards"] = (f"not run: {torch.cuda.device_count()} card visible, and NCCL "
                                 "takes one card a rank")
        print("ddp_path (3): NCCL over two cards not run: this machine shows "
              f"{torch.cuda.device_count()} card, and NCCL cannot put two ranks on one card",
              flush=True)
    del one, ranks, two, other, inputs
    shutil.rmtree(DDP_WORK_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    emit(res)

    problems = []
    if not res["torchrun_world1"]["step1_loss_bitwise_equal"]:
        problems.append("(1) torchrun's step-1 loss is not the no-group run's")
    if "train_p0.log" in torchrun["logs"] or "train.log" not in torchrun["logs"]:
        problems.append("(1) a world of 1 logs to train.log")
    if not gloo["fp32"]["loss_rel_diff"] <= FP32_LOSS_TOL:
        problems.append("(2) fp32 step-1 loss")
    if not gloo["fp32"]["backbone_grad_rel_l2"] <= FP32_GRAD_TOL:
        problems.append("(2) fp32 backbone gradients")
    if not gloo["bf16"]["loss_rel_diff"] <= TRAIN_TOL:
        problems.append("(2) bf16 step-1 loss")
    if gloo["bf16"]["launches_per_rank"] != expected_launches(qkv_attention=12,
                                                              qkv_attention_bwd=12):
        problems.append("(2) a bf16 rank did not run 12 K1 + 12 K2")
    if not gloo["rn50"]["bn_stat_rel_l2_max"] <= DDP_BN_TOL:
        problems.append("(2) RN50 BatchNorm statistics")
    if not max(gloo["slide"]["seg_rel_l2"], gloo["slide"]["depth_rel_l2"]) <= PATH_TOL:
        problems.append("(2) sharded slide logits")
    if not gloo["slide"]["seg_equal_share"] >= DDP_SEG_AGREE:
        problems.append("(2) sharded slide seg")
    if gloo["slide"]["k1_launches_per_rank"] != [12, 12]:
        problems.append("(2) a rank of the sharded frame did not run its windows through K1")
    if not gloo["eval"]["confusion_equal"]:
        problems.append("(2) tools/test.py's confusion matrix")
    if not all(gloo[c]["ranks_agree"] for c in ("fp32", "bf16", "rn50", "eval")) or not (
            gloo["fp32"]["ranks_same_grads"] and gloo["rn50"]["ranks_same_bn_stats"]
            and gloo["slide"]["ranks_same_frame"]):
        problems.append("(2) the ranks disagree")
    if isinstance(res["nccl_two_cards"], dict) and not (
            res["nccl_two_cards"]["loss_rel_diff"] <= FP32_LOSS_TOL
            and res["nccl_two_cards"]["backbone_grad_rel_l2"] <= FP32_GRAD_TOL):
        problems.append("(3) the NCCL step")
    if problems:
        raise AssertionError(f"ddp_path: {problems}")
    return res


def phase_profile(run, frames, path: str = "slide_serving") -> dict:
    """Where the device time of one item of `path` goes (torch.profiler):
    `run` is called on each of `frames` (serving frames, training batches).
    Returns the line it prints."""
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
    res = {"phase": "profile", "path": path, "frames": len(frames),
          "wall_ms_per_frame": per_frame(wall_ms),
          "device_busy_ms_per_frame": per_frame(busy_ms), "device_busy_share": busy_ms / wall_ms,
          "groups_ms_per_frame": {g: per_frame(ms) for g, ms in
                                  sorted(by_group.items(), key=lambda kv: -kv[1])},
          "top_kernels": [{"name": name[:100], "ms_per_frame": per_frame(ms),
                           "calls_per_frame": calls[name] / len(frames),
                           "group": kernel_group(name)} for name, ms in top]}
    emit(res)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    seconds = {}

    def timed(name, fn, *args):
        tick = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = round(time.perf_counter() - tick, 1)

    smi = timed("device", phase_device)
    timed("build", phase_build)
    k1_cases = timed("kernel", phase_kernels)
    slide, k1_city, k1_ade, k1_ade_eval = k1_cases[0], k1_cases[-7], k1_cases[-6], k1_cases[-5]
    k1_vitl_train, k1_vitl, k1_vitl_ref, k1_flash = k1_cases[-4:]
    k2_cases = timed("kernel_bwd", phase_kernel_bwd)
    train_shape, k2_city, k2_ade, k2_vitl = k2_cases[0], k2_cases[-3], k2_cases[-2], k2_cases[-1]
    flashes = timed("kernel_flash", phase_kernel_flash)
    longest, flash_256 = flashes[2], flashes[-1]  # the aug-test scale 1.75 shape; head dim 256
    serving = timed("kernel_int8", phase_kernel_int8)[0]
    oneshot = timed("kernel_oneshot", phase_kernel_oneshot)[0]
    fused = timed("kernel_lnqkv", phase_kernel_lnqkv)[0]
    main_res = timed("main_path", phase_main_path)
    lnqkv_res = timed("lnqkv_path", phase_lnqkv_path, main_res["profile"])
    flash_res = timed("flash_path", phase_flash_path)
    export_res = timed("export_path", phase_export_path)
    train_res = timed("train_path", phase_train_path)
    eval_res = timed("eval_path", phase_eval_path)
    serve_res = timed("serve_path", phase_serve_path)
    selftest_res = timed("selftest", phase_selftest)
    oneshot_bwds = timed("kernel_oneshot_bwd", phase_kernel_oneshot_bwd)
    oneshot_bwd, oneshot_bwd_256 = oneshot_bwds[0], oneshot_bwds[-1]
    flash_bwds = timed("kernel_flash_bwd", phase_kernel_flash_bwd)
    flash_bwd, flash_bwd_256 = flash_bwds[0], flash_bwds[-1]
    long_res = timed("train_long", phase_train_long)
    fp32_res = timed("fp32_path", phase_fp32_path, long_res["remat_false"], selftest_res)
    outproj_res = timed("outproj_path", phase_outproj_path)
    knobs_res = timed("knobs_path", phase_knobs_path)
    pab_res = timed("profile_attn_bwd", phase_profile_attn_bwd)
    bench_res = timed("bench_path", phase_bench_path)
    import tempfile

    with tempfile.TemporaryDirectory(prefix="cityscapes_smoke_") as tmp:
        city_res = timed("cityscapes_path", phase_cityscapes_path, tmp)
        # The paths after it read the same arrays from filter-0 PNGs: Paeth's
        # GIL-bound unfilter (cityscapes_path's measurement) took most of their
        # time, and they measure the model paths (the cut that keeps the script
        # inside its time limit with ddp_path).
        from denseclip_vit_multimodal_tpu_torch.utils.png import encode_png

        timed("cityscapes_tree_filter0", write_cityscapes_tree, os.path.join(tmp, "cityscapes"),
              SEED, lambda arr: encode_png(arr, level=1))
        rn50_res = timed("rn50_path", phase_rn50_path, os.path.join(tmp, "cityscapes"))
        vitl_res = timed("vitl14_seg_path", phase_vitl14_seg_path, os.path.join(tmp, "cityscapes"))
    ade_res = timed("ade20k_path", phase_ade20k_path)
    ddp_res = timed("ddp_path", phase_ddp_path)
    emit({"phase_seconds": seconds, "total": round(sum(seconds.values()), 1)})
    by_path = lambda name: {"slide_serving": main_res["launches"][name],
                            "training": train_res["launches"][name],
                            "aug_test": eval_res["launches"][name],
                            "int8_http_serving": serve_res["launches"][name],
                            "fused_lnqkv_serving": lnqkv_res["launches"][name],
                            "selftest": selftest_res["launches"][name],
                            "training_long": long_res["remat_false"]["launches"][name],
                            "training_long_remat": long_res["remat_true"]["launches"][name],
                            "outproj_experiment": outproj_res["launches"][name],
                            "profile_attn_bwd": pab_res["launches"][name],
                            "bench": bench_res["launches"][name],
                            "cityscapes_training": city_res["training"]["launches"][name],
                            "cityscapes_eval": city_res["eval"]["launches"][name],
                            "rn50_path": rn50_res["launches"][name],
                            "ade20k_training": ade_res["vit_training"]["launches"][name],
                            "ade20k_eval": ade_res["vit_eval"]["launches"][name],
                            "ade20k_rn50_rn101": (ade_res["rn50"]["launches"][name]
                                                  + ade_res["rn50"]["eval_whole"]["launches"][name]
                                                  + ade_res["rn101"]["launches"][name]),
                            "flash": flash_res["launches"][name],
                            "ddp_training_per_rank": ddp_res["gloo_two_ranks"]["bf16"][
                                "launches_per_rank"][name],
                            **{f"exported_{tag}_frame": export_res[tag]["launches_per_frame"].get(
                                name, 0) for tag in ("logits", "int8", "fused")},
                            "serving_concurrency": export_res["launches"][name],
                            **{path: launches[name] for path, launches
                               in fp32_res["launches_by_path"].items()},
                            "outproj_fp32": outproj_res["fp32"]["launches"].get(name, 0),
                            **{path: launches.get(name, 0) for path, launches
                               in knobs_res["launches_by_path"].items()},
                            **{f"{tag}_{part}": sum(vitl_res[tag][k]["launches"][name] for k in ks)
                               for tag in ("vitl14", "seg_only")
                               for part, ks in (("training", ("training",)),
                                                ("eval", ("eval", "infer")))}}
    entry = lambda name, source, replaces, res, launches: {
        "name": name, "route": "cuda",
        "source": f"denseclip_vit_multimodal_tpu_torch/csrc/{source}",
        "replaces": replaces if replaces.startswith(("jax/", "tools/")) else
        f"denseclip_vit_multimodal_tpu/{replaces}",
        "launches": launches, "launches_by_path": by_path(name),
        "max_abs_err": res["max_abs_err"], "ms": res["ms"], "kernel_ms": res["ms"],
        "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
        "library_ms": res["library_ms"],
        **{k: res[k] for k in ("tflops_5_products", "tflops_7_products", "rerun_bitwise_equal",
                               "stats_m_max_abs_err", "stats_l_max_rel_err", "rel_l2_err",
                               "bound_3xtf32_ms", "bound_fp32_fma_ms", "tflops") if k in res},
    }
    at_shape = lambda res: {k: res[k] for k in (
        "shape", "valid_len", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "tflops", "tflops_5_products", "tflops_8_products", "rerun_bitwise_equal",
        "stats_m_max_abs_err", "stats_l_max_rel_err", "bound_3xtf32_ms", "bound_fp32_fma_ms")
        if k in res}
    emit({"kernels": [
        {**entry("qkv_attention", "qkv_attention.cu", "ops/mha_kernel.py:400", slide,
                 main_res["launches"]["qkv_attention"]),
         "cityscapes_training_shape": at_shape(k1_city),
         "ade20k_training_shape": at_shape(k1_ade), "ade20k_eval_shape": at_shape(k1_ade_eval),
         "vitl14_training_shape": at_shape(k1_vitl_train), "vitl14_eval_shape": at_shape(k1_vitl),
         "vitl14_reference_protocol_shape": at_shape(k1_vitl_ref),
         "flash_below_1024_shape": at_shape(k1_flash), **knob_fields(knobs_res, "qkv_attention")},
        {**entry("qkv_attention_bwd", "qkv_attention_bwd.cu", "ops/mha_kernel.py:240",
                 train_shape, train_res["launches"]["qkv_attention_bwd"]),
         "cityscapes_training_shape": at_shape(k2_city),
         "ade20k_training_shape": at_shape(k2_ade), "vitl14_training_shape": at_shape(k2_vitl),
         **knob_fields(knobs_res, "qkv_attention_bwd")},
        {**entry("flash_attention", "flash_attention.cu", "ops/attention.py:130", longest,
                 eval_res["launches"]["flash_attention"]),
         "design": "the forward core attention_fwd.cuh under BundledPolicy: TMA producer "
                   "warpgroup, wgmma consumer warpgroups",
         "head_dim_256": at_shape(flash_256)},
        {**entry("qkv_attention_int8", "qkv_attention_int8.cu", "ops/mha_kernel.py:586",
                 serving, serve_res["launches"]["qkv_attention_int8"]),
         "design": "int8 wgmma (m64n128k32 S, register-A P V) + TMA, two passes over K"},
        {**entry("quantize_qkv_int8", "quantize_qkv_int8.cu",
                 "ops/mha_kernel.py:655 (XLA work beside the kernel, not a Pallas kernel)",
                 serving["prologue"], serve_res["launches"]["quantize_qkv_int8"]),
         "bitwise_equal_to_plain": serving["prologue"]["bitwise_equal"],
         "design_bytes_ms": serving["prologue"]["design_bytes_ms"]},
        {**entry("mha_attention", "mha_attention.cu", "ops/mha_kernel.py:164", oneshot,
                 selftest_res["launches"]["mha_attention"]),
         **knob_fields(knobs_res, "mha_attention")},
        {**entry("ln_qkv_attention", "ln_qkv_attention.cu", "ops/lnqkv_kernel.py:81", fused,
                 lnqkv_res["launches"]["ln_qkv_attention"]),
         "design": "row statistics pass; TMA + wgmma m64n256k16 projection with the LayerNorm "
                   "as its A prologue; K1's body on the q/k/v workspace",
         "split": fused["split"], **knob_fields(knobs_res, "ln_qkv_attention")},
        {**entry("flash_attention_bwd", "flash_attention_bwd.cu",
                 "jax/experimental/pallas/ops/tpu/flash_attention.py:796 (dkv, call :1121) and "
                 ":1146 (dq, call :1456)", flash_bwd,
                 long_res["remat_false"]["launches"]["flash_attention_bwd"]),
         "head_dim_256": at_shape(flash_bwd_256)},
        {**entry("mha_attention_bwd", "qkv_attention_bwd.cu",
                 "ops/mha_kernel.py:240 (via :308, :359)", oneshot_bwd,
                 pab_res["launches"]["mha_attention_bwd"]),
         "head_dim_256": at_shape(oneshot_bwd_256), **knob_fields(knobs_res, "mha_attention_bwd")},
        {**entry("qkv_out_attention", "qkv_out_attention.cu", "tools/exp_outproj_epilogue.py:46",
                 outproj_res, outproj_res["launches"]["qkv_out_attention"]),
         "design": "attention on TMA + wgmma with every head's output kept in shared memory, "
                   "then the out-projection by wgmma m64n128k16 with W_out by TMA",
         **{k: outproj_res[k] for k in ("a_ms", "A_k1_ms", "A_matmul_ms", "A_cast_ms",
                                        "tflops_b", "verdict")},
         **knob_fields(knobs_res, "qkv_out_attention")},
        *fp32_entries(entry, at_shape, fp32_res, knobs_res),
        {**entry("qkv_out_attention_fp32", "qkv_out_attention_fp32.cu",
                 "tools/exp_outproj_epilogue.py:46", outproj_res["fp32"],
                 outproj_res["fp32"]["launches"]["qkv_out_attention_fp32"]),
         "design": "K1's fp32 body (3xTF32, attention_fp32.cuh) into an fp32 workspace, then "
                   "the 3xTF32 out-projection (gemm_fp32.cuh, W_out in a KN split plane)",
         "shape": outproj_res["fp32"]["shape"],
         "k1_matmul_ms": outproj_res["fp32"]["k1_matmul_ms"],
         **knob_fields(knobs_res, "qkv_out_attention_fp32")},
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
