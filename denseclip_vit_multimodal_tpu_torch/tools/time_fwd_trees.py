"""Time the attention forward kernels of several source trees in turns, on the card.

K1 (`csrc/qkv_attention.cu`), K3 (`csrc/mha_attention.cu`), K4
(`csrc/flash_attention.cu`) and the second stage of K6
(`csrc/ln_qkv_attention.cu`) call the forward core `csrc/attention_fwd.cuh`;
K5 (`csrc/qkv_attention_int8.cu`) is the int8 attention, and its prologue
(`csrc/quantize_qkv_int8.cu`) quantizes qkv and writes V's key-major copy.
This tool builds those sources of each tree it is given (a directory
holding them and their headers: this checkout's `csrc/` by default, or a
copy of another commit's) with the port's nvcc flags into
`build/fwd_trees/<name>/`, calls their plain C entry points, whose
signatures every tree must share, and:

  * holds each tree's output and row statistics (K6 writes none) against
    the port's plain versions (chip_smoke.py's limits), with NaN in the
    K / V rows past valid_len (K1, K3, K4), and says whether they equal the
    last tree's bit for bit;
  * times every tree at K1's slide shape [10,1536,2304] valid 1522, K3's
    [10,1536,12,64] valid 1522, K4's aug-test scale 1.75 [2,25216,12,64]
    valid 25089 and long training crop [2,9344,12,64] valid 9217 (views of
    one fused qkv), and K6's x [10,1536,768] valid 1522, by CUDA events over
    50 launches (10 for K4), in turns (the trees in order, then reversed,
    `--rounds` times), and reports each tree's median beside the bound and
    one library call (the yardstick: `scaled_dot_product_attention`; for K6
    layer_norm + linear + it);
  * where a tree exposes K6's stages (`ln_qkv_stats_bf16`,
    `ln_qkv_projection_bf16`, `ln_qkv_attention_stage2_bf16`), holds the
    q/k/v workspace of its first stage against
    `ln_qkv_projection_reference` (`workspace_errors`' limits) and its
    second stage's output bitwise against the whole kernel's, then times
    the statistics, the projection, the first stage and the second stage
    in turns, beside `F.linear` at the projection's shape and the
    projection's bound;
  * holds each tree's int8 prologue bitwise against the port's plain one
    on what K5 reads (q8's q and k thirds, V's key-major copy and the
    scales of `quantize_qkv_int8` + `value_key_major`), and its K5 on those
    operands against `int8_attention_plain`; then times K5 and the prologue
    of every tree in turns at the serving shape [10,1536,2304] valid 1522,
    beside their bounds;
  * holds each tree's K7 (`csrc/qkv_out_attention.cu`, attention with the
    out-projection fused) against `qkv_out_attention_reference`
    (chip_smoke.py's limits), then times it in turns at the experiment's
    shape qkv [10,1601,2304] + W_out [768,768], beside the yardstick A
    (this checkout's K1 + `torch.matmul` + the cast to fp32, timed in the
    same turns) and the bound.

With `--fp32` it times the fp32 kernels instead: K1, K3 and K4 in fp32
(`csrc/attention_fp32.cu`) and K2, K3's backward and K4b in fp32
(`csrc/attention_bwd_fp32.cu`), the three backwards fed by the last tree's
fp32 forward, each tree's output held against the plain versions (fp32
limits: outputs max abs 1e-4 and rel. L2 1e-5, gradients rel. L2 1e-4 and
max abs 1e-4 of the largest, masked keys exactly 0) and against the last
tree's bit for bit, then timed in turns at the fp32 paths' shapes (FP32_SHAPES)
beside SDPA in fp32 (its backward for the backwards), the bound at the fp32
FMA peak and the 3xTF32 ceiling, and the TFLOP/s; then each kernel's device
time by torch.profiler (a backward entry launches a dq and a dk/dv kernel).

    python -m denseclip_vit_multimodal_tpu_torch.tools.time_fwd_trees \\
        [--tree NAME=CSRC_DIR ...] [--rounds 3] [--fp32]

One JSON line per tree and shape, then a summary line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

SHAPES = {  # name: (batch, tokens, heads, head dim, valid_len); the prefix names the kernel
    "k1_slide": (10, 1536, 12, 64, 1522),
    "k3_slide": (10, 1536, 12, 64, 1522),
    "k4_aug_test_1.75": (2, 25216, 12, 64, 25089),
    "k4_long_crop": (2, 9344, 12, 64, 9217),
    "k6_slide": (10, 1536, 12, 64, 1522),
}
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12
LOG2E = 1.4426950408889634
MAX_TOL, MEAN_TOL, REL_TOL = 2e-2, 5e-4, 5e-3
ITERS = {"k1": 50, "k3": 50, "k4": 10, "k6": 50, "k5": 50, "k7": 20}  # launches per timing
INT8_SHAPE = (10, 1536, 12, 64, 1522)  # K5's serving shape: (batch, tokens, heads, head dim, valid)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
INT8_MAX_TOL, INT8_REL_TOL = 2e-2, 5e-3  # chip_smoke.py's K5 limits
LN_EPS = 1e-5
STATS_M_TOL, STATS_L_TOL = 5e-5, 3e-5
K7_SHAPE = (10, 1601, 12, 64)  # the experiment's: (batch, tokens, heads, head dim), every key valid
OUTPROJ_REL_TOL, OUTPROJ_MAX_TOL = 5e-3, 2e-2  # chip_smoke.py's K7 limits (max: of the largest)


def build_tree(name: str, csrc: Path, out_dir: Path) -> dict:
    """Compile `csrc`'s K1, K3, K4, K6, K5, K5's prologue and K7 sources;
    their entry points by kernel ("k6_stages": K6's stage entry points, None
    where the tree has none)."""
    from denseclip_vit_multimodal_tpu_torch.ops._build import NVCC_FLAGS, _nvcc
    from denseclip_vit_multimodal_tpu_torch.ops.lnqkv_kernel import bind_entry_points

    out_dir.mkdir(parents=True, exist_ok=True)
    ptr, i64, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    sources = ["qkv_attention", "mha_attention", "flash_attention", "ln_qkv_attention",
               "qkv_attention_int8", "quantize_qkv_int8", "qkv_out_attention"]
    procs = {src: subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(out_dir / f"lib{src}.so"),
                                    str(csrc / f"{src}.cu")],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src in sources}
    for src, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for tree {name}, {src}:\n{log}")
        ptxas = [ln.strip() for ln in log.splitlines()
                 if any(key in ln for key in ("Compiling entry", "registers", "spill",
                                              "Performance", "warning"))]
        print(json.dumps({"tree": name, "build": src, "ptxas": ptxas}), flush=True)
    lib = lambda src: ctypes.CDLL(str(out_dir / f"lib{src}.so"))
    k1 = lib("qkv_attention").qkv_attention_bf16
    k1.argtypes = [ptr] * 3 + [i] * 5 + [f, ptr]
    k3 = lib("mha_attention").mha_attention_bf16
    k3.argtypes = [ptr] * 5 + [i64] * 9 + [i] * 5 + [f, ptr]
    k4 = lib("flash_attention").flash_attention_bf16
    k4.argtypes = [ptr] * 5 + [i64] * 9 + [i] * 6 + [f, ptr]
    lib6 = lib("ln_qkv_attention")
    k6 = lib6.ln_qkv_attention_bf16
    k6.argtypes = [ptr] * 7 + [i] * 6 + [f, f, ptr]
    try:
        k6_stages = bind_entry_points(lib6)
    except AttributeError:  # a tree from before K6's stage entry points
        k6_stages = None
    k5 = lib("qkv_attention_int8").qkv_attention_int8
    k5.argtypes = [ptr] * 4 + [i] * 7 + [f, ptr]
    prologue = lib("quantize_qkv_int8").quantize_qkv_int8
    prologue.argtypes = [ptr, i] + [ptr] * 4 + [i] * 6 + [ptr]
    k7 = lib("qkv_out_attention").qkv_out_attention_bf16
    k7.argtypes = [ptr] * 3 + [i] * 5 + [f, ptr]
    for fn in (k1, k3, k4, k6, k5, prologue, k7):
        fn.restype = ctypes.c_int
    return {"k1": k1, "k3": k3, "k4": k4, "k6": k6, "k5": k5, "prologue": prologue,
            "k6_stages": k6_stages, "k7": k7}


def plain_stats(q, k, kv: int, scale: float, prescaled: bool = True,
                causal: bool = False) -> torch.Tensor:
    """Each row's max of the logits (log2 units) and sum of exp2(s - max)
    over the first kv keys (causal: those up to the row): [B, H, N, 2] fp32.
    The logits of K1 / K3 (`prescaled`): bf16(q * scale * log2 e) k^T; of
    K4: (q k^T * scale) * log2 e in fp32."""
    b, n, heads, _ = q.shape
    stats = torch.empty(b, heads, n, 2, device=q.device)
    qs = (q.float() * (scale * LOG2E)).to(q.dtype) if prescaled else q
    for h in range(heads):
        s = qs[:, :, h].float() @ k[:, :kv, h].float().transpose(-1, -2)
        if not prescaled:
            s = s * scale * LOG2E
        if causal:
            rows = torch.arange(n, device=q.device)[:, None]
            s = s.masked_fill(torch.arange(kv, device=q.device)[None, :] > rows, float("-inf"))
        m = s.amax(-1)
        stats[:, h, :, 0] = m
        stats[:, h, :, 1] = torch.exp2(s - m[..., None]).sum(-1)
    return stats


def _cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of `fn` over `iters` calls after one, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_int8(fns: dict, rounds: int) -> dict:
    """K5 and its prologue of every tree at INT8_SHAPE: checks, then times in
    turns; the summary entries "k5_slide" and "k5_prologue_slide"."""
    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
        int8_attention_plain,
        quantize_qkv_int8,
        value_key_major,
    )

    b, n, heads, d, kv = INT8_SHAPE
    hd, scale, ldv = heads * d, d**-0.5, -(-n // 16) * 16
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    bufs = {}  # each tree's last (q8, vt, scales)
    out = torch.empty(b, n, hd, dtype=torch.bfloat16, device="cuda")

    def prologue(name):
        """What the tree's `_int8_forward` runs before K5, allocations included."""
        amax = torch.zeros(b, 3, heads, dtype=torch.int32, device="cuda")
        q8 = torch.empty(b, n, 3 * hd, dtype=torch.int8, device="cuda")
        vt = torch.empty(b, heads, d, ldv, dtype=torch.int8, device="cuda")
        scales = torch.empty(b, 3, heads, device="cuda")
        err = fns[name]["prologue"](qkv.data_ptr(), 1, amax.data_ptr(), q8.data_ptr(),
                                    vt.data_ptr(), scales.data_ptr(), b, n, heads, d, kv, ldv,
                                    stream)
        if err != 0:
            raise RuntimeError(f"prologue launch failed: cudaError {err}")
        bufs[name] = q8, vt, scales

    def k5(name):
        q8, vt, scales = bufs[name]
        err = fns[name]["k5"](q8.data_ptr(), vt.data_ptr(), scales.data_ptr(), out.data_ptr(), 1,
                              b, n, heads, d, kv, ldv, scale, stream)
        if err != 0:
            raise RuntimeError(f"K5 launch failed: cudaError {err}")

    want_q8, want_scales = quantize_qkv_int8(qkv, heads, kv)
    want = int8_attention_plain(want_q8, want_scales, heads, scale, kv, torch.bfloat16)
    results, outs = {}, {}
    for name, fn in fns.items():
        prologue(name)
        q8, vt, scales = bufs[name]
        want_vt = value_key_major(want_q8, heads)
        out.fill_(float("nan"))
        k5(name)
        torch.cuda.synchronize()
        outs[name] = out.clone()
        err = out[:, :kv].float() - want[:, :kv].float()
        res = {"tree": name, "shape": "k5_slide", "max_abs_err": float(err.abs().max()),
               "rel_l2_err": float(err.norm() / want[:, :kv].float().norm()),
               "prologue_bitwise_equal": bool(
                   torch.equal(q8[..., :2 * hd], want_q8[..., :2 * hd])
                   and torch.equal(vt, want_vt) and torch.equal(scales, want_scales)),
               "ms": [], "prologue_ms": []}
        res["ok"] = bool(torch.isfinite(out.float()).all() and res["prologue_bitwise_equal"]
                         and res["max_abs_err"] <= INT8_MAX_TOL
                         and res["rel_l2_err"] <= INT8_REL_TOL)
        results[name] = res
    last = list(fns)[-1]
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            results[name]["ms"].append(_cuda_ms(lambda: k5(name), ITERS["k5"]))
            results[name]["prologue_ms"].append(_cuda_ms(lambda: prologue(name), ITERS["k5"]))
    ops = 4.0 * b * heads * n * kv * d
    # K5 reads q8's q and k thirds, V's copy and the scales, and writes bf16 out
    vt_bytes, scale_bytes = b * heads * d * ldv, 4.0 * b * 3 * heads
    nbytes = 2.0 * b * n * hd + vt_bytes + scale_bytes + 2.0 * b * n * hd
    # the prologue's function reads bf16 qkv once and writes q8's q and k
    # thirds, V's copy and the scales; the two-pass design reads qkv twice
    prologue_bytes = 2.0 * b * n * 3 * hd + 2.0 * b * n * hd + vt_bytes + scale_bytes
    design_bytes = prologue_bytes + 2.0 * b * n * 3 * hd
    for name, res in results.items():
        res.update(bitwise_equal_to_last=torch.equal(outs[name], outs[last]),
                   median_ms=statistics.median(res["ms"]),
                   prologue_median_ms=statistics.median(res["prologue_ms"]),
                   bound_ms=max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3,
                   prologue_bound_ms=prologue_bytes / PEAK_BYTES * 1e3,
                   prologue_design_bytes_ms=design_bytes / PEAK_BYTES * 1e3)
        res["tops"] = ops / (res["median_ms"] * 1e-3) / 1e12
        print(json.dumps(res), flush=True)
    return {
        "k5_slide": {**{name: res["median_ms"] for name, res in results.items()},
                     "bitwise_equal": all(r["bitwise_equal_to_last"] for r in results.values()),
                     "ok": all(r["ok"] for r in results.values())},
        "k5_prologue_slide": {**{name: res["prologue_median_ms"] for name, res in results.items()},
                              "ok": all(r["prologue_bitwise_equal"] for r in results.values())},
    }


def time_k7(fns: dict, rounds: int) -> dict:
    """K7 of every tree at K7_SHAPE: checks, then times in turns with the
    yardstick A (this checkout's K1 + matmul + cast) in each turn; the
    summary entry "k7_experiment"."""
    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import mha_qkv_attention
    from denseclip_vit_multimodal_tpu_torch.tools.exp_outproj_epilogue import (
        qkv_out_attention_reference,
    )

    b, n, heads, d = K7_SHAPE
    hd = heads * d
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(hd, hd, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    out = torch.empty(b, n, hd, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def k7(name):
        err = fns[name]["k7"](qkv.data_ptr(), w.data_ptr(), out.data_ptr(), b, n, heads, d, n,
                              d**-0.5 * LOG2E, stream)
        if err != 0:
            raise RuntimeError(f"K7 launch failed: cudaError {err}")

    a_fn = lambda: torch.matmul(mha_qkv_attention(qkv, heads), w).float()
    want = qkv_out_attention_reference(qkv, w, heads)
    results, outs = {}, {}
    for name in fns:
        out.fill_(float("nan"))
        k7(name)
        torch.cuda.synchronize()
        outs[name] = out.clone()
        err = out - want
        res = {"tree": name, "shape": "k7_experiment",
               "rel_l2_err": float(err.norm() / want.norm()),
               "max_abs_err": float(err.abs().max()), "max_abs_ref": float(want.abs().max()),
               "ms": [], "a_ms": []}
        res["ok"] = bool(torch.isfinite(out).all() and res["rel_l2_err"] <= OUTPROJ_REL_TOL
                         and res["max_abs_err"] <= OUTPROJ_MAX_TOL * res["max_abs_ref"])
        results[name] = res
    last = list(fns)[-1]
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            results[name]["ms"].append(_cuda_ms(lambda: k7(name), ITERS["k7"]))
            results[name]["a_ms"].append(_cuda_ms(a_fn, ITERS["k7"]))
    flops = 4.0 * b * heads * n * n * d + 2.0 * b * n * hd * hd
    nbytes = 2.0 * (qkv.numel() + w.numel()) + 4.0 * b * n * hd
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    for name, res in results.items():
        res.update(bitwise_equal_to_last=torch.equal(outs[name], outs[last]),
                   median_ms=statistics.median(res["ms"]),
                   a_median_ms=statistics.median(res["a_ms"]), bound_ms=bound_ms)
        res["tflops"] = flops / (res["median_ms"] * 1e-3) / 1e12
        print(json.dumps(res), flush=True)
    return {"k7_experiment": {
        **{name: res["median_ms"] for name, res in results.items()},
        "A": statistics.median([ms for res in results.values() for ms in res["a_ms"]]),
        "bound": bound_ms,
        "bitwise_equal": all(r["bitwise_equal_to_last"] for r in results.values()),
        "ok": all(r["ok"] for r in results.values())}}


def time_k6_split(fns: dict, operands, heads: int, kv: int, k6_outs: dict, rounds: int) -> dict:
    """K6's stages in every tree that exposes them, on the operands of the
    "k6_slide" shape: checks, then times in turns; the summary entry
    "k6_split" (empty without such a tree)."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops.lnqkv_kernel import workspace_errors

    staged = {name: fn["k6_stages"] for name, fn in fns.items() if fn["k6_stages"] is not None}
    if not staged:
        return {}
    x, gamma, beta, wt, bias = operands
    b, n, dim = x.shape
    hd = wt.shape[0] // 3
    d, rows = hd // heads, b * n
    stats = torch.empty(rows, 2, device="cuda")
    ws = torch.empty(b, n, 3 * hd, dtype=torch.bfloat16, device="cuda")
    out = torch.empty(b, n, hd, dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def check(err):
        if err != 0:
            raise RuntimeError(f"K6 stage launch failed: cudaError {err}")

    run_stats = lambda st: check(st["stats"](x.data_ptr(), stats.data_ptr(), rows, dim, LN_EPS,
                                             stream))
    run_projection = lambda st: check(st["projection"](
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wt.data_ptr(), bias.data_ptr(),
        stats.data_ptr(), ws.data_ptr(), rows, dim, hd, d**-0.5 * LOG2E, stream))
    run_stage2 = lambda st: check(st["stage2"](ws.data_ptr(), out.data_ptr(), b, n, heads, d, kv,
                                               stream))
    parts = {
        "stats_ms": run_stats,
        "projection_ms": run_projection,
        "first_stage_ms": lambda st: (run_stats(st), run_projection(st)),
        "stage2_ms": run_stage2,
    }
    results = {}
    for name, st in staged.items():
        ws.fill_(float("nan"))
        run_stats(st)
        run_projection(st)
        run_stage2(st)
        torch.cuda.synchronize()
        errs = workspace_errors(ws, x, gamma, beta, wt.t(), bias, heads)
        res = {"tree": name, "shape": "k6_split",
               "workspace": errs,
               "workspace_in_limits": errs["max_share_of_limit"] <= 1.0,
               "stage2_bitwise_equal_to_k6": torch.equal(out, k6_outs[name]),
               **{part: [] for part in parts}}
        res["ok"] = res["workspace_in_limits"] and res["stage2_bitwise_equal_to_k6"]
        results[name] = res
    for r in range(rounds):
        for name in (list(staged) if r % 2 == 0 else list(staged)[::-1]):
            for part, fn in parts.items():
                results[name][part].append(_cuda_ms(lambda: fn(staged[name]), ITERS["k6"]))
    bias16 = bias.to(torch.bfloat16)
    linear_ms = _cuda_ms(lambda: F.linear(x, wt, bias16), ITERS["k6"])
    proj_flops = 2.0 * rows * dim * 3 * hd
    summary = {"ok": all(res["ok"] for res in results.values()), "linear_ms": linear_ms,
               "projection_bound_ms": proj_flops / PEAK_BF16_FLOPS * 1e3,
               # the statistics read x and write (mean, rstd) per row
               "stats_bound_ms": (2.0 * rows * dim + 8.0 * rows) / PEAK_BYTES * 1e3}
    for name, res in results.items():
        for part in parts:
            res[part.replace("_ms", "_median_ms")] = statistics.median(res[part])
        res.update({k: v for k, v in summary.items() if k != "ok"})
        res["projection_tflops"] = proj_flops / (res["projection_median_ms"] * 1e-3) / 1e12
        print(json.dumps(res), flush=True)
        summary[name] = {part: res[part.replace("_ms", "_median_ms")] for part in parts}
    return {"k6_split": summary}


# fp32: (batch, tokens, heads, head dim, valid_len, causal); the prefix names the kernel
FP32_SHAPES = {
    "k1f32_crop640": (4, 1664, 12, 64, 1601, False),
    "k3f32_profile": (8, 1601, 12, 64, 1601, False),
    "k4f32_long_crop": (2, 9344, 12, 64, 9217, False),
    "k2f32_crop640": (4, 1664, 12, 64, 1601, False),
    "k3bwdf32_profile": (8, 1601, 12, 64, 1601, False),
    "k3bwdf32_d128": (2, 1100, 8, 128, 1050, False),
    "k3bwdf32_d256": (1, 1030, 2, 256, 1025, False),
    "k4bf32_long_crop": (2, 9344, 12, 64, 9217, False),
    "k4bf32_causal": (1, 2048, 4, 64, 2000, True),
    "k4bf32_d256": (1, 1100, 2, 256, 1050, True),
}
FP32_ITERS = {"k1f32": 20, "k3f32": 20, "k4f32": 3, "k2f32": 10, "k3bwdf32": 10, "k4bf32": 3}
PEAK_FP32_FLOPS = 66.9e12  # H100 SXM fp32 FMA rate outside the tensor cores
PEAK_3XTF32_FLOPS = 495e12 / 3  # three TF32 products per fp32 one
FP32_MAX_TOL, FP32_REL_TOL = 1e-4, 1e-5
FP32_BWD_REL_TOL, FP32_BWD_MAX_TOL = 1e-4, 1e-4


def build_fp32_tree(name: str, csrc: Path, out_dir: Path) -> dict:
    """Compile `csrc`'s fp32 forward and backward sources; their six entry
    points by name."""
    from denseclip_vit_multimodal_tpu_torch.ops._build import NVCC_FLAGS, _nvcc

    out_dir.mkdir(parents=True, exist_ok=True)
    ptr, i64, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    sources = ["attention_fp32", "attention_bwd_fp32"]
    procs = {src: subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(out_dir / f"lib{src}.so"),
                                    str(csrc / f"{src}.cu")],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src in sources}
    for src, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for tree {name}, {src}:\n{log}")
        ptxas = [ln.strip() for ln in log.splitlines()
                 if any(key in ln for key in ("Compiling entry", "registers", "spill",
                                              "Performance", "warning"))]
        print(json.dumps({"tree": name, "build": src, "ptxas": ptxas}), flush=True)
    fwd = ctypes.CDLL(str(out_dir / "libattention_fp32.so"))
    bwd = ctypes.CDLL(str(out_dir / "libattention_bwd_fp32.so"))
    table = {
        "qkv": (fwd.qkv_attention_fp32, [ptr] * 3 + [i] * 5 + [f, ptr]),
        "mha": (fwd.mha_attention_fp32, [ptr] * 5 + [i64] * 9 + [i] * 5 + [f, ptr]),
        "flash": (fwd.flash_attention_fp32, [ptr] * 5 + [i64] * 9 + [i] * 6 + [f, ptr]),
        "qkv_bwd": (bwd.qkv_attention_bwd_fp32, [ptr] * 6 + [i] * 5 + [f, f, ptr]),
        "mha_bwd": (bwd.mha_attention_bwd_fp32, [ptr] * 10 + [i64] * 9 + [i] * 5 + [f, f, ptr]),
        "flash_bwd": (bwd.flash_attention_bwd_fp32, [ptr] * 9 + [i64] * 9 + [i] * 6 + [f, ptr]),
    }
    for fn, argtypes in table.values():
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return {key: fn for key, (fn, _) in table.items()}


def _check(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError {err}")


def _kernel_ms(fn, iters: int) -> dict:
    """Device milliseconds per call of each kernel `fn` launches, by
    torch.profiler over `iters` calls after one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us > 0:
            out[ev.key[:80]] = us / iters / 1e3
    return out


def time_fp32(fns: dict, rounds: int) -> dict:
    """The fp32 kernels of every tree at FP32_SHAPES: checks, then times in
    turns, then each kernel's device time by torch.profiler (the backwards
    launch two); a summary entry per shape."""
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops import attention, mha_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stream = torch.cuda.current_stream().cuda_stream
    last = list(fns)[-1]
    summary = {}
    for shape, (b, n, heads, d, kv, causal) in FP32_SHAPES.items():
        kernel = shape.split("_")[0]
        backward = kernel in ("k2f32", "k3bwdf32", "k4bf32")
        entry = {"k1f32": "qkv", "k2f32": "qkv", "k3f32": "mha", "k3bwdf32": "mha",
                 "k4f32": "flash", "k4bf32": "flash"}[kernel]
        hd, scale = heads * d, d**-0.5
        gen = torch.Generator(device="cuda").manual_seed(0)
        qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda")
        q, k, v = (t.view(b, n, heads, d) for t in qkv.split(hd, dim=-1))
        dout = torch.randn(b, n, heads, d, generator=gen, device="cuda")
        strides = [st for t in (q, k, v) for st in t.stride()[:3]]
        out = torch.empty(b, n, heads, d, device="cuda")
        stats = torch.empty(b, heads, n, 2, device="cuda")
        rows = kv if entry == "flash" else n  # the bundled numerics' work: the valid rows

        def forward(fn, st=None):
            st = None if st is None else st.data_ptr()
            if entry == "qkv":
                _check(fn["qkv"](qkv.data_ptr(), out.data_ptr(), st, b, n, heads, d, kv,
                                 scale * LOG2E, stream))
            elif entry == "mha":
                _check(fn["mha"](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), st,
                                 *strides, b, n, heads, d, kv, scale * LOG2E, stream))
            else:
                _check(fn["flash"](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), st,
                                   *strides, b, n, heads, d, kv, int(causal), scale, stream))

        results, outs = {}, {}
        if backward:
            forward(fns[last], stats)  # the backwards' operands: the last tree's forward
            fwd_out = out.clone()
            grads = [torch.empty(b, n, heads, d, device="cuda") for _ in range(3)]
            dqkv = torch.empty(b, n, 3 * hd, device="cuda")
            coef = (fwd_out * dout).sum(-1).transpose(1, 2).contiguous() if entry == "flash" \
                else torch.empty(b, heads, n, device="cuda")
            dout2 = dout.reshape(b, n, hd)

            def call(fn):
                if entry == "qkv":
                    _check(fn["qkv_bwd"](qkv.data_ptr(), fwd_out.data_ptr(), dout2.data_ptr(),
                                         stats.data_ptr(), coef.data_ptr(), dqkv.data_ptr(), b,
                                         n, heads, d, kv, scale * LOG2E, scale, stream))
                elif entry == "mha":
                    _check(fn["mha_bwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         fwd_out.data_ptr(), dout.data_ptr(), stats.data_ptr(),
                                         coef.data_ptr(), *(g.data_ptr() for g in grads),
                                         *strides, b, n, heads, d, kv, scale * LOG2E, scale,
                                         stream))
                else:
                    _check(fn["flash_bwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           dout.data_ptr(), stats.data_ptr(), coef.data_ptr(),
                                           *(g.data_ptr() for g in grads), *strides, b, n, heads,
                                           d, kv, int(causal), scale, stream))

            def got():
                if entry == "qkv":
                    return [t.view(b, n, heads, d) for t in dqkv.split(hd, dim=-1)]
                return grads

            if entry == "flash":
                want = attention.flash_attention_bwd_reference(q, k, v, fwd_out, dout,
                                                               causal=causal, valid_len=kv)
            elif entry == "mha":
                want = mha_kernel.mha_attention_bwd_reference(q, k, v, fwd_out, dout,
                                                              valid_len=kv)
            else:
                want = [t.view(b, n, heads, d) for t in mha_kernel.mha_qkv_attention_bwd_reference(
                    qkv, fwd_out.view(b, n, hd), dout2, heads, valid_len=kv).split(hd, dim=-1)]
            for name, fn in fns.items():
                for t in (dqkv, *grads):
                    t.fill_(float("nan"))
                call(fn)
                torch.cuda.synchronize()
                outs[name] = [g.clone() for g in got()]
                res = {"tree": name, "shape": shape, "ms": []}
                ok = True
                for g_name, g, w, lim in zip(("dq", "dk", "dv"), outs[name], want,
                                             (rows, kv, kv)):
                    e, w = g[:, :lim] - w[:, :lim], w[:, :lim]
                    res[g_name] = {"rel_l2_err": float(e.norm() / w.norm()),
                                   "max_abs_err": float(e.abs().max()),
                                   "max_abs_ref": float(w.abs().max())}
                    ok = ok and bool(torch.isfinite(g[:, :lim]).all()) and (
                        res[g_name]["rel_l2_err"] <= FP32_BWD_REL_TOL
                        and res[g_name]["max_abs_err"] <= FP32_BWD_MAX_TOL
                        * res[g_name]["max_abs_ref"])
                res["masked_dkdv_exact_zero"] = bool((outs[name][1][:, kv:] == 0).all()
                                                     and (outs[name][2][:, kv:] == 0).all())
                res["ok"] = ok and res["masked_dkdv_exact_zero"]
                results[name] = res
            del want
            lib = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
            lib[1], lib[2] = lib[1][:, :, :kv].contiguous(), lib[2][:, :, :kv].contiguous()
            lib = [t.requires_grad_(True) for t in lib]
            lib_out = F.scaled_dot_product_attention(*lib, is_causal=causal)
            lib_grad = dout.transpose(1, 2).contiguous()
            library = lambda: torch.autograd.grad(lib_out, lib, lib_grad, retain_graph=True)
            flops = 10.0 * b * heads * rows * kv * d * (0.5 if causal else 1.0)
            nbytes = 4.0 * 8 * b * n * hd + 4.0 * stats.numel()
        else:
            if entry == "flash":
                plain_out = attention.flash_attention_reference(q, k, v, causal=causal,
                                                                valid_len=kv)
            elif entry == "mha":
                plain_out = mha_kernel.mha_attention_reference(q, k, v, valid_len=kv)
            else:
                plain_out = mha_kernel.mha_qkv_attention_reference(qkv, heads, valid_len=kv).view(
                    b, n, heads, d)
            call = lambda fn: forward(fn)
            for name, fn in fns.items():
                out.fill_(float("nan"))
                forward(fn, stats)
                torch.cuda.synchronize()
                outs[name] = [out.clone(), stats.clone()]
                e = out[:, :kv] - plain_out[:, :kv]
                res = {"tree": name, "shape": shape, "ms": [],
                       "max_abs_err": float(e.abs().max()),
                       "rel_l2_err": float(e.norm() / plain_out[:, :kv].norm())}
                res["ok"] = bool(torch.isfinite(out[:, :kv]).all()
                                 and res["max_abs_err"] <= FP32_MAX_TOL
                                 and res["rel_l2_err"] <= FP32_REL_TOL)
                results[name] = res
            qh = q.transpose(1, 2).contiguous()
            kh, vh = (t[:, :kv].transpose(1, 2).contiguous() for t in (k, v))
            library = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
            flops = 4.0 * b * heads * rows * kv * d * (0.5 if causal else 1.0)
            nbytes = 4.0 * (qkv.numel() + b * n * hd)
        for r in range(rounds):
            for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                results[name]["ms"].append(_cuda_ms(lambda: call(fns[name]), FP32_ITERS[kernel]))
        for name in fns:
            results[name]["kernel_ms"] = _kernel_ms(lambda: call(fns[name]), FP32_ITERS[kernel])
        library_ms = _cuda_ms(library, FP32_ITERS[kernel])
        bytes_s = nbytes / PEAK_BYTES
        bounds = {"bound_fp32_fma_ms": max(flops / PEAK_FP32_FLOPS, bytes_s) * 1e3,
                  "bound_3xtf32_ms": max(flops / PEAK_3XTF32_FLOPS, bytes_s) * 1e3}
        for name, res in results.items():
            res.update(bitwise_equal_to_last=all(torch.equal(x, y) for x, y in
                                                 zip(outs[name], outs[last])),
                       median_ms=statistics.median(res["ms"]), library_ms=library_ms, **bounds)
            res["tflops"] = flops / (res["median_ms"] * 1e-3) / 1e12
            if backward:
                res["tflops_7_products"] = res["tflops"] * 7 / 5
            print(json.dumps(res), flush=True)
        summary[shape] = {name: res["median_ms"] for name, res in results.items()}
        summary[shape].update(library=library_ms, **bounds,
                              bitwise_equal=all(r["bitwise_equal_to_last"]
                                                for r in results.values()),
                              ok=all(r["ok"] for r in results.values()))
        del results, outs
        torch.cuda.empty_cache()
    return summary


def stats_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    return {"stats_m_max_abs_err": float((got[..., 0] - want[..., 0]).abs().max()),
            "stats_l_max_rel_err": float(((got[..., 1] - want[..., 1]) / want[..., 1]).abs().max())}


def main(argv=None) -> dict:
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops.attention import flash_attention_reference
    from denseclip_vit_multimodal_tpu_torch.ops.lnqkv_kernel import ln_qkv_attention_reference
    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import mha_qkv_attention_reference

    root = Path(__file__).resolve().parents[2]
    p = argparse.ArgumentParser()
    p.add_argument("--tree", action="append", default=[],
                   help="NAME=CSRC_DIR (default: this checkout's csrc/ as 'this')")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--fp32", action="store_true",
                   help="time the fp32 forward and backward kernels instead")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_fwd_trees: needs a CUDA device")
    trees = dict(t.split("=", 1) for t in args.tree) or {
        "this": str(root / "denseclip_vit_multimodal_tpu_torch" / "csrc")}
    if args.fp32:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(len(trees)) as pool:  # every tree's nvcc at once
            built = pool.map(lambda t: build_fp32_tree(t[0], Path(t[1]),
                                                       root / "build" / "fp32_trees" / t[0]),
                             trees.items())
            fns = dict(zip(trees, built))
        summary = time_fp32(fns, args.rounds)
        print(json.dumps({"summary": summary, "device": torch.cuda.get_device_name(0)}),
              flush=True)
        if not all(entry["ok"] for entry in summary.values()):
            raise SystemExit("time_fwd_trees: a tree disagrees with the plain version")
        return summary
    fns = {name: build_tree(name, Path(csrc), root / "build" / "fwd_trees" / name)
           for name, csrc in trees.items()}

    summary: dict = {}
    for shape, (b, n, heads, d, kv) in SHAPES.items():
        kernel = shape[:2]
        hd, scale = heads * d, d**-0.5
        gen = torch.Generator(device="cuda").manual_seed(0)
        qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = (t.view(b, n, heads, d) for t in qkv.split(hd, dim=-1))
        want_stats = None
        if kernel == "k6":  # x and ln_1 / qkv parameters at the scale of the model's init
            x = torch.randn(b, n, hd, generator=gen, device="cuda").to(torch.bfloat16)
            gamma = 1.0 + 0.1 * torch.randn(hd, generator=gen, device="cuda")
            beta = 0.1 * torch.randn(hd, generator=gen, device="cuda")
            limit = (6.0 / (4 * hd)) ** 0.5
            wt = ((torch.rand(3 * hd, hd, generator=gen, device="cuda") * 2 - 1) * limit).to(
                torch.bfloat16)
            bias = 0.02 * torch.randn(3 * hd, generator=gen, device="cuda")
            want = ln_qkv_attention_reference(x, gamma, beta, wt.t(), bias, heads, valid_len=kv)
        elif kernel == "k4":
            want = flash_attention_reference(q, k, v, valid_len=kv).view(b, n, hd)
        else:
            want = mha_qkv_attention_reference(qkv, heads, valid_len=kv)
        if kernel != "k6":
            want_stats = plain_stats(q, k, kv, scale, prescaled=kernel != "k4")
            k[:, kv:] = float("nan")  # pad keys: must never reach a real row
            v[:, kv:] = float("nan")
        out = torch.empty(b, n, hd, dtype=torch.bfloat16, device="cuda")
        stats = torch.empty(b, heads, n, 2, device="cuda")
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn, with_stats=False):
            st = stats.data_ptr() if with_stats else None
            if kernel == "k1":
                err = fn["k1"](qkv.data_ptr(), out.data_ptr(), st, b, n, heads, d, kv,
                               scale * LOG2E, stream)
            elif kernel == "k3":
                err = fn["k3"](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), st,
                               *strides, b, n, heads, d, kv, scale * LOG2E, stream)
            elif kernel == "k4":
                err = fn["k4"](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), st,
                               *strides, b, n, heads, d, kv, 0, scale, stream)
            else:  # the first stage writes q / k / v into qkv, the second reads them
                err = fn["k6"](x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wt.data_ptr(),
                               bias.data_ptr(), qkv.data_ptr(), out.data_ptr(), b, n, hd, heads,
                               d, kv, scale * LOG2E, LN_EPS, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cudaError {err}")

        results, outs = {}, {}
        for name, fn in fns.items():
            out.fill_(float("nan"))
            call(fn, with_stats=True)
            torch.cuda.synchronize()
            outs[name] = (out.clone(),) if want_stats is None else (out.clone(), stats.clone())
            err = (out.float() - want.float()).abs()
            res = {"tree": name, "shape": shape, "max_abs_err": float(err.max()),
                   "mean_abs_err": float(err.mean()),
                   "rel_l2_err": float((out.float() - want.float()).norm() / want.float().norm()),
                   "ms": []}
            res["ok"] = bool(torch.isfinite(out.float()).all() and res["max_abs_err"] <= MAX_TOL
                             and res["mean_abs_err"] <= MEAN_TOL and res["rel_l2_err"] <= REL_TOL)
            if want_stats is not None:
                res.update(stats_errors(stats, want_stats))
                res["ok"] = res["ok"] and (res["stats_m_max_abs_err"] <= STATS_M_TOL
                                           and res["stats_l_max_rel_err"] <= STATS_L_TOL)
            results[name] = res
        last = list(fns)[-1]  # every tree against the last one given, bit for bit
        for name, res in results.items():
            res[f"bitwise_equal_to_{last}"] = all(
                torch.equal(x, y) for x, y in zip(outs[name], outs[last]))
        for r in range(args.rounds):
            for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                results[name]["ms"].append(_cuda_ms(lambda: call(fns[name]), ITERS[kernel]))
        if kernel == "k6":
            def library():
                proj = F.linear(F.layer_norm(x, (hd,), gamma.to(x.dtype), beta.to(x.dtype),
                                             LN_EPS), wt, bias.to(x.dtype))
                qh, kh, vh = (t.view(b, n, heads, d).transpose(1, 2)
                              for t in proj.split(hd, dim=-1))
                return F.scaled_dot_product_attention(qh, kh[:, :, :kv], vh[:, :, :kv])
        else:
            qh = q.transpose(1, 2).contiguous()
            kh, vh = (t[:, :kv].transpose(1, 2).contiguous() for t in (k, v))
            library = lambda: F.scaled_dot_product_attention(qh, kh, vh)
        library_ms = _cuda_ms(library, ITERS[kernel])
        # the function's products: every query row (K1, K3, K6), the valid rows
        # (K4); K6 adds its projection
        flops = 4.0 * b * heads * (kv if kernel == "k4" else n) * kv * d
        nbytes = 2.0 * 4 * b * n * hd
        if kernel == "k6":
            flops += 2.0 * b * n * hd * 3 * hd
            nbytes = 2.0 * (2 * b * n * hd + 3 * hd * hd)
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        for res in results.values():
            res.update(median_ms=statistics.median(res["ms"]), bound_ms=bound_ms,
                       library_ms=library_ms,
                       tflops=flops / (statistics.median(res["ms"]) * 1e-3) / 1e12)
            print(json.dumps(res), flush=True)
        summary[shape] = {name: res["median_ms"] for name, res in results.items()}
        summary[shape]["library"] = next(iter(results.values()))["library_ms"]
        summary[shape]["bitwise_equal"] = all(res[f"bitwise_equal_to_{last}"]
                                              for res in results.values())
        summary[shape]["ok"] = all(res["ok"] for res in results.values())
        if kernel == "k6":
            summary.update(time_k6_split(fns, (x, gamma, beta, wt, bias), heads, kv,
                                         {name: o[0] for name, o in outs.items()}, args.rounds))
    summary.update(time_int8(fns, args.rounds))
    summary.update(time_k7(fns, args.rounds))
    print(json.dumps({"summary": summary, "device": torch.cuda.get_device_name(0)}), flush=True)
    if not all(s["ok"] for s in summary.values()):
        raise SystemExit("time_fwd_trees: a tree disagrees with the plain version")
    return summary


if __name__ == "__main__":
    main()
