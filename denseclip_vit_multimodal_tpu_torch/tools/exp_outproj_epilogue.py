"""Experiment: fuse the attention out-projection into the attention kernel (K7).

PyTorch port of the JAX package's `tools/exp_outproj_epilogue.py`.  The
question it asks: does multiplying each head's attention output by its rows
of W_out while the output is still on chip (no round trip of the [B, N, H*D]
attention output through device memory) beat the attention kernel plus a
separate matmul?

  * `qkv_out_attention` launches K7 for CUDA tensors (`csrc/qkv_out_attention.cu`
    for bf16 qkv and W_out, `csrc/qkv_out_attention_fp32.cu` for fp32: the
    fp32 attention core, then the fp32 out-projection, both 3xTF32; two
    launches counted as one), or raises on anything it does not take (`TypeError`
    for other dtypes, `ValueError` for head dims other than 64 / 128 and
    widths past `MAX_WIDTH`); for CPU tensors it runs
    `qkv_out_attention_reference`.  It reads `DENSECLIP_FAST_EXP2` on every
    call, as the JAX kernel reads it through `_exp2`: the polynomial against
    the row's final max, floored at 0 where JAX pads the keys with zeros
    (no `valid_len`, N not a multiple of 128).  Inference only, as in the JAX
    script.  K7 runs the attention of every head of a 64-row block on TMA +
    wgmma, keeps each head's bf16 output in shared memory, then multiplies
    it by W_out with wgmma, W_out's tiles streamed by TMA.
  * `qkv_out_attention_reference` is the plain PyTorch version with the TPU
    kernel's rounding points: K1's attention per head (q * (scale * log2 e)
    rounded to the input dtype, fp32 scores, keys at or beyond `valid_len`
    excluded, exp2 softmax, P rounded for P V, one division), the head's
    output rounded to the input dtype, then its product with that head's
    rows of W_out, accumulated over the heads in fp32.
  * `LAUNCHES["qkv_out_attention"]` counts K7's launches ("_fp32" the fp32
    kernel's, "_fast_exp2" under the knob); each also hands its FLOPs
    (attention and out-projection) to `utils/flops.py::record_kernel_flops`.
  * `main()` runs the experiment on the card: agreement first (K7 against
    its plain version and against path A), then an interleaved A / B / A2 /
    B2 timing at [10, 1601, 12, 64], where A = K1 (`mha_qkv_attention`) +
    `torch.matmul` out-projection + the cast to fp32 and B = K7, with
    `utils/benchtime.py::device_loop_time`; then A's three parts each alone,
    K7's TFLOP/s beside its bound, and a verdict.

Verdict on an NVIDIA H100 80GB HBM3 (700 W): the fusion wins narrowly.
K7 took 0.281 ms (347 TFLOP/s, bound 0.099) against 0.292 for A, of which
K1 is about 0.22, the matmul 0.03 and the cast 0.04 (`tools/time_fwd_trees.py`
and this tool; PERF.md).  Before K7's redesign for Hopper (mma.sync,
synchronous loads: 1.95 ms) it lost ×6.7.

    python -m denseclip_vit_multimodal_tpu_torch.tools.exp_outproj_epilogue [--batch 10]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
from typing import Dict, Optional

import torch

from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
    EXP_EXACT,
    _LOG2E,
    _check_kernel_input,
    _kv_len,
    _split_shape,
    attention_prescaled,
    check_exp_mode,
    kernel_name,
    mha_qkv_attention,
    softmax_modes,
)
from denseclip_vit_multimodal_tpu_torch.utils.flops import (
    attention_flops,
    projection_flops,
    record_kernel_flops,
)

LAUNCHES: Dict[str, int] = {f"qkv_out_attention{dt}{knob}": 0 for dt in ("", "_fp32")
                            for knob in ("", "_fast_exp2")}
# The widest H*D the kernel takes (ViT-L/14's width): every head's bf16
# output of a 64-row block stays in shared memory beside the K / V rings.
MAX_WIDTH = 1024


def qkv_out_attention_reference(
    qkv: torch.Tensor,
    w_out: torch.Tensor,
    num_heads: int,
    *,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
    exp_mode: int = EXP_EXACT,
) -> torch.Tensor:
    """Plain PyTorch version of K7: [B, N, 3*H*D] qkv + [H*D, H*D] w_out ->
    [B, N, H*D] fp32 (before the bias); the softmax's exp under `exp_mode`."""
    b, n, hd, d = _split_shape(qkv, num_heads)
    kv_len = _kv_len(valid_len, n)
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    q, k, v = (x.view(b, n, num_heads, d) for x in qkv.split(hd, dim=-1))
    qs = (q.float() * (scale * _LOG2E)).to(qkv.dtype)
    o = attention_prescaled(qs, k, v, kv_len, exp_mode)  # [B, N, H, D], each head rounded
    out = torch.zeros(b, n, hd, dtype=torch.float32, device=qkv.device)
    for h in range(num_heads):
        out += o[:, :, h].float() @ w_out[h * d:(h + 1) * d].float()
    return out


@functools.lru_cache(maxsize=None)
def _kernel_fn(dtype: torch.dtype):
    """K7's C entry for `dtype`, the exp mode before the stream; the fp32
    one also takes the [B, N, H*D] fp32 workspace of the attention output."""
    from denseclip_vit_multimodal_tpu_torch.ops._build import load_library

    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if dtype == torch.float32:
        fn = load_library("qkv_out_attention_fp32").qkv_out_attention_fp32
        fn.argtypes = [ptr] * 4 + [i] * 5 + [f, i, ptr]
    else:
        fn = load_library("qkv_out_attention").qkv_out_attention_bf16_knob
        fn.argtypes = [ptr] * 3 + [i] * 5 + [f, i, ptr]
    fn.restype = ctypes.c_int
    return fn


def _launch(qkv: torch.Tensor, w_out: torch.Tensor, num_heads: int, scale: float,
            kv_len: int, exp_mode: int = EXP_EXACT) -> torch.Tensor:
    """K7 on CUDA tensors (bf16 or fp32, W_out in qkv's dtype) under
    `exp_mode`; returns a contiguous fp32 [B, N, H*D]."""
    b, n, hd, d = _split_shape(qkv, num_heads)
    _check_kernel_input(qkv, "qkv")
    _check_kernel_input(w_out, "w_out")
    if w_out.dtype != qkv.dtype:
        raise TypeError(f"w_out must be {qkv.dtype} as qkv, got {w_out.dtype}")
    check_exp_mode(qkv.dtype, exp_mode, "out-projection epilogue")
    if d not in (64, 128) or hd % 64 or hd > MAX_WIDTH:
        raise ValueError(f"the out-projection epilogue kernel takes head dim 64 or 128 and a "
                         f"width that is a multiple of 64 up to {MAX_WIDTH}, got "
                         f"{d} x {num_heads}")
    if w_out.shape != (hd, hd) or w_out.device != qkv.device:
        raise ValueError(f"w_out must be [{hd}, {hd}] on qkv's device, got {tuple(w_out.shape)}")
    fn = _kernel_fn(qkv.dtype)
    out = torch.empty(b, n, hd, dtype=torch.float32, device=qkv.device)
    # the fp32 kernel's attention output, before the out-projection reads it
    ws = [torch.empty(b, n, hd, device=qkv.device)] if qkv.dtype == torch.float32 else []
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), w_out.data_ptr(), *(t.data_ptr() for t in ws), out.data_ptr(),
                 b, n, num_heads, d, kv_len, scale * _LOG2E, exp_mode, stream)
    if err != 0:
        raise RuntimeError(f"out-projection epilogue kernel launch failed: cudaError {err}")
    name = kernel_name("qkv_out_attention", qkv.dtype, exp_mode)
    LAUNCHES[name] += 1
    record_kernel_flops(name, attention_flops(b, n, kv_len, hd) + projection_flops(b, n, hd, hd))
    return out


def qkv_out_attention(
    qkv: torch.Tensor,
    w_out: torch.Tensor,
    num_heads: int,
    *,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """[B, N, 3*H*D] qkv + [H*D, H*D] w_out -> [B, N, H*D] fp32 (pre-bias):
    K7 for CUDA tensors, its plain version for CPU tensors.
    `DENSECLIP_FAST_EXP2` is read now (`softmax_modes`)."""
    _, n, _, d = _split_shape(qkv, num_heads)
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    kv_len = _kv_len(valid_len, n)
    exp_mode = softmax_modes("qkv_out", qkv.dtype, n, valid_len)[0]
    if qkv.device.type == "cpu":
        return qkv_out_attention_reference(qkv, w_out, num_heads, sm_scale=scale,
                                           valid_len=kv_len, exp_mode=exp_mode)
    if qkv.device.type != "cuda":
        raise ValueError(f"no out-projection epilogue attention for device {qkv.device}")
    return _launch(qkv, w_out, num_heads, scale, kv_len, exp_mode)


def main(argv=None) -> dict:
    """Agreement, then the interleaved A / B / A2 / B2 timing; prints one
    JSON line per stage and returns every number."""
    from denseclip_vit_multimodal_tpu_torch.tools.time_fwd_trees import PEAK_BF16_FLOPS, PEAK_BYTES
    from denseclip_vit_multimodal_tpu_torch.utils.benchtime import device_loop_time

    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=10)
    p.add_argument("--seq", type=int, default=1601)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--iters", type=int, default=30)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_outproj_epilogue: needs a CUDA device")

    b, n, heads, d = args.batch, args.seq, args.heads, args.head_dim
    hd = heads * d
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(hd, hd, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)

    def a_fn(qkv, w):  # K1, then the out-projection as its own matmul
        return torch.matmul(mha_qkv_attention(qkv, heads), w).float()

    def b_fn(qkv, w):
        return qkv_out_attention(qkv, w, heads)

    results: dict = {"shape": [b, n, 3 * hd], "heads": heads, "head_dim": d}
    ya, yb = a_fn(qkv, w), b_fn(qkv, w)
    plain = qkv_out_attention_reference(qkv, w, heads)
    torch.cuda.synchronize()
    scale_of = lambda y: float(y.abs().max()) + 1e-9
    results["rel_err_a_vs_b"] = float((ya - yb).abs().max()) / scale_of(ya)
    results["rel_err_b_vs_plain"] = float((yb - plain).abs().max()) / scale_of(plain)
    results["rel_l2_b_vs_plain"] = float((yb - plain).norm() / plain.norm())
    results["max_abs_err_b_vs_plain"] = float((yb - plain).abs().max())
    results["finite"] = bool(torch.isfinite(yb).all())
    print(json.dumps({k: results[k] for k in ("rel_err_a_vs_b", "rel_err_b_vs_plain",
                                              "rel_l2_b_vs_plain")}), flush=True)
    del ya, yb, plain

    for tag, fn in (("A", a_fn), ("B", b_fn), ("A2", a_fn), ("B2", b_fn)):
        stats: dict = {}
        results[f"{tag}_ms"] = device_loop_time(fn, (qkv, w), args.iters, stats) * 1e3
        print(json.dumps({"stage": tag, "ms": results[f"{tag}_ms"], **stats}), flush=True)
    # A's parts, each alone on its own input: K1, the matmul, the cast to fp32
    o = mha_qkv_attention(qkv, heads)
    y = torch.matmul(o, w)
    for key, fn, fargs in (("A_k1_ms", mha_qkv_attention, (qkv, heads)),
                           ("A_matmul_ms", torch.matmul, (o, w)),
                           ("A_cast_ms", torch.Tensor.float, (y,))):
        results[key] = device_loop_time(fn, fargs, args.iters) * 1e3
    del o, y
    a_ms = min(results["A_ms"], results["A2_ms"])
    b_ms = min(results["B_ms"], results["B2_ms"])
    # the function's work: the attention's two products over every key, the
    # projection; one read of qkv and W, one write of the fp32 output
    flops = 4.0 * b * heads * n * n * d + 2.0 * b * n * hd * hd
    nbytes = 2.0 * (qkv.numel() + w.numel()) + 4.0 * b * n * hd
    results.update(
        speedup_b_over_a=a_ms / b_ms, tflops_b=flops / (b_ms * 1e-3) / 1e12,
        bound_ms=max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
        bound_by="operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes",
        verdict="the fused epilogue wins" if b_ms < a_ms else "the fused epilogue loses")
    print(json.dumps({k: results[k] for k in (
        "verdict", "speedup_b_over_a", "tflops_b", "bound_ms", "bound_by", "A_k1_ms",
        "A_matmul_ms", "A_cast_ms")} | {"A_ms": a_ms, "B_ms": b_ms}), flush=True)
    return results


if __name__ == "__main__":
    main()
