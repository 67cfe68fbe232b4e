"""Backward attention-kernel microbenchmarks at training shapes, on the card.

PyTorch port of the JAX package's `tools/profile_attn_bwd.py`.  At the
heritage training shape (640x640 crop -> N = 1601, batch 8, 12 heads of 64)
or any --batch / --seq, on q / k / v / dO of [B, H, N, D] bf16 (or fp32
with --dtype float32, which runs K3's and its backward's fp32 kernels;
handed to the kernels as [B, N, H, D] views), it times:

  * fwd_kernel   — K3 (`ops/mha_kernel.py::mha_attention`);
  * bwd_kernel   — K3's backward (`_launch_mha_bwd`) on K3's output and row
                   statistics;
  * bwd_plain_autograd — autograd through plain attention
                   (`ops/attention.py::plain_attention`, fp32 scores: the
                   JAX tool's XLA autodiff-of-reference backward);
  * bwd_library  — the backward of `F.scaled_dot_product_attention` (the
                   yardstick; the port never calls it),

after checking K3's backward against the plain autograd backward per
gradient.  Timing: `utils/benchtime.py::device_loop_time`.  One JSON line
per stage, as the JAX tool prints, and a JSON file (`--out`).

    python -m denseclip_vit_multimodal_tpu_torch.tools.profile_attn_bwd [--batch 8] [--seq 1601]
        [--dtype float32]
"""

from __future__ import annotations

import argparse
import json

import torch


def main(argv=None) -> dict:
    import torch.nn.functional as F

    from denseclip_vit_multimodal_tpu_torch.ops.attention import plain_attention
    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import _launch_mha, _launch_mha_bwd
    from denseclip_vit_multimodal_tpu_torch.utils.benchtime import device_loop_time

    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=1601)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    p.add_argument("--out", default="profile_attn_bwd_results.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_attn_bwd: needs a CUDA device")

    b, n, h, d = args.batch, args.seq, args.heads, args.head_dim
    scale = d**-0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = getattr(torch, args.dtype)
    mk = lambda: torch.randn(b, h, n, d, generator=gen, device="cuda").to(dtype)
    q, k, v, do = mk(), mk(), mk(), mk()
    bnhd = lambda x: x.transpose(1, 2)  # [B, N, H, D] views of the [B, H, N, D] tensors
    results: dict = {}

    def bench(name, fn, fargs):
        dt = device_loop_time(fn, fargs, args.iters)
        results[name] = dt * 1e3
        print(json.dumps({"stage": name, "ms": round(dt * 1e3, 4)}), flush=True)

    stats = torch.empty(b, h, n, 2, dtype=torch.float32, device="cuda")
    out = _launch_mha(bnhd(q), bnhd(k), bnhd(v), scale, n, stats)
    do_bnhd = bnhd(do).contiguous()
    kernel_bwd = lambda: _launch_mha_bwd(bnhd(q), bnhd(k), bnhd(v), out, do_bnhd, stats, scale, n)

    # numeric agreement with the autograd of plain attention (fp32 scores)
    leaves = [bnhd(x).detach().requires_grad_(True) for x in (q, k, v)]
    plain_out = plain_attention(*leaves, False)
    want = torch.autograd.grad(plain_out, leaves, bnhd(do), retain_graph=True)
    for name, a, w in zip(("dq", "dk", "dv"), kernel_bwd(), want):
        a, w = a.float(), w.float()
        err = float((a - w).abs().max() / (w.abs().max() + 1e-9))
        print(json.dumps({"agreement_vs_plain_autograd": name, "rel_err": err}), flush=True)
        results[f"relerr_{name}"] = err
    del want

    bench("fwd_kernel", lambda *xs: _launch_mha(*(bnhd(x) for x in xs), scale, n), (q, k, v))
    bench("bwd_kernel", kernel_bwd, ())
    bench("bwd_plain_autograd",
          lambda: torch.autograd.grad(plain_out, leaves, bnhd(do), retain_graph=True), ())
    del plain_out
    lib_leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_leaves)
    bench("bwd_library",
          lambda: torch.autograd.grad(lib_out, lib_leaves, do, retain_graph=True), ())

    summary = {"shape": [b, h, n, d], "dtype": args.dtype,
               "device": torch.cuda.get_device_name(0), **results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({"all_ms": {k2: round(v2, 4) for k2, v2 in results.items()}}), flush=True)
    return summary


if __name__ == "__main__":
    main()
