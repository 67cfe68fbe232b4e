"""GPU self-test: the attention kernels against plain attention on the card.

    python3 -m denseclip_vit_multimodal_tpu_torch.tools.selftest

Port of the JAX package's `tools/tpu_selftest.py`, with its checks and
tolerances (max abs error against plain attention, `ops/attention.py::
plain_attention`, the JAX `xla_attn`): K3 and K1 at [2, 1601, 12, 64] bf16
and, the JAX tool's fp32 case, at [2, 1024, 12, 64] fp32 (their fp32
kernels, tolerance 5e-3), `valid_len` masking of a sequence padded 1500 ->
1536 through K3, the int8 kernel K5 (after its prologue kernel) at N = 1601,
and `flash_attention` at N = 8193, labelled by the kernel that ran (K3, by
the dispatch: 8193 <= 8448, non-causal).  Every check also fails if its
kernel was not launched.  Runs on CUDA only (no CPU fallback);
prints PASS / FAIL per check and `SELFTEST OK` or `SELFTEST FAILED`, and
exits 1 on a failure or without a CUDA device.
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional, Tuple, Union


def main(argv: Optional[List[str]] = None) -> int:
    import torch

    from denseclip_vit_multimodal_tpu_torch.ops import attention, mha_kernel
    from denseclip_vit_multimodal_tpu_torch.ops.attention import (
        flash_attention,
        flash_supported,
        plain_attention,
    )
    from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
        mha_attention,
        mha_qkv_attention,
        mha_qkv_attention_int8,
    )

    if argv:
        print(f"usage: python3 -m denseclip_vit_multimodal_tpu_torch.tools.selftest "
              f"(no arguments), got {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("selftest: no CUDA device (the self-test runs the kernels on the card only)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")
    failures = 0

    def launched() -> dict:
        return {**mha_kernel.LAUNCHES, **attention.LAUNCHES}

    def check(name: str, run: Callable[[], torch.Tensor], want: torch.Tensor, tol: float,
              kernel: Union[None, str, Tuple[str, ...]]) -> None:
        """`run` must launch `kernel` (a LAUNCHES key, or each of a tuple of
        them) once and agree with `want` to `tol` max abs error; with kernel
        None, the kernel that ran is named in the label."""
        nonlocal failures
        before = launched()
        got = run()
        torch.cuda.synchronize()
        ran = [k for k, v in launched().items() if v != before[k]]
        err = float((got.float() - want.float()).abs().max())
        kernels = [kernel] if isinstance(kernel, str) else list(kernel or ())
        ok = err <= tol and (sorted(ran) == sorted(kernels) if kernel else len(ran) == 1)
        failures += 0 if ok else 1
        label = name if kernel else f"{name} via {ran[0] if len(ran) == 1 else ran}"
        print(f"{'PASS' if ok else 'FAIL'} {label}: max_err={err:.5f} (tol {tol}, "
              f"launched {ran})")

    def normal(shape, seed, dtype=torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3)]

    # the JAX tool's two cases; fp32 takes the fp32 kernels
    for n, dtype, tol in ((1601, torch.bfloat16, 2e-2), (1024, torch.float32, 5e-3)):
        shape = (2, n, 12, 64)
        q, k, v = normal(shape, n, dtype)
        ref = plain_attention(q, k, v, False)
        name = str(dtype).split(".")[-1]
        check(f"one-shot kernel (K3) N={n} {name}", lambda: mha_attention(q, k, v), ref, tol,
              mha_kernel.kernel_name("mha_attention", dtype))
        qkv = torch.cat([x.reshape(2, n, -1) for x in (q, k, v)], dim=-1)
        check(f"qkv-direct kernel (K1) N={n} {name}",
              lambda: mha_qkv_attention(qkv, 12).reshape(shape), ref, tol,
              mha_kernel.kernel_name("qkv_attention", dtype))

    n, pad_n = 1500, 1536
    q, k, v = normal((1, n, 4, 64), 7)
    ref = plain_attention(q, k, v, False)
    padded = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad_n - n))
    check("valid_len masking (pad 1500->1536) (K3)",
          lambda: mha_attention(padded(q), padded(k), padded(v), valid_len=n)[:, :n], ref, 2e-2,
          "mha_attention")

    n = 1601
    shape = (2, n, 12, 64)
    q, k, v = normal(shape, 11)
    ref = plain_attention(q, k, v, False)
    qkv = torch.cat([x.reshape(2, n, -1) for x in (q, k, v)], dim=-1)
    check(f"int8 kernel (K5) N={n} (quantized, tol 0.35)",
          lambda: mha_qkv_attention_int8(qkv, 12).reshape(shape), ref, 0.35,
          ("quantize_qkv_int8", "qkv_attention_int8"))

    n = 8193
    q, k, v = normal((1, n, 4, 64), 1)
    if flash_supported(q):
        ref = plain_attention(q, k, v, False)
        check(f"flash_attention N={n}", lambda: flash_attention(q, k, v), ref, 3e-2, None)
    else:
        print(f"SKIP flash_attention N={n} (unsupported for {q.dtype} on {q.device})")
        failures += 1  # on the card it is supported: a skip here is a fault

    print("SELFTEST", "FAILED" if failures else "OK")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
