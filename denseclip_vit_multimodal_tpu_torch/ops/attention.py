"""Attention on [B, N, H, D]: the long-sequence flash kernel (K4), its
backward (K4b) and the dispatch.

Port of the JAX package's `ops/attention.py`.  There, `flash_attention`
sends non-causal sequences of at most 8448 tokens to its one-shot kernel
(`ops/mha_kernel.py::mha_attention`, K3) and everything else (causal, or
longer: the 1.25 / 1.5 / 1.75 scales of multi-scale evaluation, training on
crops of more than 8448 tokens) to the bundled Pallas flash kernel (K4),
whose custom VJP runs the bundled backward kernels (K4b).  Here:

* `flash_attention` follows the same dispatch.  The K3 branch runs
  `ops/mha_kernel.py::mha_attention` (K3 and, under autograd, K3's backward
  on CUDA; the plain versions on the CPU).  The K4 branch launches
  `csrc/flash_attention.cu` for a CUDA tensor, or raises on anything the
  kernel does not take; for a tensor on the CPU it runs the plain version.
  When autograd records it, it goes through `FlashAttentionFunction`: K4
  also writes each row's max and sum (the bundled kernel's residuals m and
  l), and the backward is K4b (`csrc/flash_attention_bwd.cu`) on CUDA,
  `flash_attention_bwd_reference` on the CPU.  At head dim 256, which K4
  does not take yet, it keeps plain attention.  q / k / v may be strided
  views (the split of the fused qkv projection, row stride 3*H*D): the
  kernels read them by stride, with no copy.
* `flash_attention_reference` is the plain PyTorch version of K4 with the
  bundled kernel's rounding points (see the CUDA source), one head at a time
  and chunked over query rows, so that it runs at N = 25216 without a
  [N, N] score tensor per head; `flash_attention_bwd_reference` is K4b's,
  chunked the same way.
* `plain_attention` is the counterpart of the JAX package's `_xla_attention`
  (fp32 scores and softmax over the whole row).
* `LAUNCHES` counts K4's ("flash_attention") and K4b's
  ("flash_attention_bwd", its two CUDA kernels as one) launches, never plain
  calls.

Output rows at or beyond `valid_len` are unspecified but finite (they are
computed against the valid keys); callers slice them off.  In the backward,
as in the bundled kernels (whose segment ids put the JAX package's pad rows
on pad keys only), those rows contribute nothing: K4b gives them dq = 0 and
gives keys at or beyond `valid_len` dk = dv = 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
    bnhd_args,
    check_bnhd,
    mha_attention,
)

# Below this sequence length plain attention serves (JAX package
# `_FLASH_MIN_SEQ`); non-causal sequences up to `_ONESHOT_MAX_SEQ` take the
# one-shot kernels (K1 off the fused qkv, K3 otherwise).
_FLASH_MIN_SEQ = 1024
_ONESHOT_MAX_SEQ = 8448
_REF_CHUNK = 4096  # query rows per step of the plain version

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}


def _on_cuda(x: torch.Tensor) -> bool:
    """Whether `x` lies on a CUDA device: the kernels' side of every dispatch
    rule (the JAX package's `_on_tpu`; tests patch it to reach the kernels'
    plain versions on the CPU)."""
    return x.is_cuda


def flash_supported(q: torch.Tensor) -> bool:
    """Whether the flash path serves `q` [B, N, H, D]: CUDA, bf16 (the
    kernels' one dtype), N >= 1024, head dim 64, 128 or 256 (the JAX rule)."""
    return (_on_cuda(q) and q.dtype == torch.bfloat16 and q.shape[1] >= _FLASH_MIN_SEQ
            and q.shape[-1] in (64, 128, 256))


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    valid_len: Optional[int] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention on [B, N, H, Dh] inputs with an fp32 softmax.

    Counterpart of the JAX package's `_xla_attention`: fp32 scores (the
    inputs' products accumulated in fp32), min-float masking of causal and
    `valid_len` positions, softmax in fp32 cast back to the input dtype.
    """
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    n, m = logits.shape[-2:]
    neg = torch.finfo(torch.float32).min
    if causal:
        mask = torch.ones(n, m, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, neg)
    if valid_len is not None and valid_len < m:
        logits[..., valid_len:] = neg
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", weights, v)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K4; [B, N, H, D] -> [B, N, H, D] in q's dtype.

    fp32 scores from the unscaled inputs, times `sm_scale` in fp32; keys at
    or beyond `valid_len` and (causal) after the query are excluded; P =
    exp(s - max) in fp32, rounded to the input dtype for P V with fp32
    accumulation; one division by the fp32 row sum.
    """
    n, kv_len = check_bnhd(q, k, v, valid_len)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    dtype = q.dtype
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    keys = torch.arange(kv_len, device=q.device)
    for h in range(q.shape[2]):  # one head at a time bounds the fp32 scores
        kh = k[:, :kv_len, h].float()
        vh = v[:, :kv_len, h].float()
        for r0 in range(0, n, _REF_CHUNK):
            r1 = min(r0 + _REF_CHUNK, n)
            s = (q[:, r0:r1, h].float() @ kh.transpose(-1, -2)) * scale
            if causal:
                rows = torch.arange(r0, r1, device=q.device)
                s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            denom = p.sum(dim=-1, keepdim=True)
            o = p.to(dtype).float() @ vh
            out[:, r0:r1, h] = (o / denom).to(dtype)
    return out


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4b: (dq, dk, dv) [B, N, H, D] in q's dtype.

    `out` is the forward's output and `dout` its gradient.  The bundled
    kernels' rounding points: di = rowsum(fp32 O * fp32 dO); s = q k^T in
    fp32, times `sm_scale`; p = exp(s - m) * (1 / l) over the valid (and,
    causal, earlier) keys; dv += round(p)^T dO; dp = dO v^T; ds = (dp - di)
    * p * sm_scale; dk += round(ds)^T q; dq = round(ds) k; fp32 sums,
    rounded to q's dtype at the end.  Only query rows below `valid_len`
    contribute; the rest get dq = 0, and keys at or beyond it dk = dv = 0.
    """
    _, kv_len = check_bnhd(q, k, v, valid_len)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    dtype = q.dtype
    b, n, heads, d = q.shape
    dq = torch.zeros(q.shape, dtype=dtype, device=q.device)
    dk = torch.zeros(q.shape, dtype=dtype, device=q.device)
    dv = torch.zeros(q.shape, dtype=dtype, device=q.device)
    keys = torch.arange(kv_len, device=q.device)
    for h in range(heads):  # one head at a time bounds the fp32 scores
        kh, vh = k[:, :kv_len, h].float(), v[:, :kv_len, h].float()
        dk_acc = torch.zeros(b, kv_len, d, dtype=torch.float32, device=q.device)
        dv_acc = torch.zeros(b, kv_len, d, dtype=torch.float32, device=q.device)
        for r0 in range(0, kv_len, _REF_CHUNK):
            r1 = min(r0 + _REF_CHUNK, kv_len)
            qh = q[:, r0:r1, h].float()
            doh = dout[:, r0:r1, h].to(dtype).float()
            di = (out[:, r0:r1, h].float() * doh).sum(dim=-1, keepdim=True)
            s = (qh @ kh.transpose(-1, -2)) * scale
            if causal:
                rows = torch.arange(r0, r1, device=q.device)
                s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            p = p * (1.0 / p.sum(dim=-1, keepdim=True))
            dv_acc += p.to(dtype).float().transpose(-1, -2) @ doh
            dp = doh @ vh.transpose(-1, -2)
            ds = (dp - di) * p * scale
            ds_r = ds.to(dtype).float()
            dk_acc += ds_r.transpose(-1, -2) @ qh
            dq[:, r0:r1, h] = (ds_r @ kh).to(dtype)
        dk[:, :kv_len, h] = dk_acc.to(dtype)
        dv[:, :kv_len, h] = dv_acc.to(dtype)
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str = "flash_attention"):
    """K4's or K4b's C entry point, compiled at first use."""
    from denseclip_vit_multimodal_tpu_torch.ops._build import load_library

    ptr, i64, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    if name == "flash_attention":
        fn = load_library("flash_attention").flash_attention_bf16
        fn.argtypes = [ptr] * 5 + [i64] * 9 + [i] * 6 + [f, ptr]
    else:
        fn = load_library("flash_attention_bwd").flash_attention_bwd_bf16
        fn.argtypes = [ptr] * 9 + [i64] * 9 + [i] * 6 + [f, ptr]
    fn.restype = ctypes.c_int
    return fn


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float,
            kv_len: int, stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4 on CUDA tensors; returns a contiguous [B, N, H, D] bf16 output.
    With `stats` (fp32 [B, H, N, 2]) it also writes each row's residuals."""
    b, n, heads, d = q.shape
    strides = bnhd_args(q, k, v, "flash attention", (64, 128))
    if stats is not None and (stats.shape != (b, heads, n, 2) or stats.dtype != torch.float32
                              or not stats.is_contiguous() or stats.device != q.device):
        raise ValueError(f"stats must be a contiguous fp32 {(b, heads, n, 2)} on q's device")
    fn = _kernel_fn()
    out = torch.empty(b, n, heads, d, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if stats is None else stats.data_ptr(), *strides,
                 b, n, heads, d, kv_len, int(causal), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    return out


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                dout: torch.Tensor, stats: torch.Tensor, causal: bool, scale: float,
                kv_len: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4b: (dq, dk, dv), contiguous [B, N, H, D] bf16, from the strided
    q / k / v, K4's output and residuals and the output's gradient."""
    b, n, heads, d = q.shape
    strides = bnhd_args(q, k, v, "flash attention backward", (64, 128))
    for x, what in ((out, "output"), (dout, "output gradient")):
        if x.shape != q.shape or x.dtype != torch.bfloat16 or not x.is_contiguous():
            raise ValueError(f"the flash attention backward takes a contiguous bf16 {what} "
                             f"{tuple(q.shape)}")
    if stats is None or stats.shape != (b, heads, n, 2) or not stats.is_contiguous():
        raise ValueError("the flash attention backward needs K4's row residuals")
    # di = rowsum(fp32 O * fp32 dO): the bundled wrapper computes it outside its kernels too
    di = (out.float() * dout.float()).sum(dim=-1).transpose(1, 2).contiguous()
    fn = _kernel_fn("flash_attention_bwd")
    dq, dk, dv = (torch.empty(b, n, heads, d, dtype=q.dtype, device=q.device) for _ in range(3))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), stats.data_ptr(),
                 di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *strides,
                 b, n, heads, d, kv_len, int(causal), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed: cudaError {err}")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """K4 forward, K4b backward (the bundled kernel's custom VJP).

    On CPU tensors both directions are the plain versions; on CUDA both are
    the kernels, with no fallback.  Saves q, k, v, the output and (CUDA)
    K4's row residuals.
    """

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                scale: float, kv_len: int):
        if q.device.type == "cpu":
            out = flash_attention_reference(q, k, v, causal=causal, sm_scale=scale,
                                            valid_len=kv_len)
            stats = None
        elif q.device.type == "cuda":
            b, n, heads, _ = q.shape
            stats = torch.empty(b, heads, n, 2, dtype=torch.float32, device=q.device)
            out = _launch(q, k, v, causal, scale, kv_len, stats)
        else:
            raise ValueError(f"no flash attention for device {q.device}")
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.attrs = (causal, scale, kv_len)
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        q, k, v, out, stats = ctx.saved_tensors
        causal, scale, kv_len = ctx.attrs
        if q.device.type == "cpu":
            grads = flash_attention_bwd_reference(q, k, v, out, dout, causal=causal,
                                                  sm_scale=scale, valid_len=kv_len)
        else:
            grads = _launch_bwd(q, k, v, out, dout.to(q.dtype).contiguous(), stats, causal,
                                scale, kv_len)
        return (*grads, None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Attention on q / k / v [B, N, H, D] -> [B, N, H, D].  Exact, any N.

    Dispatch (the JAX package's): non-causal N <= 8448 -> the K3 branch
    (`mha_attention`); causal, or N > 8448 -> K4, differentiable through
    `FlashAttentionFunction` (K4b) when autograd records it (plain attention
    at head dim 256, which K4 does not take yet).  `valid_len` masks
    trailing pad keys; output rows [valid_len, N) are unspecified.
    """
    n, kv_len = check_bnhd(q, k, v, valid_len)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    if not causal and n <= _ONESHOT_MAX_SEQ:
        return mha_attention(q, k, v, sm_scale=scale, valid_len=kv_len)
    if q.shape[-1] == 256:
        return plain_attention(q, k, v, causal, valid_len, sm_scale=scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, scale, kv_len)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, sm_scale=scale,
                                         valid_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    return _launch(q, k, v, causal, scale, kv_len)
