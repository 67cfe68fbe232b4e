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
  on CUDA, head dim 64, 128 or 256; the plain versions on the CPU).  The K4
  branch calls the op `denseclip_torch::flash_attention` (`ops/_library.py`),
  which launches `csrc/flash_attention.cu` (the forward core
  `csrc/attention_fwd.cuh` under the bundled kernel's numerics, head dim 64,
  128 or 256) for a bf16 CUDA tensor and `csrc/attention_fp32.cu`'s
  `flash_attention_fp32` (the SIMT fp32 core under the same numerics) for
  an fp32 one, or raises on anything the kernels do not take (another
  dtype: `TypeError`, as in the K3 branch); for a tensor on the CPU it runs
  the plain version.
  When autograd records it, it goes through `FlashAttentionFunction`: K4
  also writes each row's max and sum (the bundled kernel's residuals m and
  l), and the backward is K4b (`csrc/flash_attention_bwd.cu`, or
  `csrc/attention_bwd_fp32.cu`'s `flash_attention_bwd_fp32`, 3xTF32 on the
  tensor cores, in fp32) on
  CUDA, `flash_attention_bwd_reference` on the CPU.  q / k / v may be
  strided views (the split of the fused qkv projection, row stride 3*H*D):
  the kernels read them by stride, with no copy.
* `flash_attention_reference` is the plain PyTorch version of K4 with the
  bundled kernel's rounding points (see the CUDA source), one head at a time
  and chunked over query rows, so that it runs at N = 25216 without a
  [N, N] score tensor per head; `flash_attention_bwd_reference` is K4b's,
  chunked the same way.
* `plain_attention` is the counterpart of the JAX package's `_xla_attention`
  (fp32 scores and softmax over the whole row).
* `LAUNCHES` counts K4's ("flash_attention") and K4b's
  ("flash_attention_bwd", its two CUDA kernels as one) launches, and those
  of their fp32 kernels ("flash_attention_fp32", "flash_attention_bwd_fp32"),
  never plain calls; K4's launch also hands its FLOPs to `utils/flops.py::
  record_kernel_flops`.

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

from denseclip_vit_multimodal_tpu_torch.ops._library import define
from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
    bnhd_args,
    check_bnhd,
    check_device,
    check_kernel_dtype,
    kernel_name,
    mha_attention,
)
from denseclip_vit_multimodal_tpu_torch.utils.flops import attention_flops, record_kernel_flops

# Below this sequence length plain attention serves (JAX package
# `_FLASH_MIN_SEQ`); non-causal sequences up to `_ONESHOT_MAX_SEQ` take the
# one-shot kernels (K1 off the fused qkv, K3 otherwise).
_FLASH_MIN_SEQ = 1024
_ONESHOT_MAX_SEQ = 8448
_REF_CHUNK = 4096  # query rows per step of the plain version

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0,
                            "flash_attention_fp32": 0, "flash_attention_bwd_fp32": 0}


def _on_cuda(x: torch.Tensor) -> bool:
    """Whether `x` lies on a CUDA device: the kernels' side of every dispatch
    rule (the JAX package's `_on_tpu`; tests patch it to reach the kernels'
    plain versions on the CPU)."""
    return x.is_cuda


def flash_supported(q: torch.Tensor) -> bool:
    """Whether the flash path serves `q` [B, N, H, D]: CUDA, N >= 1024, head
    dim 64, 128 or 256 (the JAX rule, which asks nothing about the dtype:
    the kernels take bf16 and fp32, and raise `TypeError` on another)."""
    return (_on_cuda(q) and q.shape[1] >= _FLASH_MIN_SEQ
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
def _kernel_fn(name: str):
    """K4's or K4b's C entry point, compiled at first use."""
    from denseclip_vit_multimodal_tpu_torch.ops._build import load_library

    ptr, i64, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    if name == "flash_attention":
        fn = load_library("flash_attention").flash_attention_bf16
    elif name == "flash_attention_fp32":
        fn = load_library("attention_fp32").flash_attention_fp32
    elif name == "flash_attention_bwd":
        fn = load_library("flash_attention_bwd").flash_attention_bwd_bf16
    else:
        fn = load_library("attention_bwd_fp32").flash_attention_bwd_fp32
    n_ptrs = 9 if "_bwd" in name else 5
    fn.argtypes = [ptr] * n_ptrs + [i64] * 9 + [i] * 6 + [f, ptr]
    fn.restype = ctypes.c_int
    return fn


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float,
            kv_len: int, stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4 on CUDA tensors (bf16 or fp32); returns a contiguous [B, N, H, D]
    output in q's dtype.  With `stats` (fp32 [B, H, N, 2]) it also writes
    each row's residuals."""
    b, n, heads, d = q.shape
    strides = bnhd_args(q, k, v, "flash attention", (64, 128, 256))
    if stats is not None and (stats.shape != (b, heads, n, 2) or stats.dtype != torch.float32
                              or not stats.is_contiguous() or stats.device != q.device):
        raise ValueError(f"stats must be a contiguous fp32 {(b, heads, n, 2)} on q's device")
    name = kernel_name("flash_attention", q.dtype)
    fn = _kernel_fn(name)
    out = torch.empty(b, n, heads, d, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if stats is None else stats.data_ptr(), *strides,
                 b, n, heads, d, kv_len, int(causal), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    record_kernel_flops(name, attention_flops(b, n, kv_len, heads * d))
    return out


FLASH_ATTENTION_OP = define(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal, float scale, int kv_len) -> Tensor",
    cpu=lambda q, k, v, causal, scale, kv_len: flash_attention_reference(
        q, k, v, causal=causal, sm_scale=scale, valid_len=kv_len),
    cuda=_launch,
    fake=lambda q, k, v, causal, scale, kv_len: q.new_empty(q.shape),
    flops=lambda q, k, v, causal, scale, kv_len: attention_flops(
        q.shape[0], q.shape[1], kv_len, q.shape[2] * q.shape[3]),
)


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                dout: torch.Tensor, stats: torch.Tensor, causal: bool, scale: float,
                kv_len: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4b (bf16 or fp32): (dq, dk, dv), contiguous [B, N, H, D] in q's
    dtype, from the strided q / k / v, K4's output and residuals and the
    output's gradient."""
    b, n, heads, d = q.shape
    strides = bnhd_args(q, k, v, "flash attention backward", (64, 128, 256))
    for x, what in ((out, "output"), (dout, "output gradient")):
        check_kernel_dtype(x, what, "flash attention backward")
        if x.shape != q.shape or x.dtype != q.dtype or not x.is_contiguous():
            raise ValueError(f"the flash attention backward takes a contiguous {q.dtype} "
                             f"{what} {tuple(q.shape)}")
    if stats is None or stats.shape != (b, heads, n, 2) or not stats.is_contiguous():
        raise ValueError("the flash attention backward needs K4's row residuals")
    # di = rowsum(fp32 O * fp32 dO): the bundled wrapper computes it outside its kernels too
    di = (out.float() * dout.float()).sum(dim=-1).transpose(1, 2).contiguous()
    name = kernel_name("flash_attention_bwd", q.dtype)
    fn = _kernel_fn(name)
    dq, dk, dv = (torch.empty(b, n, heads, d, dtype=q.dtype, device=q.device) for _ in range(3))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), stats.data_ptr(),
                 di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *strides,
                 b, n, heads, d, kv_len, int(causal), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
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
    (`mha_attention`, differentiable through K3's backward); causal, or
    N > 8448 -> K4, differentiable through `FlashAttentionFunction` (K4b)
    when autograd records it; both branches take head dim 64, 128 and 256.
    `valid_len` masks trailing pad keys; output rows [valid_len, N) are
    unspecified.
    """
    n, kv_len = check_bnhd(q, k, v, valid_len)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    if not causal and n <= _ONESHOT_MAX_SEQ:
        # the caller's valid_len: None keeps JAX's zero-pad softmax under a knob
        return mha_attention(q, k, v, sm_scale=scale, valid_len=valid_len)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, scale, kv_len)
    check_device(q, "flash attention")
    return FLASH_ATTENTION_OP(q, k, v, causal, scale, kv_len)
