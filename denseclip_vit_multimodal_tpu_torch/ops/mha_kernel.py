"""Attention straight off the fused QKV projection: Hopper kernels + plain versions.

Port of the JAX package's `ops/mha_kernel.py::mha_qkv_attention`: the TPU
kernel `_qkv_kernel` (K1, forward; `csrc/qkv_attention.cu`) and its custom
VJP `_qkv_bwd` -> `_mha_bwd_pallas` -> `_bwd_kernel` (K2, backward;
`csrc/qkv_attention_bwd.cu`).  Each source's header note gives its design and
its bound on an H100.

* `mha_qkv_attention` launches the forward kernel for a CUDA tensor, or
  raises on anything the kernel does not take.  For a tensor on the CPU it
  runs the plain version; there is no other way to reach the plain version.
  When autograd records the call it goes through `QKVAttentionFunction`,
  whose backward is K2 on CUDA and the plain backward on the CPU.
* `mha_qkv_attention_reference` is the plain PyTorch forward with K1's
  rounding points: q * (scale * log2 e) rounded to the input dtype, fp32
  scores, exp2 softmax, P rounded to the input dtype for P V with fp32
  accumulation, one division by the fp32 row sum.
* `mha_qkv_attention_bwd_reference` is the plain backward with K2's
  rounding points (those of the JAX `_bwd_kernel`; see the CUDA source).
* `LAUNCHES` counts kernel launches (never plain calls): "qkv_attention"
  for K1, "qkv_attention_bwd" for K2 (its two CUDA kernels count as one).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

_LANE = 128
_LOG2E = 1.4426950408889634

LAUNCHES: Dict[str, int] = {"qkv_attention": 0, "qkv_attention_bwd": 0}


def qkv_supported(num_heads: int, model_dim: int) -> bool:
    head_dim = model_dim // num_heads
    return head_dim in (64, 128) and model_dim % _LANE == 0


def _split_shape(qkv: torch.Tensor, num_heads: int):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, N, 3*H*D], got {tuple(qkv.shape)}")
    b, n, three_hd = qkv.shape
    hd = three_hd // 3
    if hd % num_heads:
        raise ValueError(f"width {hd} is not divisible by {num_heads} heads")
    return b, n, hd, hd // num_heads


def _kv_len(valid_len: Optional[int], n: int) -> int:
    kv_len = n if valid_len is None else int(valid_len)
    if not 1 <= kv_len <= n:
        raise ValueError(f"valid_len {valid_len} outside [1, {n}]")
    return kv_len


def mha_qkv_attention_reference(
    qkv: torch.Tensor,
    num_heads: int,
    *,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel; [B, N, 3*H*D] -> [B, N, H*D]."""
    b, n, hd, d = _split_shape(qkv, num_heads)
    kv_len = _kv_len(valid_len, n)
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    dtype = qkv.dtype
    to_heads = lambda x: x.reshape(b, n, num_heads, d).transpose(1, 2)
    q, k, v = (to_heads(x) for x in qkv.split(hd, dim=-1))
    q = (q.float() * (scale * _LOG2E)).to(dtype)
    k, v = k[:, :, :kv_len], v[:, :, :kv_len]  # keys >= valid_len are masked
    out = torch.empty(b, n, num_heads, d, dtype=dtype, device=qkv.device)
    for h in range(num_heads):  # one head at a time bounds the fp32 scores
        s = q[:, h].float() @ k[:, h].float().transpose(-1, -2)
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1, keepdim=True)
        o = p.to(dtype).float() @ v[:, h].float()
        out[:, :, h] = (o / denom).to(dtype)
    return out.reshape(b, n, hd)


def mha_qkv_attention_bwd_reference(
    qkv: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    *,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch backward of the kernel: dqkv [B, N, 3*H*D] in qkv's dtype.

    `out` is the forward's output and `dout` its gradient, both [B, N, H*D].
    The JAX kernel's rounding points, with D = rowsum(dO * O) in place of its
    rowsum(P * dP) * r (equal up to the rounding of O).  dk and dv of keys at
    or beyond `valid_len` are exactly 0.
    """
    b, n, hd, d = _split_shape(qkv, num_heads)
    kv_len = _kv_len(valid_len, n)
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    dtype = qkv.dtype
    to_heads = lambda x: x.reshape(b, n, num_heads, d).transpose(1, 2)
    q, k, v = (to_heads(x) for x in qkv.split(hd, dim=-1))
    qs = (q.float() * (scale * _LOG2E)).to(dtype)
    do, o = to_heads(dout.to(dtype)), to_heads(out.to(dtype))
    dqkv = torch.zeros(b, n, 3, num_heads, d, dtype=dtype, device=qkv.device)
    for h in range(num_heads):  # one head at a time bounds the fp32 scores
        kh, vh, doh = k[:, h, :kv_len].float(), v[:, h, :kv_len].float(), do[:, h].float()
        s = qs[:, h].float() @ kh.transpose(-1, -2)
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        r = 1.0 / p.sum(dim=-1, keepdim=True)
        dp = doh @ vh.transpose(-1, -2)
        dc = (doh * o[:, h].float()).sum(dim=-1, keepdim=True)
        ds = (p * (dp - dc) * (scale * r)).to(dtype).float()
        dqkv[:, :, 0, h] = (ds @ kh).to(dtype)
        dqkv[:, :kv_len, 1, h] = (ds.transpose(-1, -2) @ q[:, h].float()).to(dtype)
        dor = (doh * r).to(dtype).float()
        dqkv[:, :kv_len, 2, h] = (p.to(dtype).float().transpose(-1, -2) @ dor).to(dtype)
    return dqkv.reshape(b, n, 3 * hd)


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    """A kernel's C entry point, compiled at first use."""
    from denseclip_vit_multimodal_tpu_torch.ops._build import load_library

    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "qkv_attention":
        fn = load_library("qkv_attention").qkv_attention_bf16
        fn.argtypes = [ptr, ptr, ptr] + [i] * 5 + [f, ptr]
    else:
        fn = load_library("qkv_attention_bwd").qkv_attention_bwd_bf16
        fn.argtypes = [ptr] * 6 + [i] * 5 + [f, f, ptr]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_input(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the qkv attention kernels take bfloat16 {what}, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"the qkv attention kernels take a contiguous, 16-byte aligned {what}")


def _launch(qkv: torch.Tensor, num_heads: int, scale: float, kv_len: int,
            with_stats: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1; with `with_stats` it also returns each row's (max, sum) for K2."""
    b, n, hd, d = _split_shape(qkv, num_heads)
    _check_kernel_input(qkv, "qkv")
    if d not in (64, 128):
        raise ValueError(f"the qkv attention kernel takes head dim 64 or 128, got {d}")
    fn = _kernel_fn("qkv_attention")
    out = torch.empty(b, n, hd, dtype=qkv.dtype, device=qkv.device)
    stats = (torch.empty(b, num_heads, n, 2, dtype=torch.float32, device=qkv.device)
             if with_stats else None)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(
            qkv.data_ptr(), out.data_ptr(), None if stats is None else stats.data_ptr(),
            b, n, num_heads, d, kv_len, scale * _LOG2E, stream,
        )
    if err != 0:
        raise RuntimeError(f"qkv attention kernel launch failed: cudaError {err}")
    LAUNCHES["qkv_attention"] += 1
    return out, stats


def _launch_bwd(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor, stats: torch.Tensor,
                num_heads: int, scale: float, kv_len: int) -> torch.Tensor:
    """K2: dqkv from qkv, the forward output, its gradient and K1's row stats."""
    b, n, hd, d = _split_shape(qkv, num_heads)
    for x, what in ((qkv, "qkv"), (out, "output"), (dout, "output gradient")):
        _check_kernel_input(x, what)
    if out.shape != (b, n, hd) or dout.shape != (b, n, hd):
        raise ValueError(f"output / gradient must be {(b, n, hd)}, got {tuple(out.shape)}, "
                         f"{tuple(dout.shape)}")
    if stats is None or stats.shape != (b, num_heads, n, 2) or not stats.is_contiguous():
        raise ValueError("the backward kernel needs the forward kernel's row statistics")
    fn = _kernel_fn("qkv_attention_bwd")
    dqkv = torch.empty_like(qkv)
    dcoef = torch.empty(b, num_heads, n, dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(
            qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), stats.data_ptr(),
            dcoef.data_ptr(), dqkv.data_ptr(), b, n, num_heads, d, kv_len,
            scale * _LOG2E, scale, stream,
        )
    if err != 0:
        raise RuntimeError(f"qkv attention backward kernel launch failed: cudaError {err}")
    LAUNCHES["qkv_attention_bwd"] += 1
    return dqkv


class QKVAttentionFunction(torch.autograd.Function):
    """K1 forward, K2 backward (the JAX `_qkv_mha` custom VJP).

    On a CPU tensor both directions are the plain versions; on CUDA both are
    the kernels, with no fallback.  Saves qkv, the output and (CUDA) K1's row
    statistics.
    """

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int, scale: float, kv_len: int):
        if qkv.device.type == "cpu":
            out = mha_qkv_attention_reference(qkv, num_heads, sm_scale=scale, valid_len=kv_len)
            stats = None
        elif qkv.device.type == "cuda":
            out, stats = _launch(qkv, num_heads, scale, kv_len, with_stats=True)
        else:
            raise ValueError(f"no qkv attention for device {qkv.device}")
        ctx.save_for_backward(qkv, out, stats)
        ctx.attrs = (num_heads, scale, kv_len)
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        qkv, out, stats = ctx.saved_tensors
        num_heads, scale, kv_len = ctx.attrs
        if qkv.device.type == "cpu":
            dqkv = mha_qkv_attention_bwd_reference(qkv, out, dout, num_heads, sm_scale=scale,
                                                   valid_len=kv_len)
        else:
            dqkv = _launch_bwd(qkv, out, dout.contiguous(), stats, num_heads, scale, kv_len)
        return dqkv, None, None, None


def mha_qkv_attention(
    qkv: torch.Tensor,  # [B, N, 3*H*D] fused projection output
    num_heads: int,
    *,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Attention straight off the fused QKV projection; returns [B, N, H*D].

    Keys at or beyond `valid_len` (None: N) are masked; output rows past
    `valid_len` are computed against the valid keys and left to the caller.
    Differentiable through `QKVAttentionFunction` when autograd records it.
    """
    _, n, _, d = _split_shape(qkv, num_heads)
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    kv_len = _kv_len(valid_len, n)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return QKVAttentionFunction.apply(qkv, num_heads, scale, kv_len)
    if qkv.device.type == "cpu":
        return mha_qkv_attention_reference(qkv, num_heads, sm_scale=scale, valid_len=kv_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"no qkv attention for device {qkv.device}")
    return _launch(qkv, num_heads, scale, kv_len)[0]
