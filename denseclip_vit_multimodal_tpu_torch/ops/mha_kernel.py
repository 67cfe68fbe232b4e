"""Attention straight off the fused QKV projection: Hopper kernel + plain version.

Port of the JAX package's `ops/mha_kernel.py::mha_qkv_attention` (the TPU
kernel `_qkv_kernel`, K1).  The CUDA source is `csrc/qkv_attention.cu`; its
header note gives the design and the bound on an H100.

* `mha_qkv_attention` launches the kernel for a CUDA tensor, or raises on
  anything the kernel does not take.  For a tensor on the CPU it runs the
  plain version; there is no other way to reach the plain version.
* `mha_qkv_attention_reference` is the plain PyTorch version with the
  kernel's rounding points: q * (scale * log2 e) rounded to the input dtype,
  fp32 scores, exp2 softmax, P rounded to the input dtype for P V with fp32
  accumulation, one division by the fp32 row sum.
* `LAUNCHES["qkv_attention"]` counts kernel launches (never plain calls).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

_LANE = 128
_LOG2E = 1.4426950408889634

LAUNCHES: Dict[str, int] = {"qkv_attention": 0}


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


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernel's C entry point, compiled at first use."""
    from denseclip_vit_multimodal_tpu_torch.ops._build import load_library

    fn = load_library("qkv_attention").qkv_attention_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(qkv: torch.Tensor, num_heads: int, scale: float, kv_len: int) -> torch.Tensor:
    b, n, hd, d = _split_shape(qkv, num_heads)
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the qkv attention kernel takes bfloat16, got {qkv.dtype}")
    if d not in (64, 128):
        raise ValueError(f"the qkv attention kernel takes head dim 64 or 128, got {d}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the qkv attention kernel takes a contiguous, 16-byte aligned qkv")
    fn = _kernel_fn()
    out = torch.empty(b, n, hd, dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(
            qkv.data_ptr(), out.data_ptr(), b, n, num_heads, d, kv_len,
            scale * _LOG2E, stream,
        )
    if err != 0:
        raise RuntimeError(f"qkv attention kernel launch failed: cudaError {err}")
    LAUNCHES["qkv_attention"] += 1
    return out


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
    """
    _, n, _, d = _split_shape(qkv, num_heads)
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    kv_len = _kv_len(valid_len, n)
    if qkv.device.type == "cpu":
        return mha_qkv_attention_reference(qkv, num_heads, sm_scale=scale, valid_len=kv_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"no qkv attention for device {qkv.device}")
    return _launch(qkv, num_heads, scale, kv_len)
