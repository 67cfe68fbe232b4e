"""Attention on [B, N, H, D]: the long-sequence flash kernel (K4) and its dispatch.

Port of the JAX package's `ops/attention.py`.  There, `flash_attention`
sends non-causal sequences of at most 8448 tokens to its one-shot kernel
(`ops/mha_kernel.py::mha_attention`, K3) and everything else (causal, or
longer: the 1.25 / 1.5 / 1.75 scales of multi-scale evaluation) to the
bundled Pallas flash kernel (K4).  Here:

* `flash_attention` follows the same dispatch.  The K3 branch runs
  `ops/mha_kernel.py::mha_attention`: K3 (`csrc/mha_attention.cu`) for
  CUDA tensors, its plain version for CPU tensors; while autograd records,
  it takes plain attention (`plain_attention`), since K3's backward is not
  ported.  The K4 branch launches `csrc/flash_attention.cu` for a CUDA
  tensor, or raises on anything the kernel does not take; for a tensor on
  the CPU it runs the plain version.  At head dim 256, which K4 does not
  take yet, it keeps plain attention.  q / k / v may be strided views (the
  split of the fused qkv projection, row stride 3*H*D): both kernels read
  them by stride, with no copy.
* `flash_attention_reference` is the plain PyTorch version of K4 with the
  bundled kernel's rounding points (see the CUDA source), one head at a time
  and chunked over query rows, so that it runs at N = 25216 without a
  [N, N] score tensor per head.
* `plain_attention` is the counterpart of the JAX package's `_xla_attention`
  (fp32 scores and softmax over the whole row).
* `LAUNCHES["flash_attention"]` counts K4's launches (never plain calls).

Output rows at or beyond `valid_len` are unspecified but finite (they are
computed against the valid keys); callers slice them off.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
    bnhd_strides,
    check_bnhd,
    mha_attention,
)

# Below this sequence length plain attention serves (JAX package
# `_FLASH_MIN_SEQ`); non-causal sequences up to `_ONESHOT_MAX_SEQ` take the
# one-shot kernels (K1 off the fused qkv, K3 otherwise).
_FLASH_MIN_SEQ = 1024
_ONESHOT_MAX_SEQ = 8448
_REF_CHUNK = 4096  # query rows per step of the plain version

LAUNCHES: Dict[str, int] = {"flash_attention": 0}


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


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """K4's C entry point, compiled at first use."""
    from denseclip_vit_multimodal_tpu_torch.ops._build import load_library

    ptr, i64, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fn = load_library("flash_attention").flash_attention_bf16
    fn.argtypes = [ptr] * 4 + [i64] * 9 + [i] * 6 + [f, ptr]
    fn.restype = ctypes.c_int
    return fn


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float,
            kv_len: int) -> torch.Tensor:
    """K4 on CUDA tensors; returns a contiguous [B, N, H, D] bf16 output."""
    b, n, heads, d = q.shape
    strides = [s for x, what in ((q, "q"), (k, "k"), (v, "v"))
               for s in bnhd_strides(x, what, "flash attention")]
    if d not in (64, 128):
        raise ValueError(f"the flash attention kernel takes head dim 64 or 128, got {d}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    fn = _kernel_fn()
    out = torch.empty(b, n, heads, d, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
                 b, n, heads, d, kv_len, int(causal), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    return out


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
    (`mha_attention`; plain attention while autograd records, until K3's
    backward is ported); causal, or N > 8448 -> K4 (plain attention at head
    dim 256, which K4 does not take yet).  `valid_len` masks trailing pad
    keys; output rows [valid_len, N) are unspecified.  The K4 branch is
    inference only: K4 has no backward yet.
    """
    n, kv_len = check_bnhd(q, k, v, valid_len)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    if not causal and n <= _ONESHOT_MAX_SEQ:
        if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
            return plain_attention(q, k, v, False, valid_len, sm_scale=scale)
        return mha_attention(q, k, v, sm_scale=scale, valid_len=kv_len)
    if q.shape[-1] == 256:
        return plain_attention(q, k, v, causal, valid_len, sm_scale=scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, sm_scale=scale,
                                         valid_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError("the flash attention kernel's backward (K4b) is not ported")
    return _launch(q, k, v, causal, scale, kv_len)
