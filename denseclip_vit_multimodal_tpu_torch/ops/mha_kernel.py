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
  for K1, "qkv_attention_bwd" for K2 (its two CUDA kernels count as one),
  "qkv_attention_int8" for K5, "mha_attention" for K3 and
  "mha_attention_bwd" for K3's backward.

The one-shot attention on [B, N, H, D] ports the JAX `mha_attention`, its
TPU kernel `_kernel` (K3, `csrc/mha_attention.cu`, which shares K1's device
code in `csrc/attention_fwd.cuh`) and its custom VJP `_mha_bwd` ->
`_mha_bwd_pallas` -> `_bwd_kernel` (K3's backward: K2's template in
`csrc/qkv_attention_bwd.cu`, reading q / k / v / O / dO by stride):

* `mha_attention` launches K3 for CUDA tensors, reading q / k / v by stride
  (views of the fused projection need no copy), or raises on anything the
  kernel does not take; for CPU tensors it runs `mha_attention_reference`.
  When autograd records the call it goes through `MHAAttentionFunction`:
  K3 then also writes each row's max and sum, and the backward is K3's
  backward on CUDA, `mha_attention_bwd_reference` on the CPU.
* `mha_attention_reference` has K3's rounding points, which are K1's;
  `mha_attention_bwd_reference` has the JAX `_bwd_kernel`'s (K2's plain
  backward is this function on the three column blocks of qkv).  With a
  caller's `valid_len` the pad keys are masked and get dk = dv = 0 exactly,
  and the pad query rows still contribute their dO.

The opt-in int8 serving path (`tpu.attn_impl: int8`) ports the JAX
`mha_qkv_attention_int8` and its TPU kernel `_qkv_int8_kernel` (K5,
`csrc/qkv_attention_int8.cu`):

* `quantize_qkv_int8` is the JAX prologue with its exact arithmetic
  (symmetric per-(batch, q/k/v, head) scales), plus the clamp to [-128, 127]
  that JAX's saturating cast does implicitly (torch's cast wraps).
* `int8_attention_plain` is the kernel body in plain PyTorch; both products
  are exact (fp64 holds every int32 sum), so only exp2 ulps and the order of
  the fp32 denominator sum separate it from the kernel.
* `mha_qkv_attention_int8` launches K5 for a CUDA tensor and runs the plain
  version for a CPU tensor.  When autograd records it, the backward is the
  JAX straight-through one (`Int8AttentionFunction`): the bf16 backward of
  the unquantized qkv, i.e. K1's forward for the row statistics and K2 (the
  plain versions on the CPU).

The JAX package's softmax knobs `DENSECLIP_EXP_BF16` (a bf16 exp2 pass in K1
and K3) and `DENSECLIP_FAST_EXP2` (a polynomial exp2 in K1, K2, K3 and K7)
are not honoured: the port's kernels and plain versions keep the fp32 exp2.
Rather than ignore them, every wrapper whose JAX counterpart reads one
raises `ValueError` naming the variable when it is set to 1
(`refuse_softmax_knobs`, read on every call).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, Optional, Tuple

import torch

_LANE = 128
_LOG2E = 1.4426950408889634

LAUNCHES: Dict[str, int] = {"qkv_attention": 0, "qkv_attention_bwd": 0, "qkv_attention_int8": 0,
                            "mha_attention": 0, "mha_attention_bwd": 0}
EXP_BF16_ENV = "DENSECLIP_EXP_BF16"
FAST_EXP2_ENV = "DENSECLIP_FAST_EXP2"
_REF_CHUNK = 4096  # query rows per step of the one-shot kernels' plain versions
# K5 accumulates P V in int32: at most this many keys of p8 <= 127 times |v8| <= 128
INT8_MAX_KEYS = (2**31 - 1) // (127 * 128)
_INT8_CHUNK = 4096  # query rows per step of the int8 plain version
_V_ALIGN = 16  # K5 reads V key-major in 16-byte chunks: rows padded to this many keys


def refuse_softmax_knobs(*names: str) -> None:
    """ValueError if one of the JAX package's softmax knobs `names` (default
    both) is set to 1: the port keeps the fp32 exp2 softmax."""
    for name in names or (EXP_BF16_ENV, FAST_EXP2_ENV):
        if os.environ.get(name, "0") == "1":
            raise ValueError(f"{name}=1 is not ported: the PyTorch port's attention kernels "
                             "and plain versions keep the fp32 exp2 softmax; unset it")


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


def attention_prescaled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: int) -> torch.Tensor:
    """The one-shot kernels' attention in plain PyTorch, on a q already
    multiplied by scale * log2 e and rounded to its dtype.

    q, k, v [B, N, H, D] (strided views welcome) -> [B, N, H, D] in q's
    dtype: fp32 scores against the first `kv_len` keys (the kernels mask the
    rest), exp2 softmax, P rounded to q's dtype for P V with fp32
    accumulation, one division by the fp32 row sum.  One head and at most
    `_REF_CHUNK` query rows at a time bound the fp32 scores.
    """
    b, n, heads, d = q.shape
    dtype = q.dtype
    out = torch.empty(b, n, heads, d, dtype=dtype, device=q.device)
    for h in range(heads):
        kh, vh = k[:, :kv_len, h].float(), v[:, :kv_len, h].float()
        for r0 in range(0, n, _REF_CHUNK):
            r1 = min(r0 + _REF_CHUNK, n)
            s = q[:, r0:r1, h].float() @ kh.transpose(-1, -2)
            p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
            denom = p.sum(dim=-1, keepdim=True)
            o = p.to(dtype).float() @ vh
            out[:, r0:r1, h] = (o / denom).to(dtype)
    return out


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
    q, k, v = (x.view(b, n, num_heads, d) for x in qkv.split(hd, dim=-1))
    q = (q.float() * (scale * _LOG2E)).to(qkv.dtype)
    return attention_prescaled(q, k, v, kv_len).reshape(b, n, hd)


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

    `out` is the forward's output and `dout` its gradient, both [B, N, H*D]:
    `mha_attention_bwd_reference` on the three column blocks of qkv.  dk and
    dv of keys at or beyond `valid_len` are exactly 0.
    """
    b, n, hd, d = _split_shape(qkv, num_heads)
    heads = lambda x: x.reshape(b, n, num_heads, d)
    q, k, v = (heads(x) for x in qkv.split(hd, dim=-1))
    grads = mha_attention_bwd_reference(q, k, v, heads(out), heads(dout), sm_scale=sm_scale,
                                        valid_len=valid_len)
    return torch.cat([g.reshape(b, n, hd) for g in grads], dim=-1)


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    """A kernel's C entry point, compiled at first use."""
    from denseclip_vit_multimodal_tpu_torch.ops._build import load_library

    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "qkv_attention":
        fn = load_library("qkv_attention").qkv_attention_bf16
        fn.argtypes = [ptr, ptr, ptr] + [i] * 5 + [f, ptr]
    elif name == "mha_attention":
        fn = load_library("mha_attention").mha_attention_bf16
        fn.argtypes = [ptr] * 5 + [ctypes.c_longlong] * 9 + [i] * 5 + [f, ptr]
    elif name == "mha_attention_bwd":
        fn = load_library("qkv_attention_bwd").mha_attention_bwd_bf16
        fn.argtypes = [ptr] * 10 + [ctypes.c_longlong] * 9 + [i] * 5 + [f, f, ptr]
    elif name == "qkv_attention_int8":
        fn = load_library("qkv_attention_int8").qkv_attention_int8
        fn.argtypes = [ptr] * 4 + [i] * 7 + [f, ptr]
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
    refuse_softmax_knobs()
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


# --------------------------------------------------------------------------
# One-shot attention on [B, N, H, D] (K3)
# --------------------------------------------------------------------------


def check_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid_len: Optional[int]) -> Tuple[int, int]:
    """(N, kv_len) of q / k / v [B, N, H, D] of one shape, or ValueError."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must all be [B, N, H, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    n = q.shape[1]
    return n, _kv_len(valid_len, n)


def bnhd_strides(x: torch.Tensor, what: str, kernel: str) -> Tuple[int, int, int]:
    """The batch / token / head strides (elements) of a [B, N, H, D] operand
    that the strided kernels (K3, K4) read, or TypeError / ValueError."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the {kernel} kernel takes bfloat16 {what}, got {x.dtype}")
    sb, sn, sh, sd = x.stride()
    if sd != 1 or x.data_ptr() % 16 or any(s % 8 for s in (sb, sn, sh)):
        raise ValueError(f"the {kernel} kernel takes a {what} with unit stride over the "
                         "head dim, 16-byte aligned, and other strides multiples of 8 elements")
    return sb, sn, sh


def mha_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K3; [B, N, H, D] -> [B, N, H, D] in q's dtype.

    K3's rounding points (the JAX `_kernel`): q * (scale * log2 e) rounded to
    the input dtype (the constant kept in fp32, as for K1), fp32 scores,
    keys at or beyond `valid_len` masked, exp2 softmax, P rounded to the
    input dtype for P V with fp32 accumulation, one division.
    """
    _, kv_len = check_bnhd(q, k, v, valid_len)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    qs = (q.float() * (scale * _LOG2E)).to(q.dtype)
    return attention_prescaled(qs, k, v, kv_len)


def mha_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of K3: (dq, dk, dv) [B, N, H, D] in q's dtype.

    `out` is the forward's output and `dout` its gradient.  The JAX
    `_bwd_kernel`'s rounding points: qs = q * (scale * log2 e) rounded to the
    input dtype, s = qs k^T in fp32, p = exp2(s - max), r = 1 / rowsum(p),
    ds = p * (dp - D) * (scale * r) rounded, dq = ds k, dk = ds^T q, dv =
    round(p)^T round(dO * r), with D = rowsum(dO * O) in place of the
    kernel's rowsum(P * dP) * r (equal up to the rounding of O).  Keys at or
    beyond `valid_len` get dk = dv = 0 exactly; every query row (pad rows
    too) contributes its dO.
    """
    _, kv_len = check_bnhd(q, k, v, valid_len)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    dtype = q.dtype
    qs = (q.float() * (scale * _LOG2E)).to(dtype)
    dq, dk, dv = (torch.zeros(q.shape, dtype=dtype, device=q.device) for _ in range(3))
    for h in range(q.shape[2]):  # one head at a time bounds the fp32 scores
        kh, vh = k[:, :kv_len, h].float(), v[:, :kv_len, h].float()
        doh = dout[:, :, h].to(dtype).float()
        s = qs[:, :, h].float() @ kh.transpose(-1, -2)
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        r = 1.0 / p.sum(dim=-1, keepdim=True)
        dp = doh @ vh.transpose(-1, -2)
        dc = (doh * out[:, :, h].to(dtype).float()).sum(dim=-1, keepdim=True)
        ds = (p * (dp - dc) * (scale * r)).to(dtype).float()
        dq[:, :, h] = (ds @ kh).to(dtype)
        dk[:, :kv_len, h] = (ds.transpose(-1, -2) @ q[:, :, h].float()).to(dtype)
        dor = (doh * r).to(dtype).float()
        dv[:, :kv_len, h] = (p.to(dtype).float().transpose(-1, -2) @ dor).to(dtype)
    return dq, dk, dv


def bnhd_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kernel: str,
              head_dims: Tuple[int, ...]) -> list:
    """The nine strides (batch / token / head of q, k, v) a strided kernel
    (K3, K4 and their backwards) reads, or TypeError / ValueError."""
    strides = [s for x, what in ((q, "q"), (k, "k"), (v, "v"))
               for s in bnhd_strides(x, what, kernel)]
    if q.shape[-1] not in head_dims:
        raise ValueError(f"the {kernel} kernel takes head dim "
                         f"{' or '.join(map(str, head_dims))}, got {q.shape[-1]}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    return strides


def _launch_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                kv_len: int, stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 on CUDA tensors; returns a contiguous [B, N, H, D] bf16 output.
    With `stats` (fp32 [B, H, N, 2]) it also writes each row's max and sum."""
    b, n, heads, d = q.shape
    strides = bnhd_args(q, k, v, "one-shot attention", (64, 128, 256))
    if stats is not None and (stats.shape != (b, heads, n, 2) or stats.dtype != torch.float32
                              or not stats.is_contiguous() or stats.device != q.device):
        raise ValueError(f"stats must be a contiguous fp32 {(b, heads, n, 2)} on q's device")
    fn = _kernel_fn("mha_attention")
    out = torch.empty(b, n, heads, d, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if stats is None else stats.data_ptr(), *strides,
                 b, n, heads, d, kv_len, scale * _LOG2E, stream)
    if err != 0:
        raise RuntimeError(f"one-shot attention kernel launch failed: cudaError {err}")
    LAUNCHES["mha_attention"] += 1
    return out


def _launch_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                    dout: torch.Tensor, stats: torch.Tensor, scale: float, kv_len: int):
    """K3's backward: (dq, dk, dv), contiguous [B, N, H, D] bf16, from the
    strided q / k / v, K3's output, its gradient and K3's row statistics."""
    b, n, heads, d = q.shape
    strides = bnhd_args(q, k, v, "one-shot attention backward", (64, 128))
    for x, what in ((out, "output"), (dout, "output gradient")):
        if x.shape != q.shape:
            raise ValueError(f"{what} must be {tuple(q.shape)}, got {tuple(x.shape)}")
        _check_kernel_input(x, what)
    if stats is None or stats.shape != (b, heads, n, 2) or not stats.is_contiguous():
        raise ValueError("the backward kernel needs the forward kernel's row statistics")
    fn = _kernel_fn("mha_attention_bwd")
    dq, dk, dv = (torch.empty(b, n, heads, d, dtype=q.dtype, device=q.device) for _ in range(3))
    dcoef = torch.empty(b, heads, n, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 stats.data_ptr(), dcoef.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 *strides, b, n, heads, d, kv_len, scale * _LOG2E, scale, stream)
    if err != 0:
        raise RuntimeError(f"one-shot attention backward kernel launch failed: cudaError {err}")
    LAUNCHES["mha_attention_bwd"] += 1
    return dq, dk, dv


class MHAAttentionFunction(torch.autograd.Function):
    """K3 forward, K3's backward (the JAX `_mha` custom VJP).

    On CPU tensors both directions are the plain versions; on CUDA both are
    the kernels, with no fallback.  Saves q, k, v, the output and (CUDA)
    K3's row statistics.
    """

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                kv_len: int):
        if q.device.type == "cpu":
            out = mha_attention_reference(q, k, v, sm_scale=scale, valid_len=kv_len)
            stats = None
        elif q.device.type == "cuda":
            b, n, heads, d = q.shape
            if d not in (64, 128):  # refused before the forward, not after it
                raise ValueError(f"the one-shot attention backward takes head dim 64 or 128, "
                                 f"got {d}")
            stats = torch.empty(b, heads, n, 2, dtype=torch.float32, device=q.device)
            out = _launch_mha(q, k, v, scale, kv_len, stats)
        else:
            raise ValueError(f"no one-shot attention for device {q.device}")
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.attrs = (scale, kv_len)
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        q, k, v, out, stats = ctx.saved_tensors
        scale, kv_len = ctx.attrs
        if q.device.type == "cpu":
            grads = mha_attention_bwd_reference(q, k, v, out, dout, sm_scale=scale,
                                                valid_len=kv_len)
        else:
            grads = _launch_mha_bwd(q, k, v, out, dout.to(q.dtype).contiguous(), stats, scale,
                                    kv_len)
        return (*grads, None, None)


def mha_attention(
    q: torch.Tensor,  # [B, N, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """One-shot attention; [B, N, H, D] in and out.  Exact, any N.

    Keys at or beyond `valid_len` (None: N) are masked; output rows past it
    are computed against the valid keys and left to the caller.
    Differentiable through `MHAAttentionFunction` when autograd records it.
    """
    refuse_softmax_knobs()
    _, kv_len = check_bnhd(q, k, v, valid_len)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return MHAAttentionFunction.apply(q, k, v, scale, kv_len)
    if q.device.type == "cpu":
        return mha_attention_reference(q, k, v, sm_scale=scale, valid_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no one-shot attention for device {q.device}")
    return _launch_mha(q, k, v, scale, kv_len)


# --------------------------------------------------------------------------
# Opt-in int8 attention (K5)
# --------------------------------------------------------------------------


def _f32(x: torch.Tensor, value: float) -> torch.Tensor:
    """`value` rounded to fp32 (as JAX's weak typing rounds a Python float
    against fp32), as a tensor like `x`: dividing by it is a true division
    (CUDA turns division by a Python scalar into a reciprocal multiply, one
    rounding more)."""
    return torch.full_like(x, value, dtype=torch.float32)


def quantize_qkv_int8(
    qkv: torch.Tensor, num_heads: int, valid_len: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX prologue of the int8 path: (q8 [B, N, 3*H*D] int8, scales [B, 3, H] fp32).

    Rows at or past `valid_len` are zeroed first (a select, so that inf or
    NaN padding cannot reach the scales).  amax over (tokens, head dim) of
    each (batch, q/k/v, head) in the input dtype; scales = max(amax, 1e-6) /
    127 in fp32; inv = 127 / max(amax, 1e-6) rounded to the input dtype;
    q8 = rint(x * inv) in the input dtype, clamped to [-128, 127] (the
    element at amax can round to 128, which JAX's cast saturates to 127 and
    torch's would wrap to -128).
    """
    b, n, hd, d = _split_shape(qkv, num_heads)
    kv_len = _kv_len(valid_len, n)
    x = qkv
    if kv_len < n:
        row = torch.arange(n, device=qkv.device) < kv_len
        x = torch.where(row[None, :, None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    grouped = x.reshape(b, n, 3, num_heads, d)
    floor = torch.tensor(1e-6, dtype=torch.float32, device=qkv.device)
    amax = torch.maximum(grouped.abs().amax(dim=(1, 4)).float(), floor)
    scales = amax / _f32(amax, 127.0)
    inv = (_f32(amax, 127.0) / amax).to(x.dtype)
    q8 = torch.round(grouped * inv[:, None, :, :, None]).clamp_(-128, 127).to(torch.int8)
    return q8.reshape(b, n, 3 * hd), scales


def int8_attention_plain(
    q8: torch.Tensor,
    scales: torch.Tensor,
    num_heads: int,
    sm_scale: float,
    kv_len: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain PyTorch version of K5 on quantized operands; [B, N, H*D] in `out_dtype`.

    The TPU kernel's arithmetic: s = q8 k8^T (exact); sf = s * (((sq * sk) *
    scale) * log2 e) in fp32; P = exp2(sf - max) in fp32 over the valid keys
    (the kernel's fp32-min mask gives masked keys exactly 0 there, so they are
    left out); the fp32 denominator from the unquantized P; p8 = trunc(P * 127
    + 0.5); o = p8 v8 (exact); out = (float(o) * (sv / 127)) / max(denom,
    1e-20).  One head and at most 4096 query rows at a time.
    """
    b, n, hd, d = _split_shape(q8, num_heads)
    g = q8.view(b, n, 3, num_heads, d)
    sq, sk, sv = scales.unbind(dim=1)  # [B, H] each
    mult = ((sq * sk) * _f32(sq, sm_scale)) * _f32(sq, _LOG2E)
    sv127 = sv / _f32(sv, 127.0)
    out = torch.empty(b, n, num_heads, d, dtype=out_dtype, device=q8.device)
    for h in range(num_heads):
        kh = g[:, :kv_len, 1, h].double()
        vh = g[:, :kv_len, 2, h].double()
        for r0 in range(0, n, _INT8_CHUNK):
            r1 = min(r0 + _INT8_CHUNK, n)
            s = (g[:, r0:r1, 0, h].double() @ kh.transpose(-1, -2)).float()
            sf = s * mult[:, h, None, None]
            p = torch.exp2(sf - sf.amax(dim=-1, keepdim=True))
            denom = p.sum(dim=-1, keepdim=True)
            p8 = torch.trunc(p * 127.0 + 0.5)
            o = (p8.double() @ vh).float()
            out[:, r0:r1, h] = ((o * sv127[:, h, None, None]) / denom.clamp_min(1e-20)).to(out_dtype)
    return out.reshape(b, n, hd)


def mha_qkv_attention_int8_reference(
    qkv: torch.Tensor,
    num_heads: int,
    *,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the int8 path: prologue, then the kernel body."""
    _, n, _, d = _split_shape(qkv, num_heads)
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    kv_len = _kv_len(valid_len, n)
    q8, scales = quantize_qkv_int8(qkv, num_heads, kv_len)
    return int8_attention_plain(q8, scales, num_heads, scale, kv_len, qkv.dtype)


def value_key_major(q8: torch.Tensor, num_heads: int) -> torch.Tensor:
    """V of every head key-major, [B, H, D, N'] int8 with N' = N rounded up
    to 16 (zero-filled): K5's B operand of P V takes four consecutive keys of
    one head dim per 32-bit register."""
    b, n, hd, d = _split_shape(q8, num_heads)
    ldv = -(-n // _V_ALIGN) * _V_ALIGN
    vt = q8.new_zeros(b, num_heads, d, ldv)
    vt[..., :n] = q8[..., 2 * hd:].view(b, n, num_heads, d).permute(0, 2, 3, 1)
    return vt


def _launch_int8(q8: torch.Tensor, vt: torch.Tensor, scales: torch.Tensor, num_heads: int,
                 scale: float, kv_len: int, out_dtype: torch.dtype) -> torch.Tensor:
    """K5 on the prologue's operands; returns [B, N, H*D] in `out_dtype`."""
    b, n, hd, d = _split_shape(q8, num_heads)
    if q8.dtype != torch.int8 or not q8.is_contiguous() or q8.data_ptr() % 16:
        raise ValueError("the int8 attention kernel takes a contiguous, 16-byte aligned int8 q8")
    if d not in (64, 128):
        raise ValueError(f"the int8 attention kernel takes head dim 64 or 128, got {d}")
    ldv = -(-n // _V_ALIGN) * _V_ALIGN
    if (vt.dtype != torch.int8 or tuple(vt.shape) != (b, num_heads, d, ldv)
            or not vt.is_contiguous() or vt.data_ptr() % 16):
        raise ValueError(f"the int8 attention kernel takes V as contiguous int8 "
                         f"{(b, num_heads, d, ldv)} (value_key_major)")
    if (scales.dtype != torch.float32 or tuple(scales.shape) != (b, 3, num_heads)
            or not scales.is_contiguous()):
        raise ValueError(f"the int8 attention kernel takes fp32 scales {(b, 3, num_heads)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the int8 attention kernel writes bfloat16 or float32, not {out_dtype}")
    if not (q8.device == vt.device == scales.device):
        raise ValueError("q8, V and the scales must be on one device")
    fn = _kernel_fn("qkv_attention_int8")
    out = torch.empty(b, n, hd, dtype=out_dtype, device=q8.device)
    with torch.cuda.device(q8.device):
        stream = torch.cuda.current_stream(q8.device).cuda_stream
        err = fn(q8.data_ptr(), vt.data_ptr(), scales.data_ptr(), out.data_ptr(),
                 int(out_dtype == torch.bfloat16), b, n, num_heads, d, kv_len, ldv, scale, stream)
    if err != 0:
        raise RuntimeError(f"int8 attention kernel launch failed: cudaError {err}")
    LAUNCHES["qkv_attention_int8"] += 1
    return out


class Int8AttentionFunction(torch.autograd.Function):
    """K5 forward, the JAX straight-through backward (`_qkv_mha_int8`'s VJP
    is `_qkv_bwd`): the bf16 backward of the UNQUANTIZED qkv.  On CUDA that
    is K1's forward for the output and row statistics K2 reads, then K2; on
    the CPU the plain versions.  Saves qkv only, as the JAX VJP does."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int, scale: float, kv_len: int):
        ctx.save_for_backward(qkv)
        ctx.attrs = (num_heads, scale, kv_len)
        return _int8_forward(qkv, num_heads, scale, kv_len)

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        num_heads, scale, kv_len = ctx.attrs
        if qkv.device.type == "cpu":
            out = mha_qkv_attention_reference(qkv, num_heads, sm_scale=scale, valid_len=kv_len)
            dqkv = mha_qkv_attention_bwd_reference(qkv, out, dout, num_heads, sm_scale=scale,
                                                   valid_len=kv_len)
        else:
            out, stats = _launch(qkv, num_heads, scale, kv_len, with_stats=True)
            dqkv = _launch_bwd(qkv, out, dout.to(qkv.dtype).contiguous(), stats, num_heads,
                               scale, kv_len)
        return dqkv, None, None, None


def _int8_forward(qkv: torch.Tensor, num_heads: int, scale: float, kv_len: int) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return mha_qkv_attention_int8_reference(qkv, num_heads, sm_scale=scale, valid_len=kv_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"no int8 qkv attention for device {qkv.device}")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the int8 attention path takes bfloat16 or float32 qkv, got {qkv.dtype}")
    q8, scales = quantize_qkv_int8(qkv, num_heads, kv_len)
    return _launch_int8(q8, value_key_major(q8, num_heads), scales, num_heads, scale, kv_len,
                        qkv.dtype)


def mha_qkv_attention_int8(
    qkv: torch.Tensor,  # [B, N, 3*H*D] fused projection output
    num_heads: int,
    *,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Quantized attention straight off the fused projection; [B, N, H*D] in qkv's dtype.

    The opt-in serving path (`tpu.attn_impl: int8`): int8 Q K^T and P V with
    int32 sums, fp32 softmax.  Keys at or beyond `valid_len` are masked and
    left out of the scales; output rows past `valid_len` are left to the
    caller.  Differentiable, straight through, when autograd records it
    (`Int8AttentionFunction`).
    """
    _, n, _, d = _split_shape(qkv, num_heads)
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    kv_len = _kv_len(valid_len, n)
    if kv_len > INT8_MAX_KEYS:
        raise ValueError(f"int32 sums of P V hold at most {INT8_MAX_KEYS} keys, got {kv_len}")
    if torch.is_grad_enabled() and qkv.requires_grad:
        refuse_softmax_knobs(FAST_EXP2_ENV)  # the JAX backward's `_bwd_kernel` reads it
        return Int8AttentionFunction.apply(qkv, num_heads, scale, kv_len)
    return _int8_forward(qkv, num_heads, scale, kv_len)
