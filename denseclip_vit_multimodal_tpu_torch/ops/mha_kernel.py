"""Attention straight off the fused QKV projection: Hopper kernels + plain versions.

Port of the JAX package's `ops/mha_kernel.py::mha_qkv_attention`: the TPU
kernel `_qkv_kernel` (K1, forward; `csrc/qkv_attention.cu`) and its custom
VJP `_qkv_bwd` -> `_mha_bwd_pallas` -> `_bwd_kernel` (K2, backward;
`csrc/qkv_attention_bwd.cu` on the backward core `csrc/attention_bwd.cuh`).
Each source's (or core's) header note gives its design and its bound on an
H100.

* `mha_qkv_attention` calls the op `denseclip_torch::qkv_attention`
  (`ops/_library.py`): for a CUDA tensor it launches the forward kernel, or
  raises on anything the kernel does not take; for a tensor on the CPU it
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
  "qkv_attention_int8" for K5, "quantize_qkv_int8" for its prologue (two
  CUDA kernels, one count), "mha_attention" for K3 and "mha_attention_bwd"
  for K3's backward; the same names with "_fp32" for the fp32 kernels of
  K1, K2, K3 and K3's backward.  Each forward launch also hands its FLOPs
  to `utils/flops.py::record_kernel_flops` (the prologue 0), for MFU.

The kernels take bf16 and fp32, as the TPU kernels do (JAX's dispatch asks
nothing about the dtype): a bf16 tensor launches the tensor-core kernels
(`csrc/qkv_attention.cu`, `csrc/mha_attention.cu`, `csrc/qkv_attention_bwd.cu`),
an fp32 one the fp32 kernels (`csrc/attention_fp32.cu`: SIMT, every product
an fp32 FMA; `csrc/attention_bwd_fp32.cu`: 3xTF32 on the tensor cores, fp32
accurate), and any other dtype raises `TypeError` naming the two.  The plain versions take
either; in fp32 their roundings to the input dtype are exact.

The one-shot attention on [B, N, H, D] ports the JAX `mha_attention`, its
TPU kernel `_kernel` (K3, `csrc/mha_attention.cu`, which shares K1's device
code in `csrc/attention_fwd.cuh`) and its custom VJP `_mha_bwd` ->
`_mha_bwd_pallas` -> `_bwd_kernel` (K3's backward: the backward core with
K2's numerics, `csrc/qkv_attention_bwd.cu`, reading q / k / v / O / dO by
stride; head dim 64, 128 or 256, as K3):

* `mha_attention` calls the op `denseclip_torch::mha_attention`: K3 for CUDA
  tensors, reading q / k / v by stride (views of the fused projection need
  no copy), or a raise on anything the kernel does not take;
  `mha_attention_reference` for CPU tensors.
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
`csrc/qkv_attention_int8.cu`), and the XLA prologue beside it
(`csrc/quantize_qkv_int8.cu`, the quantization and V's key-major copy in
two launches):

* `quantize_qkv_int8` is the JAX prologue with its exact arithmetic
  (symmetric per-(batch, q/k/v, head) scales), plus the clamp to [-128, 127]
  that JAX's saturating cast does implicitly (torch's cast wraps);
  `value_key_major` is V's key-major copy K5 reads.  Together they are the
  prologue kernel's plain version, bit for bit.
* `int8_attention_plain` is the kernel body in plain PyTorch; both products
  are exact (fp64 holds every int32 sum), so only exp2 ulps and the order of
  the fp32 denominator sum separate it from the kernel.
* `mha_qkv_attention_int8` calls the ops `denseclip_torch::quantize_qkv_int8`
  and `denseclip_torch::qkv_attention_int8`: the prologue kernel and K5 for
  a CUDA tensor, the plain versions for a CPU tensor.  When autograd
  records it, the backward is the JAX straight-through one
  (`Int8AttentionFunction`): the bf16 backward of the unquantized qkv, i.e.
  K1's forward for the row statistics and K2 (the plain versions on the
  CPU).

The JAX package's softmax knobs, read on every call as JAX reads its
import-time constants (`softmax_modes`): `DENSECLIP_FAST_EXP2=1` (the cubic
polynomial exp2 `exp2_poly` wherever JAX's `_exp2` sees an fp32 argument: K1,
K2, K3, K3's backward, K6 and K7, bf16 and fp32) and `DENSECLIP_EXP_BF16=1`
(the bf16 exp2 pass of K1's mask branch and K3, bf16 only).  Each wrapper
resolves an exp mode (`EXP_EXACT`, `EXP_POLY`, `EXP_POLY_ZEROED`,
`EXP_BF16`) and hands it to the op and the kernel as a trailing `exp_mode`;
under a knob the forward kernels form p against the row's final max (a
first pass over K for it), as JAX's one-shot kernels do.  A launch under a
knob counts under the kernel's name with "_fast_exp2" or "_exp_bf16"
(`kernel_name`).  Where the backward's mode differs from the forward's
(EXP_BF16 in the forward, or K3 with JAX's zero pad keys), the backward
reruns the forward in its own mode for the output and row statistics it
reads, as JAX's backward recomputes its own softmax.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, Optional, Tuple

import torch

from denseclip_vit_multimodal_tpu_torch.ops._library import define
from denseclip_vit_multimodal_tpu_torch.utils.flops import attention_flops, record_kernel_flops

_LANE = 128
_LOG2E = 1.4426950408889634

LAUNCHES: Dict[str, int] = {
    f"{name}{dt}{knob}": 0
    for name in ("qkv_attention", "qkv_attention_bwd", "mha_attention", "mha_attention_bwd")
    for dt in ("", "_fp32") for knob in ("", "_fast_exp2", "_exp_bf16")
    if not (knob == "_exp_bf16" and (dt or name.endswith("_bwd")))}
LAUNCHES.update(qkv_attention_int8=0, quantize_qkv_int8=0)
# The dtypes the attention kernels (K1-K4b) take: bf16 on the tensor cores, fp32 in SIMT
# (the forwards) or by 3xTF32 on the tensor cores (the backwards).
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
EXP_BF16_ENV = "DENSECLIP_EXP_BF16"
FAST_EXP2_ENV = "DENSECLIP_FAST_EXP2"
# The softmax's exp modes, shared with the kernels (csrc/softmax_exp.cuh):
# exp2; the polynomial against the row max of the valid keys; the polynomial
# against the row max floored at 0 (JAX's zero pad keys score 0 and join the
# max); exp2 of bf16(s - m) rounded to bf16, summed in fp32.
EXP_EXACT, EXP_POLY, EXP_POLY_ZEROED, EXP_BF16 = 0, 1, 2, 3
_MODE_SUFFIX = ("", "_fast_exp2", "_fast_exp2", "_exp_bf16")
# JAX's `_exp2_poly`: a cubic minimax for 2^f on [0, 1), fp32 constants
_E2C = (0.9999413315491341, 0.6957344083154011, 0.2261244071264617, 0.07808251030411106)
_REF_CHUNK = 4096  # query rows per step of the one-shot kernels' plain versions
# K5 accumulates P V in int32: at most this many keys of p8 <= 127 times |v8| <= 128
INT8_MAX_KEYS = (2**31 - 1) // (127 * 128)
_INT8_CHUNK = 4096  # query rows per step of the int8 plain version
_V_ALIGN = 16  # V's key-major rows are padded to whole 16-key groups
# Position i of each 16-key group of V's key-major copy holds key
# _V_KEY_ORDER[i]: K5's int32 accumulators of S then lie as the 8-bit A
# fragment of P V (csrc/qkv_attention_int8.cu says how).
_V_KEY_ORDER = (0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15)


def _knob(name: str) -> bool:
    return os.environ.get(name, "0") == "1"


def softmax_modes(kernel: str, dtype: torch.dtype, n: int,
                  valid_len: Optional[int]) -> Tuple[int, int]:
    """(forward, backward) exp modes of a call, from the knobs read now.

    `kernel` is "qkv" (K1 / K2), "mha" (K3 / its backward), "ln_qkv" (K6)
    or "qkv_out" (K7).  JAX pads N to 128 with zero keys where the caller
    gave no `valid_len`: its K1 and K7 then take the zeroed-pads branch
    (FAST_EXP2 only, the zero scores in the row max), its backward too; its
    K3 and K6 mask the pads in the forward.  EXP_BF16 acts in the mask
    branch of K1 and in K3, on bf16 only, and wins over FAST_EXP2 there (JAX's
    `_exp2` keeps `jnp.exp2` for a bf16 argument)."""
    fast = _knob(FAST_EXP2_ENV)
    zeroed = valid_len is None and n % _LANE != 0
    bwd = (EXP_POLY_ZEROED if zeroed else EXP_POLY) if fast else EXP_EXACT
    if kernel == "qkv_out" or (kernel == "qkv" and zeroed):
        return bwd, bwd
    if kernel != "ln_qkv" and _knob(EXP_BF16_ENV) and dtype == torch.bfloat16:
        return EXP_BF16, bwd
    return (EXP_POLY if fast else EXP_EXACT), bwd


def exp2_poly(x: torch.Tensor) -> torch.Tensor:
    """JAX's `_exp2_poly`, bit for bit: 2^x in fp32 for x <= 0 by exponent
    bits and a cubic for the fraction, x clamped at -126; each operation
    rounded (no FMA), as `csrc/softmax_exp.cuh::exp2_poly`."""
    x = torch.maximum(x.float(), x.new_tensor(-126.0, dtype=torch.float32))
    xi = torch.floor(x)
    xf = x - xi
    c0, c1, c2, c3 = (x.new_tensor(c, dtype=torch.float32) for c in _E2C)
    p = c0 + xf * (c1 + xf * (c2 + xf * c3))
    return (p.view(torch.int32) + (xi.to(torch.int32) << 23)).view(torch.float32)


def softmax_exp(x: torch.Tensor, exp_mode: int) -> torch.Tensor:
    """The softmax's exp2 of fp32 `x` = s - m under `exp_mode`, in fp32."""
    if exp_mode in (EXP_POLY, EXP_POLY_ZEROED):
        return exp2_poly(x)
    if exp_mode == EXP_BF16:
        return torch.exp2(x.to(torch.bfloat16).float()).to(torch.bfloat16).float()
    return torch.exp2(x)


def row_max(s: torch.Tensor, exp_mode: int) -> torch.Tensor:
    """The row max the softmax shifts by: floored at 0 under EXP_POLY_ZEROED."""
    m = s.amax(dim=-1, keepdim=True)
    return m.clamp_min(0.0) if exp_mode == EXP_POLY_ZEROED else m


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


def kernel_name(name: str, dtype: torch.dtype, exp_mode: int = EXP_EXACT) -> str:
    """The launch counter of kernel `name` for `dtype` and `exp_mode`: the
    bf16 kernel's own name, or its fp32 kernel's with "_fp32", then
    "_fast_exp2" or "_exp_bf16" under a knob."""
    return f"{name}{'_fp32' if dtype == torch.float32 else ''}{_MODE_SUFFIX[exp_mode]}"


def check_exp_mode(dtype: torch.dtype, exp_mode: int, kernel: str) -> None:
    """ValueError for an exp mode the kernels do not have: EXP_BF16 is bf16's."""
    if exp_mode not in range(4) or (exp_mode == EXP_BF16 and dtype != torch.bfloat16):
        raise ValueError(f"the {kernel} kernels take no exp mode {exp_mode} for {dtype}")


def check_kernel_dtype(x: torch.Tensor, what: str, kernel: str) -> None:
    """TypeError unless `x` is bf16 or fp32, the two dtypes the kernels take."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the {kernel} kernels take bfloat16 or float32 {what}, got {x.dtype}")


def check_device(x: torch.Tensor, what: str) -> None:
    """ValueError unless `x` lies on the CPU (the plain version) or on CUDA
    (the kernel).  Tracing's fake tensors report one of the two, so a traced
    call reaches the op's fake implementation; an eager meta tensor does not."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {x.device}")


def _kv_len(valid_len: Optional[int], n: int) -> int:
    kv_len = n if valid_len is None else int(valid_len)
    if not 1 <= kv_len <= n:
        raise ValueError(f"valid_len {valid_len} outside [1, {n}]")
    return kv_len


def attention_prescaled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: int, exp_mode: int = EXP_EXACT) -> torch.Tensor:
    """The one-shot kernels' attention in plain PyTorch, on a q already
    multiplied by scale * log2 e and rounded to its dtype.

    q, k, v [B, N, H, D] (strided views welcome) -> [B, N, H, D] in q's
    dtype: fp32 scores against the first `kv_len` keys (the kernels mask the
    rest), exp2 softmax (`softmax_exp` under `exp_mode`, against
    `row_max`), P rounded to q's dtype for P V with fp32 accumulation, one
    division by the fp32 row sum.  One head and at most `_REF_CHUNK` query
    rows at a time bound the fp32 scores.
    """
    b, n, heads, d = q.shape
    dtype = q.dtype
    out = torch.empty(b, n, heads, d, dtype=dtype, device=q.device)
    for h in range(heads):
        kh, vh = k[:, :kv_len, h].float(), v[:, :kv_len, h].float()
        for r0 in range(0, n, _REF_CHUNK):
            r1 = min(r0 + _REF_CHUNK, n)
            s = q[:, r0:r1, h].float() @ kh.transpose(-1, -2)
            p = softmax_exp(s - row_max(s, exp_mode), exp_mode)
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
    exp_mode: int = EXP_EXACT,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel; [B, N, 3*H*D] -> [B, N, H*D]."""
    b, n, hd, d = _split_shape(qkv, num_heads)
    kv_len = _kv_len(valid_len, n)
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    q, k, v = (x.view(b, n, num_heads, d) for x in qkv.split(hd, dim=-1))
    q = (q.float() * (scale * _LOG2E)).to(qkv.dtype)
    return attention_prescaled(q, k, v, kv_len, exp_mode).reshape(b, n, hd)


def mha_qkv_attention_bwd_reference(
    qkv: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    *,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
    exp_mode: int = EXP_EXACT,
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
                                        valid_len=valid_len, exp_mode=exp_mode)
    return torch.cat([g.reshape(b, n, hd) for g in grads], dim=-1)


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str, knob: bool = False):
    """A kernel's C entry point, compiled at first use.  With `knob`, the
    attention kernel's entry under the softmax knobs (`*_knob`: the exp mode,
    or K2's / K3's backward's fast_exp2 flag, before the stream; the bf16
    forward and backward ones in sources of their own)."""
    from denseclip_vit_multimodal_tpu_torch.ops._build import load_library

    ptr, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    library, entry, args = {
        "qkv_attention": ("qkv_attention", "qkv_attention_bf16", [ptr] * 3 + [i] * 5 + [f]),
        "qkv_attention_fp32": ("attention_fp32", "qkv_attention_fp32",
                               [ptr] * 3 + [i] * 5 + [f]),
        "mha_attention": ("mha_attention", "mha_attention_bf16",
                          [ptr] * 5 + [ll] * 9 + [i] * 5 + [f]),
        "mha_attention_fp32": ("attention_fp32", "mha_attention_fp32",
                               [ptr] * 5 + [ll] * 9 + [i] * 5 + [f]),
        "mha_attention_bwd": ("qkv_attention_bwd", "mha_attention_bwd_bf16",
                              [ptr] * 11 + [ll] * 9 + [i] * 5 + [f, f]),
        "mha_attention_bwd_fp32": ("attention_bwd_fp32", "mha_attention_bwd_fp32",
                                   [ptr] * 10 + [ll] * 9 + [i] * 5 + [f, f]),
        "qkv_attention_bwd": ("qkv_attention_bwd", "qkv_attention_bwd_bf16",
                              [ptr] * 7 + [i] * 5 + [f, f]),
        "qkv_attention_bwd_fp32": ("attention_bwd_fp32", "qkv_attention_bwd_fp32",
                                   [ptr] * 6 + [i] * 5 + [f, f]),
        "qkv_attention_int8": ("qkv_attention_int8", "qkv_attention_int8",
                               [ptr] * 4 + [i] * 7 + [f]),
        "quantize_qkv_int8": ("quantize_qkv_int8", "quantize_qkv_int8",
                              [ptr, i] + [ptr] * 4 + [i] * 6),
    }[name]
    if knob:
        library = {"qkv_attention": "qkv_attention_knobs", "mha_attention": "mha_attention_knobs",
                   "qkv_attention_bwd": "attention_bwd_knobs"}.get(library, library)
        entry, args = entry + "_knob", args + [i]
    fn = getattr(load_library(library), entry)
    fn.argtypes = args + [ptr]
    fn.restype = ctypes.c_int
    return fn


def _entry(name: str, exp_mode: int):
    """Kernel `name`'s entry for `exp_mode`: its own, or its `*_knob` one."""
    return _kernel_fn(name) if exp_mode == EXP_EXACT else _kernel_fn(name, True)


def _mode_args(exp_mode: int) -> list:
    """The trailing exp-mode argument of a `*_knob` entry (none for EXP_EXACT)."""
    return [] if exp_mode == EXP_EXACT else [exp_mode]


def _check_kernel_input(x: torch.Tensor, what: str) -> None:
    check_kernel_dtype(x, what, "qkv attention")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"the qkv attention kernels take a contiguous, 16-byte aligned {what}")


def _launch(qkv: torch.Tensor, num_heads: int, scale: float, kv_len: int,
            with_stats: bool = False,
            exp_mode: int = EXP_EXACT) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1 (bf16 or fp32) under `exp_mode`; with `with_stats` it also returns
    each row's (max, sum) for K2."""
    b, n, hd, d = _split_shape(qkv, num_heads)
    _check_kernel_input(qkv, "qkv")
    if d not in (64, 128):
        raise ValueError(f"the qkv attention kernel takes head dim 64 or 128, got {d}")
    check_exp_mode(qkv.dtype, exp_mode, "qkv attention")
    name = kernel_name("qkv_attention", qkv.dtype, exp_mode)
    fn = _entry(kernel_name("qkv_attention", qkv.dtype), exp_mode)
    out = torch.empty(b, n, hd, dtype=qkv.dtype, device=qkv.device)
    stats = (torch.empty(b, num_heads, n, 2, dtype=torch.float32, device=qkv.device)
             if with_stats else None)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(
            qkv.data_ptr(), out.data_ptr(), None if stats is None else stats.data_ptr(),
            b, n, num_heads, d, kv_len, scale * _LOG2E, *_mode_args(exp_mode), stream,
        )
    if err != 0:
        raise RuntimeError(f"qkv attention kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    record_kernel_flops(name, attention_flops(b, n, kv_len, hd))
    return out, stats


def _qkv_attention_fake(qkv: torch.Tensor, num_heads: int, scale: float, kv_len: int,
                        exp_mode: int = EXP_EXACT):
    b, n, hd, _ = _split_shape(qkv, num_heads)
    return qkv.new_empty(b, n, hd)


QKV_ATTENTION_OP = define(
    "qkv_attention(Tensor qkv, int num_heads, float scale, int kv_len, int exp_mode=0) -> Tensor",
    cpu=lambda qkv, num_heads, scale, kv_len, exp_mode=EXP_EXACT: mha_qkv_attention_reference(
        qkv, num_heads, sm_scale=scale, valid_len=kv_len, exp_mode=exp_mode),
    cuda=lambda qkv, num_heads, scale, kv_len, exp_mode=EXP_EXACT: _launch(
        qkv, num_heads, scale, kv_len, exp_mode=exp_mode)[0],
    fake=_qkv_attention_fake,
    flops=lambda qkv, num_heads, scale, kv_len, exp_mode=EXP_EXACT: attention_flops(
        qkv.shape[0], qkv.shape[1], kv_len, qkv.shape[2] // 3),
)


def _bwd_scratch(b: int, heads: int, n: int, d: int, device, dtype: torch.dtype) -> list:
    """The backward kernels' scratch, written by the dq kernel for the dk/dv
    kernel: Dc of every row (fp32 [B, H, N]) and, for the bf16 kernels,
    bf16(q * scale * log2 e), bf16(dO * r) (bf16 [2, B, H, N, D]); the fp32
    kernels round those on the fly."""
    dcoef = torch.empty(b, heads, n, dtype=torch.float32, device=device)
    if dtype == torch.float32:
        return [dcoef]
    return [dcoef, torch.empty(2, b, heads, n, d, dtype=torch.bfloat16, device=device)]


def _launch_bwd(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor, stats: torch.Tensor,
                num_heads: int, scale: float, kv_len: int,
                exp_mode: int = EXP_EXACT) -> torch.Tensor:
    """K2 (bf16 or fp32): dqkv from qkv, the forward output, its gradient and
    K1's row stats, all under `exp_mode` (EXP_POLY / EXP_POLY_ZEROED: p from
    the polynomial; the zeroed max is in the stats already)."""
    b, n, hd, d = _split_shape(qkv, num_heads)
    for x, what in ((qkv, "qkv"), (out, "output"), (dout, "output gradient")):
        _check_kernel_input(x, what)
    if not out.dtype == dout.dtype == qkv.dtype:
        raise TypeError(f"output / gradient must be {qkv.dtype} as qkv, got {out.dtype}, "
                        f"{dout.dtype}")
    if out.shape != (b, n, hd) or dout.shape != (b, n, hd):
        raise ValueError(f"output / gradient must be {(b, n, hd)}, got {tuple(out.shape)}, "
                         f"{tuple(dout.shape)}")
    if stats is None or stats.shape != (b, num_heads, n, 2) or not stats.is_contiguous():
        raise ValueError("the backward kernel needs the forward kernel's row statistics")
    check_exp_mode(qkv.dtype, exp_mode, "qkv attention backward")
    name = kernel_name("qkv_attention_bwd", qkv.dtype, exp_mode)
    fn = _entry(kernel_name("qkv_attention_bwd", qkv.dtype), exp_mode)
    dqkv = torch.empty_like(qkv)
    scratch = _bwd_scratch(b, num_heads, n, d, qkv.device, qkv.dtype)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(
            qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), stats.data_ptr(),
            *(x.data_ptr() for x in scratch), dqkv.data_ptr(), b, n, num_heads, d, kv_len,
            scale * _LOG2E, scale, *_mode_args(int(exp_mode != EXP_EXACT)), stream,
        )
    if err != 0:
        raise RuntimeError(f"qkv attention backward kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return dqkv


class QKVAttentionFunction(torch.autograd.Function):
    """K1 forward, K2 backward (the JAX `_qkv_mha` custom VJP).

    On a CPU tensor both directions are the plain versions; on CUDA both are
    the kernels, with no fallback.  Saves qkv, the output and (CUDA) K1's row
    statistics.  `modes` is `softmax_modes`' pair: where the backward's
    differs from the forward's, the backward reruns K1 (or its plain
    version) in its own mode for the output and statistics K2 reads.
    """

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int, scale: float, kv_len: int,
                modes: Tuple[int, int] = (EXP_EXACT, EXP_EXACT)):
        out, stats = _qkv_forward_with_stats(qkv, num_heads, scale, kv_len, modes[0])
        ctx.save_for_backward(qkv, out, stats)
        ctx.attrs = (num_heads, scale, kv_len, modes)
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        qkv, out, stats = ctx.saved_tensors
        num_heads, scale, kv_len, (fwd_mode, bwd_mode) = ctx.attrs
        dqkv = _qkv_backward(qkv, out if bwd_mode == fwd_mode else None, stats, dout, num_heads,
                             scale, kv_len, bwd_mode)
        return dqkv, None, None, None, None


def _qkv_forward_with_stats(qkv: torch.Tensor, num_heads: int, scale: float, kv_len: int,
                            exp_mode: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1's output and row statistics (CUDA), or the plain output and None (CPU)."""
    if qkv.device.type == "cpu":
        return mha_qkv_attention_reference(qkv, num_heads, sm_scale=scale, valid_len=kv_len,
                                           exp_mode=exp_mode), None
    if qkv.device.type == "cuda":
        return _launch(qkv, num_heads, scale, kv_len, with_stats=True, exp_mode=exp_mode)
    raise ValueError(f"no qkv attention for device {qkv.device}")


def _qkv_backward(qkv: torch.Tensor, out: Optional[torch.Tensor], stats: Optional[torch.Tensor],
                  dout: torch.Tensor, num_heads: int, scale: float, kv_len: int,
                  exp_mode: int) -> torch.Tensor:
    """dqkv by K2 (CUDA) or its plain version (CPU) under `exp_mode`; with
    `out` None, K1 first runs in that mode for the output and statistics."""
    if out is None:
        out, stats = _qkv_forward_with_stats(qkv, num_heads, scale, kv_len, exp_mode)
    if qkv.device.type == "cpu":
        return mha_qkv_attention_bwd_reference(qkv, out, dout, num_heads, sm_scale=scale,
                                               valid_len=kv_len, exp_mode=exp_mode)
    return _launch_bwd(qkv, out, dout.to(qkv.dtype).contiguous(), stats, num_heads, scale,
                       kv_len, exp_mode)


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
    The softmax knobs are read now (`softmax_modes`).
    """
    _, n, _, d = _split_shape(qkv, num_heads)
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    kv_len = _kv_len(valid_len, n)
    modes = softmax_modes("qkv", qkv.dtype, n, valid_len)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return QKVAttentionFunction.apply(qkv, num_heads, scale, kv_len, modes)
    check_device(qkv, "qkv attention")
    return QKV_ATTENTION_OP(qkv, num_heads, scale, kv_len, modes[0])


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
    check_kernel_dtype(x, what, kernel)
    sb, sn, sh, sd = x.stride()
    if sd != 1 or x.data_ptr() % 16 or any(s * x.element_size() % 16 for s in (sb, sn, sh)):
        raise ValueError(f"the {kernel} kernel takes a {what} with unit stride over the "
                         "head dim, 16-byte aligned, and other strides multiples of 16 bytes")
    return sb, sn, sh


def mha_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
    exp_mode: int = EXP_EXACT,
) -> torch.Tensor:
    """Plain PyTorch version of K3; [B, N, H, D] -> [B, N, H, D] in q's dtype.

    K3's rounding points (the JAX `_kernel`): q * (scale * log2 e) rounded to
    the input dtype (the constant kept in fp32, as for K1), fp32 scores,
    keys at or beyond `valid_len` masked, exp2 softmax, P rounded to the
    input dtype for P V with fp32 accumulation, one division; the exp under
    `exp_mode`.
    """
    _, kv_len = check_bnhd(q, k, v, valid_len)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    qs = (q.float() * (scale * _LOG2E)).to(q.dtype)
    return attention_prescaled(qs, k, v, kv_len, exp_mode)


def mha_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    valid_len: Optional[int] = None,
    exp_mode: int = EXP_EXACT,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of K3: (dq, dk, dv) [B, N, H, D] in q's dtype.

    `out` is the forward's output and `dout` its gradient.  The JAX
    `_bwd_kernel`'s rounding points: qs = q * (scale * log2 e) rounded to the
    input dtype, s = qs k^T in fp32, p = exp2(s - max), r = 1 / rowsum(p),
    ds = p * (dp - D) * (scale * r) rounded, dq = ds k, dk = ds^T q, dv =
    round(p)^T round(dO * r), with D = rowsum(dO * O) in place of the
    kernel's rowsum(P * dP) * r (equal up to the rounding of O).  Keys at or
    beyond `valid_len` get dk = dv = 0 exactly; every query row (pad rows
    too) contributes its dO.  Under `exp_mode` (EXP_POLY or EXP_POLY_ZEROED,
    as JAX's backward reads FAST_EXP2) p = `softmax_exp(s - row_max(s))`;
    `out` must then be the forward's output under the same mode.
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
        p = softmax_exp(s - row_max(s, exp_mode), exp_mode)
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
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must have one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    return strides


def _launch_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                kv_len: int, stats: Optional[torch.Tensor] = None,
                exp_mode: int = EXP_EXACT) -> torch.Tensor:
    """K3 on CUDA tensors (bf16 or fp32) under `exp_mode`; returns a
    contiguous [B, N, H, D] output in q's dtype.  With `stats` (fp32 [B, H,
    N, 2]) it also writes each row's max and sum."""
    b, n, heads, d = q.shape
    strides = bnhd_args(q, k, v, "one-shot attention", (64, 128, 256))
    if stats is not None and (stats.shape != (b, heads, n, 2) or stats.dtype != torch.float32
                              or not stats.is_contiguous() or stats.device != q.device):
        raise ValueError(f"stats must be a contiguous fp32 {(b, heads, n, 2)} on q's device")
    check_exp_mode(q.dtype, exp_mode, "one-shot attention")
    name = kernel_name("mha_attention", q.dtype, exp_mode)
    fn = _entry(kernel_name("mha_attention", q.dtype), exp_mode)
    out = torch.empty(b, n, heads, d, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if stats is None else stats.data_ptr(), *strides,
                 b, n, heads, d, kv_len, scale * _LOG2E, *_mode_args(exp_mode), stream)
    if err != 0:
        raise RuntimeError(f"one-shot attention kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    record_kernel_flops(name, attention_flops(b, n, kv_len, heads * d))
    return out


MHA_ATTENTION_OP = define(
    "mha_attention(Tensor q, Tensor k, Tensor v, float scale, int kv_len, int exp_mode=0) "
    "-> Tensor",
    cpu=lambda q, k, v, scale, kv_len, exp_mode=EXP_EXACT: mha_attention_reference(
        q, k, v, sm_scale=scale, valid_len=kv_len, exp_mode=exp_mode),
    cuda=lambda q, k, v, scale, kv_len, exp_mode=EXP_EXACT: _launch_mha(
        q, k, v, scale, kv_len, exp_mode=exp_mode),
    fake=lambda q, k, v, scale, kv_len, exp_mode=EXP_EXACT: q.new_empty(q.shape),
    flops=lambda q, k, v, scale, kv_len, exp_mode=EXP_EXACT: attention_flops(
        q.shape[0], q.shape[1], kv_len, q.shape[2] * q.shape[3]),
)


def _launch_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                    dout: torch.Tensor, stats: torch.Tensor, scale: float, kv_len: int,
                    exp_mode: int = EXP_EXACT):
    """K3's backward (bf16 or fp32): (dq, dk, dv), contiguous [B, N, H, D] in
    q's dtype, from the strided q / k / v, K3's output, its gradient and
    K3's row statistics, all under `exp_mode` (as K2's)."""
    b, n, heads, d = q.shape
    strides = bnhd_args(q, k, v, "one-shot attention backward", (64, 128, 256))
    for x, what in ((out, "output"), (dout, "output gradient")):
        if x.shape != q.shape:
            raise ValueError(f"{what} must be {tuple(q.shape)}, got {tuple(x.shape)}")
        _check_kernel_input(x, what)
        if x.dtype != q.dtype:
            raise TypeError(f"{what} must be {q.dtype} as q, got {x.dtype}")
    if stats is None or stats.shape != (b, heads, n, 2) or not stats.is_contiguous():
        raise ValueError("the backward kernel needs the forward kernel's row statistics")
    check_exp_mode(q.dtype, exp_mode, "one-shot attention backward")
    name = kernel_name("mha_attention_bwd", q.dtype, exp_mode)
    fn = _entry(kernel_name("mha_attention_bwd", q.dtype), exp_mode)
    dq, dk, dv = (torch.empty(b, n, heads, d, dtype=q.dtype, device=q.device) for _ in range(3))
    scratch = _bwd_scratch(b, heads, n, d, q.device, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 stats.data_ptr(), *(x.data_ptr() for x in scratch), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), *strides, b, n, heads, d, kv_len,
                 scale * _LOG2E, scale, *_mode_args(int(exp_mode != EXP_EXACT)), stream)
    if err != 0:
        raise RuntimeError(f"one-shot attention backward kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return dq, dk, dv


class MHAAttentionFunction(torch.autograd.Function):
    """K3 forward, K3's backward (the JAX `_mha` custom VJP).

    On CPU tensors both directions are the plain versions; on CUDA both are
    the kernels, with no fallback.  Saves q, k, v, the output and (CUDA)
    K3's row statistics; `modes` as `QKVAttentionFunction`'s.
    """

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                kv_len: int, modes: Tuple[int, int] = (EXP_EXACT, EXP_EXACT)):
        out, stats = _mha_forward_with_stats(q, k, v, scale, kv_len, modes[0])
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.attrs = (scale, kv_len, modes)
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        q, k, v, out, stats = ctx.saved_tensors
        scale, kv_len, (fwd_mode, bwd_mode) = ctx.attrs
        if bwd_mode != fwd_mode:  # JAX's backward recomputes its own softmax
            out, stats = _mha_forward_with_stats(q, k, v, scale, kv_len, bwd_mode)
        if q.device.type == "cpu":
            grads = mha_attention_bwd_reference(q, k, v, out, dout, sm_scale=scale,
                                                valid_len=kv_len, exp_mode=bwd_mode)
        else:
            grads = _launch_mha_bwd(q, k, v, out, dout.to(q.dtype).contiguous(), stats, scale,
                                    kv_len, bwd_mode)
        return (*grads, None, None, None)


def _mha_forward_with_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                            kv_len: int, exp_mode: int):
    """K3's output and row statistics (CUDA), or the plain output and None (CPU)."""
    if q.device.type == "cpu":
        return mha_attention_reference(q, k, v, sm_scale=scale, valid_len=kv_len,
                                       exp_mode=exp_mode), None
    if q.device.type == "cuda":
        b, n, heads, _ = q.shape
        stats = torch.empty(b, heads, n, 2, dtype=torch.float32, device=q.device)
        return _launch_mha(q, k, v, scale, kv_len, stats, exp_mode), stats
    raise ValueError(f"no one-shot attention for device {q.device}")


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
    The softmax knobs are read now (`softmax_modes`).
    """
    n, kv_len = check_bnhd(q, k, v, valid_len)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    modes = softmax_modes("mha", q.dtype, n, valid_len)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return MHAAttentionFunction.apply(q, k, v, scale, kv_len, modes)
    check_device(q, "one-shot attention")
    return MHA_ATTENTION_OP(q, k, v, scale, kv_len, modes[0])


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
    to 16 (zero-filled), each 16-key group in the order `_V_KEY_ORDER`: K5's
    B operand of P V (K-major, as 8-bit wgmma takes it)."""
    b, n, hd, d = _split_shape(q8, num_heads)
    ldv = -(-n // _V_ALIGN) * _V_ALIGN
    vt = q8.new_zeros(b, num_heads, d, ldv)
    vt[..., :n] = q8[..., 2 * hd:].view(b, n, num_heads, d).permute(0, 2, 3, 1)
    order = torch.tensor(_V_KEY_ORDER, device=q8.device)
    return vt.view(b, num_heads, d, ldv // _V_ALIGN, _V_ALIGN).index_select(-1, order).view(
        b, num_heads, d, ldv)


def _launch_quantize_int8(qkv: torch.Tensor, num_heads: int, kv_len: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The prologue kernel: (q8, V's key-major copy, scales), bit for bit
    `quantize_qkv_int8` and `value_key_major` on what K5 reads.  q8's v
    third is left unwritten (K5 reads V from its key-major copy only)."""
    b, n, hd, d = _split_shape(qkv, num_heads)
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the int8 prologue kernel takes bfloat16 or float32 qkv, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the int8 prologue kernel takes a contiguous, 16-byte aligned qkv")
    if d not in (64, 128):
        raise ValueError(f"the int8 prologue kernel takes head dim 64 or 128, got {d}")
    ldv = -(-n // _V_ALIGN) * _V_ALIGN
    fn = _kernel_fn("quantize_qkv_int8")
    dev = qkv.device
    amax = torch.zeros(b, 3, num_heads, dtype=torch.int32, device=dev)  # fp32 bits
    q8 = torch.empty(b, n, 3 * hd, dtype=torch.int8, device=dev)
    vt = torch.empty(b, num_heads, d, ldv, dtype=torch.int8, device=dev)
    scales = torch.empty(b, 3, num_heads, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(qkv.data_ptr(), int(qkv.dtype == torch.bfloat16), amax.data_ptr(),
                 q8.data_ptr(), vt.data_ptr(), scales.data_ptr(), b, n, num_heads, d, kv_len,
                 ldv, stream)
    if err != 0:
        raise RuntimeError(f"int8 prologue kernel launch failed: cudaError {err}")
    LAUNCHES["quantize_qkv_int8"] += 1
    record_kernel_flops("quantize_qkv_int8", 0)  # elementwise work
    return q8, vt, scales


def _launch_int8(q8: torch.Tensor, vt: torch.Tensor, scales: torch.Tensor, num_heads: int,
                 scale: float, kv_len: int, out_dtype: torch.dtype) -> torch.Tensor:
    """K5 on the prologue's operands; returns [B, N, H*D] in `out_dtype`.
    It reads q8's q and k thirds and V from `vt`, never q8's v third."""
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
    record_kernel_flops("qkv_attention_int8", attention_flops(b, n, kv_len, hd))
    return out


def _quantize_int8_plain(qkv: torch.Tensor, num_heads: int, kv_len: int):
    q8, scales = quantize_qkv_int8(qkv, num_heads, kv_len)
    return q8, value_key_major(q8, num_heads), scales


def _quantize_int8_fake(qkv: torch.Tensor, num_heads: int, kv_len: int):
    b, n, hd, d = _split_shape(qkv, num_heads)
    ldv = (n + _V_ALIGN - 1) // _V_ALIGN * _V_ALIGN
    return (qkv.new_empty(b, n, 3 * hd, dtype=torch.int8),
            qkv.new_empty(b, num_heads, d, ldv, dtype=torch.int8),
            qkv.new_empty(b, 3, num_heads, dtype=torch.float32))


# The prologue: (q8, V's key-major copy, scales).  The CPU version writes q8's
# v third too (K5's plain version reads V there); the kernel leaves it unwritten.
QUANTIZE_QKV_INT8_OP = define(
    "quantize_qkv_int8(Tensor qkv, int num_heads, int kv_len) -> (Tensor, Tensor, Tensor)",
    cpu=_quantize_int8_plain, cuda=_launch_quantize_int8, fake=_quantize_int8_fake,
)


def _int8_attention_fake(q8, vt, scales, num_heads: int, scale: float, kv_len: int,
                         out_dtype: torch.dtype):
    b, n, hd, _ = _split_shape(q8, num_heads)
    return q8.new_empty(b, n, hd, dtype=out_dtype)


QKV_ATTENTION_INT8_OP = define(
    "qkv_attention_int8(Tensor q8, Tensor vt, Tensor scales, int num_heads, float scale, "
    "int kv_len, ScalarType out_dtype) -> Tensor",
    cpu=lambda q8, vt, scales, num_heads, scale, kv_len, out_dtype: int8_attention_plain(
        q8, scales, num_heads, scale, kv_len, out_dtype),
    cuda=_launch_int8, fake=_int8_attention_fake,
    flops=lambda q8, vt, scales, num_heads, scale, kv_len, out_dtype: attention_flops(
        q8.shape[0], q8.shape[1], kv_len, q8.shape[2] // 3),
)


class Int8AttentionFunction(torch.autograd.Function):
    """K5 forward, the JAX straight-through backward (`_qkv_mha_int8`'s VJP
    is `_qkv_bwd`): the bf16 backward of the UNQUANTIZED qkv.  On CUDA that
    is K1's forward for the output and row statistics K2 reads, then K2; on
    the CPU the plain versions.  Saves qkv only, as the JAX VJP does."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int, scale: float, kv_len: int,
                bwd_mode: int = EXP_EXACT):
        ctx.save_for_backward(qkv)
        ctx.attrs = (num_heads, scale, kv_len, bwd_mode)
        return _int8_forward(qkv, num_heads, scale, kv_len)

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        num_heads, scale, kv_len, bwd_mode = ctx.attrs
        dqkv = _qkv_backward(qkv, None, None, dout, num_heads, scale, kv_len, bwd_mode)
        return dqkv, None, None, None, None


def _int8_forward(qkv: torch.Tensor, num_heads: int, scale: float, kv_len: int) -> torch.Tensor:
    check_device(qkv, "int8 qkv attention")
    q8, vt, scales = QUANTIZE_QKV_INT8_OP(qkv, num_heads, kv_len)
    return QKV_ATTENTION_INT8_OP(q8, vt, scales, num_heads, scale, kv_len, qkv.dtype)


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
        # the JAX backward's `_bwd_kernel` reads FAST_EXP2 (K5 itself neither knob)
        bwd_mode = softmax_modes("qkv", qkv.dtype, n, valid_len)[1]
        return Int8AttentionFunction.apply(qkv, num_heads, scale, kv_len, bwd_mode)
    return _int8_forward(qkv, num_heads, scale, kv_len)
