"""Fused LayerNorm + QKV projection + attention: the Hopper kernel K6 and its plain version.

Port of the JAX package's `ops/lnqkv_kernel.py`: the TPU kernel
`_lnqkv_kernel` (K6, `csrc/ln_qkv_attention.cu`), reached through
`ln_qkv_attention` from every pre-LN ViT block on the inference path when
`DENSECLIP_FUSED_LNQKV=1` (`models/layers.py`).  The source's header note
gives the kernel's design and its bound on an H100.

* `ln_qkv_attention` launches K6 for a CUDA tensor, or raises on anything
  the kernel does not take; for a CPU tensor it runs the plain version.
  When autograd records the call it goes through `LNQKVAttentionFunction`,
  whose backward is the VJP of `lnqkv_reference`, as the JAX `_lnqkv_bwd`:
  stray gradients are correct, not fast.
* `ln_qkv_attention_reference` is the plain PyTorch forward with K6's
  rounding points, `ln_qkv_projection_reference` the same up to the q/k/v
  workspace that K6's first stage writes, `ln_qkv_stats_reference` its
  statistics (bitwise the kernel's); `workspace_errors` holds a workspace
  to the plain one.  `lnqkv_reference` is the port of the JAX
  `_lnqkv_reference` (two-pass LayerNorm, bias added in the compute dtype,
  plain attention), used only for the backward.
* `ln_qkv_projection` runs K6's first stage alone (the statistics and the
  projection kernels) for a CUDA tensor, its plain version for a CPU one:
  for the split timings and the workspace check, not a route of the model.
* `lnqkv_supported` is the JAX rule, residency limit included.
* `LAUNCHES["ln_qkv_attention"]` counts K6's launches (its three CUDA
  kernels count as one), `LAUNCHES["ln_qkv_projection"]` the first stage's
  alone; never plain calls.

The constants below are the port's own copies of the JAX package's
`ops/mha_kernel.py` values the rule reads.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from denseclip_vit_multimodal_tpu_torch.ops.attention import plain_attention
from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import _kv_len, attention_prescaled

_LANE = 128
_LOG2E = 1.4426950408889634
# The TPU kernel's scoped-VMEM budget (16 MB minus tiles and headroom): a TPU
# residency constant, kept only so that the port routes every shape as the
# reference does.
_VMEM_SCOPED = 14 * 1024 * 1024

LAUNCHES: Dict[str, int] = {"ln_qkv_attention": 0, "ln_qkv_projection": 0}


def lnqkv_supported(num_heads: int, model_dim: int, n: int = 0) -> bool:
    """The JAX rule for the fused kernel: head dim 64 or 128, a model width
    that is a multiple of 128 and, given `n`, the TPU kernel's VMEM
    residents (x and LN(x) [n_pad, D], K/V [n_pad, lane block], bf16) plus
    one 8-row score tile within the scoped budget.  The last is a TPU limit
    (at D = 768, head dim 64 it admits n_pad <= 3968, so the 8193-token whole
    frame takes the unfused path); the port keeps it so that it routes every
    shape as the reference does."""
    head_dim = model_dim // num_heads
    if not (head_dim in (64, 128) and model_dim % _LANE == 0):
        return False
    if n:
        lane_block = max(_LANE // head_dim, 1) * head_dim
        n_pad = -(-n // _LANE) * _LANE
        resident = n_pad * 2 * (2 * model_dim + 2 * lane_block)
        if resident + 8 * n_pad * 4 * 2 > _VMEM_SCOPED:
            return False
    return True


def _shapes(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, w_qkv: torch.Tensor,
            b_qkv: torch.Tensor, num_heads: int):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, D], got {tuple(x.shape)}")
    dim = x.shape[-1]
    if (w_qkv.dim() != 2 or w_qkv.shape[0] != dim or w_qkv.shape[1] % 3
            or gamma.shape != (dim,) or beta.shape != (dim,) or b_qkv.shape != (w_qkv.shape[1],)):
        raise ValueError(f"ln_qkv_attention takes x [B, N, D], gamma / beta [D], W [D, 3*H*d] and "
                         f"b [3*H*d]; got {tuple(x.shape)}, {tuple(gamma.shape)}, "
                         f"{tuple(beta.shape)}, {tuple(w_qkv.shape)}, {tuple(b_qkv.shape)}")
    hd = w_qkv.shape[1] // 3
    if hd % num_heads:
        raise ValueError(f"width {hd} is not divisible by {num_heads} heads")
    return hd, hd // num_heads


def ln_qkv_projection_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    num_heads: int,
    *,
    sm_scale: Optional[float] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain PyTorch version of K6's first stage; x [B, N, D] -> the q/k/v
    workspace [B, N, 3*H*d] in x's dtype.

    K6's rounding points: fp32 one-pass statistics, var = max(E[x^2] -
    mean^2, 0) (`ln_qkv_stats_reference`); (y * gamma + beta) rounded to the
    dtype; W rounded to the dtype, fp32 accumulation, fp32 bias; q * (scale
    * log2 e) in fp32 after the bias, then rounded; k, v rounded after their
    bias.
    """
    hd, d = _shapes(x, gamma, beta, w_qkv, b_qkv, num_heads)
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    dtype = x.dtype
    ln = _layer_norm_rounded(x, gamma, beta, eps)
    proj = ln.float() @ w_qkv.to(dtype).float() + b_qkv.float()  # [B, N, 3*H*d] fp32
    q = (proj[..., :hd] * (scale * _LOG2E)).to(dtype)
    return torch.cat([q, proj[..., hd:].to(dtype)], dim=-1)


def ln_qkv_stats_reference(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K6's statistics pass: each row's fp32 (mean, rstd)
    [..., 2] of x [..., D], one pass, var = max(E[x^2] - mean^2, 0), summed
    in the kernel's order (a warp per row: lane l adds elements 256 i + 8 l
    + j, i then j, while 256 i + 8 l < D; then a butterfly over the lanes),
    so that the two agree bit for bit.  A width that is not a multiple of 8
    (which K6 does not take) sums in PyTorch's order."""
    xf = x.float()
    dim = xf.shape[-1]
    if dim % 8:
        total, squares = xf.sum(dim=-1), (xf * xf).sum(dim=-1)
    else:
        steps = -(-dim // 256)
        lanes = torch.nn.functional.pad(xf, (0, 256 * steps - dim)).reshape(
            *xf.shape[:-1], steps, 32, 8)
        total = torch.zeros(lanes.shape[:-3] + (32,), device=x.device)
        squares = torch.zeros_like(total)
        for i in range(steps):
            active = min(32, (dim - 256 * i) // 8)  # the lanes with elements left
            for j in range(8):
                f = lanes[..., i, :active, j]
                total[..., :active] = total[..., :active] + f
                squares[..., :active] = squares[..., :active] + f * f
        lane = torch.arange(32, device=x.device)
        for off in (16, 8, 4, 2, 1):
            total = total + total[..., lane ^ off]
            squares = squares + squares[..., lane ^ off]
        total, squares = total[..., 0], squares[..., 0]
    # divisions by tensors: PyTorch divides by a Python number as a product
    # with its reciprocal on CUDA, which rounds differently from the kernel's
    width, one = torch.full_like(total, float(dim)), torch.ones_like(total)
    mean = total / width
    var = torch.fmax(squares / width - mean * mean, torch.zeros_like(mean))
    return torch.stack([mean, one / torch.sqrt(var + eps)], dim=-1)


def _layer_norm_rounded(x, gamma, beta, eps):
    """K6's LayerNorm: `ln_qkv_stats_reference`'s statistics, (y * gamma +
    beta) rounded to x's dtype, each step rounded."""
    stats = ln_qkv_stats_reference(x, eps)
    y = (x.float() - stats[..., :1]) * stats[..., 1:]
    return (y * gamma.float() + beta.float()).to(x.dtype)


def workspace_errors(got, x, gamma, beta, w_qkv, b_qkv, num_heads, *,
                     sm_scale: Optional[float] = None, eps: float = 1e-5,
                     rows: Optional[int] = None) -> Dict[str, float]:
    """How far a q/k/v workspace `got` [B, N, 3*H*d] (K6's first stage) lies
    from `ln_qkv_projection_reference`'s, over the first `rows` rows.

    Both sides normalise x to the same bf16 values (the statistics are
    summed in one order), so only the projection's sums differ.  An
    element's limit is one bf16 step of the wanted value's binade (the last
    rounding) plus 3 * D * 2^-24 * S, S = sum_k |LN(x)_k W_kj| + |b_j|
    (times q's scale on q columns): the worst-case errors of an fp32 sum of
    D terms in any order that truncates (2^-23 an addition; tensor cores
    may accumulate so) and of one that rounds (2^-24: the reference),
    which decide the rounding where the sum cancels.  Returns the largest
    difference in bf16 steps, the largest share of the limit (<= 1 passes)
    and the number of elements that differ."""
    hd, d = _shapes(x, gamma, beta, w_qkv, b_qkv, num_heads)
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    rows = x.shape[1] if rows is None else rows
    want = ln_qkv_projection_reference(x, gamma, beta, w_qkv, b_qkv, num_heads, sm_scale=scale,
                                       eps=eps)[:, :rows].float()
    ln = _layer_norm_rounded(x[:, :rows], gamma, beta, eps).float()
    sums = ln.abs() @ w_qkv.to(x.dtype).float().abs() + b_qkv.float().abs()
    sums[..., :hd] *= scale * _LOG2E
    step = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0**-126))) - 7)
    diff = (got[:, :rows].float() - want).abs()
    limit = step + 3 * x.shape[-1] * 2.0**-24 * sums
    return {"max_bf16_steps": float((diff / step).max()),
            "max_share_of_limit": float((diff / limit).max()),
            "elements_differing": int((diff > 0).sum())}


def ln_qkv_attention_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    num_heads: int,
    *,
    sm_scale: Optional[float] = None,
    eps: float = 1e-5,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K6; x [B, N, D] (in the compute dtype) ->
    [B, N, H*d] in x's dtype.

    `ln_qkv_projection_reference`'s workspace, then keys at or beyond
    `valid_len` masked (the TPU kernel's pad rows carry LN(0) = beta, not
    zeros, so nothing else is corrected); exp2 softmax in fp32, P rounded,
    P V in fp32, one division.
    """
    hd, d = _shapes(x, gamma, beta, w_qkv, b_qkv, num_heads)
    b, n, _ = x.shape
    kv_len = _kv_len(valid_len, n)
    qkv = ln_qkv_projection_reference(x, gamma, beta, w_qkv, b_qkv, num_heads,
                                      sm_scale=sm_scale, eps=eps)
    q, k, v = (t.view(b, n, num_heads, d) for t in qkv.split(hd, dim=-1))
    return attention_prescaled(q, k, v, kv_len).reshape(b, n, hd)


def lnqkv_reference(x, gamma, beta, w_qkv, b_qkv, num_heads: int, scale: float, eps: float,
                    valid_len: Optional[int] = None) -> torch.Tensor:
    """The JAX `_lnqkv_reference`: two-pass fp32 LayerNorm rounded to x's
    dtype, the projection and bias in that dtype, then plain attention (fp32
    softmax).  Differentiable; the backward of `ln_qkv_attention`."""
    _, d = _shapes(x, gamma, beta, w_qkv, b_qkv, num_heads)
    b, n, _ = x.shape
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    ln = ((xf - mean) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)
    qkv = ln @ w_qkv.to(x.dtype) + b_qkv.to(x.dtype)
    q, k, v = (t.reshape(b, n, num_heads, d) for t in qkv.chunk(3, dim=-1))
    return plain_attention(q, k, v, False, valid_len, sm_scale=scale).reshape(b, n, -1)


def bind_entry_points(lib: ctypes.CDLL) -> Dict[str, ctypes._CFuncPtr]:
    """K6's C entry points in a library built from `csrc/ln_qkv_attention.cu`,
    typed: the whole kernel ("attention") and its stages ("stats",
    "projection", "stage2")."""
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {"attention": lib.ln_qkv_attention_bf16, "stats": lib.ln_qkv_stats_bf16,
           "projection": lib.ln_qkv_projection_bf16, "stage2": lib.ln_qkv_attention_stage2_bf16}
    fns["attention"].argtypes = [ptr] * 7 + [i] * 6 + [f, f, ptr]
    fns["stats"].argtypes = [ptr, ptr, i, i, f, ptr]
    fns["projection"].argtypes = [ptr] * 7 + [i] * 3 + [f, ptr]
    fns["stage2"].argtypes = [ptr, ptr] + [i] * 5 + [ptr]
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


@functools.lru_cache(maxsize=None)
def kernel_fns() -> Dict[str, ctypes._CFuncPtr]:
    """`bind_entry_points` of this checkout's K6, compiled at first use."""
    from denseclip_vit_multimodal_tpu_torch.ops._build import load_library

    return bind_entry_points(load_library("ln_qkv_attention"))


def _fp32_vector(t: torch.Tensor) -> torch.Tensor:
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _operands(x, gamma, beta, w_qkv, b_qkv, num_heads):
    """The checks of every K6 launch on CUDA tensors, then (head dim, W^T
    [3*H*d, D] bf16 contiguous, gamma, beta, bias fp32 16-byte aligned)."""
    hd, d = _shapes(x, gamma, beta, w_qkv, b_qkv, num_heads)
    dim = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused LN + qkv attention kernel takes bfloat16 x, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the fused LN + qkv attention kernel takes a contiguous, 16-byte aligned x")
    if d not in (64, 128) or dim % _LANE or hd % _LANE:
        raise ValueError(f"the fused LN + qkv attention kernel takes head dim 64 or 128 and "
                         f"widths that are multiples of 128, got d {d}, D {dim}, H*d {hd}")
    if len({t.device for t in (x, gamma, beta, w_qkv, b_qkv)}) != 1:
        raise ValueError("x and the parameters must be on one device")
    # W^T [3*H*d, D]: the torch Linear layout, a cast (no transpose) for the
    # transposed view of a Linear weight
    wt = w_qkv.t().to(torch.bfloat16).contiguous()
    return d, wt, *(_fp32_vector(t) for t in (gamma, beta, b_qkv))


def _launch(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, w_qkv: torch.Tensor,
            b_qkv: torch.Tensor, num_heads: int, scale: float, eps: float,
            kv_len: int) -> torch.Tensor:
    """K6 on CUDA tensors; returns [B, N, H*d] bf16."""
    d, wt, gamma, beta, bias = _operands(x, gamma, beta, w_qkv, b_qkv, num_heads)
    b, n, dim = x.shape
    hd = num_heads * d
    fn = kernel_fns()["attention"]
    workspace = torch.empty(b, n, 3 * hd, dtype=torch.bfloat16, device=x.device)
    out = torch.empty(b, n, hd, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                 workspace.data_ptr(), out.data_ptr(), b, n, dim, num_heads, d, kv_len,
                 scale * _LOG2E, eps, stream)
    if err != 0:
        raise RuntimeError(f"fused LN + qkv attention kernel launch failed: cudaError {err}")
    LAUNCHES["ln_qkv_attention"] += 1
    return out


def ln_qkv_projection(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    num_heads: int,
    *,
    sm_scale: Optional[float] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """K6's first stage alone: x [B, N, D] -> the q/k/v workspace [B, N,
    3*H*d] that its second stage reads (q already scaled by scale * log2 e).
    A CUDA tensor runs the statistics and projection kernels; a CPU tensor
    runs `ln_qkv_projection_reference`."""
    _, d = _shapes(x, gamma, beta, w_qkv, b_qkv, num_heads)
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    if x.device.type == "cpu":
        return ln_qkv_projection_reference(x, gamma, beta, w_qkv, b_qkv, num_heads,
                                           sm_scale=scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no fused LN + qkv projection for device {x.device}")
    d, wt, gamma, beta, bias = _operands(x, gamma, beta, w_qkv, b_qkv, num_heads)
    b, n, dim = x.shape
    hd = num_heads * d
    fns = kernel_fns()
    stats = torch.empty(b * n, 2, device=x.device)
    workspace = torch.empty(b, n, 3 * hd, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fns["stats"](x.data_ptr(), stats.data_ptr(), b * n, dim, float(eps), stream)
        if err == 0:
            err = fns["projection"](x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                    wt.data_ptr(), bias.data_ptr(), stats.data_ptr(),
                                    workspace.data_ptr(), b * n, dim, hd, scale * _LOG2E,
                                    stream)
    if err != 0:
        raise RuntimeError(f"fused LN + qkv projection launch failed: cudaError {err}")
    LAUNCHES["ln_qkv_projection"] += 1
    return workspace


def _forward(x, gamma, beta, w_qkv, b_qkv, num_heads, scale, eps, kv_len):
    if x.device.type == "cpu":
        return ln_qkv_attention_reference(x, gamma, beta, w_qkv, b_qkv, num_heads,
                                          sm_scale=scale, eps=eps, valid_len=kv_len)
    if x.device.type != "cuda":
        raise ValueError(f"no fused LN + qkv attention for device {x.device}")
    return _launch(x, gamma, beta, w_qkv, b_qkv, num_heads, scale, eps, kv_len)


class LNQKVAttentionFunction(torch.autograd.Function):
    """K6 forward (the plain version on the CPU); backward through the VJP of
    `lnqkv_reference`, as the JAX `_lnqkv_bwd` does."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w_qkv, b_qkv, num_heads: int, scale: float, eps: float,
                kv_len: int):
        ctx.save_for_backward(x, gamma, beta, w_qkv, b_qkv)
        ctx.attrs = (num_heads, scale, eps, kv_len)
        return _forward(x, gamma, beta, w_qkv, b_qkv, num_heads, scale, eps, kv_len)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        num_heads, scale, eps, kv_len = ctx.attrs
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(inputs, ctx.needs_input_grad[:5])]
            out = lnqkv_reference(*leaves, num_heads, scale, eps, kv_len)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g.float().to(out.dtype)))
        return tuple(next(grads) if t.requires_grad else None for t in leaves) + (None,) * 4


def ln_qkv_attention(
    x: torch.Tensor,  # [B, N, D] residual stream (pre-LN input), in the compute dtype
    gamma: torch.Tensor,  # [D] ln_1 scale
    beta: torch.Tensor,  # [D] ln_1 bias
    w_qkv: torch.Tensor,  # [D, 3*H*d]
    b_qkv: torch.Tensor,  # [3*H*d]
    num_heads: int,
    *,
    sm_scale: Optional[float] = None,
    eps: float = 1e-5,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Fused LN(x) -> QKV -> attention; returns [B, N, H*d] (before the out
    projection) in x's dtype.  Keys at or beyond `valid_len` are masked;
    output rows past it are left to the caller."""
    _, d = _shapes(x, gamma, beta, w_qkv, b_qkv, num_heads)
    kv_len = _kv_len(valid_len, x.shape[1])
    scale = d**-0.5 if sm_scale is None else float(sm_scale)
    args = (x, gamma, beta, w_qkv, b_qkv)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return LNQKVAttentionFunction.apply(*args, num_heads, scale, float(eps), kv_len)
    return _forward(*args, num_heads, scale, float(eps), kv_len)
