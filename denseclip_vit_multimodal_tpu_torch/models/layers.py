"""Shared transformer / conv building blocks (PyTorch, NHWC at the boundaries).

Port of the JAX package's `models/layers.py`.  Parameters are kept in fp32 and
cast to the module's compute `dtype` at each use, as Flax's `param_dtype` /
`dtype` split does; LayerNorm and BatchNorm compute in fp32.

  * `LayerNorm` / `layer_norm_apply` — fp32 statistics, eps 1e-5, result cast
    back to the input dtype.
  * `quick_gelu` — x * sigmoid(1.702 x).
  * `MultiHeadAttention` — fused [D, 3D] qkv projection; for long non-causal
    bf16 sequences on CUDA the attention runs in the hand-written kernel
    (`ops/mha_kernel.py`), otherwise in plain PyTorch (`plain_attention`).
  * `MLP`, `ResidualAttentionBlock` (pre-LN; per-sample drop path when
    training) and `Transformer`, a loop over its blocks that returns
    `(final, taps[L, B, N, D])`, with drop-path rates rising linearly over
    the layers.
  * `ConvBNReLU` — conv + BatchNorm + ReLU on NHWC tensors; BatchNorm in
    training normalises by the batch statistics and updates the running
    ones with Flax's rule (`batch_norm_nhwc`).
  * `drop_path`, `dropout` — Flax semantics (keep with probability 1 - rate,
    scale by 1 / (1 - rate)), drawn from an explicit `torch.Generator`.
  * `resize_bilinear` — half-pixel centres, no antialias by default.

Initialisers draw from the same distributions as the Flax ones, from a
`torch.Generator` (the numbers differ from JAX's; tests carry JAX weights
over with `convert.py`).  Random masks cannot reproduce `jax.random`'s
streams either: a forward is deterministic unless it is handed a generator.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
    mha_qkv_attention,
    qkv_supported,
)

ATTN_XLA = "xla"  # plain PyTorch attention everywhere (name kept from the JAX package)
ATTN_AUTO = "auto"  # the qkv kernel where the dispatch rule holds
ATTN_IMPLS = (ATTN_AUTO, ATTN_XLA)

# The kernel serves 1024 <= N <= 8448 tokens, as on the TPU
# (JAX package ops/attention.py: _FLASH_MIN_SEQ, _ONESHOT_MAX_SEQ).
_FLASH_MIN_SEQ = 1024
_ONESHOT_MAX_SEQ = 8448


# --------------------------------------------------------------------------
# Flax-equivalent initialisers (all draw on the CPU from `gen`)
# --------------------------------------------------------------------------


def trunc_normal(shape, std: float, gen: torch.Generator, lower=-2.0, upper=2.0) -> torch.Tensor:
    """std * standard normal truncated to [lower, upper] (inverse-CDF draw)."""
    cdf = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
    lo, hi = cdf(lower), cdf(upper)
    u = torch.rand(shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo
    x = torch.special.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    return (x.clamp(lower, upper) * std).float()


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    """Flax fan-in/fan-out of a Dense [in, out] or Conv HWIO kernel shape."""
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def variance_scaling(shape, scale: float, mode: str, gen: torch.Generator) -> torch.Tensor:
    """Flax `variance_scaling(scale, mode, "truncated_normal")` on a JAX-layout shape."""
    fan_in, fan_out = _fans(shape)
    fan = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2}[mode]
    # 0.8796...: std of a standard normal truncated to [-2, 2]
    return trunc_normal(shape, math.sqrt(scale / fan) / 0.87962566103423978, gen)


def xavier_uniform(shape, gen: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


def normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


def _set(param: torch.Tensor, value: torch.Tensor) -> None:
    with torch.no_grad():
        param.copy_(value)


# --------------------------------------------------------------------------
# Norms, activations, projections
# --------------------------------------------------------------------------


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's GELU approximation."""
    return x * torch.sigmoid(1.702 * x)


def layer_norm_apply(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, epsilon: float = 1e-5
) -> torch.Tensor:
    """fp32-stats layer norm given explicit affine params; returns x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), epsilon)
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics regardless of input dtype."""

    def __init__(self, dim: int, epsilon: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_apply(x, self.weight, self.bias, self.epsilon)


class Linear(nn.Linear):
    """nn.Linear with fp32 parameters computed in `dtype` (Flax `nn.Dense`).

    `kernel_init(shape_in_out, gen)` draws the JAX-layout [in, out] kernel.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, kernel_init=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        init = kernel_init or (lambda s, g: variance_scaling(s, 1.0, "fan_in", g))
        _set(self.weight, init((in_features, out_features), gen).T)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """Same-padded conv on NHWC tensors, fp32 parameters computed in `dtype`.

    The NHWC input is handed to cuDNN as a channels-last NCHW view (a free
    permute), and the output comes back NHWC the same way.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 kernel_init=None, gen: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=kernel_size // 2, bias=bias)
        self.compute_dtype = dtype
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        init = kernel_init or (lambda s, g: variance_scaling(s, 2.0, "fan_out", g))
        hwio = init((kernel_size, kernel_size, in_channels, out_channels), gen)
        _set(self.weight, hwio.permute(3, 2, 0, 1))
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        y = self._conv_forward(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), bias)
        return y.permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain attention on [B, N, H, Dh] inputs with an fp32 softmax.

    Counterpart of the JAX package's `_xla_attention`: fp32 scores (the
    inputs' products accumulated in fp32), min-float masking of causal and
    `valid_len` positions, softmax in fp32 cast back to the input dtype.
    """
    scale = q.shape[-1] ** -0.5
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


class MultiHeadAttention(nn.Module):
    """CLIP-style multi-head self-attention with a fused QKV projection.

    Parameters: `qkv` Linear(D, 3D) and `out` Linear(D, D).  The kernel
    dispatch rule is the JAX package's (`_qkv_kernel_applicable`) with "on
    the TPU" read as "on CUDA", plus the kernel's one dtype, bf16.
    """

    def __init__(self, dim: int, num_heads: int, causal: bool = False,
                 attn_impl: str = ATTN_AUTO,
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} is not divisible by {num_heads} heads")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not yet ported (have {ATTN_IMPLS})")
        self.num_heads = num_heads
        self.causal = causal
        self.attn_impl = attn_impl
        xavier = lambda s, g: xavier_uniform(s, g)
        self.qkv = Linear(dim, 3 * dim, dtype=dtype, kernel_init=xavier, gen=gen)
        self.out = Linear(dim, dim, dtype=dtype, kernel_init=xavier, gen=gen)

    def _qkv_kernel_applicable(self, qkv: torch.Tensor, dim: int) -> bool:
        n = qkv.shape[1]
        return (
            self.attn_impl == ATTN_AUTO
            and not self.causal
            and qkv.is_cuda
            and qkv.dtype == torch.bfloat16
            and _FLASH_MIN_SEQ <= n <= _ONESHOT_MAX_SEQ
            and qkv_supported(self.num_heads, dim)
        )

    def forward(self, x: torch.Tensor, valid_len: Optional[int] = None) -> torch.Tensor:
        b, n, dim = x.shape
        qkv = self.qkv(x)
        if self._qkv_kernel_applicable(qkv, dim):
            return self.out(mha_qkv_attention(qkv, self.num_heads, valid_len=valid_len))
        heads = lambda t: t.reshape(b, n, self.num_heads, dim // self.num_heads)
        q, k, v = (heads(t) for t in qkv.split(dim, dim=-1))
        out = plain_attention(q, k, v, self.causal, valid_len)
        return self.out(out.reshape(b, n, dim))


class MLP(nn.Module):
    """Transformer MLP: c_fc -> quick_gelu -> c_proj."""

    def __init__(self, dim: int, hidden_mult: int = 4, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.c_fc = Linear(dim, hidden_mult * dim, dtype=dtype, gen=gen)
        self.c_proj = Linear(hidden_mult * dim, dim, dtype=dtype, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


def _keep_mask(shape, rate: float, gen: torch.Generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def drop_path(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth (the JAX package's `drop_path`): a sample's
    branch survives with probability 1 - rate, scaled by 1 / (1 - rate).
    The identity without a generator (deterministic) or at rate 0."""
    if gen is None or rate <= 0.0:
        return x
    mask = _keep_mask((x.shape[0],) + (1,) * (x.dim() - 1), rate, gen, x.device)
    return torch.where(mask, x * (1.0 / max(1.0 - rate, 1e-8)), torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Flax `nn.Dropout`: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate).  The identity without a generator or at rate 0."""
    if gen is None or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    mask = _keep_mask(x.shape, rate, gen, x.device)
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block: LN, attention, residual; LN, MLP, residual.

    With a generator each residual branch goes through `drop_path` at
    `drop_path_rate` (the JAX block's training branch).
    """

    def __init__(self, dim: int, num_heads: int, causal: bool = False,
                 attn_impl: str = ATTN_AUTO, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, num_heads, causal=causal, attn_impl=attn_impl,
                                       dtype=dtype, gen=gen)
        self.ln_2 = LayerNorm(dim)
        self.mlp = MLP(dim, dtype=dtype, gen=gen)

    def forward(self, x: torch.Tensor, valid_len: Optional[int] = None,
                drop_path_rate: float = 0.0, gen: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        attn_out = self.attn(self.ln_1(x).to(self.dtype), valid_len=valid_len)
        x = x + drop_path(attn_out, drop_path_rate, gen)
        return x + drop_path(self.mlp(self.ln_2(x).to(self.dtype)), drop_path_rate, gen)


class Transformer(nn.Module):
    """Stack of residual attention blocks, applied once each.

    Returns `(final, taps)` with `taps` [layers, B, N, D] holding every
    block's output, as the JAX package's scanned stack does.  Block i's
    drop-path rate is linspace(0, drop_path_rate, layers)[i].
    """

    def __init__(self, width: int, layers: int, heads: int, causal: bool = False,
                 attn_impl: str = ATTN_AUTO, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rates = [float(r) for r in torch.linspace(0.0, drop_path_rate, layers)]
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal=causal, attn_impl=attn_impl,
                                   dtype=dtype, gen=gen)
            for _ in range(layers)
        )

    def forward(self, x: torch.Tensor, valid_len: Optional[int] = None,
                gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        taps: List[torch.Tensor] = []
        for block, rate in zip(self.blocks, self.drop_path_rates):
            x = block(x, valid_len=valid_len, drop_path_rate=rate, gen=gen)
            taps.append(x)
        return x, torch.stack(taps)


def set_attn_impl(module: nn.Module, impl: str) -> None:
    """Switch every attention layer under `module` to `impl` ("auto"/"xla")."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {impl!r} not yet ported (have {ATTN_IMPLS})")
    for m in module.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_impl = impl


# --------------------------------------------------------------------------
# Conv blocks and resize
# --------------------------------------------------------------------------


def batch_norm_nhwc(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool = False) -> torch.Tensor:
    """BatchNorm in fp32 on an NHWC tensor with Flax's arithmetic:
    (x - mean) * (rsqrt(var + eps) * scale) + bias.

    Inference (`train=False`, whatever the module's own mode) uses the running
    statistics.  Training uses the batch's mean and BIASED variance (Flax's
    one-pass E[x^2] - E[x]^2, clamped at 0) and updates the running
    statistics in place as Flax does, momentum 0.9 on the old value and the
    biased variance.  `F.batch_norm` would store the unbiased variance.
    """
    xf = x.float()
    if not train:
        mean, var = bn.running_mean, bn.running_var
    else:
        mean = xf.mean(dim=(0, 1, 2))
        var = torch.clamp((xf * xf).mean(dim=(0, 1, 2)) - mean * mean, min=0.0)
        with torch.no_grad():
            bn.running_mean.mul_(0.9).add_(0.1 * mean.detach())
            bn.running_var.mul_(0.9).add_(0.1 * var.detach())
    return (xf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


class ConvBNReLU(nn.Module):
    """Conv(bias=False) + BatchNorm (eps 1e-5, fp32) + ReLU, NHWC in and out."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel_size, bias=False, dtype=dtype, gen=gen)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return F.relu(batch_norm_nhwc(self.conv(x), self.bn, train))


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int], antialias: bool = False
                    ) -> torch.Tensor:
    """Bilinear resize of NHWC (or [H, W, C]) with half-pixel centres.

    `F.interpolate(align_corners=False)` is `jax.image.resize(method=
    "bilinear")`; with `antialias` both widen the kernel when shrinking.
    """
    if x.dim() == 3:
        return resize_bilinear(x[None], size, antialias)[0]
    if x.dim() != 4:
        raise ValueError(f"resize_bilinear expects 3D/4D NHWC input, got {tuple(x.shape)}")
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=antialias)
    return y.permute(0, 2, 3, 1).to(x.dtype)
