"""Shared transformer / conv building blocks (PyTorch, NHWC at the boundaries).

Port of the JAX package's `models/layers.py`.  Parameters are kept in fp32 and
cast to the module's compute `dtype` at each use, as Flax's `param_dtype` /
`dtype` split does; LayerNorm and BatchNorm compute in fp32.

  * `LayerNorm` / `layer_norm_apply` — fp32 statistics, eps 1e-5, result cast
    back to the input dtype.
  * `quick_gelu` — x * sigmoid(1.702 x).
  * `MultiHeadAttention` — fused [D, 3D] qkv projection; for non-causal bf16
    sequences of 1024..8448 tokens on CUDA the attention runs in the qkv
    kernel (`ops/mha_kernel.py`, K1), otherwise through `attention_core`:
    the flash kernel (`ops/attention.py`, K4) for causal or longer bf16
    sequences on CUDA, plain PyTorch (`plain_attention`) for the rest.
    With `attn_impl="int8"` (the opt-in quantized serving path) non-causal
    sequences of at most 8448 tokens on CUDA take the int8 kernel (K5)
    instead, and everything else the `auto` rules.  With
    `DENSECLIP_FUSED_LNQKV=1` the block's LayerNorm, the qkv projection and
    the attention run as one kernel (`ops/lnqkv_kernel.py`, K6) on the
    inference path, where the rule below holds.
  * `MLP`, `ResidualAttentionBlock` (pre-LN; per-sample drop path when
    training) and `Transformer`, a loop over its blocks that returns
    `(final, taps[L, B, N, D])`, with drop-path rates rising linearly over
    the layers.  `Transformer(remat=...)` takes the `tpu.remat` value
    (`resolve_remat_policy`: false, or true / "full") and recomputes each
    block in the backward (`torch.utils.checkpoint`) while autograd records;
    drop-path masks are drawn before each block, so a recompute sees the
    same masks.
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
import os
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from denseclip_vit_multimodal_tpu_torch.ops import attention as _attention
from denseclip_vit_multimodal_tpu_torch.ops.attention import (
    _FLASH_MIN_SEQ,
    _ONESHOT_MAX_SEQ,
    flash_attention,
    flash_supported,
    plain_attention,
)
from denseclip_vit_multimodal_tpu_torch.ops.lnqkv_kernel import ln_qkv_attention, lnqkv_supported
from denseclip_vit_multimodal_tpu_torch.ops.mha_kernel import (
    mha_qkv_attention,
    mha_qkv_attention_int8,
    qkv_supported,
)

ATTN_XLA = "xla"  # plain PyTorch attention everywhere (name kept from the JAX package)
ATTN_AUTO = "auto"  # the kernels where the dispatch rules hold
ATTN_INT8 = "int8"  # the opt-in quantized serving path (K5; inference only)
ATTN_IMPLS = (ATTN_AUTO, ATTN_XLA, ATTN_INT8)


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


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    impl: str = ATTN_AUTO,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Attention on [B, N, H, Dh] by the configured impl (the JAX package's
    `attention_core` for `auto`, `xla` and `int8`): `auto` takes
    `flash_attention` where `flash_supported` holds, and plain attention
    elsewhere.  `int8` quantizes only in the fused-qkv path, so what reaches
    this core (causal, more than 8448 tokens, the CPU) takes `auto`."""
    if impl == ATTN_INT8:
        impl = ATTN_AUTO
    if impl == ATTN_AUTO and flash_supported(q):
        return flash_attention(q, k, v, causal=causal, valid_len=valid_len)
    return plain_attention(q, k, v, causal, valid_len)


class MultiHeadAttention(nn.Module):
    """CLIP-style multi-head self-attention with a fused QKV projection.

    Parameters: `qkv` Linear(D, 3D) and `out` Linear(D, D).  The kernel
    dispatch rule is the JAX package's (`_qkv_kernel_applicable`) with "on
    the TPU" read as "on CUDA", plus K1's one dtype, bf16 (K5 takes bf16 and
    fp32).
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

    def _qkv_kernel_applicable(self, qkv: torch.Tensor, dim: int,
                               dtype: Optional[torch.dtype] = None) -> bool:
        """`dtype`: the compute dtype the kernel would see (default qkv's)."""
        if self.attn_impl == ATTN_XLA or self.causal:
            return False
        n = qkv.shape[1]
        if self.attn_impl == ATTN_INT8:  # no 1024-token floor, any dtype K5 writes
            regime = _attention._on_cuda(qkv) and n <= _ONESHOT_MAX_SEQ
        else:
            regime = (_attention._on_cuda(qkv) and (dtype or qkv.dtype) == torch.bfloat16
                      and _FLASH_MIN_SEQ <= n <= _ONESHOT_MAX_SEQ)
        return regime and qkv_supported(self.num_heads, dim)

    def _lnqkv_applicable(self, x: torch.Tensor, dim: int) -> bool:
        """The JAX rule for the fused LN + qkv + attention kernel (K6), read
        on every call: `DENSECLIP_FUSED_LNQKV=1`, not causal (the qkv
        projection always has a bias here), K1's regime for the attn_impl
        (under `int8` that is K6 at any N up to 8448, unquantized: JAX checks
        the fused branch first), `qkv_supported` and `lnqkv_supported` at N.
        K6 takes bf16 only where it runs, on a CUDA tensor; a CPU tensor (the
        tests patch `_on_cuda`) runs its plain version, which takes fp32 too.
        The JAX package keeps the fusion opt-in: it lost 7% end to end on a
        TPU v5e."""
        if os.environ.get("DENSECLIP_FUSED_LNQKV", "0") != "1" or self.causal:
            return False
        if x.is_cuda and self.qkv.compute_dtype != torch.bfloat16:
            return False
        return (self._qkv_kernel_applicable(x, dim, torch.bfloat16)
                and lnqkv_supported(self.num_heads, dim, n=x.shape[1]))

    def forward(self, x: torch.Tensor, valid_len: Optional[int] = None,
                pre_ln: Optional[Tuple[torch.Tensor, torch.Tensor, float]] = None
                ) -> torch.Tensor:
        """Self-attention.  `pre_ln=(scale, bias, eps)` hands the preceding
        LayerNorm's affine parameters in unapplied, so that K6 can serve the
        whole chain; where it does not, the norm is applied here and the
        other routes follow.  The parameters are the same either way."""
        b, n, dim = x.shape
        if pre_ln is not None:
            ln_scale, ln_bias, ln_eps = pre_ln
            if self._lnqkv_applicable(x, dim):
                out = ln_qkv_attention(x.to(self.qkv.compute_dtype), ln_scale, ln_bias,
                                       self.qkv.weight.t(), self.qkv.bias, self.num_heads,
                                       eps=ln_eps, valid_len=valid_len)
                return self.out(out)
            x = layer_norm_apply(x, ln_scale, ln_bias, ln_eps).to(self.qkv.compute_dtype)
        qkv = self.qkv(x)
        if self._qkv_kernel_applicable(qkv, dim):
            attn = mha_qkv_attention_int8 if self.attn_impl == ATTN_INT8 else mha_qkv_attention
            return self.out(attn(qkv, self.num_heads, valid_len=valid_len))
        # strided views of the fused projection (row stride 3 * dim), no copy
        heads = lambda t: t.view(b, n, self.num_heads, dim // self.num_heads)
        q, k, v = (heads(t) for t in qkv.split(dim, dim=-1))
        out = attention_core(q, k, v, causal=self.causal, impl=self.attn_impl,
                             valid_len=valid_len)
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


def drop_path(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample stochastic depth (the JAX package's `drop_path`): a sample's
    branch survives with probability 1 - rate, scaled by 1 / (1 - rate).
    The identity without a generator (deterministic) or at rate 0.  `keep`,
    a mask drawn beforehand by `drop_path_mask`, takes the generator's place."""
    if keep is None:
        if gen is None or rate <= 0.0:
            return x
        keep = drop_path_mask(x.shape, rate, gen, x.device)
    return torch.where(keep, x * (1.0 / max(1.0 - rate, 1e-8)), torch.zeros_like(x))


def drop_path_mask(shape, rate: float, gen: torch.Generator, device) -> torch.Tensor:
    """The [B, 1, ...] keep mask `drop_path` would draw for a tensor of `shape`."""
    return _keep_mask((shape[0],) + (1,) * (len(shape) - 1), rate, gen, device)


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
    `drop_path_rate` (the JAX block's training branch).  Without one (the
    JAX block's `deterministic`, inference) a non-causal block hands ln_1's
    parameters to the attention unapplied, so that the fused kernel (K6)
    can serve LN + qkv + attention where its rule holds.
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
                drop_path_rate: float = 0.0, gen: Optional[torch.Generator] = None,
                keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """`keep`: the two branches' drop-path masks, drawn beforehand (in the
        order the block would draw them from `gen`) so that a recompute of
        the block sees the same ones."""
        if gen is None and not self.attn.causal:
            attn_out = self.attn(x, valid_len=valid_len,
                                 pre_ln=(self.ln_1.weight, self.ln_1.bias, self.ln_1.epsilon))
        else:
            attn_out = self.attn(self.ln_1(x).to(self.dtype), valid_len=valid_len)
        keep_attn, keep_mlp = (None, None) if keep is None else keep
        x = x + drop_path(attn_out, drop_path_rate, gen, keep_attn)
        return x + drop_path(self.mlp(self.ln_2(x).to(self.dtype)), drop_path_rate, gen, keep_mlp)


# The JAX package's selective policies (checkpoint names, dots saveable).
UNPORTED_REMAT = ("attn", "attn_qkv", "dots")


def resolve_remat_policy(remat: Any) -> Optional[str]:
    """The `tpu.remat` config value as a policy name, or None for no remat
    (the JAX package's `resolve_remat_policy`):

    - false                        -> None: every activation kept
    - true / "full"                -> "full": each block recomputed from its
                                      input in the backward
    - "attn", "attn_qkv", "dots"   -> ValueError: not yet ported
    - anything else                -> the JAX package's ValueError
    """
    if not remat:
        return None
    if remat is True or remat == "full":
        return "full"
    if isinstance(remat, str) and remat in UNPORTED_REMAT:
        raise ValueError(f"tpu.remat={remat} not yet ported (have false, true / 'full')")
    raise ValueError(
        f"Unsupported remat mode {remat!r}: expected false, true/'full', "
        "'attn', 'attn_qkv', or 'dots'"
    )


class Transformer(nn.Module):
    """Stack of residual attention blocks, applied once each.

    Returns `(final, taps)` with `taps` [layers, B, N, D] holding every
    block's output, as the JAX package's scanned stack does.  Block i's
    drop-path rate is linspace(0, drop_path_rate, layers)[i].  With a
    `remat` policy (`resolve_remat_policy`) each block runs under
    `torch.utils.checkpoint` while autograd records, keeping only its input.
    Drop-path masks are drawn before each block either way, in the order the
    block would draw them, so a recompute sees the same masks.
    """

    def __init__(self, width: int, layers: int, heads: int, causal: bool = False,
                 attn_impl: str = ATTN_AUTO, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, drop_path_rate: float = 0.0,
                 remat: Any = False):
        super().__init__()
        self.remat = resolve_remat_policy(remat)
        self.drop_path_rates = [float(r) for r in torch.linspace(0.0, drop_path_rate, layers)]
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal=causal, attn_impl=attn_impl,
                                   dtype=dtype, gen=gen)
            for _ in range(layers)
        )

    def forward(self, x: torch.Tensor, valid_len: Optional[int] = None,
                gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        taps: List[torch.Tensor] = []
        remat = self.remat is not None and torch.is_grad_enabled()
        for block, rate in zip(self.blocks, self.drop_path_rates):
            keep = None
            if gen is not None and rate > 0.0:
                keep = tuple(drop_path_mask(x.shape, rate, gen, x.device) for _ in range(2))
            if remat:
                x = torch.utils.checkpoint.checkpoint(block, x, valid_len, rate, gen, keep,
                                                      use_reentrant=False)
            else:
                x = block(x, valid_len=valid_len, drop_path_rate=rate, gen=gen, keep=keep)
            taps.append(x)
        return x, torch.stack(taps)


def set_attn_impl(module: nn.Module, impl: str) -> None:
    """Switch every attention layer under `module` to `impl` ("auto", "xla"
    or "int8"; a causal layer under "int8" keeps the `auto` rules)."""
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
