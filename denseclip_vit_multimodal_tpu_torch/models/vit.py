"""CLIP Vision Transformer backbone (PyTorch port of the JAX package's `models/vit.py`).

  * patch embedding as one [P*P*3 -> width] matmul over patches flattened in
    (row, column, channel) order — the JAX layout, so weights carry over;
  * class token + positional embedding, bilinearly resampled to the input
    grid (`interpolate_pos_embed`);
  * `ln_pre`, then the sequence is padded ONCE to a multiple of 128 when it
    has at least 1024 tokens; pad keys are masked through `valid_len` in
    every layer and the pad rows are sliced off the taps.  The qkv kernel
    takes any N, but keeping the pad gives it the same [B, 1536, 3*width]
    input as the TPU kernel at the slide shape;
  * `ln_post` on the last block's tap only; `out_indices` picks the taps
    returned as NHWC maps [B, H/P, W/P, width] (CLS token dropped).

`proj` is kept for checkpoint parity and unused in the dense forward.
`deterministic=False` with a generator applies drop path in the blocks at
rates linspace(0, drop_path_rate, layers), as the JAX training forward does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from denseclip_vit_multimodal_tpu_torch.models.layers import (
    ATTN_AUTO,
    LayerNorm,
    Linear,
    Transformer,
    normal,
    resize_bilinear,
    variance_scaling,
)


class CLIPVisionTransformer(nn.Module):
    """ViT backbone returning spatial feature maps at `out_indices`."""

    def __init__(self, patch_size: int = 16, width: int = 768, layers: int = 12,
                 heads: int = 12, input_resolution: int = 224,
                 out_indices: Sequence[int] = (11,), clip_proj_dim: int = 512,
                 attn_impl: str = ATTN_AUTO, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, drop_path_rate: float = 0.0):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.patch_size = patch_size
        self.width = width
        self.layers = layers
        self.base_grid = input_resolution // patch_size
        self.out_indices = tuple(sorted(set(int(i) for i in out_indices)))
        for idx in self.out_indices:
            if not 0 <= idx < layers:
                raise ValueError(f"out_index {idx} out of range for {layers} layers")
        self.dtype = dtype
        scale = width**-0.5
        ppc = patch_size * patch_size * 3
        self.patch_embed = Linear(
            ppc, width, bias=False, dtype=dtype,
            kernel_init=lambda s, g: variance_scaling(s, 1.0, "fan_in", g), gen=gen,
        )
        self.class_embedding = nn.Parameter(normal((width,), scale, gen))
        self.positional_embedding = nn.Parameter(normal((self.base_grid**2 + 1, width), scale, gen))
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, layers, heads, causal=False,
                                       attn_impl=attn_impl, dtype=dtype, gen=gen,
                                       drop_path_rate=drop_path_rate)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(normal((width, clip_proj_dim), scale, gen))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """x: NHWC image [B, H, W, 3] -> tuple of [B, H/P, W/P, width] maps.

        `gen` draws the drop-path masks when `deterministic` is False."""
        b, h, w, c = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} not divisible by patch {p}")
        gh, gw = h // p, w // p
        patches = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        tokens = self.patch_embed(patches.reshape(b, gh * gw, p * p * c))

        cls = self.class_embedding.to(self.dtype).expand(b, 1, self.width)
        seq = torch.cat([cls, tokens], dim=1)
        pos = interpolate_pos_embed(self.positional_embedding, self.base_grid, (gh, gw))
        seq = self.ln_pre(seq + pos.to(self.dtype)[None]).to(self.dtype)

        n_tokens = seq.shape[1]
        valid_len = None
        if n_tokens >= 1024 and n_tokens % 128:
            n_padded = -(-n_tokens // 128) * 128
            seq = torch.nn.functional.pad(seq, (0, 0, 0, n_padded - n_tokens))
            valid_len = n_tokens
        _, taps = self.transformer(seq, valid_len=valid_len,
                                   gen=None if deterministic else gen)  # [L, B, N(+pad), width]

        out = []
        for idx in self.out_indices:
            feat = taps[idx, :, :n_tokens]
            if idx == self.layers - 1:
                feat = self.ln_post(feat).to(self.dtype)
            out.append(feat[:, 1:].reshape(b, gh, gw, self.width))
        return tuple(out)


def interpolate_pos_embed(pos_embed: torch.Tensor, base_grid: int, grid: Tuple[int, int]
                          ) -> torch.Tensor:
    """Bilinearly resample a [1+G*G, D] pos-embed to a (gh, gw) grid.

    The CLS entry passes through.  Like `jax.image.resize`'s default, the
    resize antialiases when it shrinks; growing (14 -> 39 at crop 624) is
    plain align_corners=False bilinear.
    """
    gh, gw = grid
    if gh == base_grid and gw == base_grid:
        return pos_embed
    spatial = pos_embed[1:].reshape(base_grid, base_grid, -1)
    resized = resize_bilinear(spatial, (gh, gw), antialias=True)
    return torch.cat([pos_embed[:1], resized.reshape(gh * gw, -1)], dim=0)
