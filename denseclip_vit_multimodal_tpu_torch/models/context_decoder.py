"""Visual-to-text context decoder (PyTorch port of the JAX package's
`models/context_decoder.py`).

The memory (the visual context [B, 1+HW, visual_dim]) goes through LN ->
Linear -> LN, the text [B, K, visual_dim] through LN -> Linear, both to
`transformer_width`.  Then each layer runs pre-LN self-attention over the K
text queries, pre-LN cross-attention into the memory and a pre-LN MLP with
the exact GELU, each branch through dropout; last LN -> `out_proj` back to
`visual_dim`.  The module returns a delta, which the caller fuses as
`text + gamma * delta`.

Every LayerNorm here is Flax's default one, epsilon 1e-6 (CLIP's towers use
1e-5).  The q / k / v projections carry no bias, the output projections do.
Attention is plain PyTorch: K is the class count (19), and the JAX module
pins it to XLA.  Dropout draws from the generator handed to `forward`
(training); without one it is off.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from denseclip_vit_multimodal_tpu_torch.models.layers import (
    ATTN_XLA,
    FLAX_LAYER_NORM_EPS,
    LayerNorm,
    Linear,
    MultiHeadAttention,
    dropout,
    gelu,
)


def _ln(dim: int) -> LayerNorm:
    return LayerNorm(dim, epsilon=FLAX_LAYER_NORM_EPS)


class _DecoderLayer(nn.Module):
    """Pre-LN self-attention + cross-attention + MLP."""

    def __init__(self, width: int, heads: int, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        attn = lambda cross: MultiHeadAttention(width, heads, attn_impl=ATTN_XLA, dtype=dtype,
                                                gen=gen, use_qkv_bias=False, cross=cross)
        self.norm1, self.self_attn = _ln(width), attn(False)
        self.norm2, self.cross_attn = _ln(width), attn(True)
        self.norm3 = _ln(width)
        self.mlp_fc = Linear(width, 4 * width, dtype=dtype, gen=gen)
        self.mlp_proj = Linear(4 * width, width, dtype=dtype, gen=gen)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = lambda t: dropout(t, self.dropout_rate, gen)
        x = x + drop(self.self_attn(self.norm1(x)))
        x = x + drop(self.cross_attn(self.norm2(x), kv=memory))
        h = drop(gelu(self.mlp_fc(self.norm3(x))))
        return x + drop(self.mlp_proj(h))


class ContextDecoder(nn.Module):
    """Refines the text embeddings with the visual context; returns the delta."""

    def __init__(self, transformer_width: int = 256, transformer_heads: int = 4,
                 transformer_layers: int = 6, visual_dim: int = 1024, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        w = transformer_width
        self.memory_ln_in = _ln(visual_dim)
        self.memory_proj = Linear(visual_dim, w, dtype=dtype, gen=gen)
        self.memory_ln_out = _ln(w)
        self.text_ln = _ln(visual_dim)
        self.text_proj = Linear(visual_dim, w, dtype=dtype, gen=gen)
        self.layers = nn.ModuleList(
            _DecoderLayer(w, transformer_heads, dropout, dtype=dtype, gen=gen)
            for _ in range(transformer_layers))
        self.out_ln = _ln(w)
        self.out_proj = Linear(w, visual_dim, dtype=dtype, gen=gen)

    def forward(self, text: torch.Tensor, visual: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """text [B, K, visual_dim], visual [B, M, visual_dim] -> delta [B, K, visual_dim]
        in the compute dtype; `gen` draws the dropout masks (training)."""
        mem = self.memory_ln_out(self.memory_proj(self.memory_ln_in(visual)))
        x = self.text_proj(self.text_ln(text))
        for layer in self.layers:
            x = layer(x, mem, gen)
        return self.out_proj(self.out_ln(x))
