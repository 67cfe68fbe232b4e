"""Prompt-learning CLIP text tower (PyTorch port of the JAX package's `models/text.py`).

`CLIPTextContextEncoder`: learnable context tokens are spliced between the
SOT token and the class-name tokens, the EOT index shifts by the number of
context tokens, and a causal transformer (plain attention) runs over
[B*K, N1+N2, C].  Single-pass transformer semantics, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from denseclip_vit_multimodal_tpu_torch.models.layers import (
    ATTN_XLA,
    LayerNorm,
    Transformer,
    normal,
)


class CLIPTextContextEncoder(nn.Module):
    """Prompt-learning text tower; `context_length` is the total N1 + N2."""

    def __init__(self, context_length: int = 22, vocab_size: int = 49408,
                 transformer_width: int = 512, transformer_heads: int = 8,
                 transformer_layers: int = 12, embed_dim: int = 512,
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.context_length = context_length
        self.transformer_width = transformer_width
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, transformer_width)
        with torch.no_grad():
            self.token_embedding.weight.copy_(normal((vocab_size, transformer_width), 0.02, gen))
        self.positional_embedding = nn.Parameter(
            normal((context_length, transformer_width), 0.01, gen))
        self.transformer = Transformer(transformer_width, transformer_layers, transformer_heads,
                                       causal=True, attn_impl=ATTN_XLA, dtype=dtype, gen=gen)
        self.ln_final = LayerNorm(transformer_width)
        self.text_projection = nn.Parameter(
            normal((transformer_width, embed_dim), transformer_width**-0.5, gen))

    def forward(self, text: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """text: [K, N1] int tokens; context: [B, N2, C] -> [B, K, embed_dim] fp32."""
        k, n1 = text.shape
        b, n2, c = context.shape
        if c != self.transformer_width or n1 + n2 != self.context_length:
            raise ValueError(
                f"text {tuple(text.shape)} + context {tuple(context.shape)} do not fit "
                f"capacity {self.context_length} at width {self.transformer_width}")
        x_text = self.token_embedding(text).to(self.dtype).expand(b, k, n1, c)
        ctx = context.to(self.dtype)[:, None].expand(b, k, n2, c)
        seq = torch.cat([x_text[:, :, :1], ctx, x_text[:, :, 1:]], dim=2).reshape(b * k, n1 + n2, c)
        seq = seq + self.positional_embedding.to(self.dtype)[None]
        seq, _ = self.transformer(seq)
        seq = self.ln_final(seq)
        eot_index = (text.argmax(dim=-1) + n2).repeat(b)  # [B*K]
        eot = seq.float()[torch.arange(b * k, device=seq.device), eot_index]
        return (eot @ self.text_projection).reshape(b, k, self.embed_dim)
