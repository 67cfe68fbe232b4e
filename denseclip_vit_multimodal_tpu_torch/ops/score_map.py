"""Pixel-text score map (PyTorch port of the JAX package's `ops/score_map.py`).

    score[b, h, w, k] = <visual[b, h, w, :] / |visual|, text[b, k, :] / |text|>

computed as in the JAX package: normalize the small text matrix, contract,
and scale rows by the visual inverse norms.  NHWC: visual [B, H, W, C],
text [B, K, C] -> scores [B, H, W, K] in fp32.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2) semantics: x / max(|x|, eps), norm taken in fp32."""
    norm = x.float().square().sum(dim=dim, keepdim=True).sqrt()
    return (x / norm.clamp_min(eps).to(x.dtype)).to(x.dtype)


def score_map(visual: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
    """Cosine-similarity score map in fp32, [B, H, W, K]."""
    vis = visual.float()
    txt_n = l2_normalize(text.float())
    raw = torch.einsum("bhwc,bkc->bhwk", vis, txt_n)
    inv_norm = torch.rsqrt(vis.square().sum(dim=-1, keepdim=True).clamp_min(1e-24))
    return raw * inv_norm
