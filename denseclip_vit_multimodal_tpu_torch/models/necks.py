"""ViT multi-level fusion neck (PyTorch port of the JAX package's `models/necks.py`).

`ViTFeatureFusionNeck`: per-level 3x3 ConvBNReLU(width -> inter), channel
concat, 1x1 ConvBNReLU fuse to `out_channels`.  NHWC in and out.  The FPN
neck of the ResNet presets is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from denseclip_vit_multimodal_tpu_torch.models.layers import ConvBNReLU


class ViTFeatureFusionNeck(nn.Module):
    """Fuse same-resolution ViT level maps into one [B, H, W, out] map."""

    def __init__(self, num_inputs: int, in_channels: int, out_channels: int,
                 inter_channels: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        inter = inter_channels or out_channels
        self.num_inputs = num_inputs
        self.process = nn.ModuleList(
            ConvBNReLU(in_channels, inter, kernel_size=3, dtype=dtype, gen=gen)
            for _ in range(num_inputs)
        )
        self.fuse = ConvBNReLU(num_inputs * inter, out_channels, kernel_size=1, dtype=dtype, gen=gen)

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(features) != self.num_inputs:
            raise ValueError(f"neck expected {self.num_inputs} inputs, got {len(features)}")
        processed = [proc(feat) for proc, feat in zip(self.process, features)]
        return self.fuse(torch.cat(processed, dim=-1))
