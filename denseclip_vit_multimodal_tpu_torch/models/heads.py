"""Decode heads (PyTorch port of the JAX package's `models/heads.py`):
`FCNHead` and the pass-through `IdentityHead`.

The reference assigns an extra `classifier` conv onto torchvision's FCNHead
Sequential, which APPENDS it, so the head is the 6-op chain

    Conv3x3(in -> in//4, no bias) -> BN -> ReLU -> Dropout(0.1)
    -> Conv1x1(in//4 -> channels) -> Conv1x1(channels -> num_outputs)

with `num_outputs` = num_classes for segmentation or 1 for depth.  NHWC.
In training (`train=True`) BatchNorm uses and updates the batch statistics and
dropout draws its mask from the given generator; in inference both are off.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from denseclip_vit_multimodal_tpu_torch.models.layers import (
    Conv2d,
    batch_norm_nhwc,
    dropout,
    normal,
)


class FCNHead(nn.Module):
    """FCN head matching the reference's appended-classifier chain."""

    def __init__(self, in_channels: int, channels: int, num_outputs: int,
                 dropout_ratio: float = 0.1, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        inter = in_channels // 4
        self.dropout_ratio = dropout_ratio
        self.conv0 = Conv2d(in_channels, inter, 3, bias=False, dtype=dtype, gen=gen)
        self.bn0 = nn.BatchNorm2d(inter, eps=1e-5, momentum=0.1)
        self.conv1 = Conv2d(inter, channels, 1, dtype=dtype, gen=gen)
        self.classifier = Conv2d(channels, num_outputs, 1, dtype=dtype,
                                 kernel_init=lambda s, g: normal(s, 0.01, g), gen=gen)

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(batch_norm_nhwc(self.conv0(x), self.bn0, train))
        x = dropout(x, self.dropout_ratio, gen if train else None)
        return self.classifier(self.conv1(x))


class IdentityHead(nn.Module):
    """Pass-through head."""

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return x
