"""Feature necks (PyTorch port of the JAX package's `models/necks.py`), NHWC.

  * `ViTFeatureFusionNeck` — per-level 3x3 ConvBNReLU(width -> inter),
    channel concat, 1x1 ConvBNReLU fuse to `out_channels`; `train` switches
    every BatchNorm to the batch statistics (and their update).
  * `FPN` — torchvision `FeaturePyramidNetwork` semantics: 1x1 laterals,
    top-down nearest upsample + add with torch's floor indexing
    (src = floor(dst * src_size / dst_size)), 3x3 output convs, and one extra
    `LastLevelMaxPool` level (a 1x1 window at stride 2) when `num_outs` asks
    for it.  Returns the pyramid finest first.

A PyTorch conv must know its input width when it is built, where Flax infers
it: both necks take `in_channels` per level (an int for every level alike),
which `build_denseclip` derives from the backbone and, at the level that
takes the score map, its number of classes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from denseclip_vit_multimodal_tpu_torch.models.layers import ConvBNReLU, Conv2d, lecun_normal


def _per_level(in_channels: Union[int, Sequence[int]], num_inputs: int) -> Tuple[int, ...]:
    if isinstance(in_channels, int):
        return (in_channels,) * num_inputs
    if len(in_channels) != num_inputs:
        raise ValueError(f"{len(in_channels)} input widths for {num_inputs} inputs")
    return tuple(int(c) for c in in_channels)


class ViTFeatureFusionNeck(nn.Module):
    """Fuse same-resolution ViT level maps into one [B, H, W, out] map."""

    def __init__(self, num_inputs: int, in_channels: Union[int, Sequence[int]], out_channels: int,
                 inter_channels: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        inter = inter_channels or out_channels
        self.num_inputs = num_inputs
        self.process = nn.ModuleList(
            ConvBNReLU(cin, inter, kernel_size=3, dtype=dtype, gen=gen)
            for cin in _per_level(in_channels, num_inputs)
        )
        self.fuse = ConvBNReLU(num_inputs * inter, out_channels, kernel_size=1, dtype=dtype, gen=gen)

    def forward(self, features: Sequence[torch.Tensor], train: bool = False) -> torch.Tensor:
        if len(features) != self.num_inputs:
            raise ValueError(f"neck expected {self.num_inputs} inputs, got {len(features)}")
        processed = [proc(feat, train) for proc, feat in zip(self.process, features)]
        return self.fuse(torch.cat(processed, dim=-1), train)


class FPN(nn.Module):
    """Feature Pyramid Network (torchvision semantics, NHWC), finest level first."""

    def __init__(self, num_inputs: int, in_channels: Union[int, Sequence[int]],
                 out_channels: int = 256, num_outs: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        super().__init__()
        widths = _per_level(in_channels, num_inputs)
        self.num_inputs = num_inputs
        self.num_outs = num_outs
        conv = lambda cin, k: Conv2d(cin, out_channels, k, dtype=dtype, kernel_init=lecun_normal,
                                     gen=gen)
        self.lateral = nn.ModuleList(conv(cin, 1) for cin in widths)
        self.output = nn.ModuleList(conv(out_channels, 3) for _ in widths)

    def forward(self, features: Sequence[torch.Tensor], train: bool = False
                ) -> Tuple[torch.Tensor, ...]:
        if len(features) != self.num_inputs:
            raise ValueError(f"FPN expected {self.num_inputs} inputs, got {len(features)}")
        laterals = [lat(feat) for lat, feat in zip(self.lateral, features)]
        for i in range(len(laterals) - 2, -1, -1):
            src = laterals[i + 1]
            oh, ow = laterals[i].shape[1:3]
            ys = torch.arange(oh, device=src.device) * src.shape[1] // oh
            xs = torch.arange(ow, device=src.device) * src.shape[2] // ow
            laterals[i] = laterals[i] + src[:, ys][:, :, xs]
        outs = [out(lat) for out, lat in zip(self.output, laterals)]
        num_outs = self.num_outs or len(outs)
        if num_outs > len(outs) + 1:
            raise ValueError(f"FPN num_outs={num_outs} > num_inputs+1={len(outs) + 1}")
        if num_outs > len(outs):
            outs.append(outs[-1][:, ::2, ::2])  # LastLevelMaxPool: a 1x1 window at stride 2
        return tuple(outs[:num_outs])
