"""CLIP's anti-aliased ResNet backbones (PyTorch port of the JAX package's
`models/resnet.py`), NHWC in and out.

  * `Bottleneck` — all convs stride 1; an average pool of the stride sits
    before conv3 on the residual path and before the 1x1 conv on the
    downsample path.  Expansion 4.
  * `_Stem` — three 3x3 convs (the first at stride 2) with BatchNorm + ReLU,
    then a 2x2 average pool.
  * `CLIPResNet` — stem + four stages -> (c1, c2, c3, c4).
  * `CLIPResNetWithAttention` — the same trunk plus `AttentionPool2d` over
    c4: the mean token prepended, a learned positional embedding resized to
    the runtime grid (`vit.interpolate_pos_embed`), one 32-head attention
    with separate q / k / v projections and `c_proj`.  It returns
    (c1, c2, c3, c4, pooled map) and, with `return_global=True`, the pooled
    global feature beside them (the JAX module `sow`s it).

Average pools are VALID windows of the stride, so odd sizes floor.  Every
BatchNorm computes in fp32 (`batch_norm_nhwc`): in training with the batch
statistics, whose running averages it updates with Flax's rule.  So the stage
maps are fp32 whatever the compute dtype, as in the JAX module; the convs and
the pool's projections compute in `dtype`.  The attention pool runs plain
attention (the JAX module pins `impl="xla"`), never a kernel.  Module names
follow the JAX tree, with `layer{i}.block{j}` as `layer{i}.{j}` (OpenAI's
own key names).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from denseclip_vit_multimodal_tpu_torch.models.layers import (
    ATTN_XLA,
    Conv2d,
    Linear,
    attention_core,
    batch_norm_nhwc,
    lecun_normal,
    normal,
)
from denseclip_vit_multimodal_tpu_torch.models.vit import interpolate_pos_embed


def _avg_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """VALID average pool of a stride x stride window at that stride (NHWC)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), stride, stride)
    return y.permute(0, 2, 3, 1)


def _conv(cin: int, cout: int, k: int, dtype, gen, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, bias=False, dtype=dtype, kernel_init=lecun_normal, gen=gen,
                  stride=stride)


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    """Anti-aliased bottleneck (expansion 4)."""

    EXPANSION = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        super().__init__()
        out_planes = planes * self.EXPANSION
        self.stride = stride
        self.conv1, self.bn1 = _conv(in_channels, planes, 1, dtype, gen), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, dtype, gen), _bn(planes)
        self.conv3, self.bn3 = _conv(planes, out_planes, 1, dtype, gen), _bn(out_planes)
        self.downsample_conv = self.downsample_bn = None
        if stride > 1 or in_channels != out_planes:
            self.downsample_conv = _conv(in_channels, out_planes, 1, dtype, gen)
            self.downsample_bn = _bn(out_planes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(batch_norm_nhwc(self.conv1(x), self.bn1, train))
        out = F.relu(batch_norm_nhwc(self.conv2(out), self.bn2, train))
        if self.stride > 1:
            out = _avg_pool(out, self.stride)
        out = batch_norm_nhwc(self.conv3(out), self.bn3, train)
        identity = x
        if self.downsample_conv is not None:
            if self.stride > 1:
                identity = _avg_pool(identity, self.stride)
            identity = batch_norm_nhwc(self.downsample_conv(identity), self.downsample_bn, train)
        return F.relu(out + identity)


class _Stem(nn.Module):
    """Three 3x3 convs (the first at stride 2) + a 2x2 average pool."""

    def __init__(self, width: int, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        half = width // 2
        self.conv1, self.bn1 = _conv(3, half, 3, dtype, gen, stride=2), _bn(half)
        self.conv2, self.bn2 = _conv(half, half, 3, dtype, gen), _bn(half)
        self.conv3, self.bn3 = _conv(half, width, 3, dtype, gen), _bn(width)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)):
            x = F.relu(batch_norm_nhwc(conv(x), bn, train))
        return _avg_pool(x, 2)


class _Stage(nn.ModuleList):
    """`blocks` bottlenecks, the first at `stride`."""

    def __init__(self, in_channels: int, blocks: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        out = planes * Bottleneck.EXPANSION
        super().__init__(
            Bottleneck(in_channels if i == 0 else out, planes, stride if i == 0 else 1,
                       dtype=dtype, gen=gen)
            for i in range(blocks))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for block in self:
            x = block(x, train)
        return x


class CLIPResNet(nn.Module):
    """4-stage CLIP ResNet trunk -> (c1, c2, c3, c4) NHWC maps."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.layers = tuple(int(n) for n in layers)
        self.width = width
        self.dtype = dtype
        self.stem = _Stem(width, dtype=dtype, gen=gen)
        cin = width
        for i, (blocks, mult, stride) in enumerate(zip(self.layers, (1, 2, 4, 8), (1, 2, 2, 2))):
            self.add_module(f"layer{i + 1}", _Stage(cin, blocks, width * mult, stride,
                                                    dtype=dtype, gen=gen))
            cin = width * mult * Bottleneck.EXPANSION

    @property
    def stage_channels(self) -> Tuple[int, ...]:
        return tuple(self.width * m * Bottleneck.EXPANSION for m in (1, 2, 4, 8))

    def _trunk(self, x: torch.Tensor, train: bool) -> Tuple[torch.Tensor, ...]:
        x = self.stem(x, train)
        outs = []
        for i in range(len(self.layers)):
            x = getattr(self, f"layer{i + 1}")(x, train)
            outs.append(x)
        return tuple(outs)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """x: NHWC [B, H, W, 3] -> (c1, c2, c3, c4); `gen` is unused (no
        dropout), taken for the backbones' common signature."""
        return self._trunk(x, not deterministic)


class AttentionPool2d(nn.Module):
    """CLIP attention pooling -> (global [B, out], feature map [B, h, w, out])."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.spacial_dim = spacial_dim
        self.num_heads = num_heads
        self.output_dim = output_dim
        self.positional_embedding = nn.Parameter(
            normal((spacial_dim**2 + 1, embed_dim), embed_dim**-0.5, gen))
        proj = lambda n: Linear(embed_dim, n, dtype=dtype, gen=gen)
        self.q_proj, self.k_proj, self.v_proj = proj(embed_dim), proj(embed_dim), proj(embed_dim)
        self.c_proj = proj(output_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, h, w, c = x.shape
        seq = x.reshape(b, h * w, c)
        seq = torch.cat([seq.mean(dim=1, keepdim=True), seq], dim=1)
        pos = interpolate_pos_embed(self.positional_embedding, self.spacial_dim, (h, w))
        seq = seq + pos.to(seq.dtype)[None]
        n = seq.shape[1]
        heads = lambda t: t.reshape(b, n, self.num_heads, c // self.num_heads)
        out = attention_core(heads(self.q_proj(seq)), heads(self.k_proj(seq)),
                             heads(self.v_proj(seq)), causal=False, impl=ATTN_XLA)
        out = self.c_proj(out.reshape(b, n, c))
        return out[:, 0], out[:, 1:].reshape(b, h, w, self.output_dim)


class CLIPResNetWithAttention(CLIPResNet):
    """ResNet trunk + attention pool -> (c1, c2, c3, c4, pooled map)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 output_dim: int = 1024, input_resolution: int = 224,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        super().__init__(layers, width, dtype=dtype, gen=gen)
        self.output_dim = output_dim
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32, 32, output_dim,
                                        dtype=dtype, gen=gen)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                gen: Optional[torch.Generator] = None, return_global: bool = False):
        """x: NHWC [B, H, W, 3] -> (c1, c2, c3, c4, pooled map); with
        `return_global`, ((c1, ..., pooled map), global [B, output_dim])."""
        outs = self._trunk(x, not deterministic)
        global_feat, local_map = self.attnpool(outs[-1])
        maps = outs + (local_map,)
        return (maps, global_feat) if return_global else maps
