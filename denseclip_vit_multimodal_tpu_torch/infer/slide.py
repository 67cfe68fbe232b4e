"""Batched sliding-window inference (PyTorch port of the JAX package's `infer/slide.py`).

  1. gather every window of every image into one [B*n_win, ch, cw, 3] batch;
  2. run `forward` over it, in chunks of `window_batch` windows when that is
     smaller than the batch (the last chunk is padded with duplicate windows,
     as the JAX package does); logits may come back at head resolution;
  3. upsample each window's logits to the crop in fp32, add it into an fp32
     canvas, and normalise by the window-coverage count.  The canvas `+=` per
     window replaces the JAX package's static strip decomposition; the sums
     agree up to fp32 summation order.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from denseclip_vit_multimodal_tpu_torch.models.layers import resize_bilinear
from denseclip_vit_multimodal_tpu_torch.parallel import mesh as mesh_lib


def window_origins(size: int, crop: int, stride: int) -> List[int]:
    """Window start offsets covering `size` (last window clamped flush)."""
    if size <= crop:
        return [0]
    n = int(np.ceil((size - crop) / stride)) + 1
    return [min(i * stride, size - crop) for i in range(n)]


def slide_grid(
    hw: Tuple[int, int], crop: Tuple[int, int], stride: Tuple[int, int]
) -> List[Tuple[int, int]]:
    ys = window_origins(hw[0], crop[0], stride[0])
    xs = window_origins(hw[1], crop[1], stride[1])
    return [(y, x) for y in ys for x in xs]


def count_map(
    hw: Tuple[int, int], crop: Tuple[int, int], stride: Tuple[int, int]
) -> np.ndarray:
    """[H, W] float32 window-coverage counts."""
    cnt = np.zeros(hw, np.float32)
    for y, x in slide_grid(hw, crop, stride):
        cnt[y : y + crop[0], x : x + crop[1]] += 1.0
    assert (cnt > 0).all(), "slide grid leaves uncovered pixels"
    return cnt


def clamp_protocol(hw: Tuple[int, int], crop: Tuple[int, int], stride: Tuple[int, int]
                   ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The (crop, stride) a frame of size `hw` is slid with: the window
    clamped to the frame, the stride to the window."""
    crop = (min(crop[0], hw[0]), min(crop[1], hw[1]))
    return crop, (min(stride[0], crop[0]), min(stride[1], crop[1]))


@functools.lru_cache(maxsize=8)
def inverse_count_map(
    hw: Tuple[int, int], crop: Tuple[int, int], stride: Tuple[int, int], device: torch.device
) -> torch.Tensor:
    """[H, W] fp32 1 / count on `device`, built once per grid (a constant of
    the compiled program in the JAX package)."""
    return torch.from_numpy(1.0 / count_map(hw, crop, stride)).to(device)


def _forward_windows(forward, flat: torch.Tensor, window_batch: int) -> torch.Tensor:
    """`forward` over the windows, in chunks of `window_batch` where that is
    smaller (the last chunk padded with duplicate windows)."""
    total = flat.shape[0]
    if window_batch and window_batch < total:
        pad = (-total) % window_batch
        padded = torch.cat([flat, flat[:pad]], dim=0) if pad else flat
        return torch.cat([forward(chunk) for chunk in padded.split(window_batch)])[:total]
    return forward(flat)


def slide_inference(
    forward: Callable[[torch.Tensor], torch.Tensor],
    image: torch.Tensor,  # [B, H, W, 3] preprocessed
    num_outputs: int,
    crop: Tuple[int, int] = (640, 640),
    stride: Tuple[int, int] = (426, 426),
    window_batch: int = 0,
    inverse_count: Optional[torch.Tensor] = None,
    shard_windows: bool = False,
) -> torch.Tensor:
    """Slide `forward` (windows [N, ch, cw, 3] -> logits [N, h', w', K]) over
    `image`; returns [B, H, W, num_outputs] fp32 averaged logits.
    `inverse_count` is `inverse_count_map` of this grid where the caller
    holds it, as an exported program does (the cache below would keep a
    traced tensor).  `shard_windows` spreads the windows over the process
    group (module docstring)."""
    b, h, w, _ = image.shape
    ch, cw = min(crop[0], h), min(crop[1], w)
    crop = (ch, cw)
    grid = slide_grid((h, w), crop, stride)
    n_win = len(grid)

    windows = torch.stack([image[:, y : y + ch, x : x + cw, :] for (y, x) in grid], dim=1)
    flat = windows.reshape(b * n_win, ch, cw, -1)

    total = b * n_win
    if shard_windows and mesh_lib.is_distributed():
        world, rank = mesh_lib.world_size(), mesh_lib.rank()
        counts = [total // world + (r < total % world) for r in range(world)]
        lo = sum(counts[:rank])
        # every rank runs as many windows as the busiest one (a short rank
        # repeats its last window and keeps none of the repeats): the ranks
        # make the same forward calls, which the ring's collectives need, and
        # a rank with no window learns the shape
        idx = [min(lo + i, total - 1) for i in range(counts[0])]
        mine = _forward_windows(forward, flat[idx], window_batch)
        logits = mesh_lib.gather_rows(mine[:counts[rank]].float(), counts)
    else:
        logits = _forward_windows(forward, flat, window_batch)
    lh, lw = logits.shape[1:3]
    logits = logits.reshape(b, n_win, lh, lw, num_outputs).float()

    canvas = torch.zeros(b, h, w, num_outputs, dtype=torch.float32, device=image.device)
    for i, (y, x) in enumerate(grid):
        win = logits[:, i]
        if (lh, lw) != (ch, cw):
            win = resize_bilinear(win, (ch, cw))
        canvas[:, y : y + ch, x : x + cw] += win
    if inverse_count is None:
        inverse_count = inverse_count_map((h, w), crop, tuple(stride), image.device)
    return canvas * inverse_count[None, :, :, None]
