"""Image normalisation on the device (PyTorch port of the JAX package's
`data/augment.py::normalize_image`; the training augmentations are not
ported yet)."""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch


class AugmentConfig(NamedTuple):
    """The normalisation part of the JAX package's `AugmentConfig` (CLIP stats)."""

    norm_mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    norm_std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)


def normalize_image(image: torch.Tensor, mean: Sequence[float], std: Sequence[float]
                    ) -> torch.Tensor:
    """uint8/float [..., 3] -> CLIP-normalized float32, on the image's device."""
    x = image.float() / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=image.device)
    std = torch.tensor(std, dtype=torch.float32, device=image.device)
    return (x - mean) / std
