"""Training augmentation on the device (PyTorch port of the JAX package's
`data/augment.py`).

The reference's Albumentations chain RandomScale(0.5-2.0) -> PadIfNeeded
(image 0, mask 255) -> RandomCrop(crop) -> HFlip(0.5) -> Normalize is one
fixed-shape resampling: output pixel (i, j) of the crop reads source

    y = (i + oy + 0.5) / sy - 0.5,    x = (j' + ox + 0.5) / sx - 0.5

(j' the flipped column with probability 0.5), bilinear for the image and
nearest for seg / depth, pad positions filled with 0 / 255 / 0.  As in the
JAX package the resampling is separable and runs as two matrix products per
array (`out = Wy @ src @ Wx^T`); the geometry (scale, integer crop offset,
flip) is drawn per sample on the host from a `torch.Generator`, so the
device never waits on a random number.  The depth mask is depth > 0 after
the transform.  ColorJitter is not ported: asking for it raises.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

Geometry = Tuple[float, float, float, float, bool]  # (sy, sx, oy, ox, flip)


class AugmentConfig(NamedTuple):
    crop_size: Tuple[int, int] = (512, 1024)
    scale_range: Tuple[float, float] = (0.5, 2.0)
    hflip_prob: float = 0.5
    norm_mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    norm_std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)
    ignore_index: int = 255


def normalize_image(image: torch.Tensor, mean: Sequence[float], std: Sequence[float]
                    ) -> torch.Tensor:
    """uint8/float [..., 3] -> CLIP-normalized float32, on the image's device."""
    x = image.float() / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=image.device)
    std = torch.tensor(std, dtype=torch.float32, device=image.device)
    return (x - mean) / std


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _sample_geometry(gen: torch.Generator, src_hw: Tuple[int, int],
                     cfg: AugmentConfig) -> Geometry:
    """Draw (scale_y, scale_x, oy, ox, flip) for one image, in float32.

    cv2.resize to ROUNDED integer dims, then an integer crop offset in the
    scaled canvas: uniform in [0, scaled - crop] when the image covers the
    crop, else centred padding (offset -floor((crop - scaled) / 2)).
    """
    h, w = src_hw
    ch, cw = cfg.crop_size
    u = torch.rand(4, generator=gen, dtype=torch.float32)
    lo, hi = cfg.scale_range
    s = _f32(lo) + (_f32(hi) - _f32(lo)) * u[0]
    sh, sw = torch.round(s * h), torch.round(s * w)

    def offset(uu, scaled, crop):
        if scaled >= crop:
            span = scaled - crop
            return torch.floor(uu * (span + 1.0)).clamp(0.0, float(span))
        return -torch.floor((crop - scaled) / 2.0)

    oy, ox = offset(u[1], sh, float(ch)), offset(u[2], sw, float(cw))
    return (float(sh / h), float(sw / w), float(oy), float(ox), bool(u[3] < cfg.hflip_prob))


def _source_coords_1d(geometry: Geometry, crop: Tuple[int, int], src_hw: Tuple[int, int],
                      device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Half-pixel source coordinates per output row / column (separable).

    Image positions are clamped to [0, src - 1] (cv2 samples the edge pixel at
    full weight); pad positions get the sentinel -2, far enough outside that
    both the tent and the nearest rows are all zero.
    """
    sy, sx, oy, ox, flip = geometry
    ch, cw = crop
    h, w = src_hw

    def coords(idx, o, s, n):
        c = idx + _f32(o).to(idx.device)
        s = _f32(s).to(idx.device)
        src = (c + 0.5) / s - 0.5
        extent = torch.round(s * n)
        is_img = (c >= 0.0) & (c <= extent - 1.0)
        return torch.where(is_img, src.clamp(0.0, n - 1.0), torch.full_like(src, -2.0))

    i = torch.arange(ch, dtype=torch.float32, device=device)
    j = torch.arange(cw, dtype=torch.float32, device=device)
    if flip:
        j = (cw - 1) - j
    return coords(i, oy, sy, h), coords(j, ox, sx, w)


def _interp_matrices(y: torch.Tensor, x: torch.Tensor, src_hw: Tuple[int, int]):
    """Separable resampling matrices (bilinear tent rows, nearest one-hot rows):
    Wy [ch, H], Wx [cw, W]; coordinates outside the source give zero rows."""
    h, w = src_hw
    sy = torch.arange(h, dtype=torch.float32, device=y.device)[None, :]
    sx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    wy_lin = (1.0 - (y[:, None] - sy).abs()).clamp(min=0.0)
    wx_lin = (1.0 - (x[:, None] - sx).abs()).clamp(min=0.0)
    wy_nn = (torch.round(y)[:, None] == sy).float()
    wx_nn = (torch.round(x)[:, None] == sx).float()
    return wy_lin, wx_lin, wy_nn, wx_nn


def _resample_bilinear_mm(img: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """[H, W, C] x [ch, H] x [cw, W] -> [ch, cw, C] as two matrix products."""
    tmp = torch.einsum("oh,hwc->owc", wy, img.float())
    return torch.einsum("pw,owc->opc", wx, tmp)


def _resample_nearest_mm(arr: torch.Tensor, wy_nn: torch.Tensor, wx_nn: torch.Tensor,
                         fill) -> torch.Tensor:
    """Nearest resample of [H, W] through one-hot products; empty rows -> fill."""
    vals = _resample_bilinear_mm(arr.float()[..., None], wy_nn, wx_nn)[..., 0]
    inside = (wy_nn.sum(-1) > 0)[:, None] & (wx_nn.sum(-1) > 0)[None, :]
    vals = torch.where(inside, vals, torch.full_like(vals, float(fill)))
    return vals.to(arr.dtype) if arr.is_floating_point() else torch.round(vals).to(arr.dtype)


def augment_sample(image: torch.Tensor, seg: Optional[torch.Tensor], depth: Optional[torch.Tensor],
                   cfg: AugmentConfig, geometry: Geometry) -> Dict[str, torch.Tensor]:
    """One sample through the fused chain, given its geometry: image [H, W, 3],
    seg [H, W] int, depth [H, W] float -> crop-sized arrays on their device."""
    src_hw = (image.shape[0], image.shape[1])
    y, x = _source_coords_1d(geometry, cfg.crop_size, src_hw, device=image.device)
    wy_lin, wx_lin, wy_nn, wx_nn = _interp_matrices(y, x, src_hw)
    out: Dict[str, torch.Tensor] = {}
    if seg is not None:
        out["seg"] = _resample_nearest_mm(seg.to(torch.int32), wy_nn, wx_nn, cfg.ignore_index)
    if depth is not None:
        d = _resample_nearest_mm(depth.float(), wy_nn, wx_nn, 0.0)
        out["depth"] = d
        out["depth_mask"] = d > 0.0
    img = _resample_bilinear_mm(image, wy_lin, wx_lin)
    out["image"] = normalize_image(img, cfg.norm_mean, cfg.norm_std)
    return out


def augment_batch(batch: Dict[str, torch.Tensor], cfg: AugmentConfig, gen: torch.Generator
                  ) -> Dict[str, torch.Tensor]:
    """Augment every sample of `batch` ('image' [B,H,W,3]; optional 'seg',
    'depth' [B,H,W]) with geometry drawn from the host generator `gen`."""
    image = batch["image"]
    src_hw = (image.shape[1], image.shape[2])
    samples = [
        augment_sample(image[i], None if "seg" not in batch else batch["seg"][i],
                       None if "depth" not in batch else batch["depth"][i],
                       cfg, _sample_geometry(gen, src_hw, cfg))
        for i in range(image.shape[0])
    ]
    return {k: torch.stack([s[k] for s in samples]) for k in samples[0]}


def augment_config_from_data_cfg(data_cfg) -> AugmentConfig:
    """The training AugmentConfig from the `data:` config section (the JAX
    package's keys)."""
    aug = data_cfg.get("augment", {}) or {}
    jitter = bool(data_cfg.get("color_jitter", False)) or any(
        float(aug.get(k, 0.0)) for k in ("brightness", "contrast", "saturation", "hue"))
    if jitter:
        raise ValueError("ColorJitter is not yet ported to the PyTorch package")
    return AugmentConfig(
        crop_size=tuple(data_cfg.get("crop_size", (512, 1024))),
        scale_range=tuple(data_cfg.get("scale_range", (0.5, 2.0))),
        hflip_prob=float(aug.get("hflip_prob", 0.5)),
        norm_mean=tuple(data_cfg.get("norm_mean", AugmentConfig().norm_mean)),
        norm_std=tuple(data_cfg.get("norm_std", AugmentConfig().norm_std)),
        ignore_index=int(data_cfg.get("ignore_label", 255)),
    )
