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
the transform.

ColorJitter (the reference's `A.ColorJitter(0.4, 0.4, 0.4, hue=0.1, p=0.8)`
under `color_jitter: true`) runs on the device after the resampling (so
after the flip) and before normalisation, on [0, 255] float RGB, with the
JAX package's formulas: brightness, contrast and saturation factors uniform
in [max(0, 1 - x), 1 + x], the hue offset uniform in [-hue, hue], contrast
and saturation blended against the ITU-R 601 gray (its mean for contrast),
hue through HSV, the four in a random order, the whole with probability
`color_jitter_prob`.  Its draws come from the same host generator, after the
sample's geometry; `color_jitter` takes them explicitly.

`eval_preprocess_batch` is the validation transform: resize to the crop
(antialiased, as `jax.image.resize`) and normalise; labels keep their size.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from denseclip_vit_multimodal_tpu_torch.models.layers import resize_bilinear

Geometry = Tuple[float, float, float, float, bool]  # (sy, sx, oy, ox, flip)
# (brightness, contrast, saturation factors, hue offset, order of the four ops)
Jitter = Tuple[float, float, float, float, Tuple[int, ...]]


class AugmentConfig(NamedTuple):
    crop_size: Tuple[int, int] = (512, 1024)
    scale_range: Tuple[float, float] = (0.5, 2.0)
    hflip_prob: float = 0.5
    norm_mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    norm_std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)
    ignore_index: int = 255
    # ColorJitter half-ranges; all zero disables it
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    hue: float = 0.0
    color_jitter_prob: float = 1.0


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


def _sample_jitter(gen: torch.Generator, cfg: AugmentConfig) -> Optional[Jitter]:
    """Draw one sample's ColorJitter: None when the config has none or the
    draw against `color_jitter_prob` skips it."""
    if not (cfg.brightness or cfg.contrast or cfg.saturation or cfg.hue):
        return None
    u = torch.rand(5, generator=gen, dtype=torch.float32)
    order = tuple(torch.randperm(4, generator=gen).tolist())

    def factor(uu, half):
        lo, hi = _f32(max(0.0, 1.0 - half)), _f32(1.0 + half)
        return float(lo + (hi - lo) * uu)

    if not bool(u[4] < cfg.color_jitter_prob):
        return None
    return (factor(u[0], cfg.brightness), factor(u[1], cfg.contrast),
            factor(u[2], cfg.saturation), float(_f32(-cfg.hue) + _f32(2 * cfg.hue) * u[3]), order)


def _rgb_to_hsv(rgb: torch.Tensor):
    """[..., 3] RGB in [0, 1] -> (h, s, v), h in [0, 1)."""
    r, g, b = rgb.unbind(-1)
    maxc, minc = rgb.amax(-1), rgb.amin(-1)
    delta = maxc - minc
    safe = delta.clamp(min=1e-12)
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12), zero)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), zero)
    return h, s, maxc


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    idx = (i.to(torch.int64) % 6)[..., None]
    pick = lambda *c: torch.stack(c, -1).gather(-1, idx)[..., 0]
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


_GRAY_WEIGHTS = (0.299, 0.587, 0.114)  # ITU-R 601, torchvision's rgb_to_grayscale


def _gray(img: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(_GRAY_WEIGHTS, dtype=torch.float32, device=img.device)
    return (img * w).sum(-1, keepdim=True)


def color_jitter(img: torch.Tensor, jitter: Jitter) -> torch.Tensor:
    """ColorJitter of [..., 3] float RGB in [0, 255] with the given factors,
    hue offset and order of the ops (0 brightness, 1 contrast, 2 saturation,
    3 hue)."""
    fb, fc, fs, fh, order = jitter

    def brightness(x):
        return (x * fb).clamp(0.0, 255.0)

    def contrast(x):
        m = _gray(x).mean()
        return (fc * x + (1.0 - fc) * m).clamp(0.0, 255.0)

    def saturation(x):
        return (fs * x + (1.0 - fs) * _gray(x)).clamp(0.0, 255.0)

    def hue(x):
        h, s, v = _rgb_to_hsv(x / 255.0)
        return _hsv_to_rgb(torch.remainder(h + fh, 1.0), s, v) * 255.0

    ops = (brightness, contrast, saturation, hue)
    for t in order:
        img = ops[t](img)
    return img


def augment_sample(image: torch.Tensor, seg: Optional[torch.Tensor], depth: Optional[torch.Tensor],
                   cfg: AugmentConfig, geometry: Geometry, jitter: Optional[Jitter] = None
                   ) -> Dict[str, torch.Tensor]:
    """One sample through the fused chain, given its geometry and jitter (None:
    none): image [H, W, 3], seg [H, W] int, depth [H, W] float -> crop-sized
    arrays on their device."""
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
    if jitter is not None:
        img = color_jitter(img, jitter)
    out["image"] = normalize_image(img, cfg.norm_mean, cfg.norm_std)
    return out


def augment_batch(batch: Dict[str, torch.Tensor], cfg: AugmentConfig, gen: torch.Generator,
                  rows: Optional[Sequence[int]] = None, total: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """Augment every sample of `batch` ('image' [B,H,W,3]; optional 'seg',
    'depth' [B,H,W]) with geometry and jitter drawn from the host generator
    `gen`, sample by sample.

    A data-parallel rank holds some rows of a global batch of `total` rows:
    `rows[i]` is the global row of its sample i.  It draws every global
    row's geometry and jitter in order (host scalars) and applies only its
    own, so each global row gets what a one-process step draws for it.
    Without `rows` the batch is the whole of it."""
    image = batch["image"]
    src_hw = (image.shape[1], image.shape[2])
    if rows is None:
        rows, total = range(image.shape[0]), image.shape[0]
    draws = [(_sample_geometry(gen, src_hw, cfg), _sample_jitter(gen, cfg))
             for _ in range(total)]
    samples = [augment_sample(image[i], None if "seg" not in batch else batch["seg"][i],
                              None if "depth" not in batch else batch["depth"][i],
                              cfg, *draws[g]) for i, g in enumerate(rows)]
    return {k: torch.stack([s[k] for s in samples]) for k in samples[0]}


def eval_preprocess_batch(batch: Dict[str, torch.Tensor], cfg: AugmentConfig
                          ) -> Dict[str, torch.Tensor]:
    """Validation path: resize to the crop size, then normalise.

    The reference's val transform Resize(crop) -> Normalize; labels and
    depth stay at their own resolution (predictions are resized back to them
    before scoring).  Adds `depth_mask` = depth > 0 when depth is present.
    """
    img = batch["image"].float()
    if tuple(img.shape[1:3]) != tuple(cfg.crop_size):
        img = resize_bilinear(img, tuple(cfg.crop_size), antialias=True)
    out = dict(batch)
    out["image"] = normalize_image(img, cfg.norm_mean, cfg.norm_std)
    if "depth" in batch:
        out["depth_mask"] = batch["depth"] > 0.0
    return out


def augment_config_from_data_cfg(data_cfg, train: bool = True) -> AugmentConfig:
    """The AugmentConfig from the `data:` config section (the JAX package's
    keys); `train=False` gives the evaluation one (no flip, no jitter).
    `color_jitter: true` sets the reference's 0.4 / 0.4 / 0.4 / hue 0.1 at
    p 0.8; `augment.{brightness,contrast,saturation,hue,color_jitter_prob}`
    override them."""
    aug = data_cfg.get("augment", {}) or {}
    cj = bool(data_cfg.get("color_jitter", False)) and train
    jitter = lambda key, on: float(aug.get(key, on if cj else 0.0)) if train else 0.0
    return AugmentConfig(
        crop_size=tuple(data_cfg.get("crop_size", (512, 1024))),
        scale_range=tuple(data_cfg.get("scale_range", (0.5, 2.0))),
        hflip_prob=float(aug.get("hflip_prob", 0.5)) if train else 0.0,
        norm_mean=tuple(data_cfg.get("norm_mean", AugmentConfig().norm_mean)),
        norm_std=tuple(data_cfg.get("norm_std", AugmentConfig().norm_std)),
        ignore_index=int(data_cfg.get("ignore_label", 255)),
        brightness=jitter("brightness", 0.4),
        contrast=jitter("contrast", 0.4),
        saturation=jitter("saturation", 0.4),
        hue=jitter("hue", 0.1),
        color_jitter_prob=float(aug.get("color_jitter_prob", 0.8 if cj else 1.0)),
    )
