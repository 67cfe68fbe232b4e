"""Inference engines: whole-image, slide-window and multi-scale + flip
`aug_test` (PyTorch port of the JAX package's `infer/engine.py`), and the
device-side `eval_metrics`.

Raw uint8 NHWC images in, a dict of outputs per the `fetch` policy out.  The
image-independent text tower runs once per model and is cached; it only
feeds the score map, so a flagship forward does not read it, while a model
with a context decoder (the ResNet presets) fuses it with each image's
visual context inside the forward.  `aug_test` rounds its scaled views to
the backbone's patch, 32 for a ResNet.  `aug_test`
stays on the device from the upload to the fetch: per scale one resize, one
forward over both flip views (the flipped view rides the batch), unflip,
resize to the frame size and a running fp32 sum.  Both resizes antialias when
they shrink, as `jax.image.resize` does by default.  `shard_windows=True`
(JAX's `window_sharding`, `infer/engine.py:171-225`) spreads each frame's
slide windows, the aug-test views' included, over the process group
(`infer/slide.py`); every rank returns the same outputs.  It acts in slide
mode only: in whole mode it warns and runs unsharded, as JAX's
`_check_window_sharding` does.  The HTTP server is `infer/server.py`.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from denseclip_vit_multimodal_tpu_torch.data.augment import AugmentConfig, normalize_image
from denseclip_vit_multimodal_tpu_torch.infer.outputs import package_outputs
from denseclip_vit_multimodal_tpu_torch.infer.slide import clamp_protocol, slide_inference
from denseclip_vit_multimodal_tpu_torch.models.layers import resize_bilinear
from denseclip_vit_multimodal_tpu_torch.train.metrics import confusion_matrix, depth_errors


class Inferencer:
    """Inference over a fixed model (weights live in the model, on its device)."""

    def __init__(self, model, texts: np.ndarray, aug_cfg: Optional[AugmentConfig] = None,
                 num_classes: int = 19):
        self.model = model
        self.texts = np.asarray(texts)
        self.aug_cfg = aug_cfg or AugmentConfig()
        self.num_classes = num_classes
        self.with_depth = model.depth_head is not None
        self._text_cache = None  # (model weights version, texts, tower output)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _text_base(self) -> torch.Tensor:
        """The text-tower output, computed once per (weights, texts)."""
        version = tuple(p._version for p in self.model.text_encoder.parameters())
        cached = self._text_cache
        if cached is None or cached[0] != version or cached[1] is not self.texts:
            with torch.inference_mode():
                cached = (version, self.texts, self.model.encode_text_base(self.texts))
            self._text_cache = cached
        return cached[2]

    def _forward_logits(self, image: torch.Tensor, mode: str, crop: Tuple[int, int],
                        stride: Tuple[int, int], window_batch: int, cached_text,
                        inverse_count: Optional[torch.Tensor] = None,
                        shard_windows: bool = False):
        """(seg [B,H,W,K] fp32, depth [B,H,W,1] fp32 or None) at the input size.
        `inverse_count`: `slide_inference`'s 1 / count map, when the caller
        holds it (an exported program keeps it as a buffer)."""
        if mode == "whole":
            out = self.model(image, self.texts, cached_text=cached_text)
            depth = out.get("depth")
            return out["seg"].float(), None if depth is None else depth.float()
        crop, stride = clamp_protocol(tuple(image.shape[1:3]), crop, stride)
        n_out = self.num_classes + (1 if self.with_depth else 0)

        def window_forward(windows):
            out = self.model(windows, self.texts, resize_outputs=False, cached_text=cached_text)
            parts = [out["seg"]]
            if self.with_depth:
                parts.append(out["depth"])
            return torch.cat([p.float() for p in parts], dim=-1)

        fused = slide_inference(window_forward, image, n_out, crop=crop, stride=stride,
                                window_batch=window_batch, inverse_count=inverse_count,
                                shard_windows=shard_windows)
        seg = fused[..., : self.num_classes]
        depth = fused[..., self.num_classes :] if self.with_depth else None
        return seg, depth

    def preprocess(self, images) -> torch.Tensor:
        """uint8/float [B, H, W, 3] -> CLIP-normalized float32 on the model's device."""
        return normalize_image(self._to_device(images), self.aug_cfg.norm_mean,
                               self.aug_cfg.norm_std)

    def _to_device(self, images) -> torch.Tensor:
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        return images.to(self.device)

    @staticmethod
    def _check_shard_windows(shard_windows: bool, mode: str) -> bool:
        """Window sharding acts in slide mode only: warn and run unsharded
        otherwise, so that predict and aug_test behave alike (JAX's rule)."""
        if shard_windows and mode != "slide":
            warnings.warn(f"window_sharding is only honored in slide mode (got mode={mode!r}); "
                          "running unsharded", stacklevel=3)
            return False
        return shard_windows

    def predict(self, images, mode: str = "whole", crop: Tuple[int, int] = (640, 640),
                stride: Tuple[int, int] = (426, 426), window_batch: int = 0,
                preprocessed: bool = False, fetch: str = "logits",
                shard_windows: bool = False) -> Dict[str, object]:
        """Forward one batch; returns {'seg_logits'?, 'seg', 'depth'?} per
        `fetch`.  `shard_windows` spreads each frame's slide windows over the
        process group."""
        if mode not in ("whole", "slide"):
            raise ValueError(f"Unknown inference mode: {mode}")
        shard_windows = self._check_shard_windows(shard_windows, mode)
        with torch.inference_mode():
            image = self._to_device(images).float() if preprocessed else self.preprocess(images)
            seg, depth = self._forward_logits(image, mode, tuple(crop), tuple(stride),
                                              window_batch, self._text_base(),
                                              shard_windows=shard_windows)
            return package_outputs(seg, depth, fetch)

    def _aug_view(self, image0: torch.Tensor, scaled_hw: Tuple[int, int], flip: bool,
                  mode: str, crop: Tuple[int, int], stride: Tuple[int, int],
                  window_batch: int, cached_text, shard_windows: bool = False):
        """One scale: resize -> forward both views in one batch -> unflip ->
        resize to the frame size -> sum of the views (seg, depth or None)."""
        b, h, w, _ = image0.shape
        scaled = resize_bilinear(image0, scaled_hw, antialias=True)
        batch = torch.cat([scaled, scaled.flip(2)]) if flip else scaled
        seg, depth = self._forward_logits(batch, mode, crop, stride, window_batch, cached_text,
                                          shard_windows=shard_windows)

        def fold(x):
            if flip:
                x = x[:b] + x[b:].flip(2)
            return resize_bilinear(x, (h, w), antialias=True)

        return fold(seg), None if depth is None else fold(depth)

    def aug_test(self, images, scales: Sequence[float] = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75),
                 flip: bool = True, mode: str = "whole", crop: Tuple[int, int] = (640, 640),
                 stride: Tuple[int, int] = (426, 426), window_batch: int = 0,
                 fetch: str = "logits", shard_windows: bool = False) -> Dict[str, object]:
        """Multi-scale + flip test on raw images: fp32 logits averaged over
        every view at the frame size.  Scaled sizes are rounded to the patch
        grid; in slide mode the window is clamped to views smaller than the
        crop.  `shard_windows` spreads every view's windows over the group."""
        if mode not in ("whole", "slide"):
            raise ValueError(f"Unknown inference mode: {mode}")
        shard_windows = self._check_shard_windows(shard_windows, mode)
        patch = int(getattr(self.model.backbone, "patch_size", 32) or 32)
        with torch.inference_mode():
            image0 = self.preprocess(images)
            h, w = image0.shape[1:3]
            cached_text = self._text_base()
            acc_seg = acc_depth = None
            views = 0
            for s in scales:
                sh = max(int(round(h * s / patch)) * patch, patch)
                sw = max(int(round(w * s / patch)) * patch, patch)
                seg_sum, depth_sum = self._aug_view(image0, (sh, sw), flip, mode, tuple(crop),
                                                    tuple(stride), window_batch, cached_text,
                                                    shard_windows)
                acc_seg = seg_sum if acc_seg is None else acc_seg.add_(seg_sum)
                if depth_sum is not None:
                    acc_depth = depth_sum if acc_depth is None else acc_depth.add_(depth_sum)
                views += 2 if flip else 1
            depth = None if acc_depth is None else acc_depth / views
            return package_outputs(acc_seg / views, depth, fetch)

    def eval_metrics(self, outputs: Dict[str, torch.Tensor], seg_gt=None, depth_gt=None,
                     ignore_index: int = 255, max_depth: float = 80.0):
        """Device-side metrics of one batch of `predict` / `aug_test` outputs
        fetched with `fetch='device'`.

        Returns (confusion [K, K] int32 or None, depth sums dict or None,
        depth count or None) on the device: accumulate across batches with
        `+` and read the small totals once at the end.  Either ground truth
        may be omitted.
        """
        with_seg = seg_gt is not None
        with_depth = depth_gt is not None and "depth" in outputs
        if not (with_seg or with_depth):
            return None, None, None
        cm = sums = count = None
        if with_seg:
            cm = confusion_matrix(outputs["seg"], self._to_device(seg_gt), self.num_classes,
                                  ignore_index)
        if with_depth:
            gt = self._to_device(depth_gt)
            sums, count = depth_errors(outputs["depth"], gt, gt > 0, max_depth=float(max_depth))
        return cm, sums, count
