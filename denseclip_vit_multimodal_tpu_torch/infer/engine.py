"""Inference engines: whole-image, slide-window and multi-scale + flip
`aug_test` (PyTorch port of the JAX package's `infer/engine.py`), and the
device-side `eval_metrics`.

Raw uint8 NHWC images in, a dict of outputs per the `fetch` policy out.  The
image-independent text tower runs once per model and is cached; it only
feeds the score map, so a flagship forward does not read it.  `aug_test`
stays on the device from the upload to the fetch: per scale one resize, one
forward over both flip views (the flipped view rides the batch), unflip,
resize to the frame size and a running fp32 sum.  Both resizes antialias when
they shrink, as `jax.image.resize` does by default.  Window sharding and the
HTTP server are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from denseclip_vit_multimodal_tpu_torch.data.augment import AugmentConfig, normalize_image
from denseclip_vit_multimodal_tpu_torch.infer.slide import slide_inference
from denseclip_vit_multimodal_tpu_torch.models.layers import resize_bilinear
from denseclip_vit_multimodal_tpu_torch.train.metrics import confusion_matrix, depth_errors


def package_outputs(seg_logits: torch.Tensor, depth: Optional[torch.Tensor], fetch: str):
    """Package (seg_logits [B,H,W,K], depth [B,H,W(,1)]) per the `fetch` policy.

    fetch='logits' — fp32 logit canvas + int32 argmax + fp32 depth as numpy.
    fetch='argmax' — int32 argmax + fp32 depth as numpy.
    fetch='packed' — argmax as uint8 (num_classes <= 256) + depth as float16,
                     cast on the device before the copy to the host.
    fetch='device' — tensors left on the device: seg_logits, seg, depth.
    """
    if depth is not None and depth.dim() == 4:
        depth = depth[..., 0]
    if fetch == "device":
        out = {"seg_logits": seg_logits, "seg": seg_logits.argmax(dim=-1)}
        if depth is not None:
            out["depth"] = depth
        return out
    if fetch == "packed":
        if seg_logits.shape[-1] > 256:
            raise ValueError(
                f"fetch='packed' needs num_classes <= 256, got {seg_logits.shape[-1]}; "
                "use fetch='argmax'"
            )
        out = {"seg": seg_logits.argmax(dim=-1).to(torch.uint8).cpu().numpy()}
        if depth is not None:
            out["depth"] = depth.to(torch.float16).cpu().numpy()
        return out
    out = {}
    if fetch == "logits":
        out["seg_logits"] = seg_logits.float().cpu().numpy()
    elif fetch != "argmax":
        raise ValueError(f"Unknown fetch policy: {fetch!r}")
    out["seg"] = seg_logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
    if depth is not None:
        out["depth"] = depth.float().cpu().numpy()
    return out


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
                        stride: Tuple[int, int], window_batch: int, cached_text):
        """(seg [B,H,W,K] fp32, depth [B,H,W,1] fp32 or None) at the input size."""
        if mode == "whole":
            out = self.model(image, self.texts, cached_text=cached_text)
            depth = out.get("depth")
            return out["seg"].float(), None if depth is None else depth.float()
        crop = (min(crop[0], image.shape[1]), min(crop[1], image.shape[2]))
        stride = (min(stride[0], crop[0]), min(stride[1], crop[1]))
        n_out = self.num_classes + (1 if self.with_depth else 0)

        def window_forward(windows):
            out = self.model(windows, self.texts, resize_outputs=False, cached_text=cached_text)
            parts = [out["seg"]]
            if self.with_depth:
                parts.append(out["depth"])
            return torch.cat([p.float() for p in parts], dim=-1)

        fused = slide_inference(window_forward, image, n_out, crop=crop, stride=stride,
                                window_batch=window_batch)
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

    def predict(self, images, mode: str = "whole", crop: Tuple[int, int] = (640, 640),
                stride: Tuple[int, int] = (426, 426), window_batch: int = 0,
                preprocessed: bool = False, fetch: str = "logits") -> Dict[str, object]:
        """Forward one batch; returns {'seg_logits'?, 'seg', 'depth'?} per `fetch`."""
        if mode not in ("whole", "slide"):
            raise ValueError(f"Unknown inference mode: {mode}")
        with torch.inference_mode():
            image = self._to_device(images).float() if preprocessed else self.preprocess(images)
            seg, depth = self._forward_logits(image, mode, tuple(crop), tuple(stride),
                                              window_batch, self._text_base())
            return package_outputs(seg, depth, fetch)

    def _aug_view(self, image0: torch.Tensor, scaled_hw: Tuple[int, int], flip: bool,
                  mode: str, crop: Tuple[int, int], stride: Tuple[int, int],
                  window_batch: int, cached_text):
        """One scale: resize -> forward both views in one batch -> unflip ->
        resize to the frame size -> sum of the views (seg, depth or None)."""
        b, h, w, _ = image0.shape
        scaled = resize_bilinear(image0, scaled_hw, antialias=True)
        batch = torch.cat([scaled, scaled.flip(2)]) if flip else scaled
        seg, depth = self._forward_logits(batch, mode, crop, stride, window_batch, cached_text)

        def fold(x):
            if flip:
                x = x[:b] + x[b:].flip(2)
            return resize_bilinear(x, (h, w), antialias=True)

        return fold(seg), None if depth is None else fold(depth)

    def aug_test(self, images, scales: Sequence[float] = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75),
                 flip: bool = True, mode: str = "whole", crop: Tuple[int, int] = (640, 640),
                 stride: Tuple[int, int] = (426, 426), window_batch: int = 0,
                 fetch: str = "logits") -> Dict[str, object]:
        """Multi-scale + flip test on raw images: fp32 logits averaged over
        every view at the frame size.  Scaled sizes are rounded to the patch
        grid; in slide mode the window is clamped to views smaller than the
        crop."""
        if mode not in ("whole", "slide"):
            raise ValueError(f"Unknown inference mode: {mode}")
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
                                                    tuple(stride), window_batch, cached_text)
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
