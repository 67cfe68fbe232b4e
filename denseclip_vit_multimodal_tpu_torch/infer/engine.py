"""Inference engine: whole-image and slide-window predict (PyTorch port of the
JAX package's `infer/engine.py`).

Raw uint8 NHWC images in, a dict of outputs per the `fetch` policy out.  The
image-independent text tower runs once per model and is cached; it only
feeds the score map, so a flagship forward does not read it.  `aug_test`,
`eval_metrics`, window sharding and the HTTP server are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from denseclip_vit_multimodal_tpu_torch.data.augment import AugmentConfig, normalize_image
from denseclip_vit_multimodal_tpu_torch.infer.slide import slide_inference


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
