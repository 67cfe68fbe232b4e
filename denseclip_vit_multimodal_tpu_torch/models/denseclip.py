"""DenseCLIP composite segmentor (PyTorch port of the JAX package's
`models/denseclip.py`): inference, and the training forward (`train=True`:
batch-statistics BatchNorm, head dropout and backbone drop path drawn from a
`torch.Generator`).

NHWC images in, NHWC logits out.  What differs from the JAX module, and why
the outputs stay identical:

  * The score map (and `vis_proj`, which feeds it, and the text tower behind
    it) is computed only when something reads it.  In this slice that is
    `return_features` alone: score concatenation into the neck, the
    identity head and the context decoder are not ported yet, and
    `build_denseclip` refuses them.  The flagship preset reads none of them
    (`score_concat_index: -1`), and XLA drops the score map from the JAX
    program too.
  * `global_proj` only feeds the context decoder, which is not ported, so
    its weights are held for checkpoint parity and never run.

Modules ported so far: `CLIPVisionTransformer`, `CLIPTextContextEncoder`,
`ViTFeatureFusionNeck`, `FCNHead` (as FPNHead / FCNHead / FCNHeadDepth).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from denseclip_vit_multimodal_tpu_torch.models.heads import FCNHead
from denseclip_vit_multimodal_tpu_torch.models.layers import (
    Conv2d,
    Linear,
    normal,
    resize_bilinear,
    trunc_normal,
)
from denseclip_vit_multimodal_tpu_torch.models.necks import ViTFeatureFusionNeck
from denseclip_vit_multimodal_tpu_torch.models.text import CLIPTextContextEncoder
from denseclip_vit_multimodal_tpu_torch.models.vit import CLIPVisionTransformer
from denseclip_vit_multimodal_tpu_torch.ops.score_map import score_map as compute_score_map
from denseclip_vit_multimodal_tpu_torch.text.tokenizer import tokenize

CITYSCAPES_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train",
    "motorcycle", "bicycle",
)


class DenseCLIP(nn.Module):
    """Language-guided dense prediction: CLIP backbone + text tower + heads."""

    def __init__(self, backbone: CLIPVisionTransformer, text_encoder: CLIPTextContextEncoder,
                 decode_head: Optional[nn.Module] = None, depth_head: Optional[nn.Module] = None,
                 neck: Optional[nn.Module] = None, num_classes: int = 19, text_dim: int = 512,
                 token_embed_dim: int = 512, backbone_out_channels: int = 768,
                 num_learnable_contexts: int = 16,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.backbone = backbone
        self.text_encoder = text_encoder
        self.decode_head = decode_head
        self.depth_head = depth_head
        self.neck = neck
        self.num_classes = num_classes
        self.text_dim = text_dim
        self.dtype = dtype
        self.contexts = (
            nn.Parameter(trunc_normal((1, num_learnable_contexts, token_embed_dim), 0.02, gen))
            if num_learnable_contexts > 0 else None
        )
        self.global_proj = self.vis_proj = None
        if backbone_out_channels != text_dim:
            self.global_proj = Linear(backbone_out_channels, text_dim, dtype=dtype,
                                      kernel_init=lambda s, g: normal(s, 0.01, g), gen=gen)
            self.vis_proj = Conv2d(backbone_out_channels, text_dim, 1, dtype=dtype, gen=gen)

    def encode_text_base(self, texts) -> torch.Tensor:
        """Image-independent text-tower output [1, K, C]; serving runs it once
        per checkpoint and passes it back as `cached_text`."""
        device = self.text_encoder.positional_embedding.device
        texts = torch.as_tensor(texts).to(device=device, dtype=torch.long)
        contexts = self.contexts
        if contexts is None:
            contexts = torch.zeros(1, 0, self.text_encoder.transformer_width, device=texts.device)
        return self.text_encoder(texts, contexts)

    def encode_text(self, texts, batch: int, cached_text: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """Text features [B, K, text_dim] (no context decoder in this slice)."""
        emb = cached_text if cached_text is not None else self.encode_text_base(texts)
        return emb.expand(batch, *emb.shape[1:])

    def forward(self, image: torch.Tensor, texts, gt_hw: Optional[Tuple[int, int]] = None,
                return_features: bool = False, resize_outputs: bool = True,
                cached_text: Optional[torch.Tensor] = None, train: bool = False,
                gen: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """image NHWC [B, H, W, 3] -> {'seg': [B,h,w,K], 'depth': [B,h,w,1], ...}.

        Outputs are resized to `gt_hw` when given, else to the image size;
        `resize_outputs=False` returns head-resolution logits (the slide
        engine upsamples per window itself).  `train=True` is the JAX
        training forward; `gen` then draws its dropout and drop-path masks
        (none are drawn without it).  The score map is skipped in training
        too, so `contexts`, `vis_proj` and `global_proj` get no gradient,
        as in the JAX program (the trainer fills their gradients with 0).
        """
        gen = gen if train else None
        feats = list(self.backbone(image.to(self.dtype), deterministic=not train, gen=gen))
        smap = text_embeddings = None
        if return_features:
            visual = feats[-1]
            if self.vis_proj is not None:
                visual = self.vis_proj(visual)
            text_embeddings = self.encode_text(texts, visual.shape[0], cached_text)
            smap = compute_score_map(visual, text_embeddings)  # [B, h, w, K] fp32

        head_input = self.neck(feats, train) if self.neck is not None else feats[-1]
        seg = self.decode_head(head_input, train, gen) if self.decode_head is not None else None
        depth = self.depth_head(head_input, train, gen) if self.depth_head is not None else None

        target_hw = tuple(gt_hw) if gt_hw is not None else (image.shape[1], image.shape[2])
        if resize_outputs:
            if seg is not None and tuple(seg.shape[1:3]) != target_hw:
                seg = resize_bilinear(seg.float(), target_hw)
            if depth is not None and tuple(depth.shape[1:3]) != target_hw:
                depth = resize_bilinear(depth.float(), target_hw)

        out: Dict[str, Any] = {"seg": seg, "depth": depth}
        if return_features:
            out["score_map"] = smap
            out["text_embeddings"] = text_embeddings
            out["head_input"] = head_input
        return out


# --------------------------------------------------------------------------
# Config-driven construction: build_denseclip
# --------------------------------------------------------------------------


def _not_ported(kind: str, name: str) -> ValueError:
    return ValueError(f"{kind} type {name!r} not yet ported to the PyTorch package")


def build_denseclip(
    model_cfg: Dict[str, Any],
    class_names: Sequence[str],
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto",
    device="cuda",
    seed: int = 0,
) -> Tuple[DenseCLIP, np.ndarray]:
    """Build an eval-mode DenseCLIP on `device` + the tokenized class names.

    Weights come from a seeded `torch.Generator` with the Flax initialisers'
    distributions (load real weights with `convert.load_flax_variables`).
    Returns (model, texts[int32 K x N1]).
    """
    cfg = dict(model_cfg)
    gen = torch.Generator().manual_seed(seed)
    text_dim = int(cfg.get("text_dim", 512))
    fixed_len = int(cfg.get("context_length", 6))
    te_width = int(dict(cfg.get("text_encoder", {})).get("transformer_width", 512))
    token_embed_dim = int(cfg.get("token_embed_dim", te_width))
    for key in ("context_decoder", "identity_head"):
        if cfg.get(key):
            raise _not_ported(key, str(cfg[key]))

    bb = dict(cfg["backbone"])
    bb_type = bb.pop("type")
    if bb_type != "CLIPVisionTransformer":
        raise _not_ported("backbone", bb_type)
    layers = int(bb.get("layers", 12))
    out_indices = tuple(sorted(set(bb.get("out_indices", [layers - 1]))))
    width = int(bb.get("width", 768))
    backbone = CLIPVisionTransformer(
        patch_size=int(bb.get("patch_size", 16)), width=width, layers=layers,
        heads=int(bb.get("heads", 12)), input_resolution=int(bb.get("input_resolution", 224)),
        out_indices=out_indices, attn_impl=attn_impl, dtype=dtype, gen=gen,
        drop_path_rate=float(bb.get("drop_path_rate", 0.0)),
    )

    te = dict(cfg["text_encoder"])
    te_type = te.pop("type")
    if te_type != "CLIPTextContextEncoder":
        raise _not_ported("text_encoder", te_type)
    text_dim = int(te.get("embed_dim", text_dim))
    total_len = int(te["context_length"])
    num_learnable = total_len - fixed_len
    if num_learnable < 0:
        raise ValueError(f"text encoder capacity {total_len} < fixed context {fixed_len}")
    text_encoder = CLIPTextContextEncoder(
        context_length=total_len, vocab_size=int(te.get("vocab_size", 49408)),
        transformer_width=te_width, transformer_heads=int(te.get("transformer_heads", 8)),
        transformer_layers=int(te.get("transformer_layers", 12)), embed_dim=text_dim,
        dtype=dtype, gen=gen,
    )

    neck = None
    head_in_channels = width
    if cfg.get("neck"):
        nk = dict(cfg["neck"])
        nk_type = nk.pop("type")
        if nk_type != "ViTFeatureFusionNeck":
            raise _not_ported("neck", nk_type)
        neck = ViTFeatureFusionNeck(
            num_inputs=len(out_indices), in_channels=width, out_channels=int(nk["out_channels"]),
            inter_channels=nk.get("inter_channels"), dtype=dtype, gen=gen,
        )
        head_in_channels = int(nk["out_channels"])

    score_concat_index = int(cfg.get("score_concat_index", -1))
    if 0 <= score_concat_index < len(out_indices):
        raise _not_ported("score_concat_index", score_concat_index)

    num_classes = len(class_names)
    decode_head = None
    if cfg.get("decode_head"):
        dh = dict(cfg["decode_head"])
        dh_type = dh.pop("type")
        if dh_type not in ("FPNHead", "FCNHead"):
            raise _not_ported("decode_head", dh_type)
        num_classes = int(dh.get("num_classes", num_classes))
        decode_head = FCNHead(
            int(dh.get("in_channels", head_in_channels)), int(dh.get("channels", 256)),
            num_classes, dropout_ratio=float(dh.get("dropout_ratio", 0.1)), dtype=dtype, gen=gen,
        )
    depth_head = None
    if cfg.get("depth_head"):
        dph = dict(cfg["depth_head"])
        dph_type = dph.pop("type")
        if dph_type not in ("FCNHeadDepth", "FCNHead"):
            raise _not_ported("depth_head", dph_type)
        depth_head = FCNHead(  # torchvision's FCNHead hard-codes Dropout(0.1)
            int(dph.get("in_channels", head_in_channels)), int(dph.get("channels", 128)), 1,
            dropout_ratio=float(dph.get("dropout_ratio", 0.1)), dtype=dtype, gen=gen,
        )

    texts = tokenize(list(class_names), context_length=fixed_len)
    model = DenseCLIP(
        backbone, text_encoder, decode_head=decode_head, depth_head=depth_head, neck=neck,
        num_classes=num_classes, text_dim=text_dim, token_embed_dim=token_embed_dim,
        backbone_out_channels=width,
        num_learnable_contexts=num_learnable, dtype=dtype, gen=gen,
    )
    return model.to(device).eval(), texts
