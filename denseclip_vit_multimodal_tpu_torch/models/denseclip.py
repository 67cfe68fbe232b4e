"""DenseCLIP composite segmentor (PyTorch port of the JAX package's
`models/denseclip.py`): inference, and the training forward (`train=True`:
batch-statistics BatchNorm, head and context-decoder dropout and backbone
drop path drawn from a `torch.Generator`).

NHWC images in, NHWC logits out.  The backbone's last map is the visual
feature: projected by `vis_proj` (with `global_proj` on its mean) where its
width is not the text width, it feeds the pixel-text score map.  With a
context decoder the text embeddings are `text + gamma * decoder(text,
visual context)`, the context being the global feature and the map's tokens
(`context_feature: attention`) or the tokens alone (`backbone`).  With
`score_concat_index` in range the score map, resized bilinearly, is
concatenated onto that level's channels before the neck; a neck that takes
fewer levels than the backbone returns (the FPN on c1..c4 of
`CLIPResNetWithAttention`) takes the first ones.

What differs from the JAX module, and why the outputs stay identical: the
score map (and `vis_proj`, `global_proj` and the text tower behind it) is
computed only when something reads it — `return_features`, the context
decoder, score concatenation or the identity head.  The flagship preset
reads none of them, and XLA drops the score map from the JAX program too.
`tau` scales the score map only for the identity head, as in the JAX module.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from denseclip_vit_multimodal_tpu_torch.core.registry import BACKBONES, HEADS, NECKS, TEXT_ENCODERS
from denseclip_vit_multimodal_tpu_torch.models.context_decoder import ContextDecoder
from denseclip_vit_multimodal_tpu_torch.models.heads import FCNHead, IdentityHead
from denseclip_vit_multimodal_tpu_torch.models.layers import (
    Conv2d,
    Linear,
    normal,
    resize_bilinear,
    trunc_normal,
)
from denseclip_vit_multimodal_tpu_torch.models.necks import FPN, ViTFeatureFusionNeck
from denseclip_vit_multimodal_tpu_torch.models.resnet import CLIPResNet, CLIPResNetWithAttention
from denseclip_vit_multimodal_tpu_torch.models.text import CLIPTextContextEncoder, CLIPTextEncoder
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

    def __init__(self, backbone: nn.Module, text_encoder: nn.Module,
                 decode_head: Optional[nn.Module] = None, depth_head: Optional[nn.Module] = None,
                 neck: Optional[nn.Module] = None, context_decoder: Optional[nn.Module] = None,
                 identity_head: Optional[nn.Module] = None, num_classes: int = 19,
                 text_dim: int = 512, token_embed_dim: int = 512,
                 context_feature: str = "attention", score_concat_index: int = -1,
                 tau: float = 0.07, backbone_out_channels: int = 768,
                 num_learnable_contexts: int = 16,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.backbone = backbone
        self.text_encoder = text_encoder
        self.decode_head = decode_head
        self.depth_head = depth_head
        self.neck = neck
        self.context_decoder = context_decoder
        self.identity_head = identity_head
        self.num_classes = num_classes
        self.text_dim = text_dim
        self.token_embed_dim = token_embed_dim
        self.context_feature = context_feature
        self.score_concat_index = score_concat_index
        self.tau = tau
        self.dtype = dtype
        self.contexts = (
            nn.Parameter(trunc_normal((1, num_learnable_contexts, token_embed_dim), 0.02, gen))
            if self.is_context_encoder and num_learnable_contexts > 0 else None
        )
        self.gamma = (nn.Parameter(torch.full((text_dim,), 1e-4))
                      if context_decoder is not None else None)
        self.global_proj = self.vis_proj = None
        if backbone_out_channels != text_dim:
            self.global_proj = Linear(backbone_out_channels, text_dim, dtype=dtype,
                                      kernel_init=lambda s, g: normal(s, 0.01, g), gen=gen)
            self.vis_proj = Conv2d(backbone_out_channels, text_dim, 1, dtype=dtype, gen=gen)

    @property
    def is_context_encoder(self) -> bool:
        return isinstance(self.text_encoder, CLIPTextContextEncoder)

    def encode_text_base(self, texts) -> torch.Tensor:
        """Image-independent text-tower output ([1, K, C] for the prompt
        tower, [K, C] for the plain one); serving runs it once per
        checkpoint and passes it back as `cached_text`."""
        device = self.text_encoder.positional_embedding.device
        texts = torch.as_tensor(texts).to(device=device, dtype=torch.long)
        if not self.is_context_encoder:
            return self.text_encoder(texts)
        contexts = self.contexts
        if contexts is None:
            contexts = torch.zeros(1, 0, self.token_embed_dim, device=texts.device)
        return self.text_encoder(texts, contexts)

    def encode_text(self, texts, batch: int, visual_context: Optional[torch.Tensor] = None,
                    cached_text: Optional[torch.Tensor] = None,
                    gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Text features [B, K, text_dim]: the tower's output (or
        `cached_text`) broadcast over the batch, plus `gamma` times the
        context decoder's delta where there is a decoder and a context."""
        emb = cached_text if cached_text is not None else self.encode_text_base(texts)
        if emb.dim() == 2:
            emb = emb[None]
        text_embeddings = emb.expand(batch, *emb.shape[1:])
        if self.context_decoder is not None and visual_context is not None:
            delta = self.context_decoder(text_embeddings, visual_context, gen)
            text_embeddings = text_embeddings + self.gamma * delta
        return text_embeddings

    def _reads_score_map(self, levels: int, return_features: bool) -> bool:
        return (return_features or self.context_decoder is not None
                or self.identity_head is not None or 0 <= self.score_concat_index < levels)

    def forward(self, image: torch.Tensor, texts, gt_hw: Optional[Tuple[int, int]] = None,
                return_features: bool = False, resize_outputs: bool = True,
                cached_text: Optional[torch.Tensor] = None, train: bool = False,
                gen: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """image NHWC [B, H, W, 3] -> {'seg': [B,h,w,K], 'depth': [B,h,w,1], ...}.

        Outputs are resized to `gt_hw` when given, else to the image size;
        `resize_outputs=False` returns head-resolution logits (the slide
        engine upsamples per window itself).  `train=True` is the JAX
        training forward; `gen` then draws its dropout and drop-path masks
        (none are drawn without it).  Where nothing reads the score map (the
        flagship), `contexts`, `vis_proj` and `global_proj` get no gradient,
        as in the JAX program (the trainer fills their gradients with 0).
        With an identity head the result also holds 'identity', the score
        map over `tau`.
        """
        gen = gen if train else None
        feats: List[torch.Tensor] = list(
            self.backbone(image.to(self.dtype), deterministic=not train, gen=gen))
        smap = text_embeddings = None
        if self._reads_score_map(len(feats), return_features):
            visual = feats[-1]
            b, fh, fw, _ = visual.shape
            global_feat = visual.mean(dim=(1, 2))
            if self.vis_proj is not None:
                global_feat = self.global_proj(global_feat)
                visual = self.vis_proj(visual)
            visual_context = None
            if self.context_decoder is not None:
                tokens = visual.reshape(b, fh * fw, -1)
                if self.context_feature == "attention":
                    visual_context = torch.cat([global_feat[:, None], tokens], dim=1)
                elif self.context_feature == "backbone":
                    visual_context = tokens
                else:
                    raise ValueError(f"invalid context_feature {self.context_feature!r}")
            text_embeddings = self.encode_text(texts, b, visual_context, cached_text, gen)
            smap = compute_score_map(visual, text_embeddings)  # [B, h, w, K] fp32

        neck_inputs = feats
        if 0 <= self.score_concat_index < len(feats):
            target = feats[self.score_concat_index]
            smap_r = resize_bilinear(smap, tuple(target.shape[1:3])).to(target.dtype)
            neck_inputs = list(feats)
            neck_inputs[self.score_concat_index] = torch.cat([target, smap_r], dim=-1)
        if self.neck is not None:
            n_in = getattr(self.neck, "num_inputs", len(neck_inputs))
            neck_out = self.neck(neck_inputs[:n_in], train)
            head_input = neck_out[0] if isinstance(neck_out, (tuple, list)) else neck_out
        else:
            head_input = neck_inputs[-1]
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
        if self.identity_head is not None:
            out["identity"] = self.identity_head(smap / self.tau)
        return out


# --------------------------------------------------------------------------
# Config-driven construction: build_denseclip
# --------------------------------------------------------------------------


def _from_registry(registry, kind: str, type_name: str, section: Dict[str, Any]):
    cls = registry.get(type_name)
    if cls is None:
        raise ValueError(f"Unsupported {kind} type: {type_name}")
    return cls(**section)


def build_denseclip(
    model_cfg: Dict[str, Any],
    class_names: Sequence[str],
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto",
    device="cuda",
    seed: int = 0,
    remat: Any = False,
) -> Tuple[DenseCLIP, np.ndarray]:
    """Build an eval-mode DenseCLIP on `device` + the tokenized class names,
    for every branch of the JAX package's `build_denseclip`: backbone
    `CLIPVisionTransformer`, `CLIPResNet` or `CLIPResNetWithAttention`; text
    encoder `CLIPTextContextEncoder` or `CLIPTextEncoder`; an optional
    `ContextDecoder`; neck `ViTFeatureFusionNeck` or `FPN`; heads `FPNHead` /
    `FCNHead`, `IdentityHead` and `FCNHeadDepth` / `FCNHead`; an optional
    identity head.  Any other `type:` is looked up in `core/registry.py`
    (`Unsupported ... type` where it is not registered).

    Weights come from a seeded `torch.Generator` with the Flax initialisers'
    distributions (load real weights with `convert.load_flax_variables`).
    `attn_impl` ("auto", "xla", "int8" or "flash") reaches the ViT only: the text
    tower, the context decoder and the ResNet's attention pool keep plain
    attention (`xla`), as in the JAX package.  So does `remat` (the
    `tpu.remat` value: false or true / "full";
    `models/layers.py::resolve_remat_policy`).  The necks' input widths,
    which Flax infers, come from the backbone's levels, plus the class count
    at `score_concat_index`.
    Returns (model, texts[int32 K x N1]).
    """
    cfg = dict(model_cfg)
    gen = torch.Generator().manual_seed(seed)
    text_dim = int(cfg.get("text_dim", 512))
    fixed_len = int(cfg.get("context_length", 6))
    te_width = int(dict(cfg.get("text_encoder", {})).get("transformer_width", 512))
    token_embed_dim = int(cfg.get("token_embed_dim", te_width))

    # --- backbone, and the widths of the levels it returns ---
    bb = dict(cfg["backbone"])
    bb_type = bb.pop("type")
    if bb_type == "CLIPVisionTransformer":
        layers = int(bb.get("layers", 12))
        out_indices = tuple(sorted(set(bb.get("out_indices", [layers - 1]))))
        width = int(bb.get("width", 768))
        backbone = CLIPVisionTransformer(
            patch_size=int(bb.get("patch_size", 16)), width=width, layers=layers,
            heads=int(bb.get("heads", 12)), input_resolution=int(bb.get("input_resolution", 224)),
            out_indices=out_indices, attn_impl=attn_impl, dtype=dtype, gen=gen,
            drop_path_rate=float(bb.get("drop_path_rate", 0.0)), remat=remat,
        )
        backbone_out_channels = width
        level_channels = [width] * len(out_indices)
    elif bb_type in ("CLIPResNet", "CLIPResNetWithAttention"):
        rn_layers = tuple(int(n) for n in bb.get("layers", (3, 4, 6, 3)))
        rn_width = int(bb.get("width", 64))
        if bb_type == "CLIPResNet":
            backbone = CLIPResNet(rn_layers, rn_width, dtype=dtype, gen=gen)
            backbone_out_channels = rn_width * 8 * 4
            level_channels = list(backbone.stage_channels)
        else:
            backbone_out_channels = int(bb.get("output_dim", 1024))
            backbone = CLIPResNetWithAttention(
                rn_layers, rn_width, output_dim=backbone_out_channels,
                input_resolution=int(bb.get("input_resolution", 224)), dtype=dtype, gen=gen)
            level_channels = list(backbone.stage_channels) + [backbone_out_channels]
    else:
        backbone = _from_registry(BACKBONES, "backbone", bb_type, bb)
        backbone_out_channels = int(getattr(backbone, "out_channels", bb.get("out_channels", 256)))
        num_levels = int(getattr(backbone, "num_levels", bb.get("num_levels", 1)))
        level_channels = [backbone_out_channels] * num_levels

    # --- text encoder ---
    te = dict(cfg["text_encoder"])
    te_type = te.pop("type")
    text_dim = int(te.get("embed_dim", text_dim))
    common_te = dict(
        vocab_size=int(te.get("vocab_size", 49408)), transformer_width=te_width,
        transformer_heads=int(te.get("transformer_heads", 8)),
        transformer_layers=int(te.get("transformer_layers", 12)), embed_dim=text_dim,
        dtype=dtype, gen=gen,
    )
    if te_type == "CLIPTextEncoder":
        text_encoder = CLIPTextEncoder(context_length=fixed_len, **common_te)
        num_learnable = 0
    elif te_type == "CLIPTextContextEncoder":
        total_len = int(te["context_length"])
        num_learnable = total_len - fixed_len
        if num_learnable < 0:
            raise ValueError(f"text encoder capacity {total_len} < fixed context {fixed_len}")
        text_encoder = CLIPTextContextEncoder(context_length=total_len, **common_te)
    else:
        text_encoder = _from_registry(TEXT_ENCODERS, "text_encoder", te_type, te)
        num_learnable = int(te.get("num_learnable_contexts", 0))

    # --- context decoder ---
    context_decoder = None
    if cfg.get("context_decoder"):
        cd = dict(cfg["context_decoder"])
        context_decoder = ContextDecoder(
            transformer_width=int(cd.get("transformer_width", 256)),
            transformer_heads=int(cd.get("transformer_heads", 4)),
            transformer_layers=int(cd.get("transformer_layers", 6)), visual_dim=text_dim,
            dropout=float(cd.get("dropout", 0.1)), dtype=dtype, gen=gen,
        )

    # --- neck: the score map widens its level by one channel a class ---
    score_concat_index = int(cfg.get("score_concat_index", -1))
    if 0 <= score_concat_index < len(level_channels):
        level_channels[score_concat_index] += len(class_names)
    neck = None
    head_in_channels = backbone_out_channels
    if cfg.get("neck"):
        nk = dict(cfg["neck"])
        nk_type = nk.pop("type")
        if nk_type == "ViTFeatureFusionNeck":
            neck = ViTFeatureFusionNeck(
                num_inputs=len(level_channels), in_channels=level_channels,
                out_channels=int(nk["out_channels"]), inter_channels=nk.get("inter_channels"),
                dtype=dtype, gen=gen,
            )
            head_in_channels = int(nk["out_channels"])
        elif nk_type == "FPN":
            in_channels = nk.get("in_channels")
            n_in = len(in_channels) if in_channels else len(level_channels)
            neck = FPN(num_inputs=n_in, in_channels=level_channels[:n_in],
                       out_channels=int(nk.get("out_channels", 256)), num_outs=nk.get("num_outs"),
                       dtype=dtype, gen=gen)
            head_in_channels = int(nk.get("out_channels", 256))
        else:
            neck = _from_registry(NECKS, "neck", nk_type, nk)
            head_in_channels = int(getattr(neck, "out_channels", nk.get("out_channels", 256)))

    # --- heads ---
    num_classes = len(class_names)
    decode_head = None
    if cfg.get("decode_head"):
        dh = dict(cfg["decode_head"])
        dh_type = dh.pop("type")
        num_classes = int(dh.get("num_classes", num_classes))
        if dh_type in ("FPNHead", "FCNHead"):
            decode_head = FCNHead(
                int(dh.get("in_channels", head_in_channels)), int(dh.get("channels", 256)),
                num_classes, dropout_ratio=float(dh.get("dropout_ratio", 0.1)), dtype=dtype,
                gen=gen,
            )
        elif dh_type == "IdentityHead":
            decode_head = IdentityHead()
        else:
            decode_head = _from_registry(HEADS, "decode_head", dh_type, dh)
    depth_head = None
    if cfg.get("depth_head"):
        dph = dict(cfg["depth_head"])
        dph_type = dph.pop("type")
        if dph_type not in ("FCNHeadDepth", "FCNHead"):
            raise ValueError(f"Unsupported depth_head type: {dph_type}")
        depth_head = FCNHead(  # torchvision's FCNHead hard-codes Dropout(0.1)
            int(dph.get("in_channels", head_in_channels)), int(dph.get("channels", 128)), 1,
            dropout_ratio=float(dph.get("dropout_ratio", 0.1)), dtype=dtype, gen=gen,
        )
    identity_head = IdentityHead() if cfg.get("identity_head") else None

    texts = tokenize(list(class_names), context_length=fixed_len)
    model = DenseCLIP(
        backbone, text_encoder, decode_head=decode_head, depth_head=depth_head, neck=neck,
        context_decoder=context_decoder, identity_head=identity_head, num_classes=num_classes,
        text_dim=text_dim, token_embed_dim=token_embed_dim,
        context_feature=str(cfg.get("context_feature", "attention")),
        score_concat_index=score_concat_index, tau=float(cfg.get("tau", 0.07)),
        backbone_out_channels=backbone_out_channels, num_learnable_contexts=num_learnable,
        dtype=dtype, gen=gen,
    )
    return model.to(device).eval(), texts
