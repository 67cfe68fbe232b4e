"""OpenAI CLIP and reference DenseCLIP checkpoints -> the port's `state_dict`
(the port's counterpart of the JAX package's `train/clip_import.py`).

`load_clip_into_model` is the cold start of the flagship's training: the
`visual.*` keys of an OpenAI CLIP file feed the ViT, the text-tower keys
(`transformer.*`, `token_embedding`, `positional_embedding`, `ln_final`,
`text_projection`) the prompt text tower.  The importers write straight onto
the port's names, whose layouts are torch's own, so no tensor is transposed:

  * `visual.conv1.weight` [width, 3, P, P] -> `patch_embed.weight`
    [width, P*P*3], patches in (row, column, channel) order;
  * `attn.in_proj_weight` / `in_proj_bias` -> the fused `attn.qkv`,
    `attn.out_proj` -> `attn.out`; `ln_*`, `mlp.c_fc`, `mlp.c_proj` as named;
  * the visual pos-embed is resized to the model's base grid (bilinear,
    antialiased when it shrinks, as `jax.image.resize`); the text pos-embed is
    truncated 77 -> the model's capacity;
  * `visual.proj` and `text_projection` are taken only where their shapes
    match the model's, else left at their init, as in the JAX package;
  * any other shape mismatch raises.

`import_reference_denseclip` migrates a whole reference DenseCLIP
`state_dict` (towers, `vis_proj` / `global_proj`, `contexts`, fusion neck,
FCN heads with their BatchNorm statistics).  `gamma` only scales the context
decoder's output, which the port's models do not have: it is dropped.  A
context decoder's keys, and a ResNet CLIP archive, raise: their modules
(`models/context_decoder.py`, `models/resnet.py`) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from denseclip_vit_multimodal_tpu_torch.models.layers import resize_bilinear

State = Dict[str, torch.Tensor]


def load_clip_state_dict(path: str) -> State:
    """Read an OpenAI CLIP checkpoint (JIT archive, as released, or a pickled
    state_dict / module) as fp32 CPU tensors.  The released files hold fp16."""
    try:
        state = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:  # not a TorchScript archive
        state = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(state, "state_dict"):
            state = state.state_dict()
    return {k: v.float() for k, v in state.items() if isinstance(v, torch.Tensor)}


def _resize_grid_pos_embed(pos: torch.Tensor, grid: int) -> torch.Tensor:
    """[1+G*G, D] -> [1+grid*grid, D]; the CLS row passes through."""
    n, d = pos.shape
    g = int(round((n - 1) ** 0.5))
    if g * g != n - 1:
        raise ValueError(f"non-square pos embed: {tuple(pos.shape)}")
    if g == grid:
        return pos
    spatial = resize_bilinear(pos[1:].reshape(g, g, d), (grid, grid), antialias=True)
    return torch.cat([pos[:1], spatial.reshape(grid * grid, d)], dim=0)


_BLOCK_KEYS = {  # CLIP resblock key -> the port's block key
    "ln_1.weight": "ln_1.weight", "ln_1.bias": "ln_1.bias",
    "attn.in_proj_weight": "attn.qkv.weight", "attn.in_proj_bias": "attn.qkv.bias",
    "attn.out_proj.weight": "attn.out.weight", "attn.out_proj.bias": "attn.out.bias",
    "ln_2.weight": "ln_2.weight", "ln_2.bias": "ln_2.bias",
    "mlp.c_fc.weight": "mlp.c_fc.weight", "mlp.c_fc.bias": "mlp.c_fc.bias",
    "mlp.c_proj.weight": "mlp.c_proj.weight", "mlp.c_proj.bias": "mlp.c_proj.bias",
}


def _blocks(state: Mapping[str, torch.Tensor], prefix: str, layers: int) -> State:
    return {f"transformer.blocks.{i}.{dst}": state[f"{prefix}.resblocks.{i}.{src}"]
            for i in range(layers) for src, dst in _BLOCK_KEYS.items()}


def import_vit_state(state: Mapping[str, torch.Tensor], layers: int, base_grid: int,
                     proj_shape: Optional[Tuple[int, ...]] = None) -> State:
    """`visual.*` keys of a ViT CLIP checkpoint -> `CLIPVisionTransformer`
    state_dict entries.  `proj` is taken when its shape is `proj_shape` (or
    when `proj_shape` is None)."""
    conv = state["visual.conv1.weight"]
    out = {
        "patch_embed.weight": conv.permute(0, 2, 3, 1).reshape(conv.shape[0], -1),
        "class_embedding": state["visual.class_embedding"],
        "positional_embedding": _resize_grid_pos_embed(state["visual.positional_embedding"],
                                                       base_grid),
        "ln_pre.weight": state["visual.ln_pre.weight"], "ln_pre.bias": state["visual.ln_pre.bias"],
        "ln_post.weight": state["visual.ln_post.weight"],
        "ln_post.bias": state["visual.ln_post.bias"],
        **_blocks(state, "visual.transformer", layers),
    }
    proj = state.get("visual.proj")
    if proj is not None and (proj_shape is None or tuple(proj.shape) == tuple(proj_shape)):
        out["proj"] = proj
    return out


def import_text_state(state: Mapping[str, torch.Tensor], layers: int, context_length: int,
                      embed_dim: int) -> State:
    """Text-tower keys -> `CLIPTextContextEncoder` state_dict entries: the
    pos-embed truncated to `context_length`, `text_projection` taken only
    when its output width is `embed_dim`."""
    pos = state["positional_embedding"]
    if pos.shape[0] < context_length:
        raise ValueError(f"checkpoint text pos-embed {pos.shape[0]} < model capacity "
                         f"{context_length}")
    out = {
        "token_embedding.weight": state["token_embedding.weight"],
        "positional_embedding": pos[:context_length],
        "ln_final.weight": state["ln_final.weight"], "ln_final.bias": state["ln_final.bias"],
        **_blocks(state, "transformer", layers),
    }
    tp = state.get("text_projection")
    if tp is not None and tp.shape[1] == embed_dim:
        out["text_projection"] = tp
    return out


def _write(model: nn.Module, entries: Mapping[str, torch.Tensor]) -> int:
    """Copy `entries` (full state_dict keys) into `model`; every key must be
    one of the model's, with its shape.  Returns the number written."""
    own = model.state_dict()
    for key, value in entries.items():
        if key not in own:
            raise KeyError(f"{key} is not a tensor of the model")
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch for {key}: model {tuple(own[key].shape)} vs "
                             f"checkpoint {tuple(value.shape)}")
    with torch.no_grad():
        for key, value in entries.items():
            own[key].copy_(value)  # state_dict tensors share the parameters' storage
    return len(entries)


def _prefixed(prefix: str, entries: Mapping[str, torch.Tensor]) -> State:
    return {f"{prefix}{k}": v for k, v in entries.items()}


def _resnet_not_ported() -> ValueError:
    return ValueError("a ResNet CLIP checkpoint needs models/resnet.py, which is not yet "
                      "ported to the PyTorch package")


def load_clip_into_model(model: nn.Module, clip_path: str, model_cfg) -> Tuple[int, int]:
    """Load an OpenAI CLIP ViT checkpoint into a DenseCLIP model in place;
    returns the numbers of visual and text tensors written."""
    bb, te = dict(model_cfg["backbone"]), dict(model_cfg["text_encoder"])
    state = load_clip_state_dict(clip_path)
    if "visual.class_embedding" not in state:
        raise _resnet_not_ported()
    own = model.state_dict()
    vit = import_vit_state(
        state, layers=int(bb.get("layers", 12)),
        base_grid=int(bb.get("input_resolution", 224)) // int(bb.get("patch_size", 16)),
        proj_shape=tuple(own["backbone.proj"].shape))
    text = import_text_state(
        state, layers=int(te.get("transformer_layers", 12)),
        context_length=own["text_encoder.positional_embedding"].shape[0],
        embed_dim=own["text_encoder.text_projection"].shape[1])
    return (_write(model, _prefixed("backbone.", vit)),
            _write(model, _prefixed("text_encoder.", text)))


def _count_indexed(state: Mapping[str, torch.Tensor], fmt: str) -> int:
    n = 0
    while any(k.startswith(fmt.format(i=n)) for k in state):
        n += 1
    return n


def _module(state: Mapping[str, torch.Tensor], src: str, dst: str,
            leaves=("weight", "bias", "running_mean", "running_var")) -> State:
    """The leaves of module `src` present in `state`, renamed to `dst`."""
    return {f"{dst}.{leaf}": state[f"{src}.{leaf}"] for leaf in leaves
            if f"{src}.{leaf}" in state}


def import_reference_denseclip(state: Mapping[str, torch.Tensor], model: nn.Module) -> int:
    """A reference DenseCLIP `state_dict` (trained or not) -> `model` in place.
    Layer counts and the pos-embed grid come from the state and the model, so
    any ViT preset works.  Returns the number of tensors written."""
    state = {k: torch.as_tensor(v).float() for k, v in state.items()}
    cd = sorted(k for k in state if k.startswith("context_decoder."))
    if cd:
        raise ValueError(f"reference checkpoint has context decoder keys ({cd[0]}, ...): "
                         "they need models/context_decoder.py, which is not yet ported to the "
                         "PyTorch package")
    if "backbone.class_embedding" not in state:
        raise _resnet_not_ported()
    own = model.state_dict()
    entries: State = {}

    vis = {f"visual.{k[len('backbone.'):]}": v for k, v in state.items()
           if k.startswith("backbone.")}
    n_pos = own["backbone.positional_embedding"].shape[0]
    entries.update(_prefixed("backbone.", import_vit_state(
        vis, layers=_count_indexed(state, "backbone.transformer.resblocks.{i}."),
        base_grid=int(round((n_pos - 1) ** 0.5)), proj_shape=tuple(own["backbone.proj"].shape))))

    text = {k[len("text_encoder."):]: v for k, v in state.items() if k.startswith("text_encoder.")}
    entries.update(_prefixed("text_encoder.", import_text_state(
        text, layers=_count_indexed(state, "text_encoder.transformer.resblocks.{i}."),
        context_length=own["text_encoder.positional_embedding"].shape[0],
        embed_dim=own["text_encoder.text_projection"].shape[1])))

    if "vis_proj.weight" in state:
        entries.update(_module(state, "vis_proj", "vis_proj"))
        entries.update(_module(state, "global_proj", "global_proj"))
    if "contexts" in state:
        entries["contexts"] = state["contexts"]

    if any(k.startswith("neck.") for k in state):
        for i in range(_count_indexed(state, "neck.process_layers.{i}.")):
            entries.update(_module(state, f"neck.process_layers.{i}.0", f"neck.process.{i}.conv"))
            entries.update(_module(state, f"neck.process_layers.{i}.1", f"neck.process.{i}.bn"))
        entries.update(_module(state, "neck.fusion_layer.0", "neck.fuse.conv"))
        entries.update(_module(state, "neck.fusion_layer.1", "neck.fuse.bn"))
    for head in ("decode_head", "depth_head"):
        if any(k.startswith(f"{head}.") for k in state):
            # torchvision FCNHead (Sequential 0 conv, 1 BN, 4 conv) + appended classifier
            for src, dst in (("0", "conv0"), ("1", "bn0"), ("4", "conv1"),
                             ("classifier", "classifier")):
                entries.update(_module(state, f"{head}.{src}", f"{head}.{dst}"))
    return _write(model, entries)
