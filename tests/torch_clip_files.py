"""Files the port's CLIP and reference imports read, written for the tests:
a stub OpenAI CLIP ViT archive and a reference trainer's state_dict.

Not a test module: `tests/test_torch_clip_import.py` and
`tests/test_torch_train_cityscapes.py` import it.
"""

import re

import torch

# the port's module names -> the reference trainer's (the inverse of
# `train/clip_import.py::import_reference_denseclip`'s map)
REFERENCE_NAMES = (
    (r"^neck\.process\.(\d+)\.conv\.", r"neck.process_layers.\1.0."),
    (r"^neck\.process\.(\d+)\.bn\.", r"neck.process_layers.\1.1."),
    (r"^neck\.fuse\.conv\.", "neck.fusion_layer.0."), (r"^neck\.fuse\.bn\.", "neck.fusion_layer.1."),
    (r"^(decode_head|depth_head)\.conv0\.", r"\1.0."), (r"^(decode_head|depth_head)\.bn0\.", r"\1.1."),
    (r"^(decode_head|depth_head)\.conv1\.", r"\1.4."),
)


def stub_clip_state(visual, text, seed=0):
    """OpenAI CLIP's key names, seeded, in fp16 as released.  `visual` is
    (width, layers, patch, positions, proj), `text` (width, layers, vocab,
    positions, proj).  LayerNorm weights sit away from 1, so a misplaced one
    shows."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: (0.02 * torch.randn(*s, generator=g)).half()
    one = lambda n: (1.0 + 0.1 * torch.randn(n, generator=g)).half()
    vw, vl, patch, vpos, vproj = visual
    tw, tl, vocab, tpos, tproj = text
    sd = {"visual.conv1.weight": r(vw, 3, patch, patch), "visual.class_embedding": r(vw),
          "visual.positional_embedding": r(vpos, vw), "visual.ln_pre.weight": one(vw),
          "visual.ln_pre.bias": r(vw), "visual.ln_post.weight": one(vw),
          "visual.ln_post.bias": r(vw), "visual.proj": r(vw, vproj),
          "token_embedding.weight": r(vocab, tw), "positional_embedding": r(tpos, tw),
          "ln_final.weight": one(tw), "ln_final.bias": r(tw), "text_projection": r(tw, tproj)}
    for prefix, w, layers in (("visual.transformer", vw, vl), ("transformer", tw, tl)):
        for i in range(layers):
            b = f"{prefix}.resblocks.{i}."
            sd.update({b + "ln_1.weight": one(w), b + "ln_1.bias": r(w),
                       b + "attn.in_proj_weight": r(3 * w, w), b + "attn.in_proj_bias": r(3 * w),
                       b + "attn.out_proj.weight": r(w, w), b + "attn.out_proj.bias": r(w),
                       b + "ln_2.weight": one(w), b + "ln_2.bias": r(w),
                       b + "mlp.c_fc.weight": r(4 * w, w), b + "mlp.c_fc.bias": r(4 * w),
                       b + "mlp.c_proj.weight": r(w, 4 * w), b + "mlp.c_proj.bias": r(w)})
    return sd


def write_stub_clip(path, visual, text, seed=0):
    """`stub_clip_state` pickled by torch.save at `path`; returns the state."""
    sd = stub_clip_state(visual, text, seed)
    torch.save(sd, path)
    return sd


def reference_state(clip_state, model_state):
    """A reference DenseCLIP state_dict under the reference trainer's names:
    the towers from the CLIP archive's tensors, every other module's tensor
    from the port's `model_state`."""
    ref = {f"backbone.{k[len('visual.'):]}": v for k, v in clip_state.items()
           if k.startswith("visual.")}
    ref.update({f"text_encoder.{k}": v for k, v in clip_state.items()
                if not k.startswith("visual.")})
    for key, value in model_state.items():
        if key.split(".")[0] in ("backbone", "text_encoder"):
            continue
        for pattern, repl in REFERENCE_NAMES:
            key = re.sub(pattern, repl, key)
        ref[key] = value
    return ref
