"""Files the port's CLIP and reference imports read, written for the tests:
stub OpenAI CLIP archives (ViT and ResNet) and a reference trainer's
state_dict.

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


def _text_tower_state(r, one, text):
    tw, tl, vocab, tpos, tproj = text
    sd = {"token_embedding.weight": r(vocab, tw), "positional_embedding": r(tpos, tw),
          "ln_final.weight": one(tw), "ln_final.bias": r(tw), "text_projection": r(tw, tproj)}
    for i in range(tl):
        b = f"transformer.resblocks.{i}."
        sd.update({b + "ln_1.weight": one(tw), b + "ln_1.bias": r(tw),
                   b + "attn.in_proj_weight": r(3 * tw, tw), b + "attn.in_proj_bias": r(3 * tw),
                   b + "attn.out_proj.weight": r(tw, tw), b + "attn.out_proj.bias": r(tw),
                   b + "ln_2.weight": one(tw), b + "ln_2.bias": r(tw),
                   b + "mlp.c_fc.weight": r(4 * tw, tw), b + "mlp.c_fc.bias": r(4 * tw),
                   b + "mlp.c_proj.weight": r(tw, 4 * tw), b + "mlp.c_proj.bias": r(tw)})
    return sd


def stub_rn_clip_state(visual, text, seed=0):
    """An OpenAI CLIP ResNet archive's key names and shapes (`ModifiedResNet`:
    3-conv stem, bottleneck stages with `downsample.0` / `.1`, `attnpool`),
    seeded, in fp16.  `visual` is (width, layers, pool grid, output dim),
    `text` as in `stub_clip_state`.  BatchNorm running variances lie in
    [0.5, 1.5], so a swapped statistic shows."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: (0.02 * torch.randn(*s, generator=g)).half()
    one = lambda n: (1.0 + 0.1 * torch.randn(n, generator=g)).half()
    w, layers, grid, out_dim = visual
    sd = {}

    def conv_bn(conv, bn, cout, cin, k):
        sd[f"visual.{conv}.weight"] = r(cout, cin, k, k)
        sd.update({f"visual.{bn}.weight": one(cout), f"visual.{bn}.bias": r(cout),
                   f"visual.{bn}.running_mean": r(cout),
                   f"visual.{bn}.running_var": (0.5 + torch.rand(cout, generator=g)).half(),
                   f"visual.{bn}.num_batches_tracked": torch.tensor(0)})

    conv_bn("conv1", "bn1", w // 2, 3, 3)
    conv_bn("conv2", "bn2", w // 2, w // 2, 3)
    conv_bn("conv3", "bn3", w, w // 2, 3)
    cin = w
    for li, (blocks, mult) in enumerate(zip(layers, (1, 2, 4, 8)), start=1):
        planes = w * mult
        for bi in range(blocks):
            b = f"layer{li}.{bi}"
            conv_bn(f"{b}.conv1", f"{b}.bn1", planes, cin, 1)
            conv_bn(f"{b}.conv2", f"{b}.bn2", planes, planes, 3)
            conv_bn(f"{b}.conv3", f"{b}.bn3", planes * 4, planes, 1)
            if bi == 0:  # stride 2 from layer2 on, and a width change in layer1
                conv_bn(f"{b}.downsample.0", f"{b}.downsample.1", planes * 4, cin, 1)
            cin = planes * 4
    embed = w * 32
    sd["visual.attnpool.positional_embedding"] = (
        torch.randn(grid * grid + 1, embed, generator=g) / embed**0.5).half()
    for name, cout in (("q_proj", embed), ("k_proj", embed), ("v_proj", embed),
                       ("c_proj", out_dim)):
        sd[f"visual.attnpool.{name}.weight"] = r(cout, embed)
        sd[f"visual.attnpool.{name}.bias"] = r(cout)
    sd.update(_text_tower_state(r, one, text))
    sd["logit_scale"] = torch.tensor(4.6052).half()
    return sd


def write_stub_clip(path, visual, text, seed=0, resnet=False):
    """`stub_clip_state` (or, with `resnet`, `stub_rn_clip_state`) pickled by
    torch.save at `path`; returns the state."""
    sd = (stub_rn_clip_state if resnet else stub_clip_state)(visual, text, seed)
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


def reference_context_decoder_state(width, visual_dim, layers, seed=0):
    """A reference `ContextDecoder`'s state_dict keys (`context_decoder.*`:
    memory_proj / text_proj / out_proj Sequentials of LayerNorm and Linear,
    `decoder.{i}` layers whose einsum attentions have unbiased q / k / v
    projections and a biased `proj`), seeded fp32 numpy arrays."""
    import numpy as np

    rs = np.random.RandomState(seed)
    r = lambda *s: rs.randn(*s).astype(np.float32) * 0.1
    ln = lambda p, n: {f"{p}.weight": 1.0 + r(n), f"{p}.bias": r(n)}
    lin = lambda p, o, i: {f"{p}.weight": r(o, i), f"{p}.bias": r(o)}
    c = "context_decoder"
    sd = {**ln(f"{c}.memory_proj.0", visual_dim), **lin(f"{c}.memory_proj.1", width, visual_dim),
          **ln(f"{c}.memory_proj.2", width), **ln(f"{c}.text_proj.0", visual_dim),
          **lin(f"{c}.text_proj.1", width, visual_dim), **ln(f"{c}.out_proj.0", width),
          **lin(f"{c}.out_proj.1", visual_dim, width)}
    for i in range(layers):
        d = f"{c}.decoder.{i}"
        for norm in ("norm1", "norm2", "norm3"):
            sd.update(ln(f"{d}.{norm}", width))
        for attn in ("self_attn", "cross_attn"):
            sd.update({f"{d}.{attn}.{n}_proj.weight": r(width, width) for n in "qkv"})
            sd.update(lin(f"{d}.{attn}.proj", width, width))
        sd.update({**lin(f"{d}.mlp.0", 4 * width, width), **lin(f"{d}.mlp.3", width, 4 * width)})
    return sd
