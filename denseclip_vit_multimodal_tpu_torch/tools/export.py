"""Serving export of the port (the JAX package's `tools/export.py`): the
inference program of a config + checkpoint, traced by `torch.export` into a
bundle that `infer/exported.py` serves without the model-building code.

    python3 -m denseclip_vit_multimodal_tpu_torch.tools.export CONFIG CHECKPOINT out_dir \
        --shape 1024 2048 --mode slide --fetch packed
    # later, elsewhere:
    python3 -m denseclip_vit_multimodal_tpu_torch.tools.export --load out_dir --selftest
    python3 -m denseclip_vit_multimodal_tpu_torch.tools.serve --from-export out_dir

CHECKPOINT is a checkpoint file of the port's own format or a work dir (its
`checkpoints/latest`).  The bundle is `program.pt2` (`torch.export.save`,
the weights inside it) and `meta.json`, with the JAX bundle's keys:
`weight_keys` lists the program's state-dict keys, `device` says where the
program runs and `ops` counts the kernel ops (`denseclip_torch::*`) in its
graph.  The JAX bundle's separate `weights.npz` has no counterpart: the
weights travel inside `program.pt2`.

What is traced is `ServingProgram`: a uint8 frame [B, H, W, 3] in, the CLIP
normalisation, whole mode or `slide_inference` at head resolution (the
live `Inferencer`'s own `_forward_logits`), and for `--fetch argmax` /
`packed` the argmax and casts of `infer/outputs.py::package_outputs`
(int32 seg + fp32 depth, or uint8 seg + fp16 depth).  The program is
specialised to one input shape, mode, crop and stride, as JAX's is.  What
is read while tracing is baked into the bundle: `tpu.attn_impl` and
`DENSECLIP_FUSED_LNQKV` (which kernel each ViT layer calls), the softmax
knobs `DENSECLIP_FAST_EXP2` / `DENSECLIP_EXP_BF16` (the exp mode each kernel
op carries: `meta.json` records the knobs as traced and `exp_modes`, the
ops' modes by op), and the device, as JAX bakes its import-time constants.
The parameters are frozen and the trace runs under `torch.no_grad()`, so
every attention layer calls its kernel's op, not an autograd function.
Runs on `cuda` unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
from typing import Optional

import torch


class ServingProgram(torch.nn.Module):
    """What `tools/export.py` traces: uint8 frames -> the `fetch` policy's
    outputs, computed as the live `Inferencer.predict` computes them.

    The text tower's output (computed once, under `no_grad`: an inference
    tensor cannot be a buffer), the normalisation's mean and std and, in
    slide mode, the window-count map are buffers, so they are constants of
    the program."""

    def __init__(self, model, texts, aug_cfg, num_classes: int, hw, mode: str, crop, stride,
                 window_batch: int, fetch: str):
        from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
        from denseclip_vit_multimodal_tpu_torch.infer.slide import (
            clamp_protocol,
            inverse_count_map,
        )

        super().__init__()
        self.model = model
        self._engine = Inferencer(model, texts, aug_cfg, num_classes=num_classes)
        device = next(model.parameters()).device
        with torch.no_grad():
            self.register_buffer("text_base", model.encode_text_base(texts))
        for name, value in (("mean", aug_cfg.norm_mean), ("std", aug_cfg.norm_std)):
            self.register_buffer(name, torch.tensor(value, dtype=torch.float32, device=device))
        self.mode, self.window_batch, self.fetch = mode, int(window_batch), fetch
        self.num_classes = num_classes
        self.crop, self.stride = clamp_protocol(tuple(hw), tuple(crop), tuple(stride))
        inverse = (inverse_count_map(tuple(hw), self.crop, self.stride, device).clone()
                   if mode == "slide" else None)
        self.register_buffer("inverse_count", inverse)

    def forward(self, image: torch.Tensor):
        pre = (image.float() / 255.0 - self.mean) / self.std  # data/augment.py::normalize_image
        seg, depth = self._engine._forward_logits(pre, self.mode, self.crop, self.stride,
                                                  self.window_batch, self.text_base,
                                                  self.inverse_count)
        if self.fetch == "logits":
            return seg if depth is None else torch.cat([seg, depth], dim=-1)
        # the baked fetch policy: the serving host never sees the fp32 canvas
        seg = seg.argmax(dim=-1).to(torch.int32 if self.fetch == "argmax" else torch.uint8)
        if depth is None:
            return (seg,)
        return seg, depth[..., 0].to(torch.float32 if self.fetch == "argmax" else torch.float16)


def kernel_ops(graph) -> dict:
    """{op name: node count} of the `denseclip_torch` ops in a traced graph."""
    return dict(collections.Counter(name for name, _ in _kernel_nodes(graph)))


def _kernel_nodes(graph):
    """(op name, node) of every `denseclip_torch` op call in a traced graph."""
    from denseclip_vit_multimodal_tpu_torch.ops._library import NAMESPACE

    for node in graph.nodes:
        name = getattr(node.target, "name", lambda: "")() if node.op == "call_function" else ""
        if name.startswith(f"{NAMESPACE}::"):
            yield name, node


def exp_modes(graph) -> dict:
    """{op name: sorted exp modes} of the kernel ops that carry one (the
    trailing `exp_mode` argument; its default 0 where the trace left it out)."""
    modes = collections.defaultdict(set)
    for name, node in _kernel_nodes(graph):
        schema = node.target._schema
        if schema.arguments and schema.arguments[-1].name == "exp_mode":
            index = len(schema.arguments) - 1
            mode = node.args[index] if len(node.args) > index else node.kwargs.get("exp_mode", 0)
            modes[name].add(int(mode))
    return {name: sorted(v) for name, v in modes.items()}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export DenseCLIP for serving (PyTorch port)")
    p.add_argument("config", nargs="?", help="config YAML path or preset name")
    p.add_argument("checkpoint", nargs="?", help="checkpoint file or work dir")
    p.add_argument("out_dir", nargs="?")
    p.add_argument("--shape", type=int, nargs=2, default=[1024, 2048])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--mode", choices=["whole", "slide"], default="whole")
    # slide protocol defaults come from the config's `test:` section
    p.add_argument("--crop", type=int, nargs=2, default=None)
    p.add_argument("--stride", type=int, nargs=2, default=None)
    p.add_argument("--window-batch", type=int, default=None,
                   help="run the slide windows in chunks of this many")
    p.add_argument("--fetch", choices=["logits", "argmax", "packed"], default="logits",
                   help="bake the fetch policy into the program: argmax = int32 seg (+ fp32 "
                        "depth), packed = uint8 seg (+ fp16 depth)")
    p.add_argument("--load", default=None, help="load an export dir (with --selftest)")
    p.add_argument("--selftest", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", dest="overrides", nargs="*", default=[],
                   metavar="KEY.PATH=VALUE", help="dotted config overrides")
    args = p.parse_args(argv)
    if not args.load and not (args.config and args.checkpoint and args.out_dir):
        p.error("config, checkpoint and out_dir are required unless --load")
    return args, p


def main(argv=None) -> Optional[dict]:
    """Runs the CLI; returns the bundle's meta (None with --load)."""
    args, parser = parse_args(argv)
    if args.load:
        from denseclip_vit_multimodal_tpu_torch.infer.exported import ExportedInferencer

        infer = ExportedInferencer(args.load, device=args.device)
        if args.selftest:
            import numpy as np

            out = infer.run(np.zeros(infer.input_shape, np.uint8))
            out = out[0] if isinstance(out, (tuple, list)) else out
            kind = "seg argmax" if infer.export_fetch != "logits" else "seg logits"
            print(f"self-test OK: {kind} {tuple(out.shape)} fetch={infer.export_fetch}")
        return None

    from denseclip_vit_multimodal_tpu_torch.core.config import (
        load_config,
        resolve_config_path,
        resolve_test_protocol,
    )
    from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import load_model_weights
    from denseclip_vit_multimodal_tpu_torch.train.loop import class_names_for

    cfg = load_config(resolve_config_path(args.config), overrides=args.overrides)
    crop, stride, window_batch = resolve_test_protocol(cfg, args.crop, args.stride,
                                                       args.window_batch)
    data_cfg = cfg.get("data", {}) or {}
    class_names = class_names_for(data_cfg)
    if args.fetch == "packed" and len(class_names) > 256:
        parser.error(f"--fetch packed needs <= 256 classes, got {len(class_names)}")
    tpu_cfg = cfg.get("tpu", {}) or {}
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        str(tpu_cfg.get("compute_dtype", "bfloat16"))]
    device = torch.device(args.device)
    model, texts = build_denseclip(cfg.model, class_names, dtype=dtype,
                                   attn_impl=str(tpu_cfg.get("attn_impl", "auto")),
                                   device=device)
    load_model_weights(args.checkpoint, model)
    model.requires_grad_(False)
    with_depth = model.depth_head is not None
    h, w = args.shape
    program = ServingProgram(model, texts, augment_config_from_data_cfg(data_cfg, train=False),
                             len(class_names), (h, w), args.mode, crop, stride, window_batch,
                             args.fetch).eval()
    example = torch.zeros(args.batch, h, w, 3, dtype=torch.uint8, device=device)
    with torch.no_grad():
        exported = torch.export.export(program, (example,), strict=False)

    os.makedirs(args.out_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(args.out_dir, "program.pt2"))
    meta = {
        "input_shape": [args.batch, h, w, 3],
        "mode": args.mode,
        "crop": list(crop),
        "stride": list(stride),
        "window_batch": int(window_batch or 0),
        "num_outputs": len(class_names) + (1 if with_depth else 0),
        "class_names": list(class_names),
        "weight_keys": list(exported.state_dict.keys()),
        "fetch": args.fetch,
        "with_depth": with_depth,
        "depth_max": float(data_cfg.get("depth_max", 80.0)),
        "model_name": os.path.basename(str(args.config)),
        "device": device.type,
        "ops": kernel_ops(exported.graph),
        "env": {k: os.environ.get(k, "0") for k in ("DENSECLIP_FUSED_LNQKV", "DENSECLIP_FAST_EXP2",
                                                    "DENSECLIP_EXP_BF16")},
        "exp_modes": exp_modes(exported.graph),
    }
    with open(os.path.join(args.out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(f"exported {args.mode} program for {args.batch}x{h}x{w} -> {args.out_dir}")
    return meta


if __name__ == "__main__":
    main()
