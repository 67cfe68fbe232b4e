"""Inference CLI of the port (the JAX package's `tools/infer.py`): image(s) ->
seg and depth PNGs.

    python3 -m denseclip_vit_multimodal_tpu_torch.tools.infer CONFIG CHECKPOINT image.png -o out/
    python3 -m denseclip_vit_multimodal_tpu_torch.tools.infer CONFIG CHECKPOINT frames/ \
        --mode slide --aug-test

CHECKPOINT is a checkpoint file of the port's own format or a work dir (its
`checkpoints/latest`).  INPUTS is an image file, or a directory whose
`*.png`, `*.jpg` and `*.jpeg` files (not recursive) are read in sorted
order.  Images are decoded as the HTTP server decodes a body
(`infer/server.py`): PNG and baseline JPEG by the port's own decoders, a
JPEG mode those refuse through Pillow where it is installed.  Each image
gives `<name>_seg.png` (the Cityscapes palette) and, for a model with a
depth head, `<name>_depth.png` (magma, scaled by `data.depth_max`) in
`--out-dir`.  Runs on `cuda` unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import glob
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run DenseCLIP inference on images (PyTorch port)")
    p.add_argument("config", help="config YAML path or preset name")
    p.add_argument("checkpoint", help="checkpoint file or work dir")
    p.add_argument("inputs", help="image file or directory")
    p.add_argument("-o", "--out-dir", default="inference_out")
    p.add_argument("--mode", choices=["whole", "slide"], default="whole")
    # slide protocol defaults come from the config's `test:` section
    p.add_argument("--crop", type=int, nargs=2, default=None)
    p.add_argument("--stride", type=int, nargs=2, default=None)
    p.add_argument("--window-batch", type=int, default=None,
                   help="run the slide windows in chunks of this many")
    p.add_argument("--aug-test", action="store_true",
                   help="multi-scale (0.5-1.75) + flip logit averaging")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", dest="overrides", nargs="*", default=[],
                   metavar="KEY.PATH=VALUE", help="dotted config overrides")
    return p.parse_args(argv)


def image_paths(inputs: str) -> list:
    """The image files of `inputs`: the file itself, or a directory's
    `*.png`, `*.jpg` and `*.jpeg` files, sorted (the JAX CLI's rule)."""
    if os.path.isdir(inputs):
        return sorted(sum((glob.glob(os.path.join(inputs, e))
                           for e in ("*.png", "*.jpg", "*.jpeg")), []))
    return [inputs]


def main(argv=None) -> list:
    """Runs the CLI; returns the PNG paths written."""
    args = parse_args(argv)

    import torch

    from denseclip_vit_multimodal_tpu_torch.core.config import (
        load_config,
        resolve_config_path,
        resolve_test_protocol,
    )
    from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.infer.server import _decoder
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import load_model_weights
    from denseclip_vit_multimodal_tpu_torch.train.loop import class_names_for
    from denseclip_vit_multimodal_tpu_torch.utils.png import encode_png
    from denseclip_vit_multimodal_tpu_torch.utils.visualize import colorize_depth, colorize_seg

    cfg = load_config(resolve_config_path(args.config), overrides=args.overrides)
    args.crop, args.stride, args.window_batch = resolve_test_protocol(
        cfg, args.crop, args.stride, args.window_batch)
    data_cfg = cfg.get("data", {}) or {}
    class_names = class_names_for(data_cfg)
    tpu_cfg = cfg.get("tpu", {}) or {}
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        str(tpu_cfg.get("compute_dtype", "bfloat16"))]
    model, texts = build_denseclip(cfg.model, class_names, dtype=dtype,
                                   attn_impl=str(tpu_cfg.get("attn_impl", "auto")),
                                   device=args.device)
    load_model_weights(args.checkpoint, model)
    infer = Inferencer(model, texts, augment_config_from_data_cfg(data_cfg, train=False),
                       num_classes=len(class_names))
    depth_max = float(data_cfg.get("depth_max", 80.0))

    paths = image_paths(args.inputs)
    if not paths:
        raise SystemExit(f"no images found under {args.inputs}")
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for path in paths:
        with open(path, "rb") as f:
            img = _decoder(f.read())[2]()[None]
        # fetch="argmax": only the argmax and the depth are drawn, so the fp32
        # logit canvas never leaves the device
        kwargs = dict(mode=args.mode, crop=tuple(args.crop), stride=tuple(args.stride),
                      window_batch=args.window_batch, fetch="argmax")
        out = infer.aug_test(img, **kwargs) if args.aug_test else infer.predict(img, **kwargs)
        base = os.path.join(args.out_dir, os.path.splitext(os.path.basename(path))[0])
        outputs = [(f"{base}_seg.png", colorize_seg(out["seg"][0]))]
        if "depth" in out:
            outputs.append((f"{base}_depth.png", colorize_depth(out["depth"][0], depth_max)))
        for name, rgb in outputs:
            with open(name, "wb") as f:
                f.write(encode_png(rgb))
            written.append(name)
        print(f"{path} -> {base}_seg.png")
    return written


if __name__ == "__main__":
    main()
