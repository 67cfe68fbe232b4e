"""FLOPs / parameter report of the port (the JAX package's `tools/get_flops.py`).

    python3 -m denseclip_vit_multimodal_tpu_torch.tools.get_flops CONFIG --shape 512 1024
    python3 -m denseclip_vit_multimodal_tpu_torch.tools.get_flops CONFIG --device cpu --set ...

Builds the model of CONFIG (random weights from a seed) on the device, runs
one forward of a zero image of `--batch` × `--shape` and prints the
parameter count and the forward FLOPs by `utils/flops.py::program_flops`,
split into what FlopCounterMode counted of the aten ops and the make-up of
the hand-written kernels launched.  On the CPU the kernels' plain versions
run and FlopCounterMode counts them, so the make-up is 0 and the total the
same.  The JAX tool also prints XLA's "bytes accessed"; nothing in PyTorch
gives that figure, so there is no bytes line.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DenseCLIP FLOPs report (PyTorch port)")
    p.add_argument("config", help="config YAML path or preset name")
    p.add_argument("--shape", type=int, nargs=2, default=[512, 1024], metavar=("H", "W"))
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", dest="overrides", nargs="*", default=[],
                   metavar="KEY.PATH=VALUE", help="dotted config overrides")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from denseclip_vit_multimodal_tpu_torch.bench import build_model, check_device

    check_device(args.device)
    import torch

    from denseclip_vit_multimodal_tpu_torch.core.config import load_config, resolve_config_path
    from denseclip_vit_multimodal_tpu_torch.train.state import count_params
    from denseclip_vit_multimodal_tpu_torch.utils.flops import program_flops

    cfg = load_config(resolve_config_path(args.config), overrides=args.overrides)
    model, texts = build_model(cfg, args.device)
    h, w = args.shape
    image = torch.zeros(args.batch, h, w, 3, device=args.device)
    # no_grad, not inference mode: a model that reads its score map runs the
    # text tower on its learnable contexts here, which FlopCounterMode's module
    # tracker cannot follow under inference mode (utils/flops.py::program_flops)
    with torch.no_grad():
        flops = program_flops(model, image, texts)
    n_params = count_params(model)

    print(f"input shape : {args.batch}x{h}x{w}x3")
    print(f"parameters  : {n_params / 1e6:.2f} M")
    print(f"forward flops: {flops.total / 1e9:.2f} GFLOPs")
    print(f"  (= {flops.aten / 1e9:.2f} aten-counted + {flops.kernels / 1e9:.2f} "
          f"kernel make-up: {flops.by_kernel})")
    return {"parameters": n_params, "flops": flops.total, "aten_flops": flops.aten,
            "kernel_flops": flops.kernels, "by_kernel": flops.by_kernel}


if __name__ == "__main__":
    main()
