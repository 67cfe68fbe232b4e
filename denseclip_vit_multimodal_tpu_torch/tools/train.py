"""Training CLI of the port (the JAX package's `tools/train.py`).

    python3 -m denseclip_vit_multimodal_tpu_torch.tools.train \
        configs/denseclip_vitb16_640x640_80k.yaml --no-validate --max-steps 10 \
        --set data.synthetic=true "data.synthetic_options.image_size=[1024,2048]"

Runs on `cuda` unless `--device cpu`.  Validates every `eval_interval`
epochs unless `--no-validate`.  `--deterministic` calls
`utils/env.py::set_determinism` before anything runs (the JAX flag's
"highest matmul precision": TF32 off, deterministic algorithms where PyTorch
has them).  `--resume` continues a run from its checkpoint (weights,
optimizer, step); `--load` warm-starts from a checkpoint's weights and
BatchNorm statistics alone, with a fresh optimizer at step 0 (a work dir of
`tools/train.py` or of `tools/import_checkpoint.py`).

Under `torchrun` (`tools/dist_train.sh`: one process a card) it trains over
the process group with JAX's global-batch semantics (`train/loop.py`):
NCCL on CUDA, Gloo with `--device cpu`.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train DenseCLIP (PyTorch port)")
    p.add_argument("config", help="config YAML path or preset name")
    p.add_argument("--work-dir", default=None, help="output directory")
    p.add_argument("--resume", default=None, help="checkpoint file or work dir to resume from")
    p.add_argument("--load", default=None,
                   help="checkpoint file or work dir to warm-start the weights from")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--deterministic", action="store_true",
                   help="TF32 off and deterministic algorithms (utils/env.py::set_determinism)")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--max-steps", type=int, default=None, help="cap the global step count")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", dest="overrides", nargs="*", default=[],
                   metavar="KEY.PATH=VALUE", help="dotted config overrides")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from denseclip_vit_multimodal_tpu_torch.core.config import load_config, resolve_config_path
    from denseclip_vit_multimodal_tpu_torch.train.loop import train

    cfg = load_config(resolve_config_path(args.config), overrides=args.overrides)
    if args.seed is not None:
        cfg.setdefault("training", {})["seed"] = args.seed
    if args.deterministic:
        from denseclip_vit_multimodal_tpu_torch.utils.env import set_determinism

        set_determinism()
    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(str(args.config)))[0])
    metrics = train(cfg, work_dir, resume=args.resume, max_steps=args.max_steps,
                    no_validate=args.no_validate, device=args.device, load=args.load)
    from denseclip_vit_multimodal_tpu_torch.parallel.mesh import rank

    if rank() == 0:
        print({k: round(v, 4) for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main()
