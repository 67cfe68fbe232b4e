"""Serving CLI of the port: config + checkpoint -> HTTP inference endpoint
(the JAX package's `tools/serve.py`, on one device).

    python3 -m denseclip_vit_multimodal_tpu_torch.tools.serve CONFIG CHECKPOINT \
        --port 8000 --warmup 1024 2048 --set tpu.attn_impl=int8
    curl -s -X POST --data-binary @frame.png 'localhost:8000/v1/predict?format=json'

CHECKPOINT is a checkpoint file of the port's own format or a work dir (its
`checkpoints/latest`).  The endpoint contract is in `infer/server.py`.  Runs
on `cuda` unless `--device cpu`.  `--from-export` waits for `infer/exported.py`,
which is not ported yet.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serve DenseCLIP over HTTP (PyTorch port)")
    p.add_argument("config", nargs="?", help="config YAML path or preset name")
    p.add_argument("checkpoint", nargs="?", help="checkpoint file or work dir")
    p.add_argument("--from-export", default=None, metavar="DIR",
                   help="serve an exported bundle (not yet ported: needs infer/exported.py)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--mode", choices=["whole", "slide"], default=None,
                   help="inference mode (default: slide)")
    # slide protocol defaults come from the config's `test:` section
    p.add_argument("--crop", type=int, nargs=2, default=None)
    p.add_argument("--stride", type=int, nargs=2, default=None)
    p.add_argument("--window-batch", type=int, default=None)
    p.add_argument("--aug-test", action="store_true",
                   help="multi-scale + flip averaging per request")
    p.add_argument("--fetch", choices=["argmax", "packed"], default="argmax",
                   help="device->host policy: packed = uint8 seg + float16 depth")
    p.add_argument("--device-timeout", type=float, default=0.0,
                   help="deadline (s) per device call: a miss answers 503 and turns "
                        "/healthz to degraded instead of hanging clients (0 = off)")
    p.add_argument("--max-body-mb", type=float, default=64.0,
                   help="reject POST bodies larger than this with 413")
    p.add_argument("--warmup", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="run one frame of this size before accepting traffic")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", dest="overrides", nargs="*", default=[],
                   metavar="KEY.PATH=VALUE", help="dotted config overrides")
    args = p.parse_args(argv)
    if args.from_export is None and not (args.config and args.checkpoint):
        p.error("config and checkpoint are required unless --from-export")
    return args


def build_service(args):
    """config + checkpoint -> (InferenceService, restored epoch), no socket."""
    if getattr(args, "from_export", None):
        raise NotImplementedError("--from-export needs infer/exported.py, which is not yet "
                                  "ported to the PyTorch package")
    import torch

    from denseclip_vit_multimodal_tpu_torch.core.config import (
        load_config,
        resolve_config_path,
        resolve_test_protocol,
    )
    from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.infer.server import InferenceService
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import load_model_weights

    cfg = load_config(resolve_config_path(args.config), overrides=args.overrides)
    crop, stride, window_batch = resolve_test_protocol(cfg, args.crop, args.stride,
                                                       args.window_batch)
    data_cfg = cfg.get("data", {}) or {}
    if "ADE20K" in str(data_cfg.get("dataset_type", "")):
        raise ValueError("ADE20K serving is not yet ported to the PyTorch package")
    class_names = CITYSCAPES_CLASSES
    tpu_cfg = cfg.get("tpu", {}) or {}
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        str(tpu_cfg.get("compute_dtype", "bfloat16"))]
    model, texts = build_denseclip(cfg.model, class_names, dtype=dtype,
                                   attn_impl=str(tpu_cfg.get("attn_impl", "auto")),
                                   device=args.device)
    epoch = load_model_weights(args.checkpoint, model)
    infer = Inferencer(model, texts, augment_config_from_data_cfg(data_cfg, train=False),
                       num_classes=len(class_names))
    service = InferenceService(
        infer, mode=args.mode or "slide", crop=tuple(crop), stride=tuple(stride),
        window_batch=window_batch, aug_test=args.aug_test,
        depth_max=float(data_cfg.get("depth_max", 80.0)),
        model_name=os.path.basename(str(args.config)), fetch=args.fetch,
        device_timeout=args.device_timeout,
    )
    return service, epoch


def main(argv=None):
    args = parse_args(argv)
    from denseclip_vit_multimodal_tpu_torch.infer.server import make_server

    service, epoch = build_service(args)
    if args.warmup:
        print(f"warm-up at {args.warmup[0]}x{args.warmup[1]} ...", flush=True)
        service.warmup(tuple(args.warmup))
    server = make_server(service, args.host, args.port,
                         max_body_bytes=int(args.max_body_mb * (1 << 20)))
    print(f"serving {args.config} (epoch {epoch}) on http://{args.host}:"
          f"{server.server_address[1]}  mode={service.mode} crop={service.crop} "
          f"stride={service.stride}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
