"""Serving CLI of the port: config + checkpoint -> HTTP inference endpoint
(the JAX package's `tools/serve.py`, on one device).

    python3 -m denseclip_vit_multimodal_tpu_torch.tools.serve CONFIG CHECKPOINT \
        --port 8000 --warmup 1024 2048 --set tpu.attn_impl=int8
    curl -s -X POST --data-binary @frame.png 'localhost:8000/v1/predict?format=json'

    # or from a tools/export.py bundle, with no config, checkpoint or model code:
    python3 -m denseclip_vit_multimodal_tpu_torch.tools.serve --from-export out_dir --port 8000

CHECKPOINT is a checkpoint file of the port's own format or a work dir (its
`checkpoints/latest`).  The endpoint contract is in `infer/server.py`.  Runs
on `cuda` unless `--device cpu`; a bundle is served on the device it was
exported on (`infer/exported.py`).
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serve DenseCLIP over HTTP (PyTorch port)")
    p.add_argument("config", nargs="?", help="config YAML path or preset name")
    p.add_argument("checkpoint", nargs="?", help="checkpoint file or work dir")
    p.add_argument("--from-export", default=None, metavar="DIR",
                   help="serve a tools/export.py bundle (torch.export program, weights inside) "
                        "with no config, checkpoint or model code; the protocol comes from "
                        "the bundle's meta.json")
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


def build_service_from_export(args):
    """export dir -> (InferenceService, epoch None).

    The bundle's meta.json fixes mode, crop, stride and window batch; a CLI
    protocol flag that conflicts with it exits rather than being ignored.
    aug_test is not exportable (one program per scale)."""
    from denseclip_vit_multimodal_tpu_torch.infer.exported import ExportedInferencer
    from denseclip_vit_multimodal_tpu_torch.infer.server import InferenceService

    infer = ExportedInferencer(args.from_export, device=args.device)
    for flag, ours in (("crop", infer.crop), ("stride", infer.stride)):
        want = getattr(args, flag)
        if want is not None and tuple(want) != ours:
            raise SystemExit(f"--{flag} {tuple(want)} conflicts with the export's {flag}={ours}; "
                             "re-export to change the protocol")
    if args.mode is not None and args.mode != infer.mode:
        raise SystemExit(f"--mode {args.mode} conflicts with the export's mode={infer.mode!r}; "
                         "re-export to change the protocol")
    if args.window_batch is not None and int(args.window_batch) != infer.window_batch:
        raise SystemExit(f"--window-batch {args.window_batch} conflicts with the export's "
                         f"window_batch={infer.window_batch}; re-export to change the protocol")
    if args.aug_test:
        raise SystemExit("--aug-test cannot be served from an export")
    # a 'logits' export serves either fetch policy (packaged from the
    # program's canvas); a baked one serves exactly its own
    if infer.export_fetch in ("argmax", "packed") and args.fetch != infer.export_fetch:
        raise SystemExit(f"export was baked with fetch={infer.export_fetch!r}; "
                         f"serve with --fetch {infer.export_fetch} or re-export")
    service = InferenceService(
        infer, mode=infer.mode, crop=infer.crop, stride=infer.stride,
        window_batch=infer.window_batch, depth_max=infer.depth_max,
        model_name=infer.model_name, fetch=args.fetch, device_timeout=args.device_timeout,
    )
    return service, None


def build_service(args):
    """config + checkpoint (or an export dir) -> (InferenceService, restored
    epoch), no socket."""
    if getattr(args, "from_export", None):
        return build_service_from_export(args)
    import torch

    from denseclip_vit_multimodal_tpu_torch.core.config import (
        load_config,
        resolve_config_path,
        resolve_test_protocol,
    )
    from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.infer.server import InferenceService
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import load_model_weights
    from denseclip_vit_multimodal_tpu_torch.train.loop import class_names_for

    cfg = load_config(resolve_config_path(args.config), overrides=args.overrides)
    crop, stride, window_batch = resolve_test_protocol(cfg, args.crop, args.stride,
                                                       args.window_batch)
    data_cfg = cfg.get("data", {}) or {}
    class_names = class_names_for(data_cfg)
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
    origin = args.from_export or f"{args.config} (epoch {epoch})"
    print(f"serving {origin} on http://{args.host}:{server.server_address[1]}  "
          f"mode={service.mode} crop={service.crop} stride={service.stride}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
