"""Multi-client HTTP serving throughput of the port (the JAX package's
`tools/exp_serving_concurrency.py`).

Drives the real serving stack (`make_server` + `InferenceService` +
`Inferencer` on a seeded init of `--config`) with K concurrent HTTP clients
that POST one PNG frame each, again and again, and prints one JSON line per
client count: `clients`, `images`, `wall_s`, `images_per_sec` and
`device_occupancy_pct`, the seconds the single-flight device lock was held
(`service.stats.device_seconds_total`) over wall time.

The lock serialises device work by design, so more clients can only gain by
overlapping one request's host work (PNG decode, npz encode, HTTP) with
another's device call.

    python3 -m denseclip_vit_multimodal_tpu_torch.tools.exp_serving_concurrency \
        --clients 1 4 --requests 6 --size 1024 2048 --fetch packed

The frame is encoded by the port's own `utils/png.py::encode_png` (the card
has no Pillow).  Runs on `cuda` unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.client import HTTPConnection

import numpy as np


def png_frame(h: int, w: int, seed: int = 0) -> bytes:
    from denseclip_vit_multimodal_tpu_torch.utils.png import encode_png

    return encode_png(np.random.RandomState(seed).randint(0, 255, (h, w, 3), np.uint8))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Multi-client HTTP serving throughput (PyTorch port)")
    p.add_argument("--config", default="configs/denseclip_vitb16_cityscapes_multitask.yaml")
    p.add_argument("--clients", type=int, nargs="*", default=[1, 4])
    p.add_argument("--requests", type=int, default=6, help="requests PER CLIENT per measurement")
    p.add_argument("--size", type=int, nargs=2, default=[1024, 2048])
    p.add_argument("--fetch", default="packed")
    p.add_argument("--mode", default="slide")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Runs the experiment; returns the JSON lines' dicts, one per client count."""
    args = parse_args(argv)

    import torch

    from denseclip_vit_multimodal_tpu_torch.core.config import load_config, resolve_test_protocol
    from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.infer.server import InferenceService, make_server
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip
    from denseclip_vit_multimodal_tpu_torch.train.loop import class_names_for

    cfg = load_config(args.config)
    crop, stride, window_batch = resolve_test_protocol(cfg)
    data_cfg = cfg.get("data", {}) or {}
    class_names = class_names_for(data_cfg)
    model, texts = build_denseclip(
        cfg.model, class_names, dtype=torch.bfloat16,
        attn_impl=str((cfg.get("tpu", {}) or {}).get("attn_impl", "auto")), device=args.device,
        seed=0)
    infer = Inferencer(model, texts, augment_config_from_data_cfg(data_cfg, train=False),
                       num_classes=len(class_names))
    service = InferenceService(infer, mode=args.mode, crop=tuple(crop), stride=tuple(stride),
                               window_batch=window_batch, fetch=args.fetch, device_timeout=300.0)
    server = make_server(service, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    h, w = args.size
    png = png_frame(h, w)
    print(f"# frame {h}x{w}, png {len(png) / 1e6:.1f} MB, mode={args.mode} crop={crop} "
          f"fetch={args.fetch}", flush=True)

    def one_request():
        conn = HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.request("POST", "/v1/predict?format=npz", body=png,
                         headers={"Content-Type": "image/png"})
            resp = conn.getresponse()
            body = resp.read()
        finally:
            conn.close()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {body[:200]!r}")
        return len(body)

    lines = []
    try:
        t0 = time.perf_counter()
        one_request()  # kernels' build, cuDNN plans, the cached text tower
        print(f"# warmup request {time.perf_counter() - t0:.1f}s", flush=True)
        one_request()  # steady state

        for k in args.clients:
            errs, done = [], [0]
            lock = threading.Lock()

            def client():
                try:
                    for _ in range(args.requests):
                        one_request()
                        with lock:
                            done[0] += 1
                except Exception as e:  # noqa: BLE001 — recorded, raised below
                    errs.append(repr(e))

            dev_t0 = service.stats.device_seconds_total
            threads = [threading.Thread(target=client) for _ in range(k)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            dev_dt = service.stats.device_seconds_total - dev_t0
            if errs:
                raise RuntimeError(f"{len(errs)} client(s) failed: {errs}")
            line = {"clients": k, "images": done[0], "wall_s": wall,
                    "images_per_sec": done[0] / wall,
                    # lock-HELD seconds / wall: the single-flight device's busy
                    # share (inference_seconds_total would add the lock waits
                    # of every client and pass 100%)
                    "device_occupancy_pct": 100 * dev_dt / wall}
            print(json.dumps(line), flush=True)
            lines.append(line)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        service.close()
    return lines


if __name__ == "__main__":
    main()
