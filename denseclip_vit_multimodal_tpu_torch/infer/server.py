"""HTTP serving over the port's :class:`Inferencer` (the JAX package's
`infer/server.py`, on one device).

- **Single-flight device access**: one call reaches the device at a time;
  the HTTP layer is threaded (`ThreadingHTTPServer`), so the decode and
  encode of other requests, health and metrics overlap the call in flight.
- **Deadline on the device call**: with `device_timeout` set, device calls
  run on one worker thread and a call past the deadline answers 503 instead
  of hanging the client.  The deadline is end to end (queue wait and device
  call); a call whose client gave up while it was queued never reaches the
  device; while a timed-out call is still running, further predicts fail
  fast with 503 and `/healthz` reports `status: degraded` with its age.
  Results are fetched to the host inside the deadline, through a
  `torch.cuda.synchronize`.
- **Compact fetches**: only the seg argmax and the depth cross to the host
  (`fetch='packed'`: uint8 seg + float16 depth).
- **No Pillow, no matplotlib for PNG**: PNG bodies go through `utils/png.py`,
  panels through `utils/visualize.py`.  Other image formats are decoded by
  Pillow when it can be imported, and answer 400 saying so when it cannot.

Endpoints: `GET /healthz` (JSON liveness, model and protocol, seconds since
the last success, in-flight age), `GET /metrics` (Prometheus text:
request / error / timeout / image counters, inference and device seconds),
`POST /v1/predict` (body: image bytes; query `format=npz|json|png`,
`target=seg|depth` for png, `mode=whole|slide`, `aug=1`).

Error contract: 400 for client errors (bad image, unknown format / mode /
aug / target, oversized decode), 413 for oversized bodies, 503 for a device
deadline miss, 500 for internal faults; all counted in
`denseclip_errors_total` (503 also in `denseclip_timeouts_total`), and no
invalid-parameter case spends a device call.
"""

from __future__ import annotations

import io
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from denseclip_vit_multimodal_tpu_torch.utils import png
from denseclip_vit_multimodal_tpu_torch.utils.visualize import colorize_depth, colorize_seg

#: formats handle_predict can encode; validated BEFORE any device work.
ALLOWED_FORMATS = ("npz", "json", "png")
_AUG_TRUE = ("1", "true", "yes", "on")
_AUG_FALSE = ("0", "false", "no", "off", "")


class DeviceTimeoutError(RuntimeError):
    """A device call exceeded the serving deadline."""


class ServingStats:
    """Thread-safe counters exported at /metrics (Prometheus text format)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.errors_total = 0
        self.timeouts_total = 0
        self.inference_seconds_total = 0.0
        self.device_seconds_total = 0.0
        self.images_total = 0

    def record(self, seconds: float, ok: bool, images: int = 1, timeout: bool = False):
        with self._lock:
            self.requests_total += 1
            if ok:
                self.inference_seconds_total += seconds
                self.images_total += images
            else:
                self.errors_total += 1
                if timeout:
                    self.timeouts_total += 1

    def record_device(self, seconds: float):
        """Seconds spent holding the single-flight device lock: unlike the
        per-request `inference_seconds_total` (which sums lock waits across
        concurrent clients), its rate is the device's busy fraction."""
        with self._lock:
            self.device_seconds_total += seconds

    def render(self) -> str:
        with self._lock:
            counters = [
                ("requests_total", self.requests_total),
                ("errors_total", self.errors_total),
                ("timeouts_total", self.timeouts_total),
                ("images_total", self.images_total),
                ("inference_seconds_total", f"{self.inference_seconds_total:.6f}"),
                ("device_seconds_total", f"{self.device_seconds_total:.6f}"),
            ]
        lines = []
        for name, value in counters:
            lines += [f"# TYPE denseclip_{name} counter", f"denseclip_{name} {value}"]
        return "\n".join(lines) + "\n"


def _open_with_pillow(body: bytes):
    """A Pillow image of a non-PNG body (lazy: header only)."""
    try:
        from PIL import Image
    except ImportError:
        raise ValueError("not a PNG, and other image formats need Pillow, which is "
                         "not installed") from None
    return Image.open(io.BytesIO(body))


def _decoder(body: bytes) -> Tuple[int, int, Callable[[], np.ndarray]]:
    """(width, height, decode) of an image body; only the header is read here."""
    if png.is_png(body):
        hdr = png.read_header(body)
        return hdr.width, hdr.height, lambda: png.decode_png(body)
    image = _open_with_pillow(body)
    w, h = image.size
    return w, h, lambda: np.asarray(image.convert("RGB"), np.uint8)


class InferenceService:
    """Model-side half of the server: decode -> predict -> encode.

    HTTP-free, so tests (and other transports) call it directly.
    """

    def __init__(
        self,
        inferencer,
        mode: str = "whole",
        crop: Tuple[int, int] = (640, 640),
        stride: Tuple[int, int] = (426, 426),
        window_batch: int = 0,
        aug_test: bool = False,
        depth_max: float = 80.0,
        model_name: str = "denseclip",
        fetch: str = "argmax",
        device_timeout: float = 0.0,
        max_pixels: int = 64 << 20,
    ):
        self.inferencer = inferencer
        self.mode = mode
        self.crop = tuple(crop)
        self.stride = tuple(stride)
        self.window_batch = window_batch
        self.aug_test = aug_test
        self.depth_max = float(depth_max)
        self.model_name = model_name
        if fetch not in ("argmax", "packed"):
            raise ValueError(f"serving fetch must be 'argmax' or 'packed', got {fetch!r}")
        if fetch == "packed" and int(getattr(inferencer, "num_classes", 0)) > 256:
            # a config error at start-up, not a misleading 400 per request
            raise ValueError(f"fetch='packed' needs num_classes <= 256, got "
                             f"{inferencer.num_classes}; serve with fetch='argmax'")
        self.fetch = fetch
        #: deadline (seconds) of one device call; 0 disables the watchdog.
        self.device_timeout = float(device_timeout)
        #: reject images whose decoded H*W exceeds this (decompression bombs).
        self.max_pixels = int(max_pixels)
        self.stats = ServingStats()
        self._device_lock = threading.Lock()  # one frame on the device at a time
        # watchdog bookkeeping (under _meta_lock): when the running device call
        # started, and when one last succeeded
        self._meta_lock = threading.Lock()
        self._inflight_since: Optional[float] = None
        self._last_success: Optional[float] = None
        self._executor: Optional[ThreadPoolExecutor] = None

    # -- core ------------------------------------------------------------

    def _run_with_deadline(self, call, timeout: Optional[float]):
        """Run `call` under the single-flight lock, bounded by `timeout`.

        timeout None / <= 0: unbounded (warm-up).  With a deadline the call
        runs on a persistent single worker thread and the deadline covers the
        queue wait and the call.  A miss raises DeviceTimeoutError, and the
        abandoned call is skipped before it reaches the device (a queued
        entry nobody waits for would otherwise still run later, holding the
        lock for nobody).  A call already running when its deadline expires
        cannot be interrupted; later calls fail fast on the in-flight age
        until it drains.
        """

        def tracked(abandoned: Optional[threading.Event] = None):
            with self._device_lock:
                if abandoned is not None and abandoned.is_set():
                    return None  # the client timed out while queued: no dispatch
                # mark in flight only while HOLDING the lock, so the marker
                # always describes the call on the device
                with self._meta_lock:
                    self._inflight_since = time.monotonic()
                t0 = time.monotonic()
                try:
                    return call()
                finally:
                    self.stats.record_device(time.monotonic() - t0)
                    with self._meta_lock:
                        self._inflight_since = None

        if not timeout or timeout <= 0:
            out = tracked()
            with self._meta_lock:
                self._last_success = time.monotonic()
            return out

        with self._meta_lock:
            stuck = self._inflight_since
            if stuck is not None and time.monotonic() - stuck > timeout:
                raise DeviceTimeoutError(
                    f"device wedged: in-flight call is {time.monotonic() - stuck:.1f}s old "
                    f"(deadline {timeout:.1f}s)")
            if self._executor is None:
                self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="device")
            executor = self._executor
        abandoned = threading.Event()
        future = executor.submit(tracked, abandoned)
        try:
            out = future.result(timeout=timeout)
        except _FutureTimeout:
            abandoned.set()  # never dispatch a call nobody is waiting for
            raise DeviceTimeoutError(f"device call exceeded {timeout:.1f}s deadline") from None
        with self._meta_lock:
            self._last_success = time.monotonic()
        return out

    def predict_array(self, img: np.ndarray, mode: Optional[str] = None,
                      aug: Optional[bool] = None,
                      timeout: Optional[float] = -1.0) -> dict:
        """uint8 [H, W, 3] -> {'seg' [H, W], 'depth'? [H, W]} as numpy.

        Dtypes follow the fetch policy: int32 / fp32 for 'argmax', uint8 /
        float16 for 'packed'.  `timeout=-1` uses the service's
        `device_timeout`; None waits forever (warm-up).  A deadline miss
        raises :class:`DeviceTimeoutError`.
        """
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"expected [H, W, 3] uint8 image, got {img.shape}")
        mode = self.mode if mode is None else mode
        if mode not in ("whole", "slide"):
            raise ValueError(f"unknown mode {mode!r}")
        aug = self.aug_test if aug is None else aug
        kwargs = dict(mode=mode, crop=self.crop, stride=self.stride,
                      window_batch=self.window_batch, fetch=self.fetch)
        if timeout is not None and timeout < 0:
            timeout = self.device_timeout

        def call():
            fn = self.inferencer.aug_test if aug else self.inferencer.predict
            out = fn(img[None], **kwargs)
            # fetch to the host INSIDE the deadline: a wedged device hangs the
            # copy exactly as it hangs the call
            device = getattr(self.inferencer, "device", None)
            if isinstance(device, torch.device) and device.type == "cuda":
                torch.cuda.synchronize(device)
            res = {"seg": np.asarray(out["seg"][0])}
            if "depth" in out:
                res["depth"] = np.asarray(out["depth"][0])
            return res

        return self._run_with_deadline(call, timeout)

    def warmup(self, hw: Tuple[int, int]):
        """Run one frame of this size before serving (cuDNN plans, the cached
        text tower, the kernels' first build), with no deadline."""
        self.predict_array(np.zeros((hw[0], hw[1], 3), np.uint8), timeout=None)

    def close(self):
        """Stop the deadline worker thread (after its current call)."""
        with self._meta_lock:
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=True)

    # -- request plumbing --------------------------------------------------

    def _client_error(self, message: str) -> Tuple[int, str, bytes]:
        self.stats.record(0.0, ok=False)
        return 400, "application/json", json.dumps({"error": message}).encode()

    def handle_predict(self, body: bytes, query: dict) -> Tuple[int, str, bytes]:
        """Returns (status, content_type, payload).

        Every parameter is validated BEFORE any device work, so a malformed
        request costs no device call and counts as an error (400); a device
        deadline miss answers 503, an internal fault 500.
        """
        fmt = query.get("format", ["npz"])[0]
        if fmt not in ALLOWED_FORMATS:
            return self._client_error(f"unknown format {fmt!r} (npz|json|png)")
        mode = query.get("mode", [None])[0]
        if mode is not None and mode not in ("whole", "slide"):
            return self._client_error(f"unknown mode {mode!r} (whole|slide)")
        aug_q = query.get("aug", [None])[0]
        if aug_q is None:
            aug = None
        elif aug_q.lower() in _AUG_TRUE:
            aug = True
        elif aug_q.lower() in _AUG_FALSE:
            aug = False
        else:
            return self._client_error(
                f"unknown aug value {aug_q!r} (1|true|yes|on / 0|false|no|off)")
        target = query.get("target", ["seg"])[0]
        if fmt == "png" and target not in ("seg", "depth"):
            return self._client_error(f"unknown target {target!r} (seg|depth)")
        if fmt == "png" and target == "depth" and not getattr(self.inferencer, "with_depth", True):
            return self._client_error("no depth head")

        try:
            w, h, decode = _decoder(body)  # header only: no pixel decoded yet
        except Exception as e:  # noqa: BLE001 — any decode failure is a 400
            return self._client_error(f"cannot decode image: {e}")
        # bound the pixels BEFORE the full decode (decompression bombs)
        if w * h > self.max_pixels:
            return self._client_error(f"image {h}x{w} exceeds the {self.max_pixels}-pixel limit")
        try:
            img = decode()
        except Exception as e:  # noqa: BLE001 — truncated data shows only now
            return self._client_error(f"cannot decode image: {e}")

        t0 = time.perf_counter()
        try:
            res = self.predict_array(img, mode=mode, aug=aug)
        except DeviceTimeoutError as e:
            self.stats.record(0.0, ok=False, timeout=True)
            return 503, "application/json", json.dumps({"error": str(e)}).encode()
        except ValueError as e:
            return self._client_error(str(e))
        except Exception as e:  # noqa: BLE001 — a fault of the server, not the client
            self.stats.record(0.0, ok=False)
            return 500, "application/json", json.dumps({"error": f"internal: {e}"}).encode()
        dt = time.perf_counter() - t0
        self.stats.record(dt, ok=True)

        if fmt == "npz":
            buf = io.BytesIO()
            np.savez(buf, **res)
            return 200, "application/octet-stream", buf.getvalue()
        if fmt == "json":
            # a machine-readable summary, not per pixel (that is what npz is for)
            hist = np.bincount(res["seg"].ravel(), minlength=self.inferencer.num_classes)
            payload = {"shape": list(res["seg"].shape), "class_pixels": hist.tolist(),
                       "latency_s": round(dt, 4)}
            if "depth" in res:
                depth = res["depth"].astype(np.float32)
                payload["depth_mean"] = float(depth.mean())
                payload["depth_max"] = float(depth.max())
            return 200, "application/json", json.dumps(payload).encode()
        # fmt == "png" (validated above)
        if target == "depth":
            if "depth" not in res:
                return self._client_error("no depth head")
            panel = colorize_depth(res["depth"].astype(np.float32), self.depth_max)
        else:
            panel = colorize_seg(res["seg"])
        return 200, "image/png", png.encode_png(panel)

    def health(self) -> dict:
        now = time.monotonic()
        with self._meta_lock:
            last, inflight = self._last_success, self._inflight_since
        last_age = None if last is None else round(now - last, 3)
        inflight_age = None if inflight is None else round(now - inflight, 3)
        # degraded: a device call has been in flight past the deadline
        degraded = bool(self.device_timeout > 0 and inflight_age is not None
                        and inflight_age > self.device_timeout)
        return {
            "status": "degraded" if degraded else "ok",
            "model": self.model_name,
            "num_classes": self.inferencer.num_classes,
            "with_depth": bool(self.inferencer.with_depth),
            "mode": self.mode,
            "crop": list(self.crop),
            "stride": list(self.stride),
            "aug_test": self.aug_test,
            "fetch": self.fetch,
            "device_timeout_s": self.device_timeout,
            "last_success_age_s": last_age,
            "inflight_age_s": inflight_age,
            "timeouts_total": self.stats.timeouts_total,
        }


def make_server(service: InferenceService, host: str = "127.0.0.1", port: int = 0,
                max_body_bytes: int = 64 << 20) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; port 0 = ephemeral.

    `max_body_bytes` caps POST bodies (413 past it), so an oversized upload
    cannot exhaust host memory before the decoder sees it."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # noqa: D102 — the stats carry the signal
            pass

        def _send(self, status: int, ctype: str, payload: bytes):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):  # noqa: N802 — http.server API
            path = urlparse(self.path).path
            if path == "/healthz":
                self._send(200, "application/json", json.dumps(service.health()).encode())
            elif path == "/metrics":
                self._send(200, "text/plain; version=0.0.4", service.stats.render().encode())
            else:
                self._send(404, "application/json", b'{"error": "not found"}')

        def do_POST(self):  # noqa: N802
            parsed = urlparse(self.path)
            if parsed.path != "/v1/predict":
                self._send(404, "application/json", b'{"error": "not found"}')
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._send(400, "application/json", b'{"error": "invalid Content-Length"}')
                return
            if length <= 0:
                self._send(400, "application/json", b'{"error": "empty body; POST image bytes"}')
                return
            if length > max_body_bytes:
                self._send(413, "application/json", json.dumps(
                    {"error": f"body {length} B exceeds the {max_body_bytes} B limit"}).encode())
                return
            body = self.rfile.read(length)
            status, ctype, payload = service.handle_predict(body, parse_qs(parsed.query))
            self._send(status, ctype, payload)

    return ThreadingHTTPServer((host, port), Handler)
