"""The port's HTTP serving (`infer/server.py`, `tools/serve.py`, `utils/png.py`,
`utils/visualize.py`) against the JAX package's.

A tiny flagship model (the verify recipe's overrides, with width 128 and 2
heads so that the int8 route applies) carries the same converted weights in
both packages; both services answer the same PNG bytes.  The contract tests
of `tests/test_serve.py` (400 / 413 / 503 / 500, metrics, deadline,
abandoned call, single flight) run against the port with a stand-in
inferencer.
"""

import io
import json
import socket
import threading
import time
import zlib
from http.client import HTTPConnection

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from denseclip_vit_multimodal_tpu.data.augment import AugmentConfig as JAugmentConfig
from denseclip_vit_multimodal_tpu.infer.engine import Inferencer as JInferencer
from denseclip_vit_multimodal_tpu.infer.server import InferenceService as JService
from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.ops import attention as j_attention
from denseclip_vit_multimodal_tpu.ops import mha_kernel as j_mha
from denseclip_vit_multimodal_tpu.utils import visualize as j_visualize
from denseclip_vit_multimodal_tpu_torch.convert import load_flax_variables
from denseclip_vit_multimodal_tpu_torch.core.config import load_config
from denseclip_vit_multimodal_tpu_torch.data.augment import AugmentConfig
from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
from denseclip_vit_multimodal_tpu_torch.infer.server import InferenceService, make_server
from denseclip_vit_multimodal_tpu_torch.models import layers as t_layers
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.ops import attention as t_attention
from denseclip_vit_multimodal_tpu_torch.utils import png
from denseclip_vit_multimodal_tpu_torch.utils.visualize import colorize_depth, colorize_seg

CONFIG = "configs/denseclip_vitb16_cityscapes_multitask.yaml"
TINY = [
    "model.backbone.width=128", "model.backbone.layers=2", "model.backbone.heads=2",
    "model.backbone.out_indices=[0,1]", "model.text_encoder.transformer_layers=1",
    "model.text_encoder.transformer_width=64", "model.text_encoder.transformer_heads=2",
    "model.token_embed_dim=64",
    "model.neck.inter_channels=16", "model.neck.out_channels=32",
    "model.decode_head.in_channels=32", "model.decode_head.channels=32",
    "model.depth_head.in_channels=32", "model.depth_head.channels=16",
    "data.crop_size=[64,128]", "tpu.compute_dtype=float32",
]
FRAME = (64, 128)
CROP, STRIDE = (48, 64), (32, 48)  # slide: 2 x 3 windows
# fp32 end to end, as tests/test_torch_infer.py; argmax compared where the
# top two logits are further apart than 10x this.
TOL = 1e-4
# The int8 path on both sides: the same quantized q/k/v and p8, but an exp2
# ulp can move a p8 by one step (measured here: 4.5e-7 on the logits, while
# int8 moves them 1.2e-3 from exact attention).
INT8_TOL = 1e-3


def _near_ties(logits, margin):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= margin


def _request(port, method, path, body=None):
    conn = HTTPConnection("127.0.0.1", port, timeout=120)
    headers = {"Content-Type": "application/octet-stream"} if body else {}
    conn.request(method, path, body=body, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    status, ctype = resp.status, resp.getheader("Content-Type")
    conn.close()
    return status, ctype, data


def _models(attn_impl):
    cfg = load_config(CONFIG, overrides=TINY)
    jm, texts = j_build(cfg.model, CITYSCAPES_CLASSES, attn_impl=attn_impl)
    tm, _ = t_build(cfg.model, CITYSCAPES_CLASSES, attn_impl=attn_impl, device="cpu")
    return jm, tm, texts


@pytest.fixture(scope="module")
def served():
    """Both services on one converted tiny model; the port's behind HTTP."""
    jm, tm, texts = _models("auto")
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1,) + FRAME + (3,)),
                                 jnp.asarray(texts))
    rs = np.random.RandomState(3)
    variables = {  # running statistics away from the identity
        "params": jax.tree.map(np.asarray, variables["params"]),
        "batch_stats": jax.tree.map(lambda a: (rs.rand(*a.shape) + 0.5).astype(np.float32),
                                    variables["batch_stats"]),
    }
    load_flax_variables(tm, variables)
    kw = dict(mode="whole", crop=CROP, stride=STRIDE, model_name="tiny-test")
    j_service = JService(JInferencer(jm, variables, texts, JAugmentConfig(crop_size=FRAME),
                                     num_classes=19, with_depth=True), **kw)
    t_service = InferenceService(Inferencer(tm, texts, AugmentConfig(crop_size=FRAME),
                                            num_classes=19), **kw)
    server = make_server(t_service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    img = np.random.RandomState(0).randint(0, 256, FRAME + (3,), dtype=np.uint8)
    yield {"port": server.server_address[1], "service": t_service, "jax": j_service,
           "variables": variables, "texts": texts, "img": img, "png": png.encode_png(img)}
    server.shutdown()
    server.server_close()


def _logits(service, img, mode):
    return service.inferencer.predict(img[None], mode=mode, crop=CROP, stride=STRIDE,
                                      fetch="logits")["seg_logits"][0]


@pytest.mark.parametrize("query", ["", "?mode=slide", "?format=json", "?format=png",
                                   "?format=png&target=depth"])
def test_http_answers_match_the_jax_service(served, query):
    status, ctype, data = _request(served["port"], "POST", "/v1/predict" + query, served["png"])
    j_status, j_ctype, j_data = served["jax"].handle_predict(
        served["png"], {k: [v] for k, v in (kv.split("=") for kv in query[1:].split("&") if kv)})
    assert (status, ctype) == (j_status, j_ctype) == (200, j_ctype)
    mode = "slide" if "slide" in query else "whole"
    clear = ~_near_ties(_logits(served["service"], served["img"], mode), 10 * TOL)
    assert clear.mean() > 0.9
    own = served["service"].predict_array(served["img"], mode=mode)
    if "format" not in query:  # npz: the machine contract
        got, want = np.load(io.BytesIO(data)), np.load(io.BytesIO(j_data))
        assert got["seg"].dtype == np.int32 and got["depth"].dtype == np.float32
        assert got["seg"].shape == got["depth"].shape == FRAME
        np.testing.assert_array_equal(got["seg"][clear], want["seg"][clear])
        np.testing.assert_allclose(got["depth"], want["depth"], atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(got["seg"], own["seg"])  # HTTP == direct call
    elif "json" in query:
        got, want = json.loads(data), json.loads(j_data)
        assert got["shape"] == want["shape"] == list(FRAME)
        assert sum(got["class_pixels"]) == FRAME[0] * FRAME[1]
        unclear = int((~clear).sum())
        assert np.abs(np.subtract(got["class_pixels"], want["class_pixels"])).sum() <= 2 * unclear
        assert got["depth_mean"] == pytest.approx(want["depth_mean"], rel=TOL)
    else:  # png panels, decoded without Pillow on the port's side
        got, want = png.decode_png(data), png.decode_png(j_data)
        assert got.shape == FRAME + (3,)
        if "depth" in query:
            np.testing.assert_array_equal(got, colorize_depth(own["depth"]))
            assert (got == want).all(axis=-1).mean() > 0.99  # bin edges 0.31 m apart
        else:
            np.testing.assert_array_equal(got, colorize_seg(own["seg"]))
            np.testing.assert_array_equal(got[clear], want[clear])


def test_int8_service_matches_the_jax_int8_service(served, monkeypatch):
    """The slice as a whole: `tpu.attn_impl: int8` on both sides, each
    through its int8 kernel's stand-in on the CPU (JAX: K5 in interpret mode;
    the port: K5's plain version), on the same PNG bytes."""
    monkeypatch.setattr(j_attention, "_on_tpu", lambda: True)
    monkeypatch.setattr(t_attention, "_on_cuda", lambda x: True)
    calls = {"jax": 0, "port": 0}
    j_int8, t_int8 = j_mha.mha_qkv_attention_int8, t_layers.mha_qkv_attention_int8

    def jax_interpret(*args, **kwargs):
        calls["jax"] += 1
        return j_int8(*args, **dict(kwargs, interpret=True))

    def port_counted(*args, **kwargs):
        calls["port"] += 1
        return t_int8(*args, **kwargs)

    monkeypatch.setattr(j_mha, "mha_qkv_attention_int8", jax_interpret)
    monkeypatch.setattr(t_layers, "mha_qkv_attention_int8", port_counted)
    jm, tm, texts = _models("int8")
    load_flax_variables(tm, served["variables"])
    kw = dict(mode="whole", crop=CROP, stride=STRIDE)
    j_service = JService(JInferencer(jm, served["variables"], texts,
                                     JAugmentConfig(crop_size=FRAME), num_classes=19,
                                     with_depth=True), **kw)
    t_service = InferenceService(Inferencer(tm, texts, AugmentConfig(crop_size=FRAME),
                                            num_classes=19), **kw)
    status, _, data = t_service.handle_predict(served["png"], {})
    j_status, _, j_data = j_service.handle_predict(served["png"], {})
    assert status == j_status == 200
    assert calls["port"] == 2 and calls["jax"] >= 2  # every ViT layer, each side
    got, want = np.load(io.BytesIO(data)), np.load(io.BytesIO(j_data))
    clear = ~_near_ties(_logits(t_service, served["img"], "whole"), INT8_TOL)
    assert clear.mean() > 0.8
    np.testing.assert_array_equal(got["seg"][clear], want["seg"][clear])
    np.testing.assert_allclose(got["depth"], want["depth"], atol=INT8_TOL, rtol=INT8_TOL)
    # and the int8 answer is not the exact one
    exact = served["service"].predict_array(served["img"])
    assert not np.array_equal(got["depth"], exact["depth"])


def test_healthz_and_metrics(served):
    status, ctype, data = _request(served["port"], "GET", "/healthz")
    info = json.loads(data)
    assert status == 200 and ctype == "application/json" and info["status"] == "ok"
    assert info["num_classes"] == 19 and info["with_depth"] is True
    assert info["mode"] == "whole" and info["crop"] == list(CROP)
    _request(served["port"], "POST", "/v1/predict", served["png"])
    _request(served["port"], "POST", "/v1/predict?format=bmp", served["png"])
    status, ctype, data = _request(served["port"], "GET", "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    counters = {line.split()[0]: float(line.split()[1])
                for line in data.decode().splitlines() if line and not line.startswith("#")}
    assert counters["denseclip_requests_total"] >= 2
    assert counters["denseclip_errors_total"] >= 1
    assert counters["denseclip_device_seconds_total"] > 0.0
    assert set(counters) == {f"denseclip_{k}" for k in (
        "requests_total", "errors_total", "timeouts_total", "images_total",
        "inference_seconds_total", "device_seconds_total")}


@pytest.mark.parametrize("method,path,body,status", [
    ("POST", "/v1/predict", b"not an image", 400),
    ("POST", "/v1/predict?format=bmp", "png", 400),
    ("POST", "/v1/predict?mode=diagonal", "png", 400),
    ("POST", "/v1/predict", None, 400),  # empty body
    ("GET", "/nope", None, 404),
])
def test_bad_requests_over_http(served, method, path, body, status):
    before = served["service"].stats.errors_total
    got, _, data = _request(served["port"], method, path,
                            served["png"] if body == "png" else body)
    assert got == status and b"error" in data
    if status == 400 and body is not None:
        assert served["service"].stats.errors_total == before + 1


def test_packed_fetch_service(served):
    base = served["service"]
    packed = InferenceService(base.inferencer, mode="whole", crop=base.crop, stride=base.stride,
                              fetch="packed")
    res_p, res_a = packed.predict_array(served["img"]), base.predict_array(served["img"])
    assert res_p["seg"].dtype == np.uint8 and res_p["depth"].dtype == np.float16
    np.testing.assert_array_equal(res_p["seg"], res_a["seg"].astype(np.uint8))
    np.testing.assert_allclose(res_p["depth"].astype(np.float32), res_a["depth"],
                               rtol=2e-3, atol=1e-3)
    assert packed.health()["fetch"] == "packed"
    with pytest.raises(ValueError, match="fetch"):
        InferenceService(base.inferencer, fetch="logits")


def test_concurrent_requests_single_flight(served):
    results, errors = [], []

    def hit():
        try:
            status, _, data = _request(served["port"], "POST", "/v1/predict", served["png"])
            assert status == 200
            results.append(np.load(io.BytesIO(data))["seg"])
        except Exception as e:  # noqa: BLE001 — collected for the main thread
            errors.append(e)

    threads = [threading.Thread(target=hit) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and len(results) == 4
    for seg in results[1:]:
        np.testing.assert_array_equal(seg, results[0])


def test_cli_build_service_from_checkpoint(tmp_path):
    """tools/serve.py: config + the port's checkpoint -> a working service."""
    from denseclip_vit_multimodal_tpu_torch.tools import serve as serve_tool
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import save_checkpoint
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state

    cfg = load_config(CONFIG, overrides=TINY)
    model, _ = t_build(cfg.model, CITYSCAPES_CLASSES, device="cpu", seed=7)
    save_checkpoint(str(tmp_path), create_train_state(model, cfg.training, 1), epoch=2)
    args = serve_tool.parse_args([CONFIG, str(tmp_path), "--mode", "whole", "--crop", "48", "64",
                                  "--device", "cpu", "--device-timeout", "60",
                                  "--set", *TINY, "tpu.attn_impl=int8"])
    service, epoch = serve_tool.build_service(args)
    try:
        assert epoch == 2 and service.mode == "whole" and service.crop == (48, 64)
        assert service.stride == (426, 426)  # the config's test: section
        impls = lambda tower: {m.attn_impl for m in tower.modules()
                               if isinstance(m, t_layers.MultiHeadAttention)}
        assert impls(service.inferencer.model.backbone) == {"int8"}
        assert impls(service.inferencer.model.text_encoder) == {"xla"}  # the ViT only
        torch.testing.assert_close(service.inferencer.model.state_dict(), model.state_dict())
        health = service.health()
        assert health["num_classes"] == 19 and health["with_depth"] is True
        res = service.predict_array(np.random.RandomState(1).randint(0, 256, FRAME + (3,),
                                                                     np.uint8))
        assert res["seg"].shape == res["depth"].shape == FRAME
        assert np.isfinite(res["depth"]).all()
    finally:
        service.close()
    with pytest.raises(SystemExit):
        serve_tool.parse_args([CONFIG])  # no checkpoint, no export
    with pytest.raises(NotImplementedError, match="exported"):
        serve_tool.build_service(serve_tool.parse_args(["--from-export", str(tmp_path)]))


# --------------------------------------------------------------------------
# the serving contract, with a stand-in inferencer (tests/test_serve.py)
# --------------------------------------------------------------------------


class _FakeInferencer:
    """Inferencer stand-in: optional gate (hang) / fail (raise) injection."""

    num_classes = 19
    with_depth = False

    def __init__(self, gate=None, fail=None):
        self.gate = gate
        self.fail = fail
        self.calls = 0
        self.last_aug = None

    def _run(self, img, aug):
        self.calls += 1
        self.last_aug = aug
        if self.fail is not None:
            raise self.fail
        if self.gate is not None:
            self.gate.wait()
        return {"seg": np.zeros((1,) + img.shape[1:3], np.int32)}

    def predict(self, img, **kw):
        return self._run(img, aug=False)

    def aug_test(self, img, **kw):
        return self._run(img, aug=True)


PNG8 = png.encode_png(np.random.RandomState(0).randint(0, 255, (8, 8, 3), np.uint8))


def _paeth_strip_png(h):
    """h one-pixel black rows, all Paeth-filtered: 4 h bytes inflated from a
    few hundred, and h anti-diagonal steps to undo."""
    head = png.encode_png(np.zeros((h, 1, 3), np.uint8))[:33]
    idat = zlib.compress(bytes([4, 0, 0, 0]) * h)
    return head + png._chunk(b"IDAT", idat) + png._chunk(b"IEND", b"")


def _wait_until(cond, what, limit=10.0):
    deadline = time.monotonic() + limit
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def test_device_timeout_returns_503_and_degrades_health():
    gate = threading.Event()
    svc = InferenceService(_FakeInferencer(gate=gate), mode="whole", device_timeout=0.3)
    try:
        h0 = svc.health()
        assert h0["status"] == "ok" and h0["last_success_age_s"] is None
        status, _, payload = svc.handle_predict(PNG8, {})
        assert status == 503 and b"deadline" in payload
        assert svc.stats.timeouts_total == 1 and svc.stats.errors_total == 1
        _wait_until(lambda: svc.health()["status"] == "degraded", "never degraded")
        h = svc.health()
        assert h["inflight_age_s"] > 0.3 and h["last_success_age_s"] is None
        assert h["timeouts_total"] == 1
        # while the timed-out call still runs, the next request fails fast
        t0 = time.monotonic()
        status, _, _ = svc.handle_predict(PNG8, {})
        assert status == 503 and time.monotonic() - t0 < 0.25
    finally:
        gate.set()  # always drain the worker
    _wait_until(lambda: svc.health()["inflight_age_s"] is None, "worker never drained")
    status, _, data = svc.handle_predict(PNG8, {})
    assert status == 200 and svc.health()["status"] == "ok"
    assert svc.health()["last_success_age_s"] is not None
    assert np.load(io.BytesIO(data))["seg"].shape == (8, 8)
    svc.close()


def test_abandoned_queued_call_never_dispatches():
    gate = threading.Event()
    fake = _FakeInferencer(gate=gate)
    svc = InferenceService(fake, mode="whole", device_timeout=2.0)
    try:
        a = threading.Thread(target=lambda: svc.handle_predict(PNG8, {}), daemon=True)
        a.start()  # A dispatches and holds the device lock on the gate
        _wait_until(lambda: fake.calls >= 1, "A never dispatched")
        t0 = time.monotonic()
        status, _, _ = svc.handle_predict(PNG8, {})  # B queues behind A, times out
        waited = time.monotonic() - t0
        assert status == 503
    finally:
        gate.set()
    a.join(timeout=30)
    _wait_until(lambda: svc.health()["inflight_age_s"] is None, "worker never drained")
    if waited >= 1.5:  # B waited in the queue (a loaded host may fail it fast instead)
        assert fake.calls == 1  # ... and never reached the device afterwards
    status, _, _ = svc.handle_predict(PNG8, {})
    assert status == 200 and fake.calls >= 2
    svc.close()


@pytest.mark.parametrize("query", [
    {"format": ["bmp"]}, {"mode": ["diagonal"]}, {"aug": ["maybe"]},
    {"format": ["png"], "target": ["sideways"]},
    {"format": ["png"], "target": ["depth"]},  # the stand-in has no depth head
])
def test_param_errors_cost_no_device_call(query):
    fake = _FakeInferencer()
    svc = InferenceService(fake, mode="whole")
    status, _, payload = svc.handle_predict(PNG8, query)
    assert status == 400 and b"error" in payload
    assert fake.calls == 0
    assert svc.stats.errors_total == svc.stats.requests_total == 1
    assert svc.stats.inference_seconds_total == 0.0


@pytest.mark.parametrize("body,max_pixels,message", [
    (PNG8, 16, b"exceeds"),  # the decoded-size cap (decompression bombs)
    (PNG8[:60], 64, b"cannot decode"),  # truncated
    (b"GIF89a....", 64, b"cannot decode"),
    (_paeth_strip_png(40000), 1 << 20, b"unfilter steps"),  # within the pixel cap
])
def test_undecodable_or_oversized_images_are_400(body, max_pixels, message):
    fake = _FakeInferencer()
    svc = InferenceService(fake, mode="whole", max_pixels=max_pixels)
    status, _, payload = svc.handle_predict(body, {})
    assert status == 400 and message in payload and fake.calls == 0


def test_other_formats_go_through_pillow_only_when_it_is_there(monkeypatch):
    buf = io.BytesIO()
    Image.fromarray(np.full((8, 8, 3), 7, np.uint8)).save(buf, format="BMP")
    fake = _FakeInferencer()
    svc = InferenceService(fake, mode="whole")
    status, _, _ = svc.handle_predict(buf.getvalue(), {})
    assert status == 200 and fake.calls == 1
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)  # Pillow not installed
    status, _, payload = svc.handle_predict(buf.getvalue(), {})
    assert status == 400 and b"Pillow" in payload and fake.calls == 1
    assert svc.handle_predict(PNG8, {})[0] == 200  # PNG needs no Pillow


@pytest.mark.parametrize("val,want_aug", [("no", False), ("FALSE", False), ("off", False),
                                          ("1", True), ("YES", True), ("on", True)])
def test_aug_flag_parsing_is_case_insensitive(val, want_aug):
    fake = _FakeInferencer()
    svc = InferenceService(fake, mode="whole")
    assert svc.handle_predict(PNG8, {"aug": [val]})[0] == 200
    assert fake.last_aug is want_aug


@pytest.mark.parametrize("fail,status,message", [
    (RuntimeError("boom"), 500, b"internal"),  # ours
    (ValueError("bad shape"), 400, b"bad shape"),  # the client's
])
def test_server_fault_is_500_client_fault_is_400(fail, status, message):
    svc = InferenceService(_FakeInferencer(fail=fail), mode="whole")
    got, _, payload = svc.handle_predict(PNG8, {})
    assert got == status and message in payload and svc.stats.errors_total == 1


def test_body_cap_and_malformed_content_length():
    svc = InferenceService(_FakeInferencer(), mode="whole")
    server = make_server(svc, "127.0.0.1", 0, max_body_bytes=1000)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        status, _, data = _request(port, "POST", "/v1/predict", b"x" * 2000)
        assert status == 413 and b"limit" in data
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(b"POST /v1/predict HTTP/1.1\r\nHost: t\r\nContent-Length: banana\r\n\r\n")
            first = s.recv(4096).split(b"\r\n", 1)[0]
        assert b"400" in first
    finally:
        server.shutdown()
        server.server_close()


# --------------------------------------------------------------------------
# utils/png.py and utils/visualize.py
# --------------------------------------------------------------------------


def _gradient_image(h=37, w=53, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 5) % 256, (yy * 7) % 256, ((xx + yy) * 3) % 256], -1)
    return (base + np.random.RandomState(seed).randint(0, 8, base.shape)).astype(np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_decode_matches_pillow(mode):
    img = Image.fromarray(_gradient_image())
    img = img.quantize(256) if mode == "P" else img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    data = buf.getvalue()
    assert png.read_header(data).bit_depth == 8
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(png.decode_png(data), want)


def _filtered_png(img, ftypes):
    """An RGB PNG whose rows carry the given filter types (per the PNG spec)."""
    h, w, _ = img.shape
    x = img.astype(np.int64).reshape(h, w * 3)
    rows = []
    for r in range(h):
        prev = x[r - 1] if r else np.zeros(w * 3, np.int64)
        left = np.concatenate([np.zeros(3, np.int64), x[r, :-3]])
        ul = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        p = left + prev - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        pred = [0, left, prev, (left + prev) // 2, paeth][ftypes[r]]
        rows.append(np.concatenate([[ftypes[r]], (x[r] - pred) % 256]).astype(np.uint8))
    raw = zlib.compress(np.stack(rows).tobytes())
    plain = png.encode_png(img)
    head = plain[:33]  # signature + IHDR
    return head + png._chunk(b"IDAT", raw) + png._chunk(b"IEND", b"")


@pytest.mark.parametrize("ftypes,shape", [
    ("0", (11, 13)), ("1", (11, 13)), ("2", (11, 13)), ("3", (11, 13)), ("4", (11, 13)),
    ("01234", (11, 13)), ("4103", (11, 13)),
    ("3402", (23, 5)), ("42", (1, 9)), ("43", (9, 1)),  # taller than wide, one row, one column
])
def test_png_decode_undoes_every_row_filter(ftypes, shape):
    img = _gradient_image(*shape, seed=int(ftypes))
    per_row = [int(ftypes[r % len(ftypes)]) for r in range(img.shape[0])]
    data = _filtered_png(img, per_row)
    np.testing.assert_array_equal(png.decode_png(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), img)


@pytest.mark.parametrize("image", ["rgb", "gray"])
def test_png_encode_round_trips_through_pillow(image):
    img = _gradient_image()
    if image == "gray":
        img = img[..., 0]
    data = png.encode_png(img)
    back = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(back, img)
    want = img if image == "rgb" else np.repeat(img[..., None], 3, axis=-1)
    np.testing.assert_array_equal(png.decode_png(data), want)


def _ihdr_png(depth=8, ctype=2, interlace=0):
    ihdr = np.array([0, 0, 0, 4, 0, 0, 0, 4], np.uint8).tobytes() + bytes(
        [depth, ctype, 0, 0, interlace])
    return png.SIGNATURE + png._chunk(b"IHDR", ihdr) + png._chunk(b"IEND", b"")


@pytest.mark.parametrize("data,match", [
    (b"\xff\xd8\xff\xe0 a jpeg", "not a PNG"),
    (_ihdr_png(depth=16), "unsupported"),
    (_ihdr_png(interlace=1), "unsupported"),
    (_ihdr_png(ctype=3), "palette"),
    (PNG8[:-20], "truncated"),
    (PNG8[:40] + bytes([PNG8[40] ^ 1]) + PNG8[41:], "CRC"),
    (_paeth_strip_png(40000), "unfilter steps"),
])
def test_png_decode_rejects(data, match):
    with pytest.raises(ValueError, match=match):
        png.decode_png(data)


def test_colorizers_match_jax():
    rs = np.random.RandomState(0)
    depth = (rs.rand(40, 60) * 100 - 10).astype(np.float32)
    depth[0, :6] = [0.0, np.nan, 80.0, 80.0001, -1.0, 79.99]
    for max_depth in (80.0, 37.5):
        np.testing.assert_array_equal(colorize_depth(depth, max_depth),
                                      j_visualize.colorize_depth(depth, max_depth))
    seg = rs.randint(-2, 260, (30, 40))
    seg[0, 0] = 255
    np.testing.assert_array_equal(colorize_seg(seg), j_visualize.colorize_seg(seg))
