"""The port's serving export (`tools/export.py`, `infer/exported.py`, `tools/serve.py
--from-export`) and its kernel ops (`ops/_library.py`) against the JAX package's.

A tiny flagship model carries the same weights in both packages (Flax
variables from `init`, BatchNorm statistics drawn with numpy, carried into the
port by `convert.load_flax_variables`); each package exports it with its own
`tools/export.py` from its own checkpoint, and both programs answer the same
seeded uint8 frame.  fp32 end to end: the same arithmetic summed in another
order (tests/torch_parity.py's limits); argmax compared where the top two
logits are further apart than 1e-4; float16 depth within one float16 step
beyond the two packages' fp32 depths' own difference.

The kernel routes are exported with `ops/attention.py::_on_cuda` patched to
true, as the dispatch tests do: the ViT then calls the kernels' ops, whose
CPU implementations (the plain versions) run the bundle here.
"""

import io
import json
import os
import shutil
import subprocess
import sys
import threading
from http.client import HTTPConnection
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from denseclip_vit_multimodal_tpu.infer.exported import ExportedInferencer as JExportedInferencer
from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.train import checkpoint as j_ckpt
from denseclip_vit_multimodal_tpu.train.state import create_train_state as j_train_state
from denseclip_vit_multimodal_tpu_torch.convert import load_flax_variables
from denseclip_vit_multimodal_tpu_torch.core.config import load_config
from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
from denseclip_vit_multimodal_tpu_torch.infer.exported import ExportedInferencer
from denseclip_vit_multimodal_tpu_torch.infer.server import make_server
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.ops import attention as t_attention
from denseclip_vit_multimodal_tpu_torch.ops import lnqkv_kernel as t_lnqkv
from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as t_mha
from denseclip_vit_multimodal_tpu_torch.tools import export as t_export
from denseclip_vit_multimodal_tpu_torch.tools import serve as t_serve
from denseclip_vit_multimodal_tpu_torch.train.checkpoint import load_model_weights, save_checkpoint
from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state
from denseclip_vit_multimodal_tpu_torch.utils import png
from torch_parity import assert_parity

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import export as j_export  # noqa: E402  (the JAX package's tools/export.py)

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
CROP, STRIDE, WINDOW_BATCH = (48, 64), (32, 48), 4  # slide: 2 x 3 windows in 2 chunks
PROTOCOL = ["--shape", *map(str, FRAME), "--crop", *map(str, CROP), "--stride",
            *map(str, STRIDE), "--window-batch", str(WINDOW_BATCH)]
GAP = 1e-4  # argmax compared where the top two logits are further apart
META_KEYS = {"input_shape", "mode", "crop", "stride", "window_batch", "num_outputs",
             "class_names", "weight_keys", "fetch", "with_depth", "depth_max", "model_name"}


def _frame(seed, batch=1):
    return np.random.RandomState(seed).randint(0, 256, (batch,) + FRAME + (3,), dtype=np.uint8)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """One tiny model's weights, saved as a JAX and as a port checkpoint."""
    root = tmp_path_factory.mktemp("export")
    cfg = load_config(CONFIG, overrides=TINY)
    jm, texts = j_build(cfg.model, CITYSCAPES_CLASSES)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(7), jnp.zeros((1,) + FRAME + (3,)),
                                 jnp.asarray(texts))
    rs = np.random.RandomState(3)
    variables = {  # running statistics away from the identity
        "params": jax.tree.map(np.asarray, variables["params"]),
        "batch_stats": jax.tree.map(lambda a: (rs.rand(*a.shape) + 0.5).astype(np.float32),
                                    variables["batch_stats"]),
    }
    j_ckpt.save_checkpoint(str(root / "jax_work"), j_train_state(jm, variables, cfg.training, 1),
                           0, 0.0)
    tm, _ = t_build(cfg.model, CITYSCAPES_CLASSES, device="cpu")
    load_flax_variables(tm, variables)
    save_checkpoint(str(root / "work"), create_train_state(tm, cfg.training, 1), epoch=0)
    return {"root": root, "model": tm, "texts": texts, "cfg": cfg,
            "jax": str(root / "jax_work"), "port": str(root / "work")}


@pytest.fixture(scope="module")
def bundles(work):
    """(package, mode, fetch) -> export dir, each exported once."""
    made = {}

    def get(package, mode, fetch, extra=()):
        key = (package, mode, fetch, tuple(extra))
        if key not in made:
            out = str(work["root"] / "_".join((package, mode, fetch, *extra)).replace("=", "-"))
            argv = [CONFIG, work[package], out, *PROTOCOL, "--mode", mode, "--fetch", fetch]
            if package == "jax":
                j_export.main([*argv, "--set", *TINY, *extra])
            else:
                t_export.main([*argv, "--device", "cpu", "--set", *TINY, *extra])
            made[key] = out
        return made[key]

    return get


def _predict(infer, mode, fetch, img):
    return infer.predict(img, mode=mode, crop=CROP, stride=STRIDE, fetch=fetch)


def test_bundle_holds_program_and_jax_meta(bundles, work):
    out = bundles("port", "slide", "logits")
    assert sorted(os.listdir(out)) == ["meta.json", "program.pt2"]
    meta = json.load(open(os.path.join(out, "meta.json")))
    jmeta = json.load(open(os.path.join(bundles("jax", "slide", "logits"), "meta.json")))
    assert META_KEYS <= set(meta) and META_KEYS <= set(jmeta)
    for key in META_KEYS - {"weight_keys"}:
        assert meta[key] == jmeta[key], key
    assert meta["device"] == "cpu" and meta["ops"] == {}  # no kernel off CUDA
    state = torch.export.load(os.path.join(out, "program.pt2")).state_dict
    assert meta["weight_keys"] == list(state)
    assert set(work["model"].state_dict()) <= {k.removeprefix("model.") for k in state}


@pytest.mark.parametrize("fetch", ["logits", "argmax", "packed"])
@pytest.mark.parametrize("mode", ["whole", "slide"])
def test_exported_program_matches_jax_exported_program(bundles, mode, fetch):
    """The port's program against JAX's on the same weights and frame."""
    img = _frame(11)
    got = _predict(ExportedInferencer(bundles("port", mode, fetch), device="cpu"), mode,
                   fetch, img)
    want = _predict(JExportedInferencer(bundles("jax", mode, fetch)), mode, fetch, img)
    assert set(got) == set(want)
    # the fp32 canvases that decide where an argmax may differ and how far
    # two float16 roundings may lie apart
    canvas = _predict(JExportedInferencer(bundles("jax", mode, "logits")), mode, "logits", img)
    port_depth = _predict(ExportedInferencer(bundles("port", mode, "logits"), device="cpu"),
                          mode, "logits", img)["depth"]
    logits = np.asarray(canvas["seg_logits"])
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > GAP
    assert decided.mean() > 0.9  # the comparison covers most pixels
    for key in got:
        a, b = np.asarray(want[key]), got[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if key == "seg":
            np.testing.assert_array_equal(b[decided], a[decided])
        elif b.dtype == np.float16:
            # packed depth: the float16 rounding of the port's fp32 depth, and
            # within one float16 step of JAX's beyond the fp32 depths' own
            # difference (near 0 a float16 step is smaller than that)
            np.testing.assert_array_equal(b, port_depth.astype(np.float16))
            step = np.spacing(np.maximum(np.abs(a), np.abs(b))).astype(np.float32)
            apart = np.abs(np.asarray(canvas["depth"]) - port_depth)
            assert (np.abs(a.astype(np.float32) - b.astype(np.float32)) <= step + apart).all()
        else:
            assert_parity(a, torch.from_numpy(b), what=f"{mode} {fetch} {key}")


@pytest.mark.parametrize("mode", ["whole", "slide"])
def test_exported_inferencer_matches_live_and_refuses_as_jax(bundles, work, mode):
    exported = ExportedInferencer(bundles("port", mode, "logits"), device="cpu")
    assert exported.num_classes == 19 and exported.with_depth is True
    assert exported.mode == mode and exported.input_shape == (1,) + FRAME + (3,)
    assert (exported.crop, exported.stride, exported.window_batch) == (CROP, STRIDE, WINDOW_BATCH)
    assert exported.export_fetch == "logits" and exported.model_name == os.path.basename(CONFIG)
    img = _frame(3)
    live = Inferencer(work["model"], work["texts"],
                      augment_config_from_data_cfg(work["cfg"].data, train=False), num_classes=19)
    for fetch in ("logits", "argmax", "packed"):
        got = _predict(exported, mode, fetch, img)
        want = live.predict(img, mode=mode, crop=CROP, stride=STRIDE, window_batch=WINDOW_BATCH,
                            fetch=fetch)
        assert set(got) == set(want)
        for key in got:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_allclose(got[key].astype(np.float32),
                                       want[key].astype(np.float32), rtol=0, atol=1e-5)

    # JAX's refusals, with its messages: the specialisation is enforced
    with pytest.raises(ValueError, match=r"specialized to input \(1, 64, 128, 3\), got"):
        exported.predict(img[:, :32], mode=mode, crop=CROP, stride=STRIDE)
    with pytest.raises(ValueError, match="takes uint8 frames, got float32"):
        exported.predict(img.astype(np.float32) / 255.0, mode=mode, crop=CROP, stride=STRIDE)
    other = "whole" if mode == "slide" else "slide"
    with pytest.raises(ValueError, match=f"runs mode='{mode}', got '{other}'"):
        exported.predict(img, mode=other, crop=CROP, stride=STRIDE)
    if mode == "slide":
        with pytest.raises(ValueError, match=r"slide protocol is crop=\(48, 64\) stride=\(32, 48\)"):
            exported.predict(img, mode=mode, crop=(64, 64), stride=STRIDE)
        with pytest.raises(ValueError, match="slide protocol"):
            exported.predict(img, mode=mode, crop=CROP, stride=(16, 16))
    with pytest.raises(ValueError, match="aug_test is not part of this export"):
        exported.aug_test(img)
    packed = ExportedInferencer(bundles("port", mode, "packed"), device="cpu")
    with pytest.raises(ValueError, match="baked with fetch='packed'; re-export with --fetch argmax"):
        _predict(packed, mode, "argmax", img)


# (attn_impl and compute dtype, DENSECLIP_FUSED_LNQKV, the ops a layer calls per window chunk)
KERNEL_ROUTES = {
    "k1_flash": (["tpu.attn_impl=flash", "tpu.compute_dtype=bfloat16"], "0",
                 ["qkv_attention"]),
    "k5_int8": (["tpu.attn_impl=int8"], "0", ["quantize_qkv_int8", "qkv_attention_int8"]),
    "k6_fused": (["tpu.attn_impl=flash"], "1", ["ln_qkv_attention"]),
}


@pytest.mark.parametrize("route", sorted(KERNEL_ROUTES))
def test_exported_graph_holds_the_kernel_ops(bundles, work, monkeypatch, route):
    """On "CUDA" (the patch) each ViT layer calls its kernel's op once per
    window chunk, and the traced graph keeps those nodes: 2 layers x 2
    chunks.  The bundle then runs the ops' CPU implementations, as the live
    path does on the same weights."""
    sets, fused, ops = KERNEL_ROUTES[route]
    monkeypatch.setattr(t_attention, "_on_cuda", lambda x: True)
    monkeypatch.setenv("DENSECLIP_FUSED_LNQKV", fused)
    out = bundles("port", "slide", "logits", sets)
    want_ops = {f"denseclip_torch::{op}": 2 * 2 for op in ops}
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta["ops"] == want_ops
    assert meta["env"]["DENSECLIP_FUSED_LNQKV"] == fused
    # the exp mode each op carries, as traced (the knobs unset): K5's ops carry none
    assert meta["exp_modes"] == {f"denseclip_torch::{op}": [0] for op in ops
                                 if op in ("qkv_attention", "ln_qkv_attention")}
    assert t_export.kernel_ops(torch.export.load(os.path.join(out, "program.pt2")).graph) == want_ops

    cfg = load_config(CONFIG, overrides=TINY + sets)
    dtype = torch.bfloat16 if "tpu.compute_dtype=bfloat16" in sets else torch.float32
    model, texts = t_build(cfg.model, CITYSCAPES_CLASSES, dtype=dtype,
                           attn_impl=cfg.tpu.attn_impl, device="cpu")
    load_model_weights(work["port"], model)
    img = _frame(5)
    live = Inferencer(model, texts, augment_config_from_data_cfg(cfg.data, train=False),
                      num_classes=19).predict(img, mode="slide", crop=CROP, stride=STRIDE,
                                              window_batch=WINDOW_BATCH, fetch="logits")
    got = _predict(ExportedInferencer(out, device="cpu"), "slide", "logits", img)
    for key in got:
        np.testing.assert_array_equal(got[key], live[key])


def _op_cases():
    """(wrapper call, op overloads it reaches, op call, plain version) per op."""
    rs = np.random.RandomState(0)
    qkv = torch.from_numpy(rs.randn(2, 40, 3 * 128).astype(np.float32))
    q, k, v = (t.view(2, 40, 2, 64) for t in qkv.split(128, dim=-1))
    scale = 64**-0.5
    q8, vt, scales = t_mha.QUANTIZE_QKV_INT8_OP(qkv, 2, 33)
    q8_plain, scales_plain = t_mha.quantize_qkv_int8(qkv, 2, 33)
    x = torch.from_numpy(rs.randn(2, 40, 128).astype(np.float32))
    ln = [torch.from_numpy(a.astype(np.float32)) for a in
          (1 + 0.1 * rs.randn(128), 0.1 * rs.randn(128), 0.1 * rs.randn(128, 384), rs.randn(384))]
    return {
        "qkv_attention": (lambda: t_mha.mha_qkv_attention(qkv, 2, valid_len=33),
                          [t_mha.QKV_ATTENTION_OP], (t_mha.QKV_ATTENTION_OP, (qkv, 2, scale, 33)),
                          lambda: t_mha.mha_qkv_attention_reference(qkv, 2, valid_len=33)),
        "mha_attention": (lambda: t_mha.mha_attention(q, k, v, valid_len=33),
                          [t_mha.MHA_ATTENTION_OP], (t_mha.MHA_ATTENTION_OP, (q, k, v, scale, 33)),
                          lambda: t_mha.mha_attention_reference(q, k, v, valid_len=33)),
        "flash_attention": (lambda: t_attention.flash_attention(q, k, v, causal=True, valid_len=33),
                            [t_attention.FLASH_ATTENTION_OP],
                            (t_attention.FLASH_ATTENTION_OP, (q, k, v, True, scale, 33)),
                            lambda: t_attention.flash_attention_reference(q, k, v, causal=True,
                                                                          valid_len=33)),
        "quantize_qkv_int8": (lambda: t_mha.mha_qkv_attention_int8(qkv, 2, valid_len=33),
                              [t_mha.QUANTIZE_QKV_INT8_OP, t_mha.QKV_ATTENTION_INT8_OP],
                              (t_mha.QUANTIZE_QKV_INT8_OP, (qkv, 2, 33)),
                              lambda: (q8_plain, t_mha.value_key_major(q8_plain, 2),
                                       scales_plain)),
        "qkv_attention_int8": (lambda: t_mha.mha_qkv_attention_int8(qkv, 2, valid_len=33),
                               [t_mha.QUANTIZE_QKV_INT8_OP, t_mha.QKV_ATTENTION_INT8_OP],
                               (t_mha.QKV_ATTENTION_INT8_OP,
                                (q8, vt, scales, 2, scale, 33, torch.float32)),
                               lambda: t_mha.int8_attention_plain(q8, scales, 2, scale, 33,
                                                                  torch.float32)),
        "ln_qkv_attention": (lambda: t_lnqkv.ln_qkv_attention(x, *ln, 2, valid_len=33),
                             [t_lnqkv.LN_QKV_ATTENTION_OP],
                             (t_lnqkv.LN_QKV_ATTENTION_OP, (x, *ln, 2, scale, 1e-5, 33)),
                             lambda: t_lnqkv.ln_qkv_attention_reference(x, *ln, 2, valid_len=33)),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_kernel_op_passes_opcheck_and_its_cpu_version_is_the_plain_one(name):
    wrapper, reached, (op, args), plain = _op_cases()[name]
    assert op.name() == f"denseclip_torch::{name}"
    assert set(torch.library.opcheck(op, args).values()) == {"SUCCESS"}
    got, want = op(*args), plain()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the wrapper reaches the op on the CPU too: its trace holds each op once
    graph = make_fx(lambda: wrapper())().graph
    targets = [n.target for n in graph.nodes if n.op == "call_function"]
    assert all(targets.count(o) == 1 for o in reached), targets


def test_fresh_process_loads_a_cpu_bundle_without_model_code(bundles):
    out = bundles("port", "slide", "packed")
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from denseclip_vit_multimodal_tpu_torch.infer.exported import ExportedInferencer\n"
        f"infer = ExportedInferencer({out!r}, device='cpu')\n"
        f"img = np.random.RandomState(2).randint(0, 256, (1, 64, 128, 3), dtype=np.uint8)\n"
        f"res = infer.predict(img, mode='slide', crop={CROP}, stride={STRIDE}, fetch='packed')\n"
        "pkg = 'denseclip_vit_multimodal_tpu_torch.'\n"
        "bad = [m for m in ('models', 'models.vit', 'models.denseclip', 'core.config')\n"
        "       if pkg + m in sys.modules]\n"
        "assert not bad, bad\n"
        "print(json.dumps({'seg': res['seg'].tolist(), 'depth': res['depth'].tolist()}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = json.loads(proc.stdout.splitlines()[-1])
    want = _predict(ExportedInferencer(out, device="cpu"), "slide", "packed", _frame(2))
    np.testing.assert_array_equal(np.asarray(got["seg"], np.uint8), want["seg"])
    np.testing.assert_array_equal(np.asarray(got["depth"], np.float16), want["depth"])


def test_bundle_runs_only_on_its_own_device(bundles, tmp_path):
    """A CUDA bundle is never run on the CPU, nor a CPU bundle on CUDA: both
    raise before anything is loaded."""
    cpu = bundles("port", "whole", "logits")
    with pytest.raises(ValueError, match=r"exported on cpu and runs there, got device='cuda'"):
        ExportedInferencer(cpu)  # the default device is cuda
    cuda = str(tmp_path / "cuda_bundle")
    shutil.copytree(cpu, cuda)
    meta = json.load(open(os.path.join(cuda, "meta.json")))
    json.dump({**meta, "device": "cuda"}, open(os.path.join(cuda, "meta.json"), "w"))
    with pytest.raises(ValueError, match=r"exported on cuda and runs there, got device='cpu'"):
        ExportedInferencer(cuda, device="cpu")


@pytest.mark.parametrize("fetch,line", [
    ("logits", "self-test OK: seg logits (1, 64, 128, 20) fetch=logits"),
    ("packed", "self-test OK: seg argmax (1, 64, 128) fetch=packed"),
])
def test_selftest_cli_prints_jaxs_line(bundles, capsys, fetch, line):
    out, jax_out = bundles("port", "whole", fetch), bundles("jax", "whole", fetch)
    capsys.readouterr()  # the exports' own lines
    assert t_export.main(["--load", out, "--selftest", "--device", "cpu"]) is None
    assert capsys.readouterr().out.strip() == line
    j_export.main(["--load", jax_out, "--selftest"])
    assert capsys.readouterr().out.strip() == line


def test_serve_from_export_socket_parity(bundles):
    """export -> serve --from-export -> npz over a real socket equals
    `ExportedInferencer.predict` of the decoded frame."""
    out = bundles("port", "slide", "packed")
    service, epoch = t_serve.build_service(t_serve.parse_args(
        ["--from-export", out, "--device", "cpu", "--fetch", "packed"]))
    assert epoch is None
    assert (service.mode, service.crop, service.stride) == ("slide", CROP, STRIDE)
    assert service.window_batch == WINDOW_BATCH and service.model_name == os.path.basename(CONFIG)
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    img = _frame(13)[0]
    try:
        conn = HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)
        conn.request("POST", "/v1/predict", body=png.encode_png(img),
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        assert resp.status == 200, data
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        service.close()
    got = np.load(io.BytesIO(data))
    want = _predict(service.inferencer, "slide", "packed", img[None])
    assert got["seg"].dtype == np.uint8 and got["depth"].dtype == np.float16
    np.testing.assert_array_equal(got["seg"], want["seg"][0])
    np.testing.assert_array_equal(got["depth"], want["depth"][0])


@pytest.mark.parametrize("flags,message", [
    (["--crop", "64", "64"], r"--crop \(64, 64\) conflicts with the export's crop=\(48, 64\)"),
    (["--stride", "16", "16"], r"--stride \(16, 16\) conflicts with the export's stride"),
    (["--mode", "whole"], "--mode whole conflicts with the export's mode='slide'"),
    (["--window-batch", "7"], "--window-batch 7 conflicts with the export's window_batch=4"),
    (["--aug-test"], "--aug-test cannot be served from an export"),
    (["--fetch", "argmax"], "export was baked with fetch='packed'; serve with --fetch packed"),
])
def test_serve_from_export_conflicts_exit_as_jax(bundles, flags, message):
    out = bundles("port", "slide", "packed")
    args = t_serve.parse_args(["--from-export", out, "--device", "cpu", "--fetch", "packed",
                               *flags])
    with pytest.raises(SystemExit, match=message):
        t_serve.build_service(args)
