"""Import hygiene of the PyTorch port: no JAX, no Flax, nothing of the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "denseclip_vit_multimodal_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "denseclip_vit_multimodal_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_import_leaves_jax_out_of_sys_modules():
    """`import` of the package and every submodule, in a fresh interpreter
    (this test process already holds jax), adds no JAX module."""
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import denseclip_vit_multimodal_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "added = set(sys.modules) - before\n"
        "bad = sorted(m for m in added if m.split('.')[0] in {'jax', 'jaxlib', 'flax', 'optax'}\n"
        "             or m.split('.')[0] == 'denseclip_vit_multimodal_tpu')\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules\n"
        "print('ok', len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_no_forbidden_import_in_source(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"


def test_serving_png_needs_no_pillow_or_matplotlib():
    """The port's server answers PNG in every format (npz, json, seg and
    depth panels) with neither Pillow nor matplotlib imported."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from denseclip_vit_multimodal_tpu_torch.infer.server import InferenceService\n"
        "from denseclip_vit_multimodal_tpu_torch.utils import png\n"
        "class Fake:\n"
        "    num_classes, with_depth = 19, True\n"
        "    def predict(self, img, **kw):\n"
        "        h, w = img.shape[1:3]\n"
        "        return {'seg': np.ones((1, h, w), np.int32),\n"
        "                'depth': np.full((1, h, w), 7.0, np.float32)}\n"
        "svc = InferenceService(Fake(), mode='whole')\n"
        "body = png.encode_png(np.zeros((8, 8, 3), np.uint8))\n"
        "for q in ({}, {'format': ['json']}, {'format': ['png']},\n"
        "          {'format': ['png'], 'target': ['depth']}):\n"
        "    assert svc.handle_predict(body, q)[0] == 200, q\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in {'PIL', 'matplotlib'})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_imports_no_jax():
    roots = {n.split(".")[0] for n in _imported_roots(ROOT / "chip_smoke.py")}
    assert not roots & set(FORBIDDEN), roots


def test_every_kernel_source_is_built():
    """`build_all` compiles every CUDA source of the port (K1, K2 with K3's
    backward, K4, K5, K3, K6, K4b, K7), and every name it builds has a
    source; nothing is built on import."""
    from denseclip_vit_multimodal_tpu_torch.ops import _build

    sources = {p.stem for p in (PKG / "csrc").glob("*.cu")}
    assert set(_build.SOURCES) == sources
    assert {"mha_attention", "ln_qkv_attention", "flash_attention_bwd",
            "qkv_out_attention"} <= sources
    assert not _build._LIBS


@pytest.mark.parametrize("module", ["ops.lnqkv_kernel", "tools.selftest",
                                    "tools.exp_outproj_epilogue", "tools.profile_attn_bwd",
                                    "tools.time_fwd_trees", "utils.benchtime", "ops.attention",
                                    "models.layers", "data.cityscapes", "data._native",
                                    "train.clip_import", "train.weights",
                                    "tools.import_checkpoint", "tools.infer",
                                    "utils.visualize", "ops._library", "infer.outputs",
                                    "infer.exported", "tools.export",
                                    "tools.exp_serving_concurrency", "parallel.mesh"])
def test_new_modules_import_without_jax_or_a_gpu(module):
    """The kernel wrappers (K6; K4b; K7 in its experiment tool), the kernel
    tools, the timing helpers, the remat-aware layers, the Cityscapes readers
    with their host ops, the CLIP import, the checkpoint import tool, the
    kernel ops' registration, the export and its loader, the concurrency
    tool and the mesh check import on a machine with neither JAX nor a card
    (nothing is compiled or built at import)."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('denseclip_vit_multimodal_tpu_torch.{module}')\n"
        "assert not any(m.split('.')[0] in {'jax', 'jaxlib', 'flax'} for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_panels_and_evaluation_outputs_need_no_pillow_or_matplotlib():
    """The validation panels, `tools/test.py`'s outputs and `tools/infer.py`'s
    PNGs are drawn and encoded with Pillow and matplotlib unimportable (the
    card has neither)."""
    code = (
        "import sys, tempfile, os\n"
        "sys.modules['PIL'] = sys.modules['matplotlib'] = None  # any import of them fails\n"
        "import numpy as np\n"
        "from denseclip_vit_multimodal_tpu_torch.tools import infer, test\n"
        "from denseclip_vit_multimodal_tpu_torch.train import loop\n"
        "from denseclip_vit_multimodal_tpu_torch.utils import visualize as v\n"
        "from denseclip_vit_multimodal_tpu_torch.data.cityscapes import labelids_from_trainids\n"
        "from denseclip_vit_multimodal_tpu_torch.utils.png import encode_png\n"
        "d = tempfile.mkdtemp()\n"
        "rs = np.random.RandomState(0)\n"
        "img, seg = rs.randint(0, 256, (8, 12, 3), dtype=np.uint8), rs.randint(0, 19, (8, 12))\n"
        "v.save_multi_task_panel(os.path.join(d, 'a.png'), img, seg, seg_gt=seg,\n"
        "                        depth_pred=rs.rand(8, 12) * 80, depth_gt=rs.rand(8, 12) * 80)\n"
        "v.save_comparison_panel(os.path.join(d, 'b.png'), img, seg, seg, epoch=1)\n"
        "encode_png(labelids_from_trainids(seg))\n"
        "encode_png(v.colorize_depth(rs.rand(8, 12) * 80))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in {'PIL', 'matplotlib'}\n"
        "             and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")
