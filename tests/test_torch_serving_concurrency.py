"""The port's `tools/exp_serving_concurrency.py` on the CPU: K HTTP clients
against the real serving stack of a tiny seeded model (a config written here,
on the flagship preset through `_base_`), one JSON line per client count with
the JAX tool's keys; occupancy is the lock-held share of wall time."""

import json
from pathlib import Path

import numpy as np
import pytest

from denseclip_vit_multimodal_tpu_torch.tools import exp_serving_concurrency as tool
from denseclip_vit_multimodal_tpu_torch.utils.png import decode_png

ROOT = Path(__file__).resolve().parents[1]

KEYS = {"clients", "images", "wall_s", "images_per_sec", "device_occupancy_pct"}
TINY_MODEL = {
    "backbone": {"width": 128, "layers": 2, "heads": 2, "out_indices": [0, 1]},
    "text_encoder": {"transformer_layers": 1, "transformer_width": 64, "transformer_heads": 2},
    "token_embed_dim": 64,
    "neck": {"inter_channels": 16, "out_channels": 32},
    "decode_head": {"in_channels": 32, "channels": 32},
    "depth_head": {"in_channels": 32, "channels": 16},
}


@pytest.fixture
def tiny_config(tmp_path):
    path = tmp_path / "tiny.yaml"
    base = ROOT / "configs" / "denseclip_vitb16_cityscapes_multitask.yaml"
    path.write_text(json.dumps({"_base_": str(base), "model": TINY_MODEL}))  # JSON is YAML
    return str(path)


@pytest.mark.parametrize("mode", ["slide", "whole"])
def test_one_json_line_per_client_count(tiny_config, capsys, mode):
    lines = tool.main(["--config", tiny_config, "--clients", "1", "2", "--requests", "2",
                       "--size", "64", "128", "--mode", mode, "--device", "cpu"])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == lines and [ln["clients"] for ln in lines] == [1, 2]
    for line in lines:
        assert set(line) == KEYS
        assert line["images"] == 2 * line["clients"]
        assert line["images_per_sec"] == pytest.approx(line["images"] / line["wall_s"])
        # single flight: the lock is held at most for the whole wall time
        assert 0 < line["device_occupancy_pct"] <= 100


def test_png_frame_is_the_seeded_frame():
    frame = decode_png(tool.png_frame(16, 24, seed=3))
    want = np.random.RandomState(3).randint(0, 255, (16, 24, 3), np.uint8)
    np.testing.assert_array_equal(frame, want)
