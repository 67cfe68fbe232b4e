"""The port over a process group of 2 spawned Gloo ranks on the CPU, against
its own one process (`tests/torch_ddp.py`; JAX's step is held in
`tests/test_torch_ddp_step.py`):

  * two train steps with augmentation, colour jitter, dropout and drop path
    on: every parameter and BatchNorm statistic of both ranks within 1e-6
    rel. L2 of the one-process run on the same global batches;
  * NaN in a sample of rank 1: both ranks skip, parameters and BatchNorm
    buffers unchanged, `step` advanced, no update counted;
  * a slide frame with its windows spread over the ranks (15 windows: 8 and
    7) against the unsharded frame, within 1e-6 rel. L2 in fp32;
  * `tools/test.py` on 5 frames at 2 ranks: the summed confusion matrix
    equals the one-process matrix with JAX's duplicate counting (the tail
    wraps: frame 0 is scored twice);
  * `train/loop.py::train` at 2 ranks with validation, then resumed: every
    checkpoint save sees the same state on both ranks, the resumed state
    is the file's, and the per-process logs are JAX's.
"""

import copy
import os

import numpy as np
import pytest
import torch

import torch_ddp
from test_torch_ddp_step import VIT
from test_torch_train_loop import PRESET, TINY
from denseclip_vit_multimodal_tpu_torch.core.config import load_config
from denseclip_vit_multimodal_tpu_torch.train import checkpoint
from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state

STEP_TOL = 1e-6
SLIDE_TOL = 1e-6
# the text tower runs in evaluation: the full vocabulary
EVAL = [o for o in TINY if "vocab_size" not in o] + ["data.synthetic_options.length=5"]


def _rel(a, b):
    return float((a.double() - b.double()).norm() / max(float(b.double().norm()), 1e-30))


def _batches(n_batches, seed, nan_row=None):
    """Global batches of 4; `nan_row`: a NaN pixel in that row's image (a
    float image: the augmentation takes any dtype; a NaN depth would only
    leave the depth mask)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        b = {"image": rs.randint(0, 256, (4, 96, 160, 3)).astype(np.uint8),
             "seg": rs.randint(0, 19, (4, 96, 160)).astype(np.int32),
             "depth": rs.uniform(1.0, 80.0, (4, 96, 160)).astype(np.float32)}
        if nan_row is not None:
            b["image"] = b["image"].astype(np.float32)
            b["image"][nan_row, 5, 7] = np.nan
        out.append(b)
    return out


def _payloads(tmp):
    cfg = copy.deepcopy(VIT)
    cfg["backbone"]["drop_path_rate"] = 0.1
    cfg["decode_head"]["dropout_ratio"] = 0.1
    cfg["depth_head"]["dropout_ratio"] = 0.1
    model, _ = torch_ddp._model(cfg, seed=1)
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    state_dict["depth_head.classifier.bias"].fill_(10.0)  # off SILog's eps clamp
    common = {"cfg": cfg, "state_dict": state_dict, "frozen": ["text_encoder"], "accum": 1,
              "training": {"optimizer": {"type": "SGD", "lr": 0.01, "momentum": 0.9,
                                         "weight_decay": 1e-4}}}
    aug = {"crop_size": (64, 128), "brightness": 0.4, "contrast": 0.4, "saturation": 0.4,
           "hue": 0.1, "color_jitter_prob": 0.8}
    frame = np.random.RandomState(2).randint(0, 256, (1, 128, 200, 3)).astype(np.uint8)

    eval_cfg = load_config(PRESET, overrides=EVAL)
    eval_model, _ = torch_ddp._model(eval_cfg.model, seed=4)
    ckpt_dir = os.path.join(tmp, "eval")
    checkpoint.save_checkpoint(ckpt_dir, create_train_state(eval_model, eval_cfg.training, 1), 0)
    argv = [PRESET, ckpt_dir, "--device", "cpu", "--set", *EVAL]
    return {
        "steps": {"task": "train_steps", **common, "aug": aug, "batches": _batches(2, 5),
                  "seed": 7},
        "nan": {"task": "train_steps", **common, "aug": aug, "batches": _batches(1, 6, 3)},
        "slide": {"task": "slide_frame", "cfg": cfg, "state_dict": state_dict, "frame": frame,
                  "crop": (64, 64), "stride": (43, 43), "window_batch": 3},
        "eval": {"task": "evaluate_cli", "argv": argv},
        "loop": {"task": "train_and_resume", "preset": PRESET, "work_dir": os.path.join(tmp, "wd"),
                 "overrides": TINY + ["training.batch_size=2", "data.synthetic_options.length=4",
                                      "training.save_visualizations=false"],
                 "first": 1, "then": 2},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ddp_loop"))
    payloads = _payloads(tmp)
    ranks = torch_ddp.start(payloads)
    one = {"steps": torch_ddp.train_steps(0, 1, payloads["steps"])}
    slide = dict(payloads["slide"], task="slide_frame")
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer

    model, texts = torch_ddp._model(slide["cfg"], slide["state_dict"])
    one["slide"] = Inferencer(model.eval(), texts).predict(
        slide["frame"], mode="slide", crop=slide["crop"], stride=slide["stride"],
        window_batch=slide["window_batch"], fetch="device")
    argv = payloads["eval"]["argv"]
    five = torch_ddp.evaluate_cli(0, 1, {"argv": argv})
    first = torch_ddp.evaluate_cli(0, 1, {"argv": argv + ["--max-samples", "1"]})
    one["eval"] = five["confusion"][0] + first["confusion"][0]
    return payloads, one, ranks.join()


def test_two_rank_steps_match_one_process_with_augmentation_and_dropout(runs):
    _, one, ranks = runs
    want = one["steps"]
    for r in ranks:
        got = r["steps"]
        assert [m["skipped"] for m in got["metrics"]] == [0.0, 0.0]
        for m_got, m_want in zip(got["metrics"], want["metrics"]):
            assert m_got["loss_total"] == pytest.approx(m_want["loss_total"], rel=1e-6)
        for key, value in want["state"].items():
            if value.is_floating_point():
                assert _rel(got["state"][key], value) <= STEP_TOL, key
    for key, value in ranks[0]["steps"]["state"].items():
        assert torch.equal(value, ranks[1]["steps"]["state"][key]), key


def test_nan_in_one_ranks_sample_skips_on_every_rank(runs):
    payloads, _, ranks = runs
    before = payloads["nan"]["state_dict"]
    for r in ranks:
        got = r["nan"]
        assert got["metrics"][0]["skipped"] == 1.0
        assert not np.isfinite(got["metrics"][0]["loss_total"])
        assert got["step"] == 1 and got["count"] == 0
        for key, value in before.items():
            assert torch.equal(got["state"][key], value), key


def test_window_sharded_slide_frame_matches_the_unsharded_frame(runs):
    _, one, ranks = runs
    for r in ranks:
        for key in ("seg_logits", "depth"):
            assert _rel(r["slide"][key], one["slide"][key]) <= SLIDE_TOL, key
        assert torch.equal(r["slide"]["seg"], ranks[0]["slide"]["seg"])
    assert torch.equal(ranks[0]["slide"]["seg_logits"], ranks[1]["slide"]["seg_logits"])


def test_two_rank_evaluation_sums_the_one_process_matrix_with_jax_duplicates(runs):
    _, one, ranks = runs
    for r in ranks:
        (cm,) = r["eval"]["confusion"]
        assert cm.dtype == torch.int32 and torch.equal(cm, one["eval"])
    assert ranks[0]["eval"]["results"]["mIoU"] == ranks[1]["eval"]["results"]["mIoU"]


def test_two_rank_checkpoint_resumes_to_the_same_state_on_both(runs):
    payloads, _, ranks = runs
    wd = payloads["loop"]["work_dir"]
    saved = [r["loop"]["saved"] for r in ranks]
    assert len(saved[0]) == len(saved[1]) >= 2
    for a, b in zip(*saved):
        assert (a["step"], a["count"]) == (b["step"], b["count"])
        for key, value in a["model"].items():
            assert torch.equal(value, b["model"][key]), key
    assert saved[0][-1]["step"] == 2
    payload = torch.load(os.path.join(wd, "checkpoints", "latest"), weights_only=True)
    assert payload["step"] == 2
    for key, value in payload["model"].items():
        assert torch.equal(value, saved[0][-1]["model"][key]), key
    assert ranks[0]["loop"]["first"]["miou"] == ranks[1]["loop"]["first"]["miou"]
    assert ranks[0]["loop"]["then"] == ranks[1]["loop"]["then"]
    files = set(ranks[0]["loop"]["files"])
    assert {"train_p0.log", "train_p1.log", "train_log.jsonl"} <= files
    assert "train.log" not in files
    with open(os.path.join(wd, "train_log.jsonl")) as f:
        assert len(f.read().splitlines()) == 2  # rank 0's two steps
    with open(os.path.join(wd, "train_p1.log")) as f:
        assert "mesh {'data': 2} over 2 devices (cpu)" in f.read()
