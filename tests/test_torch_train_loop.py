"""The port's training loop, train step and CLI on the CPU, at a tiny size:
finite losses, checkpoints and their aliases, resume without an extra step,
the SIGTERM rule, the non-finite gate, gradient accumulation, and a loss that
falls at a constant lr."""

import json
import os
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu_torch.core.config import load_config
from denseclip_vit_multimodal_tpu_torch.data.synthetic import SyntheticDataset
from denseclip_vit_multimodal_tpu_torch.tools import train as train_cli
from denseclip_vit_multimodal_tpu_torch.train import checkpoint, loop, schedules

PRESET = str(Path(__file__).resolve().parents[1] / "configs" / "denseclip_vitb16_640x640_80k.yaml")
# The heritage preset cut to a tiny size (the text tower, never run in
# training, gets a small vocabulary so checkpoints stay small).
TINY = [
    "model.backbone.width=96", "model.backbone.layers=2", "model.backbone.heads=3",
    "model.backbone.out_indices=[0,1]", "model.text_encoder.transformer_layers=1",
    "model.text_encoder.vocab_size=512",
    "model.neck.inter_channels=16", "model.neck.out_channels=32",
    "model.decode_head.in_channels=32", "model.decode_head.channels=32",
    "model.depth_head.in_channels=32", "model.depth_head.channels=16",
    "data.synthetic=true", "data.synthetic_options.image_size=[128,256]",
    "data.synthetic_options.length=8", "data.crop_size=[64,128]",
    "training.batch_size=2", "training.workers=2",
]


def _cfg(*extra):
    return load_config(PRESET, overrides=TINY + list(extra))


def _log(work_dir):
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_saves_and_resumes_without_an_extra_step(tmp_path):
    wd = str(tmp_path)
    cfg = _cfg()
    out = loop.train(cfg, wd, max_steps=3, no_validate=True, device="cpu")
    assert out["step"] == 3 and np.isfinite(out["loss_total"])
    rows = _log(wd)
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(r[k]) for r in rows for k in ("loss_seg", "loss_silog", "loss_total"))
    assert all(r["skipped"] == 0.0 for r in rows)
    assert os.path.islink(os.path.join(wd, "checkpoints", "latest"))
    # heritage warmup: the first update's lr is schedule(0) = 1e-4 * 1e-6
    assert rows[0]["lr"] == pytest.approx(1e-10)

    # the budget is met: resuming runs no step at all
    again = loop.train(cfg, wd, resume=wd, max_steps=3, no_validate=True, device="cpu")
    assert again["step"] == 3 and len(_log(wd)) == 3

    # a larger budget continues the global step, and the optimizer's count
    more = loop.train(cfg, wd, resume=wd, max_steps=5, no_validate=True, device="cpu")
    rows = _log(wd)
    assert more["step"] == 5 and [r["step"] for r in rows[3:]] == [4, 5]
    schedule = schedules.build_schedule(cfg.training, steps_per_epoch=4)
    assert rows[3]["lr"] == pytest.approx(schedule(3))


class _SigtermOnFetch(SyntheticDataset):
    """Sends SIGTERM to this process when a sample of the second batch is
    fetched, once, and only while the training loop's handler is installed
    (so the test can never kill its own process)."""

    def __getitem__(self, idx):
        handler = signal.getsignal(signal.SIGTERM)
        armed = isinstance(getattr(handler, "__self__", None), loop.GracefulShutdown)
        if armed and not getattr(self, "_sent", False) and self._fetches >= 2:
            self._sent = True
            os.kill(os.getpid(), signal.SIGTERM)
        self._fetches += 1
        return super().__getitem__(idx)


def test_sigterm_saves_a_resumable_checkpoint_and_stops(tmp_path, monkeypatch):
    before = signal.getsignal(signal.SIGTERM)

    def dataset(data_cfg, split):
        ds = _SigtermOnFetch(length=8, image_size=(128, 256))
        ds._fetches = 0
        return ds

    monkeypatch.setattr(loop, "build_dataset", dataset)
    wd = str(tmp_path)
    out = loop.train(_cfg(), wd, max_steps=20, no_validate=True, device="cpu")
    assert signal.getsignal(signal.SIGTERM) == before  # the handler is restored
    assert 1 <= out["step"] < 4  # stopped inside the first epoch, after the current step
    saved = torch.load(os.path.join(wd, "checkpoints", "latest"), weights_only=True)
    assert saved["step"] == out["step"] and saved["epoch"] == 0


def test_constant_lr_loss_falls_and_cli_runs(tmp_path):
    wd = str(tmp_path)
    train_cli.main([PRESET, "--work-dir", wd, "--no-validate", "--max-steps", "4",
                    "--device", "cpu", "--set", *TINY, "training.scheduler.type=constant",
                    "training.optimizer.lr=1e-3", "data.synthetic_options.length=2"])
    losses = [r["loss_total"] for r in _log(wd)]
    assert len(losses) == 4 and losses[-1] < losses[0]


def test_validation_is_not_yet_ported(tmp_path):
    """Validation is ported now: `no_validate=False` validates after the
    epoch, returns its metrics and saves `best` at the first mIoU."""
    out = loop.train(_cfg("data.synthetic_options.length=4"), str(tmp_path), max_steps=1,
                     device="cpu")
    assert out["step"] == 1
    for key in ("miou", "pixel_acc", "depth_abs_rel", "depth_rmse", "depth_a1",
                "val_loss_seg", "val_loss_silog"):
        assert np.isfinite(out[key]), key
    assert 0.0 <= out["miou"] <= 1.0 and 0.0 <= out["pixel_acc"] <= 1.0
    assert os.path.islink(os.path.join(tmp_path, "checkpoints", "best"))


def test_checkpoint_best_alias_and_pruning(tmp_path):
    """`best` survives the rolling window of epoch files; each alias restores
    its own state."""
    from denseclip_vit_multimodal_tpu_torch.train.state import Optimizer, TrainState

    model = torch.nn.Linear(3, 2)
    state = TrainState(model, Optimizer(model, schedules.constant(0.1), frozen_modules=()))
    wd = str(tmp_path)
    for epoch in range(8):
        with torch.no_grad():
            model.weight.fill_(float(epoch))
        state.step = 10 * epoch
        checkpoint.save_checkpoint(wd, state, epoch, best_metric=float(epoch),
                                   is_best=epoch == 1)
    files = sorted(f for f in os.listdir(os.path.join(wd, "checkpoints")) if f.endswith(".pt"))
    assert files == ["epoch_1.pt"] + [f"epoch_{e}.pt" for e in range(3, 8)]
    for which, epoch in (("best", 1), ("latest", 7)):
        assert checkpoint.restore_checkpoint(wd, state, which) == (epoch, float(epoch))
        assert state.step == 10 * epoch and float(model.weight.detach()[0, 0]) == epoch


def _tiny_state_and_step(*extra, grad_accum_steps=1):
    from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import (
        CITYSCAPES_CLASSES,
        build_denseclip,
    )
    from denseclip_vit_multimodal_tpu_torch.train.state import create_train_state
    from denseclip_vit_multimodal_tpu_torch.train.step import make_train_step

    cfg = _cfg("training.scheduler.type=PolyLR", "training.scheduler.warmup_iters=2", *extra)
    model, texts = build_denseclip(cfg.model, CITYSCAPES_CLASSES, device="cpu")
    state = create_train_state(model, cfg.training, steps_per_epoch=4)
    make = lambda **kw: make_train_step(texts, augment_config_from_data_cfg(cfg.data),
                                        grad_accum_steps=grad_accum_steps, **kw)
    sample = SyntheticDataset(length=2, image_size=(128, 256))
    batch = {k: torch.from_numpy(np.stack([sample[0][k], sample[1][k]])) for k in sample[0]}
    return state, make, batch


def test_non_finite_loss_skips_the_update_but_advances_the_step():
    state, make, batch = _tiny_state_and_step()
    step = make()
    schedule = state.optimizer.schedule
    first = step(state, batch)
    assert first["skipped"] == 0.0 and first["lr"] == pytest.approx(schedule(0))
    params = {k: v.clone() for k, v in state.model.state_dict().items()}  # weights + BN stats
    moments = {k: v["exp_avg"].clone() for k, v in state.optimizer.inner.state_dict()["state"].items()}

    skipped = make(loss_weights={"seg": float("nan")})(state, batch)  # a NaN total loss
    assert skipped["skipped"] == 1.0 and not np.isfinite(skipped["loss_total"])
    assert state.step == 2 and state.optimizer.count == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, params[k]), k
    for k, v in state.optimizer.inner.state_dict()["state"].items():
        assert torch.equal(v["exp_avg"], moments[k])

    # the lr follows the count of APPLIED updates (1), not the step (2)
    after = step(state, batch)
    assert after["skipped"] == 0.0 and after["lr"] == pytest.approx(schedule(1))
    assert schedule(1) != schedule(2)
    assert state.step == 3 and state.optimizer.count == 2


def test_gradient_accumulation_runs_microbatches():
    state, make, batch = _tiny_state_and_step(grad_accum_steps=2)
    step = make()
    out = step(state, batch)
    assert out["skipped"] == 0.0 and np.isfinite(out["loss_total"])
    assert state.optimizer.count == 1
    with pytest.raises(ValueError, match="not divisible"):
        step(state, {k: v[:1] for k, v in batch.items()})
