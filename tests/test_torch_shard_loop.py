"""`train/loop.py::train` with the state sharded: four spawned Gloo ranks
under `tpu.mesh: {data: 2, model: 2}` and `tpu.fsdp` (`fsdp_min_size` 1024),
the heritage preset cut to a tiny size (width 128, 4 heads, fp32; SGD with
momentum, whose updates are linear in the gradients), one step
then validation, then resumed to a second step, against the same run data
parallel over two ranks (`{data: 2}`, the global batches JAX's multi-process
loader makes: each data rank's rows in rank order; `test_torch_ddp_*.py`
hold that run to JAX's step and to one process): the training losses, the
validation metrics (run under the same layout) and the final checkpoint,
which is the file the data-parallel run writes (its keys and shapes: a
one-process file) holding the same state within the gradient limit; every
rank logs JAX's two lines and agrees on every number."""

import os

import pytest
import torch

import torch_ddp
from test_torch_train_loop import PRESET, TINY
from test_torch_train_model import TOL_GRAD_REL, TOL_LOSS

OVERRIDES = TINY + ["model.backbone.width=128", "model.backbone.heads=4", "training.batch_size=4",
                    "tpu.compute_dtype=float32", "training.save_visualizations=false",
                    "tpu.fsdp_min_size=1024", "training.optimizer.type=SGD",
                    "training.optimizer.momentum=0.9"]
SHARDED = OVERRIDES + ["tpu.mesh={data: 2, model: 2}", "tpu.fsdp=true"]


def _payload(tmp, name, overrides):
    return {"task": "train_and_resume", "preset": PRESET, "work_dir": os.path.join(tmp, name),
            "overrides": overrides, "first": 1, "then": 2}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("shard_loop"))
    ranks = torch_ddp.start({"loop": _payload(tmp, "sharded", SHARDED)}, world=4, timeout=400)
    ddp = torch_ddp.start({"loop": _payload(tmp, "ddp", OVERRIDES + ["tpu.mesh={data: 2}"])},
                          world=2, timeout=400)
    return ddp.join()[0]["loop"], [r["loop"] for r in ranks.join()], tmp


def _latest(tmp, name):
    return torch.load(os.path.join(tmp, name, "checkpoints", "latest"), weights_only=True)


def test_losses_and_validation_match_one_process(runs):
    ddp, ranks, _ = runs
    for got in ranks:
        for part in ("first", "then"):
            assert got[part]["step"] == ddp[part]["step"]
            for key, value in ddp[part].items():
                assert got[part][key] == pytest.approx(value, rel=TOL_LOSS, abs=TOL_LOSS), (
                    part, key)
        assert got["first"] == ranks[0]["first"] and got["then"] == ranks[0]["then"]
    assert {"miou", "pixel_acc", "val_loss_seg", "val_loss_silog"} <= set(ddp["first"])


def test_the_sharded_checkpoint_is_the_data_parallel_file(runs):
    _, _, tmp = runs
    got, want = _latest(tmp, "sharded"), _latest(tmp, "ddp")
    assert got["step"] == want["step"] == 2 and got["optimizer"]["count"] == 2
    assert set(got["model"]) == set(want["model"])
    for key, value in want["model"].items():
        g = got["model"][key]
        assert g.shape == value.shape and g.dtype == value.dtype, key
        if value.is_floating_point():
            # parameters that start at 0 hold only their updates, whose smallest
            # elements move with fp32 rounding: they are held in absolute terms
            torch.testing.assert_close(g, value, rtol=TOL_GRAD_REL, atol=1e-6, msg=key)
    flat = lambda sd: torch.cat([v.flatten() for v in sd.values() if v.is_floating_point()])
    whole = flat(got["model"]) - flat(want["model"])
    assert float(whole.norm() / flat(want["model"]).norm()) < TOL_LOSS
    sg, sw = got["optimizer"]["inner"]["state"], want["optimizer"]["inner"]["state"]
    assert set(sg) == set(sw)
    for idx, entry in sw.items():
        for key, value in entry.items():
            assert sg[idx][key].shape == value.shape, (idx, key)
    assert got["optimizer"]["inner"]["param_groups"] == want["optimizer"]["inner"]["param_groups"]


def test_every_rank_logs_the_layout(runs):
    _, ranks, tmp = runs
    files = set(ranks[0]["files"])
    assert {f"train_p{r}.log" for r in range(4)} <= files
    for r in range(4):
        with open(os.path.join(tmp, "sharded", f"train_p{r}.log")) as f:
            log = f.read()
        assert "mesh {'data': 2, 'model': 2} over 4 devices (cpu)" in log
        assert "tensor-parallel params over 2-way model axis" in log
        assert "FSDP: params + optimizer state sharded over the 2-way data axis (tpu.fsdp)" in log
