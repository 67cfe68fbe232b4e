"""ZeRO-3 over the data axis (`tpu.fsdp`, `parallel/fsdp.py`): two spawned
Gloo ranks under `{data: 2}` with FSDP (`fsdp_min_size` 1024, so the tiny
blocks shard too) against the JAX package's step on the same mesh of two
virtual devices with its state placed by `shard_train_state`, on the same
weights and global batch of 8: the loss, every trainable parameter after one
SGD step (its gradient and its update), the frozen text tower unchanged, the
BatchNorm statistics; `grad_accum_steps: 2` with a global-norm clip that
acts (each rank adds the squares of its shards); the skip on a non-finite
loss; the step under `tpu.remat`; each rank's resident parameter and AdamW
moment elements against the elements JAX places on a device.  The cases are `torch_shard_cases.py`'s;
the ranks run while the parent compiles JAX's steps."""

import numpy as np
import pytest

import torch_ddp
import torch_shard_cases as cases
from test_torch_ddp_step import _batch

MESH = {"data": 2}


@pytest.fixture(scope="module")
def runs():
    cfg = cases.vit()
    jm, texts, params, stats, state_dict = cases.weights(cfg, seed=3)
    batch, batch2 = _batch(8, cases.HW, True, 5), _batch(8, cases.HW, True, 6)
    clip = cases.training(clip=0.05)
    adamw = cases.training(opt="AdamW")
    payloads = {
        "step": cases.payload(cfg, state_dict, MESH, True, [batch]),
        "remat": cases.payload(cfg, state_dict, MESH, True, [batch], remat=True),
        "accum_clip": cases.payload(cfg, state_dict, MESH, True, [batch2], accum=2, train=clip),
        "skip": cases.payload(cfg, state_dict, MESH, True, [cases.non_finite(batch)]),
        "adamw": cases.payload(cfg, state_dict, MESH, True, [batch], train=adamw),
    }
    ranks = torch_ddp.start(payloads, world=2)
    want = {"step": cases.jax_step(jm, texts, params, stats, batch, MESH, True),
            "accum_clip": cases.jax_step(jm, texts, params, stats, batch2, MESH, True, accum=2,
                                         train=clip),
            "adamw": cases.jax_device_elements(jm, params, stats, MESH, True, adamw)}
    want["remat"] = want["step"]  # remat recomputes the same function
    return want, ranks.join(), state_dict


@pytest.mark.parametrize("case", ["step", "accum_clip", "remat"])
def test_fsdp_step_matches_jax(runs, case):
    """`remat`: under `tpu.remat` each block's recomputed forward runs
    inside its backward with the block's parameters gathered again."""
    want, ranks, initial = runs
    cases.check_against_jax(want[case], [r[case] for r in ranks], initial)


def test_the_clip_acts(runs):
    """The clipped update's norm is the clip's (JAX's `clip_by_global_norm`)."""
    _, ranks, initial = runs
    state = ranks[0]["accum_clip"]["state"]
    norm = np.sqrt(sum(float(((initial[k] - state[k]) / cases.LR).double().square().sum())
                       for k in initial if not k.startswith(cases.FROZEN)
                       and initial[k].is_floating_point() and "running" not in k))
    assert norm == pytest.approx(0.05, rel=1e-4)


def test_fsdp_skips_a_non_finite_loss(runs):
    _, ranks, initial = runs
    cases.check_skip([r["skip"] for r in ranks], initial)


def test_resident_elements_are_jax_per_device_elements(runs):
    """Parameters and AdamW moments: what each rank holds after a step is
    what JAX places on a device, about half of one process's parameters."""
    want, ranks, initial = runs
    params, opt = want["adamw"]
    full = sum(v.numel() for k, v in initial.items()
               if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    for r in ranks:
        got = r["adamw"]
        assert got["resident"] == got["jax_elements"] == (params, opt)
        assert got["metrics"][0]["skipped"] == 0.0
    assert params < 0.6 * full
