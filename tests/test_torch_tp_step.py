"""Tensor parallelism over a `model` axis (`parallel/tensor_parallel.py`):
two spawned Gloo ranks under `{model: 2}` and four under `{data: 2,
model: 2}` with FSDP, against the JAX package's step on the same mesh of
conftest's virtual devices (`{data: 1, model: 2}` for the first) with its
state placed by `shard_train_state`, on the same weights and global batch of
8: the loss, every trainable parameter after one SGD step, the frozen text
tower unchanged, the BatchNorm statistics; `grad_accum_steps: 2` with a
global-norm clip that acts; the skip on a non-finite loss; each rank's
resident parameter and AdamW moment elements against JAX's per-device
elements; the attention on each rank's half of the heads.  A ViT of 3
heads keeps its attention replicated (the heads do not divide by 2; JAX
splits the qkv columns there) and still matches JAX's step.  The cases are
`torch_shard_cases.py`'s; the ranks run while the parent compiles JAX's
steps."""

import pytest

import torch_ddp
import torch_shard_cases as cases
from test_torch_ddp_step import _batch

MESHES = {"tp": ({"model": 2}, False), "tp_fsdp": ({"data": 2, "model": 2}, True)}


@pytest.fixture(scope="module")
def runs():
    cfg = cases.vit()
    jm, texts, params, stats, state_dict = cases.weights(cfg, seed=3)
    batch, batch2 = _batch(8, cases.HW, True, 5), _batch(8, cases.HW, True, 6)
    clip, adamw = cases.training(clip=0.05), cases.training(opt="AdamW")
    cfg3 = cases.vit(heads=3, width=96)
    jm3, texts3, params3, stats3, state_dict3 = cases.weights(cfg3, seed=4)
    started = {}
    for tag, (mesh, fsdp) in MESHES.items():
        payloads = {
            "step": cases.payload(cfg, state_dict, mesh, fsdp, [batch]),
            "accum_clip": cases.payload(cfg, state_dict, mesh, fsdp, [batch2], accum=2,
                                        train=clip),
            "skip": cases.payload(cfg, state_dict, mesh, fsdp, [cases.non_finite(batch)]),
            "adamw": cases.payload(cfg, state_dict, mesh, fsdp, [batch], train=adamw),
        }
        if tag == "tp":
            payloads["heads3"] = cases.payload(cfg3, state_dict3, mesh, fsdp, [batch])
        world = 2 if tag == "tp" else 4
        started[tag] = torch_ddp.start(payloads, world=world, timeout=400)
    want = {}
    for tag, (mesh, fsdp) in MESHES.items():
        want[tag] = {
            "step": cases.jax_step(jm, texts, params, stats, batch, mesh, fsdp),
            "accum_clip": cases.jax_step(jm, texts, params, stats, batch2, mesh, fsdp, accum=2,
                                         train=clip),
            "adamw": cases.jax_device_elements(jm, params, stats, mesh, fsdp, adamw)}
    want["tp"]["heads3"] = cases.jax_step(jm3, texts3, params3, stats3, batch, MESHES["tp"][0],
                                          False)
    ranks = {tag: r.join() for tag, r in started.items()}
    return want, ranks, {"4": state_dict, "3": state_dict3}


@pytest.mark.parametrize("case", ["step", "accum_clip"])
@pytest.mark.parametrize("tag", list(MESHES))
def test_tp_step_matches_jax(runs, tag, case):
    want, ranks, initial = runs
    cases.check_against_jax(want[tag][case], [r[case] for r in ranks[tag]], initial["4"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_tp_skips_a_non_finite_loss(runs, tag):
    _, ranks, initial = runs
    cases.check_skip([r["skip"] for r in ranks[tag]], initial["4"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_resident_elements_are_jax_per_device_elements(runs, tag):
    want, ranks, _ = runs
    for r in ranks[tag]:
        got = r["adamw"]
        assert got["resident"] == got["jax_elements"] == want[tag]["adamw"]


@pytest.mark.parametrize("tag", list(MESHES))
def test_each_rank_attends_over_its_half_of_the_heads(runs, tag):
    """Both towers' attention layers hold half the heads (4 -> 2 in the ViT,
    2 -> 1 in the text tower); the mesh coordinates are row-major."""
    _, ranks, _ = runs
    for r in ranks[tag]:
        assert set(r["step"]["heads"].values()) == {2, 1}
        assert r["step"]["heads"]["backbone.transformer.blocks.0.attn"] == 2
    coords = [r["step"]["coords"] for r in ranks[tag]]
    assert coords == ([(0, 0), (0, 1)] if tag == "tp" else [(0, 0), (0, 1), (1, 0), (1, 1)])


def test_three_heads_stay_replicated_and_match_jax(runs):
    want, ranks, initial = runs
    for r in ranks["tp"]:
        assert r["heads3"]["heads"]["backbone.transformer.blocks.0.attn"] == 3
    cases.check_against_jax(want["tp"]["heads3"], [r["heads3"] for r in ranks["tp"]],
                            initial["3"])
