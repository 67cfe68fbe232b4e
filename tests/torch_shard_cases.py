"""Cases of the sharded train step (tensor parallelism, ZeRO-3) against the
JAX package's step, shared by `test_torch_fsdp_step.py`,
`test_torch_tp_step.py` and `test_torch_shard_checkpoint.py` (not collected).

A case is the seed+depth ViT of `test_torch_ddp_step.py` at width 128 with 4
heads (so both towers' heads divide by 2), its seeded weights perturbed, in
both packages' layouts, a global batch of 8 and a `torch_ddp.sharded_steps`
payload.  JAX's side runs `make_train_step` on the same mesh of conftest's
virtual devices with its state placed by `shard_train_state` (a port mesh
without a data axis is JAX's `{data: 1, ...}`).  Both take SGD steps at lr
1024 with no weight decay, so a gradient is (before - after) / 1024; with
`clip` the SGD update is clipped to a global norm, as JAX's chain does.
"""

from __future__ import annotations

import copy

import jax
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.data.augment import AugmentConfig as JAug
from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.parallel.mesh import make_mesh, shard_batch
from denseclip_vit_multimodal_tpu.parallel.sharding_rules import shard_train_state
from denseclip_vit_multimodal_tpu.train.state import create_train_state as j_state
from denseclip_vit_multimodal_tpu.train.step import make_train_step as j_step
from denseclip_vit_multimodal_tpu_torch.convert import flax_to_state_dict
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES

import torch_ddp
from test_torch_ddp_step import VIT, _batch, _flax_tree
from test_torch_train_model import TOL_GRAD_REL, TOL_LOSS

LR = 1024.0
FROZEN = ("text_encoder",)
MIN_SIZE = 1024  # JAX's tests' fsdp_min_size: the tiny model's blocks shard too
HW = (64, 128)
AUG = {"crop_size": HW, "scale_range": (1.0, 1.0), "hflip_prob": 0.0}


def vit(heads: int = 4, width: int = 128) -> dict:
    cfg = copy.deepcopy(VIT)
    cfg["backbone"] = dict(cfg["backbone"], width=width, heads=heads)
    return cfg


def training(clip=None, opt="SGD") -> dict:
    out = {"optimizer": {"type": opt, "lr": LR if opt == "SGD" else 1e-3,
                         "weight_decay": 0.0 if opt == "SGD" else 0.01}}
    if clip:
        out["clip_grad_norm"] = clip
    return out


def weights(cfg, seed: int):
    """The port's seeded weights perturbed (`test_torch_ddp_step._case`),
    and JAX's model, texts and trees holding them."""
    jm, texts = j_build(cfg, CITYSCAPES_CLASSES)
    model, _ = torch_ddp._model(cfg, seed=seed)
    rs = np.random.RandomState(seed + 1)
    state_dict = {}
    for key, value in model.state_dict().items():
        v = value.numpy()
        if key.endswith(("running_mean", "running_var")):
            v = (rs.rand(*v.shape) + 0.5).astype(np.float32)
        elif v.dtype == np.float32:
            v = v + 0.1 * rs.randn(*v.shape).astype(np.float32)
        state_dict[key] = torch.from_numpy(np.array(v))  # 0-d stays 0-d
    state_dict["depth_head.classifier.bias"].fill_(10.0)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            np.zeros((1, *HW, 3), np.float32), texts)
    params = _flax_tree(shapes["params"], "params", state_dict)
    stats = _flax_tree(shapes["batch_stats"], "batch_stats", state_dict)
    return jm, texts, params, stats, state_dict


def payload(cfg, state_dict, mesh, fsdp, batches, accum=1, train=None, **extra) -> dict:
    return {"task": "sharded_steps", "cfg": cfg, "state_dict": state_dict, "mesh": mesh,
            "fsdp": fsdp, "min_size": MIN_SIZE, "batches": batches, "accum": accum,
            "training": train or training(), "frozen": FROZEN, "aug": AUG, **extra}


def jax_mesh(mesh: dict):
    spec = mesh if "data" in mesh else {"data": 1, **mesh}
    return make_mesh(spec, devices=jax.devices()[:int(np.prod(list(spec.values())))])


def jax_step(jm, texts, params, stats, batch, mesh, fsdp, accum=1, train=None):
    """JAX's step on `mesh` (its state placed by `shard_train_state`): the
    loss, the gradients (or the clipped update / LR) as the port's
    state_dict, and the BatchNorm statistics after it."""
    m = jax_mesh(mesh)
    state = j_state(jm, {"params": params, "batch_stats": stats}, train or training(), 1,
                    frozen_modules=FROZEN)
    state = shard_train_state(state, m, fsdp=fsdp, fsdp_min_size=MIN_SIZE)
    step = j_step(texts, JAug(**AUG), grad_accum_steps=accum, frozen_modules=FROZEN)
    new_state, metrics = step(state, shard_batch(batch, m), jax.random.PRNGKey(0))
    grads = jax.tree.map(lambda old, new: (old - np.asarray(new)) / LR, params,
                         jax.tree.map(np.asarray, new_state.params))
    return (float(metrics["loss_total"]), flax_to_state_dict({"params": grads}),
            flax_to_state_dict({"batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)}))


def jax_device_elements(jm, params, stats, mesh, fsdp, train) -> tuple:
    """(parameter, optimizer-state) elements JAX places on its first device."""
    m = jax_mesh(mesh)
    state = j_state(jm, {"params": params, "batch_stats": stats}, train, 1,
                    frozen_modules=FROZEN)
    state = shard_train_state(state, m, fsdp=fsdp, fsdp_min_size=MIN_SIZE)
    dev = jax.devices()[0]

    def on_dev(tree):
        return sum(int(np.prod(s.data.shape)) for leaf in jax.tree.leaves(tree)
                   if getattr(leaf, "ndim", 0) > 0 for s in leaf.addressable_shards
                   if s.device == dev)

    return on_dev(state.params), on_dev(state.opt_state)


def check_against_jax(want, ranks, initial):
    """Each rank's loss, gradients of every trainable parameter (its full
    state after the step against JAX's update), frozen parameters unchanged
    and BatchNorm statistics."""
    want_loss, want_grads, want_stats = want
    for got in ranks:
        metrics = got["metrics"][0]
        assert metrics["loss_total"] == pytest.approx(want_loss, rel=TOL_LOSS)
        assert metrics["skipped"] == 0.0
        state = got["state"]
        assert set(state) == set(initial)
        for name, w in want_grads.items():
            before, after = initial[name].numpy(), state[name].numpy()
            if name.startswith(FROZEN):
                assert np.array_equal(after, before), name
                continue
            g, w = (before - after) / LR, w.numpy()
            if not np.any(w):
                np.testing.assert_allclose(g, 0.0, atol=1e-9, err_msg=name)
                continue
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel < TOL_GRAD_REL, (name, rel)
            upd = np.linalg.norm(after - (before - LR * w)) / np.linalg.norm(before - LR * w)
            assert upd < TOL_GRAD_REL, (name, upd)
        for key, value in want_stats.items():
            np.testing.assert_allclose(state[key].numpy(), value.numpy(), rtol=TOL_LOSS,
                                       atol=TOL_LOSS, err_msg=key)
    for got in ranks[1:]:  # every rank puts the same state together
        for key, value in got["state"].items():
            assert torch.equal(value, ranks[0]["state"][key]), key


def check_skip(ranks, initial):
    """A non-finite loss: skipped on every rank, nothing changed."""
    for got in ranks:
        assert got["metrics"][0]["skipped"] == 1.0
        assert not np.isfinite(got["metrics"][0]["loss_total"])
        assert got["count"] == 0
        for key, value in initial.items():
            assert torch.equal(got["state"][key], value), key


def non_finite(batch: dict) -> dict:
    out = {k: v.copy() for k, v in batch.items()}
    out["depth"][0, 0, 0] = np.inf
    return out
