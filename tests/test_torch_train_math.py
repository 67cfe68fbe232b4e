"""Losses, schedules and the optimizer of the port against the JAX package's, on the CPU."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.train import losses as j_losses
from denseclip_vit_multimodal_tpu.train import schedules as j_sched
from denseclip_vit_multimodal_tpu.train import state as j_state
from denseclip_vit_multimodal_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from denseclip_vit_multimodal_tpu_torch.core.config import Config, load_config
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.train import losses as t_losses
from denseclip_vit_multimodal_tpu_torch.train import schedules as t_sched
from denseclip_vit_multimodal_tpu_torch.train import state as t_state

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
# fp32 losses: the same fp32 reductions in another order.
TOL_LOSS = 1e-5
# schedules: JAX computes in float32, the port in float64.
TOL_LR = 1e-6
# parameters after optimizer updates: fp32 Adam arithmetic in another order.
TOL_PARAM = 2e-6


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def _seg_case(ignore_all=False):
    rs = np.random.RandomState(0)
    logits = rs.randn(2, 5, 7, 19).astype(np.float32) * 3
    labels = rs.randint(0, 19, (2, 5, 7)).astype(np.int32)
    labels[rs.rand(2, 5, 7) < 0.2] = 255
    if ignore_all:
        labels[:] = 255
    return logits, labels


@pytest.mark.parametrize("ignore_all", [False, True], ids=["mixed", "all_ignored"])
def test_cross_entropy_matches_jax(ignore_all):
    logits, labels = _seg_case(ignore_all)
    want = float(j_losses.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = t_losses.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.shape == ()
    assert float(got) == pytest.approx(want, rel=TOL_LOSS, abs=TOL_LOSS)
    if ignore_all:
        assert float(got) == 0.0
    # the library call with the same semantics agrees too
    if not ignore_all:
        ref = torch.nn.functional.cross_entropy(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                                torch.from_numpy(labels).long(), ignore_index=255)
        assert float(got) == pytest.approx(float(ref), rel=TOL_LOSS)


@pytest.mark.parametrize("mask_kind", ["mask", "no_mask", "empty_mask", "channel_dim"])
def test_silog_matches_jax(mask_kind):
    rs = np.random.RandomState(1)
    pred = rs.uniform(0.0, 50.0, (2, 6, 8)).astype(np.float32)
    tgt = rs.uniform(0.0, 80.0, (2, 6, 8)).astype(np.float32)
    tgt[rs.rand(2, 6, 8) < 0.3] = 0.0
    mask = tgt > 0
    if mask_kind == "empty_mask":
        mask[:] = False
    if mask_kind == "channel_dim":
        pred = pred[..., None]
    m = None if mask_kind == "no_mask" else mask
    want = float(j_losses.silog_loss(jnp.asarray(pred), jnp.asarray(tgt),
                                     None if m is None else jnp.asarray(m), lambd=0.5))
    got = float(t_losses.silog_loss(torch.from_numpy(pred), torch.from_numpy(tgt),
                                    None if m is None else torch.from_numpy(m), lambd=0.5))
    assert got == pytest.approx(want, rel=TOL_LOSS, abs=TOL_LOSS)
    if mask_kind == "empty_mask":
        assert got == 0.0


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

STEPS = [0, 1, 1499, 1500, 1501, 79999, 80000]


@pytest.mark.parametrize("preset", ["denseclip_vitb16_640x640_80k", "denseclip_vitb16_cityscapes_multitask"])
def test_build_schedule_matches_jax(preset):
    cfg = load_config(CONFIGS / f"{preset}.yaml")
    training = cfg.training
    want = j_sched.build_schedule(training.to_dict(), steps_per_epoch=372)
    got = t_sched.build_schedule(training, steps_per_epoch=372)
    for step in STEPS:
        w = float(want(jnp.asarray(step, jnp.int32)))
        assert got(step) == pytest.approx(w, rel=TOL_LR, abs=1e-12), step
    if preset.endswith("80k"):
        assert got(0) == pytest.approx(1e-4 * 1e-6)  # the first update's lr under the warmup


@pytest.mark.parametrize("stype", ["constant", "cosine", "PolyLR"])
def test_schedule_types_match_jax(stype):
    training = {"optimizer": {"lr": 3e-4}, "epochs": 7, "iters": 700,
                "scheduler": {"type": stype, "T_max": 7, "eta_min": 1e-6, "warmup_iters": 10}}
    want = j_sched.build_schedule(training, steps_per_epoch=100)
    got = t_sched.build_schedule(Config(training), steps_per_epoch=100)
    for step in (0, 5, 10, 99, 100, 350, 699, 700):
        assert got(step) == pytest.approx(float(want(jnp.asarray(step))), rel=TOL_LR, abs=1e-12)
    with pytest.raises(ValueError, match="Unsupported scheduler"):
        t_sched.build_schedule(Config({"scheduler": {"type": "bogus"}}), 10)


# --------------------------------------------------------------------------
# labels, frozen set, decay mask, AdamW / SGD updates
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair(tiny_model_cfg):
    cfg = dict(tiny_model_cfg)
    # a small vocabulary keeps the (frozen) token table small: nothing here runs the tower
    cfg["text_encoder"] = dict(cfg["text_encoder"], transformer_layers=1, vocab_size=512)
    jm, texts = j_build(cfg, CITYSCAPES_CLASSES)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.asarray(texts))
    rs = np.random.RandomState(3)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rs.randn(*np.shape(a)).astype(np.float32),
                          variables["params"])
    return cfg, params, variables["batch_stats"]


def _port_model(cfg, params, batch_stats):
    model, _ = t_build(cfg, CITYSCAPES_CLASSES, device="cpu")
    return load_flax_variables(model, {"params": params, "batch_stats": batch_stats})


def _torch_view(tree):
    """A Flax params-shaped tree of arrays -> {torch name: array}."""
    return {k: v.numpy() for k, v in flax_to_state_dict({"params": tree}).items()}


HERITAGE = {"paramwise": {"backbone_lr_mult": 0.1, "text_encoder_lr_mult": 0.0}}


@pytest.mark.parametrize("training", [HERITAGE, {}, {"lr_mults": {"neck": 0.0}}],
                         ids=["heritage", "flagship", "neck_frozen"])
def test_labels_and_frozen_set_match_jax(pair, training):
    cfg, params, stats = pair
    frozen = t_state.frozen_modules_from_cfg(Config(training))
    assert frozen == j_state.frozen_modules_from_cfg(training)
    names = sorted({*jax.tree.leaves(j_state.label_params(params, frozen))})
    codes = jax.tree.map(lambda lab, p: np.full(np.shape(p), names.index(lab), np.float32),
                         j_state.label_params(params, frozen), params)
    want = {k: names[int(v.flat[0])] for k, v in _torch_view(codes).items()}
    assert t_state.label_params(_port_model(cfg, params, stats), frozen) == want


def test_decay_mask_matches_jax(pair):
    """One update of zero gradients at lr 1: the JAX AdamW chain moves exactly
    the decayed leaves (by -wd * p), so its update tree IS the mask."""
    cfg, params, stats = pair
    frozen = ("text_encoder",)
    tx = j_state.build_optimizer(params, lambda s: 1.0, weight_decay=0.5, frozen_modules=frozen)
    zeros = jax.tree.map(jnp.zeros_like, params)
    updates, _ = jax.jit(tx.update)(zeros, tx.init(params), params)
    want = {k for k, v in _torch_view(jax.tree.map(np.asarray, updates)).items() if np.any(v)}
    model = _port_model(cfg, params, stats)
    got = {n for n, p in model.named_parameters()
           if t_state.param_label(n, frozen) != t_state.FROZEN and t_state.decays(model, n, p)}
    assert got == want
    assert "backbone.positional_embedding" in got and "backbone.ln_pre.weight" not in got


def _random_grads(params, seed):
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (0.1 * rs.randn(*np.shape(a))).astype(np.float32), params)


@pytest.mark.parametrize("opt_type,clip", [("adamw", None), ("adamw", 0.5), ("sgd", None)],
                         ids=["adamw", "adamw_clip", "sgd"])
def test_updates_match_optax(pair, opt_type, clip):
    cfg, params, stats = pair
    frozen = ("text_encoder",)
    mults = {"backbone": 0.1, "text_encoder": 0.0}
    kw = dict(weight_decay=1e-2, clip_grad_norm=clip, frozen_modules=frozen, lr_mults=mults,
              opt_type=opt_type, momentum=0.9)
    j_schedule = j_sched.poly_with_warmup(1e-3, total_steps=100, warmup_steps=2, warmup_ratio=0.1)
    t_schedule = t_sched.poly_with_warmup(1e-3, total_steps=100, warmup_steps=2, warmup_ratio=0.1)
    tx = j_state.build_optimizer(params, j_schedule, **kw)
    update = jax.jit(tx.update)
    j_params, opt_state = jax.tree.map(jnp.asarray, params), tx.init(params)
    model = _port_model(cfg, params, stats)
    opt = t_state.Optimizer(model, t_schedule, **kw)
    named = dict(model.named_parameters())
    steps = 3 if opt_type == "adamw" else 1
    for i in range(steps):
        grads = _random_grads(params, seed=10 + i)
        # nothing in the training forward reads `contexts`: JAX hands it a zero
        # gradient, the port leaves its .grad None, and AdamW must decay it anyway
        grads["contexts"] = np.zeros_like(grads["contexts"])
        # the JAX step zero-fills frozen branches, so they add nothing to the clip norm
        grads["text_encoder"] = jax.tree.map(np.zeros_like, grads["text_encoder"])
        updates, opt_state = update(grads, opt_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for name, g in _torch_view(grads).items():
            if named[name].requires_grad and name != "contexts":
                named[name].grad = torch.from_numpy(g)
        opt.step()
        opt.zero_grad()
    assert opt.count == steps
    want = _torch_view(jax.tree.map(np.asarray, j_params))
    got = {k: v.detach().numpy() for k, v in model.named_parameters()}
    assert set(got) == set(want)
    original = _torch_view(params)
    moved = 0
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=TOL_PARAM, atol=TOL_PARAM,
                                   err_msg=name)
        moved += int(not np.array_equal(got[name], original[name]))
    assert moved > 0
    assert np.array_equal(got["text_encoder.positional_embedding"],
                          original["text_encoder.positional_embedding"])  # frozen
    assert not np.array_equal(got["contexts"], original["contexts"])  # decayed


def test_optimizer_rejects_unknown_type(pair):
    cfg, params, stats = pair
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        t_state.Optimizer(_port_model(cfg, params, stats), t_sched.constant(1e-3),
                          opt_type="lamb")
