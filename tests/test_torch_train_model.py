"""The training forward and backward of the port against the JAX package's, on the CPU.

Same weights (JAX `init`, perturbed with numpy noise, carried over by
`convert.load_flax_variables`), same inputs, dropout and drop path at rate 0
(the two frameworks cannot draw the same random masks), fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.models import heads as j_heads
from denseclip_vit_multimodal_tpu.models import layers as j_layers
from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.train import losses as j_losses
from denseclip_vit_multimodal_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from denseclip_vit_multimodal_tpu_torch.models import heads as t_heads
from denseclip_vit_multimodal_tpu_torch.models import layers as t_layers
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.train import losses as t_losses

# fp32: loss and BatchNorm statistics are the same arithmetic in another order.
TOL_LOSS = 1e-5
# fp32 gradients through the ViT, the neck and both heads, per leaf,
# relative L2 (measured on the CPU: at most 4e-6).
TOL_GRAD_REL = 1e-4
CROP = (64, 128)


def _perturbed(variables, seed):
    rs = np.random.RandomState(seed)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rs.randn(*np.shape(a)).astype(np.float32),
                          variables["params"])
    stats = jax.tree.map(lambda a: (rs.rand(*np.shape(a)) + 0.5).astype(np.float32),
                         variables["batch_stats"])
    return params, stats


@pytest.fixture(scope="module")
def setup(tiny_model_cfg):
    cfg = dict(tiny_model_cfg)
    cfg["text_encoder"] = dict(cfg["text_encoder"], transformer_layers=1)
    cfg["decode_head"] = dict(cfg["decode_head"], dropout_ratio=0.0)
    cfg["depth_head"] = dict(cfg["depth_head"], dropout_ratio=0.0)
    jm, texts = j_build(cfg, CITYSCAPES_CLASSES)
    rs = np.random.RandomState(7)
    image = rs.randn(2, *CROP, 3).astype(np.float32)
    seg = rs.randint(0, 19, (2, *CROP)).astype(np.int32)
    seg[rs.rand(2, *CROP) < 0.1] = 255
    depth = rs.uniform(1.0, 80.0, (2, *CROP)).astype(np.float32)
    depth[rs.rand(2, *CROP) < 0.1] = 0.0
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(texts))
    params, stats = _perturbed(variables, seed=1)
    # Keep the depth predictions well above SILog's eps clamp: near 0, d log(p)
    # = 1/p makes the gradient ill-conditioned (fp32 rounding would decide it).
    params["depth_head"]["classifier"]["bias"] = np.full_like(
        params["depth_head"]["classifier"]["bias"], 10.0)
    batch = {"image": image, "seg": seg, "depth": depth, "mask": depth > 0}
    return cfg, jm, texts, params, stats, batch


def _jax_step(jm, texts, params, stats, batch, frozen=("text_encoder",)):
    trainable = {k: v for k, v in params.items() if k not in frozen}
    fixed = {k: v for k, v in params.items() if k in frozen}

    def loss_fn(tr):
        out, mutated = jm.apply({"params": {**tr, **fixed}, "batch_stats": stats},
                                jnp.asarray(batch["image"]), jnp.asarray(texts), train=True,
                                gt_hw=CROP, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(1)})
        seg = j_losses.cross_entropy_loss(out["seg"], jnp.asarray(batch["seg"]))
        silog = j_losses.silog_loss(out["depth"], jnp.asarray(batch["depth"]),
                                    jnp.asarray(batch["mask"]))
        return seg + 0.1 * silog, mutated["batch_stats"]

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    return float(loss), grads, new_stats


def _port_step(cfg, texts, params, stats, batch, frozen=("text_encoder",)):
    model, _ = t_build(cfg, CITYSCAPES_CLASSES, device="cpu")
    load_flax_variables(model, {"params": params, "batch_stats": stats})
    for name, p in model.named_parameters():
        p.requires_grad_(name.split(".")[0] not in frozen)
    out = model(torch.from_numpy(batch["image"]), texts, train=True, gt_hw=CROP,
                gen=torch.Generator().manual_seed(0))
    loss = (t_losses.cross_entropy_loss(out["seg"], torch.from_numpy(batch["seg"]))
            + 0.1 * t_losses.silog_loss(out["depth"], torch.from_numpy(batch["depth"]),
                                        torch.from_numpy(batch["mask"])))
    loss.backward()
    return float(loss.detach()), model


def test_training_step_matches_jax(setup):
    """Loss, the gradient of every trainable leaf (the backbone included: the
    heritage preset trains it), and the BatchNorm running statistics."""
    cfg, jm, texts, params, stats, batch = setup
    want_loss, want_grads, want_stats = _jax_step(jm, texts, params, stats, batch)
    got_loss, model = _port_step(cfg, texts, params, stats, batch)
    assert got_loss == pytest.approx(want_loss, rel=TOL_LOSS)

    want = {k: v.numpy() for k, v in flax_to_state_dict(
        {"params": jax.tree.map(np.asarray, want_grads)}).items()}
    named = dict(model.named_parameters())
    assert set(want) == {n for n, p in named.items() if p.requires_grad}
    unread = set()
    for name, w in want.items():
        g = named[name].grad
        if g is None:  # nothing in the training forward reads it; JAX's gradient is 0
            assert not np.any(w), name
            unread.add(name)
            continue
        rel = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert rel < TOL_GRAD_REL, (name, rel)
    assert unread == {"contexts", "backbone.proj", "global_proj.weight", "global_proj.bias",
                      "vis_proj.weight", "vis_proj.bias"}
    assert named["backbone.transformer.blocks.0.attn.qkv.weight"].grad.abs().sum() > 0

    for key, value in flax_to_state_dict({"batch_stats": jax.tree.map(np.asarray, want_stats)}).items():
        np.testing.assert_allclose(model.state_dict()[key].numpy(), value.numpy(),
                                   rtol=TOL_LOSS, atol=TOL_LOSS, err_msg=key)


def test_batch_norm_training_matches_flax():
    """Batch mean and BIASED variance, momentum 0.9 on the old statistics."""
    x = np.random.RandomState(2).randn(3, 5, 6, 8).astype(np.float32) * 2 + 1
    jm = j_layers.ConvBNReLU(features=16, kernel_size=3)
    variables = jm.init(jax.random.PRNGKey(0), x)
    params, stats = _perturbed({"params": variables["params"],
                                "batch_stats": variables["batch_stats"]}, seed=3)
    want, mutated = jm.apply({"params": params, "batch_stats": stats}, x, train=True,
                             mutable=["batch_stats"])
    tm = load_flax_variables(t_layers.ConvBNReLU(8, 16), {"params": params, "batch_stats": stats})
    got = tm(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    for key in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(tm.bn, f"running_{key}").numpy(), np.asarray(mutated["batch_stats"]["bn"][key]),
            atol=1e-6, rtol=1e-6)
    # the unbiased variance torch's own update would store is not what Flax keeps
    y = tm.conv(torch.from_numpy(x)).detach().reshape(-1, 16)
    assert not np.allclose(0.9 * stats["bn"]["var"] + 0.1 * y.var(0, unbiased=True).numpy(),
                           tm.bn.running_var.numpy(), rtol=1e-6, atol=1e-6)


def test_fcn_head_train_mode_matches_jax_at_dropout_zero():
    x = np.random.RandomState(4).randn(2, 4, 6, 32).astype(np.float32)
    jm = j_heads.FCNHead(in_channels=32, channels=16, num_outputs=5, dropout_ratio=0.0)
    variables = jm.init(jax.random.PRNGKey(0), x)
    params, stats = _perturbed({"params": variables["params"],
                                "batch_stats": variables["batch_stats"]}, seed=5)
    want, _ = jm.apply({"params": params, "batch_stats": stats}, x, train=True,
                       mutable=["batch_stats"])
    tm = load_flax_variables(t_heads.FCNHead(32, 16, 5, dropout_ratio=0.0),
                             {"params": params, "batch_stats": stats})
    got = tm(torch.from_numpy(x), train=True, gen=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_dropout_and_drop_path_semantics():
    x = torch.ones(400, 3, 50)
    gen = torch.Generator().manual_seed(0)
    y = t_layers.dropout(x, 0.1, gen)
    kept = y != 0
    assert 0.88 < float(kept.float().mean()) < 0.92
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    z = t_layers.drop_path(x, 0.25, gen)
    per_sample = z.flatten(1)
    assert ((per_sample == 0).all(1) | (per_sample == 1 / 0.75).all(1)).all()  # whole samples
    assert 0.65 < float((per_sample[:, 0] != 0).float().mean()) < 0.85
    for fn in (t_layers.dropout, t_layers.drop_path):  # deterministic: no generator or rate 0
        assert fn(x, 0.3, None) is x and fn(x, 0.0, gen) is x
    rates = t_layers.Transformer(96, 4, 3, drop_path_rate=0.3).drop_path_rates
    np.testing.assert_allclose(rates, np.linspace(0.0, 0.3, 4), rtol=1e-6)


def test_training_forward_draws_masks_only_in_training(setup):
    cfg, _, texts, params, stats, batch = setup
    cfg = dict(cfg, decode_head=dict(cfg["decode_head"], dropout_ratio=0.5))
    model, _ = t_build(cfg, CITYSCAPES_CLASSES, device="cpu")
    load_flax_variables(model, {"params": params, "batch_stats": stats})
    image = torch.from_numpy(batch["image"])
    with torch.no_grad():
        a = model(image, texts, train=True, gen=torch.Generator().manual_seed(0))["seg"]
        b = model(image, texts, train=True, gen=torch.Generator().manual_seed(1))["seg"]
        c = model(image, texts, train=True, gen=torch.Generator().manual_seed(0))["seg"]
        e1 = model(image, texts, gen=torch.Generator().manual_seed(0))["seg"]
        e2 = model(image, texts)["seg"]
    assert not torch.equal(a, b) and torch.equal(a, c) and torch.equal(e1, e2)
