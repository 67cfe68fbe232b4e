"""`tpu.remat` in the port (`models/layers.py::resolve_remat_policy` and the
`Transformer`'s recompute), threaded from the training loop, against the
JAX package's remat on one training step; and the port's refusal of the JAX
package's softmax knobs (`DENSECLIP_EXP_BF16`, `DENSECLIP_FAST_EXP2`), which
the port honours where JAX reads them."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.train import losses as j_losses
from denseclip_vit_multimodal_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from denseclip_vit_multimodal_tpu_torch.core.config import load_config
from denseclip_vit_multimodal_tpu_torch.models import layers
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.ops import attention, mha_kernel
from denseclip_vit_multimodal_tpu_torch.train import loop
from denseclip_vit_multimodal_tpu_torch.train import losses as t_losses

# fp32, port with remat against JAX with remat: the same arithmetic in another
# order (tests/test_torch_train_model.py's limits, measured there <= 4e-6).
TOL_LOSS = 1e-5
TOL_GRAD_REL = 1e-4
CROP = (64, 128)


@pytest.mark.parametrize("value,want", [
    (False, None), (None, None), (0, None), (True, "full"), ("full", "full"),
])
def test_resolve_remat_policy(value, want):
    assert layers.resolve_remat_policy(value) == want


@pytest.mark.parametrize("value", ["attn", "attn_qkv", "dots"])
def test_selective_policies_are_not_yet_ported(value, tiny_model_cfg):
    """The JAX package's selective policies raise rather than run as
    something else."""
    with pytest.raises(ValueError, match=f"tpu.remat={value} not yet ported"):
        layers.resolve_remat_policy(value)
    with pytest.raises(ValueError, match="not yet ported"):
        t_build(tiny_model_cfg, CITYSCAPES_CLASSES, device="cpu", remat=value)


@pytest.mark.parametrize("value", ["selective", 2, "ATTN"])
def test_unknown_policies_raise_the_jax_error(value, tiny_model_cfg):
    with pytest.raises(ValueError, match="Unsupported remat mode"):
        layers.resolve_remat_policy(value)
    with pytest.raises(ValueError, match="Unsupported remat mode"):
        t_build(tiny_model_cfg, CITYSCAPES_CLASSES, device="cpu", remat=value)


def _block_grads(remat, seed=3, dtype=torch.float32):
    net = layers.Transformer(64, 3, 2, dtype=dtype, drop_path_rate=0.5,
                             gen=torch.Generator().manual_seed(1), remat=remat)
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 20, 64).astype(np.float32))
    x = x.to(dtype).requires_grad_(True)
    gen = torch.Generator().manual_seed(seed)
    final, taps = net(x, valid_len=18, gen=gen)
    (final.float().square().mean() + taps.float().mean()).backward()
    return [final, taps, x.grad] + [p.grad for p in net.parameters()], gen.get_state()


@pytest.mark.parametrize("policy", [True, "full"])
def test_remat_keeps_outputs_gradients_and_drop_path_masks(policy):
    """Drop path at rate 0.5: the recompute in the backward must see the masks
    the forward drew, so outputs and every gradient are identical, and the
    generator ends where it would without remat."""
    (plain, plain_gen), (remat, remat_gen) = _block_grads(False), _block_grads(policy)
    assert torch.equal(plain_gen, remat_gen)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)
    # the masks do bite: other draws give another output
    assert not torch.equal(_block_grads(policy, seed=4)[0][0], plain[0])


@pytest.mark.parametrize("gen_seed", [0, None])
def test_remat_recomputes_each_block_only_while_autograd_records(gen_seed, monkeypatch):
    """One checkpoint per block, on the training route (a generator) and on
    the inference route alike; none without autograd."""
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    net = layers.Transformer(64, 2, 2, remat=True)
    x = torch.zeros(1, 5, 64, requires_grad=True)
    gen = lambda: None if gen_seed is None else torch.Generator().manual_seed(gen_seed)
    net(x, gen=gen())[0].sum().backward()
    assert calls == [{"use_reentrant": False}] * 2
    with torch.no_grad():
        net(x, gen=gen())
    assert len(calls) == 2


SETS = ["model.backbone.width=96", "model.backbone.layers=2", "model.backbone.heads=3",
        "model.backbone.out_indices=[0,1]", "model.backbone.drop_path_rate=0.2",
        "model.text_encoder.transformer_layers=1", "model.text_encoder.vocab_size=512",
        "model.neck.inter_channels=16", "model.neck.out_channels=32",
        "model.decode_head.in_channels=32", "model.decode_head.channels=32",
        "model.depth_head.in_channels=32", "model.depth_head.channels=16",
        "tpu.compute_dtype=float32", "data.synthetic=true",
        "data.synthetic_options.image_size=[128,256]", "data.synthetic_options.length=4",
        "data.crop_size=[64,128]", "training.batch_size=2", "training.workers=2"]


def test_train_loop_threads_tpu_remat(tmp_path):
    """`train()` reads `tpu.remat`: 2 steps with and without it take the same
    losses (drop path on), every step's seconds land in the log, and an
    unknown policy stops the run before it starts."""
    losses = {}
    for remat in ("false", "true"):
        wd = str(tmp_path / remat)
        cfg = load_config("configs/denseclip_vitb16_640x640_80k.yaml",
                          overrides=SETS + [f"tpu.remat={remat}"])
        loop.train(cfg, wd, max_steps=2, no_validate=True, device="cpu")
        with open(os.path.join(wd, "train_log.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        assert all(r["step_s"] > 0 for r in rows)
        losses[remat] = [r["loss_total"] for r in rows]
    assert losses["true"] == losses["false"] and len(losses["true"]) == 2
    cfg = load_config("configs/denseclip_vitb16_640x640_80k.yaml",
                      overrides=SETS + ["tpu.remat=sometimes"])
    with pytest.raises(ValueError, match="Unsupported remat mode"):
        loop.train(cfg, str(tmp_path / "bad"), max_steps=1, no_validate=True, device="cpu")


@pytest.mark.parametrize("remat", [True, "full"])
def test_training_step_with_remat_matches_jax_with_remat(remat, tiny_model_cfg):
    """One fp32 training step of the port against the JAX package's under the
    same `tpu.remat` policy (`nn.remat` around each scanned block) on the
    same weights: loss and the gradient of every backbone leaf."""
    cfg = dict(tiny_model_cfg)
    cfg["text_encoder"] = dict(cfg["text_encoder"], transformer_layers=1)
    cfg["decode_head"] = dict(cfg["decode_head"], dropout_ratio=0.0)
    cfg["depth_head"] = dict(cfg["depth_head"], dropout_ratio=0.0)
    jm, texts = j_build(cfg, CITYSCAPES_CLASSES, remat=remat)
    rs = np.random.RandomState(7)
    image = rs.randn(2, *CROP, 3).astype(np.float32)
    seg = rs.randint(0, 19, (2, *CROP)).astype(np.int32)
    depth = rs.uniform(1.0, 80.0, (2, *CROP)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(texts))
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rs.randn(*np.shape(a)).astype(np.float32),
                          variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    params["depth_head"]["classifier"]["bias"] = np.full_like(  # depth well above SILog's clamp
        params["depth_head"]["classifier"]["bias"], 10.0)

    def j_loss(bb):
        out, _ = jm.apply({"params": {**params, "backbone": bb}, "batch_stats": stats},
                          jnp.asarray(image), jnp.asarray(texts), train=True, gt_hw=CROP,
                          mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
        return (j_losses.cross_entropy_loss(out["seg"], jnp.asarray(seg)) + 0.1
                * j_losses.silog_loss(out["depth"], jnp.asarray(depth), jnp.asarray(depth > 0)))

    want_loss, want_grads = jax.jit(jax.value_and_grad(j_loss))(params["backbone"])

    model, _ = t_build(cfg, CITYSCAPES_CLASSES, device="cpu", remat=remat)
    assert model.backbone.transformer.remat == layers.resolve_remat_policy(remat)
    load_flax_variables(model, {"params": params, "batch_stats": stats})
    for name, p in model.named_parameters():
        p.requires_grad_(name.startswith("backbone."))
    out = model(torch.from_numpy(image), texts, train=True, gt_hw=CROP,
                gen=torch.Generator().manual_seed(0))
    loss = (t_losses.cross_entropy_loss(out["seg"], torch.from_numpy(seg))
            + 0.1 * t_losses.silog_loss(out["depth"], torch.from_numpy(depth),
                                        torch.from_numpy(depth > 0)))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=TOL_LOSS)
    want = flax_to_state_dict({"params": {"backbone": jax.tree.map(np.asarray, want_grads)}})
    named = dict(model.named_parameters())
    for name, w in want.items():
        g = named[name].grad
        if g is None:  # `proj`: nothing in the dense forward reads it
            assert not np.any(w.numpy()), name
            continue
        rel = np.linalg.norm(g.numpy() - w.numpy()) / max(np.linalg.norm(w.numpy()), 1e-30)
        assert rel < TOL_GRAD_REL, (name, rel)


@pytest.mark.parametrize("knob", ["DENSECLIP_EXP_BF16", "DENSECLIP_FAST_EXP2"])
def test_softmax_knobs_are_refused_where_jax_reads_them(knob, monkeypatch):
    """Where the JAX package reads a softmax knob (K1, K2, K3; the int8
    backward and K7 read DENSECLIP_FAST_EXP2 only), the port no longer
    refuses it: each wrapper reaches the plain version in the knob's mode
    (`softmax_modes`; the kernels' variants on the card), which moves its
    output; the bundled flash kernel (K4) and int8 inference (K5) read
    neither and stay bitwise the same."""
    rs = np.random.RandomState(0)
    qkv = torch.from_numpy(rs.randn(1, 20, 3 * 128).astype(np.float32)).to(torch.bfloat16)
    q, k, v = (t.view(1, 20, 2, 64) for t in qkv.split(128, dim=-1))
    mode = {"DENSECLIP_EXP_BF16": mha_kernel.EXP_BF16,
            "DENSECLIP_FAST_EXP2": mha_kernel.EXP_POLY}[knob]
    monkeypatch.setenv(knob, "0")
    off = (mha_kernel.mha_qkv_attention(qkv, 2, valid_len=18), mha_kernel.mha_attention(q, k, v),
           attention.flash_attention(q, k, v, causal=True),
           mha_kernel.mha_qkv_attention_int8(qkv, 2))
    monkeypatch.setenv(knob, "1")
    k1 = mha_kernel.mha_qkv_attention(qkv, 2, valid_len=18)
    assert torch.equal(k1, mha_kernel.mha_qkv_attention_reference(qkv, 2, valid_len=18,
                                                                  exp_mode=mode))
    assert not torch.equal(k1, off[0])
    k3 = mha_kernel.mha_attention_reference(q, k, v, exp_mode=mode)
    assert torch.equal(mha_kernel.mha_attention(q, k, v), k3)
    assert torch.equal(attention.flash_attention(q, k, v), k3)  # the K3 branch
    assert torch.equal(attention.flash_attention(q, k, v, causal=True), off[2])  # K4
    assert torch.equal(mha_kernel.mha_qkv_attention_int8(qkv, 2), off[3])  # K5 reads neither
    grad = qkv.float().clone().requires_grad_(True)  # the int8 backward: K1 + K2 in fp32
    mha_kernel.mha_qkv_attention_int8(grad, 2, valid_len=18).sum().backward()
    bwd_mode = mha_kernel.EXP_POLY if knob == "DENSECLIP_FAST_EXP2" else mha_kernel.EXP_EXACT
    out = mha_kernel.mha_qkv_attention_reference(grad.detach(), 2, valid_len=18, exp_mode=bwd_mode)
    want = mha_kernel.mha_qkv_attention_bwd_reference(grad.detach(), out, torch.ones_like(out), 2,
                                                      valid_len=18, exp_mode=bwd_mode)
    assert torch.equal(grad.grad, want)
