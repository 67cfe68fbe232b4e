"""fp32 through the attention kernels (K1, K2, K3, K3's backward, K4, K4b).

The JAX package's dispatch asks nothing about the dtype, so under
`tpu.compute_dtype: float32` it runs its Pallas kernels in fp32; the port's
rules now do the same, and its kernels take fp32 (`csrc/attention_fp32.cu`,
`csrc/attention_bwd_fp32.cu`).  Here, on the CPU:

  * the rules against JAX's with both sides believing they run on their
    accelerator (`_on_tpu` / `_on_cuda` patched): fp32 reaches the K1 wrapper
    and `flash_attention` where JAX's kernels serve it, never plain
    attention; another dtype (fp16) raises `TypeError` naming the two;
  * the flagship at a small size (width 128, 2 heads of 64, 2 layers) in
    fp32 with the kernel routes on, against the JAX model on the same
    weights (JAX's kernels in interpret mode): the forward logits and one
    training step's gradients;
  * each plain version in fp32 against JAX's kernel function in interpret
    mode, as `tests/test_mha_kernel.py` runs it.

The fp32 CUDA sources run against these plain versions under the CPU
emulation in `tests/test_torch_cuda_emulated_fp32.py`, and on the card in
`chip_smoke.py` and `tests/test_torch_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from denseclip_vit_multimodal_tpu.models import layers as j_layers
from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.ops import attention as j_attention
from denseclip_vit_multimodal_tpu.ops import mha_kernel as j_mha
from denseclip_vit_multimodal_tpu.train import losses as j_losses
from denseclip_vit_multimodal_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from denseclip_vit_multimodal_tpu_torch.core.config import load_config
from denseclip_vit_multimodal_tpu_torch.models import layers as t_layers
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.ops import attention as t_attention
from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as t_mha
from denseclip_vit_multimodal_tpu_torch.train import losses as t_losses

# ROADMAP's fp32 limits: max abs error and relative L2, port against JAX.
MAX_ABS, REL_L2 = 1e-4, 1e-5


def _assert_close(got, want, what, max_abs=MAX_ABS, rel_l2=REL_L2):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= max_abs and rel <= rel_l2, (what, err, rel)


@pytest.fixture
def on_device(monkeypatch):
    """Both packages' dispatch believes it runs on its accelerator."""
    monkeypatch.setattr(j_attention, "_on_tpu", lambda: True)
    monkeypatch.setattr(t_attention, "_on_cuda", lambda x: True)


# --------------------------------------------------------------------------
# The rules
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "flash", "int8", "xla"])
@pytest.mark.parametrize("n", [577, 1023, 1024, 8448, 8449])
def test_k1_rule_is_jaxs_in_both_dtypes(on_device, impl, n):
    jm = j_layers.MultiHeadAttention(num_heads=2, attn_impl=impl)
    tm = t_layers.MultiHeadAttention(128, 2, attn_impl=impl)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jm._qkv_kernel_applicable(jnp.zeros((1, n, 384), jdt), 128)
        got = tm._qkv_kernel_applicable(torch.zeros(1, n, 384, dtype=tdt), 128)
        assert got == want, (impl, n, tdt)
    floor = 1 if impl in ("flash", "int8") else 1024
    assert got == (impl != "xla" and floor <= n <= 8448)


@pytest.mark.parametrize("n", [1023, 1024, 9000])
def test_flash_supported_is_jaxs_in_both_dtypes(on_device, n):
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = j_attention.flash_supported(jnp.zeros((1, n, 2, 64), jdt))
        got = t_attention.flash_supported(torch.zeros(1, n, 2, 64, dtype=tdt))
        assert got == want == (n >= 1024)


def _refuse_plain(*args, **kwargs):
    raise AssertionError("a kernel-served fp32 call reached plain attention")


@pytest.mark.parametrize("n,valid_len", [(1030, 1025), (8448, 8193)])
def test_fp32_layer_reaches_the_k1_wrapper(on_device, monkeypatch, n, valid_len):
    calls = []
    k1 = t_layers.mha_qkv_attention
    monkeypatch.setattr(t_layers, "mha_qkv_attention",
                        lambda qkv, *a, **kw: calls.append(qkv.dtype) or k1(qkv, *a, **kw))
    monkeypatch.setattr(t_layers, "plain_attention", _refuse_plain)
    tm = t_layers.MultiHeadAttention(128, 2).eval()
    x = torch.from_numpy(np.random.RandomState(n).randn(1, n, 128).astype(np.float32))
    with torch.no_grad():
        out = tm(x, valid_len=valid_len)
    assert calls == [torch.float32] and out.dtype == torch.float32
    assert torch.isfinite(out[:, :valid_len]).all()


@pytest.mark.parametrize("impl", ["auto", "flash"])
@pytest.mark.parametrize("n,causal", [(1100, True), (9000, False)])
def test_fp32_core_reaches_flash_attention(on_device, monkeypatch, impl, n, causal):
    """Causal, or past the one-shot limit: the core's `flash_attention` (K4
    on CUDA), under `auto` and `flash`; never plain attention."""
    calls = []
    flash = t_layers.flash_attention
    monkeypatch.setattr(t_layers, "flash_attention",
                        lambda q, *a, **kw: calls.append(q.dtype) or flash(q, *a, **kw))
    monkeypatch.setattr(t_layers, "plain_attention", _refuse_plain)
    rs = np.random.RandomState(n)
    q, k, v = (torch.from_numpy(rs.randn(1, n, 1, 64).astype(np.float32)) for _ in range(3))
    out = t_layers.attention_core(q, k, v, causal=causal, impl=impl, valid_len=n - 5)
    assert calls == [torch.float32] and torch.isfinite(out[:, : n - 5]).all()


def test_fp16_raises_type_error_naming_the_two_dtypes():
    """Every kernel wrapper refuses fp16 before any launch (on a CPU tensor
    its dtype check runs before the build): under `auto` and `flash` alike
    the rules send a CUDA fp16 tensor to them."""
    h = lambda *shape: torch.zeros(*shape, dtype=torch.float16)
    qkv, q, out, stats = h(1, 64, 384), h(1, 64, 2, 64), h(1, 64, 128), torch.zeros(1, 2, 64, 2)
    before = {**t_mha.LAUNCHES, **t_attention.LAUNCHES}
    calls = [
        lambda: t_mha._launch(qkv, 2, 0.125, 64),
        lambda: t_mha._launch_bwd(qkv, out, out, stats, 2, 0.125, 64),
        lambda: t_mha._launch_mha(q, q, q, 0.125, 64),
        lambda: t_mha._launch_mha_bwd(q, q, q, q, q, stats, 0.125, 64),
        lambda: t_attention._launch(q, q, q, True, 0.125, 64),
        lambda: t_attention._launch_bwd(q, q, q, q, q, stats, True, 0.125, 64),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            call()
    assert {**t_mha.LAUNCHES, **t_attention.LAUNCHES} == before


def test_fp32_names_its_own_launch_counters():
    assert [t_mha.kernel_name(k, torch.float32) for k in ("qkv_attention", "mha_attention_bwd")] \
        == ["qkv_attention_fp32", "mha_attention_bwd_fp32"]
    assert t_mha.kernel_name("flash_attention", torch.bfloat16) == "flash_attention"
    fp32 = {k for k in {**t_mha.LAUNCHES, **t_attention.LAUNCHES} if k.endswith("_fp32")}
    assert fp32 == {"qkv_attention_fp32", "qkv_attention_bwd_fp32", "mha_attention_fp32",
                    "mha_attention_bwd_fp32", "flash_attention_fp32", "flash_attention_bwd_fp32"}


# --------------------------------------------------------------------------
# The small flagship in fp32, kernel routes on, against JAX
# --------------------------------------------------------------------------

CONFIG = "configs/denseclip_vitb16_cityscapes_multitask.yaml"
SMALL = [
    "model.backbone.width=128", "model.backbone.layers=2", "model.backbone.heads=2",
    "model.backbone.out_indices=[0,1]", "model.text_encoder.transformer_layers=1",
    "model.text_encoder.transformer_width=64", "model.text_encoder.transformer_heads=2",
    "model.token_embed_dim=64", "model.neck.inter_channels=16", "model.neck.out_channels=32",
    "model.decode_head.in_channels=32", "model.decode_head.channels=32",
    "model.decode_head.dropout_ratio=0.0", "model.depth_head.in_channels=32",
    "model.depth_head.channels=16", "model.depth_head.dropout_ratio=0.0",
    "tpu.compute_dtype=float32",
]
# 512 x 512: 32 x 32 + 1 = 1025 tokens, padded once to 1152 (the K1 route)
CROP = (512, 512)


@pytest.fixture(scope="module")
def flagship():
    cfg = load_config(CONFIG, overrides=SMALL)
    jm, texts = j_build(cfg.model, CITYSCAPES_CLASSES)
    rs = np.random.RandomState(11)
    image = rs.randn(1, *CROP, 3).astype(np.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(texts))
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rs.randn(*np.shape(a)).astype(np.float32),
                          variables["params"])
    stats = jax.tree.map(lambda a: (rs.rand(*np.shape(a)) + 0.5).astype(np.float32),
                         variables["batch_stats"])
    # depth predictions well above SILog's eps clamp, where d log(p) = 1 / p
    # would let fp32 rounding decide the gradient (PERF.md, PR 2)
    params["depth_head"]["classifier"]["bias"] = np.full_like(
        params["depth_head"]["classifier"]["bias"], 10.0)
    seg = rs.randint(0, 19, (1, *CROP)).astype(np.int32)
    seg[rs.rand(1, *CROP) < 0.1] = 255
    depth = rs.uniform(1.0, 80.0, (1, *CROP)).astype(np.float32)
    depth[rs.rand(1, *CROP) < 0.1] = 0.0
    batch = {"image": image, "seg": seg, "depth": depth, "mask": depth > 0}
    return cfg, jm, texts, params, stats, batch


@pytest.fixture
def kernel_routes(on_device, monkeypatch):
    """Each side's K1 calls counted; JAX's kernels in interpret mode."""
    calls = {"jax": 0, "port": 0}
    j_k1, t_k1 = j_mha.mha_qkv_attention, t_layers.mha_qkv_attention

    def jax_k1(*args, **kwargs):
        calls["jax"] += 1
        return j_k1(*args, **dict(kwargs, interpret=True))

    def port_k1(qkv, *args, **kwargs):
        assert qkv.dtype == torch.float32
        calls["port"] += 1
        return t_k1(qkv, *args, **kwargs)

    monkeypatch.setattr(j_mha, "mha_qkv_attention", jax_k1)
    monkeypatch.setattr(t_layers, "mha_qkv_attention", port_k1)
    monkeypatch.setattr(t_layers, "plain_attention", _refuse_plain)
    return calls


def _port_model(cfg, params, stats, frozen=("text_encoder",)):
    model, _ = t_build(cfg.model, CITYSCAPES_CLASSES, dtype=torch.float32, device="cpu")
    load_flax_variables(model, {"params": params, "batch_stats": stats})
    for name, p in model.named_parameters():
        p.requires_grad_(name.split(".")[0] not in frozen)
    return model


def test_flagship_fp32_forward_matches_jax(flagship, kernel_routes):
    cfg, jm, texts, params, stats, batch = flagship
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(batch["image"]),
                    jnp.asarray(texts))
    model = _port_model(cfg, params, stats).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(batch["image"]), texts)
    assert kernel_routes == {"jax": 2, "port": 2}  # every ViT layer on both sides
    for key in ("seg", "depth"):
        _assert_close(got[key].numpy(), np.asarray(want[key]), key)


def test_flagship_fp32_training_step_matches_jax(flagship, kernel_routes):
    """One training step's loss and every trainable leaf's gradient (the
    backbone's through K1 / K2 on both sides) on the same weights and batch."""
    cfg, jm, texts, params, stats, batch = flagship
    frozen = ("text_encoder",)
    trainable = {k: v for k, v in params.items() if k not in frozen}
    fixed = {k: v for k, v in params.items() if k in frozen}

    def loss_fn(tr):
        out, _ = jm.apply({"params": {**tr, **fixed}, "batch_stats": stats},
                          jnp.asarray(batch["image"]), jnp.asarray(texts), train=True,
                          gt_hw=CROP, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(1)})
        seg = j_losses.cross_entropy_loss(out["seg"], jnp.asarray(batch["seg"]))
        silog = j_losses.silog_loss(out["depth"], jnp.asarray(batch["depth"]),
                                    jnp.asarray(batch["mask"]))
        return seg + 0.1 * silog

    want_loss, want_grads = jax.value_and_grad(loss_fn)(trainable)
    model = _port_model(cfg, params, stats, frozen)
    out = model(torch.from_numpy(batch["image"]), texts, train=True, gt_hw=CROP,
                gen=torch.Generator().manual_seed(0))
    loss = (t_losses.cross_entropy_loss(out["seg"], torch.from_numpy(batch["seg"]))
            + 0.1 * t_losses.silog_loss(out["depth"], torch.from_numpy(batch["depth"]),
                                        torch.from_numpy(batch["mask"])))
    loss.backward()
    assert kernel_routes == {"jax": 2, "port": 2}
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=REL_L2)
    want = {k: v.numpy() for k, v in flax_to_state_dict(
        {"params": jax.tree.map(np.asarray, want_grads)}).items()}
    named = dict(model.named_parameters())
    got = {name: named[name].grad for name in want if named[name].grad is not None}
    assert "backbone.transformer.blocks.0.attn.qkv.weight" in got
    for name, g in got.items():  # measured here: rel. L2 <= 8.9e-6, max abs <= 1e-8
        _assert_close(g.numpy(), want[name], name)


# --------------------------------------------------------------------------
# The plain versions in fp32 against JAX's kernels in interpret mode
# --------------------------------------------------------------------------


def _rand(seed, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("b,n,heads,d,valid_len", [
    (2, 200, 2, 64, None), (1, 300, 2, 128, 250), (1, 1100, 2, 64, 1025)])
def test_plain_k1_and_k2_match_jax_kernels_fp32(b, n, heads, d, valid_len):
    hd = heads * d
    qkv, g = _rand(n + d, (b, n, 3 * hd), (b, n, hd))
    want = j_mha.mha_qkv_attention(jnp.asarray(qkv), heads, interpret=True, valid_len=valid_len)
    x = torch.from_numpy(qkv)
    out = t_mha.mha_qkv_attention_reference(x, heads, valid_len=valid_len)
    rows = n if valid_len is None else valid_len
    _assert_close(out.numpy()[:, :rows], np.asarray(want)[:, :rows], "K1")
    loss = lambda t: jnp.sum(j_mha._qkv_mha(t, heads, d**-0.5, 0, True, valid_len)
                             * jnp.asarray(g))
    want_d = np.asarray(jax.grad(loss)(jnp.asarray(qkv)))
    got_d = t_mha.mha_qkv_attention_bwd_reference(x, out, torch.from_numpy(g), heads,
                                                  valid_len=valid_len).numpy()
    for i, part in enumerate(("dq", "dk", "dv")):
        _assert_close(got_d[..., i * hd:(i + 1) * hd], want_d[..., i * hd:(i + 1) * hd],
                      f"K2 {part}")
    assert not got_d[:, rows:, hd:].any()  # masked keys: dk = dv = 0 exactly


@pytest.mark.parametrize("b,n,heads,d,valid_len", [
    (2, 200, 2, 64, None), (1, 200, 2, 128, 150), (1, 136, 1, 256, 120)])
def test_plain_k3_and_its_backward_match_jax_kernels_fp32(b, n, heads, d, valid_len):
    q, k, v, g = _rand(n * d, *[(b, n, heads, d)] * 4)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = j_mha.mha_attention(jq, jk, jv, interpret=True, valid_len=valid_len)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = t_mha.mha_attention_reference(tq, tk, tv, valid_len=valid_len)
    rows = n if valid_len is None else valid_len
    _assert_close(out.numpy()[:, :rows], np.asarray(want)[:, :rows], "K3")
    loss = lambda a, b_, c: jnp.sum(j_mha.mha_attention(a, b_, c, interpret=True,
                                                        valid_len=valid_len) * jnp.asarray(g))
    want_d = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    got_d = t_mha.mha_attention_bwd_reference(tq, tk, tv, out, torch.from_numpy(g),
                                              valid_len=valid_len)
    for part, a, w in zip(("dq", "dk", "dv"), got_d, want_d):
        _assert_close(a.numpy(), np.asarray(w), f"K3's backward {part}")
    assert not got_d[1][:, rows:].any() and not got_d[2][:, rows:].any()


@pytest.mark.parametrize("d,causal,valid_len", [(64, False, 580), (64, True, None),
                                                (128, True, 580), (256, False, 590)])
def test_plain_k4_and_k4b_match_bundled_kernels_fp32(monkeypatch, d, causal, valid_len):
    """The bundled Pallas kernels in interpret mode (`flash_attention` with
    its one-shot branch switched off); rows and keys below `valid_len`."""
    monkeypatch.setattr(j_attention, "_ONESHOT_MAX_SEQ", 0)
    heads = 1 if d == 256 else 2
    q, k, v, g = _rand(d + causal, *[(1, 600, heads, d)] * 4)
    fn = lambda a, b_, c: j_attention.flash_attention(a, b_, c, causal=causal,
                                                      valid_len=valid_len)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
        want_d = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = t_attention.flash_attention_reference(tq, tk, tv, causal=causal, valid_len=valid_len)
    rows = 600 if valid_len is None else valid_len
    _assert_close(out.numpy()[:, :rows], np.asarray(want)[:, :rows], "K4")
    got_d = t_attention.flash_attention_bwd_reference(tq, tk, tv, out, torch.from_numpy(g),
                                                      causal=causal, valid_len=valid_len)
    for part, a, w in zip(("dq", "dk", "dv"), got_d, want_d):
        _assert_close(a.numpy()[:, :rows], np.asarray(w)[:, :rows], f"K4b {part}")
