"""`attn_impl: flash` in the port (`models/layers.py`) against the JAX package's
rule, "on the TPU" read as "on CUDA": the dispatch decisions of the fused-qkv
branch (K1 at any N up to 8448, no 1024-token floor) and of the fused
LN + qkv branch (K6) at N below and above 1024 and above 8448; every call
that reaches `attention_core` goes to `flash_attention` on CUDA and to the
`auto` rules off it; a CUDA fp32 tensor takes the fp32 kernels as JAX's
does, and another dtype than bf16 or fp32 raises `TypeError`; `ring` is a
known name and an unknown one raises; and one bf16 layer under `flash` against the JAX layer, whose K1
runs in Pallas interpret mode.

The tests mark tensors as on CUDA by patching `ops.attention._on_cuda`, and
the JAX side as on the TPU by patching its `_on_tpu`, as the other dispatch
tests do; the port's wrappers then run their kernels' plain versions on the
CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.models import layers as j_layers
from denseclip_vit_multimodal_tpu.ops import attention as j_attention
from denseclip_vit_multimodal_tpu.ops import mha_kernel as jax_mha
from denseclip_vit_multimodal_tpu_torch.convert import load_flax_variables
from denseclip_vit_multimodal_tpu_torch.core.config import load_config
from denseclip_vit_multimodal_tpu_torch.models import layers as t_layers
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES, build_denseclip
from denseclip_vit_multimodal_tpu_torch.ops import attention as t_attention

# bf16 K1 (plain version) against the JAX kernel in interpret mode: q, P and
# the output rounded to bf16 (tests/test_torch_oneshot_attention.py)
BF16_MAX, BF16_REL = 2e-2, 1e-2


@pytest.fixture
def on_device(monkeypatch):
    monkeypatch.setattr(j_attention, "_on_tpu", lambda: True)
    monkeypatch.setattr(t_attention, "_on_cuda", lambda x: True)


@pytest.mark.parametrize("impl", ["flash", "auto", "int8", "xla"])
@pytest.mark.parametrize("n", [40, 577, 1023, 1024, 1522, 8448, 8449, 25089])
@pytest.mark.parametrize("dim,heads", [(768, 12), (1024, 16), (192, 2)])
def test_qkv_branch_decision_is_jaxs(on_device, impl, n, dim, heads):
    """K1 (K5 under int8) takes the fused projection exactly where JAX's
    `_qkv_kernel_applicable` holds (head dim 96: not `qkv_supported`)."""
    jm = j_layers.MultiHeadAttention(num_heads=heads, attn_impl=impl)
    tm = t_layers.MultiHeadAttention(dim, heads, attn_impl=impl)
    want = jm._qkv_kernel_applicable(jnp.zeros((1, n, 3 * dim)), dim)
    got = tm._qkv_kernel_applicable(torch.empty(1, n, 3 * dim, dtype=torch.bfloat16), dim)
    assert got == want
    if impl == "flash":
        assert got == (n <= 8448 and dim // heads in (64, 128))


@pytest.mark.parametrize("n", [577, 1522, 8449])
def test_qkv_branch_off_the_device_is_never_taken(monkeypatch, n):
    monkeypatch.setattr(j_attention, "_on_tpu", lambda: False)
    jm = j_layers.MultiHeadAttention(num_heads=12, attn_impl="flash")
    tm = t_layers.MultiHeadAttention(768, 12, attn_impl="flash")
    assert not jm._qkv_kernel_applicable(jnp.zeros((1, n, 2304)), 768)
    assert not tm._qkv_kernel_applicable(torch.empty(1, n, 2304, dtype=torch.bfloat16), 768)


@pytest.mark.parametrize("n", [197, 577, 1522, 8449])
def test_fused_lnqkv_branch_decision_is_jaxs(on_device, monkeypatch, n):
    """K6 follows K1's `flash` regime, as JAX's `_lnqkv_applicable` does."""
    monkeypatch.setenv("DENSECLIP_FUSED_LNQKV", "1")
    jm = j_layers.MultiHeadAttention(num_heads=12, attn_impl="flash")
    tm = t_layers.MultiHeadAttention(768, 12, attn_impl="flash")
    want = jm._lnqkv_applicable(jnp.zeros((1, n, 768)), 768)
    assert tm._lnqkv_applicable(torch.empty(1, n, 768, dtype=torch.bfloat16), 768) == want


@pytest.fixture
def recorded(monkeypatch):
    """Which core each side's `attention_core` ran (the kernels' calls are
    recorded and answered by plain attention)."""
    calls = {"jax": [], "port": []}

    def j_flash(q, k, v, causal, valid_len=None):
        calls["jax"].append(("flash", q.shape[1], causal))
        return j_layers._xla_attention(q, k, v, causal, valid_len)

    def t_flash(q, k, v, causal=False, valid_len=None):
        calls["port"].append(("flash", q.shape[1], causal))
        return t_attention.plain_attention(q, k, v, causal, valid_len)

    monkeypatch.setattr(j_layers, "_flash_attention", j_flash)
    monkeypatch.setattr(t_layers, "flash_attention", t_flash)
    return calls


@pytest.mark.parametrize("device", [True, False])
@pytest.mark.parametrize("n,causal", [(22, True), (300, False), (1100, True), (8449, False)])
def test_attention_core_under_flash_is_jaxs(monkeypatch, recorded, device, n, causal):
    """On the device every call reaching the core takes flash attention (K3 or
    K4 behind it); off it, `flash` is `auto` (plain here: CPU tensors)."""
    monkeypatch.setattr(j_attention, "_on_tpu", lambda: device)
    monkeypatch.setattr(t_attention, "_on_cuda", lambda x: device)
    rs = np.random.RandomState(n)
    q, k, v = (rs.randn(1, n, 2, 64).astype(np.float32) for _ in range(3))
    if device:  # the port's kernels take bf16 on CUDA
        tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    else:
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    j_layers.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                            impl="flash")
    t_layers.attention_core(tq, tk, tv, causal=causal, impl="flash")
    assert recorded["port"] == recorded["jax"] == ([("flash", n, causal)] if device else [])


def test_fp32_on_cuda_under_flash_raises(on_device, monkeypatch):
    """JAX runs its kernels in fp32 there, and so does the port: an fp32
    layer under `flash` takes the K1 wrapper (its fp32 kernel on CUDA) and
    the core takes `flash_attention` (past the one-shot limit: K4's fp32
    kernel), never plain attention; a dtype the kernels do not take (fp16)
    raises `TypeError` naming the two they take."""
    routes = []
    k1, flash = t_layers.mha_qkv_attention, t_layers.flash_attention
    monkeypatch.setattr(t_layers, "mha_qkv_attention",
                        lambda qkv, *a, **kw: routes.append(("k1", qkv.dtype)) or k1(qkv, *a, **kw))
    monkeypatch.setattr(t_layers, "flash_attention",
                        lambda q, *a, **kw: routes.append(("flash", q.dtype)) or flash(q, *a, **kw))

    def no_plain(*args, **kwargs):
        raise AssertionError("an fp32 call under flash reached plain attention")

    monkeypatch.setattr(t_layers, "plain_attention", no_plain)
    tm = t_layers.MultiHeadAttention(128, 2, attn_impl="flash").eval()
    x = torch.randn(1, 40, 128)
    with torch.no_grad():
        assert torch.isfinite(tm(x)).all()
    q = torch.randn(1, 9000, 1, 64)  # past the one-shot limit: the core's K4 branch
    assert torch.isfinite(t_layers.attention_core(q, q, q, impl="flash")).all()
    assert routes == [("k1", torch.float32), ("flash", torch.float32)]
    with pytest.raises(TypeError, match="bfloat16 or float32"):  # K4's wrapper, before a launch
        t_attention._launch(q.half(), q.half(), q.half(), False, 0.125, 9000)


def test_fp32_off_cuda_under_flash_runs_auto(monkeypatch):
    tm = t_layers.MultiHeadAttention(128, 2, attn_impl="flash").eval()
    ref = t_layers.MultiHeadAttention(128, 2, attn_impl="auto").eval()
    ref.load_state_dict(tm.state_dict())
    x = torch.randn(1, 40, 128)
    with torch.no_grad():
        assert torch.equal(tm(x), ref(x))


def test_impl_names_and_ring_still_raises():
    """`ring` is a name the port takes now (one process: `auto`; over a
    group it raises, `tests/test_torch_ring_fallback.py`); a name neither
    package has still raises."""
    assert t_layers.ATTN_IMPLS == ("auto", "xla", "int8", "flash", "ring")
    tm = t_layers.MultiHeadAttention(128, 2)
    t_layers.set_attn_impl(tm, "flash")
    assert tm.attn_impl == "flash"
    t_layers.set_attn_impl(tm, "ring")
    assert t_layers.MultiHeadAttention(128, 2, attn_impl="ring").attn_impl == "ring"
    with pytest.raises(ValueError, match="not yet ported"):
        t_layers.set_attn_impl(tm, "sparse")
    with pytest.raises(ValueError, match="not yet ported"):
        t_layers.MultiHeadAttention(128, 2, attn_impl="sparse")


def test_only_the_vit_reads_attn_impl():
    """As in the JAX builder: the text tower keeps plain attention."""
    cfg = load_config("configs/denseclip_vitb16_cityscapes_multitask.yaml", overrides=[
        "model.backbone.width=64", "model.backbone.layers=1", "model.backbone.heads=1",
        "model.backbone.out_indices=[0]", "model.text_encoder.transformer_layers=1",
        "model.text_encoder.transformer_width=64", "model.text_encoder.transformer_heads=1",
        "model.token_embed_dim=64", "model.neck.inter_channels=16", "model.neck.out_channels=32",
        "model.decode_head.in_channels=32", "model.decode_head.channels=32",
        "model.depth_head.in_channels=32", "model.depth_head.channels=16"])
    model, _ = build_denseclip(cfg.model, CITYSCAPES_CLASSES, attn_impl="flash", device="cpu")
    impls = lambda m: {a.attn_impl for a in m.modules()
                       if isinstance(a, t_layers.MultiHeadAttention)}
    assert impls(model.backbone) == {"flash"}
    assert impls(model.text_encoder) == {"xla"}


@pytest.mark.parametrize("n,valid_len", [(40, None), (577, None), (300, 290)])
def test_flash_layer_matches_jax_in_bf16(on_device, monkeypatch, n, valid_len):
    """A bf16 layer under `flash` below 1024 tokens: K1 on both sides (the
    port's plain version, JAX's kernel in interpret mode), where `auto`
    would take plain attention."""
    calls = {"jax": 0}
    j_k1 = jax_mha.mha_qkv_attention

    def interpret(*args, **kwargs):
        calls["jax"] += 1
        return j_k1(*args, **dict(kwargs, interpret=True))

    monkeypatch.setattr(jax_mha, "mha_qkv_attention", interpret)
    x = np.random.RandomState(n).randn(2, n, 128).astype(np.float32)
    jm = j_layers.MultiHeadAttention(num_heads=2, attn_impl="flash", dtype=jnp.bfloat16)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    calls["jax"] = 0
    want = np.asarray(jm.apply(variables, jnp.asarray(x), valid_len=valid_len)
                      .astype(jnp.float32))
    tm = t_layers.MultiHeadAttention(128, 2, attn_impl="flash", dtype=torch.bfloat16)
    load_flax_variables(tm, jax.tree.map(np.asarray, dict(variables))).eval()
    before = dict(calls)
    seen = []
    t_k1 = t_layers.mha_qkv_attention
    monkeypatch.setattr(t_layers, "mha_qkv_attention",
                        lambda *a, **kw: seen.append(a[0].shape) or t_k1(*a, **kw))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), valid_len=valid_len).float().numpy()
    assert before == {"jax": 1} and seen == [(2, n, 384)]
    rows = n if valid_len is None else valid_len
    err = np.abs(got[:, :rows] - want[:, :rows])
    assert err.max() <= BF16_MAX
    assert np.linalg.norm(got[:, :rows] - want[:, :rows]) / np.linalg.norm(want[:, :rows]) \
        <= BF16_REL
