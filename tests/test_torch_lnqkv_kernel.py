"""The fused LayerNorm + QKV + attention K6 of the port (`ops/lnqkv_kernel.py`:
its plain version, the autograd binding, the rule; the fused branch of
`models/layers.py`; the flagship slide path with `DENSECLIP_FUSED_LNQKV=1`)
against the JAX package, whose Pallas kernel runs here in interpret mode (as
`tests/test_lnqkv_kernel.py` runs it).  The CUDA kernel itself is held
against the same plain version on the card by `chip_smoke.py` and
`tests/test_torch_cuda.py`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.infer.engine import Inferencer as JInferencer
from denseclip_vit_multimodal_tpu.models import layers as j_layers
from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.ops import attention as j_attention
from denseclip_vit_multimodal_tpu.ops import lnqkv_kernel as j_lnqkv
from denseclip_vit_multimodal_tpu.ops import mha_kernel as j_mha
from denseclip_vit_multimodal_tpu_torch.convert import load_flax_variables
from denseclip_vit_multimodal_tpu_torch.core.config import load_config
from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer as TInferencer
from denseclip_vit_multimodal_tpu_torch.models import layers as t_layers
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.ops import attention as t_attention
from denseclip_vit_multimodal_tpu_torch.ops import lnqkv_kernel as t_lnqkv

B, N, D, H = 2, 300, 128, 2  # the JAX package's own test inputs
SCALE = 64**-0.5
# fp32: the same one-pass arithmetic in another order (JAX's kernel-vs-
# reference limit).  bf16: K1's limits (LN(x), q/k/v, P and the output are
# rounded to bf16 at the same points on both sides).
FP32_TOL = 2e-5
BF16_MAX, BF16_REL = 2e-2, 5e-3
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.RandomState(0)  # tests/test_lnqkv_kernel.py's fixture
    return (
        rng.randn(B, N, D).astype(np.float32),
        rng.rand(D).astype(np.float32) + 0.5,
        rng.randn(D).astype(np.float32) * 0.1,
        rng.randn(D, 3 * D).astype(np.float32) * 0.05,
        rng.randn(3 * D).astype(np.float32) * 0.01,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid_len", [None, 250])
def test_plain_version_matches_jax_kernel(dtype, valid_len):
    x, gamma, beta, w, bias = _inputs()
    jdt, tdt = DTYPES[dtype]
    want = j_lnqkv.ln_qkv_attention(jnp.asarray(x).astype(jdt), gamma, beta, w, bias, H,
                                    interpret=True, valid_len=valid_len)
    got = t_lnqkv.ln_qkv_attention_reference(
        torch.from_numpy(x).to(tdt), *(torch.from_numpy(a) for a in (gamma, beta, w, bias)), H,
        valid_len=valid_len)
    assert got.dtype == tdt and tuple(got.shape) == (B, N, D)
    rows = N if valid_len is None else valid_len  # later rows are left to the caller
    got = got.float().numpy()[:, :rows]
    want = np.asarray(want.astype(jnp.float32))[:, :rows]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_MAX
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= BF16_REL


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    before = dict(t_lnqkv.LAUNCHES)
    args = [torch.from_numpy(a) for a in _inputs()]
    args[0] = args[0].to(torch.bfloat16)
    out = t_lnqkv.ln_qkv_attention(*args, H, valid_len=299)
    assert torch.equal(out, t_lnqkv.ln_qkv_attention_reference(*args, H, valid_len=299))
    assert t_lnqkv.LAUNCHES == before


@pytest.mark.parametrize("case", ["x", "w", "heads", "valid_len", "device"])
def test_wrapper_raises(case):
    x, gamma, beta, w, bias = (torch.from_numpy(a) for a in _inputs())
    if case == "x":
        with pytest.raises(ValueError, match=r"\[B, N, D\]"):
            t_lnqkv.ln_qkv_attention(x[0], gamma, beta, w, bias, H)
    elif case == "w":
        with pytest.raises(ValueError, match="W"):
            t_lnqkv.ln_qkv_attention(x, gamma, beta, w.t(), bias, H)
    elif case == "heads":
        with pytest.raises(ValueError, match="divisible"):
            t_lnqkv.ln_qkv_attention(x, gamma, beta, w, bias, 3)
    elif case == "valid_len":
        with pytest.raises(ValueError, match="valid_len"):
            t_lnqkv.ln_qkv_attention(x, gamma, beta, w, bias, H, valid_len=301)
    else:
        with pytest.raises(ValueError, match="no fused LN"):
            t_lnqkv.ln_qkv_attention(x.to("meta"), gamma, beta, w, bias, H)


@pytest.mark.parametrize("dim", [128, 192, 256, 768, 1024])
def test_lnqkv_supported_matches_jax(dim):
    for heads in (1, 2, 3, 4, 6, 8, 12, 16):
        for n in (0, 1, 300, 1536, 3968, 3969, 4096, 8193, 8448):
            assert t_lnqkv.lnqkv_supported(heads, dim, n) == j_lnqkv.lnqkv_supported(heads, dim, n)


def test_lnqkv_supported_limits():
    """At the flagship's width the residency limit admits padded N <= 3968:
    every slide window (1522 tokens), never the 8193-token whole frame."""
    assert t_lnqkv.lnqkv_supported(12, 768, 1536) and t_lnqkv.lnqkv_supported(12, 768, 3968)
    assert not t_lnqkv.lnqkv_supported(12, 768, 3969)
    assert not t_lnqkv.lnqkv_supported(12, 768, 8193)
    assert t_lnqkv.lnqkv_supported(6, 768, 1536)  # head dim 128
    assert not t_lnqkv.lnqkv_supported(8, 768)  # head dim 96


@pytest.mark.parametrize("arg", ["x", "gamma", "beta", "w", "bias"])
def test_grad_matches_jax_reference_vjp(arg):
    """The backward of the autograd binding (the VJP of `lnqkv_reference`)
    against `jax.grad` of the JAX `_lnqkv_reference`, fp32, with JAX's
    `test_grad_parity` tolerances."""
    names = ["x", "gamma", "beta", "w", "bias"]
    i = names.index(arg)
    inputs = _inputs()
    loss = lambda *a: jnp.sum(j_lnqkv._lnqkv_reference(*a, H, SCALE, 1e-5) ** 2)
    want = np.asarray(jax.grad(loss, argnums=i)(*(jnp.asarray(a) for a in inputs)))
    args = [torch.from_numpy(a.copy()) for a in inputs]
    args[i].requires_grad_(True)
    before = dict(t_lnqkv.LAUNCHES)
    out = t_lnqkv.ln_qkv_attention(*args, H)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("LNQKVAttention")
    (out**2).sum().backward()
    assert t_lnqkv.LAUNCHES == before
    assert all(a.grad is None for j, a in enumerate(args) if j != i)
    np.testing.assert_allclose(args[i].grad.numpy(), want, rtol=2e-4, atol=2e-5)


# --------------------------------------------------------------------------
# models/layers.py: the fused branch
# --------------------------------------------------------------------------


@pytest.fixture
def fused_here(monkeypatch):
    """DENSECLIP_FUSED_LNQKV=1; both packages' dispatch believes it runs on
    its accelerator; the JAX kernels run in interpret mode; each side records
    its K6, int8 and K1 calls."""
    monkeypatch.setenv("DENSECLIP_FUSED_LNQKV", "1")
    monkeypatch.setattr(j_attention, "_on_tpu", lambda: True)
    monkeypatch.setattr(t_attention, "_on_cuda", lambda x: True)
    calls = {"jax": 0, "port": 0, "jax_int8": 0, "port_int8": 0, "jax_k1": 0, "port_k1": 0}

    def wrap(module, name, key, **extra):
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **dict(kwargs, **extra))

        monkeypatch.setattr(module, name, counted)

    wrap(j_lnqkv, "ln_qkv_attention", "jax", interpret=True)
    wrap(t_layers, "ln_qkv_attention", "port")
    wrap(j_mha, "mha_qkv_attention_int8", "jax_int8", interpret=True)
    wrap(t_layers, "mha_qkv_attention_int8", "port_int8")
    wrap(j_mha, "mha_qkv_attention", "jax_k1", interpret=True)
    wrap(t_layers, "mha_qkv_attention", "port_k1")
    return calls


def _blocks(x, impl="auto"):
    jb = j_layers.ResidualAttentionBlock(num_heads=2, attn_impl=impl)
    variables = jb.init(jax.random.PRNGKey(0), x)
    tb = t_layers.ResidualAttentionBlock(x.shape[-1], 2, attn_impl=impl)
    load_flax_variables(tb, jax.tree.map(np.asarray, dict(variables)))
    return jb, variables, tb.eval()


@pytest.mark.parametrize("valid_len", [None, 1050])
def test_fused_block_matches_jax(fused_here, monkeypatch, valid_len):
    """The inference block with the variable on: 1100 tokens of width 128 (2
    heads of 64) are in K1's regime, so both sides take the fused branch."""
    x = np.random.RandomState(5).randn(1, 1100, 128).astype(np.float32)
    jb, variables, tb = _blocks(x)
    for key in fused_here:  # init ran the block once
        fused_here[key] = 0
    want = np.asarray(jb.apply(variables, x, valid_len=valid_len))
    with torch.no_grad():
        got = tb(torch.from_numpy(x), valid_len=valid_len).numpy()
    assert fused_here == {"jax": 1, "port": 1, "jax_int8": 0, "port_int8": 0, "jax_k1": 0,
                          "port_k1": 0}
    rows = 1100 if valid_len is None else valid_len
    # fp32 on both sides: the same K6 arithmetic in another order
    np.testing.assert_allclose(got[:, :rows], want[:, :rows], atol=1e-4, rtol=1e-4)
    # and the fused branch agrees with the unfused one (JAX's own limit)
    monkeypatch.setenv("DENSECLIP_FUSED_LNQKV", "0")
    with torch.no_grad():
        unfused = tb(torch.from_numpy(x), valid_len=valid_len).numpy()
    assert fused_here["port"] == 1
    np.testing.assert_allclose(got[:, :rows], unfused[:, :rows], atol=2e-3, rtol=2e-3)


def test_int8_with_fused_takes_k6_on_both_sides(fused_here):
    """JAX checks the fused branch before the K1 / K5 route: under `int8`
    with the variable on, K6 runs (unquantized), with int8's regime (no
    1024-token floor)."""
    x = np.random.RandomState(6).randn(2, 40, 128).astype(np.float32)
    jb, variables, tb = _blocks(x, impl="int8")
    for key in fused_here:
        fused_here[key] = 0
    want = np.asarray(jb.apply(variables, x))
    with torch.no_grad():
        got = tb(torch.from_numpy(x)).numpy()
    assert fused_here == {"jax": 1, "port": 1, "jax_int8": 0, "port_int8": 0, "jax_k1": 0,
                          "port_k1": 0}
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_training_block_never_takes_k6(fused_here, monkeypatch):
    """With a generator (the JAX block's training branch) the block applies
    ln_1 itself and never hands it to the attention."""
    x = np.random.RandomState(7).randn(1, 1100, 128).astype(np.float32)
    jb, variables, tb = _blocks(x)
    for key in fused_here:
        fused_here[key] = 0
    jb.apply(variables, x, drop_path_rate=0.1, deterministic=False,
             rngs={"dropout": jax.random.PRNGKey(1)})
    with torch.no_grad():
        trained = tb(torch.from_numpy(x), drop_path_rate=0.0, gen=torch.Generator().manual_seed(0))
    assert fused_here["jax"] == fused_here["port"] == 0
    assert fused_here["jax_k1"] == 1  # JAX's training block takes K1 (the port's fp32: plain)
    # rate 0 keeps every branch: the unfused inference block's answer, bit for bit
    monkeypatch.setenv("DENSECLIP_FUSED_LNQKV", "0")
    with torch.no_grad():
        assert torch.equal(trained, tb(torch.from_numpy(x)))


@pytest.mark.parametrize("n,impl,causal,heads,env,on_cuda,want", [
    (1536, "auto", False, 12, "1", True, True),  # a slide window
    (3968, "auto", False, 12, "1", True, True),  # the largest N the rule admits at D 768
    (3969, "auto", False, 12, "1", True, False),  # the TPU residency limit
    (8320, "auto", False, 12, "1", True, False),  # the whole frame: unfused (K1)
    (1000, "auto", False, 12, "1", True, False),  # below the auto floor
    (40, "int8", False, 12, "1", True, True),  # no floor under int8
    (1536, "xla", False, 12, "1", True, False),
    (1536, "auto", True, 12, "1", True, False),  # causal
    (1536, "auto", False, 8, "1", True, False),  # head dim 96
    (1536, "auto", False, 12, "0", True, False),  # opt-in
    (1536, "auto", False, 12, None, True, False),
    (1536, "auto", False, 12, "1", False, False),  # a CPU tensor: no kernel
])
def test_fused_rule(monkeypatch, n, impl, causal, heads, env, on_cuda, want):
    if env is None:
        monkeypatch.delenv("DENSECLIP_FUSED_LNQKV", raising=False)
    else:
        monkeypatch.setenv("DENSECLIP_FUSED_LNQKV", env)
    if on_cuda:
        monkeypatch.setattr(t_attention, "_on_cuda", lambda x: True)
    tm = t_layers.MultiHeadAttention(768, heads, causal=causal, attn_impl=impl)
    assert tm._lnqkv_applicable(torch.empty(1, n, 768), 768) is want


def test_fused_rule_reads_the_environment_on_every_call(monkeypatch):
    monkeypatch.setattr(t_attention, "_on_cuda", lambda x: True)
    tm = t_layers.MultiHeadAttention(128, 2)
    x = torch.empty(1, 1100, 128)
    monkeypatch.setenv("DENSECLIP_FUSED_LNQKV", "1")
    assert tm._lnqkv_applicable(x, 128)
    monkeypatch.setenv("DENSECLIP_FUSED_LNQKV", "0")
    assert not tm._lnqkv_applicable(x, 128)


# --------------------------------------------------------------------------
# The slice as a whole: slide inference of a tiny flagship
# --------------------------------------------------------------------------

CONFIG = "configs/denseclip_vitb16_cityscapes_multitask.yaml"
TINY = [
    "model.backbone.width=128", "model.backbone.layers=2", "model.backbone.heads=2",
    "model.backbone.out_indices=[0,1]", "model.text_encoder.transformer_layers=1",
    "model.text_encoder.transformer_width=64", "model.text_encoder.transformer_heads=2",
    "model.token_embed_dim=64",
    "model.neck.inter_channels=16", "model.neck.out_channels=32",
    "model.decode_head.in_channels=32", "model.decode_head.channels=32",
    "model.depth_head.in_channels=32", "model.depth_head.channels=16",
    "tpu.compute_dtype=float32",
]
# crop 512: 32 x 32 + 1 = 1025 tokens, padded once to 1152 (above the auto floor)
FRAME, CROP, STRIDE = (512, 768), (512, 512), (256, 256)
# fp32 end to end; measured 1.16e-6 (seg logits) and 1.48e-6 (depth) on the CPU
SLICE_TOL = 1e-4


@pytest.fixture(scope="module")
def flagship():
    cfg = load_config(CONFIG, overrides=TINY)
    jm, texts = j_build(cfg.model, CITYSCAPES_CLASSES)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1,) + CROP + (3,)),
                                 jnp.asarray(texts))
    rs = np.random.RandomState(3)
    variables = {  # running statistics away from the identity
        "params": jax.tree.map(np.asarray, variables["params"]),
        "batch_stats": jax.tree.map(lambda a: (rs.rand(*a.shape) + 0.5).astype(np.float32),
                                    variables["batch_stats"]),
    }
    tm, _ = t_build(cfg.model, CITYSCAPES_CLASSES, device="cpu")
    load_flax_variables(tm, variables)
    frame = np.random.RandomState(4).randint(0, 256, (1,) + FRAME + (3,), dtype=np.uint8)
    return jm, variables, tm, texts, frame


def test_fused_slide_inference_matches_jax(flagship, fused_here):
    jm, variables, tm, texts, frame = flagship
    kw = dict(mode="slide", crop=CROP, stride=STRIDE, window_batch=2, fetch="logits")
    want = JInferencer(jm, variables, texts, num_classes=19, with_depth=True).predict(frame, **kw)
    got = TInferencer(tm, texts, num_classes=19).predict(frame, **kw)
    assert fused_here["port"] == 2 and fused_here["jax"] >= 1  # every ViT layer, each side
    assert fused_here["jax_int8"] == fused_here["port_int8"] == 0
    assert got["seg_logits"].shape == (1,) + FRAME + (19,)
    for key in ("seg_logits", "depth"):
        rel = np.linalg.norm(got[key] - want[key]) / np.linalg.norm(want[key])
        assert rel <= SLICE_TOL, (key, rel)


def test_fused_slide_inference_fp32_within_the_fp32_limits(flagship, fused_here):
    """The same fp32 frame through K6 on both sides (the port's K6 plain
    version, which the fp32 K6 kernel is held to on the card), within the
    fp32 limits: max abs 1e-4 and relative L2 1e-5 on the seg logits and
    the depth."""
    jm, variables, tm, texts, frame = flagship
    kw = dict(mode="slide", crop=CROP, stride=STRIDE, window_batch=2, fetch="logits")
    want = JInferencer(jm, variables, texts, num_classes=19, with_depth=True).predict(frame, **kw)
    got = TInferencer(tm, texts, num_classes=19).predict(frame, **kw)
    assert fused_here["port"] >= 2 and fused_here["port_k1"] == 0
    for key in ("seg_logits", "depth"):
        err = got[key].astype(np.float64) - want[key]
        assert np.abs(err).max() <= 1e-4, key
        assert np.linalg.norm(err) / np.linalg.norm(want[key]) <= 1e-5, key


def test_fused_rule_takes_fp32_on_cuda(monkeypatch):
    """No dtype condition, as in JAX: under `tpu.compute_dtype: float32` a
    CUDA tensor takes K6 (its fp32 kernel) where JAX takes K6."""
    import types

    monkeypatch.setenv("DENSECLIP_FUSED_LNQKV", "1")
    monkeypatch.setattr(t_attention, "_on_cuda", lambda x: True)
    tm = t_layers.MultiHeadAttention(768, 12, dtype=torch.float32)
    cuda_x = types.SimpleNamespace(is_cuda=True, shape=(10, 1536, 768), dtype=torch.float32)
    assert tm.qkv.compute_dtype == torch.float32
    assert tm._lnqkv_applicable(cuda_x, 768)
