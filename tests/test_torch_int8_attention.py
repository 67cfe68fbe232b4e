"""The int8 attention path of the port (K5's prologue, plain version and dispatch)
against the JAX package's `mha_qkv_attention_int8`.

The JAX kernel runs in Pallas interpret mode on the CPU, as the JAX package's
own tests run it (`tests/test_int8_attention.py`); its quantized operands are
read off the `pallas_call` it makes.  The CUDA kernel itself is held against
the same plain version on the card by `chip_smoke.py` and
`tests/test_torch_cuda.py`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from denseclip_vit_multimodal_tpu.models import layers as j_layers
from denseclip_vit_multimodal_tpu.ops import attention as j_attention
from denseclip_vit_multimodal_tpu.ops import mha_kernel as jax_mha
from denseclip_vit_multimodal_tpu_torch.convert import load_flax_variables
from denseclip_vit_multimodal_tpu_torch.models import layers as t_layers
from denseclip_vit_multimodal_tpu_torch.ops import attention as t_attention
from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as port_mha

# Port plain version vs JAX interpret mode: the same arithmetic, with exp2 in
# another library and the fp32 denominator summed in another order, so an
# exp2 ulp can move a p8 by one step (1/127 of one key's weight).
MAX_ABS_TOL = 2e-2
REL_L2_TOL = 5e-3
# JAX's own design budget of the int8 path against exact attention
# (max abs error / max |exact|; tests/test_int8_attention.py).
DESIGN_TOL = 0.06
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

CASES = [
    # (b, n, heads, head_dim, valid_len)
    (2, 200, 2, 64, None),
    (2, 256, 2, 64, 250),
    (1, 136, 1, 128, 100),
]


def _qkv(b, n, heads, d, seed):
    return np.random.RandomState(seed).randn(b, n, 3 * heads * d).astype(np.float32)


def _jax_int8(x, heads, valid_len, dtype):
    """JAX int8 attention in interpret mode and the (q8, scales [B, 3, H])
    its kernel was handed."""
    seen = {}
    orig = pl.pallas_call

    def recording(*args, **kwargs):
        call = orig(*args, **kwargs)

        def run(*operands):
            seen["q8"], seen["sc"] = operands[0], operands[3]
            return call(*operands)

        return run

    pl.pallas_call = recording
    try:
        out = jax_mha.mha_qkv_attention_int8(jnp.asarray(x).astype(DTYPES[dtype][0]), heads,
                                             interpret=True, valid_len=valid_len)
    finally:
        pl.pallas_call = orig
    b, n = x.shape[:2]
    q8 = np.asarray(seen["q8"])[:, :n]  # JAX pads N to 128 with zero rows
    scales = np.asarray(seen["sc"])[..., :3].reshape(b, heads, 3).transpose(0, 2, 1)
    return np.asarray(out.astype(jnp.float32)), q8, scales


@functools.lru_cache(maxsize=None)
def _case(b, n, heads, d, valid_len, dtype):
    x = _qkv(b, n, heads, d, seed=n + d)
    return (x,) + _jax_int8(x, heads, valid_len, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,heads,d,valid_len", CASES)
def test_quantization_is_bitwise_jax(b, n, heads, d, valid_len, dtype):
    x, _, want_q8, want_scales = _case(b, n, heads, d, valid_len, dtype)
    q8, scales = port_mha.quantize_qkv_int8(torch.from_numpy(x).to(DTYPES[dtype][1]), heads,
                                            valid_len)
    assert q8.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(q8.numpy(), want_q8)
    np.testing.assert_array_equal(scales.numpy(), want_scales)


def _saturating_bf16_amax():
    """A bf16 value a whose bf16 product a * bf16(127 / a) is >= 127.5, so
    that rint gives 128 (JAX's cast saturates it to 127; torch's wraps)."""
    a = torch.arange(1.0, 2.0, 2.0**-7).to(torch.bfloat16)
    inv = (torch.full_like(a, 127.0, dtype=torch.float32) / a.float()).to(torch.bfloat16)
    hit = torch.round(a * inv) >= 128
    assert hit.any()
    return float(a[hit][0])


def test_quantization_saturates_like_jax():
    a = _saturating_bf16_amax()
    x = _qkv(1, 16, 2, 64, seed=7) * 0.1
    x[0, 3, 5] = a  # the abs max of the q third of head 0
    x[0, 4, 128 + 7] = -a  # and of k, negative
    xt = torch.from_numpy(x).to(torch.bfloat16)
    q8, scales = port_mha.quantize_qkv_int8(xt, 2)
    _, want_q8, want_scales = _jax_int8(x, 2, None, "bfloat16")
    np.testing.assert_array_equal(q8.numpy(), want_q8)
    np.testing.assert_array_equal(scales.numpy(), want_scales)
    assert int(q8[0, 3, 5]) == 127 and int(q8[0, 4, 128 + 7]) == -128  # -128 is in range
    # the trap the clamp closes: torch's own cast wraps 128 to -128
    assert int(torch.tensor([128.0], dtype=torch.bfloat16).to(torch.int8)) == -128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,heads,d,valid_len", CASES)
def test_plain_version_matches_jax_kernel(b, n, heads, d, valid_len, dtype):
    x, want, _, _ = _case(b, n, heads, d, valid_len, dtype)
    got = port_mha.mha_qkv_attention_int8_reference(torch.from_numpy(x).to(DTYPES[dtype][1]),
                                                    heads, valid_len=valid_len)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (b, n, heads * d)
    rows = n if valid_len is None else valid_len  # later rows are left to the caller
    got, want = got.float().numpy()[:, :rows], want[:, :rows]
    assert np.abs(got - want).max() <= MAX_ABS_TOL
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= REL_L2_TOL
    # both within the int8 design budget of exact attention
    exact = np.asarray(jax_mha._qkv_ref(jnp.asarray(x), heads, d**-0.5, valid_len))[:, :rows]
    for out in (got, want):
        assert np.abs(out - exact).max() / np.abs(exact).max() < DESIGN_TOL


def test_pad_columns_cannot_dominate_the_max():
    """The adversarial pad case of the JAX tests (tests/test_int8_attention.py):
    every real score far below zero, so a pad key let into the row max would
    truncate every real p8 to 0.  JAX pads the 200 tokens to 256 with zero
    rows itself; the port gets the same 256 rows with `valid_len` 200."""
    rng = np.random.RandomState(2)
    q = -np.abs(rng.randn(1, 200, 128)).astype(np.float32) * 20.0
    k = np.abs(rng.randn(1, 200, 128)).astype(np.float32)
    v = rng.randn(1, 200, 128).astype(np.float32)
    x = np.concatenate([q, k, v], axis=-1)
    padded = np.concatenate([x, np.zeros((1, 56, 384), np.float32)], axis=1)
    got = port_mha.mha_qkv_attention_int8_reference(torch.from_numpy(padded), 2, valid_len=200)
    got = got.numpy()[:, :200]
    want = _jax_int8(x, 2, None, "float32")[0]
    exact = np.asarray(jax_mha._qkv_ref(jnp.asarray(x), 2, 64**-0.5))
    assert np.abs(got).max() > 1e-3  # not silently zeroed
    assert np.abs(got - exact).max() / np.abs(exact).max() < 0.25  # JAX's own bound here
    assert np.abs(got - want).max() <= MAX_ABS_TOL


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    before = dict(port_mha.LAUNCHES)
    x = torch.from_numpy(_qkv(2, 130, 2, 64, seed=1)).to(torch.bfloat16)
    out = port_mha.mha_qkv_attention_int8(x, 2, valid_len=129)
    assert torch.equal(out, port_mha.mha_qkv_attention_int8_reference(x, 2, valid_len=129))
    assert port_mha.LAUNCHES == before


@pytest.mark.parametrize("case", ["grad", "valid_len", "too_many_keys", "not_qkv"])
def test_wrapper_raises(case, monkeypatch):
    x = torch.zeros(1, 8, 3 * 128)
    if case == "grad":  # the straight-through route checks its input the same way
        with pytest.raises(ValueError, match="valid_len"):
            port_mha.mha_qkv_attention_int8(x.requires_grad_(True), 2, valid_len=9)
    elif case == "valid_len":
        with pytest.raises(ValueError):
            port_mha.mha_qkv_attention_int8(x, 2, valid_len=9)
    elif case == "too_many_keys":
        monkeypatch.setattr(port_mha, "INT8_MAX_KEYS", 7)
        with pytest.raises(ValueError, match="int32"):
            port_mha.mha_qkv_attention_int8(x, 2)
    else:
        with pytest.raises(ValueError):
            port_mha.mha_qkv_attention_int8(torch.zeros(1, 8, 3 * 128 + 1), 2)


def test_value_key_major_layout():
    b, n, heads, d = 2, 37, 3, 64
    q8 = torch.from_numpy(np.random.RandomState(3).randint(-128, 128, (b, n, 3 * heads * d))
                          .astype(np.int8))
    vt = port_mha.value_key_major(q8, heads)
    assert tuple(vt.shape) == (b, heads, d, 48) and vt.is_contiguous()
    v = q8[..., 2 * heads * d:].view(b, n, heads, d)
    assert torch.equal(vt[..., :n], v.permute(0, 2, 3, 1))
    assert not vt[..., n:].any()


# --------------------------------------------------------------------------
# models/layers.py: the int8 dispatch
# --------------------------------------------------------------------------


@pytest.fixture
def kernels_here(monkeypatch):
    """Both packages' dispatch believes it runs on its accelerator; the JAX
    int8 kernel runs in interpret mode, and each side records its int8 calls."""
    monkeypatch.setattr(j_attention, "_on_tpu", lambda: True)
    monkeypatch.setattr(t_attention, "_on_cuda", lambda x: True)
    calls = {"jax": 0, "port": 0}
    j_int8, t_int8 = jax_mha.mha_qkv_attention_int8, t_layers.mha_qkv_attention_int8

    def jax_interpret(*args, **kwargs):
        calls["jax"] += 1
        return j_int8(*args, **dict(kwargs, interpret=True))

    def port_counted(*args, **kwargs):
        calls["port"] += 1
        return t_int8(*args, **kwargs)

    monkeypatch.setattr(jax_mha, "mha_qkv_attention_int8", jax_interpret)
    monkeypatch.setattr(t_layers, "mha_qkv_attention_int8", port_counted)
    return calls


def _port_mha(variables, dim, heads, causal, impl):
    tm = t_layers.MultiHeadAttention(dim, heads, causal=causal, attn_impl=impl)
    return load_flax_variables(tm, jax.tree.map(np.asarray, dict(variables))).eval()


@pytest.mark.parametrize("valid_len", [None, 37])
def test_int8_module_matches_jax(kernels_here, valid_len):
    x = _qkv(2, 40, 1, 128, seed=5)[..., :128]
    jm = j_layers.MultiHeadAttention(num_heads=2, attn_impl="int8")
    v = jm.init(jax.random.PRNGKey(0), x)
    kernels_here["jax"] = 0  # init ran the module once
    want = np.asarray(jm.apply(v, x, valid_len=valid_len))
    with torch.no_grad():
        got = _port_mha(v, 128, 2, False, "int8")(torch.from_numpy(x), valid_len=valid_len)
    assert kernels_here == {"jax": 1, "port": 1}
    rows = 40 if valid_len is None else valid_len
    # fp32: only exp2 ulps and the denominator's summation order differ
    np.testing.assert_allclose(got.numpy()[:, :rows], want[:, :rows], atol=1e-4, rtol=1e-4)


def test_causal_layer_under_int8_stays_plain(kernels_here):
    """The text tower's causal attention never quantizes: under `int8` it
    takes the exact `auto` rules on both sides (plain attention at 22 tokens)."""
    x = _qkv(2, 22, 1, 128, seed=6)[..., :128]
    jm = j_layers.MultiHeadAttention(num_heads=2, causal=True, attn_impl="int8")
    v = jm.init(jax.random.PRNGKey(1), x)
    want = np.asarray(jm.apply(v, x))
    tm = _port_mha(v, 128, 2, True, "xla")
    t_layers.set_attn_impl(tm, "int8")
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        exact = _port_mha(v, 128, 2, True, "xla")(torch.from_numpy(x))
    assert kernels_here == {"jax": 0, "port": 0}
    assert torch.equal(got, exact)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,causal,dim,heads,want", [
    (8448, False, 128, 2, True),  # the one-shot limit
    (8449, False, 128, 2, False),  # longer: attention_core (K4 on the card)
    (10, False, 128, 2, True),  # no 1024-token floor for int8
    (10, True, 128, 2, False),  # causal: never quantized
    (10, False, 192, 2, False),  # head dim 96: not qkv_supported
])
def test_int8_dispatch_rule(kernels_here, n, causal, dim, heads, want):
    tm = t_layers.MultiHeadAttention(dim, heads, causal=causal, attn_impl="int8")
    assert tm._qkv_kernel_applicable(torch.empty(1, n, 3 * dim), dim) is want


def test_int8_dispatch_needs_cuda_and_attn_impl_names():
    tm = t_layers.MultiHeadAttention(128, 2, attn_impl="int8")
    assert not tm._qkv_kernel_applicable(torch.empty(1, 10, 384), 128)  # a CPU tensor
    t_layers.set_attn_impl(tm, "auto")
    assert tm.attn_impl == "auto"
    with pytest.raises(ValueError, match="not yet ported"):
        t_layers.set_attn_impl(tm, "ring")
    assert t_layers.ATTN_IMPLS == ("auto", "xla", "int8")


@pytest.mark.parametrize("valid_len", [None, 120])
def test_straight_through_backward_matches_jax_grad(valid_len):
    """Under autograd the int8 path's gradient is the JAX straight-through one
    (`_qkv_mha_int8`'s VJP is `_qkv_bwd`): the fp32 backward of the
    unquantized qkv, i.e. K2's plain backward after K1's plain forward.
    fp32: the JAX tests' tolerance (tests/test_torch_mha_kernel_bwd.py)."""
    rs = np.random.RandomState(21)
    x = rs.randn(2, 130, 3 * 128).astype(np.float32)
    g = rs.randn(2, 130, 128).astype(np.float32)
    loss = lambda t: jnp.sum(jax_mha.mha_qkv_attention_int8(t, 2, interpret=True,
                                                            valid_len=valid_len) * jnp.asarray(g))
    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    leaf = torch.from_numpy(x).requires_grad_(True)
    before = dict(port_mha.LAUNCHES)
    out = port_mha.mha_qkv_attention_int8(leaf, 2, valid_len=valid_len)
    torch.testing.assert_close(  # the forward is still the quantized one
        out.detach(), port_mha.mha_qkv_attention_int8_reference(torch.from_numpy(x), 2,
                                                                valid_len=valid_len))
    out.backward(torch.from_numpy(g))
    assert port_mha.LAUNCHES == before
    np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=2e-4, atol=2e-5)
