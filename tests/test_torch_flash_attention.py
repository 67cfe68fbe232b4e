"""K4's plain version (`ops/attention.py` of the port) against the JAX package's
`flash_attention`, which runs the bundled Pallas flash kernel here in interpret
mode (its one-shot branch switched off), and the port's attention dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from denseclip_vit_multimodal_tpu.ops import attention as j_attention
from denseclip_vit_multimodal_tpu_torch.models import layers
from denseclip_vit_multimodal_tpu_torch.ops import attention

# bf16: K1's limits (the output is rounded to bf16, and P is rounded at
# another running max); fp32: summation order only.
BF16_MAX, BF16_REL = 2e-2, 5e-3
FP32_MAX = 1e-5


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


def _jax_bundled(q, k, v, dtype, causal, valid_len, monkeypatch):
    monkeypatch.setattr(j_attention, "_ONESHOT_MAX_SEQ", 0)  # every N to the bundled kernel
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    with pltpu.force_tpu_interpret_mode():
        out = j_attention.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                          causal=causal, valid_len=valid_len)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype,head_dim,causal,valid_len", [
    (torch.bfloat16, 64, False, 1050),
    (torch.bfloat16, 64, True, None),
    (torch.bfloat16, 128, True, 1050),
    (torch.float32, 128, False, 1050),
    (torch.float32, 64, True, None),
])
def test_plain_k4_matches_bundled_pallas_kernel(dtype, head_dim, causal, valid_len, monkeypatch):
    q, k, v = _inputs((2, 1100, 2, head_dim), seed=head_dim + int(causal))
    want = _jax_bundled(q, k, v, dtype, causal, valid_len, monkeypatch)
    got = attention.flash_attention_reference(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)), causal=causal, valid_len=valid_len)
    assert got.dtype == dtype and got.shape == (2, 1100, 2, head_dim)
    assert torch.isfinite(got).all()  # pad rows too: they ride into the next layer
    rows = 1100 if valid_len is None else valid_len  # rows >= valid_len are unspecified
    got, want = got.float().numpy()[:, :rows], want[:, :rows]
    err = np.abs(got - want)
    if dtype == torch.float32:
        assert err.max() <= FP32_MAX
    else:
        assert err.max() <= BF16_MAX
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= BF16_REL


def test_plain_k4_honours_sm_scale_and_chunking(monkeypatch):
    """A scale other than head_dim**-0.5, and query chunks that do not divide N."""
    monkeypatch.setattr(attention, "_REF_CHUNK", 300)
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 700, 3, 64), seed=5))
    got = attention.flash_attention_reference(q, k, v, causal=True, sm_scale=0.2, valid_len=650)
    want = attention.plain_attention(q, k, v, True, 650, sm_scale=0.2)
    torch.testing.assert_close(got[:, :650], want[:, :650], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,causal,route", [
    (8448, False, "k3"),  # the K3 branch (tests/test_torch_oneshot_attention.py)
    (2049, False, "k3"),
    (8449, False, "k4"),
    (12928, False, "k4"),
    (1100, True, "k4"),  # causal: K4 at any N
    (77, True, "k4"),
])
def test_flash_attention_dispatch(n, causal, route, monkeypatch):
    """Which N goes where (the JAX package's ops/attention.py:98); on the CPU
    the K4 branch runs K4's plain version."""
    calls = []
    monkeypatch.setattr(attention, "plain_attention",
                        lambda q, *a, **kw: calls.append("plain") or q.clone())
    monkeypatch.setattr(attention, "flash_attention_reference",
                        lambda q, *a, **kw: calls.append("k4") or q.clone())
    monkeypatch.setattr(attention, "mha_attention",
                        lambda q, *a, **kw: calls.append("k3") or q.clone())
    q = torch.zeros(1, n, 1, 64)
    attention.flash_attention(q, q, q, causal=causal, valid_len=n - 1)
    assert calls == [route]


def test_flash_supported_rule():
    """The flash path is CUDA-only and bf16-only: on the CPU it never serves,
    so the CPU model takes plain attention at every N."""
    assert not attention.flash_supported(torch.zeros(1, 2048, 2, 64, dtype=torch.bfloat16))
    mha = layers.MultiHeadAttention(128, 2)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 40, 128).astype(np.float32))
    ref = mha.out(attention.plain_attention(
        *(t.reshape(1, 40, 2, 64) for t in mha.qkv(x).split(128, dim=-1)), False, 37
    ).reshape(1, 40, 128))
    torch.testing.assert_close(mha(x, valid_len=37), ref)


def test_flash_attention_raises_on_bad_input():
    q = torch.zeros(1, 9000, 2, 64)
    with pytest.raises(ValueError, match=r"\[B, N, H, D\]"):
        attention.flash_attention(q, q[:, :100], q)
    with pytest.raises(ValueError, match="valid_len"):
        attention.flash_attention(q, q, q, valid_len=9001)
    with pytest.raises(ValueError, match="valid_len"):
        attention.flash_attention_reference(q, q, q, valid_len=0)
    with pytest.raises(ValueError, match="no flash attention for device"):
        m = torch.zeros(1, 9000, 2, 64, device="meta")
        attention.flash_attention(m, m, m)
