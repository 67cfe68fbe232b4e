"""The qkv attention backward (K2) of the port against the JAX package's.

The JAX side is the TPU kernel `_mha_bwd_pallas` in Pallas interpret mode and
`jax.grad` through the custom VJP of `_qkv_mha` (interpret mode), as the JAX
package's own tests run them on the CPU.  The port side is the plain backward
`mha_qkv_attention_bwd_reference` and the CPU path of the autograd binding
`QKVAttentionFunction`.  The CUDA kernel is held against the same plain
backward on the card by `chip_smoke.py` and `tests/test_torch_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.ops import mha_kernel as jax_mha
from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as port_mha

# fp32: the JAX tests' own tolerance; both sides do the same fp32 arithmetic
# in another order (the port's D = rowsum(dO * O) equals the kernel's
# rowsum(P * dP) / l up to that order).
RTOL, ATOL = 2e-4, 2e-5
# bf16, relative L2 over each of dq, dk, dv: both sides round qs, ds, P and
# dO * r to bf16, the port's D also sees O rounded to bf16 and the JAX
# kernel's scale * log2 e constant is rounded to bf16 (weak typing).
# Measured on the CPU: 4.5e-3 to 5.1e-3 over the cases below.
BF16_REL_L2 = 1.5e-2

CASES = [
    # (b, n, heads, head_dim, valid_len)
    (2, 200, 2, 64, None),  # ragged N: the JAX wrapper pads to 256 and corrects the denominator
    (2, 256, 2, 128, None),
    (1, 128, 2, 64, 100),  # keys >= 100 masked: their dk / dv must be exactly 0
]


def _inputs(b, n, heads, d, seed):
    rs = np.random.RandomState(seed)
    qkv = rs.randn(b, n, 3 * heads * d).astype(np.float32)
    g = rs.randn(b, n, heads * d).astype(np.float32)
    return qkv, g


def _split_heads(x, heads):
    b, n, hd = x.shape
    return jnp.swapaxes(jnp.asarray(x).reshape(b, n, heads, hd // heads), 1, 2)


def _jax_pallas_bwd(qkv, g, heads, valid_len, dtype=jnp.float32):
    """`_mha_bwd_pallas` on the head-split inputs, back to the fused layout."""
    b, n, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // heads
    x = jnp.asarray(qkv).astype(dtype)
    q, k, v = (_split_heads(t, heads) for t in jnp.split(x, 3, axis=-1))
    do = _split_heads(jnp.asarray(g).astype(dtype), heads)
    dq, dk, dv = jax_mha._mha_bwd_pallas(q, k, v, do, d**-0.5, 0, True, valid_len)
    back = lambda t: np.asarray(jnp.swapaxes(t, 1, 2).reshape(b, n, hd), np.float32)
    return np.concatenate([back(dq), back(dk), back(dv)], axis=-1)


def _jax_grad(qkv, g, heads, valid_len, dtype=jnp.float32):
    d = qkv.shape[-1] // 3 // heads
    x = jnp.asarray(qkv).astype(dtype)
    gj = jnp.asarray(g).astype(dtype)
    loss = lambda t: jnp.sum(
        (jax_mha._qkv_mha(t, heads, d**-0.5, 0, True, valid_len) * gj).astype(jnp.float32))
    return np.asarray(jax.grad(loss)(x).astype(jnp.float32))


def _port_plain(qkv, g, heads, valid_len, dtype=torch.float32):
    x = torch.from_numpy(qkv).to(dtype)
    out = port_mha.mha_qkv_attention_reference(x, heads, valid_len=valid_len)
    return port_mha.mha_qkv_attention_bwd_reference(
        x, out, torch.from_numpy(g).to(dtype), heads, valid_len=valid_len)


def _port_autograd(qkv, g, heads, valid_len, dtype=torch.float32):
    x = torch.from_numpy(qkv).to(dtype).requires_grad_(True)
    before = dict(port_mha.LAUNCHES)
    out = port_mha.mha_qkv_attention(x, heads, valid_len=valid_len)
    out.backward(torch.from_numpy(g).to(dtype))
    assert port_mha.LAUNCHES == before  # the CPU path launches no kernel
    return x.grad


@pytest.mark.parametrize("b,n,heads,d,valid_len", CASES)
def test_plain_backward_matches_jax_kernel(b, n, heads, d, valid_len):
    qkv, g = _inputs(b, n, heads, d, seed=n + d)
    want = _jax_pallas_bwd(qkv, g, heads, valid_len)
    got = _port_plain(qkv, g, heads, valid_len)
    assert got.dtype == torch.float32 and tuple(got.shape) == qkv.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if valid_len is not None:
        hd = heads * d
        assert not got[:, valid_len:, hd:].any()  # dk, dv of masked keys: exactly 0
        assert np.all(want[:, valid_len:, hd:] == 0)


@pytest.mark.parametrize("b,n,heads,d,valid_len", CASES)
def test_autograd_function_matches_jax_grad(b, n, heads, d, valid_len):
    qkv, g = _inputs(b, n, heads, d, seed=n + d + 1)
    want = _jax_grad(qkv, g, heads, valid_len)
    got = _port_autograd(qkv, g, heads, valid_len)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,n,heads,d,valid_len", [(2, 200, 2, 64, None), (1, 128, 2, 64, 100)])
def test_bf16_backward_matches_jax(b, n, heads, d, valid_len):
    qkv, g = _inputs(b, n, heads, d, seed=7)
    want = _jax_grad(qkv, g, heads, valid_len, dtype=jnp.bfloat16)
    got = _port_autograd(qkv, g, heads, valid_len, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    hd = heads * d
    for part in range(3):
        a, w = got[..., part * hd:(part + 1) * hd], want[..., part * hd:(part + 1) * hd]
        assert np.linalg.norm(a - w) / np.linalg.norm(w) < BF16_REL_L2, part
    if valid_len is not None:
        assert not np.any(got[:, valid_len:, hd:])


def test_backward_wrapper_raises_without_forward_stats():
    x = torch.zeros(1, 8, 3 * 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="row statistics"):
        port_mha._launch_bwd(x, x[..., :128].contiguous(), x[..., :128].contiguous(), None,
                             2, 0.125, 8)
