"""K4b's plain version (the port's `flash_attention_bwd_reference`) against
`jax.vjp` of the JAX package's `flash_attention`, which runs the bundled
Pallas flash kernel and its backward kernels here in interpret mode (its
one-shot branch switched off), and the port's autograd binding
`FlashAttentionFunction`.  The CUDA kernel is held against the same plain
backward on the card by `chip_smoke.py` and `tests/test_torch_cuda.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from denseclip_vit_multimodal_tpu.ops import attention as j_attention
from denseclip_vit_multimodal_tpu_torch.ops import attention

# fp32: the same arithmetic in another order (the bundled kernel's running
# max and 1024-key blocks; the port's O from its own forward for di).
FP32_RTOL, FP32_ATOL = 2e-4, 2e-5
# bf16, relative L2 over each of dq, dk, dv on the valid rows / keys: both
# sides round p and ds to bf16, and each side's di reads its own bf16 O.
BF16_REL_L2 = 2e-2


def _inputs(b, n, heads, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, n, heads, d).astype(np.float32) for _ in range(4)]


def _jax_grads(q, k, v, g, dtype, causal, valid_len, monkeypatch):
    monkeypatch.setattr(j_attention, "_ONESHOT_MAX_SEQ", 0)  # every N to the bundled kernel
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    fn = lambda a, b, c: j_attention.flash_attention(a, b, c, causal=causal, valid_len=valid_len)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, *(jnp.asarray(x, jdt) for x in (q, k, v)))
        grads = vjp(jnp.asarray(g, jdt))
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


def _port_grads(q, k, v, g, dtype, causal, valid_len):
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    out = attention.flash_attention_reference(q, k, v, causal=causal, valid_len=valid_len)
    return attention.flash_attention_bwd_reference(q, k, v, out, g, causal=causal,
                                                   valid_len=valid_len)


@pytest.mark.parametrize("dtype,head_dim,causal,valid_len", [
    (torch.float32, 64, False, 580),
    (torch.float32, 64, True, None),
    (torch.float32, 128, True, 580),
    (torch.bfloat16, 64, False, 580),
    (torch.bfloat16, 64, True, None),
    (torch.bfloat16, 128, True, 580),
])
def test_plain_k4b_matches_bundled_pallas_backward(dtype, head_dim, causal, valid_len,
                                                   monkeypatch):
    """dq on the rows and dk / dv on the keys below `valid_len` (the bundled
    kernel's pad rows attend to pad keys only; the port's contribute nothing)."""
    q, k, v, g = _inputs(1, 600, 2, head_dim, seed=head_dim + int(causal))
    want = _jax_grads(q, k, v, g, dtype, causal, valid_len, monkeypatch)
    got = _port_grads(q, k, v, g, dtype, causal, valid_len)
    rows = 600 if valid_len is None else valid_len
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == (1, 600, 2, head_dim)
        a, w = a.float().numpy()[:, :rows], w[:, :rows]
        if dtype == torch.float32:
            np.testing.assert_allclose(a, w, rtol=FP32_RTOL, atol=FP32_ATOL, err_msg=name)
        else:
            assert np.linalg.norm(a - w) / np.linalg.norm(w) <= BF16_REL_L2, name


def test_plain_k4b_is_the_gradient_of_the_valid_rows():
    """K4b's plain version is the gradient of plain attention's rows below
    `valid_len` (dO of the pad rows is ignored), chunked over rows that do
    not divide N; pad rows get dq = 0, pad keys dk = dv = 0.  fp32 on both
    sides (summation order only)."""
    rs = np.random.RandomState(3)
    q, k, v, g = (torch.from_numpy(rs.randn(2, 70, 3, 64).astype(np.float32)) for _ in range(4))
    for causal in (False, True):
        out = attention.flash_attention_reference(q, k, v, causal=causal, valid_len=61)
        old = attention._REF_CHUNK
        attention._REF_CHUNK = 25
        try:
            got = attention.flash_attention_bwd_reference(q, k, v, out, g, causal=causal,
                                                          valid_len=61)
        finally:
            attention._REF_CHUNK = old
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = attention.plain_attention(*leaves, causal, 61)
        want = torch.autograd.grad(ref[:, :61], leaves, g[:, :61])
        for a, w in zip(got, want):
            torch.testing.assert_close(a[:, :61], w[:, :61], rtol=FP32_RTOL, atol=FP32_ATOL)
        assert not got[0][:, 61:].any() and not got[1][:, 61:].any() and not got[2][:, 61:].any()


def test_autograd_binding_runs_the_plain_versions_on_the_cpu(monkeypatch):
    """`flash_attention` past the one-shot limit under autograd takes
    `FlashAttentionFunction` (K4's plain forward, K4b's plain backward), not
    plain attention, and launches nothing."""
    monkeypatch.setattr(attention, "_ONESHOT_MAX_SEQ", 100)
    calls = []
    for name in ("plain_attention", "flash_attention_reference", "flash_attention_bwd_reference"):
        fn = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *a, _fn=fn, _n=name, **kw: calls.append(_n) or _fn(*a, **kw))
    rs = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rs.randn(1, 130, 2, 64).astype(np.float32)).requires_grad_(True)
               for _ in range(3))
    before = dict(attention.LAUNCHES)
    out = attention.flash_attention(q, k, v, valid_len=120)
    out[:, :120].sum().backward()
    assert calls == ["flash_attention_reference", "flash_attention_bwd_reference"]
    assert attention.LAUNCHES == before
    want = attention.flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), out.detach(),
        torch.ones_like(out).index_fill_(1, torch.arange(120, 130), 0.0), valid_len=120)
    for a, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(a, w)


def test_head_dim_256_keeps_plain_attention_under_autograd():
    """K4 does not take head dim 256 yet: that branch stays plain attention,
    differentiable by autograd."""
    rs = np.random.RandomState(5)
    q = torch.from_numpy(rs.randn(1, 20, 1, 256).astype(np.float32)).requires_grad_(True)
    out = attention.flash_attention(q, q, q, causal=True)
    out.sum().backward()
    assert torch.isfinite(q.grad).all() and q.grad.abs().sum() > 0
