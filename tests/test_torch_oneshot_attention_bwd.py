"""K3's backward of the port against the JAX package's.

The JAX side is the TPU kernel `_mha_bwd_pallas` in Pallas interpret mode
and `jax.grad` through the custom VJP of `mha_attention` (interpret mode), as
the JAX package's own tests run them on the CPU.  The port side is the plain
backward `mha_attention_bwd_reference` and the CPU path of the autograd
binding `MHAAttentionFunction`.  The CUDA kernel (the backward core with
K2's numerics, read by stride) is held against the same plain backward on
the card by `chip_smoke.py` and `tests/test_torch_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.ops import mha_kernel as jax_mha
from denseclip_vit_multimodal_tpu_torch.ops import attention
from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as port_mha

# fp32: the JAX tests' own tolerance; the same arithmetic in another order
# (the port's D = rowsum(dO * O) equals the kernel's rowsum(P * dP) / l up to
# that order).
RTOL, ATOL = 2e-4, 2e-5
# bf16, relative L2 over each of dq, dk, dv: both sides round qs, ds, P and
# dO * r to bf16, the port's D also sees O rounded to bf16 and the JAX
# kernel's scale * log2 e constant is rounded to bf16 (weak typing).
BF16_REL_L2 = 1.5e-2

CASES = [
    # (b, n, heads, head_dim, valid_len)
    (2, 200, 2, 64, None),  # ragged N: the JAX wrapper pads to 256 and corrects the denominator
    (1, 256, 2, 128, None),
    (1, 130, 3, 64, 100),  # keys >= 100 masked: dk / dv exactly 0; pad rows keep their dO
    (1, 90, 2, 256, 80),  # head dim 256 (the CUDA dk/dv kernel makes two passes there)
]


def _inputs(b, n, heads, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, n, heads, d).astype(np.float32) for _ in range(4)]


def _jax_pallas_bwd(q, k, v, g, valid_len, dtype):
    """`_mha_bwd_pallas` on [B, H, N, D], back to [B, N, H, D]."""
    t = lambda x: jnp.swapaxes(jnp.asarray(x).astype(dtype), 1, 2)
    d = q.shape[-1]
    grads = jax_mha._mha_bwd_pallas(t(q), t(k), t(v), t(g), d**-0.5, 0, True, valid_len)
    return [np.asarray(jnp.swapaxes(x, 1, 2).astype(jnp.float32)) for x in grads]


def _port_plain(q, k, v, g, valid_len, dtype):
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    out = port_mha.mha_attention_reference(q, k, v, valid_len=valid_len)
    return port_mha.mha_attention_bwd_reference(q, k, v, out, g, valid_len=valid_len)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_pallas_kernel_fp32(case):
    b, n, heads, d, valid_len = case
    q, k, v, g = _inputs(b, n, heads, d, seed=n)
    want = _jax_pallas_bwd(q, k, v, g, valid_len, jnp.float32)
    got = _port_plain(q, k, v, g, valid_len, torch.float32)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == (b, n, heads, d)
        np.testing.assert_allclose(a.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)
    if valid_len is not None:
        assert not got[1][:, valid_len:].any() and not got[2][:, valid_len:].any()
        assert got[0][:, valid_len:].abs().sum() > 0  # pad rows still get dq


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_pallas_kernel_bf16(case):
    b, n, heads, d, valid_len = case
    q, k, v, g = _inputs(b, n, heads, d, seed=n + 1)
    want = _jax_pallas_bwd(q, k, v, g, valid_len, jnp.bfloat16)
    got = _port_plain(q, k, v, g, valid_len, torch.bfloat16)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        a = a.float().numpy()
        assert np.linalg.norm(a - w) / np.linalg.norm(w) <= BF16_REL_L2, name


@pytest.mark.parametrize("valid_len", [None, 100])
def test_autograd_matches_jax_grad_through_the_custom_vjp(valid_len):
    """`mha_attention` under autograd (MHAAttentionFunction, plain versions on
    the CPU) against `jax.grad` of the JAX `mha_attention` (interpret mode),
    with a loss weighting every output row."""
    q, k, v, g = _inputs(2, 130, 2, 64, seed=9)
    loss = lambda a, b, c: jnp.sum(jax_mha.mha_attention(a, b, c, interpret=True,
                                                        valid_len=valid_len) * jnp.asarray(g))
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = port_mha.mha_attention(*leaves, valid_len=valid_len)
    (out * torch.from_numpy(g)).sum().backward()
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_strided_views_and_the_fused_layout_agree():
    """On views of one fused qkv (the ViT's split) K3's plain backward is K2's,
    column block by column block, and `flash_attention`'s one-shot branch
    differentiates through K3 with no launch on the CPU."""
    rs = np.random.RandomState(10)
    qkv = torch.from_numpy(rs.randn(2, 90, 3 * 128).astype(np.float32))
    g = torch.from_numpy(rs.randn(2, 90, 128).astype(np.float32))
    out = port_mha.mha_qkv_attention_reference(qkv, 2, valid_len=80)
    want = port_mha.mha_qkv_attention_bwd_reference(qkv, out, g, 2, valid_len=80)
    leaf = qkv.clone().requires_grad_(True)
    q, k, v = (t.view(2, 90, 2, 64) for t in leaf.split(128, dim=-1))
    before = dict(port_mha.LAUNCHES)
    got_out = attention.flash_attention(q, k, v, valid_len=80)
    got_out.backward(g.view(2, 90, 2, 64))
    assert port_mha.LAUNCHES == before
    torch.testing.assert_close(got_out.reshape(2, 90, 128), out)
    torch.testing.assert_close(leaf.grad, want)


def test_cpu_backward_launches_nothing_and_checks_its_input():
    q = torch.zeros(1, 8, 2, 64, requires_grad=True)
    with pytest.raises(ValueError, match=r"\[B, N, H, D\]"):
        port_mha.mha_attention(q, q[:, :4], q)
    before = dict(port_mha.LAUNCHES)
    port_mha.mha_attention(q, q, q).sum().backward()
    # uniform attention over zero keys: dq = dk = 0, dv = the mean of dO = 1
    assert port_mha.LAUNCHES == before and torch.equal(q.grad, torch.ones_like(q))


def test_autograd_matches_jax_grad_at_head_dim_256():
    """Head dim 256 with pad keys: `mha_attention` under autograd (plain
    versions on the CPU) against `jax.grad` through the JAX custom VJP
    (interpret mode), fp32."""
    q, k, v, g = _inputs(1, 70, 2, 256, seed=11)
    loss = lambda a, b, c: jnp.sum(jax_mha.mha_attention(a, b, c, interpret=True,
                                                        valid_len=60) * jnp.asarray(g))
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = port_mha.mha_attention(*leaves, valid_len=60)
    (out * torch.from_numpy(g)).sum().backward()
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert not leaves[1].grad[:, 60:].any() and not leaves[2].grad[:, 60:].any()


@pytest.mark.parametrize("wrapper", ["forward", "backward"])
def test_fp32_on_the_oneshot_branch_reaches_a_wrapper_that_refuses_it(monkeypatch, wrapper):
    """`flash_attention`'s K3 branch has no dtype route of its own: fp32
    q / k / v "on CUDA" (`_on_cuda` patched) go to `mha_attention`, whose
    kernel wrappers (K3, K3's backward) take fp32 as JAX's kernels do and
    pick their fp32 kernels (a CUDA tensor of another dtype they refuse with
    `TypeError` before any launch).  On the CPU that branch runs K3's plain
    versions."""
    monkeypatch.setattr(attention, "_on_cuda", lambda t: True)
    routes = []
    mha = attention.mha_attention
    monkeypatch.setattr(attention, "mha_attention",
                        lambda *a, **kw: routes.append("k3") or mha(*a, **kw))
    q, k, v, g = (torch.from_numpy(t) for t in _inputs(1, 90, 2, 64, seed=12))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attention.flash_attention(*leaves, valid_len=80)
    assert routes == ["k3"]  # fp32 keeps the K3 branch: no plain route
    (out * g).sum().backward()
    want = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (port_mha.mha_attention_reference(*want, valid_len=80) * g).sum().backward()
    for a, w in zip(leaves, want):
        torch.testing.assert_close(a.grad, w.grad, rtol=RTOL, atol=ATOL)
    before = dict(port_mha.LAUNCHES)
    stats = torch.zeros(1, 2, 90, 2)
    picked = []

    def no_build(name):  # records the kernel the wrapper picked; builds nothing
        picked.append(name)
        raise LookupError(name)

    monkeypatch.setattr(port_mha, "_kernel_fn", no_build)
    with pytest.raises(LookupError):
        if wrapper == "forward":
            port_mha._launch_mha(q, k, v, 64**-0.5, 80, stats)
        else:
            port_mha._launch_mha_bwd(q, k, v, q, g, stats, 64**-0.5, 80)
    assert picked == ["mha_attention_fp32" if wrapper == "forward" else "mha_attention_bwd_fp32"]
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        if wrapper == "forward":
            port_mha._launch_mha(q.half(), k.half(), v.half(), 64**-0.5, 80, stats)
        else:
            port_mha._launch_mha_bwd(q, k, v, q, g.half(), stats, 64**-0.5, 80)
    assert port_mha.LAUNCHES == before and len(picked) == 1
