"""The one-shot attention K3 of the port (`ops/mha_kernel.py::mha_attention`, its
plain version and the `flash_attention` dispatch) against the JAX package's
`mha_attention`, whose Pallas kernel runs here in interpret mode (as the JAX
package's own tests run it), and the port's GPU self-test.  The CUDA kernel
itself is held against the same plain version on the card by `chip_smoke.py`
and `tests/test_torch_cuda.py`.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.models import layers as j_layers
from denseclip_vit_multimodal_tpu.ops import attention as j_attention
from denseclip_vit_multimodal_tpu.ops import mha_kernel as jax_mha
from denseclip_vit_multimodal_tpu_torch.convert import load_flax_variables
from denseclip_vit_multimodal_tpu_torch.models import layers as t_layers
from denseclip_vit_multimodal_tpu_torch.ops import attention, mha_kernel
from denseclip_vit_multimodal_tpu_torch.tools import selftest

ROOT = Path(__file__).resolve().parents[1]
# fp32: the same arithmetic in another order (JAX's own kernel-vs-reference
# limit, tests/test_mha_kernel.py).  bf16: q, P and the output are rounded
# to bf16 (ulp 2^-8 near 1), and the JAX kernel rounds the scale * log2 e
# constant to bf16 (weak typing; 0.18% to 0.33% of softmax temperature at
# head dims 64 to 256), which the port keeps in fp32 (ROADMAP §3): measured
# here max abs <= 7.8e-3, rel. L2 4.4e-3 to 5.2e-3 over the cases below.
FP32_TOL = 2e-5
BF16_MAX, BF16_REL = 2e-2, 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

CASES = [
    # (b, n, heads, head_dim, valid_len, key_shift): JAX's shapes, then head dims 128 / 256
    (2, 64, 3, 64, None, 0.0),
    (2, 200, 3, 64, None, 0.0),
    (2, 513, 3, 64, None, 0.0),
    (1, 130, 2, 64, None, 5.0),  # large keys: pad columns must take no mass
    (2, 256, 3, 64, 250, 0.0),  # caller pads, masked by valid_len
    (1, 200, 2, 128, 150, 0.0),
    (1, 136, 1, 256, None, 0.0),
    (2, 256, 2, 256, 211, 0.0),
]


def _inputs(b, n, heads, d, seed, key_shift=0.0):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, n, heads, d).astype(np.float32) for _ in range(3))
    return q, k + np.float32(key_shift), v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,heads,d,valid_len,key_shift", CASES)
def test_plain_k3_matches_jax_kernel(b, n, heads, d, valid_len, key_shift, dtype):
    q, k, v = _inputs(b, n, heads, d, seed=n + d, key_shift=key_shift)
    jdt, tdt = DTYPES[dtype]
    want = jax_mha.mha_attention(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
                                 interpret=True, valid_len=valid_len)
    got = mha_kernel.mha_attention_reference(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                             valid_len=valid_len)
    assert got.dtype == tdt and tuple(got.shape) == (b, n, heads, d)
    rows = n if valid_len is None else valid_len  # later rows are left to the caller
    got = got.float().numpy()[:, :rows]
    want = np.asarray(want.astype(jnp.float32))[:, :rows]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_MAX
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= BF16_REL


def test_plain_k3_chunks_and_strided_views(monkeypatch):
    """Query chunks that do not divide N, and q / k / v as views of one fused
    projection, give the contiguous, unchunked answer."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 300, 2, 64, seed=3))
    want = mha_kernel.mha_attention_reference(q, k, v, sm_scale=0.2, valid_len=280)
    monkeypatch.setattr(mha_kernel, "_REF_CHUNK", 128)
    qkv = torch.cat([x.reshape(1, 300, 128) for x in (q, k, v)], dim=-1)
    views = [t.view(1, 300, 2, 64) for t in qkv.split(128, dim=-1)]
    got = mha_kernel.mha_attention_reference(*views, sm_scale=0.2, valid_len=280)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # K1's plain version is the same function on the fused tensor
    k1 = mha_kernel.mha_qkv_attention_reference(qkv, 2, sm_scale=0.2, valid_len=280)
    torch.testing.assert_close(k1.view(1, 300, 2, 64), want, rtol=1e-6, atol=1e-6)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    before = dict(mha_kernel.LAUNCHES)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(2, 130, 2, 64, seed=1))
    out = mha_kernel.mha_attention(q, k, v, valid_len=129)
    assert torch.equal(out, mha_kernel.mha_attention_reference(q, k, v, valid_len=129))
    assert mha_kernel.LAUNCHES == before


@pytest.mark.parametrize("case", ["shapes", "valid_len", "grad", "device"])
def test_wrapper_raises(case):
    q = torch.zeros(1, 8, 2, 64)
    if case == "shapes":
        with pytest.raises(ValueError, match=r"\[B, N, H, D\]"):
            mha_kernel.mha_attention(q, q[:, :4], q)
    elif case == "valid_len":
        with pytest.raises(ValueError, match="valid_len"):
            mha_kernel.mha_attention(q, q, q, valid_len=9)
    elif case == "grad":  # the autograd route checks its input the same way
        with pytest.raises(ValueError, match="valid_len"):
            mha_kernel.mha_attention(q.clone().requires_grad_(True), q, q, valid_len=9)
    else:
        m = torch.zeros(1, 8, 2, 64, device="meta")
        with pytest.raises(ValueError, match="no one-shot attention for device"):
            mha_kernel.mha_attention(m, m, m)


# --------------------------------------------------------------------------
# ops/attention.py: the dispatch
# --------------------------------------------------------------------------


@pytest.fixture
def routes(monkeypatch):
    """Record which of K3, K4 and plain attention `flash_attention` takes;
    the one-shot limit lowered from 8448 to 512 tokens keeps the inputs small."""
    monkeypatch.setattr(attention, "_ONESHOT_MAX_SEQ", 512)
    calls = []
    for name, route in (("mha_attention", "k3"), ("flash_attention_reference", "k4"),
                        ("plain_attention", "plain")):
        fn = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *a, _fn=fn, _r=route, **kw: calls.append(_r) or _fn(*a, **kw))
    return calls


@pytest.mark.parametrize("n,d,causal,grad,route", [
    (500, 64, False, False, "k3"),
    (500, 256, False, False, "k3"),  # head dim 256 on the K3 branch: K3 takes it
    (600, 64, False, False, "k4"),  # longer than the one-shot limit
    (600, 256, False, False, "k4"),  # head dim 256 on the K4 branch: K4 takes it
    (300, 256, True, False, "k4"),
    (300, 128, True, False, "k4"),
    (500, 64, False, True, "k3"),  # autograd on the K3 branch: K3 and its backward
])
def test_flash_attention_routes(routes, n, d, causal, grad, route):
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, n, 1, d, seed=n))
    if grad:
        q.requires_grad_(True)
    out = attention.flash_attention(q, k, v, causal=causal, valid_len=n - 5)
    assert routes == [route]
    rows = n - 5
    want = attention.plain_attention(q.detach(), k, v, causal, rows)
    torch.testing.assert_close(out[:, :rows].detach(), want[:, :rows], rtol=1e-4, atol=1e-5)
    if grad:
        out[:, :rows].sum().backward()
        assert torch.isfinite(q.grad).all() and q.grad.abs().sum() > 0


def test_flash_supported_admits_head_dim_256(monkeypatch):
    x = lambda d, dt=torch.bfloat16: torch.zeros(1, 1024, 2, d, dtype=dt)
    assert not attention.flash_supported(x(256))  # a CPU tensor: no kernel
    monkeypatch.setattr(attention, "_on_cuda", lambda t: True)
    assert [attention.flash_supported(x(d)) for d in (64, 128, 256, 32, 96)] == [
        True, True, True, False, False]
    assert attention.flash_supported(x(64, torch.float32))  # the kernels take fp32 too
    assert not attention.flash_supported(torch.zeros(1, 1023, 2, 64, dtype=torch.bfloat16))


@pytest.mark.parametrize("valid_len", [None, 1025])
def test_head_dim_256_module_matches_jax(monkeypatch, valid_len):
    """A width-512 layer with 2 heads of 256 misses the fused-qkv route on
    both sides and reaches the one-shot kernel through `flash_attention`:
    JAX's in interpret mode, the port's plain version (both sides believe
    they are on their accelerator)."""
    import jax

    monkeypatch.setattr(j_attention, "_on_tpu", lambda: True)
    monkeypatch.setattr(attention, "_on_cuda", lambda t: True)
    calls = {"jax": 0, "port": 0}
    j_mha, t_mha = jax_mha.mha_attention, mha_kernel.mha_attention

    def jax_interpret(*args, **kwargs):
        calls["jax"] += 1
        return j_mha(*args, **dict(kwargs, interpret=True))

    def port_counted(*args, **kwargs):
        calls["port"] += 1
        return t_mha(*args, **kwargs)

    monkeypatch.setattr(jax_mha, "mha_attention", jax_interpret)
    monkeypatch.setattr(attention, "mha_attention", port_counted)
    x = np.random.RandomState(4).randn(1, 1030, 512).astype(np.float32)
    jm = j_layers.MultiHeadAttention(num_heads=2, dtype=jnp.bfloat16)
    variables = jm.init(jax.random.PRNGKey(0), x)
    calls["jax"] = 0  # init ran the module once
    want = np.asarray(jm.apply(variables, x, valid_len=valid_len).astype(jnp.float32))
    tm = t_layers.MultiHeadAttention(512, 2, dtype=torch.bfloat16)
    load_flax_variables(tm, jax.tree.map(np.asarray, dict(variables)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(torch.bfloat16), valid_len=valid_len).float().numpy()
    assert calls == {"jax": 1, "port": 1}
    rows = 1030 if valid_len is None else valid_len
    got, want = got[:, :rows], want[:, :rows]
    # bf16 projections on both sides (rounded at other points) and K3's
    # bf16 limits above
    assert np.abs(got - want).max() <= 5e-2
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= BF16_REL


# --------------------------------------------------------------------------
# tools/selftest.py
# --------------------------------------------------------------------------


def test_selftest_needs_cuda(capsys):
    assert not torch.cuda.is_available()
    assert selftest.main([]) == 1
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and "SELFTEST" not in out.out
    assert selftest.main(["--cpu"]) == 2  # takes no arguments, and no CPU fallback


def test_selftest_module_exits_nonzero_without_cuda():
    proc = subprocess.run([sys.executable, "-m", "denseclip_vit_multimodal_tpu_torch.tools.selftest"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "SELFTEST OK" not in proc.stdout
