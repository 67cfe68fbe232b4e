"""The qkv attention kernel's plain version against the JAX package's TPU kernel.

The JAX kernel runs in Pallas interpret mode on the CPU (as the JAX package's
own tests run it), and its XLA reference `_qkv_ref` beside it.  The CUDA
kernel itself is held against the same plain version on the card by
`chip_smoke.py` and `tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.ops import mha_kernel as jax_mha
from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as port_mha

# fp32: both sides do the same fp32 arithmetic in another order -> ~1e-6.
# bf16: q, P and the output are rounded to bf16 (ulp 2^-8 of values <= ~3);
# the JAX kernel also rounds the scale*log2e constant to bf16 (weak typing),
# a 0.18% softmax temperature change the port does not copy -> 2e-2.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(b, n, heads, d, seed):
    return np.random.RandomState(seed).randn(b, n, 3 * heads * d).astype(np.float32)


CASES = [
    # (n, heads, head_dim, valid_len): padded (N % 128 == 0, keys masked) or ragged N
    (256, 2, 64, 250),
    (200, 2, 64, None),
    (200, 2, 64, 150),
    (128, 1, 128, None),
    (136, 1, 128, 100),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,heads,d,valid_len", CASES)
def test_plain_version_matches_jax_kernel(n, heads, d, valid_len, dtype):
    x = _qkv(2, n, heads, d, seed=n + d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    kernel = jax_mha.mha_qkv_attention(xj, heads, interpret=True, valid_len=valid_len)
    ref = jax_mha._qkv_ref(xj, heads, d**-0.5, valid_len)
    port = port_mha.mha_qkv_attention_reference(torch.from_numpy(x).to(tdt), heads,
                                                valid_len=valid_len)
    assert port.dtype == tdt and tuple(port.shape) == (2, n, heads * d)
    got = port.float().numpy()
    for want in (kernel, ref):
        want = np.asarray(want.astype(jnp.float32))
        # rows past valid_len are unspecified output (the caller slices them off)
        rows = n if valid_len is None else valid_len
        np.testing.assert_allclose(got[:, :rows], want[:, :rows], atol=TOL[dtype], rtol=0)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    before = dict(port_mha.LAUNCHES)
    x = torch.from_numpy(_qkv(2, 130, 2, 64, seed=1)).to(torch.bfloat16)
    out = port_mha.mha_qkv_attention(x, 2, valid_len=129)
    ref = port_mha.mha_qkv_attention_reference(x, 2, valid_len=129)
    assert torch.equal(out, ref)
    assert port_mha.LAUNCHES == before


@pytest.mark.parametrize(
    "shape,heads,kwargs,err",
    [
        ((2, 64 * 6), 2, {}, ValueError),  # not [B, N, 3*H*D]
        ((1, 8, 3 * 128 + 1), 2, {}, ValueError),  # last dim not 3 * width
        ((1, 8, 3 * 100), 3, {}, ValueError),  # width not divisible by heads
        ((1, 8, 3 * 128), 2, {"valid_len": 0}, ValueError),
        ((1, 8, 3 * 128), 2, {"valid_len": 9}, ValueError),
    ],
)
def test_wrapper_raises_on_bad_input(shape, heads, kwargs, err):
    with pytest.raises(err):
        port_mha.mha_qkv_attention(torch.zeros(shape), heads, **kwargs)


def test_qkv_supported_matches_jax():
    for heads, dim in [(12, 768), (8, 1024), (3, 96), (16, 1024), (12, 760), (6, 768)]:
        assert port_mha.qkv_supported(heads, dim) == jax_mha.qkv_supported(heads, dim)
