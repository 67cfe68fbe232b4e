"""K7's plain version (the port's `tools/exp_outproj_epilogue.py`) against the
JAX experiment's `qkv_out_attention` in Pallas interpret mode, loaded from
`tools/exp_outproj_epilogue.py` by path; the wrapper's CPU route and the
timing helpers the experiment uses.  The CUDA kernel is held against the
same plain version on the card by `chip_smoke.py` and
`tests/test_torch_cuda.py`."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel
from denseclip_vit_multimodal_tpu_torch.tools import exp_outproj_epilogue as port_exp
from denseclip_vit_multimodal_tpu_torch.utils import benchtime

ROOT = Path(__file__).resolve().parents[1]
# fp32: the same arithmetic in another order (the heads' products summed in
# another order; the script corrects the zero-pad denominator, the port
# excludes the pad keys).
FP32_RTOL, FP32_ATOL = 2e-5, 2e-6
# bf16 operands (fp32 output): each head's output is rounded to bf16 on both
# sides, and the TPU kernel also rounds scale * log2 e to bf16 (weak typing),
# so a few outputs move by one bf16 ulp before the fp32 projection.
BF16_REL_L2 = 1e-2


@pytest.fixture(scope="module")
def jax_exp():
    spec = importlib.util.spec_from_file_location("jax_exp_outproj_epilogue",
                                                  ROOT / "tools" / "exp_outproj_epilogue.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(b, n, heads, d, seed):
    rs = np.random.RandomState(seed)
    hd = heads * d
    return (rs.randn(b, n, 3 * hd).astype(np.float32),
            (rs.randn(hd, hd) * 0.05).astype(np.float32))


@pytest.mark.parametrize("dtype,n,heads,head_dim,valid_len", [
    (torch.float32, 200, 4, 64, None),  # ragged N: the script pads to 256, corrects the denominator
    (torch.float32, 256, 2, 128, 250),  # a caller's valid_len: the script's iota mask
    (torch.bfloat16, 200, 4, 64, None),
    (torch.bfloat16, 130, 2, 128, 100),
])
def test_plain_k7_matches_pallas_kernel(jax_exp, dtype, n, heads, head_dim, valid_len):
    qkv, w = _inputs(2, n, heads, head_dim, seed=n + heads)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    want = np.asarray(jax_exp.qkv_out_attention(jnp.asarray(qkv, jdt), jnp.asarray(w, jdt), heads,
                                                interpret=True, valid_len=valid_len))
    got = port_exp.qkv_out_attention_reference(torch.from_numpy(qkv).to(dtype),
                                               torch.from_numpy(w).to(dtype), heads,
                                               valid_len=valid_len)
    assert got.dtype == torch.float32 and got.shape == (2, n, heads * head_dim)
    rows = n if valid_len is None else valid_len  # the script's pad rows attend too: compare all
    got, want = got.numpy()[:, :rows], want[:, :rows]
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=FP32_RTOL, atol=FP32_ATOL)
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= BF16_REL_L2


def test_plain_k7_is_k1_then_the_out_projection():
    """K7's plain version equals K1's plain version followed by the matmul
    (fp32: summation order only), and the CPU wrapper is the plain version."""
    qkv, w = (torch.from_numpy(x) for x in _inputs(1, 70, 2, 64, seed=3))
    want = mha_kernel.mha_qkv_attention_reference(qkv, 2, valid_len=66) @ w
    before = dict(port_exp.LAUNCHES)
    got = port_exp.qkv_out_attention(qkv, w, 2, valid_len=66)
    assert port_exp.LAUNCHES == before
    torch.testing.assert_close(got, want, rtol=FP32_RTOL, atol=FP32_ATOL)
    torch.testing.assert_close(got, port_exp.qkv_out_attention_reference(qkv, w, 2, valid_len=66))


@pytest.mark.parametrize("case", ["valid_len", "not_qkv", "device", "fast_exp2"])
def test_wrapper_raises(case, monkeypatch):
    qkv, w = torch.zeros(1, 8, 3 * 128), torch.zeros(128, 128)
    if case == "valid_len":
        with pytest.raises(ValueError, match="valid_len"):
            port_exp.qkv_out_attention(qkv, w, 2, valid_len=9)
    elif case == "not_qkv":
        with pytest.raises(ValueError):
            port_exp.qkv_out_attention(torch.zeros(1, 8, 3 * 128 + 1), w, 2)
    elif case == "device":
        with pytest.raises(ValueError, match="for device"):
            port_exp.qkv_out_attention(qkv.to("meta"), w.to("meta"), 2)
    else:  # the JAX kernel reads DENSECLIP_FAST_EXP2, and so does the port
        monkeypatch.setenv("DENSECLIP_FAST_EXP2", "1")
        with pytest.raises(ValueError, match="for device"):  # still no meta route
            port_exp.qkv_out_attention(qkv.to("meta"), w.to("meta"), 2)
        qkv, w = (torch.from_numpy(x) for x in _inputs(1, 8, 2, 64, seed=1))
        got = port_exp.qkv_out_attention(qkv, w, 2)  # N 8, no valid_len: JAX's zero pads
        assert torch.equal(got, port_exp.qkv_out_attention_reference(
            qkv, w, 2, exp_mode=mha_kernel.EXP_POLY_ZEROED))
        monkeypatch.setenv("DENSECLIP_FAST_EXP2", "0")
        assert not torch.equal(got, port_exp.qkv_out_attention(qkv, w, 2))


def test_adaptive_min_time_stops_when_the_two_fastest_agree():
    """The JAX module's stop rule, on runs that report their own seconds."""
    times = iter([1.0, 0.5, 0.505, 9.0])
    best, drift = benchtime.adaptive_min_time(lambda: next(times))
    assert best == 0.5 and drift == pytest.approx(100.0)  # stopped before the fourth
    times = iter([1.0, 2.0, 3.0])
    best, _ = benchtime.adaptive_min_time(lambda: next(times), max_rounds=3)
    assert best == 1.0
    best, _ = benchtime.adaptive_min_time(lambda: None, max_rounds=2)  # the host clock
    assert best >= 0.0


def test_card_timing_refuses_to_time_the_cpu(monkeypatch):
    """No CUDA device: the card's timer and the experiment raise rather than
    report CPU numbers."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchtime.device_loop_time(lambda: None, (), 3)
    with pytest.raises(SystemExit):
        port_exp.main([])
