"""The softmax knobs' kernel variants and the fp32 K6 / K7 sources on the
CPU emulation.

Compiled by the host compiler against `tests/cuda_emu/`
(`tests/torch_cuda_emu.py::_build`), each entry against its plain version
in the same exp mode (`ops/mha_kernel.py::softmax_modes`):
`csrc/qkv_attention_knobs.cu` and `csrc/mha_attention_knobs.cu` (K1 / K3 on
the wgmma core under `kPoly` / `kBf16`: a first pass over K for the row
max), `csrc/attention_bwd_knobs.cu` (K2 / K3's backward under
`TpuPolyPolicy`), the `_knob` entries of `csrc/attention_fp32.cu`,
`csrc/attention_bwd_fp32.cu`, `csrc/ln_qkv_attention.cu` and
`csrc/qkv_out_attention.cu`, and the new `csrc/ln_qkv_attention_fp32.cu`
and `csrc/qkv_out_attention_fp32.cu`.  Every case also checks that the
variant sees its knob: it lies at most a fifth as far from the plain version
in its mode as from the knob-off one.  The plain versions are held to the
JAX kernels under the knobs in `tests/test_torch_softmax_knobs.py`.  About
40 s on one worker (the builds about 25 s of it).
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu_torch.ops import lnqkv_kernel
from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel as M
from denseclip_vit_multimodal_tpu_torch.tools import exp_outproj_epilogue
from torch_cuda_emu import LOG2E, _build_all

EXACT, POLY, ZEROED, EBF16 = M.EXP_EXACT, M.EXP_POLY, M.EXP_POLY_ZEROED, M.EXP_BF16
FP32_MAX, FP32_REL = 1e-4, 1e-5
FP32_GRAD_REL = 1e-4
BF16_MAX, BF16_REL = 2e-2, 5e-3
BF16_GRAD_REL = 2e-3
SEES = 5.0
STATS_M, STATS_L = 5e-5, 3e-5
# EXP_BF16's row sums: one flipped bf16 rounding of s - m (the scores' fp32
# sums run in another order) moves its p by up to 2^-8 |s - m| ln 2
STATS_L_BF16 = 2e-3


@pytest.fixture(scope="module")
def fns(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a C++20 host compiler (g++)")
    out = tmp_path_factory.mktemp("cuda_emu_knobs")
    ptr, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    sources = {"k1": "qkv_attention_knobs", "k3": "mha_attention_knobs",
               "bwd": "attention_bwd_knobs", "f32": "attention_fp32",
               "f32bwd": "attention_bwd_fp32", "k6": "ln_qkv_attention",
               "k6f32": "ln_qkv_attention_fp32", "k7": "qkv_out_attention",
               "k7f32": "qkv_out_attention_fp32"}
    libs = dict(zip(sources, _build_all(sources.values(), out)))
    table = {
        "k1": (libs["k1"].qkv_attention_bf16_knob, [ptr] * 3 + [i] * 5 + [f, i, ptr]),
        "k3": (libs["k3"].mha_attention_bf16_knob, [ptr] * 5 + [ll] * 9 + [i] * 5 + [f, i, ptr]),
        "k2": (libs["bwd"].qkv_attention_bwd_bf16_knob, [ptr] * 7 + [i] * 5 + [f, f, i, ptr]),
        "k3bwd": (libs["bwd"].mha_attention_bwd_bf16_knob,
                  [ptr] * 11 + [ll] * 9 + [i] * 5 + [f, f, i, ptr]),
        "k1f32": (libs["f32"].qkv_attention_fp32_knob, [ptr] * 3 + [i] * 5 + [f, i, ptr]),
        "k3f32": (libs["f32"].mha_attention_fp32_knob,
                  [ptr] * 5 + [ll] * 9 + [i] * 5 + [f, i, ptr]),
        "k2f32": (libs["f32bwd"].qkv_attention_bwd_fp32_knob,
                  [ptr] * 6 + [i] * 5 + [f, f, i, ptr]),
        "k3bwdf32": (libs["f32bwd"].mha_attention_bwd_fp32_knob,
                     [ptr] * 10 + [ll] * 9 + [i] * 5 + [f, f, i, ptr]),
        "k7": (libs["k7"].qkv_out_attention_bf16_knob, [ptr] * 3 + [i] * 5 + [f, i, ptr]),
        "k7f32": (libs["k7f32"].qkv_out_attention_fp32, [ptr] * 4 + [i] * 5 + [f, i, ptr]),
    }
    for fn, argtypes in table.values():
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    got = {name: fn for name, (fn, _) in table.items()}
    got["k6"] = lnqkv_kernel.bind_entry_points(libs["k6"])
    got["k6f32"] = lnqkv_kernel.bind_fp32_entry_points(libs["k6f32"])
    return got


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _assert_close_and_sees(got, want, want_off, rel_lim, max_lim=None, sees=True):
    """Within the limits of the plain version in the mode and, with `sees`, a
    fifth as far from it as from the knob-off one.  bf16 outputs under
    FAST_EXP2 pass `sees=False`: the polynomial's 8.4e-5 hides under their
    rounding, and the row sums (`_assert_stats`) show it instead."""
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= rel_lim, (_rel(got, want), _rel(got, want_off))
    if max_lim is not None:
        assert float((got.double() - want.double()).abs().max()) <= max_lim
    if sees:
        assert _rel(got, want) * SEES <= _rel(got, want_off), (_rel(got, want),
                                                               _rel(got, want_off))


def _sees(dtype, mode):
    return dtype == torch.float32 or mode == EBF16


def _qkv(b, n, heads, d, kv, dtype, seed):
    """Seeded qkv (scale 2: sharp enough rows for the knobs to show), NaN
    in the K / V rows past kv."""
    gen = torch.Generator().manual_seed(seed)
    qkv = (torch.randn(b, n, 3 * heads * d, generator=gen) * 2).to(dtype)
    qkv[:, kv:, heads * d:] = float("nan")
    return qkv


def _plain_stats(q, k, kv, scale, mode):
    s = torch.einsum("bnhd,bmhd->bhnm", (q.float() * (scale * LOG2E)).to(q.dtype).float(),
                     k[:, :kv].float())
    m = M.row_max(s, mode)
    return m[..., 0], M.softmax_exp(s - m, mode).sum(-1)


def _assert_stats(stats, q, k, kv, scale, mode):
    """Row max and sum against the plain ones in the mode; under FAST_EXP2
    the sums see the knob (a fifth as far as from the exp2 sums)."""
    m, l = _plain_stats(q, k, kv, scale, mode)
    assert float((stats[..., 0] - m).abs().max()) <= STATS_M
    lim = STATS_L_BF16 if mode == EBF16 else STATS_L
    err = float(((stats[..., 1] - l) / l).abs().max())
    assert err <= lim
    if mode in (POLY, ZEROED):
        m0, l0 = _plain_stats(q, k, kv, scale, EXACT)
        shift = torch.exp2(m - m0)  # the exp2 sums at the same max
        assert err * SEES <= float(((stats[..., 1] - l0 / shift) / l).abs().max())


@pytest.mark.parametrize("dtype,mode,b,n,heads,d,kv", [
    (torch.bfloat16, POLY, 1, 200, 2, 64, 190),
    (torch.bfloat16, ZEROED, 1, 200, 2, 64, 200),  # JAX's zero pads: the max floored at 0
    (torch.bfloat16, EBF16, 1, 150, 1, 128, 140),
    (torch.float32, POLY, 2, 90, 2, 64, 70),
    (torch.float32, ZEROED, 1, 97, 1, 128, 97),
])
def test_k1_and_k2_knob_variants(fns, dtype, mode, b, n, heads, d, kv):
    """K1 under the mode (output, row statistics), then K2 on its output and
    statistics (FAST_EXP2 modes: EXP_BF16's backward is the exact one)."""
    qkv = _qkv(b, n, heads, d, kv, dtype, seed=n + d + mode)
    hd, scale = heads * d, d**-0.5
    fp32 = dtype == torch.float32
    out = torch.full((b, n, hd), float("nan"), dtype=dtype)
    stats = torch.empty(b, heads, n, 2)
    assert fns["k1f32" if fp32 else "k1"](qkv.data_ptr(), out.data_ptr(), stats.data_ptr(), b, n,
                                          heads, d, kv, scale * LOG2E, mode, None) == 0
    want = M.mha_qkv_attention_reference(qkv, heads, valid_len=kv, exp_mode=mode)
    want_off = M.mha_qkv_attention_reference(qkv, heads, valid_len=kv)
    _assert_close_and_sees(out[:, :kv], want[:, :kv], want_off[:, :kv],
                           FP32_REL if fp32 else BF16_REL, FP32_MAX if fp32 else BF16_MAX,
                           _sees(dtype, mode))
    q, k = (t.view(b, n, heads, d) for t in qkv.split(hd, dim=-1)[:2])
    _assert_stats(stats, q, k, kv, scale, mode)
    if mode == EBF16:
        return
    dout = torch.randn(b, n, hd, generator=torch.Generator().manual_seed(1)).to(dtype)
    dqkv = torch.full_like(qkv, float("nan"))
    dcoef = torch.empty(b, heads, n)
    if fp32:
        err = fns["k2f32"](qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), stats.data_ptr(),
                           dcoef.data_ptr(), dqkv.data_ptr(), b, n, heads, d, kv, scale * LOG2E,
                           scale, 1, None)
    else:
        scratch = torch.empty(2, b, heads, n, d, dtype=torch.bfloat16)
        err = fns["k2"](qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), stats.data_ptr(),
                        dcoef.data_ptr(), scratch.data_ptr(), dqkv.data_ptr(), b, n, heads, d, kv,
                        scale * LOG2E, scale, 1, None)
    assert err == 0
    want_g = M.mha_qkv_attention_bwd_reference(qkv, want, dout, heads, valid_len=kv,
                                               exp_mode=mode)
    off_g = M.mha_qkv_attention_bwd_reference(qkv, want_off, dout, heads, valid_len=kv)
    cols = lambda t: torch.cat([t[:, :, :hd], t[:, :kv, hd:].reshape(b, -1, hd)], dim=1)
    _assert_close_and_sees(cols(dqkv), cols(want_g), cols(off_g),
                           FP32_GRAD_REL if fp32 else BF16_GRAD_REL)
    assert not dqkv[:, kv:, hd:].any()  # masked keys: dk = dv = 0 exactly


@pytest.mark.parametrize("dtype,mode,d", [
    (torch.bfloat16, POLY, 64), (torch.bfloat16, ZEROED, 256), (torch.bfloat16, EBF16, 128),
    (torch.float32, POLY, 256),
])
def test_k3_and_its_backward_knob_variants(fns, dtype, mode, d):
    """K3 on strided views under the mode, then K3's backward (FAST_EXP2)."""
    b, n, heads, kv = 1, 100, 2, 95
    qkv = _qkv(b, n, heads, d, kv, dtype, seed=d + mode)
    q, k, v = (t.view(b, n, heads, d) for t in qkv.split(heads * d, dim=-1))
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    scale, fp32 = d**-0.5, dtype == torch.float32
    out = torch.full((b, n, heads, d), float("nan"), dtype=dtype)
    stats = torch.empty(b, heads, n, 2)
    assert fns["k3f32" if fp32 else "k3"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                          out.data_ptr(), stats.data_ptr(), *strides, b, n, heads,
                                          d, kv, scale * LOG2E, mode, None) == 0
    want = M.mha_attention_reference(q, k, v, valid_len=kv, exp_mode=mode)
    want_off = M.mha_attention_reference(q, k, v, valid_len=kv)
    _assert_close_and_sees(out[:, :kv], want[:, :kv], want_off[:, :kv],
                           FP32_REL if fp32 else BF16_REL, FP32_MAX if fp32 else BF16_MAX,
                           _sees(dtype, mode))
    _assert_stats(stats, q, k, kv, scale, mode)
    if mode == EBF16:
        return
    dout = torch.randn(b, n, heads, d, generator=torch.Generator().manual_seed(2)).to(dtype)
    grads = [torch.full((b, n, heads, d), float("nan"), dtype=dtype) for _ in range(3)]
    dcoef = torch.empty(b, heads, n)
    scratch = [] if fp32 else [torch.empty(2, b, heads, n, d, dtype=torch.bfloat16)]
    assert fns["k3bwdf32" if fp32 else "k3bwd"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        stats.data_ptr(), dcoef.data_ptr(), *(t.data_ptr() for t in scratch),
        *(g.data_ptr() for g in grads), *strides, b, n, heads, d, kv, scale * LOG2E, scale, 1,
        None) == 0
    want_g = M.mha_attention_bwd_reference(q, k, v, want, dout, valid_len=kv, exp_mode=mode)
    off_g = M.mha_attention_bwd_reference(q, k, v, want_off, dout, valid_len=kv)
    for g, w, o in zip(grads, want_g, off_g):
        assert _rel(g[:, :kv], w[:, :kv]) <= (FP32_GRAD_REL if fp32 else BF16_GRAD_REL)
    assert sum(_rel(g[:, :kv], w[:, :kv]) for g, w in zip(grads, want_g)) * SEES <= sum(
        _rel(g[:, :kv], o[:, :kv]) for g, o in zip(grads, off_g))


def _lnqkv_inputs(b, n, dim, hd, dtype, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, n, dim).astype(np.float32)).to(dtype)
    gamma = torch.from_numpy(1.0 + 0.1 * rng.randn(dim).astype(np.float32))
    beta = torch.from_numpy(0.1 * rng.randn(dim).astype(np.float32))
    limit = 4 * (6.0 / (4 * dim)) ** 0.5  # sharper rows than the init's, so the knob shows
    wt = torch.from_numpy(((rng.rand(3 * hd, dim) * 2 - 1) * limit).astype(np.float32))
    bias = torch.from_numpy(0.02 * rng.randn(3 * hd).astype(np.float32))
    return x, gamma, beta, wt.to(dtype), bias


@pytest.mark.parametrize("dtype,mode,b,n,dim,heads,d,kv", [
    (torch.bfloat16, POLY, 1, 150, 256, 4, 64, 140),
    (torch.float32, EXACT, 1, 150, 256, 4, 64, 140),
    (torch.float32, POLY, 2, 70, 128, 1, 128, 66),
])
def test_k6_knob_and_fp32(fns, dtype, mode, b, n, dim, heads, d, kv):
    """K6 under FAST_EXP2 (bf16: its second stage on its own workspace, which
    the plain version's rounds differently at a bf16 step) and the fp32 K6:
    the whole kernel, its first stage's statistics bitwise and workspace."""
    x, gamma, beta, wt, bias = _lnqkv_inputs(b, n, dim, heads * d, dtype, seed=n + mode)
    x[:, kv:] = float("nan")  # pad rows: keys past kv are never read
    hd, scale, fp32 = heads * d, d**-0.5, dtype == torch.float32
    ws = torch.full((b, n, 3 * hd), float("nan"), dtype=dtype)
    out = torch.full((b, n, hd), float("nan"), dtype=dtype)
    entry = fns["k6f32"]["attention"] if fp32 else fns["k6"]["attention_knob"]
    assert entry(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                 ws.data_ptr(), out.data_ptr(), b, n, dim, heads, d, kv, scale * LOG2E, 1e-5,
                 mode, None) == 0
    if fp32:
        want = lnqkv_kernel.ln_qkv_attention_reference(x, gamma, beta, wt.t(), bias, heads,
                                                       valid_len=kv, exp_mode=mode)
        want_off = lnqkv_kernel.ln_qkv_attention_reference(x, gamma, beta, wt.t(), bias, heads,
                                                           valid_len=kv)
        assert float((out[:, :kv] - want[:, :kv]).abs().max()) <= FP32_MAX
        assert _rel(out[:, :kv], want[:, :kv]) <= FP32_REL
        if mode != EXACT:
            _assert_close_and_sees(out[:, :kv], want[:, :kv], want_off[:, :kv], FP32_REL)
        stats = torch.full((b * n, 2), float("nan"))
        ws2 = torch.full_like(ws, float("nan"))
        assert fns["k6f32"]["projection"](x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                          wt.data_ptr(), bias.data_ptr(), stats.data_ptr(),
                                          ws2.data_ptr(), b * n, dim, hd, scale * LOG2E, 1e-5,
                                          None) == 0
        assert torch.equal(stats.view(b, n, 2)[:, :kv],
                           lnqkv_kernel.ln_qkv_stats_reference(x)[:, :kv])
        plain_ws = lnqkv_kernel.ln_qkv_projection_reference(x, gamma, beta, wt.t(), bias, heads)
        assert _rel(ws2[:, :kv], plain_ws[:, :kv]) <= FP32_REL
        assert torch.equal(ws2[:, :kv], ws[:, :kv])
    else:  # the second stage against attention on the kernel's own workspace
        q, k, v = (t.view(b, n, heads, d) for t in ws.split(hd, dim=-1))
        want = M.attention_prescaled(q, k, v, kv, mode).reshape(b, n, hd)
        want_off = M.attention_prescaled(q, k, v, kv).reshape(b, n, hd)
        _assert_close_and_sees(out[:, :kv], want[:, :kv], want_off[:, :kv], BF16_REL, BF16_MAX)


@pytest.mark.parametrize("dtype,mode,b,n,heads,d,kv", [
    (torch.bfloat16, POLY, 1, 150, 2, 64, 140),
    (torch.bfloat16, ZEROED, 1, 140, 2, 128, 140),
    (torch.float32, EXACT, 1, 140, 2, 128, 133),
    (torch.float32, POLY, 2, 100, 3, 64, 100),
    (torch.float32, ZEROED, 1, 150, 2, 64, 150),
])
def test_k7_knob_and_fp32(fns, dtype, mode, b, n, heads, d, kv):
    """K7 under FAST_EXP2 and the fp32 K7 against the plain version; nothing
    is written past the output's last row."""
    hd = heads * d
    rng = np.random.RandomState(n + mode)
    qkv = torch.from_numpy(rng.randn(b, n, 3 * hd).astype(np.float32) * 2).to(dtype)
    w = torch.from_numpy((rng.randn(hd, hd) * 0.05).astype(np.float32)).to(dtype)
    qkv[:, kv:, hd:] = float("nan")
    buf = torch.full((b * n + 64, hd), float("nan"))
    fp32 = dtype == torch.float32
    ws = [torch.full((b, n, hd), float("nan"))] if fp32 else []
    assert fns["k7f32" if fp32 else "k7"](qkv.data_ptr(), w.data_ptr(),
                                          *(t.data_ptr() for t in ws), buf.data_ptr(), b, n,
                                          heads, d, kv, d**-0.5 * LOG2E, mode, None) == 0
    assert torch.isnan(buf[b * n:]).all()
    got = buf[:b * n].view(b, n, hd)
    want = exp_outproj_epilogue.qkv_out_attention_reference(qkv, w, heads, valid_len=kv,
                                                            exp_mode=mode)
    want_off = exp_outproj_epilogue.qkv_out_attention_reference(qkv, w, heads, valid_len=kv)
    if mode == EXACT:
        assert float((got - want).abs().max()) <= FP32_MAX and _rel(got, want) <= FP32_REL
    else:
        _assert_close_and_sees(got, want, want_off, FP32_REL if fp32 else BF16_REL)


def test_knob_entries_refuse_modes_they_do_not_have(fns):
    """Before any launch: EXP_BF16 in fp32, exact or unknown modes on the
    bf16 knob sources, K6's modes past the polynomial, K7's EXP_BF16."""
    qkv = torch.zeros(1, 64, 3 * 128, dtype=torch.bfloat16)
    out = torch.zeros(1, 64, 128, dtype=torch.bfloat16)
    for mode in (EXACT, 4, -1):
        assert fns["k1"](qkv.data_ptr(), out.data_ptr(), None, 1, 64, 2, 64, 64, 1.0, mode,
                         None) != 0
    f = torch.zeros(1, 64, 3 * 128)
    assert fns["k1f32"](f.data_ptr(), f.data_ptr(), None, 1, 64, 2, 64, 64, 1.0, EBF16,
                        None) != 0
    assert fns["k7"](qkv.data_ptr(), qkv.data_ptr(), f.data_ptr(), 1, 64, 2, 64, 64, 1.0, EBF16,
                     None) != 0
    x = torch.zeros(1, 64, 128, dtype=torch.bfloat16)
    assert fns["k6"]["attention_knob"](x.data_ptr(), *([f.data_ptr()] * 6), 1, 64, 128, 2, 64, 64,
                                       1.0, 1e-5, ZEROED, None) != 0
    assert fns["k2"](*([qkv.data_ptr()] * 7), 1, 64, 2, 64, 64, 1.0, 1.0, 0, None) != 0
