"""The attention kernels' CUDA sources, run on the CPU.

The backward sources (`csrc/qkv_attention_bwd.cu`: K2, K3's backward;
`csrc/flash_attention_bwd.cu`: K4b, on their core `csrc/attention_bwd.cuh`)
are in `tests/test_torch_cuda_emulated_oneshot_bwd.py` and
`tests/test_torch_cuda_emulated_flash_bwd.py`; K4's forward is held here to
feed K4b.  The forward: `csrc/qkv_attention.cu` (K1), `csrc/mha_attention.cu` (K3) and
`csrc/flash_attention.cu` (K4) on their core `csrc/attention_fwd.cuh`.  The
int8 attention `csrc/qkv_attention_int8.cu` (K5: 8-bit wgmma, TMA with the
64-byte swizzle) and its prologue `csrc/quantize_qkv_int8.cu`, the prologue
held bitwise to its plain version.  K6 (`csrc/ln_qkv_attention.cu`) and K7
(`csrc/qkv_out_attention.cu`: the attention with every head's output kept
in shared memory, then the out-projection by wgmma with W_out's tiles
MN-major).  Each is compiled by the host
compiler against the CPU emulation in `tests/cuda_emu/` (one std::thread per
CUDA thread; ldmatrix, mma.sync and shuffles emulated per warp; cp.async
deferred to its wait; for the forward, wgmma from its shared-memory
descriptors with the 128-byte (64-byte for K5) swizzle, deferred to its wait, TMA box loads
with zero fill past the tensor map's extent, mbarriers with transaction
counts that fail on a thread's second arrival in one phase, named
barriers) and called through its plain C entry point on CPU
tensors, at small shapes that reach every branch: ragged tiles, pad keys
(NaN in the forward's K / V rows past valid_len) and pad rows, causal
masks, head dims 64 / 128 / 256.  Each output is held to the chip's limits
against the port's plain versions, the forward's row statistics to the
plain row max and sum, masked keys (and K4b's pad rows) to exactly 0, and a
second call bitwise to the first.  What only the card shows (timing, the
compiler's registers, a real race) stays with `tests/test_torch_cuda.py`
and `chip_smoke.py`.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu_torch.ops import attention
from denseclip_vit_multimodal_tpu_torch.ops import lnqkv_kernel
from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel
from denseclip_vit_multimodal_tpu_torch.tools import exp_outproj_epilogue, time_fwd_trees
from torch_cuda_emu import (  # noqa: F401  (libs: a fixture)
    INT8_MAX_TOL,
    INT8_REL_TOL,
    LOG2E,
    _assert_grads_close,
    _build,
    _inputs,
    _nan_like,
    _row_stats,
    libs,
)

# ---- the forward core (csrc/attention_fwd.cuh): K1, K3 and K4 ----

# chip_smoke.py's limits for the forward kernels against their plain versions
FWD_MAX_TOL, FWD_MEAN_TOL, FWD_REL_TOL = 2e-2, 5e-4, 5e-3
# and for the row statistics they write: max abs error of the row max (log2
# units), max relative error of the row sum
STATS_M_TOL, STATS_L_TOL = 5e-5, 3e-5


@pytest.fixture(scope="module")
def fwd_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a C++20 host compiler (g++)")
    out = tmp_path_factory.mktemp("cuda_emu_fwd")
    ptr, i64, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    qkv = _build("qkv_attention", out).qkv_attention_bf16
    mha = _build("mha_attention", out).mha_attention_bf16
    flash = _build("flash_attention", out).flash_attention_bf16
    qkv.argtypes = [ptr] * 3 + [i] * 5 + [f, ptr]
    mha.argtypes = [ptr] * 5 + [i64] * 9 + [i] * 5 + [f, ptr]
    flash.argtypes = [ptr] * 5 + [i64] * 9 + [i] * 6 + [f, ptr]
    qkv.restype = mha.restype = flash.restype = ctypes.c_int
    return {"qkv": qkv, "mha": mha, "flash": flash}


def _poison_pad_keys(k, v, kv):
    """NaN in every K / V row at or past kv (they must never reach a real row)."""
    k[:, kv:] = float("nan")
    v[:, kv:] = float("nan")


def _assert_fwd_close(out, want, stats, want_stats):
    assert torch.isfinite(out.float()).all()
    err = (out.float() - want.float()).abs()
    assert float(err.max()) <= FWD_MAX_TOL
    assert float(err.mean()) <= FWD_MEAN_TOL
    assert float((out.float() - want.float()).norm() / want.float().norm()) <= FWD_REL_TOL
    m, l = stats[..., 0], stats[..., 1]
    assert float((m - want_stats[..., 0]).abs().max()) <= STATS_M_TOL
    assert float(((l - want_stats[..., 1]) / want_stats[..., 1]).abs().max()) <= STATS_L_TOL


def _run_fwd_mha(fn, b, n, heads, d, kv, poison):
    _, q, k, v, _ = _inputs(b, n, heads, d, seed=3 * n + d)
    if poison:
        _poison_pad_keys(k, v, kv)
    scale = d**-0.5
    out = torch.full((b, n, heads, d), float("nan"), dtype=torch.bfloat16)
    stats = torch.full((b, heads, n, 2), float("nan"))
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), stats.data_ptr(), *strides,
             b, n, heads, d, kv, scale * LOG2E, None)
    assert err == 0
    want = mha_kernel.mha_attention_reference(q, k, v, valid_len=kv)
    return out, want, stats, _row_stats(q, k, kv, scale, True)


def _run_fwd_qkv(fn, b, n, heads, d, kv, poison):
    qkv, q, k, v, _ = _inputs(b, n, heads, d, seed=5 * n + d)
    if poison:
        _poison_pad_keys(k, v, kv)  # views: the k and v column blocks of qkv
    scale = d**-0.5
    out = torch.full((b, n, heads * d), float("nan"), dtype=torch.bfloat16)
    stats = torch.full((b, heads, n, 2), float("nan"))
    err = fn(qkv.data_ptr(), out.data_ptr(), stats.data_ptr(), b, n, heads, d, kv,
             scale * LOG2E, None)
    assert err == 0
    want = mha_kernel.mha_qkv_attention_reference(qkv, heads, valid_len=kv)
    return out, want, stats, _row_stats(q, k, kv, scale, True)


@pytest.mark.parametrize("b,n,heads,d,kv,poison", [
    (1, 150, 2, 64, 140, True),  # ragged q and key tiles, NaN in the pad keys
    (2, 130, 1, 64, 130, False),  # batch 2, no pad keys, a ragged last key tile
    (1, 140, 1, 128, 133, True),
    (1, 100, 1, 256, 90, True),  # head dim 256
])
def test_oneshot_forward_source_matches_plain_version(fwd_libs, b, n, heads, d, kv, poison):
    _assert_fwd_close(*_run_fwd_mha(fwd_libs["mha"], b, n, heads, d, kv, poison))


def _run_fwd_flash(fn, b, n, heads, d, kv, poison, causal=False, layout="fused"):
    """K4 on views of one fused qkv, or on [B, H, N, D] storage (head stride
    above the token stride)."""
    if layout == "fused":
        _, q, k, v, _ = _inputs(b, n, heads, d, seed=7 * n + d + causal)
    else:
        gen = torch.Generator().manual_seed(7 * n + d)
        q, k, v = (torch.randn(b, heads, n, d, generator=gen).to(torch.bfloat16).transpose(1, 2)
                   for _ in range(3))
    if poison:
        _poison_pad_keys(k, v, kv)
    scale = d**-0.5
    out = torch.full((b, n, heads, d), float("nan"), dtype=torch.bfloat16)
    stats = torch.full((b, heads, n, 2), float("nan"))
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), stats.data_ptr(), *strides,
             b, n, heads, d, kv, int(causal), scale, None)
    assert err == 0
    want = attention.flash_attention_reference(q, k, v, causal=causal, valid_len=kv)
    return out, want, stats, _row_stats(q, k, kv, scale, False, causal)


@pytest.mark.parametrize("b,n,heads,d,kv,poison,causal,layout", [
    (1, 150, 2, 64, 140, True, False, "fused"),  # ragged, NaN in the pad keys of K and V
    (1, 300, 1, 64, 300, False, True, "fused"),  # causal, N a multiple of neither 192 nor 128
    (1, 200, 2, 64, 170, True, True, "fused"),  # causal with pad keys past valid_len
    (1, 140, 1, 128, 133, True, True, "fused"),  # head dim 128: 128-row q-tiles
    (1, 100, 1, 256, 90, True, True, "fused"),  # head dim 256: 64-key tiles
    (1, 150, 1, 256, 140, True, False, "fused"),
    (2, 130, 2, 64, 130, False, False, "bhnd"),  # [B, H, N, D] storage, batch 2
])
def test_flash_forward_source_matches_plain_version(fwd_libs, b, n, heads, d, kv, poison, causal,
                                                    layout):
    """K4 (the forward core under the bundled kernel's numerics) against its
    plain version, and its row statistics against the plain row max / sum of
    the unscaled product times scale * log2 e."""
    _assert_fwd_close(*_run_fwd_flash(fwd_libs["flash"], b, n, heads, d, kv, poison, causal,
                                      layout))


def test_flash_forward_feeds_its_backward(fwd_libs, libs):
    """K4's output and row statistics, as written by the forward source, give
    K4b's gradients within the backward limits (the two share the logit bit
    for bit), at head dim 256, causal, with pad rows and keys."""
    b, n, heads, d, kv = 1, 100, 1, 256, 90
    _, q, k, v, dout = _inputs(b, n, heads, d, seed=21)
    scale = d**-0.5
    out = torch.empty(b, n, heads, d, dtype=torch.bfloat16)
    stats = torch.empty(b, heads, n, 2)
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    assert fwd_libs["flash"](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             stats.data_ptr(), *strides, b, n, heads, d, kv, 1, scale, None) == 0
    di = (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = _nan_like(q)
    assert libs["flash"](q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                         stats.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                         dv.data_ptr(), *strides, b, n, heads, d, kv, 1, scale, None) == 0
    want = attention.flash_attention_bwd_reference(q, k, v, out, dout, causal=True, valid_len=kv)
    _assert_grads_close((dq, dk, dv), want, kv, kv)
    assert not dq[:, kv:].any()


@pytest.mark.parametrize("b,n,heads,d,kv,poison", [
    (1, 150, 2, 64, 137, True),  # ragged tiles, NaN in the pad keys of K and V
    (1, 140, 1, 128, 140, False),  # head dim 128: q / k / v column blocks of 3 * 128
    (2, 70, 1, 64, 66, True),  # batch 2, one ragged tile
])
def test_fused_qkv_forward_source_matches_plain_version(fwd_libs, b, n, heads, d, kv, poison):
    _assert_fwd_close(*_run_fwd_qkv(fwd_libs["qkv"], b, n, heads, d, kv, poison))


@pytest.mark.parametrize("kernel,d", [("qkv", 64), ("mha", 128), ("mha", 256), ("flash", 64),
                                      ("flash", 256)])
def test_forward_sources_are_bitwise_deterministic(fwd_libs, kernel, d):
    """A second call on the same inputs gives the same output and statistics
    bit for bit (K4 causal)."""
    run = {"qkv": _run_fwd_qkv, "mha": _run_fwd_mha,
           "flash": lambda *args: _run_fwd_flash(*args, causal=True)}[kernel]
    first, second = (run(fwd_libs[kernel], 1, 140, 1, d, 131, True) for _ in range(2))
    assert torch.equal(first[0], second[0]) and torch.equal(first[2], second[2])
    _assert_fwd_close(*first)


def test_forward_entry_points_refuse_what_the_kernels_do_not_take(fwd_libs):
    """Head dim 256 in K1 (64 / 128 only), head dim 32 in any, and kv_len
    outside [1, N] return cudaErrorInvalidValue (1) before any launch."""
    qkv = lambda d, kv: fwd_libs["qkv"](None, None, None, 1, 64, 1, d, kv, 1.0, None)
    mha = lambda d, kv: fwd_libs["mha"](*([None] * 5 + [0] * 9 + [1, 64, 1, d, kv, 1.0, None]))
    flash = lambda d, kv: fwd_libs["flash"](*([None] * 5 + [0] * 9 + [1, 64, 1, d, kv, 1, 1.0,
                                                                      None]))
    assert qkv(256, 64) == 1 and qkv(32, 64) == 1 and qkv(64, 0) == 1 and qkv(64, 65) == 1
    assert mha(32, 64) == 1 and mha(64, 65) == 1 and mha(512, 64) == 1
    assert flash(32, 64) == 1 and flash(64, 0) == 1 and flash(64, 65) == 1


def test_timing_tool_checks_statistics_the_same_way_and_refuses_the_cpu(monkeypatch):
    """`tools/time_fwd_trees.py` (the design-step timings on the card) holds
    the row statistics to the plain values computed as here, K5 and K7 to
    this file's limits, and exits rather than time anything without a card."""
    _, q, k, _, _ = _inputs(1, 90, 2, 64, seed=11)
    got = time_fwd_trees.plain_stats(q, k, 80, 0.125)
    assert torch.allclose(got, _row_stats(q, k, 80, 0.125, True), rtol=1e-6, atol=1e-6)
    got = time_fwd_trees.plain_stats(q, k, 80, 0.125, prescaled=False, causal=True)  # K4's
    assert torch.allclose(got, _row_stats(q, k, 80, 0.125, False, True), rtol=1e-6, atol=1e-6)
    assert (time_fwd_trees.STATS_M_TOL, time_fwd_trees.STATS_L_TOL) == (STATS_M_TOL, STATS_L_TOL)
    assert (time_fwd_trees.INT8_MAX_TOL, time_fwd_trees.INT8_REL_TOL) == (INT8_MAX_TOL,
                                                                          INT8_REL_TOL)
    assert (time_fwd_trees.OUTPROJ_REL_TOL, time_fwd_trees.OUTPROJ_MAX_TOL) == (OUTPROJ_REL_TOL,
                                                                                OUTPROJ_MAX_TOL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        time_fwd_trees.main([])


# ---- the int8 attention (csrc/qkv_attention_int8.cu, K5) and its prologue
# (csrc/quantize_qkv_int8.cu): 8-bit wgmma, TMA with the 64-byte swizzle ----


@pytest.fixture(scope="module")
def int8_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a C++20 host compiler (g++)")
    out = tmp_path_factory.mktemp("cuda_emu_int8")
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    k5 = _build("qkv_attention_int8", out).qkv_attention_int8
    pro = _build("quantize_qkv_int8", out).quantize_qkv_int8
    k5.argtypes = [ptr] * 4 + [i] * 7 + [f, ptr]
    pro.argtypes = [ptr, i] + [ptr] * 4 + [i] * 6 + [ptr]
    k5.restype = pro.restype = ctypes.c_int
    return {"k5": k5, "prologue": pro}


def _int8_qkv(b, n, heads, d, kv, seed, dtype=torch.bfloat16, adversarial=False):
    """Seeded qkv [B, N, 3HD]; `adversarial`: every real score far below zero
    (negative q against positive k) and zero pad rows past kv, as
    tests/test_int8_attention.py's pad case."""
    hd = heads * d
    x = torch.from_numpy(np.random.RandomState(seed).randn(b, n, 3 * hd).astype(np.float32))
    if adversarial:
        x[..., :hd] = -x[..., :hd].abs() * 20.0
        x[..., hd:2 * hd] = x[..., hd:2 * hd].abs()
        x[:, kv:] = 0.0
    return x.to(dtype)


def _run_prologue(fn, qkv, heads, kv):
    b, n, three_hd = qkv.shape
    d = three_hd // 3 // heads
    ldv = -(-n // 16) * 16
    amax = torch.zeros(b, 3, heads, dtype=torch.int32)
    # every byte of q8's q and k thirds must be written, none of its v third
    q8 = torch.full((b, n, three_hd), 77, dtype=torch.int8)
    vt = torch.full((b, heads, d, ldv), 77, dtype=torch.int8)
    scales = torch.full((b, 3, heads), float("nan"))
    err = fn(qkv.data_ptr(), int(qkv.dtype == torch.bfloat16), amax.data_ptr(), q8.data_ptr(),
             vt.data_ptr(), scales.data_ptr(), b, n, heads, d, kv, ldv, None)
    assert err == 0
    return q8, vt, scales


def _run_k5(fn, q8, vt, scales, heads, kv, out_dtype):
    b, n, three_hd = q8.shape
    d = three_hd // 3 // heads
    out = torch.full((b, n, heads * d), float("nan"), dtype=out_dtype)
    err = fn(q8.data_ptr(), vt.data_ptr(), scales.data_ptr(), out.data_ptr(),
             int(out_dtype == torch.bfloat16), b, n, heads, d, kv, vt.shape[-1], d**-0.5, None)
    assert err == 0
    return out


def _assert_int8_close(out, want, kv):
    assert torch.isfinite(out.float()).all()
    got, ref = out[:, :kv].float(), want[:, :kv].float()
    assert float(ref.abs().max()) > 1e-3  # not silently zeroed
    assert float((got - ref).abs().max()) <= INT8_MAX_TOL
    assert float((got - ref).norm() / ref.norm()) <= INT8_REL_TOL


@pytest.mark.parametrize("b,n,heads,d,kv,out_dtype,poison,adversarial", [
    (1, 150, 2, 64, 140, torch.bfloat16, True, False),  # ragged q / key tiles, poisoned pads
    (1, 140, 1, 128, 133, torch.float32, True, False),  # head dim 128, fp32 out
    (2, 130, 1, 64, 130, torch.float32, False, False),  # batch 2, no pad keys
    (1, 256, 2, 64, 200, torch.bfloat16, False, True),  # all-negative scores, zero pads
])
def test_int8_attention_source_matches_plain_version(int8_libs, b, n, heads, d, kv, out_dtype,
                                                     poison, adversarial):
    """K5 against `int8_attention_plain` on the plain prologue's operands.
    With `poison`, q8's rows past kv and V's key-major copy past kv (within
    its last 16-key group and beyond) hold nonzero bytes: a kernel that
    weighs a key past kv fails."""
    qkv = _int8_qkv(b, n, heads, d, kv, seed=n + d, adversarial=adversarial)
    q8, scales = mha_kernel.quantize_qkv_int8(qkv, heads, kv)
    vt = mha_kernel.value_key_major(q8, heads)
    want = mha_kernel.int8_attention_plain(q8, scales, heads, d**-0.5, kv, out_dtype)
    if poison:
        gen = torch.Generator().manual_seed(kv)
        q8[:, kv:] = torch.randint(-128, 128, q8[:, kv:].shape, generator=gen).to(torch.int8)
        ldv = vt.shape[-1]
        keys = torch.tensor([16 * (p // 16) + mha_kernel._V_KEY_ORDER[p % 16] for p in range(ldv)])
        vt[..., keys >= kv] = 100
    out = _run_k5(int8_libs["k5"], q8, vt, scales, heads, kv, out_dtype)
    _assert_int8_close(out, want, kv)
    again = _run_k5(int8_libs["k5"], q8, vt, scales, heads, kv, out_dtype)
    assert torch.equal(out, again)  # a second call, bit for bit


def _saturating_bf16_amax():
    """A bf16 value a whose bf16 product a * bf16(127 / a) rounds to 128
    (tests/test_torch_int8_attention.py finds it the same way)."""
    a = torch.arange(1.0, 2.0, 2.0**-7).to(torch.bfloat16)
    inv = (torch.full_like(a, 127.0, dtype=torch.float32) / a.float()).to(torch.bfloat16)
    return float(a[torch.round(a * inv) >= 128][0])


@pytest.mark.parametrize("b,n,heads,d,kv,dtype,pads", [
    (1, 150, 2, 64, 140, torch.bfloat16, "inf"),  # inf and -inf in the pad rows
    (2, 100, 1, 128, 100, torch.bfloat16, None),  # valid_len = N, head dim 128
    (1, 150, 2, 64, 131, torch.float32, "nan"),  # fp32, NaN in the pad rows
    (1, 70, 1, 128, 70, torch.float32, None),
])
def test_int8_prologue_source_is_bitwise_the_plain_prologue(int8_libs, b, n, heads, d, kv, dtype,
                                                            pads):
    """q8's q and k thirds, V's key-major copy and the scales equal
    `quantize_qkv_int8` + `value_key_major` bit for bit, with the saturating
    element (rounds to 128, stored 127) at the abs max of q's and of k's
    first head; q8's v third (K5 reads V from its copy) is not written."""
    x = _int8_qkv(b, n, heads, d, kv, seed=3 * n + d, dtype=torch.float32) * 0.1
    a = _saturating_bf16_amax()
    x[0, 3, 5] = a
    x[0, 4, heads * d + 7] = -a
    if pads:
        x[:, kv:, ::2] = float(pads)
        x[:, kv:, 1::2] = -float("inf") if pads == "inf" else float("nan")
    qkv = x.to(dtype)
    q8, vt, scales = _run_prologue(int8_libs["prologue"], qkv, heads, kv)
    want_q8, want_scales = mha_kernel.quantize_qkv_int8(qkv, heads, kv)
    assert torch.equal(q8[..., :2 * heads * d], want_q8[..., :2 * heads * d])
    assert bool((q8[..., 2 * heads * d:] == 77).all())
    assert torch.equal(vt, mha_kernel.value_key_major(want_q8, heads))
    assert torch.equal(scales, want_scales)
    if dtype == torch.bfloat16:
        assert int(q8[0, 3, 5]) == 127 and int(q8[0, 4, heads * d + 7]) == -128


def test_int8_prologue_feeds_the_attention_source(int8_libs):
    """The slice as the CUDA path runs it: the prologue kernel, then K5 on
    its operands (q8's v third left as `_run_prologue` filled it), against
    the plain int8 path on the unquantized qkv."""
    b, n, heads, d, kv = 1, 200, 2, 64, 190
    qkv = _int8_qkv(b, n, heads, d, kv, seed=29)
    qkv[:, kv:] = float("nan")  # pad rows: never read
    q8, vt, scales = _run_prologue(int8_libs["prologue"], qkv, heads, kv)
    out = _run_k5(int8_libs["k5"], q8, vt, scales, heads, kv, torch.bfloat16)
    want = mha_kernel.mha_qkv_attention_int8_reference(qkv, heads, valid_len=kv)
    _assert_int8_close(out, want, kv)


def test_int8_entry_points_refuse_what_the_kernels_do_not_take(int8_libs):
    """Head dim 32, kv_len outside [1, N] or past the int32 limit, and a V
    row length below N or not a multiple of 16 return cudaErrorInvalidValue
    (1) before any launch, in K5 and in the prologue."""
    k5 = lambda d, n, kv, ldv: int8_libs["k5"](None, None, None, None, 1, 1, n, 1, d, kv, ldv,
                                               1.0, None)
    pro = lambda d, n, kv, ldv: int8_libs["prologue"](None, 1, None, None, None, None, 1, n, 1, d,
                                                      kv, ldv, None)
    for fn in (k5, pro):
        assert fn(32, 64, 64, 64) == 1 and fn(256, 64, 64, 64) == 1
        assert fn(64, 64, 0, 64) == 1 and fn(64, 64, 65, 64) == 1
        assert fn(64, 64, 64, 48) == 1 and fn(64, 64, 64, 72) == 1
    big = mha_kernel.INT8_MAX_KEYS + 1
    assert k5(64, big, big, -(-big // 16) * 16) == 1


# ---- K6 (csrc/ln_qkv_attention.cu): the statistics pass, the LayerNorm +
# qkv projection on TMA + wgmma m64n256k16 (A normalised in shared memory or
# in registers), then K1's body on the q/k/v workspace ----

@pytest.fixture(scope="module")
def lnqkv_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a C++20 host compiler (g++)")
    return lnqkv_kernel.bind_entry_points(
        _build("ln_qkv_attention", tmp_path_factory.mktemp("cuda_emu_lnqkv")))


def _lnqkv_inputs(b, n, dim, hd, seed, poison_from=None):
    """x [B, N, D] bf16 and ln_1 / qkv parameters at the scale of the model's
    init (chip_smoke.py's), W^T [3*hd, D] bf16; NaN in the rows of x from
    `poison_from` on."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, n, dim).astype(np.float32)).to(torch.bfloat16)
    if poison_from is not None:
        x[:, poison_from:] = float("nan")
    gamma = torch.from_numpy(1.0 + 0.1 * rng.randn(dim).astype(np.float32))
    beta = torch.from_numpy(0.1 * rng.randn(dim).astype(np.float32))
    limit = (6.0 / (4 * dim)) ** 0.5
    wt = torch.from_numpy(((rng.rand(3 * hd, dim) * 2 - 1) * limit).astype(np.float32))
    bias = torch.from_numpy(0.02 * rng.randn(3 * hd).astype(np.float32))
    return x, gamma, beta, wt.to(torch.bfloat16), bias


def _run_lnqkv(fns, x, gamma, beta, wt, bias, heads, kv):
    """The whole of K6: (its q/k/v workspace, its output), both NaN-filled
    before the call."""
    b, n, dim = x.shape
    hd = wt.shape[0] // 3
    d = hd // heads
    qkv = torch.full((b, n, 3 * hd), float("nan"), dtype=torch.bfloat16)
    out = torch.full((b, n, hd), float("nan"), dtype=torch.bfloat16)
    err = fns["attention"](x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wt.data_ptr(),
                           bias.data_ptr(), qkv.data_ptr(), out.data_ptr(), b, n, dim, heads, d,
                           kv, d**-0.5 * LOG2E, 1e-5, None)
    assert err == 0
    return qkv, out


def _run_projection(fns, x, gamma, beta, wt, bias, heads):
    """K6's first stage alone (the statistics, then the projection): the
    workspace and the statistics [B*N, 2]."""
    b, n, dim = x.shape
    hd = wt.shape[0] // 3
    stats = torch.full((b * n, 2), float("nan"))
    qkv = torch.full((b, n, 3 * hd), float("nan"), dtype=torch.bfloat16)
    assert fns["stats"](x.data_ptr(), stats.data_ptr(), b * n, dim, 1e-5, None) == 0
    assert fns["projection"](x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wt.data_ptr(),
                             bias.data_ptr(), stats.data_ptr(), qkv.data_ptr(), b * n, dim, hd,
                             (hd // heads) ** -0.5 * LOG2E, None) == 0
    return qkv, stats


def _assert_workspace_close(got, x, gamma, beta, wt, bias, heads, rows):
    """The workspace within `lnqkv_kernel.workspace_errors`' limits (one
    bf16 step, plus the fp32 sums' error bound where they cancel; measured
    here: at most one step, in 3-5 of 54-108 K elements)."""
    errs = lnqkv_kernel.workspace_errors(got, x, gamma, beta, wt.t(), bias, heads, rows=rows)
    assert errs["max_share_of_limit"] <= 1.0, errs


@pytest.mark.parametrize("b,n,dim,heads,d,kv,poison", [
    (1, 150, 256, 4, 64, 140, True),  # ragged row tile, NaN in the rows of x past kv
    (1, 140, 256, 1, 128, 133, False),  # head dim 128: 3*hd = 384, a ragged column tile
    (2, 70, 128, 2, 64, 66, False),  # batch 2: rows of both in one tile; q and k in one tile
])
def test_lnqkv_source_matches_plain_version(lnqkv_lib, b, n, dim, heads, d, kv, poison):
    """The whole of K6 against `ln_qkv_attention_reference` within
    chip_smoke.py's kernel limits on the valid rows (finite even with NaN in
    the pad rows of x), and the q/k/v workspace its first stage writes
    against `ln_qkv_projection_reference` within the last bf16 rounding
    (`lnqkv_kernel.workspace_errors`)."""
    hd = heads * d
    x, gamma, beta, wt, bias = _lnqkv_inputs(b, n, dim, hd, seed=n + dim,
                                             poison_from=kv if poison else None)
    qkv, out = _run_lnqkv(lnqkv_lib, x, gamma, beta, wt, bias, heads, kv)
    want = lnqkv_kernel.ln_qkv_attention_reference(x, gamma, beta, wt.t(), bias, heads,
                                                   valid_len=kv)
    got, ref = out[:, :kv].float(), want[:, :kv].float()
    assert torch.isfinite(got).all()
    err = (got - ref).abs()
    assert float(err.max()) <= FWD_MAX_TOL
    assert float(err.mean()) <= FWD_MEAN_TOL
    assert float((got - ref).norm() / ref.norm()) <= FWD_REL_TOL
    _assert_workspace_close(qkv, x, gamma, beta, wt, bias, heads, kv if poison else n)


@pytest.mark.parametrize("b,n,dim,heads,d", [
    (1, 150, 256, 4, 64),
    (2, 70, 128, 1, 128),
])
def test_lnqkv_first_stage_source_matches_plain_version(lnqkv_lib, b, n, dim, heads, d):
    """K6's stages alone: the statistics pass equals `ln_qkv_stats_reference`
    bit for bit, the projection on them writes the workspace of the plain
    projection within the last bf16 rounding, and the whole of K6 writes
    that workspace too, bit for bit."""
    x, gamma, beta, wt, bias = _lnqkv_inputs(b, n, dim, heads * d, seed=7 * n + dim)
    qkv, stats = _run_projection(lnqkv_lib, x, gamma, beta, wt, bias, heads)
    assert torch.equal(stats, lnqkv_kernel.ln_qkv_stats_reference(x).reshape(-1, 2))
    _assert_workspace_close(qkv, x, gamma, beta, wt, bias, heads, n)
    assert torch.equal(_run_lnqkv(lnqkv_lib, x, gamma, beta, wt, bias, heads, n)[0], qkv)


def test_lnqkv_source_is_bitwise_deterministic(lnqkv_lib):
    """A second call on the same inputs writes the same workspace and output
    bit for bit: no atomics, every sum in one order."""
    x, gamma, beta, wt, bias = _lnqkv_inputs(1, 130, 128, 128, seed=3)
    first, second = (_run_lnqkv(lnqkv_lib, x, gamma, beta, wt, bias, 2, 120) for _ in range(2))
    assert torch.equal(first[0], second[0]) and torch.equal(first[1][:, :120], second[1][:, :120])


def test_lnqkv_entry_points_refuse_what_the_kernel_does_not_take(lnqkv_lib):
    """A model width or H*d that is not a multiple of 128, head dim 32 or
    256, and kv_len outside [1, N] return cudaErrorInvalidValue (1) before
    any launch, in the whole of K6 and in its stages."""
    k6 = lambda dim, heads, d, kv: lnqkv_lib["attention"](*([None] * 7), 1, 64, dim, heads, d, kv,
                                                          1.0, 1e-5, None)
    assert k6(192, 2, 64, 64) == 1 and k6(256, 1, 64, 64) == 1  # D; H*d = 64
    assert k6(256, 4, 32, 64) == 1 and k6(256, 1, 256, 64) == 1  # head dim
    assert k6(256, 2, 64, 0) == 1 and k6(256, 2, 64, 65) == 1  # kv_len
    proj = lambda rows, dim, hd: lnqkv_lib["projection"](*([None] * 7), rows, dim, hd, 1.0, None)
    assert proj(0, 128, 128) == 1 and proj(64, 64, 128) == 1 and proj(64, 128, 192) == 1
    assert lnqkv_lib["stats"](None, None, 64, 200, 1e-5, None) == 1
    stage2 = lambda d, kv: lnqkv_lib["stage2"](None, None, 1, 64, 2, d, kv, None)
    assert stage2(32, 64) == 1 and stage2(64, 65) == 1


# ---- K7 (csrc/qkv_out_attention.cu): the attention on TMA + wgmma with
# every head's output in shared memory, then out = O W_out by wgmma ----

# chip_smoke.py's limits for K7 against its plain version (fp32 out): relative
# L2, and max abs error as a share of the largest reference magnitude
OUTPROJ_REL_TOL, OUTPROJ_MAX_TOL = 5e-3, 2e-2


@pytest.fixture(scope="module")
def outproj_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a C++20 host compiler (g++)")
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build("qkv_out_attention",
                tmp_path_factory.mktemp("cuda_emu_outproj")).qkv_out_attention_bf16
    fn.argtypes = [ptr] * 3 + [i] * 5 + [f, ptr]
    fn.restype = ctypes.c_int
    return fn


def _run_outproj(fn, b, n, heads, d, kv, seed, poison=False):
    """K7 on seeded qkv and W_out (NaN in the K / V rows past kv with
    `poison`): (its output, the plain version's).  The output buffer runs 64
    NaN rows past [B, N, H*D], which must stay NaN."""
    hd = heads * d
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(b, n, 3 * hd).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.randn(hd, hd) * 0.05).astype(np.float32)).to(torch.bfloat16)
    if poison:
        qkv[:, kv:, hd:] = float("nan")
    want = exp_outproj_epilogue.qkv_out_attention_reference(qkv, w, heads, valid_len=kv)
    buf = torch.full((b * n + 64, hd), float("nan"))
    err = fn(qkv.data_ptr(), w.data_ptr(), buf.data_ptr(), b, n, heads, d, kv, d**-0.5 * LOG2E,
             None)
    assert err == 0
    assert torch.isnan(buf[b * n:]).all()  # nothing written past the last row
    return buf[:b * n].view(b, n, hd), want


def _assert_outproj_close(out, want):
    assert torch.isfinite(out).all()
    err = out - want
    assert float(err.norm() / want.norm()) <= OUTPROJ_REL_TOL
    assert float(err.abs().max()) <= OUTPROJ_MAX_TOL * float(want.abs().max())


@pytest.mark.parametrize("b,n,heads,d,kv,poison", [
    (1, 150, 2, 64, 140, True),  # a ragged last q-tile, NaN in the K / V rows past valid_len
    (2, 100, 2, 64, 100, False),  # batch 2, N not a multiple of the 64-row q-tile
    (1, 140, 2, 128, 133, True),  # head dim 128: one-stage K / V rings, two 128-column chunks
    (1, 90, 3, 64, 85, False),  # H*D = 192: three column boxes, chunks of 128 and 64
    (1, 70, 16, 64, 70, False),  # H*D = 1024, the widest: O is 128 KB
])
def test_outproj_source_matches_plain_version(outproj_lib, b, n, heads, d, kv, poison):
    """K7 against `qkv_out_attention_reference` on every row, within
    chip_smoke.py's limits.  The emulation runs the last block first, so a
    block that wrote past its batch element's last row would leave the next
    element's first rows (or the buffer's tail) wrong."""
    _assert_outproj_close(*_run_outproj(outproj_lib, b, n, heads, d, kv, seed=n + heads + d,
                                        poison=poison))


def test_outproj_source_is_bitwise_deterministic(outproj_lib):
    """A second call on the same inputs gives the same output bit for bit:
    no atomics, every sum in one order."""
    first, second = (_run_outproj(outproj_lib, 1, 130, 3, 64, 120, seed=3, poison=True)
                     for _ in range(2))
    assert torch.equal(first[0], second[0])
    _assert_outproj_close(*first)


def test_outproj_entry_point_refuses_what_the_kernel_does_not_take(outproj_lib):
    """Head dim 32 or 256, H*D past 1024 and kv_len outside [1, N] return
    cudaErrorInvalidValue (1) before any launch."""
    k7 = lambda heads, d, kv: outproj_lib(None, None, None, 1, 64, heads, d, kv, 1.0, None)
    assert k7(2, 32, 64) == 1 and k7(1, 256, 64) == 1
    assert k7(17, 64, 64) == 1 and k7(9, 128, 64) == 1
    assert k7(2, 64, 0) == 1 and k7(2, 64, 65) == 1
