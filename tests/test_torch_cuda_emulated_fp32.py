"""The fp32 attention kernels' CUDA sources on the CPU emulation.

`csrc/attention_fp32.cu` (K1, K3 and K4 in fp32 on the 3xTF32 forward core
`csrc/attention_fp32.cuh`) and `csrc/attention_bwd_fp32.cu` (K2, K3's
backward and K4b on the 3xTF32 core `csrc/attention_bwd_fp32.cuh`),
compiled by the host compiler against `tests/cuda_emu/`
(`tests/torch_cuda_emu.py::_build`: a std::thread per CUDA thread,
shuffles, `__syncwarp` and TF32 mma.sync (`tests/cuda_emu/mma_tf32.cuh`) as
warp exchanges, cp.async deferred to its wait, shared memory filled with
NaN bytes before each block), each entry against its plain version: head
dims 64 / 128 / 256, causal, `valid_len` with NaN in the K / V rows past
it, the row statistics, and a rerun held bitwise equal.  The cases reach
the backward core's paths: both stages of its ring, tiles no mask reaches
and n-tiles a mask empties, D = 256's single stage and two passes; and the
forward core's: its ring wrapped at each head dim's tiling, tiles a mask
empties for a warp, its masked and unmasked softmax steps.  The plain versions are held
against the JAX package's kernels in `tests/test_torch_fp32_kernels.py`.
"""

import ctypes
import re

import pytest
import torch

from denseclip_vit_multimodal_tpu_torch.ops import attention, mha_kernel
from torch_cuda_emu import CSRC, LOG2E, _build_all, _row_stats

# Outputs against the plain versions: max abs and relative L2 (ROADMAP's
# fp32 limits); gradients: relative L2 and max abs as a share of the
# largest reference magnitude, per gradient (the card's limits).
OUT_MAX, OUT_REL = 1e-4, 1e-5
GRAD_REL, GRAD_MAX = 1e-4, 1e-4
STATS_M, STATS_L = 5e-5, 3e-5


@pytest.fixture(scope="module")
def fns(tmp_path_factory):
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("needs a C++20 host compiler (g++)")
    out = tmp_path_factory.mktemp("cuda_emu_fp32")
    fwd, bwd = _build_all(("attention_fp32", "attention_bwd_fp32"), out)
    ptr, i64, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    table = {
        "qkv": (fwd.qkv_attention_fp32, [ptr] * 3 + [i] * 5 + [f, ptr]),
        "mha": (fwd.mha_attention_fp32, [ptr] * 5 + [i64] * 9 + [i] * 5 + [f, ptr]),
        "flash": (fwd.flash_attention_fp32, [ptr] * 5 + [i64] * 9 + [i] * 6 + [f, ptr]),
        "qkv_bwd": (bwd.qkv_attention_bwd_fp32, [ptr] * 6 + [i] * 5 + [f, f, ptr]),
        "mha_bwd": (bwd.mha_attention_bwd_fp32, [ptr] * 10 + [i64] * 9 + [i] * 5 + [f, f, ptr]),
        "flash_bwd": (bwd.flash_attention_bwd_fp32, [ptr] * 9 + [i64] * 9 + [i] * 6 + [f, ptr]),
    }
    for fn, argtypes in table.values():
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return {name: fn for name, (fn, _) in table.items()}


def _inputs(b, n, heads, d, kv, seed):
    """q / k / v as views of one fused fp32 qkv (row stride 3*H*D), with NaN
    in the K / V rows at or past kv, and dO."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen)
    q, k, v = (t.view(b, n, heads, d) for t in qkv.split(heads * d, dim=-1))
    k[:, kv:] = float("nan")
    v[:, kv:] = float("nan")
    return qkv, q, k, v, torch.randn(b, n, heads, d, generator=gen)


def _strides(*xs):
    return [s for x in xs for s in x.stride()[:3]]


def _nans(shape, count=1):
    return [torch.full(shape, float("nan")) for _ in range(count)]


def _assert_out(got, want, rows):
    got, want = got[:, :rows].double(), want[:, :rows].double()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= OUT_MAX
    assert float((got - want).norm() / want.norm()) <= OUT_REL


def _assert_stats(stats, q, k, kv, scale, prescaled, causal=False):
    want = _row_stats(q, k, kv, scale, prescaled, causal)
    assert float((stats[..., 0] - want[..., 0]).abs().max()) <= STATS_M
    assert float(((stats[..., 1] - want[..., 1]) / want[..., 1]).abs().max()) <= STATS_L


def _assert_grads(got, want, rows, kv):
    for name, g, w, lim in zip(("dq", "dk", "dv"), got, want, (rows, kv, kv)):
        g, w = g[:, :lim].double(), w[:, :lim].double()
        assert torch.isfinite(g).all(), name
        assert float((g - w).norm() / w.norm()) <= GRAD_REL, name
        assert float((g - w).abs().max()) <= GRAD_MAX * float(w.abs().max()), name
    assert not got[1][:, kv:].any() and not got[2][:, kv:].any()  # masked keys: exactly 0


def _run_twice(call, outs):
    """Launch twice; the second run must equal the first bit for bit."""
    assert call() == 0
    first = [o.clone() for o in outs]
    for o in outs:
        o.fill_(float("nan"))
    assert call() == 0
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(first, outs))


@pytest.mark.parametrize("b,n,heads,d,kv", [(2, 90, 2, 64, 70), (1, 33, 1, 128, 33)])
def test_k1_and_k2_fp32(fns, b, n, heads, d, kv):
    qkv, q, k, v, dout = _inputs(b, n, heads, d, kv, seed=n + d)
    hd, scale = heads * d, d**-0.5
    out, stats = torch.full((b, n, hd), float("nan")), torch.empty(b, heads, n, 2)
    _run_twice(lambda: fns["qkv"](qkv.data_ptr(), out.data_ptr(), stats.data_ptr(), b, n, heads,
                                  d, kv, scale * LOG2E, None), [out, stats])
    _assert_out(out, mha_kernel.mha_qkv_attention_reference(qkv, heads, valid_len=kv), kv)
    _assert_stats(stats, q, k, kv, scale, True)
    # K2 on K1's output; q rows past kv (the pad rows) contribute their dO
    do2 = dout.reshape(b, n, hd).contiguous()
    (dqkv,) = _nans(qkv.shape)
    dcoef = torch.empty(b, heads, n)
    _run_twice(lambda: fns["qkv_bwd"](qkv.data_ptr(), out.data_ptr(), do2.data_ptr(),
                                      stats.data_ptr(), dcoef.data_ptr(), dqkv.data_ptr(), b, n,
                                      heads, d, kv, scale * LOG2E, scale, None), [dqkv])
    clean = qkv.clone()
    clean[:, kv:, hd:] = 0.0  # the plain version reads no pad key either
    want = mha_kernel.mha_qkv_attention_bwd_reference(clean, out, do2, heads, valid_len=kv)
    _assert_grads(dqkv.split(hd, dim=-1), want.split(hd, dim=-1), n, kv)


@pytest.mark.parametrize("b,n,heads,d,kv", [(1, 80, 2, 64, 75), (1, 70, 2, 128, 64),
                                            (1, 40, 2, 256, 35)])
def test_k3_and_its_backward_fp32(fns, b, n, heads, d, kv):
    _, q, k, v, dout = _inputs(b, n, heads, d, kv, seed=n * d)
    scale = d**-0.5
    out, stats = torch.empty(b, n, heads, d), torch.empty(b, heads, n, 2)
    _run_twice(lambda: fns["mha"](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  stats.data_ptr(), *_strides(q, k, v), b, n, heads, d, kv,
                                  scale * LOG2E, None), [out, stats])
    kc, vc = k.clone(), v.clone()
    kc[:, kv:] = vc[:, kv:] = 0.0
    _assert_out(out, mha_kernel.mha_attention_reference(q, kc, vc, valid_len=kv), n)
    _assert_stats(stats, q, kc, kv, scale, True)
    dq, dk, dv = _nans((b, n, heads, d), 3)
    dcoef = torch.empty(b, heads, n)
    _run_twice(lambda: fns["mha_bwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      dout.data_ptr(), stats.data_ptr(), dcoef.data_ptr(),
                                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                      *_strides(q, k, v), b, n, heads, d, kv, scale * LOG2E,
                                      scale, None), [dq, dk, dv])
    want = mha_kernel.mha_attention_bwd_reference(q, kc, vc, out, dout, valid_len=kv)
    _assert_grads((dq, dk, dv), want, n, kv)


@pytest.mark.parametrize("b,n,heads,d,kv,causal", [(1, 100, 2, 64, 90, True),
                                                   (2, 70, 1, 128, 70, False),
                                                   (1, 75, 1, 256, 68, True)])
def test_k4_and_k4b_fp32(fns, b, n, heads, d, kv, causal):
    _, q, k, v, dout = _inputs(b, n, heads, d, kv, seed=n + d + causal)
    scale = d**-0.5
    out, stats = torch.empty(b, n, heads, d), torch.empty(b, heads, n, 2)
    _run_twice(lambda: fns["flash"](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    stats.data_ptr(), *_strides(q, k, v), b, n, heads, d, kv,
                                    int(causal), scale, None), [out, stats])
    kc, vc = k.clone(), v.clone()
    kc[:, kv:] = vc[:, kv:] = 0.0
    want = attention.flash_attention_reference(q, kc, vc, causal=causal, valid_len=kv)
    _assert_out(out, want, kv)
    _assert_stats(stats[:, :, :kv], q[:, :kv], kc, kv, scale, False, causal)
    di = (out * dout).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = _nans((b, n, heads, d), 3)
    _run_twice(lambda: fns["flash_bwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        dout.data_ptr(), stats.data_ptr(), di.data_ptr(),
                                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                        *_strides(q, k, v), b, n, heads, d, kv, int(causal),
                                        scale, None), [dq, dk, dv])
    want = attention.flash_attention_bwd_reference(q, kc, vc, out, dout, causal=causal,
                                                   valid_len=kv)
    _assert_grads((dq, dk, dv), want, kv, kv)
    assert not dq[:, kv:].any()  # pad rows contribute nothing under the bundled numerics


def _fwd_tiling(d):
    """(16-row groups, key tile, stages) of the forward core's `Cfg<d>`: a
    tensor-core tiling's warps, or the SIMT core's 64 rows, 32-key tiles
    and two stages (`csrc/attention_fp32_simt.cuh`, which takes D = 256)."""
    text = (CSRC / "attention_fp32.cuh").read_text()
    m = re.search(rf"struct Cfg<{d}> : Tiles<{d}, (\d+), (\d+), (\d+)>", text)
    return tuple(int(x) for x in m.groups()) if m else (4, 32, 2)


def _causal_coverage(n, d, kv):
    """The most tiles a block of the causal forward streams, and whether some
    warp meets a tile that the mask empties for all its rows."""
    warps, step, _ = _fwd_tiling(d)
    rows = 16 * warps
    most, emptied = 0, False
    for q0 in range(0, n, rows):
        tiles = -(-min(kv, q0 + rows) // step)
        most = max(most, tiles)
        emptied |= any(min(kv, q0 + 16 * w + 16) <= step * t
                       for w in range(warps) for t in range(tiles))
    return most, emptied


@pytest.mark.parametrize("b,n,heads,d,kv", [(1, 260, 1, 64, 250), (1, 100, 2, 128, 96),
                                            (1, 90, 2, 256, 80)])
def test_k4_fp32_wraps_its_ring_and_skips_emptied_tiles(fns, b, n, heads, d, kv):
    """K4 causal at each head dim's tiling: some block streams more tiles
    than its ring has stages, and some warp meets a tile that the mask
    empties for all its rows; NaN in the K / V rows past valid_len; the
    output, the row statistics and a rerun."""
    most, emptied = _causal_coverage(n, d, kv)
    assert most > _fwd_tiling(d)[2] and emptied
    _, q, k, v, _ = _inputs(b, n, heads, d, kv, seed=3 * n + d)
    scale = d**-0.5
    out, stats = torch.empty(b, n, heads, d), torch.empty(b, heads, n, 2)
    _run_twice(lambda: fns["flash"](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    stats.data_ptr(), *_strides(q, k, v), b, n, heads, d, kv, 1,
                                    scale, None), [out, stats])
    kc, vc = k.clone(), v.clone()
    kc[:, kv:] = vc[:, kv:] = 0.0
    _assert_out(out, attention.flash_attention_reference(q, kc, vc, causal=True, valid_len=kv),
                n)
    _assert_stats(stats, q, kc, kv, scale, False, causal=True)


def test_masked_keys_get_exact_zeros_whatever_the_query_side_holds(fns):
    """Under the TPU numerics pad query rows contribute (as in JAX), so NaN
    in a pad row of q reaches the valid keys' dk; the masked keys' dk / dv
    are still written 0 exactly."""
    b, n, heads, d, kv = 1, 80, 2, 64, 70
    _, q, k, v, dout = _inputs(b, n, heads, d, kv, seed=5)
    q[:, kv + 3] = float("nan")
    scale = d**-0.5
    out, stats = torch.empty(b, n, heads, d), torch.empty(b, heads, n, 2)
    assert fns["mha"](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), stats.data_ptr(),
                      *_strides(q, k, v), b, n, heads, d, kv, scale * LOG2E, None) == 0
    dq, dk, dv = _nans((b, n, heads, d), 3)
    assert fns["mha_bwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          dout.data_ptr(), stats.data_ptr(), torch.empty(b, heads, n).data_ptr(),
                          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_strides(q, k, v), b, n,
                          heads, d, kv, scale * LOG2E, scale, None) == 0
    assert torch.isnan(dk[:, :kv]).any()  # the pad row's NaN reached the valid keys
    assert torch.equal(dk[:, kv:], torch.zeros_like(dk[:, kv:]))
    assert torch.equal(dv[:, kv:], torch.zeros_like(dv[:, kv:]))


def test_entries_refuse_what_they_do_not_take(fns):
    """Head dim 32 (and 256 for the fused-qkv entries), kv_len outside
    [1, N]: cudaErrorInvalidValue (1), nothing launched."""
    x = torch.zeros(1, 8, 3 * 64)
    out, q = torch.zeros(1, 8, 64), torch.zeros(1, 8, 2, 32)
    assert fns["qkv"](x.data_ptr(), out.data_ptr(), None, 1, 8, 2, 32, 8, 1.0, None) == 1
    assert fns["qkv"](x.data_ptr(), out.data_ptr(), None, 1, 8, 1, 64, 9, 1.0, None) == 1
    st = _strides(q, q, q)
    assert fns["mha"](*[q.data_ptr()] * 4, None, *st, 1, 8, 2, 32, 8, 1.0, None) == 1
    assert fns["flash"](*[q.data_ptr()] * 4, None, *st, 1, 8, 2, 32, 8, 0, 1.0, None) == 1
    big = torch.zeros(1, 8, 3 * 256)
    assert fns["qkv_bwd"](*[big.data_ptr()] * 6, 1, 8, 1, 256, 8, 1.0, 1.0, None) == 1
