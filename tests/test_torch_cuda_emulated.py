"""The attention-backward kernels' CUDA sources, run on the CPU.

`csrc/qkv_attention_bwd.cu` (K2, K3's backward) and `csrc/flash_attention_bwd.cu`
(K4b) with their core `csrc/attention_bwd.cuh` are compiled by the host
compiler against the CPU emulation in `tests/cuda_emu/` (one std::thread per
CUDA thread; ldmatrix, mma.sync and shuffles emulated per warp; cp.async
deferred to its wait) and called through their plain C entry points on CPU
tensors, at small shapes that reach every branch: ragged tiles, pad keys and
pad rows, causal masks, head dims 64 / 128 / 256 (the dk/dv kernel's two
passes).  Each gradient is held to the chip's limits against the port's
plain versions, masked keys (and K4b's pad rows) to exactly 0, and a second
call bitwise to the first.  What
only the card shows (timing, the compiler's registers, a real race) stays
with `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from denseclip_vit_multimodal_tpu_torch.ops import attention
from denseclip_vit_multimodal_tpu_torch.ops import mha_kernel

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "denseclip_vit_multimodal_tpu_torch" / "csrc"
EMU = Path(__file__).resolve().parent / "cuda_emu"
LOG2E = 1.4426950408889634
# chip_smoke.py's limits for the backward kernels, per gradient
BWD_REL_TOL, BWD_MAX_TOL = 2e-3, 1e-2
_LAUNCH = re.compile(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), [^>]*>>>\((\w+)\)")


def _build(src: str, out: Path) -> ctypes.CDLL:
    work = out / src
    work.mkdir()
    shutil.copy(EMU / "mma_bf16.cuh", work)  # found before csrc's by `#include "..."`
    core = (CSRC / "attention_bwd.cuh").read_text()
    (work / "attention_bwd.cuh").write_text(_LAUNCH.sub(r"emu_launch(\1, \2, \3, \4, \5)", core))
    (work / f"{src}.cpp").write_text(
        '#include "cuda_runtime.h"\n'
        "namespace dclip { namespace bwd { alignas(16) unsigned char smem_raw[emu::kSmemBytes]; } }\n"
        "namespace { struct Init { Init() { emu::smem_base = dclip::bwd::smem_raw; } } init_; }\n"
        + (CSRC / f"{src}.cu").read_text())
    lib = out / f"lib{src}.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
         f"-I{EMU}", f"-I{work}", "-o", str(lib), str(work / f"{src}.cpp"), str(EMU / "emu_main.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a C++20 host compiler (g++)")
    out = tmp_path_factory.mktemp("cuda_emu")
    ptr, i64, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    qlib, flib = _build("qkv_attention_bwd", out), _build("flash_attention_bwd", out)
    fns = {"mha": qlib.mha_attention_bwd_bf16, "qkv": qlib.qkv_attention_bwd_bf16,
           "flash": flib.flash_attention_bwd_bf16}
    fns["mha"].argtypes = [ptr] * 11 + [i64] * 9 + [i] * 5 + [f, f, ptr]
    fns["qkv"].argtypes = [ptr] * 7 + [i] * 5 + [f, f, ptr]
    fns["flash"].argtypes = [ptr] * 9 + [i64] * 9 + [i] * 6 + [f, ptr]
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


def _inputs(b, n, heads, d, seed):
    """q / k / v as views of one fused qkv (row stride 3*H*D) and dO, bf16."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen).to(torch.bfloat16)
    q, k, v = (t.view(b, n, heads, d) for t in qkv.split(heads * d, dim=-1))
    return qkv, q, k, v, torch.randn(b, n, heads, d, generator=gen).to(torch.bfloat16)


def _row_stats(q, k, kv, scale, prescaled, causal=False):
    """The forward kernels' residuals [B, H, N, 2]: each row's max of the
    logits in log2 units and its sum of exp2(s - max), over the valid keys."""
    if prescaled:  # K1 / K3: q * scale * log2 e rounded to bf16, then the product
        s = torch.einsum("bnhd,bmhd->bhnm", (q.float() * (scale * LOG2E)).to(q.dtype).float(),
                         k[:, :kv].float())
    else:  # K4: the product, then * scale * log2 e in fp32
        s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k[:, :kv].float()) * scale * LOG2E
    if causal:
        s = s.masked_fill(torch.arange(kv)[None, :] > torch.arange(q.shape[1])[:, None],
                          float("-inf"))
    m = s.amax(-1)
    return torch.stack([m, torch.exp2(s - m[..., None]).sum(-1)], -1).contiguous()


def _assert_grads_close(got, want, rows, keys):
    for name, g, w, lim in zip(("dq", "dk", "dv"), got, want, (rows, keys, keys)):
        g, w = g[:, :lim].float(), w[:, :lim].float()
        assert float((g - w).norm() / w.norm()) <= BWD_REL_TOL, name
        assert float((g - w).abs().max()) <= BWD_MAX_TOL * float(w.abs().max()), name
    assert not got[1][:, keys:].any() and not got[2][:, keys:].any()  # masked keys


def _nan_like(x, count=3):
    return [torch.full(x.shape, float("nan"), dtype=x.dtype) for _ in range(count)]


def _run_mha(fn, b, n, heads, d, kv):
    _, q, k, v, dout = _inputs(b, n, heads, d, seed=n + d)
    scale = d**-0.5
    out = mha_kernel.mha_attention_reference(q, k, v, valid_len=kv)
    stats = _row_stats(q, k, kv, scale, True)
    dq, dk, dv = _nan_like(q)
    dcoef, scratch = torch.empty(b, heads, n), torch.empty(2, b, heads, n, d, dtype=torch.bfloat16)
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
             stats.data_ptr(), dcoef.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), *strides, b, n, heads, d, kv, scale * LOG2E, scale, None)
    assert err == 0
    return (dq, dk, dv), mha_kernel.mha_attention_bwd_reference(q, k, v, out, dout, valid_len=kv)


def _run_flash(fn, b, n, heads, d, kv, causal):
    _, q, k, v, dout = _inputs(b, n, heads, d, seed=n + d + causal)
    scale = d**-0.5
    out = attention.flash_attention_reference(q, k, v, causal=causal, valid_len=kv)
    stats = _row_stats(q, k, kv, scale, False, causal)
    di = (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = _nan_like(q)
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), stats.data_ptr(),
             di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *strides, b, n, heads, d,
             kv, int(causal), scale, None)
    assert err == 0
    want = attention.flash_attention_bwd_reference(q, k, v, out, dout, causal=causal,
                                                   valid_len=kv)
    return (dq, dk, dv), want


@pytest.mark.parametrize("b,n,heads,d,kv", [
    (1, 150, 2, 64, 140),  # ragged tiles, pad keys; pad rows reach dk / dv
    (1, 140, 1, 128, 133),
    (1, 100, 1, 256, 90),  # head dim 256: 4 warps, 32-row tiles, dk then dv
    (2, 140, 1, 64, 140),  # batch 2, no pad keys: every chunk but the last unmasked
])
def test_oneshot_backward_source_matches_plain_version(libs, b, n, heads, d, kv):
    got, want = _run_mha(libs["mha"], b, n, heads, d, kv)
    _assert_grads_close(got, want, n, kv)


def _run_qkv(fn, b, n, heads, d, kv, seed):
    qkv, q, k, v, dout = _inputs(b, n, heads, d, seed=seed)
    scale, hd = d**-0.5, heads * d
    out = mha_kernel.mha_qkv_attention_reference(qkv, heads, valid_len=kv)
    stats = _row_stats(q, k, kv, scale, True)
    dqkv = torch.full_like(qkv, float("nan"))
    dcoef, scratch = torch.empty(b, heads, n), torch.empty(2, b, heads, n, d, dtype=torch.bfloat16)
    dout = dout.reshape(b, n, hd)
    err = fn(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), stats.data_ptr(),
             dcoef.data_ptr(), scratch.data_ptr(), dqkv.data_ptr(), b, n, heads, d, kv,
             scale * LOG2E, scale, None)
    assert err == 0
    want = mha_kernel.mha_qkv_attention_bwd_reference(qkv, out, dout, heads, valid_len=kv)
    split = lambda x: [t.view(b, n, heads, d) for t in x.split(hd, dim=-1)]
    return split(dqkv), split(want)


def test_fused_qkv_backward_source_matches_plain_version(libs):
    got, want = _run_qkv(libs["qkv"], 1, 130, 2, 64, 100, seed=5)
    _assert_grads_close(got, want, 130, 100)


@pytest.mark.parametrize("b,n,heads,d,kv", [
    (1, 140, 1, 128, 133),  # head dim 128: qkv's column blocks of 3 * 128
    (2, 70, 1, 64, 70),  # batch 2, one ragged tile, no pad keys
])
def test_fused_qkv_backward_source_at_more_shapes(libs, b, n, heads, d, kv):
    got, want = _run_qkv(libs["qkv"], b, n, heads, d, kv, seed=n + d)
    _assert_grads_close(got, want, n, kv)


@pytest.mark.parametrize("b,n,heads,d,kv,causal", [
    (1, 150, 2, 64, 140, False),  # pad rows: dq = 0, no share in dk / dv
    (1, 200, 1, 64, 200, True),
    (1, 140, 1, 128, 120, True),
    (2, 130, 1, 64, 130, False),  # batch 2, no pad rows
    (1, 300, 1, 64, 290, True),  # causal over three 128-row blocks, with pad keys
])
def test_flash_backward_source_matches_plain_version(libs, b, n, heads, d, kv, causal):
    got, want = _run_flash(libs["flash"], b, n, heads, d, kv, causal)
    _assert_grads_close(got, want, kv, kv)
    assert not got[0][:, kv:].any()  # pad rows' dq


@pytest.mark.parametrize("kernel,d,causal", [
    ("mha", 64, False),
    ("mha", 256, False),  # the dk/dv kernel's two passes
    ("flash", 64, True),
])
def test_backward_sources_are_bitwise_deterministic(libs, kernel, d, causal):
    """A second call on the same inputs gives the same gradients bit for bit:
    the kernels have no atomics, so every sum runs in one order."""
    run = ((lambda: _run_mha(libs["mha"], 1, 150, 1, d, 140)) if kernel == "mha"
           else (lambda: _run_flash(libs["flash"], 1, 150, 1, d, 140, causal)))
    (first, want), (second, _) = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _assert_grads_close(first, want, 150 if kernel == "mha" else 140, 140)


def test_entry_points_refuse_what_the_kernels_do_not_take(libs):
    """Head dim 256 in K2 (K1 takes 64 / 128) and in K4b, head dim 32, and
    kv_len outside [1, N] return cudaErrorInvalidValue (1) before any
    launch."""
    args = lambda d, kv: [None] * 7 + [1, 64, 1, d, kv, 1.0, 1.0, None]
    assert libs["qkv"](*args(256, 64)) == 1
    assert libs["qkv"](*args(32, 64)) == 1
    assert libs["qkv"](*args(64, 65)) == 1
    flash = lambda d, kv: libs["flash"](*([None] * 9 + [0] * 9 + [1, 64, 1, d, kv, 0, 1.0, None]))
    assert flash(256, 64) == 1 and flash(64, 0) == 1
