"""Helpers of the emulated CUDA source tests (not a test module): the
build of a `csrc/` source against the CPU emulation in `tests/cuda_emu/`,
the backward sources' fixture, seeded inputs, the plain row statistics and
the backward kernels' limits.  `tests/test_torch_cuda_emulated*.py` import it.
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
# chip_smoke.py's limits for K5 against its plain version on the same operands
INT8_MAX_TOL, INT8_REL_TOL = 2e-2, 5e-3
_LAUNCH = re.compile(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), [^>]*>>>\((\w+)\)")
_SHARED = re.compile(r"extern __shared__ __align__\(\d+\) unsigned char smem_raw\[\];")


def _build(src: str, out: Path) -> ctypes.CDLL:
    """`csrc/<src>.cu` compiled against the emulation: every `csrc/` header
    copied beside it with each `<<<...>>>` launch made an `emu_launch` and
    each block's dynamic shared memory the emulation's one array, then the
    emulation's headers over their `csrc/` namesakes, so that an `#include
    "..."` from any header finds the emulated ones."""
    work = out / src
    work.mkdir()
    emulated = lambda text: _SHARED.sub("unsigned char* const smem_raw = emu::smem_base;",
                                        _LAUNCH.sub(r"emu_launch(\1, \2, \3, \4, \5)", text))
    for header in CSRC.glob("*.cuh"):
        (work / header.name).write_text(emulated(header.read_text()))
    for header in EMU.glob("*.cuh"):
        shutil.copy(header, work)
    (work / f"{src}.cpp").write_text(
        '#include "cuda_runtime.h"\n' + emulated((CSRC / f"{src}.cu").read_text()))
    lib = out / f"lib{src}.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
         f"-I{EMU}", f"-I{work}", f"-I{CSRC}", "-o", str(lib), str(work / f"{src}.cpp"),
         str(EMU / "emu_main.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ctypes.CDLL(str(lib))


def _build_all(srcs, out: Path, workers: int = 4) -> list:
    """`_build` of each source, `workers` host compilers at a time."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(lambda src: _build(src, out), srcs))


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

