"""The CPU emulation of `csrc/mma_tf32.cuh` (`tests/cuda_emu/mma_tf32.cuh`),
which the emulated fp32 backward core runs on, against a numpy float64
version of the PTX ISA's definitions: the fragment layout of mma.sync
m16n8k8 .tf32 (A row-major 16 x 8, B 8 x 8 by column, C 16 x 8, lane =
4 g + t; the tensor cores read an operand's top 19 bits), the rounding of
`cvt.rna.tf32.f32` (10 mantissa bits, to nearest, ties away from zero) and
the 3xTF32 split x = hi + lo (hi rounded so, lo = x - hi exact).  A probe
source, compiled by the host compiler against `tests/cuda_emu/`, runs the
header's functions on one emulated warp.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

EMU = Path(__file__).resolve().parent / "cuda_emu"

PROBE = r"""
#include "cuda_runtime.h"
#include "mma_tf32.cuh"

using namespace dclip;

struct Args {
  const void* a;  // [steps][32][4]: TF32 bits (tf32) or fp32 values (three_x)
  const void* b;  // [steps][32][2]
  float* c;       // [32][4], accumulated in place
  int steps, three_x;
};

void probe(Args p) {
  const int l = threadIdx.x;
  float* c = p.c + 4 * l;
  for (int s = 0; s < p.steps; ++s) {
    if (p.three_x) {
      const float* a = static_cast<const float*>(p.a) + (s * 32 + l) * 4;
      const float* b = static_cast<const float*>(p.b) + (s * 32 + l) * 2;
      mma_3xtf32(c, split_a(a[0], a[1], a[2], a[3]), split_b(b[0], b[1]));
    } else {
      const uint32_t* a = static_cast<const uint32_t*>(p.a) + (s * 32 + l) * 4;
      const uint32_t* b = static_cast<const uint32_t*>(p.b) + (s * 32 + l) * 2;
      mma_tf32(c, a, b[0], b[1]);
    }
  }
}

extern "C" void warp_mma(const void* a, const void* b, float* c, int steps, int three_x) {
  emu_launch(probe, dim3(1), 32, 0, Args{a, b, c, steps, three_x});
}

extern "C" void split(const float* x, uint32_t* hi, uint32_t* lo, int n) {
  for (int i = 0; i < n; ++i) split_tf32(x[i], hi[i], lo[i]);
}
"""


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a C++20 host compiler (g++)")
    out = tmp_path_factory.mktemp("cuda_emu_tf32")
    (out / "probe.cpp").write_text(PROBE)
    lib = out / "libprobe.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{EMU}", "-o", str(lib),
         str(out / "probe.cpp"), str(EMU / "emu_main.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    so = ctypes.CDLL(str(lib))
    ptr, i = ctypes.c_void_p, ctypes.c_int
    so.warp_mma.argtypes, so.warp_mma.restype = [ptr, ptr, ptr, i, i], None
    so.split.argtypes, so.split.restype = [ptr, ptr, ptr, i], None
    return so


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """fp32 values rounded to 11 significant bits, to nearest, ties away from
    zero, in float64 (normal numbers)."""
    x = np.asarray(x, np.float64)
    m, e = np.frexp(x)  # x = m 2^e, 0.5 <= |m| < 1
    q = m * 2.0**11
    return np.ldexp(np.sign(q) * np.floor(np.abs(q) + 0.5), e - 11)


def trunc_tf32(x: np.ndarray) -> np.ndarray:
    """fp32 values as the tensor cores read them: the low 13 bits dropped."""
    return (np.asarray(x, np.float32).view(np.uint32) & 0xffffe000).view(np.float32)


def split_np(x: np.ndarray):
    """hi, and lo as the tensor cores read it, in float64."""
    hi = rna_tf32(x)
    return hi, trunc_tf32(x.astype(np.float64) - hi).astype(np.float64)


def frag_a(a: np.ndarray) -> np.ndarray:
    """[steps][32][4] A fragments of a 16 x 8k row-major A, k-step by k-step."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    return np.stack([np.stack([a[g, 8 * s + t], a[g + 8, 8 * s + t], a[g, 8 * s + t + 4],
                               a[g + 8, 8 * s + t + 4]], -1) for s in range(a.shape[1] // 8)])


def frag_b(b: np.ndarray) -> np.ndarray:
    """[steps][32][2] B fragments of an 8k x 8 B."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    return np.stack([np.stack([b[8 * s + t, g], b[8 * s + t + 4, g]], -1)
                     for s in range(b.shape[0] // 8)])


def from_frag_c(c: np.ndarray) -> np.ndarray:
    """The 16 x 8 C of the lanes' [32][4] accumulators."""
    out = np.empty((16, 8), c.dtype)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for e in range(4):
        out[g + 8 * (e >> 1), 2 * t + (e & 1)] = c[:, e]
    return out


def run(probe, fa: np.ndarray, fb: np.ndarray, three_x: bool) -> np.ndarray:
    fa, fb = np.ascontiguousarray(fa), np.ascontiguousarray(fb)
    c = np.zeros((32, 4), np.float32)
    probe.warp_mma(fa.ctypes.data, fb.ctypes.data, c.ctypes.data, fa.shape[0], int(three_x))
    return from_frag_c(c)


def test_fragment_layout_is_exact_and_low_bits_are_ignored(probe):
    """Small integers are exact in TF32 and in every fp32 sum here, so the
    emulated product equals A B exactly unless a lane's element lands in the
    wrong place; low mantissa bits below TF32's are dropped, as the tensor
    cores drop them."""
    rng = np.random.default_rng(0)
    a = rng.integers(-8, 9, (16, 32)).astype(np.float32)
    b = rng.integers(-8, 9, (32, 8)).astype(np.float32)
    junk = lambda x: (x.view(np.uint32) | rng.integers(0, 0x1000, x.shape, dtype=np.uint32)
                      * (x != 0))
    got = run(probe, frag_a(junk(a)), frag_b(junk(b)), three_x=False)
    assert np.array_equal(got, (a.astype(np.float64) @ b).astype(np.float32))


def test_split_rounds_hi_to_nearest_ties_away_and_holds_x_exactly(probe):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-3, 3, 4096)).astype(np.float32)
    # exact ties: 13 dropped bits of 0x1000, both signs; they round away from zero
    ties = ((rng.integers(0x3f000000, 0x41000000, 64, dtype=np.uint32) & 0xffffe000)
            | 0x1000).view(np.float32)
    x = np.concatenate([x, ties, -ties])
    hi, lo = np.empty(x.shape, np.uint32), np.empty(x.shape, np.uint32)
    probe.split(x.ctypes.data, hi.ctypes.data, lo.ctypes.data, x.size)
    hi, lo = hi.view(np.float32).astype(np.float64), lo.view(np.float32).astype(np.float64)
    assert np.array_equal(hi, rna_tf32(x))
    assert np.all(np.abs(hi[-128:]) > np.abs(x[-128:]))  # the ties went up
    assert np.array_equal(hi + lo, x.astype(np.float64))  # lo = x - hi exactly
    assert np.all(np.abs(lo) <= 2.0**-11 * np.abs(x))  # half an ulp of 11 bits
    # lo as the tensor cores read it (its 11 leading bits) holds x to 2^-21
    assert np.all(np.abs(hi + trunc_tf32(lo) - x) <= 2.0**-21 * np.abs(x))
    # a NaN, whatever its payload, reaches the product through hi or lo
    nan = np.array([0x7FC00000, 0x7FFFFFFF, 0xFFFFF000, 0x7F800001], np.uint32).view(np.float32)
    hi, lo = np.empty(4, np.uint32), np.empty(4, np.uint32)
    probe.split(nan.ctypes.data, hi.ctypes.data, lo.ctypes.data, 4)
    assert np.all(np.isnan(trunc_tf32(hi.view(np.float32))) | np.isnan(trunc_tf32(
        lo.view(np.float32))))


def test_3xtf32_product_keeps_fp32_accuracy_where_1xtf32_does_not(probe):
    """A 16 x 256 by 256 x 8 product: 3xTF32 (split in registers, three
    products a step) lands within 1e-6 relative of float64, and the numpy
    version of the same split agrees; one TF32 product of the rounded
    operands does not."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((16, 256)).astype(np.float32)
    b = rng.standard_normal((256, 8)).astype(np.float32)
    exact = a.astype(np.float64) @ b
    rel = lambda got: float(np.linalg.norm(got - exact) / np.linalg.norm(exact))
    three = run(probe, frag_a(a), frag_b(b), three_x=True)
    (ahi, alo), (bhi, blo) = split_np(a), split_np(b)
    assert rel(three) <= 1e-6
    assert rel(ahi @ blo + alo @ bhi + ahi @ bhi) <= 1e-6
    one = run(probe, frag_a(ahi.astype(np.float32)).view(np.uint32),
              frag_b(bhi.astype(np.float32)).view(np.uint32), three_x=False)
    assert rel(one) > 1e-6
    assert abs(rel(one) - rel(ahi @ bhi)) <= 1e-6
