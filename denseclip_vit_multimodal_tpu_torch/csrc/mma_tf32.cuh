// Warp-level TF32 tensor-core helpers of the fp32 attention backward
// (attention_bwd_fp32.cuh): the 3xTF32 split of an fp32 operand and
// mma.sync m16n8k8 on TF32.  tests/cuda_emu/mma_tf32.cuh is the CPU
// emulation of this header.  ops/_build.py hashes this header into the name
// of every library built from csrc/.
//
// Fragment layout of mma.sync m16n8k8 .tf32 (g = lane / 4, t = lane % 4):
//   A 16x8 row-major: a0 (row g, col t),     a1 (row g + 8, col t),
//                     a2 (row g, col t + 4), a3 (row g + 8, col t + 4)
//   B 8x8 "col":      b0 (row k = t, col n = g), b1 (row k = t + 4, col g)
//   C 16x8:           c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8, ...)
//
// 3xTF32: x = hi + lo with hi = x rounded to TF32 (10 mantissa bits, to
// nearest, ties away from zero: cvt.rna's rounding) and lo = x - hi, exact
// in fp32; a b is then lo_a hi_b + hi_a lo_b + hi_a hi_b, summed in that
// order into the fp32 accumulator (lo_a lo_b, about 2^-24 of a b, is
// dropped).  The tensor cores read a TF32 operand's top 19 bits, so lo
// enters with its 11 leading significant bits (2^-22 of x); each product
// keeps about fp32's accuracy where one TF32 product keeps about three
// digits.  The rounding is two integer operations: cvt.rna.tf32.f32 takes
// four (it tests for Inf and NaN), and rounding lo as well doubles that,
// which made the split most of the inner loops' work.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dclip {

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as fp32 bits: cvt.rna's result for every finite x.  A NaN may come out as
// another value; its remainder x - hi is then NaN and carries it.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An A fragment (a0-a3) and a B fragment (b0, b1), each split into its
// TF32 high parts and remainders.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));  // exact
}

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

// c += a * b, TF32 inputs, fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b to fp32 accuracy: three TF32 products, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float c[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// acc += a * b as mma_3xtf32, the three products summed from zero and then
// added to acc with one fp32 rounding to nearest.  The tensor cores do not
// round where they add to the accumulator (they truncate), and over the
// thousands of steps of a sum along a sequence that bias grows with its
// length; added this way, each step rounds once, to nearest.
__device__ __forceinline__ void mma_3xtf32_rn(float acc[4], const FragA& a, const FragB& b) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(c, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], c[i]);
}

}  // namespace dclip
