// Warp-level bf16 tensor-core helpers shared by the kernels under csrc/.
// ops/_build.py hashes this header into the name of every library built
// from csrc/, so an edit here rebuilds them all.
//
// Fragment layout of mma.sync m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 (row g, cols 2t..2t+1), a1 (row g+8, cols 2t..),
//                      a2 (row g, cols 2t+8..),   a3 (row g+8, cols 2t+8..)
//   B 16x8 "col":      b0 (rows 2t..2t+1, col g), b1 (rows 2t+8.., col g)
//   C 16x8:            c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, ...)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dclip {

constexpr int kVec = 8;  // bf16 per 16-byte global load

union Vec8 {
  uint4 u;
  __nv_bfloat16 h[kVec];
};

// c += a * b, bf16 inputs, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16; `lo` lands in the low half (lower index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of rows [r0, r0 + 16) x cols [c0, c0 + 16) of a row-major
// bf16 tile in shared memory with row stride `ld`.
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* s,
                                       int ld, int r0, int c0, int g, int t) {
  const __nv_bfloat16* p0 = s + (r0 + g) * ld + c0 + 2 * t;
  const __nv_bfloat16* p1 = p0 + 8 * ld;
  a[0] = ld_u32(p0);
  a[1] = ld_u32(p1);
  a[2] = ld_u32(p0 + 8);
  a[3] = ld_u32(p1 + 8);
}

// The B fragment of cols [n0, n0 + 8) x rows [k0, k0 + 16) of a K x N operand
// stored N-major in shared memory (row n holds the operand's column n, k
// contiguous) with row stride `ld`.
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const __nv_bfloat16* s, int ld, int n0,
                                       int k0, int g, int t) {
  const __nv_bfloat16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b0 = ld_u32(p);
  b1 = ld_u32(p + 8);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8x8 bf16 matrices from shared memory (lane l addresses row l of the
// four stacked matrices): the A fragment of a 16x16 tile, or the B
// fragments of two 8-wide n-tiles of an N-major operand.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

}  // namespace dclip
