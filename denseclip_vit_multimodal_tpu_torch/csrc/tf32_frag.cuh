// Fragment helpers of the 3xTF32 mma.sync cores (mma_tf32.cuh): the fp32
// attention backward (attention_bwd_fp32.cuh), the fp32 attention forward
// (attention_fp32.cuh) and the fp32 product of the fused kernels
// (gemm_fp32.cuh).  Plain device code on top of mma_tf32.cuh, so the CPU
// emulation (tests/cuda_emu/) compiles it as it stands.  ops/_build.py
// hashes this header into the name of every library built from csrc/.
//
// Two kinds of helper:
//   * fragments of plain fp32 tiles, split in registers at each load
//     (frag_a, frag_b_nk, frag_b_kn; c_as_a turns a C fragment into an A
//     fragment): the backward, whose streamed tiles are read by one
//     orientation each;
//   * split planes: a tile lands by cp.async in a plane's landing slots,
//     the thread that copied a chunk splits it in place into TF32 high
//     parts and remainders (split_nk, split_kn: once a tile, not once a
//     warp), and every fragment is then one 16-byte shared load with no
//     arithmetic (frag_a_nk, frag_b_nk_split, frag_b_kn_split).
//
// The split planes run the mma's k index in the permuted order t <-> 2t,
// t + 4 <-> 2t + 1 within each 8-deep k-step (the order of c_as_a), so the
// two k values a lane holds are neighbours:
//   NK plane (k along a row: Q, K, A, W^T): row r, pair i = k / 2 at words
//     r * ld + 4 i: {hi(2i), hi(2i + 1), lo(2i), lo(2i + 1)}; ld = 16 mod 32
//     words, so the 16-byte loads of a quarter-warp (g in {0, 1}, t in
//     0..3) hit 32 distinct banks; a raw 16-byte chunk (row r, k c..c + 3)
//     lands at r * ld + 2c, and its split fills words 2c..2c + 7;
//   KN plane (k down the rows: V, W_out): pair row p (k = 2p, 2p + 1), column
//     n at words p * ld + 4n: {hi(2p), hi(2p + 1), lo(2p), lo(2p + 1)}; ld =
//     8 mod 32 words (a quarter-warp's t on pair rows, g on columns: banks
//     8t + 4g..+3); the raw chunks (2p, n c..c + 3) and (2p + 1, c..c + 3)
//     land at p * ld + 4c and + 4c + 4, and their split fills 4c..4c + 15.
// A chunk's split overwrites only its own landing slot and the gap after
// it, so no other thread's chunk: no barrier between a thread's cp.async
// wait and its split.

#pragma once

#include "mma_bf16.cuh"  // cp_async16
#include "mma_tf32.cuh"

namespace dclip {

// ---- plain fp32 tiles, split at each load (the backward) ----------------

// The A fragment of rows [r0, r0 + 16) x cols [c0, c0 + 8) of a row-major
// tile (k along the row), split.
template <int kLd>
__device__ __forceinline__ FragA frag_a(const float* s, int r0, int c0, int g, int t) {
  const float* p = s + (r0 + g) * kLd + c0 + t;
  return split_a(p[0], p[8 * kLd], p[4], p[8 * kLd + 4]);
}

// The B fragment of n-rows [n0, n0 + 8) x k-cols [k0, k0 + 8) of an operand
// stored [n][k] (k along the row; K-major), times `scale` (rounded) with
// kScale, split.
template <int kLd, bool kScale = false>
__device__ __forceinline__ FragB frag_b_nk(const float* s, int n0, int k0, int g, int t,
                                           float scale = 1.f) {
  const float* p = s + (n0 + g) * kLd + k0 + t;
  float b0 = p[0], b1 = p[4];
  if constexpr (kScale) {
    b0 = __fmul_rn(b0, scale);
    b1 = __fmul_rn(b1, scale);
  }
  return split_b(b0, b1);
}

// The B fragment of k-rows [k0, k0 + 8) x n-cols [n0, n0 + 8) of an operand
// stored [k][n] (n along the row; MN-major) in the permuted k order (b0 from
// row k0 + 2t, b1 from row k0 + 2t + 1), rows times s0 / s1 (rounded) with
// kScale, split.
template <int kLd, bool kScale = false>
__device__ __forceinline__ FragB frag_b_kn(const float* s, int k0, int n0, int g, int t,
                                           float s0 = 1.f, float s1 = 1.f) {
  const float* p = s + (k0 + 2 * t) * kLd + n0 + g;
  float b0 = p[0], b1 = p[kLd];
  if constexpr (kScale) {
    b0 = __fmul_rn(b0, s0);
    b1 = __fmul_rn(b1, s1);
  }
  return split_b(b0, b1);
}

// The C fragment of an 8-wide n-tile as the A fragment of an 8-deep k-step
// in the permuted k order (c0 / c1: row g, columns 2t / 2t + 1), split.
__device__ __forceinline__ FragA c_as_a(const float c[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// ---- split planes ----------------------------------------------------------

namespace tf32 {

// Each helper below walks the kRows x kCols tile's 16-byte chunks (pairs of
// chunks in a KN plane) a thread at a time, a fixed number each (static
// trip counts: straight-line code the compiler may interleave with the
// tensor-core work of the previous tile), the same chunks in land_* and
// split_*.

// Rows [0, kRows) x cols [0, kCols) of a row-major fp32 operand (`stride`
// elements between rows, unit stride along a row) into an NK plane's
// landing slots by 16-byte cp.async; rows >= lim, chunks at or past col_lim
// and every chunk when `on` is false are zero-filled without a read.
template <int kRows, int kCols, int kThreads>
__device__ __forceinline__ void land_nk(float* plane, int ld, const float* src, long long stride,
                                        int lim, int col_lim, int tid, bool on = true) {
  constexpr int kChunks = kCols / 4, kPer = kRows * kChunks / kThreads;
  static_assert(kRows * kChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kThreads, r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = on && r < lim && c < col_lim;
    cp_async16(plane + r * ld + 2 * c, src + (ok ? (long long)r * stride + c : 0), ok ? 16 : 0);
  }
}

// Pairs of rows [0, kRows) of a row-major fp32 operand into a KN plane's
// landing slots, as land_nk.
template <int kRows, int kCols, int kThreads>
__device__ __forceinline__ void land_kn(float* plane, int ld, const float* src, long long stride,
                                        int lim, int col_lim, int tid, bool on = true) {
  constexpr int kChunks = kCols / 4, kPer = kRows / 2 * kChunks / kThreads;
  static_assert(kRows / 2 * kChunks % kThreads == 0, "whole chunk pairs a thread");
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kThreads, p = i / kChunks, c = (i % kChunks) * 4;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 2 * p + e;
      const bool ok = on && r < lim && c < col_lim;
      cp_async16(plane + p * ld + 4 * c + 4 * e, src + (ok ? (long long)r * stride + c : 0),
                 ok ? 16 : 0);
    }
  }
}

struct Identity {
  __device__ __forceinline__ void operator()(int, int, float4&) const {}
};

// This thread's chunks of land_nk, each first transformed by f(row, col, x)
// (the chunk's four values of columns col..col + 3, in place), then split
// in place.  Call after the thread's cp.async wait; a barrier makes the
// plane visible to the other warps.
template <int kRows, int kCols, int kThreads, class F = Identity>
__device__ __forceinline__ void split_nk(float* plane, int ld, int tid, F f = F()) {
  constexpr int kChunks = kCols / 4, kPer = kRows * kChunks / kThreads;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kThreads, r = i / kChunks, c = (i % kChunks) * 4;
    float* p = plane + r * ld + 2 * c;
    float4 x = *reinterpret_cast<const float4*>(p);
    f(r, c, x);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(p) = make_uint4(h[0], h[1], l[0], l[1]);
    *reinterpret_cast<uint4*>(p + 4) = make_uint4(h[2], h[3], l[2], l[3]);
  }
}

// This thread's chunks of land_kn, split in place (after its cp.async wait).
template <int kRows, int kCols, int kThreads>
__device__ __forceinline__ void split_kn(float* plane, int ld, int tid) {
  constexpr int kChunks = kCols / 4, kPer = kRows / 2 * kChunks / kThreads;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kThreads, p = i / kChunks, c = (i % kChunks) * 4;
    float* q = plane + p * ld + 4 * c;
    const float4 a = *reinterpret_cast<const float4*>(q);      // row 2p
    const float4 b = *reinterpret_cast<const float4*>(q + 4);  // row 2p + 1
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t ha, la, hb, lb;
      split_tf32(av[j], ha, la);
      split_tf32(bv[j], hb, lb);
      *reinterpret_cast<uint4*>(q + 4 * j) = make_uint4(ha, hb, la, lb);
    }
  }
}

// The A fragment of rows [0, 16) of an NK plane at `rows` (its row 0), k-step
// kk: two 16-byte loads, rows g and g + 8.
__device__ __forceinline__ FragA frag_a_nk(const float* rows, int ld, int kk, int g, int t) {
  const uint4 u = *reinterpret_cast<const uint4*>(rows + g * ld + 16 * kk + 4 * t);
  const uint4 v = *reinterpret_cast<const uint4*>(rows + (g + 8) * ld + 16 * kk + 4 * t);
  FragA f;
  f.hi[0] = u.x, f.hi[1] = v.x, f.hi[2] = u.y, f.hi[3] = v.y;
  f.lo[0] = u.z, f.lo[1] = v.z, f.lo[2] = u.w, f.lo[3] = v.w;
  return f;
}

// The B fragment of n-rows [0, 8) of an NK plane at `rows`, k-step kk.
__device__ __forceinline__ FragB frag_b_nk_split(const float* rows, int ld, int kk, int g, int t) {
  const uint4 u = *reinterpret_cast<const uint4*>(rows + g * ld + 16 * kk + 4 * t);
  FragB f;
  f.hi[0] = u.x, f.hi[1] = u.y, f.lo[0] = u.z, f.lo[1] = u.w;
  return f;
}

// The B fragment of k-step j (k rows 8j..8j + 7) x n-cols [n0, n0 + 8) of
// a KN plane.
__device__ __forceinline__ FragB frag_b_kn_split(const float* plane, int ld, int j, int n0, int g,
                                                 int t) {
  const uint4 u = *reinterpret_cast<const uint4*>(plane + (4 * j + t) * ld + 4 * (n0 + g));
  FragB f;
  f.hi[0] = u.x, f.hi[1] = u.y, f.lo[0] = u.z, f.lo[1] = u.w;
  return f;
}

}  // namespace tf32
}  // namespace dclip
