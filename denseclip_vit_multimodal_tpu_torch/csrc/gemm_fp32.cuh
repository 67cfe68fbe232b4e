// The fp32 product of the fp32 fused kernels, on the tensor cores by 3xTF32
// (mma_tf32.cuh): K6's projection with the LayerNorm as its A prologue
// (ln_qkv_attention_fp32.cu) and K7's out-projection
// (qkv_out_attention_fp32.cu).  ops/_build.py hashes this header into the
// name of every library built from csrc/.
//
//   C [rows, cols] = A' B (+ bias, then columns < scale_cols times col_scale)
//   A  [rows, K] fp32 row-major; A' = A, or with `kLayerNorm` the TPU
//      kernel's LayerNorm of each row: ((a - mean) * rstd) * gamma + beta,
//      each step rounded on its own (mean / rstd from a [rows] float2);
//   B  with `kBT` [cols, K] (the torch Linear layout W^T), else [K, cols];
//   K a multiple of kRoundK (32), cols a multiple of 4; rows any.
// Every product is 3xTF32 (each operand split into a TF32 high part and its
// remainder, three TF32 products, about 2^-21 of each term lost).  The
// tensor cores truncate where they accumulate, so each kRoundK = 32 of K is
// summed from zero and added to the accumulator with one rounding to
// nearest (over K = 768 the truncation alone would bias the sums by ~1e-5
// relative).  The bias is added after the sum and the scale applied after
// the bias, each once rounded, as the TPU kernels' fp32 `dot + bias` then
// `* scale`.
//
// Design: one block of 8 warps per 128 x 128 tile of C, each warp on 64 x
// 32 (4 x 4 mma tiles of m16n8k8 .tf32).  The A and B k-tiles (kBK = 16
// deep) stream through a four-stage ring of 16-byte cp.async copies that
// land in split planes (tf32_frag.cuh; A and W^T in NK planes, an MN-major
// B in a KN plane); the thread that copied a chunk applies the LayerNorm to
// it (K6) and splits it in place after its own wait, so each element is
// normalised and split once a block, and every fragment is one or two
// 16-byte shared loads.  K-tile t + 1 is split after k-tile t's HMMAs while
// t + 3 lands, each k-tile's work straight-line code; one block barrier a
// k-tile publishes t + 1's planes and frees t's stage.  Not wgmma: TF32
// wgmma reads both operands K-major, which K6's A and W^T are but K7's W_out
// is not; mma.sync serves both.
//
// Bound on an H100 SXM: 2 rows cols K FLOP; at the 3xTF32 ceiling of 165
// TFLOP/s (a third of the 495 TFLOP/s TF32 rate) K6's projection at the
// slide shape [15360, 768] x [768, 2304] (54.4 GFLOP) takes 0.330 ms and
// K7's [16010, 768] x [768, 768] (18.9 GFLOP) 0.114 ms; at the fp32 FMA
// peak of 66.9 TFLOP/s they would be 0.81 and 0.28 ms.

#pragma once

#include "tf32_frag.cuh"

namespace dclip {
namespace f32 {

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kGemmWarps = 8, kGemmThreads = 32 * kGemmWarps, kGemmStages = 4;
constexpr int kRoundK = 32;  // the depth summed from zero before each rounded add
constexpr int kWarpsN = 4;                              // 2 x 4 warps
constexpr int kWM = kBM / (kGemmWarps / kWarpsN);       // a warp's 64 rows
constexpr int kWN = kBN / kWarpsN;                      // and 32 columns
constexpr int kMT = kWM / 16, kNT = kWN / 8;            // its mma tiles
constexpr int kLdA = 2 * kBK + 16;  // NK plane of A (and of W^T): 16 mod 32 words
constexpr int kLdB = 4 * kBN + 8;   // KN plane of an MN-major B: 8 mod 32 words

template <bool kBT>
__host__ __device__ constexpr int gemm_stage_words() {
  return kBM * kLdA + (kBT ? kBN * kLdA : kBK / 2 * kLdB);
}

template <bool kBT>
constexpr size_t gemm_smem() {
  return sizeof(float) * (size_t)kGemmStages * gemm_stage_words<kBT>();
}

struct GemmArgs {
  const float* a;  // [rows, K]
  const float* b;  // [cols, K] (kBT) or [K, cols]
  float* c;        // [rows, cols]
  const float* bias;    // [cols] or null
  const float2* stats;  // kLayerNorm: [rows] (mean, rstd)
  const float* gamma;   // kLayerNorm: [K]
  const float* beta;
  int rows, cols, k;
  int scale_cols;   // columns < scale_cols are multiplied by col_scale
  float col_scale;
};

// The TPU kernel's LayerNorm of an A chunk (tile row r, tile column c) of
// the k-tile at k0, before its split; a row past the end (zero-filled, never
// stored) takes the last row's statistics.
struct LayerNormChunk {
  const float2* stats;
  const float* gamma;
  const float* beta;
  int m0, rows, k0;
  __device__ __forceinline__ void operator()(int r, int c, float4& x) const {
    const float2 st = stats[min(m0 + r, rows - 1)];
    const float4 ga = ld4(gamma + k0 + c), be = ld4(beta + k0 + c);
    auto ln = [&](float e, float gm, float bt) {
      return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(e, st.x), st.y), gm), bt);
    };
    x = make_float4(ln(x.x, ga.x, be.x), ln(x.y, ga.y, be.y), ln(x.z, ga.z, be.z),
                    ln(x.w, ga.w, be.w));
  }
};

template <bool kLayerNorm, bool kBT>
__device__ __forceinline__ void gemm(const GemmArgs& g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);  // [stage][A plane, B plane]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;
  const int k_tiles = g.k / kBK;
  auto stage = [&](int kt) { return smem + (kt % kGemmStages) * gemm_stage_words<kBT>(); };
  // k-tile kt into its stage (one group); past the last, zero-filled without
  // a read, so the loop below runs the same straight-line code to its end
  auto issue = [&](int kt) {
    const bool on = kt < k_tiles;
    float* sa = stage(kt);
    float* sb = sa + kBM * kLdA;
    const int k0 = min(kt, k_tiles - 1) * kBK;
    tf32::land_nk<kBM, kBK, kGemmThreads>(sa, kLdA, g.a + (long long)m0 * g.k + k0, g.k,
                                          g.rows - m0, kBK, tid, on);
    if constexpr (kBT)
      tf32::land_nk<kBN, kBK, kGemmThreads>(sb, kLdA, g.b + (long long)n0 * g.k + k0, g.k,
                                            g.cols - n0, kBK, tid, on);
    else
      tf32::land_kn<kBK, kBN, kGemmThreads>(sb, kLdB, g.b + (long long)k0 * g.cols + n0, g.cols,
                                            kBK, g.cols - n0, tid, on);
    cp_async_commit();
  };

  // this thread's chunks of k-tile kt, after its own wait (past the last k-tile:
  // a stage nothing reads, normalised with the last k-tile's parameters)
  auto split = [&](int kt) {
    float* sa = stage(kt);
    float* sb = sa + kBM * kLdA;
    if constexpr (kLayerNorm)
      tf32::split_nk<kBM, kBK, kGemmThreads>(
          sa, kLdA, tid,
          LayerNormChunk{g.stats, g.gamma, g.beta, m0, g.rows, min(kt, k_tiles - 1) * kBK});
    else
      tf32::split_nk<kBM, kBK, kGemmThreads>(sa, kLdA, tid);
    if constexpr (kBT)
      tf32::split_nk<kBN, kBK, kGemmThreads>(sb, kLdA, tid);
    else
      tf32::split_kn<kBK, kBN, kGemmThreads>(sb, kLdB, tid);
  };

  float acc[kMT][kNT][4], part[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = part[mi][ni][e] = 0.f;

  for (int s = 0; s + 1 < kGemmStages; ++s) issue(s);
  cp_async_wait<kGemmStages - 2>();  // k-tile 0 has landed (this thread's copies)
  split(0);
  __syncthreads();
  // k-tile kt + kGemmStages - 1 lands while kt is used and kt + 1 is split
  // (after the HMMAs: split first, the compiler interleaves the two and the
  // HMMAs wait); one barrier a k-tile publishes kt + 1 and frees kt's stage.
  // K is a multiple of kRoundK: the loop takes the k-tiles of one rounded
  // sum at a time, each k-tile straight-line code.
  for (int k0 = 0; k0 < k_tiles; k0 += kRoundK / kBK) {
#pragma unroll
    for (int kt = k0; kt < k0 + kRoundK / kBK; ++kt) {
      issue(kt + kGemmStages - 1);  // into k-tile kt - 1's stage, freed by the last barrier
      const float* sa = stage(kt);
      const float* sb = sa + kBM * kLdA;
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        FragA af[kMT];
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
          af[mi] = tf32::frag_a_nk(sa + (wm + 16 * mi) * kLdA, kLdA, kk, gq, t);
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
          FragB bf;
          if constexpr (kBT)
            bf = tf32::frag_b_nk_split(sb + (wn + 8 * ni) * kLdA, kLdA, kk, gq, t);
          else
            bf = tf32::frag_b_kn_split(sb, kLdB, kk, wn + 8 * ni, gq, t);
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi) mma_3xtf32(part[mi][ni], af[mi], bf);
        }
      }
      cp_async_wait<kGemmStages - 2>();  // k-tile kt + 1 has landed (this thread's copies)
      split(kt + 1);
      __syncthreads();
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], part[mi][ni][e]);
          part[mi][ni][e] = 0.f;
        }
  }

  // rows g and g + 8 of each mma tile, columns 2t and 2t + 1
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + 16 * mi + gq + 8 * half;
      if (row >= g.rows) continue;
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const int col = n0 + wn + 8 * ni + 2 * t;
        if (col >= g.cols) continue;  // cols % 4 == 0: col + 1 is inside too
        float y[2] = {acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (g.bias != nullptr) y[e] = __fadd_rn(y[e], g.bias[col + e]);
          if (col + e < g.scale_cols) y[e] = __fmul_rn(y[e], g.col_scale);
        }
        *reinterpret_cast<float2*>(g.c + (long long)row * g.cols + col) = make_float2(y[0], y[1]);
      }
    }
}

template <bool kLayerNorm, bool kBT>
__global__ void __launch_bounds__(kGemmThreads) gemm_fp32_kernel(const GemmArgs g) {
  gemm<kLayerNorm, kBT>(g);
}

template <bool kLayerNorm, bool kBT>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  static_assert(kGemmStages >= 3 && kRoundK % kBK == 0, "the ring and the rounded sums");
  if (g.rows < 1 || g.cols < 4 || g.cols % 4 || g.k < kRoundK || g.k % kRoundK)
    return cudaErrorInvalidValue;
  auto kernel = gemm_fp32_kernel<kLayerNorm, kBT>;
  constexpr size_t smem = gemm_smem<kBT>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.cols + kBN - 1) / kBN, (g.rows + kBM - 1) / kBM);
  kernel<<<grid, kGemmThreads, smem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace f32
}  // namespace dclip
