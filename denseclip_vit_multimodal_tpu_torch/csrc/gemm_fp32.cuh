// The fp32 SIMT product of the fp32 fused kernels: K6's projection with the
// LayerNorm as its A prologue (ln_qkv_attention_fp32.cu) and K7's
// out-projection (qkv_out_attention_fp32.cu).  ops/_build.py hashes this
// header into the name of every library built from csrc/.
//
//   C [rows, cols] = A' B (+ bias, then columns < scale_cols times col_scale)
//   A  [rows, K] fp32 row-major; A' = A, or with `kLayerNorm` the TPU
//      kernel's LayerNorm of each row: ((a - mean) * rstd) * gamma + beta,
//      each step rounded on its own (mean / rstd from a [rows] float2);
//   B  with `kBT` [cols, K] (the torch Linear layout W^T), else [K, cols];
//   K a multiple of kBK; rows and cols any.
// Every product is an fp32 FMA summed in k order from 0 (no TF32); the bias
// is added after the sum and the scale applied after the bias, each once
// rounded, as the TPU kernels' fp32 `dot + bias` then `* scale`.
//
// Design: one block of 256 threads per 64 x 128 tile of C, the A and B
// k-tiles (kBK = 32 deep) staged through shared memory by plain loads (the
// prologue applied on the way) with one buffer and two barriers a k-step;
// each thread owns 4 rows x 8 columns (attention_fp32.cuh's 16 x 16 grid:
// rows ty + 16 i; columns tx + 16 j with `kBT`, tx * 4 + 64 c + e without)
// and reads float4s of both tiles.  Simple and right first: no cp.async
// pipeline, no register double buffer (PERF.md gives the measured time
// beside the bound).
//
// Bound on an H100 SXM: 2 rows cols K FLOP at the 66.9 TFLOP/s fp32 FMA
// peak (K6's projection at the slide shape [15360, 768] x [768, 2304]:
// 54.4 GFLOP, 0.81 ms; K7's [16010, 768] x [768, 768]: 18.9 GFLOP, 0.28 ms).

#pragma once

#include "attention_fp32.cuh"

namespace dclip {
namespace f32 {

constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kLdA = kBK + 4;   // a padded row of the A k-tile
constexpr int kLdBt = kBK + 4;  // a padded row of the B k-tile, [cols][k] (kBT)
constexpr int kLdB = kBN + 4;   // a padded row of the B k-tile, [k][cols]

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

template <bool kBT>
constexpr size_t gemm_smem() {  // the A and B k-tiles, in bytes
  return sizeof(float) * (size_t)(kBM * kLdA + (kBT ? kBN * kLdBt : kBK * kLdB));
}

template <bool kLayerNorm, bool kBT>
__device__ __forceinline__ void gemm(const GemmArgs& g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sA = reinterpret_cast<float*>(smem_raw);  // [kBM][kLdA]
  float* sB = sA + kBM * kLdA;                     // [kBN][kLdBt] or [kBK][kLdB]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.k; k0 += kBK) {
    // A: 64 rows x 32 columns, two float4 a thread; rows past the end read 0
    for (int v = tid; v < kBM * kBK / 4; v += kThreads) {
      const int r = v / (kBK / 4), c = (v % (kBK / 4)) * 4, row = m0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < g.rows) {
        x = ld4(g.a + (long long)row * g.k + k0 + c);
        if constexpr (kLayerNorm) {
          const float2 st = g.stats[row];
          const float4 ga = ld4(g.gamma + k0 + c), be = ld4(g.beta + k0 + c);
          auto ln = [&](float e, float gm, float bt) {
            return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(e, st.x), st.y), gm), bt);
          };
          x = make_float4(ln(x.x, ga.x, be.x), ln(x.y, ga.y, be.y), ln(x.z, ga.z, be.z),
                          ln(x.w, ga.w, be.w));
        }
      }
      *reinterpret_cast<float4*>(sA + r * kLdA + c) = x;
    }
    // B: 128 columns x 32 k, four float4 a thread; columns past the end read 0
    for (int v = tid; v < kBN * kBK / 4; v += kThreads) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kBT) {
        const int r = v / (kBK / 4), c = (v % (kBK / 4)) * 4;  // r: column of C
        if (n0 + r < g.cols) x = ld4(g.b + (long long)(n0 + r) * g.k + k0 + c);
        *reinterpret_cast<float4*>(sB + r * kLdBt + c) = x;
      } else {
        const int r = v / (kBN / 4), c = (v % (kBN / 4)) * 4;  // r: k
        if (n0 + c < g.cols) x = ld4(g.b + (long long)(k0 + r) * g.cols + n0 + c);
        *reinterpret_cast<float4*>(sB + r * kLdB + c) = x;
      }
    }
    __syncthreads();
    if constexpr (kBT) {
      mm_nt<8, kBK, false>(acc, sA, kLdA, sB, kLdBt, ty, tx, 0.f);
    } else {
      mm_nn<2, kBK, false>(acc, sA, kLdA, sB, kLdB, ty, tx, nullptr);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= g.rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (kBT ? tx + 16 * j : tx * 4 + 64 * (j >> 2) + (j & 3));
      if (col >= g.cols) continue;
      float y = acc[i][j];
      if (g.bias != nullptr) y = __fadd_rn(y, g.bias[col]);
      if (col < g.scale_cols) y = __fmul_rn(y, g.col_scale);
      g.c[(long long)row * g.cols + col] = y;
    }
  }
}

template <bool kLayerNorm, bool kBT>
__global__ void __launch_bounds__(kThreads) gemm_fp32_kernel(const GemmArgs g) {
  gemm<kLayerNorm, kBT>(g);
}

template <bool kLayerNorm, bool kBT>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  if (g.rows < 1 || g.cols < 1 || g.k < kBK || g.k % kBK) return cudaErrorInvalidValue;
  const dim3 grid((g.cols + kBN - 1) / kBN, (g.rows + kBM - 1) / kBM);
  auto kernel = gemm_fp32_kernel<kLayerNorm, kBT>;
  kernel<<<grid, kThreads, gemm_smem<kBT>(), stream>>>(g);
  return cudaGetLastError();
}

}  // namespace f32
}  // namespace dclip
