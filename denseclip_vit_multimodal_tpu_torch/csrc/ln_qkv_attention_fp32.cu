// Fused LayerNorm + QKV projection + attention in fp32 (K6 under
// `tpu.compute_dtype: float32`).
//
// Replaces the TPU kernel `_lnqkv_kernel` of the JAX package
// (denseclip_vit_multimodal_tpu/ops/lnqkv_kernel.py, reached through
// `_lnqkv_fwd_impl` / `ln_qkv_attention`) on fp32 inputs, which the TPU
// kernel takes as it takes bf16 (JAX's dispatch asks nothing about the
// dtype):
//
//   x [B, N, D] fp32, gamma / beta [D] fp32, W^T [3*H*d, D] fp32 (the torch
//   Linear layout), bias [3*H*d] fp32  ->  out [B, N, H*d] fp32,
//   d in {64, 128}, D a multiple of 32
//
// Numerics follow the TPU kernel's fp32 rounding points (lnqkv_kernel.py:
// 50-75, 93-145):
//   * LayerNorm statistics in fp32 as mean and E[x^2], var = max(E[x^2] -
//     mean^2, 0), summed in the bf16 kernel's order (ln_qkv_stats_reference
//     repeats it bit for bit); ln = ((x - mean) * rstd) * gamma + beta,
//     kept in fp32, each step rounded on its own;
//   * k, v = ln W + b and q = (ln Wq + bq) * (scale * log2 e), fp32 sums of
//     3xTF32 products (gemm_fp32.cuh: each k-tile summed from zero and added
//     with one rounding), the bias then the scale each rounded once;
//   * attention as K1's fp32 kernel (attention_fp32.cuh) on the pre-scaled
//     q: 3xTF32 scores, exp2 softmax, 3xTF32 P V, one division.  Keys >=
//     valid_len are excluded (the TPU kernel's finfo.min mask); pad rows of
//     the residual stream carry LN(0) = beta, not zeros.
//   * Under DENSECLIP_FAST_EXP2 (exp mode 1), which the TPU kernel reads
//     through `_softmax_unnormalized` -> `_exp2`: p = exp2_poly(s - m)
//     against the row's final max (softmax_exp.cuh).
//
// Design: three launches, counted as one K6 launch, as the bf16 kernel's
// (ln_qkv_attention.cu):
//   (a) ln_qkv_stats_fp32_kernel: one warp per row, its (mean, rstd) into a
//       [B*N] float2 scratch (the `out` buffer, which only (c) writes);
//   (b) the 3xTF32 tensor-core product gemm_fp32.cuh with the LayerNorm
//       applied to each A chunk before its split, into an fp32 q/k/v
//       workspace [B, N, 3*H*d];
//   (c) ln_qkv_attention_fp32_kernel: K1's fp32 body on that workspace,
//       q_scale 1.
// LN(x) never reaches device memory; the workspace does (written once, read
// by (c)).
//
// Bound on an H100 SXM at the slide shape (x [10, 1536, 768], 12 heads of
// 64, valid_len 1522): projection 2*B*N*D*3*H*d = 54.4 GFLOP plus attention
// 4*B*H*N*valid_len*d = 71.8 GFLOP, at the 3xTF32 ceiling of 165 TFLOP/s:
// 0.765 ms, operation-bound (1.89 ms at the fp32 FMA peak of 66.9 TFLOP/s;
// PERF.md gives the measured time).

#include "attention_fp32.cuh"
#include "gemm_fp32.cuh"

namespace {

using namespace dclip::f32;
namespace softmax = dclip::softmax;

constexpr int kStatsThreads = 256;  // one warp per row

// (a) Each row's fp32 (mean, rstd): lane l adds elements 256 i + 8 l + j
// (i, then j), then a butterfly over the lanes; no FMA.
struct StatsArgs {
  const float* x;  // [rows, dim]
  float2* stats;   // [rows]: mean, rstd
  int rows, dim;
  float eps;
};

__global__ void __launch_bounds__(kStatsThreads) ln_qkv_stats_fp32_kernel(const StatsArgs p) {
  const int row = blockIdx.x * (kStatsThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int dim = p.dim;
  if (row >= p.rows) return;  // a whole warp
  const float* xr = p.x + (long long)row * dim;
  float sum = 0.f, sq = 0.f;
  for (int c = lane * 8; c < dim; c += 256) {
    const float4 lo = ld4(xr + c), hi = ld4(xr + c + 4);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sum = __fadd_rn(sum, v[j]);
      sq = __fadd_rn(sq, __fmul_rn(v[j], v[j]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  if (lane == 0) {
    const float mean = __fdiv_rn(sum, (float)dim);
    const float msq = __fdiv_rn(sq, (float)dim);
    const float var = fmaxf(__fsub_rn(msq, __fmul_rn(mean, mean)), 0.f);
    p.stats[row] = make_float2(mean, __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, p.eps))));
  }
}

// (c) attention on the workspace
template <int D, int kMode>  // softmax::kExact, or kPoly under DENSECLIP_FAST_EXP2
__global__ void __launch_bounds__(Cfg<D>::kThreads, Cfg<D>::kMinBlocks)
ln_qkv_attention_fp32_kernel(const Args a) {
  forward<TpuPolicy, D, kMode>(a);
}

bool bad_projection(int rows, int dim, int hd) {
  return rows < 1 || dim < 32 || dim % 32 || hd < 64 || hd % 64;
}

// (a): the statistics into `stats`.
cudaError_t run_stats(const float* x, float2* stats, int rows, int dim, float eps,
                      cudaStream_t stream) {
  const dim3 grid((rows + kStatsThreads / 32 - 1) / (kStatsThreads / 32));
  const StatsArgs sp{x, stats, rows, dim, eps};
  ln_qkv_stats_fp32_kernel<<<grid, kStatsThreads, 0, stream>>>(sp);
  return cudaGetLastError();
}

// (b): the projection on `stats` into `qkv`.
cudaError_t run_gemm(const float* x, const float* gamma, const float* beta, const float* wt,
                     const float* bias, const float2* stats, float* qkv, int rows, int dim,
                     int hd, float q_scale, cudaStream_t stream) {
  const GemmArgs g{x, wt, qkv, bias, stats, gamma, beta, rows, 3 * hd, dim, hd, q_scale};
  return launch_gemm<true, true>(g, stream);
}

// (a) + (b).
cudaError_t run_projection(const float* x, const float* gamma, const float* beta,
                           const float* wt, const float* bias, float2* stats, float* qkv,
                           int rows, int dim, int hd, float q_scale, float eps,
                           cudaStream_t stream) {
  if (bad_projection(rows, dim, hd)) return cudaErrorInvalidValue;
  const cudaError_t err = run_stats(x, stats, rows, dim, eps, stream);
  if (err != cudaSuccess) return err;
  return run_gemm(x, gamma, beta, wt, bias, stats, qkv, rows, dim, hd, q_scale, stream);
}

template <int D>
cudaError_t run_attention(const float* qkv, float* out, int batch, int n, int heads, int kv_len,
                          int mode, cudaStream_t stream) {
  const int hd = heads * D;
  const Strides st{(long long)n * 3 * hd, 3LL * hd, D};
  const Args a{qkv, qkv + hd, qkv + 2 * hd, out, nullptr, st, st, st,
               n, heads, kv_len, 0, 1.f, 0.f};
  void (*const kernels[2])(Args) = {ln_qkv_attention_fp32_kernel<D, softmax::kExact>,
                                    ln_qkv_attention_fp32_kernel<D, softmax::kPoly>};
  return launch_mode<D>(kernels, mode, a, batch, stream);
}

}  // namespace

// Plain C entry points for ctypes.  x, W^T and the workspace are contiguous
// fp32 device tensors, gamma, beta [D] and bias [3*H*d] contiguous fp32, all
// 16-byte aligned; q_scale is scale * log2 e.  Each returns the cudaError_t
// of its launches (0 = cudaSuccess), or cudaErrorInvalidValue before any
// launch for a shape or mode it does not take.

// The whole of K6 in fp32: `qkv` an fp32 [B, N, 3*H*d] workspace the call
// overwrites, `out` a contiguous fp32 [B, N, H*d] buffer (also the
// statistics' scratch).  Head dim 64 or 128, D a multiple of 32, 1 <=
// kv_len <= n; exp_mode 0 (exp2) or 1 (DENSECLIP_FAST_EXP2).
extern "C" int ln_qkv_attention_fp32(const void* x, const void* gamma, const void* beta,
                                     const void* wt, const void* bias, void* qkv, void* out,
                                     int batch, int n, int dim, int heads, int head_dim,
                                     int kv_len, float q_scale, float eps, int exp_mode,
                                     void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n ||
      (head_dim != 64 && head_dim != 128) ||
      (exp_mode != softmax::kExact && exp_mode != softmax::kPoly))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ws = static_cast<float*>(qkv);
  auto* o = static_cast<float*>(out);
  cudaError_t err = run_projection(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(wt),
      static_cast<const float*>(bias), reinterpret_cast<float2*>(o), ws, batch * n, dim,
      heads * head_dim, q_scale, eps, s);
  if (err != cudaSuccess) return (int)err;
  if (head_dim == 64) return (int)run_attention<64>(ws, o, batch, n, heads, kv_len, exp_mode, s);
  return (int)run_attention<128>(ws, o, batch, n, heads, kv_len, exp_mode, s);
}

// K6's first stage alone, for the workspace check: (a) into `stats` [rows]
// float2 (mean, rstd), then (b) into the workspace qkv [rows, 3*hd].
extern "C" int ln_qkv_projection_fp32(const void* x, const void* gamma, const void* beta,
                                      const void* wt, const void* bias, void* stats, void* qkv,
                                      int rows, int dim, int hd, float q_scale, float eps,
                                      void* stream) {
  return (int)run_projection(static_cast<const float*>(x), static_cast<const float*>(gamma),
                             static_cast<const float*>(beta), static_cast<const float*>(wt),
                             static_cast<const float*>(bias), static_cast<float2*>(stats),
                             static_cast<float*>(qkv), rows, dim, hd, q_scale, eps,
                             static_cast<cudaStream_t>(stream));
}

// K6's stages one at a time, for the split of its time (the bf16 kernel's
// `ln_qkv_stats_bf16` / `ln_qkv_projection_bf16` / `ln_qkv_attention_stage2_bf16`
// in fp32): (a) into `stats` [rows] float2; (b) on those statistics into the
// workspace qkv [rows, 3*hd]; (c) on that workspace into `out` [B, N, H*d].
extern "C" int ln_qkv_stats_fp32(const void* x, void* stats, int rows, int dim, float eps,
                                 void* stream) {
  if (bad_projection(rows, dim, 64)) return (int)cudaErrorInvalidValue;
  return (int)run_stats(static_cast<const float*>(x), static_cast<float2*>(stats), rows, dim,
                        eps, static_cast<cudaStream_t>(stream));
}

extern "C" int ln_qkv_gemm_fp32(const void* x, const void* gamma, const void* beta,
                                const void* wt, const void* bias, const void* stats, void* qkv,
                                int rows, int dim, int hd, float q_scale, void* stream) {
  if (bad_projection(rows, dim, hd)) return (int)cudaErrorInvalidValue;
  return (int)run_gemm(static_cast<const float*>(x), static_cast<const float*>(gamma),
                       static_cast<const float*>(beta), static_cast<const float*>(wt),
                       static_cast<const float*>(bias), static_cast<const float2*>(stats),
                       static_cast<float*>(qkv), rows, dim, hd, q_scale,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ln_qkv_attention_stage2_fp32(const void* qkv, void* out, int batch, int n,
                                            int heads, int head_dim, int kv_len, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n ||
      (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  const auto* ws = static_cast<const float*>(qkv);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)run_attention<64>(ws, o, batch, n, heads, kv_len, 0, s);
  return (int)run_attention<128>(ws, o, batch, n, heads, kv_len, 0, s);
}
