// Fused LayerNorm + QKV projection + attention (K6).
//
// Replaces the TPU kernel `_lnqkv_kernel` of the JAX package
// (denseclip_vit_multimodal_tpu/ops/lnqkv_kernel.py, reached through
// `_lnqkv_fwd_impl` / `ln_qkv_attention`; opt-in DENSECLIP_FUSED_LNQKV=1 on
// the inference path of every pre-LN ViT block):
//
//   x [B, N, D] bf16, gamma / beta [D] fp32, W^T [3*H*d, D] bf16 (the torch
//   Linear layout: row j holds output column j), bias [3*H*d] fp32
//   -> out [B, N, H*d] bf16,   d in {64, 128}, D a multiple of 128
//
// Numerics follow the TPU kernel's rounding points:
//   * LayerNorm statistics in fp32, one pass: var = max(E[x^2] - mean^2, 0);
//     y = (x - mean) * rsqrt(var + eps), then (y * gamma + beta) rounded to
//     bf16 (no FMA contraction: each step rounds as the TPU kernel's does);
//   * the projection multiplies bf16 by bf16 with fp32 accumulation and adds
//     the fp32 bias; q is then multiplied by scale * log2 e in fp32 and
//     rounded to bf16; k and v are rounded after their bias;
//   * attention as K1's (attention_fwd.cuh) on the pre-scaled q: fp32
//     scores, exp2 softmax, P rounded to bf16, fp32 P V, one division.  Keys
//     >= valid_len are excluded (the TPU kernel's finfo.min mask).  Pad rows
//     of the residual stream are not zero (LN(0) = beta), which is why no
//     zero-pad correction is used anywhere.
//
// Design.  The TPU kernel keeps LN(x) [n_pad, D] and one 128-lane block of
// K/V for all N resident in VMEM across q-tiles.  On Hopper K+V of one head
// at N = 1536 is 384 KB, more than an SM's 227 KB of shared memory, and
// recomputing the K/V projection per q-tile would multiply the projection's
// work by N / q-tile.  So this first version runs two launches, counted as
// one K6 launch:
//   (a) ln_qkv_proj_kernel: per 128-row x 128-column output tile, the fp32
//       row statistics of its 128 rows of x, then the [D] contraction in
//       64-deep k-tiles, double-buffered: each x k-tile is normalised as it
//       is staged into shared memory (registers prefetch the next one while
//       the tensor cores work on this one), W^T k-tiles arrive by cp.async,
//       fragments by ldmatrix, mma.sync m16n8k16 with fp32 accumulators, and
//       an epilogue that adds the bias, scales q and writes the q/k/v
//       workspace [B, N, 3*H*d] bf16;
//   (b) ln_qkv_attention_kernel: K1's body on that workspace, q_scale 1.
// LN(x) never reaches device memory; q/k/v does (71 MB at the slide shape,
// written once and read by (b)).  Keeping K/V on chip (thread-block clusters
// sharing K/V through distributed shared memory, or a persistent kernel) is
// later work.
//
// Bound on an H100 SXM at the slide shape (x [10, 1536, 768], 12 heads of
// 64, valid_len 1522): projection 2*B*N*D*3*H*d = 54.4 GFLOP plus attention
// 4*B*H*N*valid_len*d = 71.8 GFLOP of bf16 tensor-core work, 0.128 ms at
// 989 TFLOP/s, against ~51 MB of x, W and out (0.015 ms at 3.35 TB/s):
// compute-bound.

#include "attention_fwd.cuh"

namespace {

using namespace dclip;

constexpr int kProjThreads = 256;  // 8 warps: 4 along the rows x 2 along the columns
constexpr int kBM = 128;           // rows of x per block
constexpr int kBN = 128;           // output columns per block
constexpr int kBK = 64;            // depth of one staged k-tile
constexpr int kLdT = kBK + 8;      // shared row stride (bf16): 144 bytes, conflict-free ldmatrix
constexpr int kChunks = kBK / kVec;                     // 16-byte chunks per tile row
constexpr int kTileVecs = kBM * kChunks / kProjThreads;  // chunks per thread per tile
constexpr int kRowStep = kProjThreads / kChunks;         // rows between a thread's chunks
constexpr size_t kProjSmem =
    sizeof(__nv_bfloat16) * 2 * (kBM + kBN) * kLdT + 2 * kBM * sizeof(float);
static_assert(kBN == kBM, "x and W^T tiles share one load pattern");

__global__ void __launch_bounds__(kProjThreads, 2)
ln_qkv_proj_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const __nv_bfloat16* __restrict__ wt,
                   const float* __restrict__ bias, __nv_bfloat16* __restrict__ qkv, int rows,
                   int dim, int hd, float eps, float q_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kBM][kLdT]
  __nv_bfloat16* sW = sA + 2 * kBM * kLdT;                          // [2][kBN][kLdT]
  float* s_mean = reinterpret_cast<float*>(sW + 2 * kBN * kLdT);
  float* s_rstd = s_mean + kBM;

  const int n0 = blockIdx.x * kBN;  // first output column
  const int m0 = blockIdx.y * kBM;  // first row of x
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 1;  // rows wm*32 .. +32 of the tile
  const int wn = warp & 1;   // columns wn*64 .. +64
  const long long out_ld = 3LL * hd;

  // 1. fp32 statistics of this block's rows: warp w takes rows 16w .. 16w+15.
  for (int rr = 0; rr < kBM / 8; ++rr) {
    const int r = warp * (kBM / 8) + rr;
    const int row = m0 + r;
    float sum = 0.f, sq = 0.f;
    if (row < rows) {
      const __nv_bfloat16* xr = x + (long long)row * dim;
      for (int c = lane * kVec; c < dim; c += 32 * kVec) {
        Vec8 v;
        v.u = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float f = __bfloat162float(v.h[j]);
          sum += f;
          sq = fmaf(f, f, sq);
        }
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
      s_mean[r] = mean;
      s_rstd[r] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    }
  }
  __syncthreads();

  // 2. The contraction over D, k-tile by k-tile.  A thread owns the same 8
  // columns of every tile row it loads: rows tid / kChunks + j * kRowStep.
  const int c = (tid % kChunks) * kVec;
  const int r0 = tid / kChunks;
  uint4 ra[kTileVecs];  // the next k-tile of x, normalised when it is staged
  auto fetch_x = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kTileVecs; ++j) {
      const int row = m0 + r0 + j * kRowStep;
      ra[j] = row < rows ? *reinterpret_cast<const uint4*>(x + (long long)row * dim + k0 + c)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto fetch_w = [&](int buf, int k0) {  // W^T straight into shared memory
#pragma unroll
    for (int j = 0; j < kTileVecs; ++j) {
      const int r = r0 + j * kRowStep;
      cp_async16(sW + (buf * kBN + r) * kLdT + c, wt + (long long)(n0 + r) * dim + k0 + c, 16);
    }
  };
  auto stage_x = [&](int buf, int k0) {  // LN(x) rounded to bf16, into sA
    const float4 g0 = *reinterpret_cast<const float4*>(gamma + k0 + c);
    const float4 g1 = *reinterpret_cast<const float4*>(gamma + k0 + c + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(beta + k0 + c);
    const float4 b1 = *reinterpret_cast<const float4*>(beta + k0 + c + 4);
    const float gv[kVec] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bv[kVec] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int j = 0; j < kTileVecs; ++j) {
      const int r = r0 + j * kRowStep;
      const float mean = s_mean[r];
      const float rstd = s_rstd[r];
      Vec8 v;
      v.u = ra[j];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float y = __fmul_rn(__fsub_rn(__bfloat162float(v.h[e]), mean), rstd);
        v.h[e] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(y, gv[e]), bv[e]));
      }
      *reinterpret_cast<uint4*>(sA + (buf * kBM + r) * kLdT + c) = v.u;
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int k_tiles = dim / kBK;
  fetch_x(0);
  fetch_w(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    stage_x(buf, kt * kBK);
    cp_async_wait<0>();  // this thread's part of W^T tile kt has landed
    // Two buffers: after this barrier every warp is done with tile kt-1, so
    // its buffers may be refilled with tile kt+1 while tile kt is multiplied.
    __syncthreads();
    if (kt + 1 < k_tiles) {
      fetch_x((kt + 1) * kBK);
      fetch_w(buf ^ 1, (kt + 1) * kBK);
    }
    cp_async_commit();
    const __nv_bfloat16* tA = sA + buf * kBM * kLdT;
    const __nv_bfloat16* tW = sW + buf * kBN * kLdT;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], tA + (wm * 32 + mt * 16 + (lane & 15)) * kLdT + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // two 8-wide n-tiles per ldmatrix
        uint32_t bf[4];
        ldmatrix_x4(bf, tW + (wn * 64 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdT +
                            kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }

  // 3. Epilogue: + fp32 bias; q additionally * scale * log2 e in fp32; round.
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n0 + wn * 64 + nt * 8 + 2 * t;  // a pair never straddles q/k/v (hd % 128 == 0)
    const float b0 = __ldg(bias + col);
    const float b1 = __ldg(bias + col + 1);
    const bool is_q = col < hd;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + mt * 16 + g + half * 8;
        if (row >= rows) continue;
        float v0 = __fadd_rn(acc[mt][nt][2 * half], b0);
        float v1 = __fadd_rn(acc[mt][nt][2 * half + 1], b1);
        if (is_q) {
          v0 = __fmul_rn(v0, q_scale);
          v1 = __fmul_rn(v1, q_scale);
        }
        *reinterpret_cast<uint32_t*>(qkv + row * out_ld + col) = pack_bf16(v0, v1);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(attn::kThreads) ln_qkv_attention_kernel(attn::Args a) {
  attn::forward<D>(a);
}

template <int D>
cudaError_t run(const __nv_bfloat16* x, const float* gamma, const float* beta,
                const __nv_bfloat16* wt, const float* bias, __nv_bfloat16* qkv,
                __nv_bfloat16* out, int batch, int n, int dim, int heads, int kv_len,
                float q_scale, float eps, cudaStream_t stream) {
  const int hd = heads * D;
  const int rows = batch * n;
  cudaError_t err = cudaFuncSetAttribute(
      ln_qkv_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kProjSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(3 * hd / kBN, (rows + kBM - 1) / kBM);
  ln_qkv_proj_kernel<<<grid, kProjThreads, kProjSmem, stream>>>(x, gamma, beta, wt, bias, qkv,
                                                                rows, dim, hd, eps, q_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const attn::Strides st{(long long)n * 3 * hd, 3LL * hd, D};
  const attn::Args a{qkv, qkv + hd, qkv + 2 * hd, out, nullptr, st, st, st, n, heads, kv_len, 1.f};
  return attn::launch<D>(ln_qkv_attention_kernel<D>, a, batch, stream);
}

}  // namespace

// Plain C entry point for ctypes.  x, W^T and the workspace are contiguous
// bf16 device tensors (16-byte aligned); gamma, beta [D] and bias [3*H*d]
// contiguous fp32; `qkv` a [B, N, 3*H*d] bf16 workspace the call
// overwrites; `out` a contiguous [B, N, H*d] bf16 buffer.  q_scale is
// scale * log2 e.  Needs D % 128 == 0 and H*d % 128 == 0.  Returns the
// cudaError_t of the launches (0 = cudaSuccess).
extern "C" int ln_qkv_attention_bf16(const void* x, const void* gamma, const void* beta,
                                     const void* wt, const void* bias, void* qkv, void* out,
                                     int batch, int n, int dim, int heads, int head_dim,
                                     int kv_len, float q_scale, float eps, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n || dim % 128 ||
      (heads * head_dim) % kBN)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* g = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  const auto* w = static_cast<const __nv_bfloat16*>(wt);
  const auto* bi = static_cast<const float*>(bias);
  auto* ws = static_cast<__nv_bfloat16*>(qkv);
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return (int)run<64>(xb, g, be, w, bi, ws, o, batch, n, dim, heads, kv_len, q_scale, eps, s);
  if (head_dim == 128)
    return (int)run<128>(xb, g, be, w, bi, ws, o, batch, n, dim, heads, kv_len, q_scale, eps, s);
  return (int)cudaErrorInvalidValue;
}
