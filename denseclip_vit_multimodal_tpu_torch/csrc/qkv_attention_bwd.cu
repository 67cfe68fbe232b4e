// Backward of the fused-QKV attention (K2): dqkv from qkv, the forward
// output O, dO and the forward's row statistics.
//
// Replaces the TPU kernel `_bwd_kernel` of the JAX package
// (denseclip_vit_multimodal_tpu/ops/mha_kernel.py, reached through
// `_qkv_bwd` -> `_mha_bwd_pallas`).  Same function, Hopper tiling:
//
//   qkv [B, N, 3*H*D], O and dO [B, N, H*D], all bf16, D in {64, 128}
//   stats [B, H, N] float2 (softmax max m in log2 units, row sum l) from
//   the forward kernel (qkv_attention.cu)  ->  dqkv [B, N, 3*H*D] bf16.
//   q, k, v, dq, dk, dv of head h are read and written in place by stride in
//   the fused layout (no head split, no concatenation on the host).
//
// Numerics follow the TPU kernel's rounding points, per (batch, head):
//   qs = bf16(q * (scale * log2 e))   (the constant stays fp32)
//   s  = qs k^T (fp32),  p = exp2(s - m) unnormalised,  r = 1 / l
//   dp = dO v^T (fp32)
//   ds = bf16(p * (dp - Dc) * (scale * r))
//   dq = ds k,  dk = ds^T q (unscaled q),  dv = bf16(p)^T bf16(dO * r)
//   fp32 accumulation throughout, one rounding to bf16 at the end.
// The one change: the TPU kernel takes Dc = rowsum(p * dp) * r over the full
// score row it holds; a streamed kernel never holds the row, so Dc is taken
// as rowsum(dO * O), the same number (sum_j p_j dp_j / l = dO . O) up to the
// bf16 rounding of O.  m and l come from the forward instead of a second
// pass over the keys.
// Keys >= valid_len are never loaded and their p is 0, so their dk and dv are
// exactly 0; query rows >= valid_len (pad rows) get dq against the valid
// keys, as their forward output was.
//
// Design.  The TPU kernel holds a head's whole K/V and accumulates dk/dv in
// VMEM across q-tiles, an order the TPU's sequential grid guarantees.  Hopper
// blocks run in no order, so the work is split FlashAttention-2 style into
// two kernels on one stream, neither with atomics (deterministic sums):
//   1. dq: one block per (64 query rows, head, batch); first Dc for its rows
//      (written to `dcoef` for kernel 2), then a loop over 64-key tiles
//      recomputing s, p, dp, ds and accumulating dq in registers;
//   2. dk/dv: one block per (64 keys, head, batch), a loop over 64-row query
//      tiles recomputing s^T, p^T, dp^T, ds^T and accumulating dk, dv.
// 4 warps of 16 rows each; every product is mma.sync m16n8k16 (bf16 in, fp32
// out); operands that need the other orientation (K for dq; q and dO * r for
// dk/dv) are stored transposed in shared memory by scalar stores.
//
// Bound on an H100 SXM at the heritage training shape [4, 1664, 2304],
// valid_len 1601, H 12, D 64: five N x valid_len x D products per (b, h)
// (s, dp, dv, dq, dk) = 10 * B * H * N * valid_len * D = 81.8 GFLOP of bf16
// tensor-core work (83 us at 989 TFLOP/s) against ~72 MB of traffic (21 us at
// 3.35 TB/s): operation-bound.  This version recomputes s and dp in both
// kernels (7 products instead of 5) and loads tiles synchronously: simple and
// right first.

#include "mma_bf16.cuh"

namespace {

using namespace dclip;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16 * kWarps;  // rows a block owns: query rows (dq) or keys (dk/dv)
constexpr int kStep = 64;           // rows of the streamed side: keys (dq) or query rows (dk/dv)
constexpr int kPad = 8;             // bf16 row padding (16 bytes) against bank conflicts

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ Vec8 load_vec(const bf16* p) {
  Vec8 v;
  v.u = *reinterpret_cast<const uint4*>(p);
  return v;
}

__device__ __forceinline__ Vec8 zero_vec() {
  Vec8 v;
  v.u = make_uint4(0u, 0u, 0u, 0u);
  return v;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
qkv_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ out,
                  const bf16* __restrict__ dout, const float2* __restrict__ stats,
                  float* __restrict__ dcoef, bf16* __restrict__ dqkv, int n,
                  int heads, int kv_len, float q_scale, float scale) {
  constexpr int kLd = D + kPad;       // [row][d] tiles
  constexpr int kLdT = kStep + kPad;  // sKt: [d][key]
  constexpr int kVecPerRow = D / kVec;
  constexpr int kSteps = D / 16;
  constexpr int kOutTiles = D / 8;
  static_assert(kStep == kTile, "sK holds the O tile in the prologue");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // scaled q
  bf16* sDO = sQ + kTile * kLd;
  bf16* sK = sDO + kTile * kLd;  // O in the prologue, then K tiles
  bf16* sV = sK + kStep * kLd;
  bf16* sKt = sV + kStep * kLd;
  float* sDc = reinterpret_cast<float*>(sKt + D * kLdT);

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int hd = heads * D;
  const long long row_stride = 3LL * hd;
  const bf16* base = qkv + (long long)b * n * row_stride;
  const bf16* out_b = out + (long long)b * n * hd + h * D;
  const bf16* dout_b = dout + (long long)b * n * hd + h * D;
  const long long bh = (long long)b * heads + h;
  const int q_col = h * D;
  const int k_col = hd + h * D;
  const int v_col = 2 * hd + h * D;

  for (int i = tid; i < kTile * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    const int row = q0 + r;
    Vec8 q = zero_vec(), d = zero_vec(), o = zero_vec();
    if (row < n) {
      q = load_vec(base + row * row_stride + q_col + c);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        q.h[j] = __float2bfloat16_rn(__bfloat162float(q.h[j]) * q_scale);
      d = load_vec(dout_b + (long long)row * hd + c);
      o = load_vec(out_b + (long long)row * hd + c);
    }
    *reinterpret_cast<uint4*>(sQ + r * kLd + c) = q.u;
    *reinterpret_cast<uint4*>(sDO + r * kLd + c) = d.u;
    *reinterpret_cast<uint4*>(sK + r * kLd + c) = o.u;
  }
  __syncthreads();

  // Dc = rowsum(dO * O) in fp32, one warp per row in turn.
  for (int r = warp; r < kTile; r += kWarps) {
    float acc = 0.f;
    for (int c = lane; c < D; c += 32)
      acc += __bfloat162float(sDO[r * kLd + c]) * __bfloat162float(sK[r * kLd + c]);
    acc = warp_sum(acc);
    if (lane == 0) {
      sDc[r] = acc;
      if (q0 + r < n) dcoef[bh * n + q0 + r] = acc;
    }
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[kSteps][4], dof[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    load_a(qf[kk], sQ, kLd, wr, kk * 16, g, t);
    load_a(dof[kk], sDO, kLd, wr, kk * 16, g, t);
  }
  // Per-row statistics of rows g and g + 8; rows past n get p = 0.
  float m[2], sr[2], dc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    m[i] = __int_as_float(0x7f800000);
    sr[i] = 0.f;
    if (row < n) {
      const float2 st = stats[bh * n + row];
      m[i] = st.x;
      sr[i] = scale * (1.f / st.y);
    }
    dc[i] = sDc[wr + g + 8 * i];
  }

  float dq[kOutTiles][4];
#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += kStep) {
    __syncthreads();  // every warp is done with the previous tile (and with O)
    for (int i = tid; i < kStep * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const int key = k0 + r;
      Vec8 kv = zero_vec(), vv = zero_vec();
      if (key < kv_len) {
        kv = load_vec(base + key * row_stride + k_col + c);
        vv = load_vec(base + key * row_stride + v_col + c);
      }
      *reinterpret_cast<uint4*>(sK + r * kLd + c) = kv.u;
      *reinterpret_cast<uint4*>(sV + r * kLd + c) = vv.u;
#pragma unroll
      for (int j = 0; j < kVec; ++j) sKt[(c + j) * kLdT + r] = kv.h[j];
    }
    __syncthreads();

#pragma unroll
    for (int cc = 0; cc < kStep / 16; ++cc) {  // 16 keys at a time
      uint32_t dsf[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int n0 = cc * 16 + jj * 8;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          uint32_t b0, b1;
          load_b(b0, b1, sK, kLd, n0, kk * 16, g, t);
          mma_bf16(s, qf[kk], b0, b1);
          load_b(b0, b1, sV, kLd, n0, kk * 16, g, t);
          mma_bf16(dp, dof[kk], b0, b1);
        }
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = k0 + n0 + 2 * t + (e & 1);
          const float p = key < kv_len ? exp2f(s[e] - m[i]) : 0.f;
          ds[e] = p * (dp[e] - dc[i]) * sr[i];
        }
        dsf[jj * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsf[jj * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int dt = 0; dt < kOutTiles; ++dt) {
        uint32_t b0, b1;
        load_b(b0, b1, sKt, kLdT, dt * 8, cc * 16, g, t);
        mma_bf16(dq[dt], dsf, b0, b1);
      }
    }
  }

  bf16* dst = dqkv + (long long)b * n * row_stride + q_col;
  const int row0 = q0 + wr + g;
  const int row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < n)
      *reinterpret_cast<uint32_t*>(dst + row0 * row_stride + col) = pack_bf16(dq[dt][0], dq[dt][1]);
    if (row1 < n)
      *reinterpret_cast<uint32_t*>(dst + row1 * row_stride + col) = pack_bf16(dq[dt][2], dq[dt][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
qkv_bwd_dkdv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                    const float2* __restrict__ stats, const float* __restrict__ dcoef,
                    bf16* __restrict__ dqkv, int n, int heads, int kv_len,
                    float q_scale, float scale) {
  constexpr int kLd = D + kPad;       // [row][d] tiles
  constexpr int kLdT = kStep + kPad;  // [d][query] tiles
  constexpr int kVecPerRow = D / kVec;
  constexpr int kSteps = D / 16;
  constexpr int kOutTiles = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTile * kLd;
  bf16* sQs = sV + kTile * kLd;    // scaled q, [query][d]
  bf16* sDO = sQs + kStep * kLd;   // dO, [query][d]
  bf16* sQt = sDO + kStep * kLd;   // unscaled q, [d][query]
  bf16* sDOrt = sQt + D * kLdT;    // bf16(dO * r), [d][query]
  float* sM = reinterpret_cast<float*>(sDOrt + D * kLdT);
  float* sR = sM + kStep;
  float* sSR = sR + kStep;
  float* sDc = sSR + kStep;

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int hd = heads * D;
  const long long row_stride = 3LL * hd;
  const bf16* base = qkv + (long long)b * n * row_stride;
  const bf16* dout_b = dout + (long long)b * n * hd + h * D;
  const long long bh = (long long)b * heads + h;
  const int q_col = h * D;
  const int k_col = hd + h * D;
  const int v_col = 2 * hd + h * D;
  bf16* dst = dqkv + (long long)b * n * row_stride;

  if (k0 >= kv_len) {  // a tile of masked keys: dk = dv = 0 exactly
    for (int i = tid; i < kTile * kVecPerRow; i += kThreads) {
      const int key = k0 + i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      if (key < n) {
        *reinterpret_cast<uint4*>(dst + key * row_stride + k_col + c) = zero_vec().u;
        *reinterpret_cast<uint4*>(dst + key * row_stride + v_col + c) = zero_vec().u;
      }
    }
    return;
  }

  for (int i = tid; i < kTile * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    const int key = k0 + r;
    Vec8 kv = zero_vec(), vv = zero_vec();
    if (key < kv_len) {
      kv = load_vec(base + key * row_stride + k_col + c);
      vv = load_vec(base + key * row_stride + v_col + c);
    }
    *reinterpret_cast<uint4*>(sK + r * kLd + c) = kv.u;
    *reinterpret_cast<uint4*>(sV + r * kLd + c) = vv.u;
  }

  const int wr = warp * 16;
  const bool valid[2] = {k0 + wr + g < kv_len, k0 + wr + g + 8 < kv_len};
  float dk[kOutTiles][4], dv[kOutTiles][4];
#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kStep) {
    __syncthreads();  // every warp is done with the previous query tile
    if (tid < kStep) {  // per-row statistics; rows past n get p = 0
      const int row = q0 + tid;
      float mm = __int_as_float(0x7f800000), r = 0.f, dc = 0.f;
      if (row < n) {
        const float2 st = stats[bh * n + row];
        mm = st.x;
        r = 1.f / st.y;
        dc = dcoef[bh * n + row];
      }
      sM[tid] = mm;
      sR[tid] = r;
      sSR[tid] = scale * r;
      sDc[tid] = dc;
    }
    __syncthreads();
    for (int i = tid; i < kStep * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const int row = q0 + r;
      Vec8 q = zero_vec(), d = zero_vec(), qs, dr;
      if (row < n) {
        q = load_vec(base + row * row_stride + q_col + c);
        d = load_vec(dout_b + (long long)row * hd + c);
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        qs.h[j] = __float2bfloat16_rn(__bfloat162float(q.h[j]) * q_scale);
        dr.h[j] = __float2bfloat16_rn(__bfloat162float(d.h[j]) * sR[r]);
        sQt[(c + j) * kLdT + r] = q.h[j];
        sDOrt[(c + j) * kLdT + r] = dr.h[j];
      }
      *reinterpret_cast<uint4*>(sQs + r * kLd + c) = qs.u;
      *reinterpret_cast<uint4*>(sDO + r * kLd + c) = d.u;
    }
    __syncthreads();

#pragma unroll
    for (int cc = 0; cc < kStep / 16; ++cc) {  // 16 query rows at a time
      uint32_t dsf[4], pf[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int n0 = cc * 16 + jj * 8;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {  // s^T = K qs^T, dp^T = V dO^T
          uint32_t a[4], b0, b1;
          load_a(a, sK, kLd, wr, kk * 16, g, t);
          load_b(b0, b1, sQs, kLd, n0, kk * 16, g, t);
          mma_bf16(s, a, b0, b1);
          load_a(a, sV, kLd, wr, kk * 16, g, t);
          load_b(b0, b1, sDO, kLd, n0, kk * 16, g, t);
          mma_bf16(dp, a, b0, b1);
        }
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = n0 + 2 * t + (e & 1);
          p[e] = valid[e >> 1] ? exp2f(s[e] - sM[q]) : 0.f;
          ds[e] = p[e] * (dp[e] - sDc[q]) * sSR[q];
        }
        pf[jj * 2 + 0] = pack_bf16(p[0], p[1]);
        pf[jj * 2 + 1] = pack_bf16(p[2], p[3]);
        dsf[jj * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsf[jj * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int dt = 0; dt < kOutTiles; ++dt) {  // dk += ds^T q, dv += p^T (dO r)
        uint32_t b0, b1;
        load_b(b0, b1, sQt, kLdT, dt * 8, cc * 16, g, t);
        mma_bf16(dk[dt], dsf, b0, b1);
        load_b(b0, b1, sDOrt, kLdT, dt * 8, cc * 16, g, t);
        mma_bf16(dv[dt], pf, b0, b1);
      }
    }
  }

  const int key0 = k0 + wr + g;
  const int key1 = key0 + 8;
#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (key0 < n) {
      *reinterpret_cast<uint32_t*>(dst + key0 * row_stride + k_col + col) = pack_bf16(dk[dt][0], dk[dt][1]);
      *reinterpret_cast<uint32_t*>(dst + key0 * row_stride + v_col + col) = pack_bf16(dv[dt][0], dv[dt][1]);
    }
    if (key1 < n) {
      *reinterpret_cast<uint32_t*>(dst + key1 * row_stride + k_col + col) = pack_bf16(dk[dt][2], dk[dt][3]);
      *reinterpret_cast<uint32_t*>(dst + key1 * row_stride + v_col + col) = pack_bf16(dv[dt][2], dv[dt][3]);
    }
  }
}

template <int D>
cudaError_t launch(const void* qkv, const void* out, const void* dout, const void* stats,
                   void* dcoef, void* dqkv, int batch, int n, int heads, int kv_len,
                   float q_scale, float scale, cudaStream_t stream) {
  constexpr int kLd = D + kPad;
  constexpr int kLdT = kStep + kPad;
  const size_t smem_dq = sizeof(bf16) * ((size_t)(2 * kTile + 2 * kStep) * kLd + (size_t)D * kLdT) +
                         sizeof(float) * kTile;
  const size_t smem_dkdv = sizeof(bf16) * ((size_t)(2 * kTile + 2 * kStep) * kLd + 2 * (size_t)D * kLdT) +
                           4 * sizeof(float) * kStep;
  cudaError_t err = cudaFuncSetAttribute(
      qkv_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      qkv_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  qkv_bwd_dq_kernel<D><<<grid, kThreads, smem_dq, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float2*>(stats), static_cast<float*>(dcoef), static_cast<bf16*>(dqkv),
      n, heads, kv_len, q_scale, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qkv_bwd_dkdv_kernel<D><<<grid, kThreads, smem_dkdv, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<const float2*>(stats), static_cast<const float*>(dcoef),
      static_cast<bf16*>(dqkv), n, heads, kv_len, q_scale, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  qkv / dqkv [B, N, 3*H*D] and out / dout
// [B, N, H*D] are contiguous bf16 device tensors (16-byte aligned); stats is
// the fp32 [B, H, N, 2] buffer the forward filled; dcoef is fp32 [B, H, N]
// scratch.  `q_scale` = scale * log2 e, `scale` the softmax scale.  Launches
// the dq kernel, then the dk/dv kernel, on `stream` (a cudaStream_t).
// Returns the cudaError_t of the launches (0 = cudaSuccess).
extern "C" int qkv_attention_bwd_bf16(const void* qkv, const void* out, const void* dout,
                                      const void* stats, void* dcoef, void* dqkv, int batch,
                                      int n, int heads, int head_dim, int kv_len,
                                      float q_scale, float scale, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return (int)launch<64>(qkv, out, dout, stats, dcoef, dqkv, batch, n, heads, kv_len,
                           q_scale, scale, s);
  if (head_dim == 128)
    return (int)launch<128>(qkv, out, dout, stats, dcoef, dqkv, batch, n, heads, kv_len,
                            q_scale, scale, s);
  return (int)cudaErrorInvalidValue;
}
