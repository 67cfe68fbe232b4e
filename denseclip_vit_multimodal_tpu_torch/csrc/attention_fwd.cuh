// The non-causal attention forward shared by three kernels: K1
// (qkv_attention.cu, q/k/v read off the fused projection), K3
// (mha_attention.cu, separate strided q/k/v) and the second stage of K6
// (ln_qkv_attention.cu, on the q/k/v workspace its first stage writes).
// Each source wraps `forward<D>` in a __global__ of its own name, so that a
// profile tells the three apart.  ops/_build.py hashes this header into the
// name of every library built from csrc/.
//
//   q, k, v [B, N, H, D] bf16 read by stride (unit stride over D), D in
//   {64, 128, 256};  out [B, N, H, D] bf16, contiguous.
//
// Numerics (the TPU kernels' rounding points):
//   * q * q_scale is computed in fp32 and rounded to bf16 before Q K^T;
//     q_scale is scale * log2 e (K1, K3) or 1 (K6, whose first stage has
//     already scaled q in fp32 and rounded it);
//   * scores are fp32 (bf16 x bf16 products, fp32 accumulation);
//   * the softmax uses exp2; P is rounded to bf16 for P V, which accumulates
//     in fp32; the row sum is taken over the fp32 P;
//   * one division by the row sum on the output.
// Keys >= kv_len are excluded exactly and never loaded: the TPU kernels'
// finfo.min column mask gives them weight 0 too, and a NaN in a pad row
// cannot reach a real row through 0 * NaN.
//
// Design.  A head's whole K/V does not fit the 227 KB of shared memory a
// block may use (384 KB at N = 1536, D = 64), so K/V stream through shared
// memory in tiles with an online softmax in fp32.  One block per (q-tile of
// 128 rows, head, batch); 8 warps, each owning 16 query rows.  Both
// products run on the tensor cores through mma.sync m16n8k16 (bf16 in, fp32
// out); the S fragment is re-packed in registers as the A operand of P V.
// V is stored transposed in shared memory, so every B fragment is one
// 32-bit shared load.  At D <= 128 a warp keeps its Q fragments in
// registers and K/V tiles hold 64 keys; at D = 256 the O accumulator alone
// takes 128 registers a thread, so Q fragments are re-read from shared
// memory and K/V tiles hold 32 keys.  Synchronous tile loads, no wgmma, no
// TMA, no warp specialisation.

#pragma once

#include "mma_bf16.cuh"

namespace dclip {
namespace attn {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block
constexpr int kPad = 8;               // bf16 row padding (16 bytes) against bank conflicts

template <int D>
__host__ __device__ constexpr int block_k() {  // keys per K/V tile
  return D > 128 ? 32 : 64;
}

struct Strides {  // in elements
  long long b, n, h;
};

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;  // contiguous [B, N, H, D]
  float2* stats;       // null, or [B, H, N]: each query row's max (log2 units) and sum
  Strides qs, ks, vs;
  int n, heads, kv_len;
  float q_scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * ((size_t)(kBlockQ + block_k<D>()) * (D + kPad) +
                                  (size_t)D * (block_k<D>() + kPad));
}

template <int D>
__device__ __forceinline__ void forward(const Args& a) {
  constexpr int kBlockK = block_k<D>();
  constexpr bool kQInRegs = D <= 128;
  constexpr int kLdQK = D + kPad;       // sQ / sK row stride
  constexpr int kLdV = kBlockK + kPad;  // sVt row stride (one row per head dim)
  constexpr int kVecPerRow = D / kVec;
  constexpr int kSteps = D / 16;        // k-steps of Q K^T
  constexpr int kOutTiles = D / 8;      // n-tiles of P V
  constexpr int kKeyTiles = kBlockK / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockQ * kLdQK;
  __nv_bfloat16* sVt = sK + kBlockK * kLdQK;

  const int n = a.n;
  const int kv_len = a.kv_len;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  const __nv_bfloat16* qb = a.q + b * a.qs.b + h * a.qs.h;
  const __nv_bfloat16* kb = a.k + b * a.ks.b + h * a.ks.h;
  const __nv_bfloat16* vb = a.v + b * a.vs.b + h * a.vs.h;
  const float neg_inf = __int_as_float(0xff800000);

  // Q tile, scaled by q_scale in fp32 and rounded to bf16.
  for (int i = tid; i < kBlockQ * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    const int row = q0 + r;
    Vec8 v;
    v.u = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) {
      v.u = *reinterpret_cast<const uint4*>(qb + row * a.qs.n + c);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        v.h[j] = __float2bfloat16_rn(__bfloat162float(v.h[j]) * a.q_scale);
    }
    *reinterpret_cast<uint4*>(sQ + r * kLdQK + c) = v.u;
  }
  __syncthreads();

  // This warp's 16 rows of Q as A fragments, kept in registers (D <= 128).
  const int wr = warp * 16;
  uint32_t qf[kQInRegs ? kSteps : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) load_a(qf[kk], sQ, kLdQK, wr, kk * 16, g, t);
  }

  float o[kOutTiles][4];
#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_run[2] = {neg_inf, neg_inf};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums

  for (int k0 = 0; k0 < kv_len; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < kBlockK * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const int key = k0 + r;
      Vec8 kv, vv;
      kv.u = make_uint4(0u, 0u, 0u, 0u);
      vv.u = make_uint4(0u, 0u, 0u, 0u);
      if (key < kv_len) {
        kv.u = *reinterpret_cast<const uint4*>(kb + key * a.ks.n + c);
        vv.u = *reinterpret_cast<const uint4*>(vb + key * a.vs.n + c);
      }
      *reinterpret_cast<uint4*>(sK + r * kLdQK + c) = kv.u;
#pragma unroll
      for (int j = 0; j < kVec; ++j) sVt[(c + j) * kLdV + r] = vv.h[j];
    }
    __syncthreads();

    // S = Q K^T: 16 rows x kBlockK keys per warp, fp32.
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t af[4];
      if constexpr (kQInRegs) {
        af[0] = qf[kk][0];
        af[1] = qf[kk][1];
        af[2] = qf[kk][2];
        af[3] = qf[kk][3];
      } else {
        load_a(af, sQ, kLdQK, wr, kk * 16, g, t);
      }
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        const __nv_bfloat16* kp = sK + (j * 8 + g) * kLdQK + kk * 16 + 2 * t;
        mma_bf16(s[j], af, ld_u32(kp), ld_u32(kp + 8));
      }
    }
    if (k0 + kBlockK > kv_len) {  // ragged last tile: mask keys >= kv_len
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        const int key = k0 + j * 8 + 2 * t;
        if (key >= kv_len) s[j][0] = s[j][2] = neg_inf;
        if (key + 1 >= kv_len) s[j][1] = s[j][3] = neg_inf;
      }
    }

    // Online softmax.  Every tile holds at least one valid key, so the new
    // running max is finite and exp2(-inf - m) = 0 needs no special case.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float alpha0 = exp2f(m_run[0] - mx[0]);
    const float alpha1 = exp2f(m_run[1] - mx[1]);
    m_run[0] = mx[0];
    m_run[1] = mx[1];
    l_run[0] *= alpha0;
    l_run[1] *= alpha1;
#pragma unroll
    for (int dt = 0; dt < kOutTiles; ++dt) {
      o[dt][0] *= alpha0;
      o[dt][1] *= alpha0;
      o[dt][2] *= alpha1;
      o[dt][3] *= alpha1;
    }

    // P = exp2(S - m) in fp32 (summed in fp32), rounded to bf16 as the A
    // operand of P V: key tiles 2kk and 2kk+1 form k-step kk.
    uint32_t pf[kBlockK / 16][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      const float p0 = exp2f(s[j][0] - mx[0]);
      const float p1 = exp2f(s[j][1] - mx[0]);
      const float p2 = exp2f(s[j][2] - mx[1]);
      const float p3 = exp2f(s[j][3] - mx[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      const int kk = j >> 1;
      const int half = (j & 1) * 2;
      pf[kk][half + 0] = pack_bf16(p0, p1);
      pf[kk][half + 1] = pack_bf16(p2, p3);
    }

    // O += P V (fp32 accumulation).
#pragma unroll
    for (int dt = 0; dt < kOutTiles; ++dt) {
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const __nv_bfloat16* vp = sVt + (dt * 8 + g) * kLdV + kk * 16 + 2 * t;
        mma_bf16(o[dt], pf[kk], ld_u32(vp), ld_u32(vp + 8));
      }
    }
  }

  // Row sums across the four threads of each row group, then one division.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int row0 = q0 + wr + g;
  const int row1 = row0 + 8;
  if (a.stats != nullptr && t == 0) {  // (max, sum) of every row, for the backward
    float2* st = a.stats + ((long long)b * a.heads + h) * n;
    if (row0 < n) st[row0] = make_float2(m_run[0], l_run[0]);
    if (row1 < n) st[row1] = make_float2(m_run[1], l_run[1]);
  }
  const long long out_stride = (long long)a.heads * D;
  __nv_bfloat16* out_b = a.out + (long long)b * n * out_stride + h * D;
#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < n)
      *reinterpret_cast<uint32_t*>(out_b + row0 * out_stride + col) =
          pack_bf16(o[dt][0] / l_run[0], o[dt][1] / l_run[0]);
    if (row1 < n)
      *reinterpret_cast<uint32_t*>(out_b + row1 * out_stride + col) =
          pack_bf16(o[dt][2] / l_run[1], o[dt][3] / l_run[1]);
  }
}

// Launch `kernel` (a __global__ wrapping forward<D>) over (q-tiles, heads, batch).
template <int D>
cudaError_t launch(void (*kernel)(Args), const Args& a, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kBlockQ - 1) / kBlockQ, a.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace dclip
