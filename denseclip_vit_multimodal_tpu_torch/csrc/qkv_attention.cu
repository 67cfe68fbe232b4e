// Non-causal softmax attention read straight off the fused QKV projection.
//
// Replaces the TPU kernel `_qkv_kernel` of the JAX package
// (denseclip_vit_multimodal_tpu/ops/mha_kernel.py, reached through
// `_qkv_fwd_impl` / `mha_qkv_attention`).  Same function, Hopper tiling:
//
//   qkv [B, N, 3*H*D] bf16  ->  out [B, N, H*D] bf16,   D in {64, 128}
//   q, k, v of head h are read in place by stride: columns h*D, H*D + h*D
//   and 2*H*D + h*D of every token row (no head split, no transpose).
//
// Numerics follow the TPU kernel's rounding points:
//   * q * (scale * log2 e) is computed in fp32 and rounded to bf16 before
//     Q K^T (the constant itself stays fp32);
//   * scores are fp32 (bf16 x bf16 products, fp32 accumulation);
//   * the softmax uses exp2; P is rounded to bf16 for P V, which accumulates
//     in fp32; the row sum is taken over the fp32 P;
//   * one division by the row sum on the output.
// Keys >= valid_len are masked exactly (and never loaded), so the TPU
// kernel's zero-pad mass subtraction (mha_kernel.py:416-436) is not needed:
// any N is accepted and the ragged edge of the last K/V tile is masked here.
//
// Design.  The TPU kernel keeps a head's whole K/V in VMEM and runs a
// one-shot softmax.  On Hopper K+V of one head at N = 1536 is 384 KB of bf16,
// more than the 227 KB of shared memory a block may use, so this kernel
// streams K/V through shared memory in tiles of 64 keys with an online
// softmax in fp32 (flash-attention style).  One block per (q-tile of 128
// rows, head, batch); 8 warps, each owning 16 query rows.  Both products run
// on the tensor cores through mma.sync m16n8k16 (bf16 in, fp32 out); the S
// accumulator fragment is re-packed in registers as the A operand of P V.
// V is stored transposed in shared memory so that every B fragment is one
// 32-bit shared load.
//
// Bound on an H100 SXM at the slide shape [10, 1536, 2304], valid_len 1522,
// H 12, D 64: 4*B*H*valid_len^2*D = 71 GFLOP of bf16 tensor-core work
// (72 us at 989 TFLOP/s) against 94 MB of qkv/out traffic (28 us at
// 3.35 TB/s): compute- (and exp2-) bound.  This first version is simple:
// synchronous tile loads, no wgmma, no TMA, no warp specialisation.

#include "mma_bf16.cuh"

namespace {

using namespace dclip;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block
constexpr int kBlockK = 64;           // keys per K/V tile
constexpr int kPad = 8;               // bf16 row padding (16 bytes) against bank conflicts

template <int D>
__global__ void __launch_bounds__(kThreads)
qkv_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                     __nv_bfloat16* __restrict__ out,
                     float2* __restrict__ stats, int n, int heads,
                     int kv_len, float q_scale) {
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

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  const long long row_stride = 3LL * heads * D;
  const __nv_bfloat16* base = qkv + (long long)b * n * row_stride;
  const int q_col = h * D;
  const int k_col = heads * D + h * D;
  const int v_col = 2 * heads * D + h * D;
  const float neg_inf = __int_as_float(0xff800000);

  // Q tile, pre-scaled by scale*log2(e) in fp32 and rounded to bf16.
  for (int i = tid; i < kBlockQ * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    const int row = q0 + r;
    Vec8 v;
    v.u = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) {
      v.u = *reinterpret_cast<const uint4*>(base + row * row_stride + q_col + c);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        v.h[j] = __float2bfloat16_rn(__bfloat162float(v.h[j]) * q_scale);
    }
    *reinterpret_cast<uint4*>(sQ + r * kLdQK + c) = v.u;
  }
  __syncthreads();

  // This warp's 16 rows of Q as A fragments, kept in registers.
  const int wr = warp * 16;
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const __nv_bfloat16* p0 = sQ + (wr + g) * kLdQK + kk * 16 + 2 * t;
    const __nv_bfloat16* p1 = p0 + 8 * kLdQK;
    qf[kk][0] = ld_u32(p0);
    qf[kk][1] = ld_u32(p1);
    qf[kk][2] = ld_u32(p0 + 8);
    qf[kk][3] = ld_u32(p1 + 8);
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
        const __nv_bfloat16* src = base + key * row_stride;
        kv.u = *reinterpret_cast<const uint4*>(src + k_col + c);
        vv.u = *reinterpret_cast<const uint4*>(src + v_col + c);
      }
      *reinterpret_cast<uint4*>(sK + r * kLdQK + c) = kv.u;
#pragma unroll
      for (int j = 0; j < kVec; ++j) sVt[(c + j) * kLdV + r] = vv.h[j];
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, fp32.
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const __nv_bfloat16* kp = sK + (j * 8 + g) * kLdQK + kk * 16 + 2 * t;
        mma_bf16(s[j], qf[kk], ld_u32(kp), ld_u32(kp + 8));
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
  if (stats != nullptr && t == 0) {  // (max, sum) of every row, for the backward
    float2* st = stats + ((long long)b * heads + h) * n;
    if (row0 < n) st[row0] = make_float2(m_run[0], l_run[0]);
    if (row1 < n) st[row1] = make_float2(m_run[1], l_run[1]);
  }
  const long long out_stride = (long long)heads * D;
  __nv_bfloat16* out_b = out + (long long)b * n * out_stride + h * D;
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

template <int D>
cudaError_t launch(const void* qkv, void* out, void* stats, int batch, int n,
                   int heads, int kv_len, float q_scale, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((size_t)(kBlockQ + kBlockK) * (D + kPad) +
                       (size_t)D * (kBlockK + kPad));
  cudaError_t err = cudaFuncSetAttribute(
      qkv_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  qkv_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      static_cast<float2*>(stats), n, heads, kv_len, q_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers of
// contiguous bf16 tensors (16-byte aligned); `stream` is a cudaStream_t.
// `stats` is null, or an fp32 [B, H, N, 2] buffer that receives each query
// row's softmax max (log2 units) and row sum, which the backward
// (qkv_attention_bwd.cu) reads instead of recomputing them.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int qkv_attention_bf16(const void* qkv, void* out, void* stats,
                                  int batch, int n, int heads, int head_dim,
                                  int kv_len, float q_scale, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return (int)launch<64>(qkv, out, stats, batch, n, heads, kv_len, q_scale, s);
  if (head_dim == 128)
    return (int)launch<128>(qkv, out, stats, batch, n, heads, kv_len, q_scale, s);
  return (int)cudaErrorInvalidValue;
}
