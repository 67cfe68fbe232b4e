// Long-sequence softmax attention on [B, N, H, D] (flash attention forward).
//
// Replaces the bundled TPU kernel `jax.experimental.pallas.ops.tpu.
// flash_attention` (forward body `_flash_attention_kernel_single_batch`),
// which the JAX package calls at denseclip_vit_multimodal_tpu/ops/
// attention.py:130 for causal attention and for sequences longer than 8448
// tokens (the 1.25 / 1.5 / 1.75 scales of multi-scale evaluation on a
// 1024x2048 frame: 12801 / 18433 / 25089 tokens).
//
//   q, k, v [B, N, H, D] bf16, read by stride (row stride 3*H*D when they
//   are views of the fused qkv projection), D in {64, 128}
//   out     [B, N, H, D] bf16, contiguous
//   stats   null, or [B, H, N] float2: each query row's max of the scaled
//           logits (log2 units) and its sum of exp2(s - max), the residuals
//           the backward (K4b, flash_attention_bwd.cu) reads; the bundled
//           kernel saves the same pair in natural units (m, l)
//
// Numerics follow the bundled kernel's rounding points:
//   * s = q k^T in fp32 from the UNSCALED bf16 q, then s *= sm_scale in fp32;
//   * keys >= kv_len (and, when causal, keys after the query) are excluded;
//     they are never loaded from memory, so a NaN in a pad row cannot reach
//     a real row through 0 * NaN;
//   * online softmax with fp32 max and sum; exp(x) is exp2(x * log2 e);
//   * P is rounded to bf16 for P V, which accumulates in fp32; the row sum is
//     taken over the fp32 P; one division by it at the end (the bundled
//     kernel renormalises at every step: equal up to fp32 rounding).
//
// Design.  K1's streamed layout (csrc/qkv_attention.cu): one block per
// (q-tile of 128 rows, head, batch), 8 warps of 16 query rows each, K/V
// streamed through shared memory in tiles of 64 keys, both products on the
// tensor cores through mma.sync m16n8k16.  What differs from K1: K/V tiles
// are double-buffered with cp.async (the next tile loads while this one is
// multiplied), V stays row-major in shared memory and its B fragments come
// from ldmatrix.trans (no scalar transpose), and causal blocks stop at the
// diagonal instead of masking the tiles past it.
//
// Bound on an H100 SXM at the largest evaluation shape [2, 25216, 12, 64],
// valid_len 25089: 4*B*H*valid_len^2*D = 3.87 TFLOP of bf16 tensor-core work
// (3.9 ms at 989 TFLOP/s) against 310 MB of q/k/v/out traffic (0.09 ms at
// 3.35 TB/s): compute- (and exp-) bound.  No wgmma, no TMA, no warp
// specialisation yet.

#include "mma_bf16.cuh"

namespace {

using namespace dclip;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block
constexpr int kBlockK = 64;           // keys per K/V tile
constexpr int kPad = 8;               // bf16 row padding (16 bytes) against bank conflicts
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // in elements
  long long b, n, h;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, float2* __restrict__ stats,
                       Strides qs, Strides ks,
                       Strides vs, int n, int heads, int kv_len, int causal,
                       float sm_scale) {
  constexpr int kLd = D + kPad;  // row stride of every shared tile
  constexpr int kVecPerRow = D / kVec;
  constexpr int kSteps = D / 16;     // k-steps of Q K^T
  constexpr int kOutTiles = D / 8;   // n-tiles of P V
  constexpr int kKeyTiles = kBlockK / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockQ * kLd;      // [2][kBlockK][kLd]
  __nv_bfloat16* sV = sK + 2 * kBlockK * kLd;  // [2][kBlockK][kLd]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const float neg_inf = __int_as_float(0xff800000);

  // Keys this block reads: all valid ones, or (causal) those up to its last row.
  const int kv_end = causal ? min(kv_len, q0 + kBlockQ) : kv_len;
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  auto load_kv = [&](int stage, int k0) {
    __nv_bfloat16* dk = sK + stage * kBlockK * kLd;
    __nv_bfloat16* dv = sV + stage * kBlockK * kLd;
    for (int i = tid; i < kBlockK * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const int key = k0 + r;
      const bool ok = key < kv_len;
      const long long row = ok ? key : 0;  // a valid address even when nothing is read
      cp_async16(dk + r * kLd + c, kb + row * ks.n + c, ok ? 16 : 0);
      cp_async16(dv + r * kLd + c, vb + row * vs.n + c, ok ? 16 : 0);
    }
  };

  // Q tile (zeros past N) and the first K/V tile, in one cp.async group.
  for (int i = tid; i < kBlockQ * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    const int row = q0 + r;
    const bool ok = row < n;
    cp_async16(sQ + r * kLd + c, qb + (long long)(ok ? row : 0) * qs.n + c, ok ? 16 : 0);
  }
  load_kv(0, 0);
  cp_async_commit();

  const int wr = warp * 16;
  const int row0 = q0 + wr + g;  // this thread's two query rows
  const int row1 = row0 + 8;
  uint32_t qf[kSteps][4];
  float o[kOutTiles][4];
#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_run[2] = {neg_inf, neg_inf};  // running max of rows g, g + 8 (log2 units)
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockK;
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_kv(stage ^ 1, k0 + kBlockK);  // prefetch the next tile
    cp_async_commit();  // (possibly empty group: keeps the wait count uniform)
    cp_async_wait<1>();  // everything but the prefetch has landed
    __syncthreads();

    if (it == 0) {  // this warp's 16 rows of Q as A fragments, kept in registers
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) load_a(qf[kk], sQ, kLd, wr, kk * 16, g, t);
    }
    const __nv_bfloat16* tK = sK + stage * kBlockK * kLd;
    const __nv_bfloat16* tV = sV + stage * kBlockK * kLd;

    // S = Q K^T (fp32), then * sm_scale (fp32) and into log2 units.
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t b0, b1;
        load_b(b0, b1, tK, kLd, j * 8, kk * 16, g, t);
        mma_bf16(s[j], qf[kk], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = (s[j][e] * sm_scale) * kLog2e;
    }
    const bool ragged = k0 + kBlockK > kv_len;
    const bool diagonal = causal && k0 + kBlockK - 1 > q0 + wr;
    if (ragged || diagonal) {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        const int key = k0 + j * 8 + 2 * t;
        const int lim0 = causal ? min(kv_len - 1, row0) : kv_len - 1;  // last key row0 sees
        const int lim1 = causal ? min(kv_len - 1, row1) : kv_len - 1;
        if (key > lim0) s[j][0] = neg_inf;
        if (key + 1 > lim0) s[j][1] = neg_inf;
        if (key > lim1) s[j][2] = neg_inf;
        if (key + 1 > lim1) s[j][3] = neg_inf;
      }
    }

    // Online softmax.  Key 0 is seen by every row in the first tile, so the
    // running max is finite from then on and exp2(-inf - m) = 0 needs no
    // special case; a row whose keys in this tile are all masked adds 0.
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

    // O += P V (fp32 accumulation); V's B fragments by ldmatrix.trans, two
    // 8-wide output tiles per load.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt < kOutTiles; dt += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, tV + (kk * 16 + (lane & 15)) * kLd + dt * 8 + (lane >> 4) * 8);
        mma_bf16(o[dt], pf[kk], vf[0], vf[1]);
        mma_bf16(o[dt + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Row sums across the four threads of each row group, then one division.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  if (stats != nullptr && t == 0) {  // (max, sum) of every row, for the backward
    float2* st = stats + ((long long)b * heads + h) * n;
    if (row0 < n) st[row0] = make_float2(m_run[0], l_run[0]);
    if (row1 < n) st[row1] = make_float2(m_run[1], l_run[1]);
  }
  const long long out_row = (long long)heads * D;
  __nv_bfloat16* ob = out + (long long)b * n * out_row + (long long)h * D;
#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < n)
      *reinterpret_cast<uint32_t*>(ob + row0 * out_row + col) =
          pack_bf16(o[dt][0] / l_run[0], o[dt][1] / l_run[0]);
    if (row1 < n)
      *reinterpret_cast<uint32_t*>(ob + row1 * out_row + col) =
          pack_bf16(o[dt][2] / l_run[1], o[dt][3] / l_run[1]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* stats, Strides qs,
                   Strides ks, Strides vs, int batch, int n, int heads, int kv_len,
                   int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(kBlockQ + 4 * kBlockK) * (D + kPad);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float2*>(stats), qs, ks, vs, n,
      heads, kv_len, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  q / k / v are device pointers of bf16
// [B, N, H, D] tensors with unit stride over D, 16-byte aligned, whose
// batch / token / head strides (in elements, multiples of 8) are given; out
// is a contiguous bf16 [B, N, H, D] buffer; `stats` is null or an fp32
// [B, H, N, 2] buffer for the row residuals.  `stream` is a cudaStream_t.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    void* stats,
                                    long long q_sb, long long q_sn, long long q_sh,
                                    long long k_sb, long long k_sn, long long k_sh,
                                    long long v_sb, long long v_sn, long long v_sh,
                                    int batch, int n, int heads, int head_dim, int kv_len,
                                    int causal, float sm_scale, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return (int)launch<64>(q, k, v, out, stats, qs, ks, vs, batch, n, heads, kv_len, causal,
                           sm_scale, s);
  if (head_dim == 128)
    return (int)launch<128>(q, k, v, out, stats, qs, ks, vs, batch, n, heads, kv_len, causal,
                            sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
