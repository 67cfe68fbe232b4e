// Attention off the fused QKV projection with the out-projection fused as an
// epilogue (K7): the experiment of tools/exp_outproj_epilogue.py.
//
// Replaces the TPU kernel `_qkv_out_kernel` of the JAX package's
// tools/exp_outproj_epilogue.py (reached through `qkv_out_attention`), which
// asks whether multiplying each head's attention output by its rows of
// W_out while it is still on chip beats K1 plus a separate matmul.
//
//   qkv [B, N, 3*H*D] bf16 (contiguous), D in {64, 128}, H*D a multiple of
//   64;  w_out [H*D, H*D] bf16 (contiguous, [in, out]: y = o @ w_out)
//   ->  out [B, N, H*D] fp32 (before the bias), contiguous.
//
// Numerics follow the TPU kernel's rounding points, per head:
//   * K1's body: q * (scale * log2 e) in fp32 rounded to bf16, fp32 scores,
//     exp2 softmax, P rounded to bf16 for P V with fp32 accumulation, the
//     row sum over the fp32 P; keys >= valid_len excluded (the script's
//     iota mask gives them weight 0 too; its zero-pad denominator correction
//     is the same number);
//   * o / denom rounded to bf16;
//   * the product with W_out's rows of that head, accumulated in fp32 with
//     every other head's.
// The one difference is the softmax's order: streamed with an online max
// (as K1), where the TPU kernel holds the whole score row.
//
// Design.  The TPU kernel keeps an fp32 [bq, H*D] output block resident in
// VMEM across the heads of a q-tile.  That block is 192 KB at 64 rows and
// H*D = 768, more than the registers of a block, so here each block (64
// query rows of one batch element, 4 warps of 16 rows) keeps the bf16
// attention output of ALL heads in shared memory ([64, H*D]: 96 KB at 768)
// and multiplies it by W_out after the last head, 64 output columns at a
// time with the accumulator in registers, W_out streamed through shared
// memory in 64 x 64 tiles.  The attention output never reaches device
// memory and no atomics are used (the sum order is fixed).  K/V of each head
// stream through shared memory in 64-key tiles with the online softmax; V's
// and W_out's B fragments come from ldmatrix.trans.  Synchronous loads, no
// wgmma, no TMA.
//
// Bound on an H100 SXM at the experiment's shape [10, 1601, 2304], H 12,
// D 64: attention 4*B*H*N^2*D = 78.7 GFLOP plus the projection 2*B*N*(H*D)^2
// = 18.9 GFLOP of bf16 tensor-core work (0.099 ms at 989 TFLOP/s) against
// ~123 MB of qkv / W / fp32-out traffic (0.037 ms at 3.35 TB/s):
// operation-bound.

#include "mma_bf16.cuh"

namespace {

using namespace dclip;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block
constexpr int kBlockK = 64;           // keys per K/V tile
constexpr int kBlockN = 64;           // output columns (and W_out rows) per projection tile
constexpr int kPad = 8;               // bf16 row padding (16 bytes) against bank conflicts

template <int D>
constexpr size_t smem_bytes(int hd) {
  return sizeof(bf16) * ((size_t)kBlockQ * (hd + kPad) +              // sO
                         (size_t)(kBlockQ + 2 * kBlockK) * (D + kPad));  // sQ, sK, sV (sW)
}

template <int D>
__global__ void __launch_bounds__(kThreads)
qkv_out_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ w,
                         float* __restrict__ out, int n, int heads, int kv_len,
                         float q_scale) {
  constexpr int kLd = D + kPad;
  constexpr int kLdW = kBlockN + kPad;
  constexpr int kVecPerRow = D / kVec;
  constexpr int kSteps = D / 16;
  constexpr int kOutTiles = D / 8;
  constexpr int kKeyTiles = kBlockK / 8;
  static_assert(kBlockK * kLdW <= kBlockK * kLd, "a W tile fits the K tile's buffer");

  const int hd = heads * D;
  const int ldo = hd + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sO = reinterpret_cast<bf16*>(smem_raw);  // [kBlockQ][hd]: every head's output
  bf16* sQ = sO + kBlockQ * ldo;
  bf16* sK = sQ + kBlockQ * kLd;  // K tiles; W_out tiles in the epilogue
  bf16* sV = sK + kBlockK * kLd;

  const int q0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const long long row_stride = 3LL * hd;
  const bf16* base = qkv + (long long)b * n * row_stride;
  const float neg_inf = __int_as_float(0xff800000);

  for (int h = 0; h < heads; ++h) {
    const bf16* qb = base + h * D;
    const bf16* kb = base + hd + h * D;
    const bf16* vb = base + 2 * hd + h * D;
    __syncthreads();  // every warp is done with the previous head's tiles
    for (int i = tid; i < kBlockQ * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const long long row = q0 + r;
      Vec8 v;
      v.u = make_uint4(0u, 0u, 0u, 0u);
      if (row < n) {
        v.u = *reinterpret_cast<const uint4*>(qb + row * row_stride + c);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          v.h[j] = __float2bfloat16_rn(__bfloat162float(v.h[j]) * q_scale);
      }
      *reinterpret_cast<uint4*>(sQ + r * kLd + c) = v.u;
    }
    __syncthreads();
    uint32_t qf[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) load_a(qf[kk], sQ, kLd, wr, kk * 16, g, t);

    float o[kOutTiles][4];
#pragma unroll
    for (int dt = 0; dt < kOutTiles; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    float m_run[2] = {neg_inf, neg_inf};
    float l_run[2] = {0.f, 0.f};

    for (int k0 = 0; k0 < kv_len; k0 += kBlockK) {
      __syncthreads();  // every warp is done with the previous K/V tile
      for (int i = tid; i < kBlockK * kVecPerRow; i += kThreads) {
        const int r = i / kVecPerRow;
        const int c = (i % kVecPerRow) * kVec;
        const long long key = k0 + r;
        uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
        if (key < kv_len) {
          kv = *reinterpret_cast<const uint4*>(kb + key * row_stride + c);
          vv = *reinterpret_cast<const uint4*>(vb + key * row_stride + c);
        }
        *reinterpret_cast<uint4*>(sK + r * kLd + c) = kv;
        *reinterpret_cast<uint4*>(sV + r * kLd + c) = vv;
      }
      __syncthreads();

      float s[kKeyTiles][4];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
          uint32_t b0, b1;
          load_b(b0, b1, sK, kLd, j * 8, kk * 16, g, t);
          mma_bf16(s[j], qf[kk], b0, b1);
        }
      }
      if (k0 + kBlockK > kv_len) {  // ragged last tile: keys >= kv_len get weight 0
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
          const int key = k0 + j * 8 + 2 * t;
          if (key >= kv_len) s[j][0] = s[j][2] = neg_inf;
          if (key + 1 >= kv_len) s[j][1] = s[j][3] = neg_inf;
        }
      }

      // Online softmax: every tile holds a valid key, so the max is finite.
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
      uint32_t pf[kBlockK / 16][4];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        const float p0 = exp2f(s[j][0] - mx[0]);
        const float p1 = exp2f(s[j][1] - mx[0]);
        const float p2 = exp2f(s[j][2] - mx[1]);
        const float p3 = exp2f(s[j][3] - mx[1]);
        l_run[0] += p0 + p1;
        l_run[1] += p2 + p3;
        pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {  // O += P V, V's fragments by ldmatrix.trans
#pragma unroll
        for (int dt = 0; dt < kOutTiles; dt += 2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, sV + (kk * 16 + (lane & 15)) * kLd + dt * 8 + (lane >> 4) * 8);
          mma_bf16(o[dt], pf[kk], vf[0], vf[1]);
          mma_bf16(o[dt + 1], pf[kk], vf[2], vf[3]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    // o / denom rounded to bf16, into this head's columns of sO.
#pragma unroll
    for (int dt = 0; dt < kOutTiles; ++dt) {
      const int col = h * D + dt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(sO + (wr + g) * ldo + col) =
          pack_bf16(o[dt][0] / l_run[0], o[dt][1] / l_run[0]);
      *reinterpret_cast<uint32_t*>(sO + (wr + g + 8) * ldo + col) =
          pack_bf16(o[dt][2] / l_run[1], o[dt][3] / l_run[1]);
    }
  }

  // Epilogue: out[64, hd] = sO[64, hd] @ W_out[hd, hd], 64 columns at a time.
  bf16* sW = sK;
  float* ob = out + (long long)b * n * hd;
  for (int n0 = 0; n0 < hd; n0 += kBlockN) {
    float acc[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += kBlockK) {
      __syncthreads();  // sO complete (first pass); the previous W tile consumed
      for (int i = tid; i < kBlockK * (kBlockN / kVec); i += kThreads) {
        const int r = i / (kBlockN / kVec);
        const int c = (i % (kBlockN / kVec)) * kVec;
        *reinterpret_cast<uint4*>(sW + r * kLdW + c) =
            *reinterpret_cast<const uint4*>(w + (long long)(c0 + r) * hd + n0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        uint32_t af[4];
        load_a(af, sO, ldo, wr, c0 + kk * 16, g, t);
#pragma unroll
        for (int j = 0; j < kBlockN / 8; j += 2) {
          uint32_t wf[4];
          ldmatrix_x4_trans(wf, sW + (kk * 16 + (lane & 15)) * kLdW + j * 8 + (lane >> 4) * 8);
          mma_bf16(acc[j], af, wf[0], wf[1]);
          mma_bf16(acc[j + 1], af, wf[2], wf[3]);
        }
      }
    }
    const long long row0 = q0 + wr + g;
    const long long row1 = row0 + 8;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      if (row0 < n)
        *reinterpret_cast<float2*>(ob + row0 * hd + col) = make_float2(acc[j][0], acc[j][1]);
      if (row1 < n)
        *reinterpret_cast<float2*>(ob + row1 * hd + col) = make_float2(acc[j][2], acc[j][3]);
    }
  }
}

template <int D>
cudaError_t launch(const void* qkv, const void* w, void* out, int batch, int n, int heads,
                   int kv_len, float q_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(heads * D);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      qkv_out_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, batch);
  qkv_out_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(w), static_cast<float*>(out), n,
      heads, kv_len, q_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  qkv [B, N, 3*H*D] and w_out [H*D, H*D]
// are contiguous bf16 device tensors (16-byte aligned), out a contiguous
// fp32 [B, N, H*D] buffer; q_scale is scale * log2 e; `stream` is a
// cudaStream_t.  Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int qkv_out_attention_bf16(const void* qkv, const void* w, void* out, int batch,
                                      int n, int heads, int head_dim, int kv_len,
                                      float q_scale, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n ||
      (heads * head_dim) % kBlockN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)launch<64>(qkv, w, out, batch, n, heads, kv_len, q_scale, s);
  if (head_dim == 128) return (int)launch<128>(qkv, w, out, batch, n, heads, kv_len, q_scale, s);
  return (int)cudaErrorInvalidValue;
}
