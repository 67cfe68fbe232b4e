// Backward of the long-sequence flash attention (K4b).
//
// Replaces the bundled TPU kernels of `jax.experimental.pallas.ops.tpu.
// flash_attention` that differentiate K4: `_flash_attention_dkv_kernel`
// (pallas_call in `_flash_attention_bwd_dkv`) and `_flash_attention_dq_kernel`
// (pallas_call in `_flash_attention_bwd_dq`), reached from the JAX package's
// ops/attention.py:130 when the backbone trains on sequences longer than
// 8448 tokens (a 1536x1536 crop of the heritage preset: 9217 tokens) or
// through a causal tower.
//
//   q, k, v [B, N, H, D] bf16, read by stride (views of the fused qkv
//   projection), D in {64, 128};  dO [B, N, H, D] bf16 contiguous;
//   stats [B, H, N] float2 (row max m of the scaled logits in log2 units,
//   row sum l of exp2(s - m)) from K4's forward; di [B, H, N] fp32 =
//   rowsum(fp32 O * fp32 dO), computed by the caller as the bundled
//   wrapper computes it outside its kernels  ->  dq, dk, dv [B, N, H, D]
//   bf16, contiguous.
//
// Numerics follow the bundled kernels' rounding points:
//   s  = q k^T in fp32 from the UNSCALED bf16 q, then * sm_scale in fp32
//        (and * log2 e, the units of m);
//   p  = exp2(s - m) * (1 / l)        (the bundled exp(s - m) * (1 / l))
//   dv += bf16(p)^T dO;  dp = dO v^T;  ds = (dp - di) * p * sm_scale;
//   dk += bf16(ds)^T q;  dq += bf16(ds) k;  fp32 sums, one rounding at the end.
// Masks: keys >= valid_len (and, when causal, keys after the query) have
// p = 0 and are never loaded.  The bundled kernels put the JAX package's pad
// query rows on pad keys only (segment ids), so here query rows >= valid_len
// contribute nothing to dk / dv, their dq is 0, and dk / dv of keys >=
// valid_len are exactly 0.
//
// Design.  The bundled kernels keep dk/dv (or dq) in VMEM scratch across a
// sequential grid axis.  Hopper blocks run in no order, so, as for K2
// (qkv_attention_bwd.cu), two kernels on one stream and no atomics
// (deterministic sums):
//   1. dk/dv: one block per (64 keys, head, batch), a loop over 64-row query
//      tiles (causal: from the block's first key on) recomputing s^T, p^T,
//      dp^T, ds^T and accumulating dk, dv in registers;
//   2. dq: one block per (64 query rows, head, batch), a loop over 64-key
//      tiles (causal: up to the diagonal) accumulating dq in registers.
// 4 warps of 16 rows each, mma.sync m16n8k16 (bf16 in, fp32 out);
// operands needed in the other orientation (K for dq; q and dO for dk/dv)
// are stored transposed in shared memory by scalar stores.
//
// Bound on an H100 SXM at the training shape [2, 9344, 12, 64], valid_len
// 9217: the function needs five valid_len x valid_len x D products per
// (b, h) (s, dp, dv, dk, dq) = 10 * B * H * valid_len^2 * D = 1.30 TFLOP of
// bf16 tensor-core work (1.32 ms at 989 TFLOP/s) against ~90 MB of traffic
// (0.03 ms at 3.35 TB/s): operation- (and exp-) bound.  This design does
// seven (the dq kernel computes s and dp again), 1.4x the bound's work.
// Synchronous tile loads, no wgmma, no TMA: simple and right first.

#include "mma_bf16.cuh"

namespace {

using namespace dclip;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16 * kWarps;  // rows a block owns: keys (dk/dv) or query rows (dq)
constexpr int kStep = 64;           // rows of the streamed side
constexpr int kPad = 8;             // bf16 row padding (16 bytes) against bank conflicts
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTile == kStep, "causal loops start at the block's own tile");

struct Strides {  // in elements
  long long b, n, h;
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;     // contiguous [B, N, H, D]
  const float2* stats;  // [B, H, N]
  const float* di;      // [B, H, N]
  bf16* dq;             // contiguous [B, N, H, D]
  bf16* dk;
  bf16* dv;
  Strides qs, ks, vs;
  int n, heads, kv_len, causal;
  float sm_scale;
};

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
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const Args a) {
  constexpr int kLd = D + kPad;       // [row][d] tiles
  constexpr int kLdT = kStep + kPad;  // [d][query] tiles
  constexpr int kVecPerRow = D / kVec;
  constexpr int kSteps = D / 16;
  constexpr int kOutTiles = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTile * kLd;
  bf16* sQ = sV + kTile * kLd;   // q, [query][d]
  bf16* sDO = sQ + kStep * kLd;  // dO, [query][d]
  bf16* sQt = sDO + kStep * kLd;  // q, [d][query]
  bf16* sDOt = sQt + D * kLdT;    // dO, [d][query]
  float* sM = reinterpret_cast<float*>(sDOt + D * kLdT);
  float* sR = sM + kStep;
  float* sDi = sR + kStep;

  const int n = a.n;
  const int kv_len = a.kv_len;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const long long row_stride = (long long)a.heads * D;  // dO, dq, dk, dv
  const bf16* qb = a.q + b * a.qs.b + h * a.qs.h;
  const bf16* kb = a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vb = a.v + b * a.vs.b + h * a.vs.h;
  const bf16* dob = a.dout + (long long)b * n * row_stride + h * D;
  bf16* dkb = a.dk + (long long)b * n * row_stride + h * D;
  bf16* dvb = a.dv + (long long)b * n * row_stride + h * D;
  const long long bh = (long long)b * a.heads + h;

  if (k0 >= kv_len) {  // a tile of masked keys: dk = dv = 0 exactly
    for (int i = tid; i < kTile * kVecPerRow; i += kThreads) {
      const long long key = k0 + i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      if (key < n) {
        *reinterpret_cast<uint4*>(dkb + key * row_stride + c) = zero_vec().u;
        *reinterpret_cast<uint4*>(dvb + key * row_stride + c) = zero_vec().u;
      }
    }
    return;
  }

  for (int i = tid; i < kTile * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    const long long key = k0 + r;
    Vec8 kv = zero_vec(), vv = zero_vec();
    if (key < kv_len) {
      kv = load_vec(kb + key * a.ks.n + c);
      vv = load_vec(vb + key * a.vs.n + c);
    }
    *reinterpret_cast<uint4*>(sK + r * kLd + c) = kv.u;
    *reinterpret_cast<uint4*>(sV + r * kLd + c) = vv.u;
  }

  const int wr = warp * 16;
  const int key_r[2] = {k0 + wr + g, k0 + wr + g + 8};  // this thread's two keys
  float dk[kOutTiles][4], dv[kOutTiles][4];
#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }

  // Only valid query rows contribute; causal rows start at this key tile.
  for (int q0 = a.causal ? k0 : 0; q0 < kv_len; q0 += kStep) {
    __syncthreads();  // every warp is done with the previous query tile
    if (tid < kStep) {  // per-row residuals; rows past valid_len get p = 0
      const int row = q0 + tid;
      float mm = __int_as_float(0x7f800000), r = 0.f, dd = 0.f;
      if (row < kv_len) {
        const float2 st = a.stats[bh * n + row];
        mm = st.x;
        r = 1.f / st.y;
        dd = a.di[bh * n + row];
      }
      sM[tid] = mm;
      sR[tid] = r;
      sDi[tid] = dd;
    }
    for (int i = tid; i < kStep * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const long long row = q0 + r;
      Vec8 q = zero_vec(), d = zero_vec();
      if (row < kv_len) {
        q = load_vec(qb + row * a.qs.n + c);
        d = load_vec(dob + row * row_stride + c);
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        sQt[(c + j) * kLdT + r] = q.h[j];
        sDOt[(c + j) * kLdT + r] = d.h[j];
      }
      *reinterpret_cast<uint4*>(sQ + r * kLd + c) = q.u;
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
        for (int kk = 0; kk < kSteps; ++kk) {  // s^T = K q^T, dp^T = V dO^T
          uint32_t af[4], b0, b1;
          load_a(af, sK, kLd, wr, kk * 16, g, t);
          load_b(b0, b1, sQ, kLd, n0, kk * 16, g, t);
          mma_bf16(s, af, b0, b1);
          load_a(af, sV, kLd, wr, kk * 16, g, t);
          load_b(b0, b1, sDO, kLd, n0, kk * 16, g, t);
          mma_bf16(dp, af, b0, b1);
        }
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n0 + 2 * t + (e & 1);
          const int key = key_r[e >> 1];
          const bool live = key < kv_len && (!a.causal || key <= q0 + qi);
          p[e] = live ? exp2f((s[e] * a.sm_scale) * kLog2e - sM[qi]) * sR[qi] : 0.f;
          ds[e] = (dp[e] - sDi[qi]) * p[e] * a.sm_scale;
        }
        pf[jj * 2 + 0] = pack_bf16(p[0], p[1]);
        pf[jj * 2 + 1] = pack_bf16(p[2], p[3]);
        dsf[jj * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsf[jj * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int dt = 0; dt < kOutTiles; ++dt) {  // dk += ds^T q, dv += p^T dO
        uint32_t b0, b1;
        load_b(b0, b1, sQt, kLdT, dt * 8, cc * 16, g, t);
        mma_bf16(dk[dt], dsf, b0, b1);
        load_b(b0, b1, sDOt, kLdT, dt * 8, cc * 16, g, t);
        mma_bf16(dv[dt], pf, b0, b1);
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt) {
    const int col = dt * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long key = key_r[i];
      if (key < n) {
        *reinterpret_cast<uint32_t*>(dkb + key * row_stride + col) =
            pack_bf16(dk[dt][2 * i], dk[dt][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dvb + key * row_stride + col) =
            pack_bf16(dv[dt][2 * i], dv[dt][2 * i + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Args a) {
  constexpr int kLd = D + kPad;       // [row][d] tiles
  constexpr int kLdT = kStep + kPad;  // sKt: [d][key]
  constexpr int kVecPerRow = D / kVec;
  constexpr int kSteps = D / 16;
  constexpr int kOutTiles = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + kTile * kLd;
  bf16* sK = sDO + kTile * kLd;
  bf16* sV = sK + kStep * kLd;
  bf16* sKt = sV + kStep * kLd;

  const int n = a.n;
  const int kv_len = a.kv_len;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const long long row_stride = (long long)a.heads * D;
  const bf16* qb = a.q + b * a.qs.b + h * a.qs.h;
  const bf16* kb = a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vb = a.v + b * a.vs.b + h * a.vs.h;
  const bf16* dob = a.dout + (long long)b * n * row_stride + h * D;
  bf16* dqb = a.dq + (long long)b * n * row_stride + h * D;
  const long long bh = (long long)b * a.heads + h;

  if (q0 >= kv_len) {  // a tile of pad query rows: dq = 0
    for (int i = tid; i < kTile * kVecPerRow; i += kThreads) {
      const long long row = q0 + i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      if (row < n) *reinterpret_cast<uint4*>(dqb + row * row_stride + c) = zero_vec().u;
    }
    return;
  }

  for (int i = tid; i < kTile * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    const long long row = q0 + r;
    Vec8 q = zero_vec(), d = zero_vec();
    if (row < kv_len) {
      q = load_vec(qb + row * a.qs.n + c);
      d = load_vec(dob + row * row_stride + c);
    }
    *reinterpret_cast<uint4*>(sQ + r * kLd + c) = q.u;
    *reinterpret_cast<uint4*>(sDO + r * kLd + c) = d.u;
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[kSteps][4], dof[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    load_a(qf[kk], sQ, kLd, wr, kk * 16, g, t);
    load_a(dof[kk], sDO, kLd, wr, kk * 16, g, t);
  }
  // Residuals of rows g and g + 8; rows past valid_len get p = 0.
  const int row_r[2] = {q0 + wr + g, q0 + wr + g + 8};
  float m[2], rl[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = __int_as_float(0x7f800000);
    rl[i] = 0.f;
    dd[i] = 0.f;
    if (row_r[i] < kv_len) {
      const float2 st = a.stats[bh * n + row_r[i]];
      m[i] = st.x;
      rl[i] = 1.f / st.y;
      dd[i] = a.di[bh * n + row_r[i]];
    }
  }

  float dq[kOutTiles][4];
#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;

  const int k_end = a.causal ? min(kv_len, q0 + kTile) : kv_len;
  for (int k0 = 0; k0 < k_end; k0 += kStep) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kStep * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const long long key = k0 + r;
      Vec8 kv = zero_vec(), vv = zero_vec();
      if (key < kv_len) {
        kv = load_vec(kb + key * a.ks.n + c);
        vv = load_vec(vb + key * a.vs.n + c);
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
          const bool live = key < kv_len && (!a.causal || key <= row_r[i]);
          const float p = live ? exp2f((s[e] * a.sm_scale) * kLog2e - m[i]) * rl[i] : 0.f;
          ds[e] = (dp[e] - dd[i]) * p * a.sm_scale;
        }
        dsf[jj * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsf[jj * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int dt = 0; dt < kOutTiles; ++dt) {  // dq += ds k
        uint32_t b0, b1;
        load_b(b0, b1, sKt, kLdT, dt * 8, cc * 16, g, t);
        mma_bf16(dq[dt], dsf, b0, b1);
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt) {
    const int col = dt * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long row = row_r[i];
      if (row < n)
        *reinterpret_cast<uint32_t*>(dqb + row * row_stride + col) =
            pack_bf16(dq[dt][2 * i], dq[dt][2 * i + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int kLd = D + kPad;
  constexpr int kLdT = kStep + kPad;
  const size_t smem_dkdv = sizeof(bf16) * ((size_t)(2 * kTile + 2 * kStep) * kLd + 2 * (size_t)D * kLdT) +
                           3 * sizeof(float) * kStep;
  const size_t smem_dq = sizeof(bf16) * ((size_t)(2 * kTile + 2 * kStep) * kLd + (size_t)D * kLdT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kTile - 1) / kTile, a.heads, batch);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, smem_dkdv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem_dq, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  q / k / v are device pointers of bf16
// [B, N, H, D] tensors with unit stride over D, 16-byte aligned, whose batch /
// token / head strides (in elements, multiples of 8) are given; dout, dq, dk
// and dv are contiguous bf16 [B, N, H, D]; stats is the fp32 [B, H, N, 2]
// buffer K4's forward filled and di fp32 [B, H, N].  Launches the dk/dv
// kernel, then the dq kernel, on `stream` (a cudaStream_t).  Returns the
// cudaError_t of the launches (0 = cudaSuccess).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const void* stats, const void* di,
                                        void* dq, void* dk, void* dv,
                                        long long q_sb, long long q_sn, long long q_sh,
                                        long long k_sb, long long k_sn, long long k_sh,
                                        long long v_sb, long long v_sn, long long v_sh,
                                        int batch, int n, int heads, int head_dim, int kv_len,
                                        int causal, float sm_scale, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
               static_cast<const float2*>(stats), static_cast<const float*>(di),
               static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
               Strides{q_sb, q_sn, q_sh}, Strides{k_sb, k_sn, k_sh}, Strides{v_sb, v_sn, v_sh},
               n, heads, kv_len, causal, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)launch<64>(a, batch, s);
  if (head_dim == 128) return (int)launch<128>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}
