// The attention backward shared by K2 and K3's backward
// (qkv_attention_bwd.cu) and K4b (flash_attention_bwd.cu): the counterpart
// of attention_fwd.cuh.  Each source instantiates `dq<P, C>` and
// `dkdv<P, C>` in __global__ kernels of its own names (a profile tells them
// apart) and launches them through `launch`.  ops/_build.py hashes this
// header into the name of every library built from csrc/.
//
// Replaces three TPU backward kernels:
//   * `_bwd_kernel` of the JAX package (denseclip_vit_multimodal_tpu/ops/
//     mha_kernel.py), reached through `_qkv_bwd` -> `_mha_bwd_pallas` (K2,
//     off the fused QKV projection) and `_mha_bwd` -> `_mha_bwd_pallas`
//     (K3's backward, `mha_attention`): policy `TpuPolicy`;
//   * the bundled `_flash_attention_dkv_kernel` and `_flash_attention_dq_
//     kernel` (jax/experimental/pallas/ops/tpu/flash_attention.py) behind
//     the JAX package's ops/attention.py:130 (K4b): policy `BundledPolicy`.
//
//   q, k, v, dO [B, N, H, D] bf16, read by stride (unit stride over D), D in
//   {64, 128, 256};  stats [B, H, N] float2 from the
//   forward (row max m of the scaled logits in log2 units, row sum l of
//   exp2(s - m));  coef [B, H, N] fp32  ->  dq, dk, dv [B, N, H, D] bf16,
//   written by stride.
//
// Numerics, per caller (the policy):
//   TpuPolicy (the TPU `_bwd_kernel`'s rounding points): qs = bf16(q *
//     (scale * log2 e)) with the constant in fp32; s = qs k^T (fp32), p =
//     exp2(s - m) unnormalised, r = 1 / l; dp = dO v^T; ds = bf16(p * (dp -
//     Dc) * (scale * r)); dq = ds k, dk = ds^T q (unscaled q), dv = bf16(p)^T
//     bf16(dO * r).  Dc = rowsum(dO * O) stands in for the kernel's rowsum(p
//     * dp) * r over a score row a streamed kernel never holds (the same
//     number up to the bf16 rounding of O).  The dq kernel runs first: it
//     writes Dc to `coef` and qs and bf16(dO * r) to two [B, H, N, D]
//     scratch tensors, so that the dk/dv kernel streams every operand as one
//     plain copy.  Query rows in [kv_len, N) (pad rows) get dq against the
//     valid keys and their dO reaches dk / dv of the valid keys.
//   BundledPolicy (the bundled kernels' rounding points): s = q k^T in fp32
//     from the UNSCALED q, then * sm_scale * log2 e; p = exp2(s - m) * (1 /
//     l); dv += bf16(p)^T dO; ds = (dp - di) * p * sm_scale; dk += bf16(ds)^T
//     q; dq = bf16(ds) k.  di = rowsum(O * dO) comes from the caller in
//     `coef`; the dk/dv kernel runs first.  Pad rows contribute nothing and
//     get dq = 0; keys after the query are masked when `causal`.
//   Both: fp32 accumulation, one rounding to bf16 at the end; keys >= kv_len
//   get p = 0 and dk = dv = 0 exactly; no atomics, so every sum runs in a
//   fixed order and a rerun is bitwise the same.
//
// Bound on an H100 SXM: the function is five products of N x kv_len x D per
// (batch, head) (s, dp, dv, dq, dk): 10 * B * H * N * kv_len * D bf16
// tensor-core operations (halved when causal) against a few bytes per
// element of q, k, v, O, dO, dq, dk, dv.  At every training shape
// (K2 [4, 1664, 2304] valid 1601: 82 GFLOP, 0.083 ms at 989 TFLOP/s
// against 21 us of traffic; K4b [2, 9344, 12, 64] valid 9217: 1.30 TFLOP,
// 1.32 ms) it is operation- (and exp-) bound.
//
// Design.  The TPU kernels accumulate dk / dv (or dq) in VMEM across a
// sequential grid axis; Hopper blocks run in no order, so the work is split
// FlashAttention-2 style into two kernels on one stream, neither with
// atomics, at the price of s and dp computed in both (seven products where
// the function needs five):
//   dq:   one block per (kRows query rows, head, batch), owning q and dO,
//         a loop over kStep-key tiles of K and V accumulating dq;
//   dk/dv: one block per (kRows keys, head, batch), owning K and V, a loop
//         over kStep-row tiles of the query side accumulating dk and dv.
// Each warp owns 16 rows; every product is mma.sync m16n8k16 (bf16 in, fp32
// out).  What the design does about the card:
//   * the streamed side (K / V in dq; q, dO (and qs, dO * r) in dk/dv) runs
//     through a two-stage ring of cp.async copies: tile t + 1 loads while
//     tile t is multiplied;
//   * every tile is one plain row-major copy in shared memory, read in both
//     orientations by ldmatrix / ldmatrix.trans (no transposed copy, no
//     scalar stores); rows are padded by 16 bytes, so the eight row
//     addresses of each 8x8 matrix fall in distinct banks;
//   * 8 warps own 128 rows at D <= 128 (K1's block); the dq kernel keeps
//     its A fragments in registers at D = 64;
//   * the s / dp products run k-step outer over two independent 8-wide
//     n-tiles each: four independent mma chains, as K1's Q K^T loop;
//   * warps skip 16-row chunks that masks empty (causal, ragged ends), and
//     chunks no mask reaches take a copy of the loop without per-element
//     mask tests (the tests cost about a fifth of the time on this card);
//   * the dk/dv kernel takes each streamed row's softmax terms (max,
//     reciprocal sum, Dc / di) once per tile, not once per chunk.
// Keeping the dk/dv kernel's K / V fragments in registers saves a third of
// its ldmatrix reads but halves the warps an SM holds: it measured slower
// (PERF.md, the per-step table).
// Head dim 256 (both policies): 16 keys x 256 of both dk and dv in fp32
// would take 256 registers a thread, over the cap of 255.  So at D = 256 a
// dk/dv block makes two passes over the query side: the first accumulates
// dk (s, dp, dk), the second dv (s again, dv): 128 accumulator registers
// each, eight products where D <= 128 does seven.  Blocks are 4 warps on 64
// rows and streamed tiles 32 rows, to fit 227 KB of shared memory.
// Not yet: wgmma, TMA, warp specialisation.

#pragma once

#include "bundled_logit.cuh"
#include "mma_bf16.cuh"

namespace dclip {
namespace bwd {

using bf16 = __nv_bfloat16;

struct Strides {  // in elements
  long long b, n, h;
};

struct Args {
  const bf16* q;      // as given: dk's operand, and s's under BundledPolicy
  const bf16* k;
  const bf16* v;
  const bf16* o;      // TpuPolicy: the forward output (Dc); else unused
  const bf16* dout;
  const float2* stats;  // [B, H, N]
  float* coef;        // [B, H, N]: Dc (written by the dq kernel) or di (given)
  bf16* qs;           // TpuPolicy scratch [B, H, N, D]: bf16(q * q_scale)
  bf16* dor;          // TpuPolicy scratch [B, H, N, D]: bf16(dO * r)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides qst, kst, vst, ost, dost, dqst, dkst, dvst;
  int n, heads, kv_len, causal;
  float q_scale;  // TpuPolicy: scale * log2 e
  float scale;    // the softmax scale
};

// The TPU `_bwd_kernel`'s arithmetic (K2, K3's backward).
struct TpuPolicy {
  static constexpr bool kPrescaled = true;  // s from qs; dv from bf16(dO * r)
  static constexpr bool kDqFirst = true;
  static constexpr bool kPadRowsContribute = true;
  // The per-row multiplier of ds from the row sum l.
  __device__ static float row_mul(float l, float scale) { return scale * (1.f / l); }
  __device__ static float logit(float s, float) { return s; }
  __device__ static float prob(float s, float m, float) { return exp2f(s - m); }
  __device__ static float dscore(float p, float dp, float c, float rm, float) {
    return p * (dp - c) * rm;
  }
};

// The bundled flash kernels' arithmetic (K4b).
struct BundledPolicy {
  static constexpr bool kPrescaled = false;
  static constexpr bool kDqFirst = false;
  static constexpr bool kPadRowsContribute = false;
  __device__ static float row_mul(float l, float) { return 1.f / l; }
  // K4's logit, bit for bit: p is rebuilt from the row max K4 wrote
  __device__ static float logit(float s, float scale) { return bundled_logit(s, scale); }
  __device__ static float prob(float s, float m, float r) { return exp2f(s - m) * r; }
  __device__ static float dscore(float p, float dp, float c, float, float scale) {
    return (dp - c) * p * scale;
  }
};

// Tiling per head dim.
template <int D_>
struct Cfg {
  static constexpr int D = D_;
  static constexpr int kWarps = D_ > 128 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;         // rows a block owns
  static constexpr int kStep = D_ > 128 ? 32 : 64;  // rows of a streamed tile
  static constexpr int kStages = 2;                 // the streamed side's ring
  static constexpr int kPasses = D_ > 128 ? 2 : 1;  // dk/dv: dk, then dv (D = 256)
  static constexpr bool kQRegs = D_ <= 64;          // dq: A fragments in registers
  static constexpr int kMinBlocks = D_ <= 64 ? 2 : 1;
  static constexpr int kLd = D_ + 8;                // padded row, bf16
  static_assert(kRows % kStep == 0, "causal loops start at the block's first row");
};

// ---- fragments by ldmatrix --------------------------------------------

// A fragment (16 x 16, row-major [m][k]) at rows r0.., cols c0..
__device__ __forceinline__ void ldsm_a(uint32_t a[4], const bf16* s, int ld, int r0, int c0,
                                       int lane) {
  ldmatrix_x4(a, s + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of the two n-tiles n0.., n0 + 8.. over k0..k0 + 16 of an
// operand stored [n][k] (k contiguous): b[0], b[1] for n0; b[2], b[3] for n0 + 8.
__device__ __forceinline__ void ldsm_b(uint32_t b[4], const bf16* s, int ld, int n0, int k0,
                                       int lane) {
  ldmatrix_x4(b, s + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of the two n-tiles n0.., n0 + 8.. over k0..k0 + 16 of an
// operand stored [k][n] (n contiguous), by ldmatrix.trans.
__device__ __forceinline__ void ldsm_bt(uint32_t b[4], const bf16* s, int ld, int k0, int n0,
                                        int lane) {
  ldmatrix_x4_trans(b, s + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// Rows [r0, r0 + rows) of a [B, N, H, D] operand at `base` (the (batch,
// head) origin) into a padded shared tile; rows >= lim are zero-filled.
template <int D, int kThreads>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, long long row_stride,
                                          int r0, int rows, int lim, int tid) {
  constexpr int kVecPerRow = D / kVec;
  for (int i = tid; i < rows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    const bool ok = r0 + r < lim;
    cp_async16(dst + r * (D + 8) + c, base + (long long)(ok ? r0 + r : 0) * row_stride + c,
               ok ? 16 : 0);
  }
}

// The fragment pair (s, dp) for 16 owned rows x 16 streamed rows: s over
// (A rows of sA) x (rows of sB), dp over (sA2) x (sB2), each as two 8-wide
// n-tiles, k-step outer (four independent mma chains).  With kFromRegs the A
// fragments come from qf / dof instead.
template <class C, bool kWithDp, bool kFromRegs>
__device__ __forceinline__ void scores(float s[2][4], float dp[2][4], const bf16* sA,
                                       const bf16* sA2, const uint32_t (*qf)[4],
                                       const uint32_t (*dof)[4], int wr, const bf16* sB,
                                       const bf16* sB2, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::D / 16; ++kk) {
    uint32_t af[4], bf[4];
    if constexpr (kFromRegs) {
#pragma unroll
      for (int i = 0; i < 4; ++i) af[i] = qf[kk][i];
    } else {
      ldsm_a(af, sA, C::kLd, wr, kk * 16, lane);
    }
    ldsm_b(bf, sB, C::kLd, n0, kk * 16, lane);
    mma_bf16(s[0], af, bf[0], bf[1]);
    mma_bf16(s[1], af, bf[2], bf[3]);
    if constexpr (kWithDp) {
      if constexpr (kFromRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) af[i] = dof[kk][i];
      } else {
        ldsm_a(af, sA2, C::kLd, wr, kk * 16, lane);
      }
      ldsm_b(bf, sB2, C::kLd, n0, kk * 16, lane);
      mma_bf16(dp[0], af, bf[0], bf[1]);
      mma_bf16(dp[1], af, bf[2], bf[3]);
    }
  }
}

// acc[2 * dt + i] += a (16 x 16) times the [k][n] tile sB's rows k0.. by
// ldmatrix.trans, over all D columns.
template <int D>
__device__ __forceinline__ void accumulate(float (*acc)[4], const uint32_t a[4], const bf16* sB,
                                           int k0, int lane) {
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) {
    uint32_t b[4];
    ldsm_bt(b, sB, D + 8, k0, dt * 16, lane);
    mma_bf16(acc[2 * dt], a, b[0], b[1]);
    mma_bf16(acc[2 * dt + 1], a, b[2], b[3]);
  }
}

// Rows (r0 + g, r0 + g + 8) of a 16 x D fp32 accumulator to a strided
// [B, N, H, D] bf16 operand; rows >= n are dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride, int row0, int n,
                                           const float (*acc)[4], int t) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < n)
      *reinterpret_cast<uint32_t*>(base + (long long)row0 * row_stride + col) =
          pack_bf16(acc[dt][0], acc[dt][1]);
    if (row0 + 8 < n)
      *reinterpret_cast<uint32_t*>(base + (long long)(row0 + 8) * row_stride + col) =
          pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

// Zeros into rows [r0, min(r0 + rows, n)) of a strided [B, N, H, D] operand.
template <int D, int kThreads>
__device__ __forceinline__ void zero_rows(bf16* base, long long row_stride, int r0, int rows,
                                          int n, int tid) {
  constexpr int kVecPerRow = D / kVec;
  for (int i = tid; i < rows * kVecPerRow; i += kThreads) {
    const int row = r0 + i / kVecPerRow;
    if (row < n)
      *reinterpret_cast<uint4*>(base + (long long)row * row_stride + (i % kVecPerRow) * kVec) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

template <class T>
__device__ __forceinline__ T* at(T* p, const Strides& s, int b, int h) {
  return p + b * s.b + h * s.h;
}

template <class C>
constexpr size_t dq_smem() {
  return sizeof(bf16) * (size_t)(2 * C::kRows + 2 * C::kStages * C::kStep) * C::kLd +
         sizeof(float) * C::kRows;
}

template <class P, class C>
constexpr size_t dkdv_smem() {
  constexpr int kTiles = P::kPrescaled ? 4 : 2;
  return sizeof(bf16) * (size_t)(2 * C::kRows + C::kStages * kTiles * C::kStep) * C::kLd +
         (sizeof(float2) + sizeof(float)) * C::kStages * C::kStep;
}

// ---- the dq kernel -----------------------------------------------------

template <class P, class C>
__device__ __forceinline__ void dq(const Args& a) {
  constexpr int D = C::D, kLd = C::kLd, kRows = C::kRows, kStep = C::kStep;
  constexpr int kSteps = D / 16, kOut = D / 8, kVecPerRow = D / kVec;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // q (scaled in place under TpuPolicy)
  bf16* sDO = sQ + kRows * kLd;
  bf16* sKV = sDO + kRows * kLd;  // [stage][K, V][kStep][kLd]
  float* sDc = reinterpret_cast<float*>(sKV + 2 * C::kStages * kStep * kLd);

  const int n = a.n, kv_len = a.kv_len;
  const int rows_end = P::kPadRowsContribute ? n : kv_len;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * a.heads + h;
  bf16* dqb = at(a.dq, a.dqst, b, h);

  if (q0 >= rows_end) {  // pad query rows only (BundledPolicy): dq = 0
    zero_rows<D, C::kThreads>(dqb, a.dqst.n, q0, kRows, n, tid);
    return;
  }
  const bf16* kb = at(a.k, a.kst, b, h);
  const bf16* vb = at(a.v, a.vst, b, h);
  const int k_end = a.causal ? min(kv_len, q0 + kRows) : kv_len;
  const int n_tiles = (k_end + kStep - 1) / kStep;
  auto load_kv = [&](int stage, int k0) {
    bf16* dst = sKV + stage * 2 * kStep * kLd;
    load_rows<D, C::kThreads>(dst, kb + (long long)k0 * a.kst.n, a.kst.n, 0, kStep, kv_len - k0,
                              tid);
    load_rows<D, C::kThreads>(dst + kStep * kLd, vb + (long long)k0 * a.vst.n, a.vst.n, 0, kStep,
                              kv_len - k0, tid);
  };

  // Owned q and dO (one group), then the first K/V tile (another).
  load_rows<D, C::kThreads>(sQ, at(a.q, a.qst, b, h), a.qst.n, q0, kRows, rows_end, tid);
  load_rows<D, C::kThreads>(sDO, at(a.dout, a.dost, b, h), a.dost.n, q0, kRows, rows_end, tid);
  cp_async_commit();
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  if constexpr (P::kPrescaled) {
    // qs = bf16(q * q_scale) in place and to the scratch; bf16(dO * r) to
    // the scratch; Dc = rowsum(dO * O) in fp32, one warp per row.
    const long long sbh = bh * n * D;  // scratch [B, H, N, D]
    for (int i = tid; i < kRows * kVecPerRow; i += C::kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const int row = q0 + r;
      Vec8 qv, dv;
      qv.u = *reinterpret_cast<const uint4*>(sQ + r * kLd + c);
      dv.u = *reinterpret_cast<const uint4*>(sDO + r * kLd + c);
      const float rr = row < n ? 1.f / a.stats[bh * n + row].y : 0.f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        qv.h[j] = __float2bfloat16_rn(__bfloat162float(qv.h[j]) * a.q_scale);
        dv.h[j] = __float2bfloat16_rn(__bfloat162float(dv.h[j]) * rr);
      }
      *reinterpret_cast<uint4*>(sQ + r * kLd + c) = qv.u;
      if (row < n) {
        *reinterpret_cast<uint4*>(a.qs + sbh + (long long)row * D + c) = qv.u;
        *reinterpret_cast<uint4*>(a.dor + sbh + (long long)row * D + c) = dv.u;
      }
    }
    const bf16* ob = at(a.o, a.ost, b, h);
    for (int r = warp; r < kRows; r += C::kWarps) {
      const int row = q0 + r;
      float acc = 0.f;
      if (row < n)
        for (int c = lane; c < D; c += 32)
          acc += __bfloat162float(sDO[r * kLd + c]) *
                 __bfloat162float(ob[(long long)row * a.ost.n + c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        sDc[r] = acc;
        if (row < n) a.coef[bh * n + row] = acc;
      }
    }
    __syncthreads();
  }

  const int wr = warp * 16;
  const int row_r[2] = {q0 + wr + g, q0 + wr + g + 8};
  uint32_t qf[C::kQRegs ? kSteps : 1][4], dof[C::kQRegs ? kSteps : 1][4];
  if constexpr (C::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      ldsm_a(qf[kk], sQ, kLd, wr, kk * 16, lane);
      ldsm_a(dof[kk], sDO, kLd, wr, kk * 16, lane);
    }
  }
  // Per-row residuals of rows g and g + 8; rows past rows_end get p = 0.
  float m[2], rm[2], cc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = rm[i] = cc[i] = 0.f;
    if (row_r[i] < rows_end) {
      const float2 st = a.stats[bh * n + row_r[i]];
      m[i] = st.x;
      rm[i] = P::row_mul(st.y, a.scale);
      cc[i] = P::kPrescaled ? sDc[wr + g + 8 * i] : a.coef[bh * n + row_r[i]];
    }
  }
  const bool warp_live = q0 + wr < rows_end;
  const int warp_last_row = q0 + wr + 15;

  float acc[kOut][4];
#pragma unroll
  for (int dt = 0; dt < kOut; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kStep;
    if (it + 1 < n_tiles) load_kv((it + 1) & 1, k0 + kStep);  // prefetch the next tile
    cp_async_commit();  // (possibly empty: keeps the wait count uniform)
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tK = sKV + (it & 1) * 2 * kStep * kLd;
    const bf16* tV = tK + kStep * kLd;

#pragma unroll
    for (int ch = 0; ch < kStep / 16; ++ch) {  // 16 keys at a time
      const int kc = k0 + ch * 16;
      if (!warp_live || kc >= kv_len || (a.causal && kc > warp_last_row)) continue;
      float s[2][4], dp[2][4];
      scores<C, true, C::kQRegs>(s, dp, sQ, sDO, qf, dof, wr, tK, tV, ch * 16, lane);
      uint32_t dsf[4];
      // ds of the chunk; `masked` false where no mask reaches it (a copy
      // without the per-element tests)
      auto chunk = [&](bool masked) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int key = kc + j * 8 + 2 * t + (e & 1);
            const bool live = !masked || (key < kv_len && row_r[i] < rows_end &&
                                          (!a.causal || key <= row_r[i]));
            ds[e] = 0.f;
            if (live) {
              const float p = P::prob(P::logit(s[j][e], a.scale), m[i], rm[i]);
              ds[e] = P::dscore(p, dp[j][e], cc[i], rm[i], a.scale);
            }
          }
          dsf[2 * j + 0] = pack_bf16(ds[0], ds[1]);
          dsf[2 * j + 1] = pack_bf16(ds[2], ds[3]);
        }
      };
      if (kc + 16 <= kv_len && q0 + wr + 16 <= rows_end &&
          (!a.causal || kc + 15 <= q0 + wr))
        chunk(false);
      else
        chunk(true);
      accumulate<D>(acc, dsf, tK, ch * 16, lane);  // dq += ds k
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_rows<D>(dqb, a.dqst.n, row_r[0], n, acc, t);
}

// ---- the dk/dv kernel --------------------------------------------------

template <class P, class C>
__device__ __forceinline__ void dkdv(const Args& a) {
  constexpr int D = C::D, kLd = C::kLd, kRows = C::kRows, kStep = C::kStep;
  constexpr int kOut = D / 8;
  constexpr int kTiles = P::kPrescaled ? 4 : 2;  // qs, q, dO, dO * r (or q, dO)
  constexpr int kStageElems = kTiles * kStep * kLd;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kRows * kLd;
  bf16* sS = sV + kRows * kLd;  // [stage][tiles][kStep][kLd]
  float2* sStat = reinterpret_cast<float2*>(sS + C::kStages * kStageElems);  // [stage][kStep]
  float* sCoef = reinterpret_cast<float*>(sStat + C::kStages * kStep);      // [stage][kStep]

  const int n = a.n, kv_len = a.kv_len;
  const int rows_end = P::kPadRowsContribute ? n : kv_len;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * a.heads + h;
  bf16* dkb = at(a.dk, a.dkst, b, h);
  bf16* dvb = at(a.dv, a.dvst, b, h);

  if (k0 >= kv_len) {  // a tile of masked keys: dk = dv = 0 exactly
    zero_rows<D, C::kThreads>(dkb, a.dkst.n, k0, kRows, n, tid);
    zero_rows<D, C::kThreads>(dvb, a.dvst.n, k0, kRows, n, tid);
    return;
  }

  // The query side: q as given (dk), dO (dp) and, under TpuPolicy, the dq
  // kernel's qs (s) and bf16(dO * r) (dv) from the [B, H, N, D] scratch.
  const bf16* qb = at(a.q, a.qst, b, h);
  const bf16* dob = at(a.dout, a.dost, b, h);
  const bf16* qsb = P::kPrescaled ? a.qs + bh * n * D : qb;
  const bf16* dorb = P::kPrescaled ? a.dor + bh * n * D : dob;
  const long long qs_stride = P::kPrescaled ? D : a.qst.n;
  const long long dor_stride = P::kPrescaled ? D : a.dost.n;
  const int q_begin = a.causal ? k0 : 0;
  const int n_tiles = (rows_end - q_begin + kStep - 1) / kStep;
  // tiles of a stage: 0 = s's operand, 1 = dk's, 2 = dp's, 3 = dv's (aliases without prescaling)
  auto tile = [&](int stage, int which) -> bf16* {
    return sS + stage * kStageElems + (P::kPrescaled ? which : which >> 1) * kStep * kLd;
  };
  auto load_q = [&](int stage, int q0, bool for_dk, bool for_dv) {
    const int lim = rows_end - q0;
    load_rows<D, C::kThreads>(tile(stage, 0), qsb + (long long)q0 * qs_stride, qs_stride, 0,
                              kStep, lim, tid);
    if (P::kPrescaled && for_dk)
      load_rows<D, C::kThreads>(tile(stage, 1), qb + (long long)q0 * a.qst.n, a.qst.n, 0, kStep,
                                lim, tid);
    if (!P::kPrescaled || for_dk)
      load_rows<D, C::kThreads>(tile(stage, 2), dob + (long long)q0 * a.dost.n, a.dost.n, 0,
                                kStep, lim, tid);
    if (P::kPrescaled && for_dv)
      load_rows<D, C::kThreads>(tile(stage, 3), dorb + (long long)q0 * dor_stride, dor_stride, 0,
                                kStep, lim, tid);
  };
  // Each streamed row's (m, row_mul(l), coef) read into registers
  // when its tile's copy is issued and stored into the stage's row slots at
  // the end of the iteration before the one that reads them, so the chunk
  // loop takes no reciprocal and no extra barrier is needed.
  struct Row {
    float m, rm, c;
  };
  auto fetch_row = [&](int q0) {
    Row r{0.f, 0.f, 0.f};
    const int row = q0 + tid;
    if (tid < kStep && row < rows_end) {
      const float2 st = a.stats[bh * n + row];
      r = Row{st.x, P::row_mul(st.y, a.scale), a.coef[bh * n + row]};
    }
    return r;
  };
  auto put_row = [&](int stage, const Row& r) {
    if (tid < kStep) {
      sStat[stage * kStep + tid] = make_float2(r.m, r.rm);
      sCoef[stage * kStep + tid] = r.c;
    }
  };

  load_rows<D, C::kThreads>(sK, at(a.k, a.kst, b, h), a.kst.n, k0, kRows, kv_len, tid);
  load_rows<D, C::kThreads>(sV, at(a.v, a.vst, b, h), a.vst.n, k0, kRows, kv_len, tid);
  cp_async_commit();

  const int wr = warp * 16;
  const int key_r[2] = {k0 + wr + g, k0 + wr + g + 8};  // this thread's two keys
  const bool warp_live = k0 + wr < kv_len;
  float acc_a[kOut][4], acc_b[C::kPasses == 1 ? kOut : 1][4];

  for (int pass = 0; pass < C::kPasses; ++pass) {
    const bool do_dk = C::kPasses == 1 || pass == 0;
    const bool do_dv = C::kPasses == 1 || pass == 1;
    // single pass: acc_a = dk, acc_b = dv; two passes: acc_a = dk, then dv
    float (*dk_acc)[4] = acc_a;
    float (*dv_acc)[4] = C::kPasses == 1 ? acc_b : acc_a;
#pragma unroll
    for (int dt = 0; dt < kOut; ++dt) {
      acc_a[dt][0] = acc_a[dt][1] = acc_a[dt][2] = acc_a[dt][3] = 0.f;
      if constexpr (C::kPasses == 1)
        acc_b[dt][0] = acc_b[dt][1] = acc_b[dt][2] = acc_b[dt][3] = 0.f;
    }
    load_q(0, q_begin, do_dk, do_dv);
    put_row(0, fetch_row(q_begin));
    cp_async_commit();

    for (int it = 0; it < n_tiles; ++it) {
      const int q0 = q_begin + it * kStep;
      Row next{0.f, 0.f, 0.f};
      if (it + 1 < n_tiles) {
        load_q((it + 1) & 1, q0 + kStep, do_dk, do_dv);
        next = fetch_row(q0 + kStep);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int stage = it & 1;
      const float2* st = sStat + stage * kStep;
      const float* co = sCoef + stage * kStep;

#pragma unroll
      for (int ch = 0; ch < kStep / 16; ++ch) {  // 16 query rows at a time
        const int qc = q0 + ch * 16;
        if (!warp_live || qc >= rows_end || (a.causal && qc + 15 < k0 + wr)) continue;
        float s[2][4], dp[2][4];
        // s^T = K qs^T, dp^T = V dO^T (keys as rows)
        if (do_dk)
          scores<C, true, false>(s, dp, sK, sV, nullptr, nullptr, wr, tile(stage, 0),
                                 tile(stage, 2), ch * 16, lane);
        else
          scores<C, false, false>(s, dp, sK, sV, nullptr, nullptr, wr, tile(stage, 0),
                                  tile(stage, 2), ch * 16, lane);
        uint32_t pf[4], dsf[4];
        // p and ds of the chunk; `masked` as in the dq kernel
        auto chunk = [&](bool masked) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float p[4], ds[4];
#pragma unroll
            for (int cq = 0; cq < 2; ++cq) {  // this thread's two query columns of n-tile j
              const int qi = ch * 16 + j * 8 + 2 * t + cq;
              const int row = q0 + qi;
              const float2 sr = st[qi];  // (m, row_mul(l)): 0 past rows_end
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int e = 2 * i + cq;
                const int key = key_r[i];
                const bool live =
                    !masked || (key < kv_len && row < rows_end && (!a.causal || key <= row));
                p[e] = ds[e] = 0.f;
                if (live) {
                  p[e] = P::prob(P::logit(s[j][e], a.scale), sr.x, sr.y);
                  ds[e] = P::dscore(p[e], dp[j][e], co[qi], sr.y, a.scale);
                }
              }
            }
            pf[2 * j + 0] = pack_bf16(p[0], p[1]);
            pf[2 * j + 1] = pack_bf16(p[2], p[3]);
            dsf[2 * j + 0] = pack_bf16(ds[0], ds[1]);
            dsf[2 * j + 1] = pack_bf16(ds[2], ds[3]);
          }
        };
        if (k0 + wr + 16 <= kv_len && qc + 16 <= rows_end &&
            (!a.causal || qc >= k0 + wr + 15))
          chunk(false);
        else
          chunk(true);
        if (do_dv) accumulate<D>(dv_acc, pf, tile(stage, 3), ch * 16, lane);   // dv += p^T dO(r)
        if (do_dk) accumulate<D>(dk_acc, dsf, tile(stage, 1), ch * 16, lane);  // dk += ds^T q
      }
      // the next stage was last read before this iteration's barrier
      if (it + 1 < n_tiles) put_row((it + 1) & 1, next);
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
    if (do_dk) store_rows<D>(dkb, a.dkst.n, key_r[0], n, dk_acc, t);
    if (do_dv) store_rows<D>(dvb, a.dvst.n, key_r[0], n, dv_acc, t);
  }
}

// Launch the dq and dk/dv kernels (each a __global__ wrapping dq<P, C> /
// dkdv<P, C>) over (row tiles, heads, batch), in the policy's order.
template <class P, class C>
cudaError_t launch(void (*dq_kernel)(Args), void (*dkdv_kernel)(Args), const Args& a, int batch,
                   cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem<C>();
  constexpr size_t smem_dkdv = dkdv_smem<P, C>();
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + C::kRows - 1) / C::kRows, a.heads, batch);
  for (int i = 0; i < 2; ++i) {
    if ((i == 0) == P::kDqFirst)
      dq_kernel<<<grid, C::kThreads, smem_dq, stream>>>(a);
    else
      dkdv_kernel<<<grid, C::kThreads, smem_dkdv, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Launch `Run::go<Cfg<head_dim>>(a, batch, stream)` for head dim 64, 128
// and 256.  Anything else: cudaErrorInvalidValue, nothing launched.
template <class Run>
int dispatch(int head_dim, const Args& a, int batch, void* stream) {
  if (batch < 1 || a.n < 1 || a.heads < 1 || a.kv_len < 1 || a.kv_len > a.n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)Run::template go<Cfg<64>>(a, batch, s);
  if (head_dim == 128) return (int)Run::template go<Cfg<128>>(a, batch, s);
  if (head_dim == 256) return (int)Run::template go<Cfg<256>>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace bwd
}  // namespace dclip
