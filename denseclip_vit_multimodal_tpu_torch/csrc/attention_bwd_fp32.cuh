// The fp32 attention backward shared by K2 and K3's backward (under the
// TPU `_bwd_kernel`'s numerics) and K4b (under the bundled kernels'), in
// attention_bwd_fp32.cu: the counterpart of attention_fp32.cuh, whose SIMT
// tile products it uses, as attention_bwd.cuh is the bf16 forward's.
// attention_bwd_fp32.cu instantiates `dq<P, D>` and `dkdv<P, D>` in
// __global__ kernels of its own names.  ops/_build.py hashes this header into
// the name of every library built from csrc/.
//
// Replaces, in fp32:
//   * `_bwd_kernel` of the JAX package (denseclip_vit_multimodal_tpu/ops/
//     mha_kernel.py), reached through `_qkv_bwd` -> `_mha_bwd_pallas` (K2)
//     and `_mha_bwd` -> `_mha_bwd_pallas` (K3's backward): `TpuPolicy`;
//   * the bundled `_flash_attention_dkv_kernel` and `_flash_attention_dq_
//     kernel` (jax/experimental/pallas/ops/tpu/flash_attention.py) behind
//     ops/attention.py:130 (K4b): `BundledPolicy`.
//
//   q, k, v, dO [B, N, H, D] fp32 read by stride (unit stride over D, 16-byte
//   aligned rows), D in {64, 128, 256}; stats [B, H, N] float2 from the fp32
//   forward (row max m of the logits in log2 units, row sum l of exp2(s -
//   m)); coef [B, H, N] fp32  ->  dq, dk, dv [B, N, H, D] fp32, by stride.
//
// Numerics, per caller (the policy), every product an fp32 FMA:
//   TpuPolicy (the TPU `_bwd_kernel`'s rounding points in fp32): qs = q *
//     q_scale rounded once (q_scale = scale * log2 e); s = qs k^T, p =
//     exp2(s - m) unnormalised, r = 1 / l; dp = dO v^T; ds = p * (dp - Dc) *
//     (scale * r); dq = ds k, dk = ds^T q (the unscaled q), dv = p^T (dO *
//     r), dO * r rounded once.  Dc = rowsum(dO * O) stands in for the
//     kernel's rowsum(p * dp) * r (the same number up to fp32 rounding): the
//     dq kernel runs first and writes it to `coef`.  The TPU kernel's
//     pad-mass correction of the row sum (pads * exp2(-m) subtracted, floored
//     at 1.2e-7 of that mass) is the exact mask here: the forward never
//     loaded a pad key, so its l holds no pad mass to subtract.  Query rows
//     in [kv_len, N) get dq against the valid keys, and their dO reaches dk
//     / dv of the valid keys.
//   BundledPolicy (the bundled kernels'): s = q k^T from the unscaled q,
//     then bundled_logit(s, scale); p = exp2(s - m) * (1 / l); dv += p^T dO;
//     ds = (dp - di) * p * scale; dk += ds^T q; dq = ds k.  di = rowsum(O *
//     dO) comes from the caller in `coef`.  Pad rows contribute nothing and
//     get dq = 0; keys after the query are masked when `causal`.
//   Both: s is formed as the forward formed it (the same FMAs in the same
//   order), so p is rebuilt from the forward's row max bit for bit; keys >=
//   kv_len are never loaded, get p = 0 and are written dk = dv = 0 exactly;
//   no atomics, so every sum runs in a fixed order and a rerun is bitwise
//   the same.
//
// Design.  The TPU kernels accumulate dk / dv in VMEM across a sequential
// grid axis; Hopper blocks run in no order, so the work is split into two
// kernels on one stream, neither with atomics, at the price of s and dp
// computed in both (seven products where the function needs five), as the
// bf16 core splits it:
//   dq:    one block per (64 query rows, head, batch), owning q (scaled in
//          place under TpuPolicy) and dO in shared memory, a loop over tiles
//          of kStep keys of K and V: s, dp, ds into a shared tile, dq += ds K;
//   dk/dv: one block per (64 keys, head, batch), owning K and V, a loop over
//          tiles of kStep query rows of q and dO with their row terms (m,
//          1 / l, Dc / di): s^T, dp^T, p^T and ds^T into shared tiles, dv +=
//          p^T dO', dk += ds^T q, where dO' = dO * r (TpuPolicy, rounded on
//          the fly) or dO, and s^T reads q * q_scale rounded on the fly.
// Threads and tiles as the forward's (256 threads as 16 x 16, a thread on
// rows ty + 16 i and streamed rows tx + 16 j, its output columns tx * 4 +
// 64 c); a single stage of streamed tiles (shared memory: the owned tiles
// take 2 x 64 rows), two blocks an SM where they fit (D = 64; D = 128 for
// the dq kernel).
//
// Bound on an H100 SXM: five products of N x kv_len x D per (batch, head),
// 10 B H N kv_len D FLOP of fp32 FMA work (halved when causal) at 66.9
// TFLOP/s against a few bytes per element of q, k, v, O, dO, dq, dk, dv:
// operation-bound (K2 at [4, 1664, 2304] valid 1601: 82 GFLOP, 1.22 ms; K4b
// at [2, 9344, 12, 64] valid 9217: 1.30 TFLOP, 19.5 ms), plus the exp2 of
// each score in both kernels.

#pragma once

#include "attention_fp32.cuh"

namespace dclip {
namespace f32 {

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* o;  // TpuPolicy: the forward output (Dc); else unused
  const float* dout;
  const float2* stats;  // [B, H, N]
  float* coef;          // [B, H, N]: Dc (written by the dq kernel) or di (given)
  float* dq;
  float* dk;
  float* dv;
  Strides qst, kst, vst, ost, dost, dqst, dkst, dvst;
  int n, heads, kv_len, causal;
  float q_scale;  // TpuPolicy: scale * log2 e
  float scale;    // the softmax scale
};

// The TPU `_bwd_kernel`'s arithmetic (K2, K3's backward).
struct TpuBwd {
  static constexpr bool kPrescaled = true;  // s from q * q_scale; dv from dO * r
  static constexpr bool kDqFirst = true;
  static constexpr bool kPadRowsContribute = true;
  // The per-row multiplier of ds from r = 1 / l.
  __device__ static float row_mul(float r, float scale) { return scale * r; }
  __device__ static float logit(float s, float) { return s; }
  __device__ static float prob(float s, float m, float) { return exp2f(s - m); }
  __device__ static float dscore(float p, float dp, float c, float rm, float) {
    return p * (dp - c) * rm;
  }
};

// TpuBwd under DENSECLIP_FAST_EXP2: p rebuilt by JAX's polynomial from the
// forward's final row max (softmax_exp.cuh), whose row sum the forward
// under the same knob wrote.
struct TpuPolyBwd : TpuBwd {
  __device__ static float prob(float s, float m, float) { return softmax::exp2_poly(s - m); }
};

// The bundled flash kernels' arithmetic (K4b).
struct BundledBwd {
  static constexpr bool kPrescaled = false;
  static constexpr bool kDqFirst = false;
  static constexpr bool kPadRowsContribute = false;
  __device__ static float row_mul(float r, float) { return r; }
  __device__ static float logit(float s, float scale) { return bundled_logit(s, scale); }
  __device__ static float prob(float s, float m, float r) { return exp2f(s - m) * r; }
  __device__ static float dscore(float p, float dp, float c, float, float scale) {
    return (dp - c) * p * scale;
  }
};

template <int D>
struct BwdCfg {
  static constexpr int kDqMinBlocks = D <= 128 ? 2 : 1;
  static constexpr int kDkdvMinBlocks = D <= 64 ? 2 : 1;
};

template <int D>
constexpr size_t dq_smem() {
  using C = Cfg<D>;
  return sizeof(float) * (size_t)((2 * kRows + 2 * C::kStep) * C::kLd + kRows * C::kLdS);
}

template <int D>
constexpr size_t dkdv_smem() {
  using C = Cfg<D>;
  return sizeof(float) *
         (size_t)((2 * kRows + 2 * C::kStep) * C::kLd + 3 * C::kStep + 2 * kRows * C::kLdS);
}

// Zeros into rows [r0, min(r0 + rows, n)) of a strided fp32 [B, N, H, D] operand.
template <int D>
__device__ __forceinline__ void zero_rows(float* base, long long row_stride, int r0, int rows,
                                          int n, int tid) {
  constexpr int kVecPerRow = D / 4;
  for (int i = tid; i < rows * kVecPerRow; i += kThreads) {
    const int row = r0 + i / kVecPerRow;
    if (row < n)
      *reinterpret_cast<float4*>(base + (long long)row * row_stride + (i % kVecPerRow) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ---- the dq kernel -----------------------------------------------------

template <class P, int D>
__device__ __forceinline__ void dq(const BwdArgs& a) {
  using C = Cfg<D>;
  constexpr int kLd = C::kLd, kStep = C::kStep, TN = C::TN, kLdS = C::kLdS, NC = C::NC;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kRows][kLd] (scaled under TpuBwd)
  float* sDO = sQ + kRows * kLd;                   // [kRows][kLd]
  float* sK = sDO + kRows * kLd;                   // [kStep][kLd]
  float* sV = sK + kStep * kLd;                    // [kStep][kLd]
  float* sDS = sV + kStep * kLd;                   // [kRows][kLdS]

  const int n = a.n, kv_len = a.kv_len;
  const int rows_end = P::kPadRowsContribute ? n : kv_len;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long bh = (long long)b * a.heads + h;
  float* dqb = at(a.dq, a.dqst, b, h);

  if (q0 >= rows_end) {  // pad query rows only (BundledBwd): dq = 0
    zero_rows<D>(dqb, a.dqst.n, q0, kRows, n, tid);
    return;
  }
  load_rows<D>(sQ, at(a.q, a.qst, b, h) + (long long)q0 * a.qst.n, a.qst.n, kRows,
               rows_end - q0, tid);
  load_rows<D>(sDO, at(a.dout, a.dost, b, h) + (long long)q0 * a.dost.n, a.dost.n, kRows,
               rows_end - q0, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Per owned row (this half-warp's rows only): the scaled q, the residuals
  // and, under TpuBwd, Dc = rowsum(dO * O), written for the dk/dv kernel.
  int row_of[TM];
  float m[TM], rm[TM], cc[TM];
  const float* ob = P::kPrescaled ? at(a.o, a.ost, b, h) : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row_of[i] = q0 + ty + 16 * i;
    const bool live = row < rows_end;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx * 4 + 64 * c;
      float* qp = sQ + (ty + 16 * i) * kLd + col;
      if constexpr (P::kPrescaled) {
        *reinterpret_cast<float4*>(qp) = mul4(ld4(qp), a.q_scale);
        if (live) {
          const float4 d4 = ld4(sDO + (ty + 16 * i) * kLd + col);
          const float4 o4 = ld4(ob + (long long)row * a.ost.n + col);
          part = fmaf(d4.x, o4.x, part);
          part = fmaf(d4.y, o4.y, part);
          part = fmaf(d4.z, o4.z, part);
          part = fmaf(d4.w, o4.w, part);
        }
      }
    }
    m[i] = rm[i] = cc[i] = 0.f;
    float dc = 0.f;
    if constexpr (P::kPrescaled) dc = row_sum(part);
    if (live) {
      const float2 st = a.stats[bh * n + row];
      m[i] = st.x;
      rm[i] = P::row_mul(1.f / st.y, a.scale);
      cc[i] = P::kPrescaled ? dc : a.coef[bh * n + row];
      if (P::kPrescaled && tx == 0) a.coef[bh * n + row] = dc;
    }
  }
  __syncwarp();

  float acc[TM][4 * NC];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) acc[i][e] = 0.f;

  const float* kb = at(a.k, a.kst, b, h);
  const float* vb = at(a.v, a.vst, b, h);
  const int k_end = a.causal ? min(kv_len, q0 + kRows) : kv_len;
  for (int k0 = 0; k0 < k_end; k0 += kStep) {
    load_rows<D>(sK, kb + (long long)k0 * a.kst.n, a.kst.n, kStep, kv_len - k0, tid);
    load_rows<D>(sV, vb + (long long)k0 * a.vst.n, a.vst.n, kStep, kv_len - k0, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_nt<TN, D, false>(s, sQ, kLd, sK, kLd, ty, tx, 0.f);
    mm_nt<TN, D, false>(dp, sDO, kLd, sV, kLd, ty, tx, 0.f);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool live = key < kv_len && row_of[i] < rows_end &&
                          (!a.causal || key <= row_of[i]);
        float ds = 0.f;
        if (live) {
          const float p = P::prob(P::logit(s[i][j], a.scale), m[i], rm[i]);
          ds = P::dscore(p, dp[i][j], cc[i], rm[i], a.scale);
        }
        sDS[(ty + 16 * i) * kLdS + tx + 16 * j] = ds;
      }
    __syncwarp();  // a half-warp reads back only the ds rows it wrote
    mm_nn<NC, kStep, false>(acc, sDS, kLdS, sK, kLd, ty, tx, nullptr);  // dq += ds k
    __syncthreads();  // every warp is done with the tile before it is refilled
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
    if (row_of[i] < n) store_row<NC>(dqb, a.dqst.n, row_of[i], acc[i], tx);
}

// ---- the dk/dv kernel --------------------------------------------------

template <class P, int D>
__device__ __forceinline__ void dkdv(const BwdArgs& a) {
  using C = Cfg<D>;
  constexpr int kLd = C::kLd, kStep = C::kStep, TN = C::TN, kLdS = C::kLdS, NC = C::NC;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [kRows][kLd]
  float* sV = sK + kRows * kLd;                    // [kRows][kLd]
  float* sQ = sV + kRows * kLd;                    // [kStep][kLd], unscaled
  float* sDO = sQ + kStep * kLd;                   // [kStep][kLd]
  float* sM = sDO + kStep * kLd;                   // [kStep] row max
  float* sR = sM + kStep;                          // [kStep] 1 / row sum
  float* sC = sR + kStep;                          // [kStep] Dc / di
  float* sPT = sC + kStep;                         // [kRows][kLdS]: p^T (keys as rows)
  float* sDST = sPT + kRows * kLdS;                // [kRows][kLdS]: ds^T

  const int n = a.n, kv_len = a.kv_len;
  const int rows_end = P::kPadRowsContribute ? n : kv_len;
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long bh = (long long)b * a.heads + h;
  float* dkb = at(a.dk, a.dkst, b, h);
  float* dvb = at(a.dv, a.dvst, b, h);

  if (k0 >= kv_len) {  // a tile of masked keys: dk = dv = 0 exactly
    zero_rows<D>(dkb, a.dkst.n, k0, kRows, n, tid);
    zero_rows<D>(dvb, a.dvst.n, k0, kRows, n, tid);
    return;
  }
  load_rows<D>(sK, at(a.k, a.kst, b, h) + (long long)k0 * a.kst.n, a.kst.n, kRows, kv_len - k0,
               tid);
  load_rows<D>(sV, at(a.v, a.vst, b, h) + (long long)k0 * a.vst.n, a.vst.n, kRows, kv_len - k0,
               tid);
  cp_async_commit();

  int key_of[TM];
  float dk_acc[TM][4 * NC], dv_acc[TM][4 * NC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    key_of[i] = k0 + ty + 16 * i;
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  }

  const float* qb = at(a.q, a.qst, b, h);
  const float* dob = at(a.dout, a.dost, b, h);
  const int q_begin = a.causal ? k0 : 0;
  for (int q0 = q_begin; q0 < rows_end; q0 += kStep) {
    load_rows<D>(sQ, qb + (long long)q0 * a.qst.n, a.qst.n, kStep, rows_end - q0, tid);
    load_rows<D>(sDO, dob + (long long)q0 * a.dost.n, a.dost.n, kStep, rows_end - q0, tid);
    cp_async_commit();
    if (tid < kStep) {  // the streamed rows' terms; 0 past rows_end
      const int row = q0 + tid;
      float mm = 0.f, r = 0.f, c = 0.f;
      if (row < rows_end) {
        const float2 st = a.stats[bh * n + row];
        mm = st.x;
        r = 1.f / st.y;
        c = a.coef[bh * n + row];
      }
      sM[tid] = mm;
      sR[tid] = r;
      sC[tid] = c;
    }
    cp_async_wait<0>();
    __syncthreads();

    float sT[TM][TN], dpT[TM][TN];  // keys as rows, streamed rows as columns
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sT[i][j] = dpT[i][j] = 0.f;
    mm_nt<TN, D, P::kPrescaled>(sT, sK, kLd, sQ, kLd, ty, tx, a.q_scale);
    mm_nt<TN, D, false>(dpT, sV, kLd, sDO, kLd, ty, tx, 0.f);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int qi = tx + 16 * j;
      const int row = q0 + qi;
      const float mm = sM[qi], rm = P::row_mul(sR[qi], a.scale), c = sC[qi];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int key = key_of[i];
        const bool live = key < kv_len && row < rows_end && (!a.causal || key <= row);
        float p = 0.f, ds = 0.f;
        if (live) {
          p = P::prob(P::logit(sT[i][j], a.scale), mm, rm);
          ds = P::dscore(p, dpT[i][j], c, rm, a.scale);
        }
        sPT[(ty + 16 * i) * kLdS + qi] = p;
        sDST[(ty + 16 * i) * kLdS + qi] = ds;
      }
    }
    __syncwarp();  // a half-warp reads back only the rows it wrote
    mm_nn<NC, kStep, P::kPrescaled>(dv_acc, sPT, kLdS, sDO, kLd, ty, tx, sR);  // dv += p^T dO'
    mm_nn<NC, kStep, false>(dk_acc, sDST, kLdS, sQ, kLd, ty, tx, nullptr);     // dk += ds^T q
    __syncthreads();  // every warp is done with the tiles before they are refilled
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int key = key_of[i];
    if (key >= n) continue;
    if (key >= kv_len) {  // a masked key: exactly 0, whatever the query side held
#pragma unroll
      for (int e = 0; e < 4 * NC; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
    }
    store_row<NC>(dkb, a.dkst.n, key, dk_acc[i], tx);
    store_row<NC>(dvb, a.dvst.n, key, dv_acc[i], tx);
  }
}

// Launch the dq and dk/dv kernels (each a __global__ wrapping dq<P, D> /
// dkdv<P, D>) over (row tiles, heads, batch), in the policy's order.
template <class P, int D>
cudaError_t launch_bwd(void (*dq_kernel)(BwdArgs), void (*dkdv_kernel)(BwdArgs),
                       const BwdArgs& a, int batch, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem<D>();
  constexpr size_t smem_dkdv = dkdv_smem<D>();
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kRows - 1) / kRows, a.heads, batch);
  for (int i = 0; i < 2; ++i) {
    if ((i == 0) == P::kDqFirst)
      dq_kernel<<<grid, kThreads, smem_dq, stream>>>(a);
    else
      dkdv_kernel<<<grid, kThreads, smem_dkdv, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace f32
}  // namespace dclip
