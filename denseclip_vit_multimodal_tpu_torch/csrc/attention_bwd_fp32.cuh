// The fp32 attention backward shared by K2 and K3's backward (under the
// TPU `_bwd_kernel`'s numerics) and K4b (under the bundled kernels'), in
// attention_bwd_fp32.cu: the fp32 counterpart of attention_bwd.cuh, on the
// tensor cores by 3xTF32 (mma_tf32.cuh).  attention_bwd_fp32.cu
// instantiates `dq<P, C>` and `dkdv<P, C>` in __global__ kernels of its own
// names.  ops/_build.py hashes this header into the name of every library
// built from csrc/.
//
// Replaces, in fp32:
//   * `_bwd_kernel` of the JAX package (denseclip_vit_multimodal_tpu/ops/
//     mha_kernel.py), reached through `_qkv_bwd` -> `_mha_bwd_pallas` (K2)
//     and `_mha_bwd` -> `_mha_bwd_pallas` (K3's backward): `TpuBwd`;
//   * the bundled `_flash_attention_dkv_kernel` and `_flash_attention_dq_
//     kernel` (jax/experimental/pallas/ops/tpu/flash_attention.py) behind
//     ops/attention.py:130 (K4b): `BundledBwd`.
//
//   q, k, v, dO [B, N, H, D] fp32 read by stride (unit stride over D, 16-byte
//   aligned rows), D in {64, 128, 256}; stats [B, H, N] float2 from the fp32
//   forward (row max m of the logits in log2 units, row sum l of exp2(s -
//   m)); coef [B, H, N] fp32  ->  dq, dk, dv [B, N, H, D] fp32, by stride.
//
// Numerics, per caller (the policy); every product is 3xTF32 (mma_tf32.cuh:
// each operand split into a TF32 high part and the remainder, three TF32
// products summed into fp32, about 2^-21 of each term lost; the long sums,
// dq over the keys and dk / dv over the query rows, add each step's three
// products to their accumulator with one fp32 rounding to nearest, since
// the tensor cores truncate where they accumulate):
//   TpuBwd (the TPU `_bwd_kernel`'s rounding points in fp32): qs = q *
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
//   BundledBwd (the bundled kernels'): s = q k^T from the unscaled q,
//     then bundled_logit(s, scale); p = exp2(s - m) * (1 / l); dv += p^T dO;
//     ds = (dp - di) * p * scale; dk += ds^T q; dq = ds k.  di = rowsum(O *
//     dO) comes from the caller in `coef`.  Pad rows contribute nothing and
//     get dq = 0; keys after the query are masked when `causal`.
//   Both: s is formed from the same operands as the forward's
//   (attention_fp32.cuh), also by 3xTF32 but summed in another order, so it
//   may differ from the forward's in its last bits and p = exp2(s - m) from the
//   forward's max by about as much (a few 1e-7 relative): the gradients stay
//   within the fp32 limits (rel. L2 1e-4).  Keys >= kv_len are never
//   loaded, get p = 0 and are written dk = dv = 0 exactly; no atomics, so
//   every sum runs in a fixed order and a rerun is bitwise the same.
//
// Design.  The TPU kernels accumulate dk / dv in VMEM across a sequential
// grid axis; Hopper blocks run in no order, so the work is split into two
// kernels on one stream, neither with atomics, at the price of s and dp
// computed in both (seven products where the function needs five), as the
// bf16 core (attention_bwd.cuh) splits it:
//   dq:    one block per (kRows query rows, head, batch), owning q (scaled
//          in place under TpuBwd) and dO, a loop over kStep-key tiles of K
//          and V: s, dp, ds, dq += ds K;
//   dk/dv: one block per (kRows keys, head, batch), owning K and V, a loop
//          over kStep-row tiles of q and dO with their row terms (m, scale
//          * r or r, Dc or di, r): s^T, dp^T, p^T, ds^T, dv += p^T dO', dk +=
//          ds^T q, where dO' = dO * r rounded on the fly (TpuBwd) or dO, and
//          s^T reads q * q_scale rounded on the fly.
// Every product is mma.sync m16n8k8 on TF32, three per product (3xTF32),
// each warp on 16 owned rows (the mma's M).  What the design does:
//   * not wgmma: TF32 wgmma reads A and B K-major only, and dq = ds K,
//     dv = p^T dO' and dk = ds^T q read their B MN-major from a row-major
//     [rows, D] tile; mma.sync takes its fragments by 32-bit shared loads in
//     either orientation, so each tile is one plain fp32 copy;
//   * rows padded to D + 4 floats (4 mod 32 banks): a K-major fragment
//     (lanes g on rows, t on columns) hits banks 4g + t, and an MN-major one
//     reads its k rows 2t and 2t + 1 (lanes t on rows, g on columns: banks
//     8t + g), both without conflicts;
//   * that k order (mma k index t <-> row 2t, t + 4 <-> 2t + 1) is also the
//     column order of the C fragment, so the s / dp fragments of an 8-key
//     n-tile become ds's (p's) A fragment of an 8-deep k-step in registers:
//     p and ds never touch shared memory;
//   * operands are split into high part and remainder in registers after
//     each fragment load (the owned tiles' A fragments once per k-step and
//     tile, shared by every n-tile of the tile), so shared memory holds plain
//     fp32 tiles; p and ds are split once, as A fragments.  The split is
//     three instructions an element (mma_tf32.cuh); with cvt.rna for both
//     parts (nine) it took 30% of the time (PERF.md);
//   * the streamed tiles run through a two-stage ring of 16-byte cp.async
//     copies (tile t + 1 loads while tile t is multiplied); the s / dp
//     products run k-step outer over all n-tiles of the tile (independent
//     mma chains);
//   * warps skip the 8-row n-tiles that masks empty (causal, ragged ends)
//     and take a copy of the softmax step without per-element mask tests
//     where no mask reaches the tile; the dk/dv kernel takes each streamed
//     row's terms once per tile (fetched with the tile's copy, stored into
//     the stage's row slots after the previous use).
// Tiling (BwdCfg): 8 warps on 128 rows at D <= 128.  The dq kernel streams
// 32-key tiles; at D = 64 it takes 121 registers and 103 KB, so two blocks
// share an SM.  The dk/dv kernel streams 64-row tiles at D = 64 (each K / V
// fragment split once for eight n-tiles; 32-row tiles and two or three
// blocks an SM measured slower) and 32-row tiles at D = 128, one block an
// SM (137-199 KB).  At D = 256 16 rows x 256 of dk and dv in fp32 would
// take 256 registers a thread, over the cap of 255, so a dk/dv block makes
// two passes over the query side (dk, then dv: eight products where D <=
// 128 does seven), on 4 warps over 64 rows with 32-row streamed tiles; two
// 64 x 256 owned tiles take 130 KB there, and a second stage of the
// streamed tiles does not fit beside them, so D = 256 runs a single stage
// (copy, wait, multiply).  A warp on two m-tiles (each K / V fragment
// serving both) and sums of several k-steps before each rounding add both
// measured slower: their registers spill.
//
// Bound on an H100 SXM: five products of N x kv_len x D per (batch, head),
// 10 B H N kv_len D FLOP (halved when causal) against a few bytes per
// element of q, k, v, O, dO, dq, dk, dv: operation-bound.  Under 3xTF32
// the ceiling is a third of the 495 TFLOP/s TF32 rate, 165 TFLOP/s (K2 at
// [4, 1664, 2304] valid 1601: 82 GFLOP, 0.496 ms; K4b at [2, 9344, 12, 64]
// valid 9217: 1.30 TFLOP, 7.91 ms); at the fp32 FMA peak of 66.9 TFLOP/s it
// would be 1.22 and 19.5 ms.  Plus the exp2 of each score in both kernels.

#pragma once

#include "bundled_logit.cuh"
#include "mma_bf16.cuh"  // cp_async16, cp_async_commit, cp_async_wait
#include "softmax_exp.cuh"
#include "tf32_frag.cuh"  // mma_tf32.cuh and the fragment helpers

namespace dclip {
namespace f32bwd {

struct Strides {  // in elements
  long long b, n, h;
};

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* o;  // TpuBwd: the forward output (Dc); else unused
  const float* dout;
  const float2* stats;  // [B, H, N]
  float* coef;          // [B, H, N]: Dc (written by the dq kernel) or di (given)
  float* dq;
  float* dk;
  float* dv;
  Strides qst, kst, vst, ost, dost, dqst, dkst, dvst;
  int n, heads, kv_len, causal;
  float q_scale;  // TpuBwd: scale * log2 e
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

// A kernel's tiling: kWarps warps on 16 rows each (kRows rows a block
// owns), kStep-row streamed tiles in a ring of kStages, kMinBlocks blocks
// an SM (the launch bound).
template <int D_, int kWarps_, int kStep_, int kStages_, int kMinBlocks_>
struct Tiles {
  static constexpr int D = D_, kWarps = kWarps_, kStep = kStep_, kStages = kStages_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kPasses = D_ > 128 ? 2 : 1;  // dk/dv: dk, then dv (D = 256)
  static constexpr int kLd = D_ + 4;                // padded fp32 row: 4 mod 32 banks
  static constexpr int NT = kStep / 8;              // 8-row n-tiles of a streamed tile
  static constexpr int kOut = D_ / 8;               // 8-column n-tiles of an output row
  static_assert(kRows % kStep == 0, "causal loops start at the block's first row");
};

// The tilings per head dim (the header note says why).
template <int D>
struct BwdCfg {
  static constexpr int kStages = D > 128 ? 1 : 2;
  using Dq = Tiles<D, (D > 128 ? 4 : 8), 32, kStages, (D == 64 ? 2 : 1)>;
  using Dkdv = Tiles<D, (D > 128 ? 4 : 8), (D == 64 ? 64 : 32), kStages, 1>;
};

template <class C>
constexpr size_t dq_smem() {
  return sizeof(float) * ((size_t)(2 * C::kRows + 2 * C::kStages * C::kStep) * C::kLd + C::kRows);
}

template <class C>
constexpr size_t dkdv_smem() {
  return sizeof(float) *
         ((size_t)(2 * C::kRows + 2 * C::kStages * C::kStep) * C::kLd + 4 * C::kStages * C::kStep);
}

template <class T>
__device__ __forceinline__ T* at(T* p, const Strides& s, int b, int h) {
  return p + b * s.b + h * s.h;
}

// Rows [0, rows) of a [B, N, H, D] operand at `base` (its first row) into a
// padded shared tile by 16-byte cp.async; rows >= lim are zero-filled and
// never read.
template <class C>
__device__ __forceinline__ void load_rows(float* dst, const float* base, long long row_stride,
                                          int rows, int lim, int tid) {
  constexpr int kVecPerRow = C::D / 4;
  for (int i = tid; i < rows * kVecPerRow; i += C::kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    const bool ok = r < lim;
    cp_async16(dst + r * C::kLd + c, base + (long long)(ok ? r : 0) * row_stride + c,
               ok ? 16 : 0);
  }
}

// Zeros into rows [r0, min(r0 + rows, n)) of a strided fp32 [B, N, H, D] operand.
template <class C>
__device__ __forceinline__ void zero_rows(float* base, long long row_stride, int r0, int rows,
                                          int n, int tid) {
  constexpr int kVecPerRow = C::D / 4;
  for (int i = tid; i < rows * kVecPerRow; i += C::kThreads) {
    const int row = r0 + i / kVecPerRow;
    if (row < n)
      *reinterpret_cast<float4*>(base + (long long)row * row_stride + (i % kVecPerRow) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ---- fragments: frag_a, frag_b_nk, frag_b_kn, c_as_a (tf32_frag.cuh) ----

// Rows (r0 + g, r0 + g + 8) of a 16 x D accumulator (c0, c1 of row g at
// columns 8 dt + 2t, + 1) to a strided [B, N, H, D] fp32 operand; rows >= n
// are dropped, rows >= zero_from written 0.
template <int kOut>
__device__ __forceinline__ void store_rows(float* base, long long row_stride, int r0, int n,
                                           int zero_from, const float (*acc)[4], int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= n) continue;
    const bool zero = row >= zero_from;
    float* dst = base + (long long)row * row_stride + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kOut; ++dt)
      *reinterpret_cast<float2*>(dst + 8 * dt) =
          zero ? make_float2(0.f, 0.f) : make_float2(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
}

// ---- the dq kernel -----------------------------------------------------

template <class P, class C>
__device__ __forceinline__ void dq(const BwdArgs& a) {
  constexpr int D = C::D, kLd = C::kLd, kRows = C::kRows, kStep = C::kStep;
  constexpr int NT = C::NT, kOut = C::kOut, kStages = C::kStages;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kRows][kLd] (scaled under TpuBwd)
  float* sDO = sQ + kRows * kLd;                   // [kRows][kLd]
  float* sKV = sDO + kRows * kLd;                  // [stage][K, V][kStep][kLd]
  float* sDc = sKV + kStages * 2 * kStep * kLd;    // [kRows]

  const int n = a.n, kv_len = a.kv_len;
  const int rows_end = P::kPadRowsContribute ? n : kv_len;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * a.heads + h;
  float* dqb = at(a.dq, a.dqst, b, h);

  if (q0 >= rows_end) {  // pad query rows only (BundledBwd): dq = 0
    zero_rows<C>(dqb, a.dqst.n, q0, kRows, n, tid);
    return;
  }
  const float* kb = at(a.k, a.kst, b, h);
  const float* vb = at(a.v, a.vst, b, h);
  const int k_end = a.causal ? min(kv_len, q0 + kRows) : kv_len;
  const int n_tiles = (k_end + kStep - 1) / kStep;
  auto issue = [&](int it) {  // tile `it` of K and V into its stage (one group, maybe empty)
    if (it < n_tiles) {
      float* dst = sKV + (it % kStages) * 2 * kStep * kLd;
      const int k0 = it * kStep;
      load_rows<C>(dst, kb + (long long)k0 * a.kst.n, a.kst.n, kStep, kv_len - k0, tid);
      load_rows<C>(dst + kStep * kLd, vb + (long long)k0 * a.vst.n, a.vst.n, kStep,
                   kv_len - k0, tid);
    }
    cp_async_commit();
  };

  // Owned q and dO (one group), then the ring's first tiles.
  load_rows<C>(sQ, at(a.q, a.qst, b, h) + (long long)q0 * a.qst.n, a.qst.n, kRows,
               rows_end - q0, tid);
  load_rows<C>(sDO, at(a.dout, a.dost, b, h) + (long long)q0 * a.dost.n, a.dost.n, kRows,
               rows_end - q0, tid);
  cp_async_commit();
  for (int s = 0; s + 1 < kStages; ++s) issue(s);
  cp_async_wait<kStages - 1>();  // the owned tiles have landed (this thread's copies)
  __syncthreads();

  if constexpr (P::kPrescaled) {
    // qs = q * q_scale rounded, in place; Dc = rowsum(dO * O), a warp a row,
    // written for the dk/dv kernel.
    for (int i = tid; i < kRows * (D / 4); i += C::kThreads) {
      float4* p = reinterpret_cast<float4*>(sQ + (i / (D / 4)) * kLd + (i % (D / 4)) * 4);
      const float4 x = *p;
      *p = make_float4(__fmul_rn(x.x, a.q_scale), __fmul_rn(x.y, a.q_scale),
                       __fmul_rn(x.z, a.q_scale), __fmul_rn(x.w, a.q_scale));
    }
    const float* ob = at(a.o, a.ost, b, h);
    for (int r = warp; r < kRows; r += C::kWarps) {
      const int row = q0 + r;
      float acc = 0.f;
      if (row < rows_end)
        for (int c = lane; c < D; c += 32)
          acc = fmaf(sDO[r * kLd + c], ob[(long long)row * a.ost.n + c], acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        sDc[r] = acc;
        if (row < rows_end) a.coef[bh * n + row] = acc;
      }
    }
    __syncthreads();
  }

  // This thread's rows g and g + 8 of the warp's 16: their residuals (0
  // past rows_end, where every score is masked).
  const int wr = warp * 16;
  const int row_r[2] = {q0 + wr + g, q0 + wr + g + 8};
  float m[2], rm[2], cc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = rm[i] = cc[i] = 0.f;
    if (row_r[i] < rows_end) {
      const float2 st = a.stats[bh * n + row_r[i]];
      m[i] = st.x;
      rm[i] = P::row_mul(1.f / st.y, a.scale);
      cc[i] = P::kPrescaled ? sDc[wr + g + 8 * i] : a.coef[bh * n + row_r[i]];
    }
  }
  const bool warp_live = q0 + wr < rows_end;
  const int key_lim = a.causal ? min(kv_len, q0 + wr + 16) : kv_len;  // the warp's live keys

  float acc[kOut][4];
#pragma unroll
  for (int dt = 0; dt < kOut; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    issue(it + kStages - 1);  // into the stage the previous iteration released
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* tK = sKV + (it % kStages) * 2 * kStep * kLd;
    const float* tV = tK + kStep * kLd;
    const int k0 = it * kStep;
    // n-tiles of 8 keys holding a live key of the warp's rows
    const int live = warp_live ? min(NT, (key_lim - k0 + 7) / 8) : 0;
    if (live > 0) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      // s = qs K^T, dp = dO V^T: k-step outer, every live n-tile inner
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        const FragA qa = frag_a<kLd>(sQ, wr, 8 * kk, g, t);
        const FragA da = frag_a<kLd>(sDO, wr, 8 * kk, g, t);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j >= live) continue;
          mma_3xtf32(s[j], qa, frag_b_nk<kLd>(tK, 8 * j, 8 * kk, g, t));
          mma_3xtf32(dp[j], da, frag_b_nk<kLd>(tV, 8 * j, 8 * kk, g, t));
        }
      }
      // ds over s's registers; `masked` false where no mask reaches the tile
      auto softmax_step = [&](bool masked) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const bool ok = !masked || (key < kv_len && row_r[i] < rows_end &&
                                        (!a.causal || key <= row_r[i]));
            float ds = 0.f;
            if (ok) {
              const float p = P::prob(P::logit(s[j][e], a.scale), m[i], rm[i]);
              ds = P::dscore(p, dp[j][e], cc[i], rm[i], a.scale);
            }
            s[j][e] = ds;
          }
      };
      if (k0 + kStep <= kv_len && q0 + wr + 16 <= rows_end &&
          (!a.causal || k0 + kStep - 1 <= q0 + wr))
        softmax_step(false);
      else
        softmax_step(true);
      // dq += ds K: ds's n-tile j is the k-step over keys k0 + 8j..
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= live) continue;
        const FragA dsa = c_as_a(s[j]);
#pragma unroll
        for (int dt = 0; dt < kOut; ++dt)
          mma_3xtf32_rn(acc[dt], dsa, frag_b_kn<kLd>(tK, 8 * j, 8 * dt, g, t));
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_rows<kOut>(dqb, a.dqst.n, row_r[0], n, n, acc, t);
}

// ---- the dk/dv kernel --------------------------------------------------

template <class P, class C>
__device__ __forceinline__ void dkdv(const BwdArgs& a) {
  constexpr int D = C::D, kLd = C::kLd, kRows = C::kRows, kStep = C::kStep;
  constexpr int NT = C::NT, kOut = C::kOut, kStages = C::kStages;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [kRows][kLd]
  float* sV = sK + kRows * kLd;                    // [kRows][kLd]
  float* sS = sV + kRows * kLd;                    // [stage][q, dO][kStep][kLd], q unscaled
  float* sRow = sS + kStages * 2 * kStep * kLd;    // [stage][m, rm, c, r][kStep]

  const int n = a.n, kv_len = a.kv_len;
  const int rows_end = P::kPadRowsContribute ? n : kv_len;
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * a.heads + h;
  float* dkb = at(a.dk, a.dkst, b, h);
  float* dvb = at(a.dv, a.dvst, b, h);

  if (k0 >= kv_len) {  // a tile of masked keys: dk = dv = 0 exactly
    zero_rows<C>(dkb, a.dkst.n, k0, kRows, n, tid);
    zero_rows<C>(dvb, a.dvst.n, k0, kRows, n, tid);
    return;
  }
  load_rows<C>(sK, at(a.k, a.kst, b, h) + (long long)k0 * a.kst.n, a.kst.n, kRows, kv_len - k0,
               tid);
  load_rows<C>(sV, at(a.v, a.vst, b, h) + (long long)k0 * a.vst.n, a.vst.n, kRows, kv_len - k0,
               tid);
  cp_async_commit();

  const float* qb = at(a.q, a.qst, b, h);
  const float* dob = at(a.dout, a.dost, b, h);
  const int q_begin = a.causal ? k0 : 0;
  const int n_tiles = (rows_end - q_begin + kStep - 1) / kStep;
  // A streamed row's terms (m, row_mul(r), Dc / di, r), 0 past rows_end.
  struct Row {
    float m, rm, c, r;
  };
  // Tile `it` of q and dO into its stage (one group, maybe empty); its rows'
  // terms are returned (thread tid < kStep: row tid) for put_row.
  auto issue = [&](int it) {
    Row r{0.f, 0.f, 0.f, 0.f};
    if (it < n_tiles) {
      const int q0 = q_begin + it * kStep;
      float* dst = sS + (it % kStages) * 2 * kStep * kLd;
      load_rows<C>(dst, qb + (long long)q0 * a.qst.n, a.qst.n, kStep, rows_end - q0, tid);
      load_rows<C>(dst + kStep * kLd, dob + (long long)q0 * a.dost.n, a.dost.n, kStep,
                   rows_end - q0, tid);
      const int row = q0 + tid;
      if (tid < kStep && row < rows_end) {
        const float2 st = a.stats[bh * n + row];
        const float rr = 1.f / st.y;
        r = Row{st.x, P::row_mul(rr, a.scale), a.coef[bh * n + row], rr};
      }
    }
    cp_async_commit();
    return r;
  };
  auto put_row = [&](int stage, const Row& r) {
    if (tid < kStep) {
      float* dst = sRow + stage * 4 * kStep + tid;
      dst[0] = r.m;
      dst[kStep] = r.rm;
      dst[2 * kStep] = r.c;
      dst[3 * kStep] = r.r;
    }
  };

  const int wr = warp * 16, kw = k0 + wr;  // the warp's first key
  const bool warp_live = kw < kv_len;
  const int key_r[2] = {kw + g, kw + g + 8};  // this thread's two keys
  float acc_a[kOut][4], acc_b[C::kPasses == 1 ? kOut : 1][4];

#pragma unroll
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
    for (int s = 0; s + 1 < kStages; ++s) put_row(s, issue(s));

    for (int it = 0; it < n_tiles; ++it) {
      const Row next = issue(it + kStages - 1);  // into the stage the previous iteration released
      if constexpr (kStages == 1) put_row(0, next);
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const int stage = it % kStages;
      const int q0 = q_begin + it * kStep;
      const float* tQ = sS + stage * 2 * kStep * kLd;
      const float* tDO = tQ + kStep * kLd;
      const float* tRow = sRow + stage * 4 * kStep;
      // live n-tiles [j_lo, j_hi) of 8 query rows: below rows_end and, when
      // causal, reaching the warp's first key
      const int j_hi = warp_live ? min(NT, (rows_end - q0 + 7) / 8) : 0;
      const int j_lo = a.causal ? max(0, (kw - q0) / 8) : 0;
      if (j_lo < j_hi) {
        float sT[NT][4], dpT[NT][4];  // keys as rows, query rows as columns
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
        // s^T = K qs^T, dp^T = V dO^T: k-step outer, every live n-tile inner
#pragma unroll 2
        for (int kk = 0; kk < D / 8; ++kk) {
          const FragA ka = frag_a<kLd>(sK, wr, 8 * kk, g, t);
          if (do_dk) {
            const FragA va = frag_a<kLd>(sV, wr, 8 * kk, g, t);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              if (j < j_lo || j >= j_hi) continue;
              mma_3xtf32(sT[j], ka,
                         frag_b_nk<kLd, P::kPrescaled>(tQ, 8 * j, 8 * kk, g, t, a.q_scale));
              mma_3xtf32(dpT[j], va, frag_b_nk<kLd>(tDO, 8 * j, 8 * kk, g, t));
            }
          } else {
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              if (j < j_lo || j >= j_hi) continue;
              mma_3xtf32(sT[j], ka,
                         frag_b_nk<kLd, P::kPrescaled>(tQ, 8 * j, 8 * kk, g, t, a.q_scale));
            }
          }
        }
        // p^T over sT's registers and ds^T over dpT's; `masked` as in dq
        auto softmax_step = [&](bool masked) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int cq = 0; cq < 2; ++cq) {  // this thread's two query columns of n-tile j
              const int qi = 8 * j + 2 * t + cq;
              const int row = q0 + qi;
              const float mm = tRow[qi], rm = tRow[kStep + qi], c = tRow[2 * kStep + qi];
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int e = 2 * i + cq;
                const int key = key_r[i];
                const bool ok = !masked || (key < kv_len && row < rows_end &&
                                            (!a.causal || key <= row));
                float p = 0.f, ds = 0.f;
                if (ok) {
                  p = P::prob(P::logit(sT[j][e], a.scale), mm, rm);
                  ds = P::dscore(p, dpT[j][e], c, rm, a.scale);
                }
                sT[j][e] = p;
                dpT[j][e] = ds;
              }
            }
        };
        if (kw + 16 <= kv_len && q0 + kStep <= rows_end && (!a.causal || q0 >= kw + 15))
          softmax_step(false);
        else
          softmax_step(true);
        // dv += p^T dO' and dk += ds^T q: n-tile j is the k-step over query rows q0 + 8j..
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < j_lo || j >= j_hi) continue;
          if (do_dv) {
            const FragA pa = c_as_a(sT[j]);
            const float r0 = tRow[3 * kStep + 8 * j + 2 * t];
            const float r1 = tRow[3 * kStep + 8 * j + 2 * t + 1];
#pragma unroll
            for (int dt = 0; dt < kOut; ++dt)
              mma_3xtf32_rn(dv_acc[dt], pa,
                            frag_b_kn<kLd, P::kPrescaled>(tDO, 8 * j, 8 * dt, g, t, r0, r1));
          }
          if (do_dk) {
            const FragA da = c_as_a(dpT[j]);
#pragma unroll
            for (int dt = 0; dt < kOut; ++dt)
              mma_3xtf32_rn(dk_acc[dt], da, frag_b_kn<kLd>(tQ, 8 * j, 8 * dt, g, t));
          }
        }
      }
      // the next tile's stage was last read before this iteration's first barrier
      if constexpr (kStages > 1) put_row((it + 1) % kStages, next);
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
    // masked keys (>= kv_len) are written 0 exactly, whatever the query side held
    if (do_dk) store_rows<kOut>(dkb, a.dkst.n, key_r[0], n, kv_len, dk_acc, t);
    if (do_dv) store_rows<kOut>(dvb, a.dvst.n, key_r[0], n, kv_len, dv_acc, t);
  }
}

// Launch the dq and dk/dv kernels (each a __global__ wrapping dq<P, C::Dq> /
// dkdv<P, C::Dkdv>, C = BwdCfg<D>) over (row tiles, heads, batch), in the
// policy's order.
template <class P, class C>
cudaError_t launch_bwd(void (*dq_kernel)(BwdArgs), void (*dkdv_kernel)(BwdArgs),
                       const BwdArgs& a, int batch, cudaStream_t stream) {
  using Dq = typename C::Dq;
  using Dkdv = typename C::Dkdv;
  constexpr size_t smem_dq = dq_smem<Dq>();
  constexpr size_t smem_dkdv = dkdv_smem<Dkdv>();
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((a.n + Dq::kRows - 1) / Dq::kRows, a.heads, batch);
  const dim3 dkdv_grid((a.n + Dkdv::kRows - 1) / Dkdv::kRows, a.heads, batch);
  for (int i = 0; i < 2; ++i) {
    if ((i == 0) == P::kDqFirst)
      dq_kernel<<<dq_grid, Dq::kThreads, smem_dq, stream>>>(a);
    else
      dkdv_kernel<<<dkdv_grid, Dkdv::kThreads, smem_dkdv, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace f32bwd
}  // namespace dclip
