// The fp32 attention forward shared by five kernels: K1 off the fused qkv
// projection and K3 on strided q / k / v (attention_fp32.cu), the second
// stages of the fused fp32 K6 and K7 (ln_qkv_attention_fp32.cu,
// qkv_out_attention_fp32.cu), all under `TpuPolicy`, and K4 (long or causal
// sequences, attention_fp32.cu) under `BundledPolicy`.  The bf16 kernels
// (attention_fwd.cuh) run their products on the tensor cores in bf16; these
// take the fp32 inputs of `tpu.compute_dtype: float32`, which the TPU
// kernels take too (JAX's dispatch asks nothing about the dtype), and run
// their products on the tensor cores by 3xTF32 (mma_tf32.cuh).
// ops/_build.py hashes this header into the name of every library built
// from csrc/.
//
// Replaces, in fp32:
//   * `_qkv_kernel` (denseclip_vit_multimodal_tpu/ops/mha_kernel.py, K1) and
//     `_kernel` (K3) of the JAX package: policy `TpuPolicy`;
//   * the bundled `_flash_attention_kernel_single_batch` (jax/experimental/
//     pallas/ops/tpu/flash_attention.py) behind ops/attention.py:130 (K4):
//     policy `BundledPolicy`.
//
//   q, k, v [B, N, H, D] fp32 read by stride (unit stride over D, the other
//   strides multiples of 4 elements, 16-byte aligned), D in {64, 128, 256};
//   out [B, N, H, D] fp32, contiguous;
//   stats null, or [B, H, N] float2: each query row's max of the logits in
//   log2 units and its sum of exp2(logit - max), the residuals the fp32
//   backward reads (the layout of the bf16 kernels' statistics).
//
// Numerics, per caller (the policy):
//   TpuPolicy (the TPU kernels' rounding points in fp32): qs = q * q_scale
//     rounded once to fp32 (q_scale = scale * log2 e, the constant in fp32
//     and not rounded further: fp32 is the input dtype); s = qs k^T is the
//     logit.
//   BundledPolicy (the bundled kernel's): s = q k^T from the unscaled q,
//     then bundled_logit(s, scale) = (s * scale) * log2 e (bundled_logit.cuh,
//     which the backward shares); with `causal`, keys after the query are
//     excluded.
//   Both: every product is 3xTF32 (each operand split into a TF32 high part
//   and its remainder, three TF32 products: about 2^-21 of each term lost,
//   fp32's accuracy where one TF32 product keeps three digits).  The tensor
//   cores truncate where they accumulate, so no sum runs long in them: s
//   sums its k-steps round-robin into kSets accumulators from zero (at most
//   12 HMMAs each) and adds them with one rounding each; P V sums one
//   streamed tile's keys from zero, and O = O * alpha + that sum is one fmaf
//   (rounded to nearest) a tile.  The softmax uses exp2f, an online max and
//   sum in fp32; P stays fp32 (split for the tensor cores); one division by
//   the row sum at the end (the TPU kernels divide once as well; the bundled
//   one renormalises per block: equal up to fp32 rounding).  The backward
//   kernels (attention_bwd_fp32.cuh) form s the same way up to the order of
//   the k-steps' sums, within a few ulp of this s.  Head dim 256 runs the
//   SIMT core (attention_fp32_simt.cuh: every product an fp32 FMA).
// Under DENSECLIP_FAST_EXP2 (`forward<P, D, kPoly>`, TpuPolicy; kPolyZeroed
// with Args::max_floor 0): a first pass streams K alone for each row's
// final max, then the loop runs with that max fixed (no rescale) and p =
// exp2_poly(s - m) (softmax_exp.cuh); the statistics carry that max and the
// sum of those p.
// Keys >= kv_len are excluded and never loaded (their tile rows are
// zero-filled by cp.async, and their scores masked to -inf), so a NaN in a
// pad row of K or V cannot reach a real row through 0 * NaN.  The TPU
// kernels pad N to 128 with zeros and subtract the pads' exp2(-m) from each
// row sum (with a floor against cancellation); a key that is never loaded
// adds nothing that needs subtracting.
//
// Design (mma.sync m16n8k8 .tf32, three products per fragment pair): one
// block of kWarps warps per (16 kWarps query rows, head, batch); a warp owns
// 16 rows (the mma's M).
//   * Q lands once, is pre-scaled (TpuPolicy) and split into an NK plane
//     (tf32_frag.cuh); at D = 64 each warp reads its A fragments into
//     registers (64 of them) and the plane, in the ring's stages 1.. until
//     then, is freed; at D = 128 a warp reads them from the plane (two
//     16-byte loads a k-step, shared by every n-tile).
//   * K and V stream in kStep-key tiles through a kStages ring of 16-byte
//     cp.async copies that land in split planes (K: NK, V: KN), and each
//     thread splits the chunks it copied in place after its own wait: each
//     element is split once a tile, by one thread, where the backward core
//     (attention_bwd_fp32.cuh) splits each streamed fragment again in every
//     warp (PERF.md §6 gives the A/B rounds of the two).  Tile t + 1 is
//     split after tile t is used while tile t + 2 lands, each tile's work
//     straight-line code; one block barrier a tile publishes tile t + 1's
//     planes and frees tile t's stage.
//   * S = Q K^T: k-step outer, every 8-key n-tile inner, each B fragment
//     one 16-byte load, kSets x NT independent HMMA chains.  The
//     row max and sum over the quad that shares a row are two xor-shuffles.
//     P is born in the C fragments and becomes P V's A fragment in
//     registers (c_as_a); P V runs key k-step outer, every output n-tile
//     inner (D / 8 independent chains), each V B fragment one 16-byte load.
//   * No branch inside a tile's work (the S and P V loops run every n-tile,
//     the masked ones too; a tile no mask reaches takes a softmax step
//     without per-score mask tests): skipping the n-tiles a mask empties
//     split the HMMAs into branches the compiler could not schedule across,
//     and cost more than the few masked tiles it saved (PERF.md §6).
// Tiling (Cfg): D = 64: 8 warps on 128 rows, 64-key tiles, three stages,
// 212 KB of shared memory (Q's plane in stages 1-2 at the start), Q in
// registers; D = 128: 4 warps on 64 rows, 16-key tiles, three stages, 172
// KB.  One block an SM (255 registers a thread, a few dozen bytes spilled).
//
// Bound on an H100 SXM: 4 B H N kv_len D FLOP (halved when causal) against
// a few bytes per element of q, k, v and out: operation-bound at every
// shape of the paths.  Under 3xTF32 the ceiling is a third of the 495
// TFLOP/s TF32 rate, 165 TFLOP/s (the slide window [10, 1536, 2304] valid
// 1522: 71.8 GFLOP, 0.435 ms; the aug-test view [2, 25216, 12, 64] valid
// 25089: 3.87 TFLOP, 23.4 ms); at the fp32 FMA peak of 66.9 TFLOP/s it
// would be 1.07 and 57.8 ms.  mma.sync's own TF32 rate on the card is
// about 320 TFLOP/s (tools/mma_tf32_peak.py), a third of it 107.  The
// softmax adds one exp2 per score on the special-function units (PERF.md
// gives the measured times).

#pragma once

#include "bundled_logit.cuh"
#include "softmax_exp.cuh"
#include "tf32_frag.cuh"

namespace dclip {
namespace f32 {

struct Strides {  // in elements
  long long b, n, h;
};

// A forward tiling: kWarps warps on 16 rows each, kStep-key streamed tiles
// in a ring of kStages.
template <int D_, int kWarps_, int kStep_, int kStages_>
struct Tiles {
  static constexpr bool kSimt = false;
  static constexpr int D = D_, kWarps = kWarps_, kStep = kStep_, kStages = kStages_;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kMinBlocks = 1;
  static constexpr int NT = kStep / 8;  // 8-key n-tiles of a streamed tile
  static constexpr int kOut = D / 8;    // 8-column n-tiles of an output row
  static constexpr int kLdNk = 2 * D + 16;  // Q and K planes: 16 mod 32 words
  static constexpr int kLdKn = 4 * D + 8;   // the V plane's pair rows: 8 mod 32 words
  // Q's A fragments in registers (read once; its plane lives in the ring's
  // stages 1.. until then), or read from its own plane at every tile
  static constexpr bool kQRegs = D == 64;
  // S's k-steps run round-robin over kSets accumulator sets: kSets * NT
  // independent HMMA chains a warp
  static constexpr int kSets = NT >= 8 ? 1 : 8 / NT;
  static constexpr int kStageWords = kStep * kLdNk + kStep / 2 * kLdKn;
  static constexpr int kQPlaneWords = kRows * kLdNk;
  static constexpr int kQWords = kQRegs ? 0 : kQPlaneWords;  // Q's own words
  static_assert(kStages >= 3, "tile t + 1 splits while tile t is used and t + 2 lands");
  static_assert((D / 8) % kSets == 0, "whole k-steps per accumulator set");
  static_assert(!kQRegs || kQPlaneWords <= (kStages - 1) * kStageWords, "Q's plane in the ring");
  static_assert(kStep % 8 == 0 && D % 64 == 0 && D <= 128,
                "whole k-steps, 8-step chunks of D, O and its tile sums in registers");
};

// The tilings per head dim (the header note says why); head dim 256 runs
// the SIMT core (attention_fp32_simt.cuh), chosen here at compile time.
template <int D>
struct Cfg;
template <>
struct Cfg<64> : Tiles<64, 8, 64, 3> {};
template <>
struct Cfg<128> : Tiles<128, 4, 16, 3> {};
template <>
struct Cfg<256> {
  static constexpr bool kSimt = true;
  static constexpr int kThreads = 256, kRows = 64, kMinBlocks = 1;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Max / sum over the four lanes of a quad (the lanes that share a row of a
// C fragment), in a fixed order.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <class T>
__device__ __forceinline__ T* at(T* p, const Strides& s, int b, int h) {
  return p + b * s.b + h * s.h;
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* out;     // contiguous [B, N, H, D]
  float2* stats;  // null or [B, H, N]
  Strides qst, kst, vst;
  int n, heads, kv_len, causal;
  float q_scale;  // TpuPolicy: scale * log2 e
  float scale;    // BundledPolicy: the softmax scale
  float max_floor = -3.402823466e38f;  // under a knob: the row max's floor (softmax_exp.cuh)
};

// The TPU kernels' arithmetic (K1, K3).
struct TpuPolicy {
  static constexpr bool kPrescaled = true;
  __device__ static float logit(float s, float) { return s; }
};

// The bundled flash kernel's arithmetic (K4).
struct BundledPolicy {
  static constexpr bool kPrescaled = false;
  __device__ static float logit(float s, float scale) { return bundled_logit(s, scale); }
};

}  // namespace f32
}  // namespace dclip

#include "attention_fp32_simt.cuh"

namespace dclip {
namespace f32 {

template <int D>
constexpr size_t fwd_smem() {
  using C = Cfg<D>;
  if constexpr (C::kSimt)
    return simt::fwd_smem<D>();
  else
    return sizeof(float) * (size_t)(C::kQWords + C::kStages * C::kStageWords);
}

// Q's chunks pre-scaled by q_scale (rounded once) before their split.
struct ScaleChunk {
  float s;
  __device__ __forceinline__ void operator()(int, int, float4& x) const {
    x = make_float4(__fmul_rn(x.x, s), __fmul_rn(x.y, s), __fmul_rn(x.z, s), __fmul_rn(x.w, s));
  }
};

// A stage's split: this thread's chunks of its K plane (and V plane),
// after its own cp.async wait.
template <class C>
__device__ __forceinline__ void split_stage(float* st, bool with_v, int tid) {
  tf32::split_nk<C::kStep, C::D, C::kThreads>(st, C::kLdNk, tid);
  if (with_v) tf32::split_kn<C::kStep, C::D, C::kThreads>(st + C::kStep * C::kLdNk, C::kLdKn, tid);
}

// K's B fragment of n-tile j (keys 8j..8j + 7 of the tile), k-step kk.
template <class C>
__device__ __forceinline__ FragB k_frag(const float* tK, int j, int kk, int g, int t) {
  return tf32::frag_b_nk_split(tK + 8 * j * C::kLdNk, C::kLdNk, kk, g, t);
}

// V's B fragment of k-step j (keys 8j..8j + 7 of the tile), output n-tile dt.
template <class C>
__device__ __forceinline__ FragB v_frag(const float* tV, int j, int dt, int g, int t) {
  return tf32::frag_b_kn_split(tV, C::kLdKn, j, 8 * dt, g, t);
}

// The tensor-core forward (D = 64, 128).
template <class P, int D, int kMode>
__device__ __forceinline__ void forward_tc(const Args& a) {
  using C = Cfg<D>;
  constexpr bool kTwoPass = softmax::two_pass(kMode);
  constexpr int kLdNk = C::kLdNk, kLdKn = C::kLdKn, kStep = C::kStep, NT = C::NT;
  constexpr int kOut = C::kOut, kRows = C::kRows, kStages = C::kStages, kThreads = C::kThreads;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sKV = reinterpret_cast<float*>(smem_raw) + C::kQWords;  // [stage][K NK, V KN plane]
  // [kRows] rows of an NK plane: before the ring, or in its stages 1..
  float* sQ = C::kQRegs ? sKV + C::kStageWords : reinterpret_cast<float*>(smem_raw);

  const int n = a.n, kv_len = a.kv_len;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = at(a.k, a.kst, b, h);
  const float* vb = at(a.v, a.vst, b, h);
  const int k_end = a.causal ? min(kv_len, q0 + kRows) : kv_len;
  const int n_tiles = (k_end + kStep - 1) / kStep;
  // The ring's loads: under two passes the K-only tiles of the first pass,
  // then the K and V tiles of the second.
  const int n_loads = kTwoPass ? 2 * n_tiles : n_tiles;
  auto tile_of = [&](int i) { return kTwoPass && i >= n_tiles ? i - n_tiles : i; };
  auto with_v = [&](int i) { return !kTwoPass || i >= n_tiles; };
  auto stage = [&](int i) { return sKV + (i % kStages) * C::kStageWords; };
  // Load i into its stage (one group); a load past the last is zero-filled
  // without a read, so the loop below runs the same straight-line code to
  // its end.
  auto issue = [&](int i) {
    const bool on = i < n_loads;
    const int k0 = tile_of(min(i, n_loads - 1)) * kStep;
    float* st = stage(i);
    tf32::land_nk<kStep, D, kThreads>(st, kLdNk, kb + (long long)k0 * a.kst.n, a.kst.n,
                                      kv_len - k0, D, tid, on);
    if (with_v(i))
      tf32::land_kn<kStep, D, kThreads>(st + kStep * kLdNk, kLdKn, vb + (long long)k0 * a.vst.n,
                                        a.vst.n, kv_len - k0, D, tid, on);
    cp_async_commit();
  };

  // Q (one group), then the ring's first tiles (kQRegs: load 0 only, until
  // Q's plane in the stages after it is read); Q and load 0 split and
  // published before the loop.
  tf32::land_nk<kRows, D, kThreads>(sQ, kLdNk, at(a.q, a.qst, b, h) + (long long)q0 * a.qst.n,
                                    a.qst.n, n - q0, D, tid);
  cp_async_commit();
  constexpr int kFirst = C::kQRegs ? 1 : kStages - 1;  // loads issued before Q is split
  for (int s = 0; s < kFirst; ++s) issue(s);
  cp_async_wait<kFirst>();  // Q has landed (this thread's copies)
  if constexpr (P::kPrescaled)
    tf32::split_nk<kRows, D, kThreads>(sQ, kLdNk, tid, ScaleChunk{a.q_scale});
  else
    tf32::split_nk<kRows, D, kThreads>(sQ, kLdNk, tid);
  const int wr = warp * 16;  // the warp's first row in the block
  const float* wq = sQ + wr * kLdNk;
  FragA qreg[C::kQRegs ? D / 8 : 1];
  if constexpr (C::kQRegs) {
    __syncthreads();  // Q's plane published
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) qreg[kk] = tf32::frag_a_nk(wq, kLdNk, kk, g, t);
    __syncthreads();  // every warp holds its Q: the ring's stages 1.. are free
    for (int s = 1; s + 1 < kStages; ++s) issue(s);
  }
  cp_async_wait<kStages - 2>();  // load 0 has landed
  split_stage<C>(stage(0), with_v(0), tid);
  __syncthreads();
  const int row_r[2] = {q0 + wr + g, q0 + wr + g + 8};

  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};  // l: this thread's share
  float o[kOut][4];
#pragma unroll
  for (int dt = 0; dt < kOut; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  // Load i's part for this warp (its stage is published).
  auto compute = [&](int i) {
    if (kTwoPass && i == n_tiles) {  // the first pass is over: the rows' final max
#pragma unroll
      for (int r = 0; r < 2; ++r) m[r] = fmaxf(quad_max(m[r]), a.max_floor);
    }
    const float* tK = stage(i);
    const float* tV = tK + kStep * kLdNk;
    const bool first_pass = kTwoPass && i < n_tiles;
    const int k0 = tile_of(i) * kStep;

    // s = qs K^T: k-step outer, every n-tile inner, k-step kk into
    // accumulator set kk % kSets (each summed from zero), the sets then
    // added in order, one rounding each
    constexpr int kSets = C::kSets;
    float c[kSets][NT][4];
#pragma unroll
    for (int q = 0; q < kSets; ++q)
#pragma unroll
      for (int j = 0; j < NT; ++j) c[q][j][0] = c[q][j][1] = c[q][j][2] = c[q][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      FragA qa;
      if constexpr (C::kQRegs)
        qa = qreg[kk];
      else
        qa = tf32::frag_a_nk(wq, kLdNk, kk, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_3xtf32(c[kk % kSets][j], qa, k_frag<C>(tK, j, kk, g, t));
    }
    float (&s)[NT][4] = c[0];
#pragma unroll
    for (int q = 1; q < kSets; ++q)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = __fadd_rn(s[j][e], c[q][j][e]);

    // the logits; masked scores -inf (every score of a tile that the mask
    // empties for the warp's rows, whose max then stays).  `masked` false
    // where no mask reaches the tile.
    auto logits = [&](bool masked) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const bool ok = !masked || (key < kv_len && (!a.causal || key <= row_r[e >> 1]));
          s[j][e] = ok ? P::logit(s[j][e], a.scale) : neg_inf();
        }
    };
    if (k0 + kStep <= kv_len && (!a.causal || k0 + kStep - 1 <= q0 + wr))
      logits(false);
    else
      logits(true);

    if (first_pass) {  // this thread's share of the rows' max
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
      return;
    }
    float alpha[2] = {1.f, 1.f};
    if constexpr (kTwoPass) {  // the max is final: no rescale
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = softmax::knob_exp<kMode>(s[j][e], m[e >> 1]);  // 0 where masked
          l[e >> 1] += p;
          s[j][e] = p;
        }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = neg_inf();
#pragma unroll
        for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        // Tile 0 holds key 0, which every row sees: the max is finite from there on.
        const float m_new = fmaxf(m[r], quad_max(mx));
        alpha[r] = exp2f(m[r] - m_new);  // 0 on the first tile
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - m[e >> 1]);  // exactly 0 where masked
          l[e >> 1] += p;
          s[j][e] = p;
        }
    }

    // P V into the tile's sums from zero (P's n-tile j is the k-step over
    // keys k0 + 8j..; one independent chain per output n-tile), then O = O *
    // alpha + the sums, one fmaf each
    float pv[kOut][4];
#pragma unroll
    for (int dt = 0; dt < kOut; ++dt) pv[dt][0] = pv[dt][1] = pv[dt][2] = pv[dt][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const FragA pa = c_as_a(s[j]);
#pragma unroll
      for (int dt = 0; dt < kOut; ++dt) mma_3xtf32(pv[dt], pa, v_frag<C>(tV, j, dt, g, t));
    }
#pragma unroll
    for (int dt = 0; dt < kOut; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = fmaf(o[dt][e], alpha[e >> 1], pv[dt][e]);
  };

  // Load i + kStages - 1 lands while load i is used and load i + 1 is split
  // (after the use: split first, the compiler interleaves the two and runs
  // out of registers); one barrier a load publishes load i + 1 and frees
  // load i's stage.
  for (int i = 0; i < n_loads; ++i) {
    issue(i + kStages - 1);  // into load i - 1's stage, freed by the last barrier
    compute(i);
    cp_async_wait<kStages - 2>();  // load i + 1 has landed (this thread's copies)
    split_stage<C>(stage(i + 1), with_v(i + 1), tid);  // past the last load: unused
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const int row = row_r[r];
    if (row >= n) continue;
    float* dst = a.out + (((long long)b * n + row) * a.heads + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kOut; ++dt)
      *reinterpret_cast<float2*>(dst + 8 * dt) =
          make_float2(o[dt][2 * r] / sum, o[dt][2 * r + 1] / sum);
    if (a.stats != nullptr && t == 0)
      a.stats[((long long)b * a.heads + h) * n + row] = make_float2(m[r], sum);
  }
}

template <class P, int D, int kMode = softmax::kExact>
__device__ __forceinline__ void forward(const Args& a) {
  if constexpr (Cfg<D>::kSimt)
    simt::forward<P, D, kMode>(a);
  else
    forward_tc<P, D, kMode>(a);
}

// Launch `kernel` (a __global__ wrapping forward<P, D>) over (q-tiles, heads,
// batch) with its dynamic shared memory.
template <int D>
cudaError_t launch(void (*kernel)(Args), const Args& a, int batch, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + C::kRows - 1) / C::kRows, a.heads, batch);
  kernel<<<grid, C::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Launch kernels[variant(mode)] (kExact's and kPoly's instantiations) with
// the row max's floor of `mode`, or cudaErrorInvalidValue for a mode the
// fp32 kernels do not have (kBf16).
template <int D>
cudaError_t launch_mode(void (*const (&kernels)[2])(Args), int mode, Args a, int batch,
                        cudaStream_t stream) {
  const int v = softmax::variant(mode);
  if (v < 0 || v > 1) return cudaErrorInvalidValue;
  a.max_floor = softmax::max_floor(mode);
  return launch<D>(kernels[v], a, batch, stream);
}

}  // namespace f32
}  // namespace dclip
