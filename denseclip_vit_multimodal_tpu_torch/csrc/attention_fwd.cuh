// The attention forward shared by four kernels: K1 (qkv_attention.cu, q/k/v
// read off the fused projection), K3 (mha_attention.cu, separate strided
// q/k/v), the second stage of K6 (ln_qkv_attention.cu, on the q/k/v
// workspace its first stage writes), all three under `TpuPolicy`, and K4
// (flash_attention.cu, long or causal sequences) under `BundledPolicy`.
// Each source wraps `forward<P, D>` in a __global__ of its own name, so that
// a profile tells them apart.  ops/_build.py hashes this header into the
// name of every library built from csrc/.
//
//   q, k, v [B, N, H, D] bf16 read by stride (unit stride over D, the other
//   strides multiples of 8 elements), D in {64, 128, 256};
//   out [B, N, H, D] bf16, contiguous;
//   stats null, or [B, H, N] float2: each query row's max of the logits in
//   log2 units and its sum of exp2(logit - max), the residuals the
//   backward (attention_bwd.cuh) reads.
//
// Numerics, per caller (the policy):
//   TpuPolicy (the TPU kernels' rounding points): q * q_scale is computed
//     in fp32 and rounded to bf16 in shared memory before Q K^T; q_scale is
//     scale * log2 e (K1, K3) or 1 (K6, whose first stage has already
//     scaled q in fp32 and rounded it); the fp32 score is the logit.
//   BundledPolicy (the bundled flash kernel's): s = q k^T in fp32 from the
//     unscaled bf16 q, then the logit bundled_logit(s, scale) = (s * scale)
//     * log2 e in fp32 (bundled_logit.cuh, shared with K4b's backward);
//     with `causal`, keys after the query are excluded.
//   Both: scores are fp32 (bf16 x bf16 products, fp32 accumulation); the
//   softmax uses exp2; P is rounded to bf16 for P V, which accumulates in
//   fp32; the row sum is taken over the fp32 P; one division by the row sum
//   on the output.  exp2 is ex2.approx.ftz (sm90::exp2_ftz): the
//   special-function unit's exp2, with results below 2^-126 flushed to 0;
//   no such term changes a row whose largest term is 1 (the outputs are
//   bitwise those of exp2f).
// Softmax knobs (TpuPolicy, softmax_exp.cuh): `forward<P, D, kMode>` with
// kMode kPoly (kPolyZeroed: Args::max_floor 0) or kBf16 first runs S = Q K^T
// over every K tile for each row's final max (the producer streams K twice,
// the ring's parities running on), then the loop below with the max fixed
// (no rescale) and p = knob_exp(s, m); the statistics carry that max and
// the sum of those p.  kExact (the default) is the single streamed pass.
// Keys >= kv_len are excluded exactly and never loaded: the K / V tensor
// maps end at kv_len, so TMA fills the box past it with zeros, and those
// scores are masked to -inf.  A NaN in a pad row cannot reach a real row.
//
// Design (Hopper, sm_90a).  A head's whole K/V does not fit the 227 KB of
// shared memory a block may use (384 KB at N = 1536, D = 64), so K/V stream
// through shared memory in tiles with an online softmax in fp32.  One block
// per (q-tile, head, batch) and one block per SM, made of warpgroups:
//   * a producer warpgroup (24 registers a thread after setmaxnreg) of which
//     one thread keeps Q and the K / V tiles in flight with TMA
//     (cp.async.bulk.tensor) into 128-byte-swizzled shared memory, K and V
//     each through a two-stage ring of mbarriers (full: TMA's bytes landed;
//     empty: every consumer warp is done with the tile);
//   * consumer warpgroups of 64 query rows each: three at D = 64 (192 rows,
//     160 registers), two at D = 128 and 256 (128 rows, 240 registers).
//     Under TpuPolicy a consumer scales its Q rows in place (fp32, rounded
//     to bf16, then fence.proxy.async).  It computes S = Q K^T with one
//     wgmma m64nNk16 chain per tile (Q and K K-major in shared memory), runs
//     the online softmax on the fp32 accumulator in registers, re-packs P
//     as the bf16 register A operand, and accumulates O += P V with wgmma
//     reading V MN-major (row-major [key][d], the descriptor's transpose
//     bit: no transpose).
// A 128-byte swizzle row holds 64 bf16, so a D-wide row is D / 64 boxes.
// Tiles of N = 128 keys at D <= 128, 64 at D = 256 (whose O accumulator
// alone takes 128 registers a thread).  Each consumer runs its tile's S,
// softmax and P V in turn; the softmax of one warpgroup overlaps the
// products of the others.
// Causal (BundledPolicy): the producer loads the tiles below min(kv_len,
// q0 + block_q), the block's last row, and every consumer runs every one of
// them, masking key > row only on the tiles that reach past its own first
// row.  Every consumer so arrives on every tile's empty barriers after
// waiting for its full ones: an arrival for a tile whose full phase a
// consumer did not wait for would complete the wrong phase.  With 192-row
// q-tiles and 128-key tiles (64 x 128 at D >= 128) a consumer runs at most
// one tile it does not need.
//
// Bound, measured (tools/time_fwd_trees.py, NVIDIA H100 80GB HBM3, 700 W):
// at K1's slide shape [10, 1536, 2304], valid_len 1522, the products are
// 71.8 GFLOP (0.0726 ms at 989 TFLOP/s) and the softmax 281 M exp2 on the
// special-function units (16 a clock an SM: about 0.07 ms); this body takes
// 0.180-0.184 ms (390-400 TFLOP/s), about the two added, where one
// scaled_dot_product_attention call takes 0.19.  Issuing tile j + 1's S
// before tile j's P V retires, so that a warpgroup's own softmax overlaps
// its products, measured slower here (0.25-0.27 ms: more live registers,
// spills), with or without the warpgroups taking turns.

#pragma once

#include "bundled_logit.cuh"
#include "hopper.cuh"
#include "mma_bf16.cuh"
#include "softmax_exp.cuh"
#include "tensor_map.cuh"

namespace dclip {
namespace attn {

template <int D>
__host__ __device__ constexpr int consumers() {  // consumer warpgroups, 64 query rows each
  return D == 64 ? 3 : 2;
}
template <int D>
__host__ __device__ constexpr int threads() {  // + the producer warpgroup
  return 128 * (consumers<D>() + 1);
}
template <int D>
__host__ __device__ constexpr int block_q() {
  return 64 * consumers<D>();
}
constexpr int kStages = 2;                        // K (and V) tiles in flight
constexpr int kBox = 64;                          // bf16 per 128-byte swizzled row

template <int D>
__host__ __device__ constexpr int block_n() {  // keys per K/V tile
  return D > 128 ? 64 : 128;
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
  int causal;     // BundledPolicy: exclude keys after the query (TpuPolicy: 0)
  float q_scale;  // TpuPolicy: q's multiplier before Q K^T
  float scale;    // BundledPolicy: the softmax scale on the fp32 s
  float max_floor = -3.402823466e38f;  // under a knob: the row max's floor (softmax_exp.cuh)
};

// The TPU kernels' arithmetic (K1, K3, K6): q prescaled in shared memory,
// the score is the logit, never causal.
struct TpuPolicy {
  static constexpr bool kPrescaled = true;
  static constexpr bool kCausal = false;
  __device__ static float logit(float s, float) { return s; }
};

// The bundled flash kernel's arithmetic (K4).
struct BundledPolicy {
  static constexpr bool kPrescaled = false;
  static constexpr bool kCausal = true;  // when Args::causal
  __device__ static float logit(float s, float scale) { return bundled_logit(s, scale); }
};

// A tensor map over [B, rows, H, D] and the coordinate slot (1-3) of the
// head, row and batch index: the outer dimensions are ordered by stride.
struct Map {
  CUtensorMap tmap;
  int slot_h, slot_n, slot_b;
};

struct Params {
  Map q, k, v;
  Args a;
};

// Shared memory, in bytes from a 1024-aligned base (the swizzle's period).
template <int D>
struct Smem {
  static constexpr int kBlockQ = block_q<D>();
  static constexpr int kN = block_n<D>();
  static constexpr int kBoxes = D / kBox;
  static constexpr int kQBox = kBlockQ * 128;  // one 64-column box of the Q tile
  static constexpr int kKVBox = kN * 128;      // one 64-column box of a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBoxes * kQBox;             // [kStages][kBoxes][kN][64]
  static constexpr int kV = kK + kStages * kBoxes * kKVBox;  // [kStages][kBoxes][kN][64]
  static constexpr int kBars = kV + kStages * kBoxes * kKVBox;
  // q, then k_full, k_empty, v_full, v_empty [kStages] each
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages);
};

template <int D>
constexpr size_t smem_bytes() {
  return Smem<D>::kBytes + 1024;  // + the alignment of the base
}

// wgmma's shared-memory matrix descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (>> 4), layout type 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void tma_load(const Map& m, uint32_t dst, uint32_t bar, int col, int h,
                                         int row, int b) {
  int c[4] = {col, 0, 0, 0};
  c[m.slot_h] = h;
  c[m.slot_n] = row;
  c[m.slot_b] = b;
  sm90::tma_load_4d(dst, &m.tmap, bar, c[0], c[1], c[2], c[3]);
}

template <class P, int D, int kMode = softmax::kExact>
__device__ __forceinline__ void forward(const Params& p) {
  constexpr bool kTwoPass = softmax::two_pass(kMode);
  using L = Smem<D>;
  constexpr int kConsumers = consumers<D>();
  constexpr int kBlockQ = block_q<D>();
  constexpr int kN = L::kN;
  constexpr int kBoxes = L::kBoxes;
  constexpr uint32_t kQBytes = kBlockQ * D * 2;
  constexpr uint32_t kTileBytes = kN * D * 2;
  const Args& a = p.a;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBars;
  auto k_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto k_empty = [&](int s) { return bar_q + 8 * (1 + kStages + s); };
  auto v_full = [&](int s) { return bar_q + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bar_q + 8 * (1 + 3 * kStages + s); };
  auto k_tile = [&](int s, int box) { return base + L::kK + (s * kBoxes + box) * L::kKVBox; };
  auto v_tile = [&](int s, int box) { return base + L::kV + (s * kBoxes + box) * L::kKVBox; };

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_len = a.kv_len;
  const bool causal = P::kCausal && a.causal;
  // keys this block reads: the valid ones, or (causal) those up to its last row
  const int kv_end = causal ? min(kv_len, q0 + kBlockQ) : kv_len;
  const int n_tiles = (kv_end + kN - 1) / kN;
  const int wg = threadIdx.x / 128;  // 0: the producer; 1..kConsumers: consumers

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(k_full(s), 1);
      sm90::mbar_init(k_empty(s), 4 * kConsumers);  // one arrival per consumer warp
      sm90::mbar_init(v_full(s), 1);
      sm90::mbar_init(v_empty(s), 4 * kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ---- producer ----
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(bar_q, kQBytes);
      for (int c = 0; c < kBoxes; ++c)
        tma_load(p.q, base + L::kQ + c * L::kQBox, bar_q, c * kBox, h, q0, b);
      int kc = 0;  // K tiles issued (twice as many as V's under a knob)
      auto load_k = [&](int it) {
        const int s = kc % kStages;
        sm90::mbar_wait(k_empty(s), ((kc / kStages) & 1) ^ 1);  // a fresh barrier passes
        sm90::mbar_arrive_expect_tx(k_full(s), kTileBytes);
        for (int c = 0; c < kBoxes; ++c)
          tma_load(p.k, k_tile(s, c), k_full(s), c * kBox, h, it * kN, b);
        ++kc;
      };
      if constexpr (kTwoPass)
        for (int it = 0; it < n_tiles; ++it) load_k(it);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t free_parity = ((it / kStages) & 1) ^ 1;  // a fresh barrier passes
        load_k(it);
        sm90::mbar_wait(v_empty(s), free_parity);
        sm90::mbar_arrive_expect_tx(v_full(s), kTileBytes);
        for (int c = 0; c < kBoxes; ++c)
          tma_load(p.v, v_tile(s, c), v_full(s), c * kBox, h, it * kN, b);
      }
    }
    return;
  }

  // ---- consumers ----
  sm90::setmaxnreg_inc<(kConsumers == 3 ? 160 : 240)>();
  const int cw = wg - 1;               // this consumer's 64 rows of the q-tile
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;           // 16 rows each (wgmma's accumulator layout)
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float neg_inf = __int_as_float(0xff800000);

  sm90::mbar_wait(bar_q, 0);
  if constexpr (P::kPrescaled) {
    // Q * q_scale in fp32, rounded to bf16, in place over this warpgroup's
    // rows of every box (the swizzle only permutes 16-byte chunks in a row).
    for (int i = tid; i < kBoxes * 64 * 8; i += 128) {
      Vec8 v;
      uint4* ptr = reinterpret_cast<uint4*>(smem + L::kQ + (i >> 9) * L::kQBox + cw * 64 * 128 +
                                            (i & 511) * 16);
      v.u = *ptr;
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        v.h[j] = __float2bfloat16_rn(__bfloat162float(v.h[j]) * a.q_scale);
      *ptr = v.u;
    }
    sm90::fence_proxy_async();  // the writes above, before wgmma reads them
    sm90::named_barrier_sync(1 + cw, 128);
  }

  // K-major operands: 8 rows of 128 bytes per 1024-byte group (SBO); a
  // k-step of 16 columns is 32 bytes along the row.  V is MN-major: 16 keys
  // are two groups of 8 rows (SBO 1024), 64-column boxes kKVBox apart (LBO).
  const uint32_t q_rows = base + L::kQ + cw * 64 * 128;
  auto desc_q = [&](int kk) {
    return desc_sw128(q_rows + (kk >> 2) * L::kQBox + (kk & 3) * 32, 16, 1024);
  };
  auto desc_k = [&](int s, int kk) { return desc_sw128(k_tile(s, kk >> 2) + (kk & 3) * 32, 16, 1024); };
  auto desc_v = [&](int s, int kk) { return desc_sw128(v_tile(s, 0) + kk * 16 * 128, L::kKVBox, 1024); };

  float m_run[2] = {neg_inf, neg_inf};  // rows g and g + 8 of this warp
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums
  const int first_row = q0 + cw * 64;   // this warpgroup's first query row
  const int row0 = first_row + warp * 16 + g;
  const int row1 = row0 + 8;
  int kc = 0;  // K tiles consumed

  // S = Q K^T of tile `it` from K ring slot kc: 64 rows x kN keys, fp32
  // (accumulator i: key 8 (i / 4) + 2t + i % 2 of row g, or row g + 8 for
  // i % 4 >= 2), as logits, keys the row does not see at -inf.
  auto scores = [&](float (&sc)[kN / 2], int it) {
    const int s = kc % kStages;
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] = 0.f;
    sm90::mbar_wait(k_full(s), (kc / kStages) & 1);
    sm90::fence_regs<kN / 2>(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) sm90::wgmma_ss<kN>(sc, desc_q(kk), desc_k(s, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<kN / 2>(sc);
    if (lane == 0) sm90::mbar_arrive(k_empty(s));
    ++kc;

#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] = P::logit(sc[i], a.scale);
    const int k0 = it * kN;
    // The ragged last tile: keys >= kv_len (TMA gave zeros).  Causal: keys
    // after the row, on the tiles that reach past this warpgroup's first row.
    if (k0 + kN > kv_len || (causal && k0 + kN - 1 > first_row)) {
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (key >= kv_len || (causal && key > ((i & 2) ? row1 : row0))) sc[i] = neg_inf;
      }
    }
  };

  if constexpr (kTwoPass) {  // the rows' final max, before any p
    for (int it = 0; it < n_tiles; ++it) {
      float sc[kN / 2];
      scores(sc, it);
#pragma unroll
      for (int i = 0; i < kN / 2; i += 4) {
        m_run[0] = fmaxf(m_run[0], fmaxf(sc[i], sc[i + 1]));
        m_run[1] = fmaxf(m_run[1], fmaxf(sc[i + 2], sc[i + 3]));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_run[r] = fmaxf(m_run[r], __shfl_xor_sync(0xffffffffu, m_run[r], 1));
      m_run[r] = fmaxf(m_run[r], __shfl_xor_sync(0xffffffffu, m_run[r], 2));
      m_run[r] = fmaxf(m_run[r], a.max_floor);
    }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {  // (O, l) over the K / V tiles
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    float sc[kN / 2];
    scores(sc, it);

    // Online softmax.  Tile 0 holds key 0, which every row sees (kv_len >=
    // 1, and a causal row is >= 0), so the running max is finite from the
    // first tile on, and exp2(-inf - m) = 0 needs no special case.  A later
    // tile may hold no key a row sees (causal: all after the row): the row
    // keeps its max (alpha = 1) and adds 0.  Under a knob the max is final.
    float mx[2] = {m_run[0], m_run[1]};
    if constexpr (!kTwoPass) {
#pragma unroll
      for (int i = 0; i < kN / 2; i += 4) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[i], sc[i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[i + 2], sc[i + 3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      const float alpha0 = sm90::exp2_ftz(m_run[0] - mx[0]);
      const float alpha1 = sm90::exp2_ftz(m_run[1] - mx[1]);
      m_run[0] = mx[0];
      m_run[1] = mx[1];
      l_run[0] *= alpha0;
      l_run[1] *= alpha1;
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        o[i] *= alpha0;
        o[i + 1] *= alpha0;
        o[i + 2] *= alpha1;
        o[i + 3] *= alpha1;
      }
    }

    // P = exp2(S - m) in fp32 (summed in fp32), rounded to bf16 as the A
    // fragment of P V: keys 16kk .. 16kk + 15 are accumulator entries
    // 8kk .. 8kk + 7.
    uint32_t pf[kN / 16][4];
    auto prob = [&](float x, float m) {
      if constexpr (kTwoPass)
        return softmax::knob_exp<kMode>(x, m);
      else
        return sm90::exp2_ftz(x - m);
    };
#pragma unroll
    for (int i = 0; i < kN / 2; i += 4) {
      const float p0 = prob(sc[i], mx[0]);
      const float p1 = prob(sc[i + 1], mx[0]);
      const float p2 = prob(sc[i + 2], mx[1]);
      const float p3 = prob(sc[i + 3], mx[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      pf[i >> 3][(i >> 1) & 2] = pack_bf16(p0, p1);
      pf[i >> 3][((i >> 1) & 2) + 1] = pack_bf16(p2, p3);
    }

    // O += P V (fp32 accumulation).
    sm90::mbar_wait(v_full(s), parity);
    sm90::fence_regs<D / 2>(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) sm90::wgmma_rs_tb<D>(o, pf[kk], desc_v(s, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<D / 2>(o);
    sm90::fence_regs<kN / 4>(&pf[0][0]);
    if (lane == 0) sm90::mbar_arrive(v_empty(s));
  }

  // Row sums across the four threads of each row group, then one division.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int n = a.n;
  if (a.stats != nullptr && t == 0) {  // (max, sum) of every row, for the backward
    float2* st = a.stats + ((long long)b * a.heads + h) * n;
    if (row0 < n) st[row0] = make_float2(m_run[0], l_run[0]);
    if (row1 < n) st[row1] = make_float2(m_run[1], l_run[1]);
  }
  const long long out_stride = (long long)a.heads * D;
  __nv_bfloat16* out_b = a.out + (long long)b * n * out_stride + h * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 4) {
    const int col = 2 * i + 2 * t;  // 8 (i / 4) + 2t
    if (row0 < n)
      *reinterpret_cast<uint32_t*>(out_b + row0 * out_stride + col) =
          pack_bf16(o[i] / l_run[0], o[i + 1] / l_run[0]);
    if (row1 < n)
      *reinterpret_cast<uint32_t*>(out_b + row1 * out_stride + col) =
          pack_bf16(o[i + 2] / l_run[1], o[i + 3] / l_run[1]);
  }
}

// The map of a [B, rows, H, D] bf16 operand read by stride, in boxes of
// 64 columns x `box_rows` rows of one head and batch, 128-byte swizzled;
// rows >= `rows` read as zeros.
inline cudaError_t make_map(Map* m, const __nv_bfloat16* ptr, const Strides& st, int d, int heads,
                            int rows, int batch, int box_rows) {
  EncodeTiled encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  // the outer dimensions (head, row, batch) in increasing stride
  long long stride[3] = {st.h, st.n, st.b};
  unsigned long long extent[3] = {(unsigned long long)heads, (unsigned long long)rows,
                                  (unsigned long long)batch};
  unsigned box[3] = {1u, (unsigned)box_rows, 1u};
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (stride[order[j]] < stride[order[i]]) {
        const int tmp = order[i];
        order[i] = order[j];
        order[j] = tmp;
      }
  cuuint64_t dims[4] = {(cuuint64_t)d, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t boxes[4] = {(cuuint32_t)kBox, 0, 0, 0};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int* slot[3] = {&m->slot_h, &m->slot_n, &m->slot_b};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = extent[order[i]];
    strides[i] = (cuuint64_t)stride[order[i]] * sizeof(__nv_bfloat16);
    boxes[i + 1] = box[order[i]];
    *slot[order[i]] = i + 1;
  }
  const CUresult r = encode(&m->tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, (void*)ptr, dims, strides,
                            boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch `kernel` (a __global__ wrapping forward<P, D>) over (q-tiles, heads,
// batch), with the tensor maps of q (rows < n) and k / v (rows < kv_len).
template <int D>
cudaError_t launch(void (*kernel)(Params), const Args& a, int batch, cudaStream_t stream) {
  Params p;
  p.a = a;
  constexpr int kBlockQ = block_q<D>();
  cudaError_t err = make_map(&p.q, a.q, a.qs, D, a.heads, a.n, batch, kBlockQ);
  if (err == cudaSuccess) err = make_map(&p.k, a.k, a.ks, D, a.heads, a.kv_len, batch, block_n<D>());
  if (err == cudaSuccess) err = make_map(&p.v, a.v, a.vs, D, a.heads, a.kv_len, batch, block_n<D>());
  if (err != cudaSuccess) return err;
  constexpr size_t smem = smem_bytes<D>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kBlockQ - 1) / kBlockQ, a.heads, batch);
  kernel<<<grid, threads<D>(), smem, stream>>>(p);
  return cudaGetLastError();
}

// Launch kernels[variant(mode)] (the source's instantiations for kExact,
// kPoly and kBf16; null where it has none) with the row max's floor of
// `mode`, or cudaErrorInvalidValue for a mode it does not have.
template <int D>
cudaError_t launch_mode(void (*const (&kernels)[4])(Params), int mode, Args a, int batch,
                        cudaStream_t stream) {
  const int v = softmax::variant(mode);
  if (v < 0 || kernels[v] == nullptr) return cudaErrorInvalidValue;
  a.max_floor = softmax::max_floor(mode);
  return launch<D>(kernels[v], a, batch, stream);
}

}  // namespace attn
}  // namespace dclip
