// Int8 softmax attention on the quantized fused QKV projection (the opt-in
// int8 serving path, `tpu.attn_impl: int8`).
//
// Replaces the TPU kernel `_qkv_int8_kernel` of the JAX package
// (denseclip_vit_multimodal_tpu/ops/mha_kernel.py, reached through
// `_qkv_int8_fwd_impl` / `mha_qkv_attention_int8`).  Same function:
//
//   q8  [B, N, 3*H*D] int8   q of head h at column h*D, k at H*D + h*D
//                            (the prologue's output, quantize_qkv_int8.cu;
//                            its v third is not read)
//   vt  [B, H, D, ldv] int8  v of head h key-major: row d holds the keys of
//                            head dim d, each 16-key group in the order
//                            0 1 8 9 2 3 10 11 4 5 12 13 6 7 14 15 (the
//                            prologue's; ldv = N rounded up to 16)
//   scales [B, 3, H] fp32    (sq, sk, sv) per batch and head
//   out [B, N, H*D]          bf16 or fp32 (the dtype of the unquantized qkv)
//
// Numerics are the TPU kernel's, rounding point for rounding point:
//   * s = q8 . k8 in int32 (exact);
//   * sf = float(s) * mult in fp32, mult = ((sq * sk) * scale) * log2 e;
//   * keys >= kv_len are masked (the TPU kernel sets them to the fp32 minimum,
//     which gives them P = 0 exactly, as here);
//   * p = exp2(sf - m) in fp32, m the row max over the valid keys; the row
//     sum (the denominator) is taken over the fp32 p;
//   * p8 = trunc(p * 127 + 0.5) (p <= 1, so p8 <= 127);
//   * o = p8 . v8 in int32 (exact below 132104 keys);
//   * out = (float(o) * (sv / 127)) / max(denom, 1e-20).
// Every multiply-add of that chain is written with __fmul_rn / __fadd_rn /
// __fsub_rn, so that the compiler cannot contract it into an FMA and round
// differently from the plain version.  exp2 is ex2.approx.ftz
// (sm90::exp2_ftz), as in the bf16 forward core: results below 2^-126 are
// flushed to 0, which no p8 (a multiple of 1/127) and no row sum whose
// largest term is 1 can see.  The two conversions are exact full-rate forms
// instead of the quarter-rate I2F / F2I, which share the special-function
// pipe with ex2: |s| <= 128 * 128 * D < 2^22, so float(s) is the float of
// the bits s + 0x4B400000 minus 1.5 * 2^23; and 0.5 <= p * 127 + 0.5 <=
// 127.5, so its floor is the low byte of (p * 127 + 0.5) + 2^23 rounded
// down.
//
// Design (Hopper, sm_90a).  The TPU kernel holds a head's whole K/V in VMEM
// and quantizes P against the FINAL row max, so an online softmax (the bf16
// core's) would give other p8 values; and K of one head at N = 8320 is
// 532 KB, more than the 227 KB of shared memory a block may use.  So each
// block makes two passes over the key tiles: the first finds the int32 row
// max of s (exact, and max(float(s) * mult) = float(max s) * mult since the
// multiplier is positive), the second recomputes s and forms p, the
// denominator and P V: three int8 products where the function needs two.
// One block per (q-tile, head, batch) and one block per SM:
//   * a producer warpgroup (24 registers a thread after setmaxnreg) of which
//     one thread keeps Q and the K / V tiles in flight with TMA over q8 as
//     [B, N, 3H, D] (K's map ends at kv_len: TMA fills the rows past it with
//     zeros) and over vt, into 64-byte-swizzled shared memory (a D = 64 row
//     is 64 bytes; D = 128 rows are two such boxes), through rings of
//     mbarriers (full: TMA's bytes landed; empty: every consumer warp is done
//     with the tile): K tiles for both passes, V tiles for the second;
//   * consumer warpgroups of 64 query rows each, three at D = 64 and two at
//     D = 128.  S = Q K^T is one wgmma m64n128k32 chain per tile (Q and K
//     K-major in shared memory).  In the second pass each thread turns its
//     int32 accumulators into p8 and packs them, as they lie, into the A
//     registers of O += P V (wgmma with A from registers, V K-major): a
//     thread's accumulators hold keys {2t, 2t+1, 8+2t, 9+2t} of each
//     16-key group, while the 8-bit A fragment holds positions {4t..4t+3},
//     so the prologue writes V's copy with each 16-key group in the order
//     above, which puts key 2t, 2t+1, 8+2t, 9+2t at position 4t..4t+3.
//     The int32 sums of P V are exact, so the order of their terms changes
//     no bit, and p8 needs no shuffle and no trip through shared memory.
// Keys >= kv_len are masked to INT_MIN in the first pass and to p = 0 in
// the second, on the ragged last tile only (full tiles run a mask-free
// copy of the per-score code), so V's copy past kv_len (zeros from the
// prologue) is never weighed.  Four K / V tiles are in flight (two
// measured 2% slower).
//
// Bound on an H100 SXM at the slide shape [10, 1536, 2304], valid_len 1522,
// H 12, D 64: the function's two products are 4*B*H*N*valid_len*D = 71.8 G
// int8 tensor-core operations (0.036 ms at 1,979 TOPS) against ~59 MB of
// int8 input and bf16 output (0.018 ms at 3.35 TB/s): operation-bound.  This
// design executes three products (0.054 ms at peak) and 281 M exp2 on the
// special-function units (16 a clock an SM: about 0.07 ms); the second
// pass adds about ten issued instructions a score (the two exact
// conversions, the scale, the max's subtraction, the row sum, three for
// p8, most of a byte permute), which no fused-multiply-add may shorten
// without changing a rounding.  Measured (tools/time_fwd_trees.py, NVIDIA
// H100 80GB HBM3, 700 W) 0.216-0.222 ms; the mma.sync kernel it replaced
// took 0.528-0.540.  What holds it: the per-score work, not the
// products or the first pass.  Without the first pass's products the kernel
// takes 1% less, without exp2 5% less, and with no per-score work at all
// (p8 taken from the raw bits) 0.100 ms: the products, barriers and loads
// alone.  The two add up: a consumer runs its tile's products and its
// per-score work in turn, and the three consumers of a block do not hide
// one's products behind another's work.  Tried and slower: two consumers
// at D = 64 (0.226-0.238), 64-key tiles (0.255), issuing tile j + 1's S
// before tile j's softmax (0.252-0.262: ptxas serialises the wgmma,
// C7515), issuing tile j's P V and tile j + 1's S as one group
// (0.220-0.238), and ordering the consumers' turns at the tensor cores
// with named barriers (0.228).

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"
#include "tensor_map.cuh"

namespace dclip {
namespace i8 {

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
constexpr int kN = 128;      // keys per K / V tile
constexpr int kBox = 64;     // bytes of a 64-byte-swizzled row
constexpr int kStages = 4;   // K (and V) tiles in flight
constexpr int kMaxKeys = INT_MAX / (127 * 128);  // int32 P V sums stay exact
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  CUtensorMap q, k, v;  // q8 as [B, N, 3H, D] (rows < n; rows < kv_len), vt
  const float* scales;
  void* out;
  int n, heads, kv_len;
  float sm_scale;
};

// Shared memory, in bytes from a 1024-aligned base; every box starts on a
// multiple of 512, the 64-byte swizzle's period.
template <int D>
struct Smem {
  static constexpr int kQBoxes = D / kBox;      // 64-byte column boxes of a Q / K row
  static constexpr int kVBoxes = kN / kBox;     // 64-key boxes of a V tile
  static constexpr int kQBox = block_q<D>() * kBox;
  static constexpr int kKBox = kN * kBox;
  static constexpr int kVBox = D * kBox;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBoxes * kQBox;            // [kStages][kQBoxes][kN][64]
  static constexpr int kV = kK + kStages * kQBoxes * kKBox;  // [kStages][kVBoxes][D][64]
  static constexpr int kBars = kV + kStages * kVBoxes * kVBox;
  // q, then k_full, k_empty, v_full, v_empty [kStages] each
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages);
};

template <int D>
constexpr size_t smem_bytes() {
  return Smem<D>::kBytes + 1024;  // + the alignment of the base
}

// wgmma's descriptor of a K-major operand in 64-byte-swizzled rows: 8 rows
// of 64 bytes per 512-byte group (SBO), layout type 2.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// Four bytes, the low byte of each word, `a`'s lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// float(s), exact for |s| < 2^22, on the full-rate pipes.
__device__ __forceinline__ float exact_float(int s) {
  return __fsub_rn(__int_as_float(s + 0x4B400000), 12582912.f);
}

// p8 = trunc(p * 127 + 0.5) for 0 <= p <= 1, in the low byte of the result.
__device__ __forceinline__ uint32_t quantize_p(float p) {
  return __float_as_uint(__fadd_rd(__fadd_rn(__fmul_rn(p, 127.f), 0.5f), 8388608.f));
}

// p = exp2(float(s) * mult - m) of one S tile (keys at offset >= lim from
// this thread's first key masked to p = 0 when kRagged), its share of the
// row sums (in l[0] for row g, l[1] for row g + 8), and p8 packed as the
// A fragments of P V: k-step kk (keys 32kk .. 32kk + 31, two 16-key groups
// G) has a[2 (G & 1)] for row g and a[2 (G & 1) + 1] for row g + 8, each
// the four keys 2t, 2t+1, 8+2t, 9+2t of the group (accumulators 8G + 0, 1,
// 4, 5 of row g; 8G + 2, 3, 6, 7 of row g + 8).
template <bool kRagged>
__device__ __forceinline__ void tile_p8(const int* s, float mult, float m0, float m1, int lim,
                                        float l[2], uint32_t (*pf)[4]) {
  float part[2][4] = {};  // partial row sums: four short addition chains a row
  uint32_t q[kN / 2];     // p8 in the low byte
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    float p = sm90::exp2_ftz(__fsub_rn(__fmul_rn(exact_float(s[i]), mult), (i & 2) ? m1 : m0));
    if (kRagged && 8 * (i >> 2) + (i & 1) >= lim) p = 0.f;
    part[(i >> 1) & 1][(i >> 2) & 3] = __fadd_rn(part[(i >> 1) & 1][(i >> 2) & 3], p);
    q[i] = quantize_p(p);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = __fadd_rn(l[r], __fadd_rn(__fadd_rn(part[r][0], part[r][1]),
                                     __fadd_rn(part[r][2], part[r][3])));
#pragma unroll
  for (int grp = 0; grp < kN / 16; ++grp) {
    const int i = 8 * grp;
    pf[grp >> 1][2 * (grp & 1)] = pack4(q[i], q[i + 1], q[i + 4], q[i + 5]);
    pf[grp >> 1][2 * (grp & 1) + 1] = pack4(q[i + 2], q[i + 3], q[i + 6], q[i + 7]);
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int D, typename T>
__device__ __forceinline__ void forward(const Params& p) {
  using L = Smem<D>;
  constexpr int kConsumers = consumers<D>();
  constexpr int kBlockQ = block_q<D>();
  constexpr uint32_t kQBytes = kBlockQ * D;
  constexpr uint32_t kKBytes = kN * D;
  constexpr uint32_t kVBytes = D * kN;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBars;
  auto k_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto k_empty = [&](int s) { return bar_q + 8 * (1 + kStages + s); };
  auto v_full = [&](int s) { return bar_q + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bar_q + 8 * (1 + 3 * kStages + s); };
  auto q_box = [&](int c) { return base + L::kQ + c * L::kQBox; };
  auto k_tile = [&](int s, int c) { return base + L::kK + (s * L::kQBoxes + c) * L::kKBox; };
  auto v_tile = [&](int s, int c) { return base + L::kV + (s * L::kVBoxes + c) * L::kVBox; };

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int heads = p.heads;
  const int kv_len = p.kv_len;
  const int n_tiles = (kv_len + kN - 1) / kN;
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

  if (wg == 0) {  // ---- producer: Q, then K tiles of both passes, V tiles of the second ----
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(bar_q, kQBytes);
      for (int c = 0; c < L::kQBoxes; ++c)
        sm90::tma_load_4d(q_box(c), &p.q, bar_q, c * kBox, h, q0, b);
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t free_parity = ((it / kStages) & 1) ^ 1;  // a fresh barrier passes
        const int k0 = (it % n_tiles) * kN;
        sm90::mbar_wait(k_empty(s), free_parity);
        sm90::mbar_arrive_expect_tx(k_full(s), kKBytes);
        for (int c = 0; c < L::kQBoxes; ++c)
          sm90::tma_load_4d(k_tile(s, c), &p.k, k_full(s), c * kBox, heads + h, k0, b);
        if (it >= n_tiles) {
          const int j = it - n_tiles;
          const int sv = j % kStages;
          sm90::mbar_wait(v_empty(sv), ((j / kStages) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(v_full(sv), kVBytes);
          for (int c = 0; c < L::kVBoxes; ++c)
            sm90::tma_load_4d(v_tile(sv, c), &p.v, v_full(sv), k0 + c * kBox, 0, h, b);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  sm90::setmaxnreg_inc<(kConsumers == 3 ? 160 : 240)>();
  const int cw = wg - 1;          // this consumer's 64 rows of the q-tile
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;      // 16 rows each (wgmma's accumulator layout)
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* sc = p.scales + (long long)b * 3 * heads + h;
  const float mult = __fmul_rn(__fmul_rn(__fmul_rn(sc[0], sc[heads]), p.sm_scale), kLog2e);
  const float sv127 = __fdiv_rn(sc[2 * heads], 127.f);

  // K-major operands in 64-byte rows: a k-step of 32 bytes is half a row.
  const uint32_t q_rows = cw * 64 * kBox;
  auto desc_q = [&](int kk) { return desc_sw64(q_box(kk >> 1) + q_rows + (kk & 1) * 32); };
  auto desc_k = [&](int s, int kk) { return desc_sw64(k_tile(s, kk >> 1) + (kk & 1) * 32); };
  auto desc_v = [&](int s, int kk) { return desc_sw64(v_tile(s, kk >> 1) + (kk & 1) * 32); };

  // S = Q K^T of K tile `it` of the ring (64 rows x kN keys, int32;
  // accumulator i: key 8 (i / 4) + 2t + i % 2 of row g, or row g + 8 for
  // i % 4 >= 2), then the tile's slot is released.
  int s_acc[kN / 2];
  auto scores = [&](int it) {
    const int s = it % kStages;
    sm90::mbar_wait(k_full(s), (it / kStages) & 1);
    sm90::fence_regs<kN / 2>(s_acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk)
      sm90::wgmma_ss_s8<kN>(s_acc, desc_q(kk), desc_k(s, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<kN / 2>(s_acc);
    if (lane == 0) sm90::mbar_arrive(k_empty(s));
  };

  sm90::mbar_wait(bar_q, 0);

  // Pass 1: the int32 row max over the valid keys (rows g and g + 8).
  int mx[2] = {INT_MIN, INT_MIN};
  for (int it = 0; it < n_tiles; ++it) {
    scores(it);
    const int k0 = it * kN;
    if (k0 + kN > kv_len) {  // the ragged last tile: TMA gave zero rows past kv_len
#pragma unroll
      for (int i = 0; i < kN / 2; ++i)
        if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= kv_len) s_acc[i] = INT_MIN;
    }
#pragma unroll
    for (int i = 0; i < kN / 2; i += 4) {
      mx[0] = max(mx[0], max(s_acc[i], s_acc[i + 1]));
      mx[1] = max(mx[1], max(s_acc[i + 2], s_acc[i + 3]));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  const float m0 = __fmul_rn(exact_float(mx[0]), mult);
  const float m1 = __fmul_rn(exact_float(mx[1]), mult);

  // Pass 2: p, the denominator and O = p8 V.
  int o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0;
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  for (int j = 0; j < n_tiles; ++j) {
    scores(n_tiles + j);
    const int lim = kv_len - j * kN - 2 * t;  // keys of this thread at offset >= lim are masked
    uint32_t pf[kN / 32][4];
    if (j * kN + kN > kv_len)  // the ragged last tile only: full tiles carry no mask
      tile_p8<true>(s_acc, mult, m0, m1, lim, l, pf);
    else
      tile_p8<false>(s_acc, mult, m0, m1, lim, l, pf);

    const int s = j % kStages;
    sm90::mbar_wait(v_full(s), (j / kStages) & 1);
    sm90::fence_regs<D / 2>(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 32; ++kk) sm90::wgmma_rs_s8<D>(o, pf[kk], desc_v(s, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<D / 2>(o);
    sm90::fence_regs<kN / 8>(&pf[0][0]);
    if (lane == 0) sm90::mbar_arrive(v_empty(s));
  }

  // Row sums across the four threads of each row group, then the dequant.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
  }
  const float d0 = fmaxf(l[0], 1e-20f);
  const float d1 = fmaxf(l[1], 1e-20f);
  const int n = p.n;
  const int row0 = q0 + cw * 64 + warp * 16 + g;
  const int row1 = row0 + 8;
  const long long out_stride = (long long)heads * D;
  T* out_b = static_cast<T*>(p.out) + (long long)b * n * out_stride + h * D;
  auto deq = [&](int v, float den) {
    return __fdiv_rn(__fmul_rn(__int2float_rn(v), sv127), den);
  };
#pragma unroll
  for (int i = 0; i < D / 2; i += 4) {
    const int col = 2 * i + 2 * t;  // 8 (i / 4) + 2t
    if (row0 < n) store2(out_b + row0 * out_stride + col, deq(o[i], d0), deq(o[i + 1], d0));
    if (row1 < n) store2(out_b + row1 * out_stride + col, deq(o[i + 2], d1), deq(o[i + 3], d1));
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(threads<D>(), 1)
qkv_attention_int8_kernel(const __grid_constant__ Params p) {
  forward<D, T>(p);
}

// A 4-d map of int8 `ptr` with extents dims[0..3] (innermost first), byte
// strides strides[0..2] of dims 1..3, boxes box[0..3], 64-byte swizzle;
// elements past an extent arrive as zeros.
inline cudaError_t make_map(CUtensorMap* m, const void* ptr, const cuuint64_t dims[4],
                            const cuuint64_t strides[3], const cuuint32_t box[4]) {
  EncodeTiled encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, typename T>
cudaError_t launch(const void* q8, const void* vt, const void* scales, void* out, int batch,
                   int n, int heads, int kv_len, int ldv, float sm_scale, cudaStream_t stream) {
  Params p;
  p.scales = static_cast<const float*>(scales);
  p.out = out;
  p.n = n;
  p.heads = heads;
  p.kv_len = kv_len;
  p.sm_scale = sm_scale;
  // q8 as [B, rows, 3H, D]: Q's map ends at n, K's at kv_len
  const cuuint64_t row = 3ull * heads * D;
  const cuuint64_t qk_strides[3] = {(cuuint64_t)D, row, row * n};
  const cuuint64_t q_dims[4] = {(cuuint64_t)D, 3ull * heads, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t k_dims[4] = {(cuuint64_t)D, 3ull * heads, (cuuint64_t)kv_len,
                                (cuuint64_t)batch};
  const cuuint32_t q_box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)block_q<D>(), 1};
  const cuuint32_t k_box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)kN, 1};
  // vt as [B, H, D, keys]: the map ends at kv_len rounded up to the 16-key
  // group (the prologue zeroed the keys of the group past kv_len)
  const cuuint64_t v_dims[4] = {(cuuint64_t)((kv_len + 15) / 16 * 16), (cuuint64_t)D,
                                (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t v_strides[3] = {(cuuint64_t)ldv, (cuuint64_t)ldv * D,
                                   (cuuint64_t)ldv * D * heads};
  const cuuint32_t v_box[4] = {(cuuint32_t)kBox, (cuuint32_t)D, 1, 1};
  cudaError_t err = make_map(&p.q, q8, q_dims, qk_strides, q_box);
  if (err == cudaSuccess) err = make_map(&p.k, q8, k_dims, qk_strides, k_box);
  if (err == cudaSuccess) err = make_map(&p.v, vt, v_dims, v_strides, v_box);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = smem_bytes<D>();
  auto* kernel = qkv_attention_int8_kernel<D, T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + block_q<D>() - 1) / block_q<D>(), heads, batch);
  kernel<<<grid, threads<D>(), smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace i8
}  // namespace dclip

// Plain C entry point for ctypes.  Pointers are device pointers of
// contiguous tensors, 16-byte aligned: q8 int8 [B, N, 3*H*D], vt int8
// [B, H, D, ldv] (ldv >= N, a multiple of 16; each 16-key group in the
// prologue's order), scales fp32 [B, 3, H], out [B, N, H*D] bf16
// (out_bf16 = 1) or fp32 (0).  `stream` is a cudaStream_t.  Returns the
// cudaError_t of the launch (0 = cudaSuccess).
extern "C" int qkv_attention_int8(const void* q8, const void* vt, const void* scales, void* out,
                                  int out_bf16, int batch, int n, int heads, int head_dim,
                                  int kv_len, int ldv, float sm_scale, void* stream) {
  using namespace dclip::i8;
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n || kv_len > kMaxKeys ||
      ldv < n || ldv % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return out_bf16 ? (int)launch<64, __nv_bfloat16>(q8, vt, scales, out, batch, n, heads,
                                                     kv_len, ldv, sm_scale, s)
                    : (int)launch<64, float>(q8, vt, scales, out, batch, n, heads, kv_len, ldv,
                                             sm_scale, s);
  if (head_dim == 128)
    return out_bf16 ? (int)launch<128, __nv_bfloat16>(q8, vt, scales, out, batch, n, heads,
                                                      kv_len, ldv, sm_scale, s)
                    : (int)launch<128, float>(q8, vt, scales, out, batch, n, heads, kv_len,
                                              ldv, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
