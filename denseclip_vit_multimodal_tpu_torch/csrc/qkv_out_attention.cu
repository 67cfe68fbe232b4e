// Attention off the fused QKV projection with the out-projection fused as an
// epilogue (K7): the experiment of tools/exp_outproj_epilogue.py.
//
// Replaces the TPU kernel `_qkv_out_kernel` of the JAX package's
// tools/exp_outproj_epilogue.py (reached through `qkv_out_attention`), which
// asks whether multiplying each head's attention output by its rows of
// W_out while it is still on chip beats K1 plus a separate matmul.
//
//   qkv [B, N, 3*H*D] bf16 (contiguous), D in {64, 128}, H*D a multiple of
//   64 and at most 1024 (ViT-L/14's width);  w_out [H*D, H*D] bf16
//   (contiguous, [in, out]: y = o @ w_out)
//   ->  out [B, N, H*D] fp32 (before the bias), contiguous.
//
// Numerics follow the TPU kernel's rounding points, per head:
//   * K1's: q * (scale * log2 e) in fp32 rounded to bf16, fp32 scores,
//     exp2 softmax (ex2.approx.ftz, as the forward core), P rounded to bf16
//     for P V with fp32 accumulation, the row sum over the fp32 P; keys >=
//     valid_len excluded exactly and never loaded (the script's iota mask
//     gives them weight 0 too; its zero-pad denominator correction is the
//     same number);
//   * o / denom rounded to bf16;
//   * the product with W_out's rows of that head, accumulated in fp32 with
//     every other head's.
// The one difference is the softmax's order: streamed with an online max
// (as K1), where the TPU kernel holds the whole score row.  Under
// DENSECLIP_FAST_EXP2 (`qkv_out_attention_bf16_knob`), which the TPU kernel
// reads through `_exp2`, each head first runs S = Q K^T over its K tiles for
// the rows' final max (floored at 0 where the script pads the keys with
// zeros: no valid_len, N not a multiple of 128), then p = exp2_poly(s - m)
// with that max fixed (softmax_exp.cuh): the producer streams K twice, the
// K ring's parities running on ahead of V's.
//
// Design (Hopper, sm_90a).  The TPU kernel keeps an fp32 [bq, H*D] output
// block resident in VMEM across the heads of a q-tile.  Here a block takes
// 64 query rows of one batch element and every head, and keeps the bf16
// attention output of all heads in shared memory: O [64, H*D], 96 KB at
// H*D = 768 and 128 KB at 1024, in 64-column boxes with the 128-byte
// swizzle, the K-major layout a wgmma descriptor reads.  Each head's Q is
// loaded by TMA into that head's boxes of O and scaled there; its output
// later takes its place.  An fp32 [64, H*D] accumulator would be 384
// registers a thread at 768, so the product with W_out waits for the last
// head.  A block is a producer warpgroup and C consumer warpgroups (three
// at D = 64 with 160 registers, two at D = 128 with 240):
//   * lane 0 of producer warp c feeds consumer c by TMA (the producer keeps
//     24 registers): its heads' Q boxes, then its K / V tiles of 64 keys
//     through rings of full / empty mbarriers (two stages at D = 64, one at
//     D = 128: 32 KB a consumer either way), whose parities run on from one
//     head into the next; then, once the consumer has released every K / V
//     tile, W_out's tiles (32 rows x 128 columns, 8 KB, MN-major) through a
//     four-slot ring in the same 32 KB;
//   * consumer c takes heads c, c + C, ..., each over all 64 rows: S = Q K^T
//     by wgmma m64n64k16 from shared memory, the online exp2 softmax on the
//     fp32 accumulator, P as the register A operand of O += P V (wgmma with
//     the transpose bit on V), then o / l rounded into the head's boxes of
//     O.  After the last head (a named barrier over every consumer) they
//     split the output columns in chunks of 128 (a last chunk of 64 where
//     H*D % 128 == 64), chunk c, c + C, ...: out = O W_out by wgmma
//     m64nNk16 with A = O and B = W_out's slot (transpose bit), fp32
//     accumulators in registers, each slot released one k-step behind, then
//     stored straight from registers to the rows below N: a block never
//     writes the next batch element's rows.
// The attention output never reaches device memory and no atomics are used
// (every sum runs in one order): a rerun is bitwise equal.  Shared memory:
// C * 32 KB of rings + 128 * H*D bytes of O + barriers: 225 KB at D = 64 and
// H*D = 1024, the widest the kernel takes.
//
// Bound on an H100 SXM at the experiment's shape [10, 1601, 2304], H 12,
// D 64: attention 4*B*H*N^2*D = 78.7 GFLOP plus the projection 2*B*N*(H*D)^2
// = 18.9 GFLOP of bf16 tensor-core work (0.099 ms at 989 TFLOP/s) against
// ~123 MB of qkv / W / fp32-out traffic (0.037 ms at 3.35 TB/s):
// operation-bound.  Measured (tools/time_fwd_trees.py, NVIDIA H100 80GB
// HBM3, 700 W): 0.281 ms (347 TFLOP/s), where K1 + matmul + the cast to
// fp32 take 0.292; the same design with two consumer warpgroups took 0.330,
// and the previous one (mma.sync on ldmatrix fragments, synchronous loads,
// four warps of 16 rows) 1.95.

#include "attention_fwd.cuh"

namespace {

using namespace dclip;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                      // query rows per block
constexpr int kN = 64;                         // keys per K / V tile
constexpr int kBox = 64;                       // bf16 per 128-byte swizzled row
constexpr int kBoxBytes = kRows * 128;         // one 64 x 64 box of O
constexpr int kMaxWidth = 1024;                // H*D
constexpr int kMaxHeads = kMaxWidth / 64;
constexpr int kChunk = 128;                    // output columns per projection chunk
constexpr int kWRows = 32;                     // W_out rows (k) per ring slot
constexpr int kWBytes = kWRows * kChunk * 2;   // a slot: two 32 x 64 boxes, 8 KB
constexpr int kRing = 32768;                   // each consumer's K / V ring, then its W ring
constexpr int kWStages = kRing / kWBytes;

template <int D>
__host__ __device__ constexpr int consumers() {  // consumer warpgroups
  return D == 64 ? 3 : 2;
}
template <int D>
__host__ __device__ constexpr int threads() {  // + the producer warpgroup
  return 128 * (consumers<D>() + 1);
}
template <int D>
__host__ __device__ constexpr int o_offset() {  // O after every consumer's ring
  return consumers<D>() * kRing;
}
template <int D>
__host__ __device__ constexpr int stages() {  // K (and V) tiles in flight
  return D == 64 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int tile_bytes() {  // a K or V tile: D / 64 boxes of kN rows
  return kN * D * 2;
}
static_assert(2 * stages<64>() * tile_bytes<64>() == kRing, "D = 64: K and V rings fill the region");
static_assert(2 * stages<128>() * tile_bytes<128>() == kRing, "D = 128: the same");

// Per consumer: k_full, k_empty, v_full, v_empty [stages] each, then w_full,
// w_empty [kWStages] each; after q_full [kMaxHeads].
template <int D>
__host__ __device__ constexpr int bars_per_consumer() {
  return 4 * stages<D>() + 2 * kWStages;
}

template <int D>
size_t smem_bytes(int hd) {  // + the alignment of the base
  return o_offset<D>() + (size_t)hd * 128 +
         8 * (kMaxHeads + consumers<D>() * bars_per_consumer<D>()) + 1024;
}

struct OutParams {
  attn::Map q, k, v;  // [B, rows, H, D] views of qkv: q rows < n, k / v rows < kv_len
  CUtensorMap w;      // w_out [hd, hd], boxes of 64 columns x kWRows rows
  float* out;
  int n, heads, kv_len;
  float q_scale;
  float max_floor;  // under the knob: the row max's floor (softmax_exp.cuh)
};

// A operand from O (or a head's Q in it), K-major: 16 columns from column
// 16 * k16, 8 rows of 128 bytes per 1024-byte group.
__device__ __forceinline__ uint64_t desc_o(uint32_t o_base, int k16) {
  return attn::desc_sw128(o_base + (k16 >> 2) * kBoxBytes + (k16 & 3) * 32, 16, 1024);
}

// out[64 rows, NC columns from n0] = O W_out[:, n0 .. n0 + NC), W_out's
// slots of kWRows rows taken from this consumer's ring at position `wit`;
// rows at or past `rows` (the batch element's end) are not stored.
template <int NC>
__device__ __forceinline__ void project(float* out_rows, int hd, int n0, int rows,
                                        uint32_t o_base, uint32_t ring, uint32_t w_full,
                                        uint32_t w_empty, int& wit, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  const int k_tiles = hd / kWRows;
  // W_out is MN-major ([in][out], out contiguous): a slot holds NC / 64
  // boxes of kWRows k-rows x 64 columns (LBO), 8 k-rows per 1024 bytes (SBO).
  for (int kt = 0; kt < k_tiles; ++kt, ++wit) {
    const int s = wit % kWStages;
    sm90::mbar_wait(w_full + 8 * s, (wit / kWStages) & 1);
    sm90::fence_regs<NC / 2>(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWRows / 16; ++kk)
      sm90::wgmma_ss_tb<NC>(
          acc, desc_o(o_base, kt * (kWRows / 16) + kk),
          attn::desc_sw128(ring + s * kWBytes + kk * 16 * 128, kWRows * 128, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // the previous slot's products have retired
    sm90::fence_regs<NC / 2>(acc);
    if (kt > 0 && lane == 0) sm90::mbar_arrive(w_empty + 8 * ((wit - 1) % kWStages));
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs<NC / 2>(acc);
  if (lane == 0) sm90::mbar_arrive(w_empty + 8 * ((wit - 1) % kWStages));
  // accumulator i: row 16 warp + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2t + i % 2
  const int row0 = warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int i = 0; i < NC / 2; i += 4) {
    const int col = n0 + 2 * i + 2 * t;
    if (row0 < rows)
      *reinterpret_cast<float2*>(out_rows + (long long)row0 * hd + col) =
          make_float2(acc[i], acc[i + 1]);
    if (row1 < rows)
      *reinterpret_cast<float2*>(out_rows + (long long)row1 * hd + col) =
          make_float2(acc[i + 2], acc[i + 3]);
  }
}

template <int D, int kMode>  // softmax::kExact, or kPoly under DENSECLIP_FAST_EXP2
__global__ void __launch_bounds__(threads<D>(), 1)
qkv_out_attention_kernel(const __grid_constant__ OutParams p) {
  constexpr bool kTwoPass = softmax::two_pass(kMode);
  constexpr int kConsumers = consumers<D>();
  constexpr int kOOff = o_offset<D>();
  constexpr int kStages = stages<D>();
  constexpr int kHeadBoxes = D / kBox;
  constexpr int kTile = tile_bytes<D>();
  constexpr int kBars = bars_per_consumer<D>();

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int hd = p.heads * D;
  const uint32_t o_base = base + kOOff;
  const uint32_t bars = o_base + hd * 128;
  auto q_full = [&](int h) { return bars + 8 * h; };
  auto bar = [&](int c, int i) { return bars + 8 * (kMaxHeads + c * kBars + i); };
  auto k_full = [&](int c, int s) { return bar(c, s); };
  auto k_empty = [&](int c, int s) { return bar(c, kStages + s); };
  auto v_full = [&](int c, int s) { return bar(c, 2 * kStages + s); };
  auto v_empty = [&](int c, int s) { return bar(c, 3 * kStages + s); };
  auto w_full = [&](int c) { return bar(c, 4 * kStages); };  // [kWStages] each
  auto w_empty = [&](int c) { return bar(c, 4 * kStages + kWStages); };
  auto ring = [&](int c) { return base + c * kRing; };
  auto k_tile = [&](int c, int s, int box) { return ring(c) + s * kTile + box * kN * 128; };
  auto v_tile = [&](int c, int s, int box) {
    return ring(c) + (kStages + s) * kTile + box * kN * 128;
  };

  const int q0 = blockIdx.x * kRows;
  const int b = blockIdx.y;
  const int kv_len = p.kv_len;
  const int n_tiles = (kv_len + kN - 1) / kN;
  const int chunks = (hd + kChunk - 1) / kChunk;
  const int wg = threadIdx.x / 128;  // 0: the producer; 1 .. kConsumers: consumers

  if (threadIdx.x == 0) {
    for (int h = 0; h < p.heads; ++h) sm90::mbar_init(q_full(h), 1);
    for (int c = 0; c < kConsumers; ++c) {
      for (int s = 0; s < kStages; ++s) {
        sm90::mbar_init(k_full(c, s), 1);
        sm90::mbar_init(k_empty(c, s), 4);  // one arrival per consumer warp
        sm90::mbar_init(v_full(c, s), 1);
        sm90::mbar_init(v_empty(c, s), 4);
      }
      for (int s = 0; s < kWStages; ++s) {
        sm90::mbar_init(w_full(c) + 8 * s, 1);
        sm90::mbar_init(w_empty(c) + 8 * s, 4);
      }
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ---- producers: lane 0 of warp c feeds consumer c ----
    sm90::setmaxnreg_dec<24>();
    const int c = threadIdx.x / 32;
    if (c < kConsumers && (threadIdx.x & 31) == 0) {
      int it = 0;   // V tiles issued: the V ring's position, across heads
      int itk = 0;  // K tiles issued (twice as many under the knob)
      for (int h = c; h < p.heads; h += kConsumers) {
        sm90::mbar_arrive_expect_tx(q_full(h), kRows * D * 2);
        for (int box = 0; box < kHeadBoxes; ++box)
          attn::tma_load(p.q, o_base + (h * kHeadBoxes + box) * kBoxBytes, q_full(h), box * kBox,
                         h, q0, b);
        auto load_k = [&](int j) {
          const int s = itk % kStages;
          sm90::mbar_wait(k_empty(c, s), ((itk / kStages) & 1) ^ 1);  // a fresh barrier passes
          sm90::mbar_arrive_expect_tx(k_full(c, s), kTile);
          for (int box = 0; box < kHeadBoxes; ++box)
            attn::tma_load(p.k, k_tile(c, s, box), k_full(c, s), box * kBox, h, j * kN, b);
          ++itk;
        };
        if constexpr (kTwoPass)
          for (int j = 0; j < n_tiles; ++j) load_k(j);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int s = it % kStages;
          const uint32_t free_parity = ((it / kStages) & 1) ^ 1;  // a fresh barrier passes
          load_k(j);
          sm90::mbar_wait(v_empty(c, s), free_parity);
          sm90::mbar_arrive_expect_tx(v_full(c, s), kTile);
          for (int box = 0; box < kHeadBoxes; ++box)
            attn::tma_load(p.v, v_tile(c, s, box), v_full(c, s), box * kBox, h, j * kN, b);
        }
      }
      // W_out's slots overlay the K / V tiles: wait until the consumer has
      // released every one (the waits the next kStages loads would make).
      for (int e = 0; e < kStages; ++e, ++it, ++itk) {
        sm90::mbar_wait(k_empty(c, itk % kStages), ((itk / kStages) & 1) ^ 1);
        sm90::mbar_wait(v_empty(c, it % kStages), ((it / kStages) & 1) ^ 1);
      }
      int wit = 0;  // W slots issued
      for (int chunk = c; chunk < chunks; chunk += kConsumers) {
        const int n0 = chunk * kChunk;
        const int boxes = min(kChunk, hd - n0) / kBox;
        for (int kt = 0; kt < hd / kWRows; ++kt, ++wit) {
          const int s = wit % kWStages;
          sm90::mbar_wait(w_empty(c) + 8 * s, ((wit / kWStages) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(w_full(c) + 8 * s, boxes * kWRows * 128);
          for (int box = 0; box < boxes; ++box)
            sm90::tma_load_2d(ring(c) + s * kWBytes + box * kWRows * 128, &p.w,
                              w_full(c) + 8 * s, n0 + box * kBox, kt * kWRows);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  sm90::setmaxnreg_inc<(kConsumers == 3 ? 160 : 240)>();
  const int c = wg - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;  // 16 rows each (wgmma's accumulator layout)
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float neg_inf = __int_as_float(0xff800000);
  // K-major K: 8 rows of 128 bytes per 1024-byte group; a k-step of 16
  // columns is 32 bytes along the row.  V is MN-major: 16 keys are two
  // groups of 8 rows (SBO 1024), 64-column boxes kN * 128 bytes apart (LBO).
  auto desc_k = [&](int s, int kk) {
    return attn::desc_sw128(k_tile(c, s, kk >> 2) + (kk & 3) * 32, 16, 1024);
  };
  auto desc_v = [&](int s, int kk) {
    return attn::desc_sw128(v_tile(c, s, 0) + kk * 16 * 128, kN * 128, 1024);
  };

  int it = 0;   // V tiles consumed, across heads
  int itk = 0;  // K tiles consumed
  for (int h = c; h < p.heads; h += kConsumers) {
    sm90::mbar_wait(q_full(h), 0);
    // Q * q_scale in fp32, rounded to bf16, in place over the head's boxes
    // (the swizzle only permutes 16-byte chunks in a row).
    for (int i = tid; i < kHeadBoxes * kRows * 8; i += 128) {
      Vec8 v;
      uint4* ptr = reinterpret_cast<uint4*>(smem + kOOff + (h * kHeadBoxes + (i >> 9)) * kBoxBytes +
                                            (i & 511) * 16);
      v.u = *ptr;
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        v.h[j] = __float2bfloat16_rn(__bfloat162float(v.h[j]) * p.q_scale);
      *ptr = v.u;
    }
    sm90::fence_proxy_async();  // the writes above, before wgmma reads them
    sm90::named_barrier_sync(1 + c, 128);

    float m_run[2] = {neg_inf, neg_inf};  // rows g and g + 8 of this warp
    float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums

    // S = Q K^T of tile j from K ring slot itk: 64 rows x kN keys, fp32
    // (accumulator i: key 8 (i / 4) + 2t + i % 2 of row g, or row g + 8 for
    // i % 4 >= 2), keys >= kv_len at -inf (TMA gave zeros).
    auto scores = [&](float (&sc)[kN / 2], int j) {
      const int s = itk % kStages;
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) sc[i] = 0.f;
      sm90::mbar_wait(k_full(c, s), (itk / kStages) & 1);
      sm90::fence_regs<kN / 2>(sc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss<kN>(sc, desc_o(o_base, h * (D / 16) + kk), desc_k(s, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<kN / 2>(sc);
      if (lane == 0) sm90::mbar_arrive(k_empty(c, s));
      ++itk;
      const int k0 = j * kN;
      if (k0 + kN > kv_len) {  // the ragged last tile
#pragma unroll
        for (int i = 0; i < kN / 2; ++i)
          if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= kv_len) sc[i] = neg_inf;
      }
    };

    if constexpr (kTwoPass) {  // the rows' final max, before any p
      for (int j = 0; j < n_tiles; ++j) {
        float sc[kN / 2];
        scores(sc, j);
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
        m_run[r] = fmaxf(m_run[r], p.max_floor);
      }
    }

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    for (int j = 0; j < n_tiles; ++j, ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      float sc[kN / 2];
      scores(sc, j);

      // Online softmax.  Tile 0 holds key 0 (kv_len >= 1), so the running
      // max is finite from the first tile on.  Under the knob it is final.
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
      sm90::mbar_wait(v_full(c, s), parity);
      sm90::fence_regs<D / 2>(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) sm90::wgmma_rs_tb<D>(o, pf[kk], desc_v(s, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<D / 2>(o);
      sm90::fence_regs<kN / 4>(&pf[0][0]);
      if (lane == 0) sm90::mbar_arrive(v_empty(c, s));
    }

    // Row sums across the four threads of each row group, then o / l
    // rounded to bf16 into the head's boxes of O, over its Q (this warp's
    // rows only: its last Q K^T has retired).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {
      const int box = h * kHeadBoxes + (i >> 5);  // column 8 (i / 4) + 2t of the head
      const int chunk = (i >> 2) & 7;             // its 16 bytes within the box's row
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + g + 8 * half;
        const float l = l_run[half];
        *reinterpret_cast<uint32_t*>(smem + kOOff + box * kBoxBytes + r * 128 +
                                     ((chunk ^ (r & 7)) << 4) + 4 * t) =
            pack_bf16(o[i + 2 * half] / l, o[i + 2 * half + 1] / l);
      }
    }
  }
  sm90::fence_proxy_async();  // the outputs, before wgmma reads them
  sm90::named_barrier_sync(1 + kConsumers, 128 * kConsumers);  // every head's output is in O

  // out = O W_out, this consumer's chunks of 128 output columns.
  float* out_rows = p.out + ((long long)b * p.n + q0) * hd;
  const int rows = p.n - q0;
  int wit = 0;  // W slots consumed
  for (int chunk = c; chunk < chunks; chunk += kConsumers) {
    const int n0 = chunk * kChunk;
    if (hd - n0 >= kChunk)
      project<kChunk>(out_rows, hd, n0, rows, o_base, ring(c), w_full(c), w_empty(c), wit, warp,
                      lane);
    else
      project<kBox>(out_rows, hd, n0, rows, o_base, ring(c), w_full(c), w_empty(c), wit, warp,
                    lane);
  }
}

template <int D>
cudaError_t launch(const bf16* qkv, const bf16* w, float* out, int batch, int n, int heads,
                   int kv_len, float q_scale, int mode, cudaStream_t stream) {
  const int hd = heads * D;
  OutParams p;
  const attn::Strides st{(long long)n * 3 * hd, 3LL * hd, D};
  cudaError_t err = attn::make_map(&p.q, qkv, st, D, heads, n, batch, kRows);
  if (err == cudaSuccess) err = attn::make_map(&p.k, qkv + hd, st, D, heads, kv_len, batch, kN);
  if (err == cudaSuccess) err = attn::make_map(&p.v, qkv + 2 * hd, st, D, heads, kv_len, batch, kN);
  if (err == cudaSuccess) err = make_map_2d(&p.w, w, hd, hd, hd, kWRows);
  if (err != cudaSuccess) return err;
  p.out = out;
  p.n = n;
  p.heads = heads;
  p.kv_len = kv_len;
  p.q_scale = q_scale;
  p.max_floor = softmax::max_floor(mode);
  const size_t smem = smem_bytes<D>(hd);
  auto kernel = softmax::variant(mode) == softmax::kPoly
                    ? qkv_out_attention_kernel<D, softmax::kPoly>
                    : qkv_out_attention_kernel<D, softmax::kExact>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRows - 1) / kRows, batch);
  kernel<<<grid, threads<D>(), smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  qkv [B, N, 3*H*D] and w_out [H*D, H*D]
// are contiguous bf16 device tensors (16-byte aligned), out a contiguous
// fp32 [B, N, H*D] buffer; q_scale is scale * log2 e; `stream` is a
// cudaStream_t.  Returns the cudaError_t of the launch (0 = cudaSuccess),
// or cudaErrorInvalidValue before any launch for a shape it does not take
// (head_dim 64 or 128, H*D a multiple of 64 up to 1024, 1 <= kv_len <= n).
// The `_knob` entry takes the exp mode before the stream: 0 as the plain
// entry, 1 DENSECLIP_FAST_EXP2 against the row max, 2 against it floored
// at 0 (ops/mha_kernel.py::softmax_modes).
extern "C" int qkv_out_attention_bf16_knob(const void* qkv, const void* w, void* out, int batch,
                                           int n, int heads, int head_dim, int kv_len,
                                           float q_scale, int exp_mode, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n ||
      (head_dim != 64 && head_dim != 128) || heads * head_dim > kMaxWidth ||
      exp_mode < softmax::kExact || exp_mode > softmax::kPolyZeroed)
    return (int)cudaErrorInvalidValue;
  const auto* q = static_cast<const bf16*>(qkv);
  const auto* wb = static_cast<const bf16*>(w);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return (int)launch<64>(q, wb, o, batch, n, heads, kv_len, q_scale, exp_mode, s);
  return (int)launch<128>(q, wb, o, batch, n, heads, kv_len, q_scale, exp_mode, s);
}

extern "C" int qkv_out_attention_bf16(const void* qkv, const void* w, void* out, int batch,
                                      int n, int heads, int head_dim, int kv_len,
                                      float q_scale, void* stream) {
  return qkv_out_attention_bf16_knob(qkv, w, out, batch, n, heads, head_dim, kv_len, q_scale,
                                     softmax::kExact, stream);
}
