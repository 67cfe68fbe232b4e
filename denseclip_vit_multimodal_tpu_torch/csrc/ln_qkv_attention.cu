// Fused LayerNorm + QKV projection + attention (K6).
//
// Replaces the TPU kernel `_lnqkv_kernel` of the JAX package
// (denseclip_vit_multimodal_tpu/ops/lnqkv_kernel.py, reached through
// `_lnqkv_fwd_impl` / `ln_qkv_attention`; opt-in DENSECLIP_FUSED_LNQKV=1 on
// the inference path of every pre-LN ViT block):
//
//   x [B, N, D] bf16, gamma / beta [D] fp32, W^T [3*H*d, D] bf16 (the torch
//   Linear layout: row j holds output column j), bias [3*H*d] fp32
//   -> out [B, N, H*d] bf16,   d in {64, 128}, D and H*d multiples of 128
//
// Numerics follow the TPU kernel's rounding points:
//   * LayerNorm statistics in fp32, one pass: var = max(E[x^2] - mean^2, 0);
//     y = (x - mean) * rsqrt(var + eps), then (y * gamma + beta) rounded to
//     bf16 (no FMA contraction: each step rounds as the TPU kernel's does);
//   * the projection multiplies bf16 by bf16 with fp32 accumulation and adds
//     the fp32 bias; q is then multiplied by scale * log2 e in fp32 and
//     rounded to bf16; k and v are rounded after their bias;
//   * attention as K1's (attention_fwd.cuh) on the pre-scaled q: fp32
//     scores, exp2 softmax, P rounded to bf16, fp32 P V, one division.  Keys
//     >= valid_len are excluded (the TPU kernel's finfo.min mask).  Pad rows
//     of the residual stream are not zero (LN(0) = beta), which is why no
//     zero-pad correction is used anywhere.
//
// Design.  The TPU kernel keeps LN(x) [n_pad, D] and one 128-lane block of
// K/V for all N resident in VMEM across q-tiles.  On Hopper K+V of one head
// at N = 1536 is 384 KB, more than an SM's 227 KB of shared memory, and
// recomputing the K/V projection per q-tile would multiply the projection's
// work by N / q-tile.  So K6 runs three launches, counted as one K6 launch:
//   (a) ln_qkv_stats_kernel: one warp per row of x, its fp32 mean and rstd
//       into a [B*N] float2 scratch (the `out` buffer, which only (c)
//       writes), summed in an order the plain version repeats bit for bit.
//       It reads x once, at its bound; the previous design recomputed the
//       statistics of 128 rows in each of its 18 column blocks.
//   (b) ln_qkv_proj_kernel: a persistent Hopper GEMM over 128 x 256 output
//       tiles with the LayerNorm as its A prologue.  A producer warpgroup
//       (one thread) keeps a 3-stage ring of raw x and W^T k-tiles, 64 deep,
//       in flight by TMA (128-byte swizzle, 2-d maps through
//       tensor_map.cuh) on full / empty mbarriers, running on into the next
//       tile.  Two consumer warpgroups of 64 rows each take their rows of
//       the raw x tile by ldmatrix as wgmma's A fragment, normalise it in
//       registers and run wgmma m64n256k16 against W^T (K-major), fp32
//       accumulators in registers, releasing a stage when the products that
//       read it retire, one k-tile behind.  (Normalising in place in shared
//       memory and running wgmma from there measured 2% slower.)  The
//       epilogue adds the bias, scales q (by column: H*d need only be a
//       multiple of 128, so a tile may straddle q and k), rounds into a
//       swizzled output tile of its own and stores it by TMA, whose map
//       clips rows >= B*N and columns >= 3*H*d, while the ring loads the
//       next tile.  No atomics: reruns are bitwise equal.
//       The previous design ran mma.sync on ldmatrix fragments with
//       cp.async double buffering, one block per tile: about 0.42 ms at the
//       slide shape.  This one measured 0.125-0.128 ms (430 TFLOP/s;
//       tools/time_fwd_trees.py, NVIDIA H100 80GB HBM3, 700 W) against
//       0.087 for F.linear: a 128 x 256 tile reads 48 KB a k-tile, 620 MB
//       at the slide shape, about what L2 delivers to the SMs in that time
//       (a variant that only loads took 0.123 ms).  Sharing W's tiles
//       between the two blocks of a cluster (TMA multicast) would cut that
//       by a third; not done.
//   (c) ln_qkv_attention_kernel: K1's body on that workspace, q_scale 1,
//       its TMA tensor maps built over the workspace at launch; under
//       DENSECLIP_FAST_EXP2 (`ln_qkv_attention_bf16_knob`), which JAX's K6
//       reads through `_softmax_unnormalized` -> `_exp2`, the body under
//       `kPoly`: a first pass over K for each row's final max, then p =
//       exp2_poly(s - m) (softmax_exp.cuh).
// LN(x) never reaches device memory; q/k/v does (71 MB at the slide shape,
// written once and read by (c)).  Keeping K/V on chip (thread-block clusters
// sharing K/V through distributed shared memory, or a persistent kernel) is
// later work.
//
// Bound on an H100 SXM at the slide shape (x [10, 1536, 768], 12 heads of
// 64, valid_len 1522): projection 2*B*N*D*3*H*d = 54.4 GFLOP plus attention
// 4*B*H*N*valid_len*d = 71.8 GFLOP of bf16 tensor-core work, 0.128 ms at
// 989 TFLOP/s (the projection alone 0.055 ms), against ~51 MB of x, W and
// out (0.015 ms at 3.35 TB/s): compute-bound.

#include "attention_fwd.cuh"

namespace {

using namespace dclip;

// ---- (a) the row statistics ----

constexpr int kStatsThreads = 256;  // one warp per row

struct StatsParams {
  const __nv_bfloat16* x;  // [rows, dim]
  float2* stats;           // [rows]: mean, rstd
  int rows, dim;
  float eps;
};

__global__ void __launch_bounds__(kStatsThreads)
ln_qkv_stats_kernel(const __grid_constant__ StatsParams p) {
  const int row = blockIdx.x * (kStatsThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= p.rows) return;  // a whole warp
  const __nv_bfloat16* xr = p.x + (long long)row * p.dim;
  float sum = 0.f, sq = 0.f;
  for (int c = lane * kVec; c < p.dim; c += 32 * kVec) {
    Vec8 v;
    v.u = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {  // no FMA: the plain version sums the same way
      const float f = __bfloat162float(v.h[j]);
      sum = __fadd_rn(sum, f);
      sq = __fadd_rn(sq, __fmul_rn(f, f));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  if (lane == 0) {
    const float mean = __fdiv_rn(sum, (float)p.dim);
    const float msq = __fdiv_rn(sq, (float)p.dim);
    const float var = fmaxf(__fsub_rn(msq, __fmul_rn(mean, mean)), 0.f);
    p.stats[row] = make_float2(mean, __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, p.eps))));
  }
}

// ---- (b) the projection ----

constexpr int kBM = 128;  // rows of x per tile: two consumer warpgroups of 64
constexpr int kBN = 256;  // output columns per tile
constexpr int kBK = 64;   // depth of a k-tile: one 128-byte swizzled row
constexpr int kStages = 3;
constexpr int kProjThreads = 384;  // the producer warpgroup + two consumers
constexpr uint32_t kXBytes = kBM * kBK * 2;  // 16 KB
constexpr uint32_t kWBytes = kBN * kBK * 2;  // 32 KB
constexpr uint32_t kOutBox = 64 * 64 * 2;    // one 64 x 64 box of the output tile, 8 KB
// Shared memory from a 1024-aligned base: x tiles [kStages][kBM][64], W^T
// tiles [kStages][kBN][64], the output tile [2 consumers][4 boxes][64][64]
// (the epilogue's, so that the ring keeps loading the next tile meanwhile),
// then the full and empty barriers.
constexpr uint32_t kWOff = kStages * kXBytes;
constexpr uint32_t kOutOff = kWOff + kStages * kWBytes;
constexpr uint32_t kBarOff = kOutOff + 2 * 4 * kOutBox;
constexpr size_t kProjSmem = kBarOff + 16 * kStages + 1024;  // + the base's alignment

struct ProjParams {
  CUtensorMap x;    // [rows, dim], boxes of 64 x kBM
  CUtensorMap w;    // W^T [3*hd, dim], boxes of 64 x kBN
  CUtensorMap out;  // the workspace [rows, 3*hd], boxes of 64 x 64
  const float* gamma;
  const float* beta;
  const float* bias;
  const float2* stats;  // [rows]: mean, rstd
  int rows, dim, hd;
  int col_tiles, tiles;
  float q_scale;
};

// (y * gamma + beta) rounded to bf16 for the two elements of `v` (the lower
// k in the low half), y = (x - mean) * rstd.
__device__ __forceinline__ uint32_t normalise2(uint32_t v, float mean, float rstd, float g0,
                                               float g1, float b0, float b1) {
  const float x0 = __uint_as_float(v << 16), x1 = __uint_as_float(v & 0xffff0000u);
  const float y0 = __fmul_rn(__fsub_rn(x0, mean), rstd);
  const float y1 = __fmul_rn(__fsub_rn(x1, mean), rstd);
  return pack_bf16(__fadd_rn(__fmul_rn(y0, g0), b0), __fadd_rn(__fmul_rn(y1, g1), b1));
}

// Persistent: block b takes tiles b, b + gridDim.x, ... of the row-major
// [row tiles][column tiles] order (neighbouring tiles share their x rows).
__global__ void __launch_bounds__(kProjThreads, 1)
ln_qkv_proj_kernel(const __grid_constant__ ProjParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  auto full = [&](int s) { return base + kBarOff + 8 * s; };
  auto empty = [&](int s) { return base + kBarOff + 8 * (kStages + s); };
  auto x_tile = [&](int s) { return base + s * kXBytes; };
  auto w_tile = [&](int s) { return base + kWOff + s * kWBytes; };
  const int k_tiles = p.dim / kBK;
  const int wg = threadIdx.x / 128;  // 0: the producer; 1, 2: consumers

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ---- producer: the ring runs on across tiles ----
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = tile / p.col_tiles * kBM, n0 = tile % p.col_tiles * kBN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % kStages;
          sm90::mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);  // a fresh barrier passes
          sm90::mbar_arrive_expect_tx(full(s), kXBytes + kWBytes);
          sm90::tma_load_2d(x_tile(s), &p.x, full(s), kt * kBK, m0);
          sm90::tma_load_2d(w_tile(s), &p.w, full(s), kt * kBK, n0);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  sm90::setmaxnreg_inc<240>();
  const int cw = wg - 1;  // rows cw*64 .. +64 of a tile
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;  // 16 rows each (wgmma's accumulator layout)
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t out_tile = base + kOutOff + cw * 4 * kOutBox;
  // W^T is K-major: 8 rows of 128 bytes per 1024-byte group (SBO); a k-step
  // of 16 columns is 32 bytes along the row.
  auto desc_w = [&](int s, int kk) { return attn::desc_sw128(w_tile(s) + kk * 32, 16, 1024); };

  // The A operand: ldmatrix gives the A fragment of the raw x tile (a0 row
  // g, k 2t..2t+1; a1 row g + 8; a2 / a3 k + 8), normalised in registers.
  // Two fragment sets, so that k-tile kt's are written while k-tile kt - 1's
  // products still read theirs; k_tiles is even (dim % 128 == 0).
  const int lrow = cw * 64 + warp * 16 + (lane & 15);  // the row this lane addresses
  float acc[kBN / 2];
  uint32_t fa[kBK / 16][4], fb[kBK / 16][4];
  float2 st[2];  // (mean, rstd) of rows g and g + 8 of this warp's 16
  int it = 0;    // k-tiles consumed: the ring's position
  // k-tile kt of the current tile into fragment set `a`; then retire k-tile
  // kt - 1's products (set `prev`) and hand its stage back to the producer.
  auto step = [&](int kt, uint32_t (&a)[kBK / 16][4], uint32_t (&prev)[kBK / 16][4]) {
    const int s = it % kStages;
    sm90::mbar_wait(full(s), (it / kStages) & 1);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const int chunk = 2 * kk + (lane >> 4);  // the swizzle permutes a row's chunks by row % 8
      ldmatrix_x4(a[kk], smem + s * kXBytes + lrow * 128 + ((chunk ^ (lrow & 7)) << 4));
      const int k = kt * kBK + 16 * kk + 2 * t;
      const float2 g0 = *reinterpret_cast<const float2*>(p.gamma + k);
      const float2 g8 = *reinterpret_cast<const float2*>(p.gamma + k + 8);
      const float2 b0 = *reinterpret_cast<const float2*>(p.beta + k);
      const float2 b8 = *reinterpret_cast<const float2*>(p.beta + k + 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 gm = i & 2 ? g8 : g0, bt = i & 2 ? b8 : b0;
        a[kk][i] = normalise2(a[kk][i], st[i & 1].x, st[i & 1].y, gm.x, gm.y, bt.x, bt.y);
      }
    }
    sm90::fence_regs<kBN / 2>(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) sm90::wgmma_rs<kBN>(acc, a[kk], desc_w(s, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs<kBN / 2>(acc);
    sm90::fence_regs<4 * kBK / 16>(&prev[0][0]);
    if (kt > 0 && lane == 0) sm90::mbar_arrive(empty((it - 1) % kStages));
    ++it;
  };

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int m0 = tile / p.col_tiles * kBM, n0 = tile % p.col_tiles * kBN;
    for (int half = 0; half < 2; ++half) {  // (0, 0) past the last row: never stored
      const int row = m0 + cw * 64 + warp * 16 + g + 8 * half;
      st[half] = row < p.rows ? p.stats[row] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; kt += 2) {
      step(kt, fa, fb);
      step(kt + 1, fb, fa);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs<kBN / 2>(acc);
    if (lane == 0) sm90::mbar_arrive(empty((it - 1) % kStages));

    // Epilogue: + fp32 bias; q columns (< hd) also * q_scale in fp32; round;
    // into this warpgroup's 64 x 256 output tile (four 128-byte-swizzled
    // 64 x 64 boxes), which one thread then stores by TMA: the map clips
    // rows >= rows and columns >= 3*hd.  Accumulator i: row g + 8 ((i / 2)
    // % 2) of this warp's 16, column 8 (i / 4) + 2t + i % 2; a pair never
    // straddles q / k / v (hd % 128 == 0).
    if (tid == 0) sm90::bulk_wait_read<0>();  // the previous tile's store has read the tile
    sm90::named_barrier_sync(1 + cw, 128);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      const float2 bias = col < 3 * p.hd ? *reinterpret_cast<const float2*>(p.bias + col)
                                         : make_float2(0.f, 0.f);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v0 = __fadd_rn(acc[4 * j + 2 * half], bias.x);
        float v1 = __fadd_rn(acc[4 * j + 2 * half + 1], bias.y);
        if (col < p.hd) {
          v0 = __fmul_rn(v0, p.q_scale);
          v1 = __fmul_rn(v1, p.q_scale);
        }
        const int r = warp * 16 + g + 8 * half;  // of this warpgroup's 64
        const int chunk = j & 7;                 // 16 bytes: columns 8 (j % 8) .. + 8 of box j / 8
        *reinterpret_cast<uint32_t*>(smem + (out_tile - base) + (j >> 3) * kOutBox + r * 128 +
                                     ((chunk ^ (r & 7)) << 4) + 4 * t) = pack_bf16(v0, v1);
      }
    }
    sm90::fence_proxy_async();  // the writes above, before the TMA store reads them
    sm90::named_barrier_sync(1 + cw, 128);
    if (tid == 0) {
      for (int box = 0; box < 4; ++box)
        sm90::tma_store_2d(&p.out, out_tile + box * kOutBox, n0 + 64 * box, m0 + cw * 64);
      sm90::bulk_commit();
    }
  }
  if (tid == 0) sm90::bulk_wait<0>();
}

// ---- (c) attention on the workspace ----

template <int D, int kMode>  // softmax::kExact, or kPoly under DENSECLIP_FAST_EXP2
__global__ void __launch_bounds__(attn::threads<D>(), 1)
ln_qkv_attention_kernel(const __grid_constant__ attn::Params p) {
  attn::forward<attn::TpuPolicy, D, kMode>(p);
}

cudaError_t run_stats(const __nv_bfloat16* x, float2* stats, int rows, int dim, float eps,
                      cudaStream_t stream) {
  const StatsParams sp{x, stats, rows, dim, eps};
  const dim3 grid((rows + kStatsThreads / 32 - 1) / (kStatsThreads / 32));
  ln_qkv_stats_kernel<<<grid, kStatsThreads, 0, stream>>>(sp);
  return cudaGetLastError();
}

cudaError_t run_projection(const __nv_bfloat16* x, const float* gamma, const float* beta,
                           const __nv_bfloat16* wt, const float* bias, const float2* stats,
                           __nv_bfloat16* qkv, int rows, int dim, int hd, float q_scale,
                           cudaStream_t stream) {
  ProjParams pp;
  cudaError_t err = make_map_2d(&pp.x, x, rows, dim, dim, kBM);
  if (err == cudaSuccess) err = make_map_2d(&pp.w, wt, 3LL * hd, dim, dim, kBN);
  if (err == cudaSuccess) err = make_map_2d(&pp.out, qkv, rows, 3LL * hd, 3LL * hd, 64);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  pp.gamma = gamma;
  pp.beta = beta;
  pp.bias = bias;
  pp.stats = stats;
  pp.rows = rows;
  pp.dim = dim;
  pp.hd = hd;
  pp.col_tiles = (3 * hd + kBN - 1) / kBN;
  pp.tiles = pp.col_tiles * ((rows + kBM - 1) / kBM);
  pp.q_scale = q_scale;
  err = cudaFuncSetAttribute(ln_qkv_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kProjSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(pp.tiles < sms ? pp.tiles : sms);
  ln_qkv_proj_kernel<<<grid, kProjThreads, kProjSmem, stream>>>(pp);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_attention(const __nv_bfloat16* qkv, __nv_bfloat16* out, int batch, int n,
                          int heads, int kv_len, int mode, cudaStream_t stream) {
  const int hd = heads * D;
  const attn::Strides st{(long long)n * 3 * hd, 3LL * hd, D};
  const attn::Args a{qkv, qkv + hd, qkv + 2 * hd, out, nullptr, st, st, st,
                     n, heads, kv_len, 0, 1.f, 0.f};
  void (*const kernels[4])(attn::Params) = {ln_qkv_attention_kernel<D, softmax::kExact>,
                                            ln_qkv_attention_kernel<D, softmax::kPoly>, nullptr,
                                            nullptr};
  return attn::launch_mode<D>(kernels, mode, a, batch, stream);
}

// (c) under exp mode `mode` (0 exact, 1 the polynomial; K6 masks its pads,
// so JAX's K6 has no zero-pad max and no bf16 exp).
cudaError_t run_attention(const void* qkv, void* out, int batch, int n, int heads, int head_dim,
                          int kv_len, cudaStream_t stream, int mode = softmax::kExact) {
  const auto* ws = static_cast<const __nv_bfloat16*>(qkv);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (head_dim == 64) return run_attention<64>(ws, o, batch, n, heads, kv_len, mode, stream);
  if (head_dim == 128) return run_attention<128>(ws, o, batch, n, heads, kv_len, mode, stream);
  return cudaErrorInvalidValue;
}

bool projection_shapes_ok(int rows, int dim, int hd) {
  return rows >= 1 && dim >= 128 && dim % 128 == 0 && hd >= 128 && hd % 128 == 0;
}

}  // namespace

// Plain C entry points for ctypes.  x, W^T and the workspace are contiguous
// bf16 device tensors (16-byte aligned); gamma, beta [D] and bias [3*H*d]
// contiguous fp32 (16-byte aligned); q_scale is scale * log2 e.  Each
// returns the cudaError_t of its launches (0 = cudaSuccess), or
// cudaErrorInvalidValue before any launch for a shape it does not take.

// The whole of K6: `qkv` a [B, N, 3*H*d] bf16 workspace the call
// overwrites, `out` a contiguous [B, N, H*d] bf16 buffer (also the
// statistics' scratch).  Needs D % 128 == 0, H*d % 128 == 0, head_dim 64 or
// 128 and 1 <= kv_len <= n.
extern "C" int ln_qkv_attention_bf16_knob(const void* x, const void* gamma, const void* beta,
                                          const void* wt, const void* bias, void* qkv, void* out,
                                          int batch, int n, int dim, int heads, int head_dim,
                                          int kv_len, float q_scale, float eps, int exp_mode,
                                          void* stream);

extern "C" int ln_qkv_attention_bf16(const void* x, const void* gamma, const void* beta,
                                     const void* wt, const void* bias, void* qkv, void* out,
                                     int batch, int n, int dim, int heads, int head_dim,
                                     int kv_len, float q_scale, float eps, void* stream) {
  return ln_qkv_attention_bf16_knob(x, gamma, beta, wt, bias, qkv, out, batch, n, dim, heads,
                                    head_dim, kv_len, q_scale, eps, softmax::kExact, stream);
}

// The whole of K6 under exp mode `exp_mode` (0 as ln_qkv_attention_bf16, 1
// DENSECLIP_FAST_EXP2; others: cudaErrorInvalidValue before any launch).
extern "C" int ln_qkv_attention_bf16_knob(const void* x, const void* gamma, const void* beta,
                                          const void* wt, const void* bias, void* qkv, void* out,
                                          int batch, int n, int dim, int heads, int head_dim,
                                          int kv_len, float q_scale, float eps, int exp_mode,
                                          void* stream) {
  const int rows = batch * n, hd = heads * head_dim;
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n ||
      (head_dim != 64 && head_dim != 128) || !projection_shapes_ok(rows, dim, hd) ||
      (exp_mode != softmax::kExact && exp_mode != softmax::kPoly))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* stats = static_cast<float2*>(out);  // `out` is written only by the attention
  auto* ws = static_cast<__nv_bfloat16*>(qkv);
  cudaError_t err = run_stats(xb, stats, rows, dim, eps, s);
  if (err == cudaSuccess)
    err = run_projection(xb, static_cast<const float*>(gamma), static_cast<const float*>(beta),
                         static_cast<const __nv_bfloat16*>(wt), static_cast<const float*>(bias),
                         stats, ws, rows, dim, hd, q_scale, s);
  if (err == cudaSuccess)
    err = run_attention(ws, out, batch, n, heads, head_dim, kv_len, s, exp_mode);
  return (int)err;
}

// K6's stages alone, for the split timings and the workspace check.
// (a) the statistics of x [rows, dim] into `stats` [rows] float2 (mean, rstd).
extern "C" int ln_qkv_stats_bf16(const void* x, void* stats, int rows, int dim, float eps,
                                 void* stream) {
  if (rows < 1 || dim < 128 || dim % 128) return (int)cudaErrorInvalidValue;
  return (int)run_stats(static_cast<const __nv_bfloat16*>(x), static_cast<float2*>(stats), rows,
                        dim, eps, static_cast<cudaStream_t>(stream));
}

// (b) the projection on those statistics into the workspace qkv [rows,
// 3*hd].
extern "C" int ln_qkv_projection_bf16(const void* x, const void* gamma, const void* beta,
                                      const void* wt, const void* bias, const void* stats,
                                      void* qkv, int rows, int dim, int hd, float q_scale,
                                      void* stream) {
  if (!projection_shapes_ok(rows, dim, hd)) return (int)cudaErrorInvalidValue;
  return (int)run_projection(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(bias), static_cast<const float2*>(stats),
      static_cast<__nv_bfloat16*>(qkv), rows, dim, hd, q_scale,
      static_cast<cudaStream_t>(stream));
}

// (c) attention on the workspace into out [B, N, H*d].
extern "C" int ln_qkv_attention_stage2_bf16(const void* qkv, void* out, int batch, int n,
                                            int heads, int head_dim, int kv_len, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n)
    return (int)cudaErrorInvalidValue;
  return (int)run_attention(qkv, out, batch, n, heads, head_dim, kv_len,
                            static_cast<cudaStream_t>(stream));
}
