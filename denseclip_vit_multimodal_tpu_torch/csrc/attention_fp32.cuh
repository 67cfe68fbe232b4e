// The fp32 attention forward shared by three kernels (attention_fp32.cu):
// K1 off the fused qkv projection and K3 on strided q / k / v, both under
// `TpuPolicy`, and K4 (long or causal sequences) under `BundledPolicy`; and
// its SIMT tile products, which the fused fp32 kernels (gemm_fp32.cuh) use.
// The bf16 kernels (attention_fwd.cuh) run their products on the tensor
// cores; these take the fp32 inputs of `tpu.compute_dtype: float32`, which
// the TPU kernels take too (JAX's dispatch asks nothing about the dtype).
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
//     and not rounded further: fp32 is the input dtype); s = qs k^T in fp32
//     is the logit.
//   BundledPolicy (the bundled kernel's): s = q k^T in fp32 from the
//     unscaled q, then bundled_logit(s, scale) = (s * scale) * log2 e
//     (bundled_logit.cuh, which the backward shares); with `causal`, keys
//     after the query are excluded.
//   Both: every product is an fp32 FMA (no TF32, no tensor core), summed in
//   k order from 0; the softmax uses exp2f, an online max and sum in fp32;
//   P stays fp32 for P V; one division by the row sum at the end (the TPU
//   kernels divide once as well; the bundled one renormalises per block:
//   equal up to fp32 rounding).  The backward kernels (attention_bwd_fp32.cuh)
//   form s from the same operands by 3xTF32, within a few ulp of this s.
// Under DENSECLIP_FAST_EXP2 (`forward<P, D, kPoly>`, TpuPolicy; kPolyZeroed
// with Args::max_floor 0): a first pass streams K alone for each row's
// final max, then the loop below runs with that max fixed (no rescale) and
// p = exp2_poly(s - m) (softmax_exp.cuh); the statistics carry that max and
// the sum of those p.
// Keys >= kv_len are excluded and never loaded (their tile rows are
// zero-filled by cp.async, and their scores masked to -inf), so a NaN in a
// pad row of K or V cannot reach a real row through 0 * NaN.  The TPU
// kernels pad N to 128 with zeros and subtract the pads' exp2(-m) from each
// row sum (with a floor against cancellation); a key that is never loaded
// adds nothing that needs subtracting.
//
// Design (SIMT; the products are fp32-accurate: 1xTF32 keeps about three
// digits and would miss the fp32 limits; 3xTF32 on the tensor cores is the
// later redesign, ROADMAP §2).  One block of 256 threads per (64 query
// rows, head, batch).  Q stays in shared memory (pre-scaled under
// TpuPolicy); K and V stream through shared memory in tiles of kStep keys
// (64 at D = 64, 32 at D = 128 and 256, so that Q, a two-stage K / V ring
// and the P tile fit 227 KB at D = 256) by 16-byte cp.async, tile t + 1
// in flight while tile t is used.  The threads form a 16 x 16 grid (ty =
// tid / 16, tx = tid % 16): a thread owns query rows ty + 16 i (i < 4) and,
// of each tile, keys tx + 16 j (j < kStep / 16), so the sixteen lanes of a
// half-warp own whole rows: the row max and sum are four xor-shuffles, and
// P goes through shared memory rows that only that half-warp writes and
// reads (__syncwarp, no block barrier).  Its O columns are tx * 4 + 64 c.
// Each S step reads a float4 of Q (broadcast in the half-warp) and of K
// (padded rows: conflict-free) per four FMAs a row; P V reads a float4 of
// P per four keys and a float4 of V per key.
//
// Bound on an H100 SXM: 4 B H N kv_len D FLOP of fp32 FMA work, at 66.9
// TFLOP/s (the card's fp32 peak) against a few bytes per element of q, k,
// v and out: operation-bound at every shape of the paths (the slide
// window [10, 1536, 2304] valid 1522: 71.8 GFLOP, 1.07 ms; the aug-test
// view [2, 25216, 12, 64] valid 25089: 3.87 TFLOP, 57.8 ms).  The softmax
// adds one exp2 per score on the special-function units, an eighth of the
// FMA rate (PERF.md gives the measured times).

#pragma once

#include "bundled_logit.cuh"
#include "mma_bf16.cuh"  // cp_async16, cp_async_commit, cp_async_wait
#include "softmax_exp.cuh"

namespace dclip {
namespace f32 {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kRows = 64;      // rows a block owns: ty + 16 i
constexpr int TM = kRows / 16;

struct Strides {  // in elements
  long long b, n, h;
};

// Tiling per head dim.
template <int D_>
struct Cfg {
  static constexpr int kLd = D_ + 4;                // padded fp32 row of an operand tile
  static constexpr int kStep = D_ == 64 ? 64 : 32;  // rows of a streamed tile
  static constexpr int TN = kStep / 16;             // streamed rows a thread owns
  static constexpr int kLdS = kStep + 16;           // a score tile's row: half-warps on other banks
  static constexpr int NC = D_ / 64;                // float4 column groups of an output row
  static constexpr int kFwdStages = 2;
  // blocks an SM holds: 2 where two blocks' shared memory fits
  static constexpr int kFwdMinBlocks = D_ <= 128 ? 2 : 1;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 mul4(float4 v, float s) {
  return make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s), __fmul_rn(v.z, s), __fmul_rn(v.w, s));
}

// Max / sum over the sixteen lanes of a half-warp (the lanes of one row).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][j] += sum over k < K of A[(ty + 16 i) * lda + k] * B'[(tx + 16 j) * ldb + k],
// one FMA per term in k order; B' = B * b_scale (rounded) with kScaleB.
template <int TN, int K, bool kScaleB>
__device__ __forceinline__ void mm_nt(float (&acc)[TM][TN], const float* A, int lda,
                                      const float* B, int ldb, int ty, int tx, float b_scale) {
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float4 a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = ld4(A + (ty + 16 * i) * lda + k);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      b[j] = ld4(B + (tx + 16 * j) * ldb + k);
      if constexpr (kScaleB) b[j] = mul4(b[j], b_scale);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][4 c + e] += sum over r < R of A[(ty + 16 i) * lda + r] *
// B'[r * ldb + tx * 4 + 64 c + e], in r order; B' row r = B row r times
// row_scale[r] (rounded) with kRowScale.
template <int NC, int R, bool kRowScale>
__device__ __forceinline__ void mm_nn(float (&acc)[TM][4 * NC], const float* A, int lda,
                                      const float* B, int ldb, int ty, int tx,
                                      const float* row_scale) {
#pragma unroll 2
  for (int r = 0; r < R; r += 4) {
    float4 a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = ld4(A + (ty + 16 * i) * lda + r);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 b[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        b[c] = ld4(B + (r + kk) * ldb + tx * 4 + 64 * c);
        if constexpr (kRowScale) b[c] = mul4(b[c], row_scale[r + kk]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = lane_of(a[i], kk);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[i][4 * c + 0] = fmaf(av, b[c].x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(av, b[c].y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(av, b[c].z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(av, b[c].w, acc[i][4 * c + 3]);
        }
      }
    }
  }
}

// Rows [0, rows) of a [B, N, H, D] operand at `base` (its first row) into a
// padded shared tile by 16-byte cp.async; rows >= lim are zero-filled and
// never read.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* base, long long row_stride,
                                          int rows, int lim, int tid) {
  constexpr int kVecPerRow = D / 4;
  for (int i = tid; i < rows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    const bool ok = r < lim;
    cp_async16(dst + r * (D + 4) + c, base + (long long)(ok ? r : 0) * row_stride + c,
               ok ? 16 : 0);
  }
}

// This thread's output columns (tx * 4 + 64 c) of row `row` from `acc` to
// an fp32 [B, N, H, D] operand at `base` (its (batch, head) origin).
template <int NC>
__device__ __forceinline__ void store_row(float* base, long long row_stride, int row,
                                          const float* acc, int tx) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
    *reinterpret_cast<float4*>(base + (long long)row * row_stride + tx * 4 + 64 * c) =
        make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
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

template <int D>
constexpr size_t fwd_smem() {
  using C = Cfg<D>;
  return sizeof(float) * (size_t)((kRows + C::kFwdStages * 2 * C::kStep) * C::kLd +
                                  kRows * C::kLdS);
}

template <class P, int D, int kMode = softmax::kExact>
__device__ __forceinline__ void forward(const Args& a) {
  constexpr bool kTwoPass = softmax::two_pass(kMode);
  using C = Cfg<D>;
  constexpr int kLd = C::kLd, kStep = C::kStep, TN = C::TN, kLdS = C::kLdS, NC = C::NC;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);      // [kRows][kLd]
  float* sKV = sQ + kRows * kLd;                       // [stage][K, V][kStep][kLd]
  float* sP = sKV + C::kFwdStages * 2 * kStep * kLd;   // [kRows][kLdS]

  const int n = a.n, kv_len = a.kv_len;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* kb = at(a.k, a.kst, b, h);
  const float* vb = at(a.v, a.vst, b, h);
  const int k_end = a.causal ? min(kv_len, q0 + kRows) : kv_len;
  const int n_tiles = (k_end + kStep - 1) / kStep;
  auto load_kv = [&](int stage, int k0) {
    float* dst = sKV + stage * 2 * kStep * kLd;
    load_rows<D>(dst, kb + (long long)k0 * a.kst.n, a.kst.n, kStep, kv_len - k0, tid);
    load_rows<D>(dst + kStep * kLd, vb + (long long)k0 * a.vst.n, a.vst.n, kStep, kv_len - k0,
                 tid);
  };

  auto load_k = [&](int stage, int k0) {
    load_rows<D>(sKV + stage * 2 * kStep * kLd, kb + (long long)k0 * a.kst.n, a.kst.n, kStep,
                 kv_len - k0, tid);
  };
  load_rows<D>(sQ, at(a.q, a.qst, b, h) + (long long)q0 * a.qst.n, a.qst.n, kRows, n - q0, tid);
  cp_async_commit();
  if constexpr (kTwoPass)
    load_k(0, 0);
  else
    load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed (each thread's own copies)
  __syncthreads();
  if constexpr (P::kPrescaled) {  // this half-warp's rows, in place
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float* p = sQ + (ty + 16 * i) * kLd + tx * 4 + 64 * c;
        *reinterpret_cast<float4*>(p) = mul4(ld4(p), a.q_scale);
      }
    __syncwarp();
  }

  int row_of[TM];
  float m[TM], l[TM], o[TM][4 * NC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    row_of[i] = q0 + ty + 16 * i;
    m[i] = neg_inf();
    l[i] = 0.f;  // this thread's share of the row sum
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) o[i][e] = 0.f;
  }

  if constexpr (kTwoPass) {  // the rows' final max: K alone, then K and V again
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = it * kStep;
      if (it + 1 < n_tiles)
        load_k((it + 1) & 1, k0 + kStep);
      else
        load_kv(n_tiles & 1, 0);  // the second pass's first tile, in the other stage
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      float s[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
      mm_nt<TN, D, false>(s, sQ, kLd, sKV + (it & 1) * 2 * kStep * kLd, kLd, ty, tx, 0.f);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int key = k0 + tx + 16 * j;
          if (key < kv_len && (!a.causal || key <= row_of[i]))
            m[i] = fmaxf(m[i], P::logit(s[i][j], a.scale));
        }
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) m[i] = fmaxf(row_max(m[i]), a.max_floor);
  }

  // the stages run on from the first pass: tile `it` sits in stage (it + st0) & 1
  const int st0 = kTwoPass ? n_tiles & 1 : 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kStep;
    if (it + 1 < n_tiles) load_kv((it + 1 + st0) & 1, k0 + kStep);  // prefetch the next tile
    cp_async_commit();  // (possibly empty: keeps the wait count uniform)
    cp_async_wait<1>();
    __syncthreads();
    const float* tK = sKV + ((it + st0) & 1) * 2 * kStep * kLd;
    const float* tV = tK + kStep * kLd;

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    mm_nt<TN, D, false>(s, sQ, kLd, tK, kLd, ty, tx, 0.f);

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool live = key < kv_len && (!a.causal || key <= row_of[i]);
        s[i][j] = live ? P::logit(s[i][j], a.scale) : neg_inf();
        mx = fmaxf(mx, s[i][j]);
      }
      if constexpr (kTwoPass) {  // the max is final: no rescale
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float p = softmax::knob_exp<kMode>(s[i][j], m[i]);  // exactly 0 where masked
          l[i] += p;
          sP[(ty + 16 * i) * kLdS + tx + 16 * j] = p;
        }
        continue;
      }
      // Tile 0 holds key 0, which every row sees: the max is finite from there on.
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = exp2f(m[i] - m_new);  // 0 on the first tile
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < 4 * NC; ++e) o[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = exp2f(s[i][j] - m_new);  // exactly 0 where masked
        l[i] += p;
        sP[(ty + 16 * i) * kLdS + tx + 16 * j] = p;
      }
    }
    __syncwarp();  // a half-warp reads back only the P rows it wrote
    mm_nn<NC, kStep, false>(o, sP, kLdS, tV, kLd, ty, tx, nullptr);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float sum = row_sum(l[i]);
    if (row_of[i] >= n) continue;
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) o[i][e] = o[i][e] / sum;
    store_row<NC>(a.out + ((long long)b * n * a.heads + h) * D, (long long)a.heads * D,
                  row_of[i], o[i], tx);
    if (a.stats != nullptr && tx == 0)
      a.stats[((long long)b * a.heads + h) * n + row_of[i]] = make_float2(m[i], sum);
  }
}

// Launch `kernel` (a __global__ wrapping forward<P, D>) over (q-tiles, heads,
// batch) with its dynamic shared memory.
template <int D>
cudaError_t launch(void (*kernel)(Args), const Args& a, int batch, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kRows - 1) / kRows, a.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
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
