// Int8 softmax attention on the quantized fused QKV projection (the opt-in
// int8 serving path, `tpu.attn_impl: int8`).
//
// Replaces the TPU kernel `_qkv_int8_kernel` of the JAX package
// (denseclip_vit_multimodal_tpu/ops/mha_kernel.py, reached through
// `_qkv_int8_fwd_impl` / `mha_qkv_attention_int8`).  Same function:
//
//   q8  [B, N, 3*H*D] int8   q of head h at column h*D, k at H*D + h*D
//                            (the prologue's output; its v third is not read)
//   vt  [B, H, D, ldv] int8  v of head h key-major (row d holds the keys of
//                            head dim d; ldv = N rounded up to 16)
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
// differently from the plain version.
//
// Design.  The TPU kernel holds a head's whole K/V in VMEM and quantizes P
// against the FINAL row max.  An online softmax (K1's) would quantize P
// against running maxima and give other p8 values, and K/V of one head at
// N = 8320 is 532 KB of int8, more than the 227 KB of shared memory a block
// may use.  So each block makes two passes over the key tiles: the first
// finds the int32 row max of s (exact, and max(float(s) * mult) =
// float(max s) * mult because the multiplier is positive), the second
// recomputes s and forms p, the denominator and P V.  One block per (q-tile
// of 128 rows, head, batch); 8 warps, each owning 16 query rows.  Both
// products run on the tensor cores through mma.sync m16n8k32 (s8 x s8 ->
// s32).  The int32 S fragment is NOT the A operand layout of P V (a thread
// holds keys {2t, 2t+1} of each 8-key tile; the A operand wants
// {4t..4t+3}), so p8 goes through a per-warp 16 x 64 byte tile in shared
// memory.  V is loaded key-major (the prologue wrote it so), which makes each
// B fragment of P V one 32-bit shared load.  Keys >= kv_len are never
// loaded.
//
// Bound on an H100 SXM at the slide shape [10, 1536, 2304], valid_len 1522,
// H 12, D 64: 4*B*H*N*valid_len*D = 71.8 G int8 tensor-core operations
// (36 us at 1,979 TOPS) against ~59 MB of int8 input and bf16 output (18 us at
// 3.35 TB/s): operation-bound.  This first version is simple: synchronous
// tile loads, K read twice, no wgmma, no TMA, no warp specialisation.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block
constexpr int kBlockK = 64;           // keys per K/V tile
constexpr int kPad = 16;              // bytes of row padding against bank conflicts
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxKeys = INT_MAX / (127 * 128);  // int32 P V sums stay exact

// c += a * b: mma.sync m16n8k32, s8 inputs, s32 accumulation.  Fragments
// (g = lane / 4, t = lane % 4), four int8 per register:
//   A 16x32 row-major: a0 (row g, cols 4t..4t+3), a1 (row g+8, cols 4t..),
//                      a2 (row g, cols 16+4t..),  a3 (row g+8, cols 16+4t..)
//   B 32x8 "col":      b0 (rows 4t..4t+3, col g), b1 (rows 16+4t.., col g)
//   C 16x8:            c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, ...)
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// p8 = trunc(p * 127 + 0.5), without contraction.
__device__ __forceinline__ int quantize_p(float p) {
  return __float2int_rz(__fadd_rn(__fmul_rn(p, 127.f), 0.5f));
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
qkv_attention_int8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ vt,
                          const float* __restrict__ scales, T* __restrict__ out, int n,
                          int heads, int kv_len, int ldv, float sm_scale) {
  constexpr int kLdQK = D + kPad;       // sQ / sK row stride (bytes)
  constexpr int kLdV = kBlockK + kPad;  // sV / sP row stride (bytes)
  constexpr int kChunks = D / 16;       // 16-byte chunks per q / k row
  constexpr int kVChunks = kBlockK / 16;
  constexpr int kSteps = D / 32;          // k-steps of Q K^T
  constexpr int kKeyTiles = kBlockK / 8;  // n-tiles of Q K^T
  constexpr int kPSteps = kBlockK / 32;   // k-steps of P V
  constexpr int kOutTiles = D / 8;        // n-tiles of P V

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* sK = sQ + kBlockQ * kLdQK;
  int8_t* sV = sK + kBlockK * kLdQK;  // [D][kLdV]: the tile's keys, per head dim
  int8_t* sP = sV + D * kLdV;         // [kWarps][16][kLdV]: p8 of each warp

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const long long row_stride = 3LL * heads * D;
  const int8_t* base = q8 + (long long)b * n * row_stride;
  const int8_t* vbase = vt + ((long long)b * heads + h) * D * ldv;
  const int q_col = h * D;
  const int k_col = heads * D + h * D;
  const float* sc = scales + (long long)b * 3 * heads + h;
  const float mult = __fmul_rn(__fmul_rn(__fmul_rn(sc[0], sc[heads]), sm_scale), kLog2e);
  const float sv127 = __fdiv_rn(sc[2 * heads], 127.f);

  // Q tile (rows >= n zero) and this warp's A fragments, kept in registers.
  for (int i = tid; i < kBlockQ * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 16;
    const int row = q0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) v = *reinterpret_cast<const uint4*>(base + row * row_stride + q_col + c);
    *reinterpret_cast<uint4*>(sQ + r * kLdQK + c) = v;
  }
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int8_t* p0 = sQ + (wr + g) * kLdQK + kk * 32 + 4 * t;
    const int8_t* p1 = p0 + 8 * kLdQK;
    qf[kk][0] = ld_u32(p0);
    qf[kk][1] = ld_u32(p1);
    qf[kk][2] = ld_u32(p0 + 16);
    qf[kk][3] = ld_u32(p1 + 16);
  }

  // K tile [kBlockK][D]; keys >= kv_len are zero-filled, never loaded.
  auto load_k = [&](int k0) {
    for (int i = tid; i < kBlockK * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 16;
      const int key = k0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (key < kv_len) v = *reinterpret_cast<const uint4*>(base + key * row_stride + k_col + c);
      *reinterpret_cast<uint4*>(sK + r * kLdQK + c) = v;
    }
  };
  // V tile [D][kBlockK] from the key-major copy; the same masking.
  auto load_v = [&](int k0) {
    for (int i = tid; i < D * kVChunks; i += kThreads) {
      const int d = i / kVChunks;
      const int c = (i % kVChunks) * 16;
      const int key = k0 + c;
      const int8_t* src = vbase + (long long)d * ldv + key;
      union {
        uint4 u;
        int8_t x[16];
      } v;
      v.u = make_uint4(0u, 0u, 0u, 0u);
      if (key + 16 <= kv_len) {
        v.u = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; key + j < kv_len; ++j) v.x[j] = src[j];
      }
      *reinterpret_cast<uint4*>(sV + d * kLdV + c) = v.u;
    }
  };
  // S = Q K^T of this warp's 16 rows and the tile's 64 keys, int32.
  auto scores = [&](int s[kKeyTiles][4]) {
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const int8_t* kp = sK + (j * 8 + g) * kLdQK + kk * 32 + 4 * t;
        mma_s8(s[j], qf[kk], ld_u32(kp), ld_u32(kp + 16));
      }
    }
  };

  // Pass 1: the int32 row max over the valid keys (rows g and g + 8).
  int mx[2] = {INT_MIN, INT_MIN};
  for (int k0 = 0; k0 < kv_len; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous K tile
    load_k(k0);
    __syncthreads();
    int s[kKeyTiles][4];
    scores(s);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      const int key = k0 + j * 8 + 2 * t;
      if (key < kv_len) {
        mx[0] = max(mx[0], s[j][0]);
        mx[1] = max(mx[1], s[j][2]);
      }
      if (key + 1 < kv_len) {
        mx[0] = max(mx[0], s[j][1]);
        mx[1] = max(mx[1], s[j][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  const float m0 = __fmul_rn(__int2float_rn(mx[0]), mult);
  const float m1 = __fmul_rn(__int2float_rn(mx[1]), mult);

  // Pass 2: p, the denominator and O = p8 V.
  int8_t* sPw = sP + warp * 16 * kLdV;
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  int o[kOutTiles][4];
#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0;
  for (int k0 = 0; k0 < kv_len; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous K / V / P tiles
    load_k(k0);
    load_v(k0);
    __syncthreads();
    int s[kKeyTiles][4];
    scores(s);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      const int key = k0 + j * 8 + 2 * t;
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m = e < 2 ? m0 : m1;
        const bool valid = key + (e & 1) < kv_len;
        p[e] = valid ? exp2f(__fsub_rn(__fmul_rn(__int2float_rn(s[j][e]), mult), m)) : 0.f;
      }
      l[0] = __fadd_rn(l[0], __fadd_rn(p[0], p[1]));
      l[1] = __fadd_rn(l[1], __fadd_rn(p[2], p[3]));
      const int col = j * 8 + 2 * t;
      sPw[g * kLdV + col] = (int8_t)quantize_p(p[0]);
      sPw[g * kLdV + col + 1] = (int8_t)quantize_p(p[1]);
      sPw[(g + 8) * kLdV + col] = (int8_t)quantize_p(p[2]);
      sPw[(g + 8) * kLdV + col + 1] = (int8_t)quantize_p(p[3]);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
      const int8_t* a0 = sPw + g * kLdV + kk * 32 + 4 * t;
      const int8_t* a1 = a0 + 8 * kLdV;
      const uint32_t pf[4] = {ld_u32(a0), ld_u32(a1), ld_u32(a0 + 16), ld_u32(a1 + 16)};
#pragma unroll
      for (int dt = 0; dt < kOutTiles; ++dt) {
        const int8_t* vp = sV + (dt * 8 + g) * kLdV + kk * 32 + 4 * t;
        mma_s8(o[dt], pf, ld_u32(vp), ld_u32(vp + 16));
      }
    }
    __syncwarp();
  }

  // Row sums across the four threads of each row group, then the dequant.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
  }
  const float d0 = fmaxf(l[0], 1e-20f);
  const float d1 = fmaxf(l[1], 1e-20f);
  const int row0 = q0 + wr + g;
  const int row1 = row0 + 8;
  const long long out_stride = (long long)heads * D;
  T* out_b = out + (long long)b * n * out_stride + h * D;
  auto deq = [&](int v, float den) {
    return __fdiv_rn(__fmul_rn(__int2float_rn(v), sv127), den);
  };
#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < n) store2(out_b + row0 * out_stride + col, deq(o[dt][0], d0), deq(o[dt][1], d0));
    if (row1 < n) store2(out_b + row1 * out_stride + col, deq(o[dt][2], d1), deq(o[dt][3], d1));
  }
}

template <int D, typename T>
cudaError_t launch(const void* q8, const void* vt, const void* scales, void* out, int batch,
                   int n, int heads, int kv_len, int ldv, float sm_scale, cudaStream_t stream) {
  const size_t smem = (size_t)(kBlockQ + kBlockK) * (D + kPad) +
                      (size_t)(D + 16 * kWarps) * (kBlockK + kPad);
  cudaError_t err = cudaFuncSetAttribute(
      qkv_attention_int8_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  qkv_attention_int8_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(vt),
      static_cast<const float*>(scales), static_cast<T*>(out), n, heads, kv_len, ldv, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers of
// contiguous tensors, 16-byte aligned: q8 int8 [B, N, 3*H*D], vt int8
// [B, H, D, ldv] (ldv >= N, a multiple of 16), scales fp32 [B, 3, H], out
// [B, N, H*D] bf16 (out_bf16 = 1) or fp32 (0).  `stream` is a cudaStream_t.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int qkv_attention_int8(const void* q8, const void* vt, const void* scales, void* out,
                                  int out_bf16, int batch, int n, int heads, int head_dim,
                                  int kv_len, int ldv, float sm_scale, void* stream) {
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
                    : (int)launch<128, float>(q8, vt, scales, out, batch, n, heads, kv_len, ldv,
                                              sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
