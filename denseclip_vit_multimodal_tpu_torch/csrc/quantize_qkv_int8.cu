// The prologue of the int8 attention (qkv_attention_int8.cu): symmetric
// per-(batch, q/k/v, head) quantization of the fused QKV projection, and V's
// key-major copy.
//
// Replaces XLA work, not a Pallas kernel: the two fused passes beside the
// TPU kernel `_qkv_int8_kernel` in `_qkv_int8_fwd_impl`
// (denseclip_vit_multimodal_tpu/ops/mha_kernel.py, the abs-max reduce and
// the multiply + rint + cast).  Same function as the port's plain
// `quantize_qkv_int8` followed by `value_key_major` (ops/mha_kernel.py), bit
// for bit on every byte the attention kernel reads:
//
//   x [B, N, 3*H*D] bf16 or fp32 -> q8 [B, N, 3*H*D] int8 (q and k thirds),
//                                   vt [B, H, D, ldv] int8, scales [B, 3, H] fp32
//
//   * rows at or past kv_len are left out of the abs-max by never being read
//     (inf or NaN padding cannot reach the scales), and their q8 is 0;
//   * amax = max(|x|) over the valid rows and the head dim of each (batch,
//     q/k/v, head), then max(amax, 1e-6) in fp32;
//   * scales = amax / 127, inv = 127 / amax in fp32, inv rounded to x's dtype;
//   * q8 = rint(x * inv), the product rounded to x's dtype first, clamped to
//     [-128, 127] (the element at amax can round to 128: it saturates);
//   * q8's v third is not written: the attention kernel reads V from vt
//     only, so its bytes would be traffic no reader needs;
//   * vt[b, h, d, 16G + i] = q8 of v, head h, dim d, key 16G + key_at(i)
//     (0 past kv_len and in the columns [N, ldv)).  The order makes each
//     thread's int32 accumulators of S in the attention kernel the 8-bit A
//     fragment of P V as they lie (that file's note says how).
//
// Design.  Two launches.  (a) The abs-max: each thread reads one 16-byte
// column chunk of a run of rows below kv_len and keeps the largest |x| as
// fp32 bits, the lanes of one (q/k/v, head) group combine theirs by
// shuffles, and one lane folds it into amax[B, 3, H] (zeroed by the caller)
// with atomicMax on the bits: |x| >= 0 orders as an unsigned integer, so the
// maximum is the same in any order (and a NaN, above every number, wins as
// in the plain version).  (b) The rounding: one block per (64 tokens, q/k/v
// head, batch) reads x again, forms its group's scale and inv, writes q8
// (q and k groups), and for the v groups stages the 64 x D tile in shared
// memory and writes it transposed into vt, 16 keys (one group) per 16-byte
// store.
//
// Bound on an H100 SXM at the slide shape x [10, 1536, 2304] bf16, valid
// 1522: one read of x (70.8 MB) and the writes of q8's q and k thirds
// (23.6 MB) and vt (11.8 MB) at 3.35 TB/s, 0.0317 ms: bytes-bound (a few
// operations a byte).  This design reads x twice (0.0528 ms of bytes): the
// abs-max of a group must be complete before any of its elements is
// rounded, and x (70.8 MB) does not fit in L2 (50 MB) or across the SMs'
// shared memory.  A one-read design would hold one (batch, group) of x in
// one block's shared memory (1536 x 64 bf16 = 196 KB at this shape, not at
// head dim 128, fp32 or a whole-image request) and round it from there.
// Measured (tools/time_fwd_trees.py, NVIDIA H100 80GB HBM3, 700 W) 0.078-
// 0.080 ms with q8's v third written, the caller's zeroing of amax
// included; the eager PyTorch prologue before it took 0.654-0.691 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dclip {
namespace quant {

constexpr int kAmaxThreads = 128;
constexpr int kAmaxRows = 64;  // rows of x per block of the abs-max pass
constexpr int kTile = 64;      // tokens per block of the rounding pass
constexpr int kThreads = 256;
template <int D>
__host__ __device__ constexpr int tile_ld() {  // bytes of a token's row of the staged v tile
  return D + 16;
}
// Position i of a 16-key group of vt holds key key_at(i): 0 1 8 9 2 3 10 11
// 4 5 12 13 6 7 14 15.
__host__ __device__ constexpr int key_at(int i) {
  return 2 * (i >> 2) + (i & 1) + 8 * ((i >> 1) & 1);
}

struct Args {
  const void* x;  // [B, N, 3*H*D] bf16 or fp32
  unsigned* amax;  // [B, 3, H]: fp32 bits, zero on entry
  int8_t* q8;
  int8_t* vt;
  float* scales;
  int n, heads, kv_len, ldv;
};

__device__ __forceinline__ uint32_t abs_bits(float x) { return __float_as_uint(x) & 0x7fffffffu; }

template <typename T>
struct Chunk;  // 16 bytes of x

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  union {
    uint4 u;
    __nv_bfloat16 h[8];
  };
  __device__ float at(int i) const { return __bfloat162float(h[i]); }
  // x * inv in bf16 (the fp32 product rounded to bf16)
  __device__ static float times(float x, float inv) {
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, inv)));
  }
  __device__ static float round_inv(float inv) {
    return __bfloat162float(__float2bfloat16_rn(inv));
  }
};

template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  union {
    uint4 u;
    float f[4];
  };
  __device__ float at(int i) const { return f[i]; }
  __device__ static float times(float x, float inv) { return __fmul_rn(x, inv); }
  __device__ static float round_inv(float inv) { return inv; }
};

// (a) amax[b, g] = the largest |x| (fp32 bits) of group g = (q/k/v) * H +
// head over the rows below kv_len.
template <typename T, int D>
__global__ void __launch_bounds__(kAmaxThreads)
int8_prologue_amax_kernel(const __grid_constant__ Args a) {
  using C = Chunk<T>;
  constexpr int kGroup = D / C::kN;  // lanes per group: 8, 16 or 32, aligned in the warp
  const int heads = a.heads;
  const int width = 3 * heads * D;
  const int chunks = width / C::kN;
  const int c = blockIdx.x * kAmaxThreads + threadIdx.x;
  const int r0 = blockIdx.y * kAmaxRows;
  const int r1 = min(r0 + kAmaxRows, a.kv_len);
  const int b = blockIdx.z;
  unsigned m = 0;
  if (c < chunks) {
    const T* p = static_cast<const T*>(a.x) + ((long long)b * a.n + r0) * width + c * C::kN;
    for (int r = r0; r < r1; ++r, p += width) {
      C v;
      v.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
      for (int i = 0; i < C::kN; ++i) m = max(m, abs_bits(v.at(i)));
    }
  }
#pragma unroll
  for (int o = 1; o < kGroup; o <<= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (c < chunks && threadIdx.x % kGroup == 0) atomicMax(a.amax + b * 3 * heads + c / kGroup, m);
}

// (b) The scales of group blockIdx.y, and for tokens [64 x, 64 x + 64) its
// q8 (a q or k group) or its columns of vt (a v group).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
int8_prologue_quantize_kernel(const __grid_constant__ Args a) {
  using C = Chunk<T>;
  constexpr int kPer = C::kN;
  constexpr int kChunks = D / kPer;  // chunks of a row of the group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto tile = reinterpret_cast<int8_t(*)[tile_ld<D>()]>(smem_raw);  // the v group's q8

  const int t0 = blockIdx.x * kTile;
  const int grp = blockIdx.y;  // (q/k/v) * H + head
  const int b = blockIdx.z;
  const int n = a.n, heads = a.heads, kv_len = a.kv_len, ldv = a.ldv;
  const int width = 3 * heads * D;
  const bool is_v = grp >= 2 * heads;
  const T* x = static_cast<const T*>(a.x);

  const float mx = __uint_as_float(a.amax[b * 3 * heads + grp]);
  const float amax = mx < 1e-6f ? 1e-6f : mx;  // a NaN stays NaN, as torch.maximum keeps it
  const float inv = C::round_inv(__fdiv_rn(127.f, amax));
  if (blockIdx.x == 0 && threadIdx.x == 0) a.scales[b * 3 * heads + grp] = __fdiv_rn(amax, 127.f);

  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int col = (i % kChunks) * kPer;
    const int row = t0 + r;
    union {
      uint32_t w[kPer / 4];
      int8_t v[kPer];
    } out;
#pragma unroll
    for (int j = 0; j < kPer / 4; ++j) out.w[j] = 0u;
    if (row < kv_len) {
      C v;
      v.u = *reinterpret_cast<const uint4*>(x + ((long long)b * n + row) * width + grp * D + col);
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        out.v[j] = (int8_t)fminf(fmaxf(rintf(C::times(v.at(j), inv)), -128.f), 127.f);
    }
    if (!is_v && row < n) {
      int8_t* dst = a.q8 + ((long long)b * n + row) * width + grp * D + col;
      if constexpr (kPer == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(out.w[0], out.w[1]);
      else
        *reinterpret_cast<uint32_t*>(dst) = out.w[0];
    }
    if (is_v) {
#pragma unroll
      for (int j = 0; j < kPer / 4; ++j)
        *reinterpret_cast<uint32_t*>(&tile[r][col + 4 * j]) = out.w[j];
    }
  }
  if (!is_v) return;
  __syncthreads();
  // vt[b, h, d, t0 + 16 G + i] = tile[16 G + key_at(i)][d]
  const int h = grp - 2 * heads;
  int8_t* vt_bh = a.vt + ((long long)b * heads + h) * D * ldv;
  for (int i = threadIdx.x; i < D * (kTile / 16); i += kThreads) {
    const int d = i / (kTile / 16);
    const int grp16 = i % (kTile / 16);
    const int pos = t0 + 16 * grp16;
    if (pos >= ldv) continue;
    union {
      uint4 u;
      int8_t v[16];
    } keys;
#pragma unroll
    for (int j = 0; j < 16; ++j) keys.v[j] = tile[16 * grp16 + key_at(j)][d];
    *reinterpret_cast<uint4*>(vt_bh + (long long)d * ldv + pos) = keys.u;
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const int chunks = 3 * a.heads * D / Chunk<T>::kN;
  const dim3 grid_a((chunks + kAmaxThreads - 1) / kAmaxThreads,
                    (a.kv_len + kAmaxRows - 1) / kAmaxRows, batch);
  auto* amax_kernel = int8_prologue_amax_kernel<T, D>;
  amax_kernel<<<grid_a, kAmaxThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_b((a.n + kTile - 1) / kTile, 3 * a.heads, batch);
  constexpr size_t smem = kTile * tile_ld<D>();
  auto* quantize_kernel = int8_prologue_quantize_kernel<T, D>;
  quantize_kernel<<<grid_b, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace quant
}  // namespace dclip

// Plain C entry point for ctypes.  Pointers are device pointers of
// contiguous tensors, 16-byte aligned: x [B, N, 3*H*D] bf16 (in_bf16 = 1) or
// fp32 (0); amax int32 [B, 3, H], zero on entry (scratch); q8 int8
// [B, N, 3*H*D], of which the q and k thirds are written; vt int8
// [B, H, D, ldv] (ldv >= N, a multiple of 16);
// scales fp32 [B, 3, H].  `stream` is a cudaStream_t.  Two launches; returns
// the cudaError_t of the first that failed (0 = cudaSuccess).
extern "C" int quantize_qkv_int8(const void* x, int in_bf16, void* amax, void* q8, void* vt,
                                 void* scales, int batch, int n, int heads, int head_dim,
                                 int kv_len, int ldv, void* stream) {
  using namespace dclip::quant;
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n || ldv < n || ldv % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x, static_cast<unsigned*>(amax), static_cast<int8_t*>(q8), static_cast<int8_t*>(vt),
               static_cast<float*>(scales), n, heads, kv_len, ldv};
  if (head_dim == 64)
    return in_bf16 ? (int)launch<__nv_bfloat16, 64>(a, batch, s) : (int)launch<float, 64>(a, batch, s);
  if (head_dim == 128)
    return in_bf16 ? (int)launch<__nv_bfloat16, 128>(a, batch, s)
                   : (int)launch<float, 128>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}
