// The fp32 attention forwards: K1 off the fused QKV projection, K3 on
// strided q / k / v (both under the TPU kernels' numerics) and K4, long or
// causal sequences (under the bundled kernel's).  All three instantiate the
// SIMT core attention_fp32.cuh, whose header note gives the TPU kernels
// replaced, the numerics, the design and the bound on an H100; they differ
// in addressing and policy only.  This file holds the kernels' names and the
// plain C entry points, with the bf16 entries' signatures.

#include "attention_fp32.cuh"

namespace {

using namespace dclip::f32;

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kFwdMinBlocks)
qkv_attention_fp32_kernel(const Args a) {
  forward<TpuPolicy, D>(a);
}

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kFwdMinBlocks)
mha_attention_fp32_kernel(const Args a) {
  forward<TpuPolicy, D>(a);
}

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kFwdMinBlocks)
flash_attention_fp32_kernel(const Args a) {
  forward<BundledPolicy, D>(a);
}

bool bad_sizes(int batch, int n, int heads, int kv_len) {
  return batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n;
}

}  // namespace

// Plain C entry points for ctypes; each returns the cudaError_t of the
// launch (0 = cudaSuccess) and launches on `stream` (a cudaStream_t).
// `stats` is null, or an fp32 [B, H, N, 2] buffer that receives each query
// row's max of the logits (log2 units) and its row sum, for the backward
// (attention_bwd_fp32.cu).

// K1: qkv is a contiguous fp32 [B, N, 3*H*D] device tensor (16-byte
// aligned), out a contiguous fp32 [B, N, H*D] one; head dim 64 or 128;
// q_scale = scale * log2 e.
extern "C" int qkv_attention_fp32(const void* qkv, void* out, void* stats, int batch, int n,
                                  int heads, int head_dim, int kv_len, float q_scale,
                                  void* stream) {
  if (bad_sizes(batch, n, heads, kv_len)) return (int)cudaErrorInvalidValue;
  const auto* base = static_cast<const float*>(qkv);
  const long long hd = (long long)heads * head_dim;
  const Strides st{(long long)n * 3 * hd, 3 * hd, head_dim};
  const Args a{base, base + hd, base + 2 * hd, static_cast<float*>(out),
               static_cast<float2*>(stats), st, st, st, n, heads, kv_len, 0, q_scale, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)launch<64>(qkv_attention_fp32_kernel<64>, a, batch, s);
  if (head_dim == 128) return (int)launch<128>(qkv_attention_fp32_kernel<128>, a, batch, s);
  return (int)cudaErrorInvalidValue;
}

// K3: q / k / v are fp32 [B, N, H, D] device tensors with unit stride over
// D, 16-byte aligned, whose batch / token / head strides (in elements,
// multiples of 4) are given; out is a contiguous fp32 [B, N, H, D] buffer;
// head dim 64, 128 or 256; q_scale = scale * log2 e.
extern "C" int mha_attention_fp32(const void* q, const void* k, const void* v, void* out,
                                  void* stats,
                                  long long q_sb, long long q_sn, long long q_sh,
                                  long long k_sb, long long k_sn, long long k_sh,
                                  long long v_sb, long long v_sn, long long v_sh,
                                  int batch, int n, int heads, int head_dim, int kv_len,
                                  float q_scale, void* stream) {
  if (bad_sizes(batch, n, heads, kv_len)) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<float*>(out),
               static_cast<float2*>(stats), Strides{q_sb, q_sn, q_sh}, Strides{k_sb, k_sn, k_sh},
               Strides{v_sb, v_sn, v_sh}, n, heads, kv_len, 0, q_scale, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)launch<64>(mha_attention_fp32_kernel<64>, a, batch, s);
  if (head_dim == 128) return (int)launch<128>(mha_attention_fp32_kernel<128>, a, batch, s);
  if (head_dim == 256) return (int)launch<256>(mha_attention_fp32_kernel<256>, a, batch, s);
  return (int)cudaErrorInvalidValue;
}

// K4: q / k / v and out as K3's; `causal` nonzero excludes keys after the
// query; sm_scale is the softmax scale (applied to the scores).
extern "C" int flash_attention_fp32(const void* q, const void* k, const void* v, void* out,
                                    void* stats,
                                    long long q_sb, long long q_sn, long long q_sh,
                                    long long k_sb, long long k_sn, long long k_sh,
                                    long long v_sb, long long v_sn, long long v_sh,
                                    int batch, int n, int heads, int head_dim, int kv_len,
                                    int causal, float sm_scale, void* stream) {
  if (bad_sizes(batch, n, heads, kv_len)) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<float*>(out),
               static_cast<float2*>(stats), Strides{q_sb, q_sn, q_sh}, Strides{k_sb, k_sn, k_sh},
               Strides{v_sb, v_sn, v_sh}, n, heads, kv_len, causal != 0, 1.f, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)launch<64>(flash_attention_fp32_kernel<64>, a, batch, s);
  if (head_dim == 128) return (int)launch<128>(flash_attention_fp32_kernel<128>, a, batch, s);
  if (head_dim == 256) return (int)launch<256>(flash_attention_fp32_kernel<256>, a, batch, s);
  return (int)cudaErrorInvalidValue;
}
