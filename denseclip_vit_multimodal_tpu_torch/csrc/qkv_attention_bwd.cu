// Backward of the one-shot attention: K2 (off the fused QKV projection) and
// K3's backward (on separate [B, N, H, D] q / k / v).  Both instantiate the
// backward core `attention_bwd.cuh` with the TPU `_bwd_kernel`'s numerics
// (`TpuPolicy`); its header note gives the TPU kernel replaced, the bound on
// an H100 and the design.  This file holds the kernels' names and the plain
// C entry points: K2 hands over the three column blocks of qkv / dqkv (row
// stride 3*H*D, no head split, no concatenation on the host); K3's backward
// the strided views K3 read and contiguous dq / dk / dv.

#include "attention_bwd.cuh"

namespace {

using namespace dclip::bwd;

template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks) qkv_bwd_dq_kernel(const Args a) {
  dq<TpuPolicy, C>(a);
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks) qkv_bwd_dkdv_kernel(const Args a) {
  dkdv<TpuPolicy, C>(a);
}

struct Run {
  template <class C>
  static cudaError_t go(const Args& a, int batch, cudaStream_t s) {
    return launch<TpuPolicy, C>(qkv_bwd_dq_kernel<C>, qkv_bwd_dkdv_kernel<C>, a, batch, s);
  }
};

}  // namespace

// Plain C entry points for ctypes.  Both launch the dq kernel, then the dk/dv
// kernel, on `stream` (a cudaStream_t), and return the cudaError_t of the
// launches (0 = cudaSuccess).  stats is the fp32 [B, H, N, 2] buffer the
// forward filled; dcoef is fp32 [B, H, N] scratch and `scratch` bf16
// [2, B, H, N, D] scratch (16-byte aligned).  `q_scale` = scale * log2 e,
// `scale` the softmax scale.

// K2: qkv / dqkv [B, N, 3*H*D] and out / dout [B, N, H*D] are contiguous
// bf16 device tensors (16-byte aligned); head dim 64 or 128.
extern "C" int qkv_attention_bwd_bf16(const void* qkv, const void* out, const void* dout,
                                      const void* stats, void* dcoef, void* scratch, void* dqkv,
                                      int batch, int n, int heads, int head_dim, int kv_len,
                                      float q_scale, float scale, void* stream) {
  if (head_dim == 256) return (int)cudaErrorInvalidValue;  // K1 takes 64 / 128
  const auto* x = static_cast<const bf16*>(qkv);
  auto* dx = static_cast<bf16*>(dqkv);
  auto* sc = static_cast<bf16*>(scratch);
  const long long hd = (long long)heads * head_dim;
  const Strides fused{(long long)n * 3 * hd, 3 * hd, head_dim};
  const Strides flat{(long long)n * hd, hd, head_dim};
  const Args a{x, x + hd, x + 2 * hd, static_cast<const bf16*>(out),
               static_cast<const bf16*>(dout), static_cast<const float2*>(stats),
               static_cast<float*>(dcoef), sc, sc + batch * n * hd, dx, dx + hd, dx + 2 * hd,
               fused, fused, fused, flat, flat, fused, fused, fused,
               n, heads, kv_len, 0, q_scale, scale};
  return dispatch<Run>(head_dim, a, batch, stream);
}

// K3's backward: q / k / v are bf16 [B, N, H, D] device tensors with unit
// stride over D, 16-byte aligned, whose batch / token / head strides (in
// elements, multiples of 8) are given; out, dout, dq, dk and dv are
// contiguous bf16 [B, N, H, D]; head dim 64, 128 or 256.
extern "C" int mha_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                      const void* out, const void* dout, const void* stats,
                                      void* dcoef, void* scratch, void* dq, void* dk, void* dv,
                                      long long q_sb, long long q_sn, long long q_sh,
                                      long long k_sb, long long k_sn, long long k_sh,
                                      long long v_sb, long long v_sn, long long v_sh,
                                      int batch, int n, int heads, int head_dim, int kv_len,
                                      float q_scale, float scale, void* stream) {
  const long long hd = (long long)heads * head_dim;
  const Strides flat{(long long)n * hd, hd, head_dim};
  auto* sc = static_cast<bf16*>(scratch);
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(out),
               static_cast<const bf16*>(dout), static_cast<const float2*>(stats),
               static_cast<float*>(dcoef), sc, sc + batch * n * hd, static_cast<bf16*>(dq),
               static_cast<bf16*>(dk), static_cast<bf16*>(dv), Strides{q_sb, q_sn, q_sh},
               Strides{k_sb, k_sn, k_sh}, Strides{v_sb, v_sn, v_sh}, flat, flat, flat, flat, flat,
               n, heads, kv_len, 0, q_scale, scale};
  return dispatch<Run>(head_dim, a, batch, stream);
}
