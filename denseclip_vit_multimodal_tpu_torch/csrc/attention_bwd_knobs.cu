// K2 and K3's backward (qkv_attention_bwd.cu) under DENSECLIP_FAST_EXP2.
//
// Replaces `_bwd_kernel` (denseclip_vit_multimodal_tpu/ops/mha_kernel.py)
// as it runs with the knob set: `_exp2` -> `_exp2_poly` on the fp32 scores
// it recomputes, p = exp2_poly(s - m).  The body is the backward core
// attention_bwd.cuh under `TpuPolyPolicy`: p rebuilt from the row max and
// sum that the forward under the same knob wrote (its final max, floored at
// 0 where JAX pads the keys with zeros; the sum of its polynomial p), which
// is JAX's backward's own recomputation.  A source of its own, so that the
// default kernels (qkv_attention_bwd.cu) build unchanged and in parallel.
//
// Bound: K2's and K3's backward's (attention_bwd.cuh's note); the
// polynomial costs ALU work where exp2 took the special-function units.

#include "attention_bwd.cuh"

namespace {

using namespace dclip::bwd;

template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
qkv_bwd_poly_dq_kernel(const Args a) {
  dq<TpuPolyPolicy, C>(a);
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
qkv_bwd_poly_dkdv_kernel(const Args a) {
  dkdv<TpuPolyPolicy, C>(a);
}

struct Run {
  template <class C>
  static cudaError_t go(const Args& a, int batch, cudaStream_t s) {
    return launch<TpuPolyPolicy, C>(qkv_bwd_poly_dq_kernel<C>, qkv_bwd_poly_dkdv_kernel<C>, a,
                                    batch, s);
  }
};

}  // namespace

// Plain C entry points for ctypes: qkv_attention_bwd_bf16's and
// mha_attention_bwd_bf16's arguments, then `fast_exp2`, which must be 1
// (else cudaErrorInvalidValue before any launch).

extern "C" int qkv_attention_bwd_bf16_knob(const void* qkv, const void* out, const void* dout,
                                           const void* stats, void* dcoef, void* scratch,
                                           void* dqkv, int batch, int n, int heads, int head_dim,
                                           int kv_len, float q_scale, float scale, int fast_exp2,
                                           void* stream) {
  if (head_dim == 256 || fast_exp2 != 1) return (int)cudaErrorInvalidValue;  // K1: 64 / 128
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

extern "C" int mha_attention_bwd_bf16_knob(const void* q, const void* k, const void* v,
                                           const void* out, const void* dout, const void* stats,
                                           void* dcoef, void* scratch, void* dq, void* dk,
                                           void* dv,
                                           long long q_sb, long long q_sn, long long q_sh,
                                           long long k_sb, long long k_sn, long long k_sh,
                                           long long v_sb, long long v_sn, long long v_sh,
                                           int batch, int n, int heads, int head_dim, int kv_len,
                                           float q_scale, float scale, int fast_exp2,
                                           void* stream) {
  if (fast_exp2 != 1) return (int)cudaErrorInvalidValue;
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
