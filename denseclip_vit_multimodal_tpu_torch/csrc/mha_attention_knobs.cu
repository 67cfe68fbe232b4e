// K3 (mha_attention.cu) under the JAX package's softmax knobs:
// DENSECLIP_FAST_EXP2 (the polynomial exp2) and DENSECLIP_EXP_BF16 (the
// bf16 exp pass `_kernel` always reads).
//
// Replaces `_kernel` (denseclip_vit_multimodal_tpu/ops/mha_kernel.py) as it
// runs with either knob set.  The body is the forward core
// attention_fwd.cuh under `kPoly` / `kBf16` (a first pass over K for the
// row's final max, softmax_exp.cuh); mode 2 (the polynomial against the max
// floored at 0) is not a path of K3's forward: the backward of a call
// without valid_len at a ragged N runs it for the row statistics JAX's
// backward forms over its zero pad keys.
//
// Bound: K3's work (mha_attention.cu); the first pass adds Q K^T again.

#include "attention_fwd.cuh"

namespace {

using namespace dclip;

template <int D, int kMode>
__global__ void __launch_bounds__(attn::threads<D>(), 1)
mha_attention_knob_kernel(const __grid_constant__ attn::Params p) {
  attn::forward<attn::TpuPolicy, D, kMode>(p);
}

template <int D>
cudaError_t run(const attn::Args& a, int batch, int mode, cudaStream_t s) {
  void (*const kernels[4])(attn::Params) = {
      nullptr, mha_attention_knob_kernel<D, softmax::kPoly>, nullptr,
      mha_attention_knob_kernel<D, softmax::kBf16>};
  return attn::launch_mode<D>(kernels, mode, a, batch, s);
}

}  // namespace

// Plain C entry point for ctypes: mha_attention_bf16's arguments, then the
// exp mode (1, 2 or 3, as qkv_attention_knobs.cu's).
extern "C" int mha_attention_bf16_knob(const void* q, const void* k, const void* v, void* out,
                                       void* stats,
                                       long long q_sb, long long q_sn, long long q_sh,
                                       long long k_sb, long long k_sn, long long k_sh,
                                       long long v_sb, long long v_sn, long long v_sh,
                                       int batch, int n, int heads, int head_dim, int kv_len,
                                       float q_scale, int exp_mode, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n)
    return (int)cudaErrorInvalidValue;
  const attn::Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                     static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
                     static_cast<float2*>(stats), attn::Strides{q_sb, q_sn, q_sh},
                     attn::Strides{k_sb, k_sn, k_sh}, attn::Strides{v_sb, v_sn, v_sh}, n, heads,
                     kv_len, 0, q_scale, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)run<64>(a, batch, exp_mode, s);
  if (head_dim == 128) return (int)run<128>(a, batch, exp_mode, s);
  if (head_dim == 256) return (int)run<256>(a, batch, exp_mode, s);
  return (int)cudaErrorInvalidValue;
}
