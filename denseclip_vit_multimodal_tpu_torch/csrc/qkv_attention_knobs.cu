// K1 (qkv_attention.cu) under the JAX package's softmax knobs:
// DENSECLIP_FAST_EXP2 (the polynomial exp2, against the row max or, where
// JAX pads the keys with zeros, that max floored at 0) and
// DENSECLIP_EXP_BF16 (the bf16 exp pass of `_qkv_kernel`'s mask branch).
//
// Replaces `_qkv_kernel` (denseclip_vit_multimodal_tpu/ops/mha_kernel.py)
// as it runs with either knob set: `_exp2` -> `_exp2_poly` on the fp32
// scores, or `_softmax_unnormalized` with a bf16 p.  The body is the forward
// core attention_fwd.cuh under `kPoly` / `kBf16` (softmax_exp.cuh says why
// p is formed against the row's final max: a first pass over K); the
// default kernel, qkv_attention.cu, stays one streamed pass, and each
// source builds on its own (one nvcc each, in parallel).
//
// Bound: the function's work is K1's (attention_fwd.cuh's note); the first
// pass adds a third product, Q K^T again, which shows as a lower TFLOP/s of
// the same FLOP count (PERF.md gives the measured times).

#include "attention_fwd.cuh"

namespace {

using namespace dclip;

template <int D, int kMode>
__global__ void __launch_bounds__(attn::threads<D>(), 1)
qkv_attention_knob_kernel(const __grid_constant__ attn::Params p) {
  attn::forward<attn::TpuPolicy, D, kMode>(p);
}

template <int D>
cudaError_t run(const attn::Args& a, int batch, int mode, cudaStream_t s) {
  void (*const kernels[4])(attn::Params) = {
      nullptr, qkv_attention_knob_kernel<D, softmax::kPoly>, nullptr,
      qkv_attention_knob_kernel<D, softmax::kBf16>};
  return attn::launch_mode<D>(kernels, mode, a, batch, s);
}

}  // namespace

// Plain C entry point for ctypes: qkv_attention_bf16's arguments, then the
// exp mode (ops/mha_kernel.py: 1 EXP_POLY, 2 EXP_POLY_ZEROED, 3 EXP_BF16;
// anything else: cudaErrorInvalidValue before any launch).  `stats`
// receives each row's final max (floored under mode 2) and the sum of the
// p this mode forms.
extern "C" int qkv_attention_bf16_knob(const void* qkv, void* out, void* stats, int batch, int n,
                                       int heads, int head_dim, int kv_len, float q_scale,
                                       int exp_mode, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n)
    return (int)cudaErrorInvalidValue;
  const auto* base = static_cast<const __nv_bfloat16*>(qkv);
  const long long hd = (long long)heads * head_dim;
  const attn::Strides st{(long long)n * 3 * hd, 3 * hd, head_dim};
  const attn::Args a{base, base + hd, base + 2 * hd, static_cast<__nv_bfloat16*>(out),
                     static_cast<float2*>(stats), st, st, st, n, heads, kv_len, 0, q_scale, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)run<64>(a, batch, exp_mode, s);
  if (head_dim == 128) return (int)run<128>(a, batch, exp_mode, s);
  return (int)cudaErrorInvalidValue;
}
