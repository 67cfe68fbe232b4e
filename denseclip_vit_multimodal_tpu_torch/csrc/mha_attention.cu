// One-shot softmax attention on [B, N, H, D] (K3).
//
// Replaces the TPU kernel `_kernel` of the JAX package
// (denseclip_vit_multimodal_tpu/ops/mha_kernel.py, reached through
// `_mha_fwd_impl` / `mha_attention`, and from `ops/attention.py::
// flash_attention` for non-causal sequences of at most 8448 tokens).  Same
// function, Hopper tiling:
//
//   q, k, v [B, N, H, D] bf16, read by stride (row stride 3*H*D when they
//   are views of the fused qkv projection), D in {64, 128, 256}
//   out     [B, N, H, D] bf16, contiguous
//
// Numerics follow the TPU kernel's rounding points, which are K1's:
// q * (scale * log2 e) in fp32 rounded to bf16 (the constant stays fp32),
// fp32 scores, exp2 softmax, P rounded to bf16 for P V with fp32
// accumulation, one division by the fp32 row sum.  The TPU kernel pads N to
// a multiple of 128 and masks columns >= valid_len with finfo.min; here
// keys >= valid_len are never loaded, which gives them the same weight 0.
//
// Design.  K1's body (attention_fwd.cuh) with separate base pointers and
// strides for q, k and v, each read through its own TMA tensor map: K/V
// streamed through shared memory in tiles of 128 keys (64 at D = 256) with
// an online fp32 softmax, because a head's whole K/V, which the TPU kernel
// keeps in VMEM, exceeds the 227 KB of shared memory a block may use.  Both
// products run as wgmma; at D = 256 the O accumulator takes 128 of a
// consumer's 240 registers.
//
// Bound on an H100 SXM at the slide shape [10, 1536, 12, 64], valid_len
// 1522: 4*B*H*N*valid_len*D = 71.8 GFLOP of bf16 tensor-core work (0.0726 ms
// at 989 TFLOP/s) against 94 MB of q/k/v/out traffic (0.028 ms at
// 3.35 TB/s), and 281 M exp2 (about 0.07 ms): compute-bound.  Measured
// 0.180-0.184 ms (the mma.sync body before it: 0.470).

#include "attention_fwd.cuh"

namespace {

using namespace dclip;

template <int D>
__global__ void __launch_bounds__(attn::threads<D>(), 1)
mha_attention_kernel(const __grid_constant__ attn::Params p) {
  attn::forward<attn::TpuPolicy, D>(p);
}

}  // namespace

// Plain C entry point for ctypes.  q / k / v are device pointers of bf16
// [B, N, H, D] tensors with unit stride over D, 16-byte aligned, whose
// batch / token / head strides (in elements, multiples of 8) are given; out
// is a contiguous bf16 [B, N, H, D] buffer.  `stats` is null, or an fp32
// [B, H, N, 2] buffer that receives each query row's softmax max (log2
// units) and row sum for the backward (qkv_attention_bwd.cu).  q_scale is
// scale * log2 e.  `stream` is a cudaStream_t.  Returns the cudaError_t of
// the launch.
extern "C" int mha_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                  void* stats,
                                  long long q_sb, long long q_sn, long long q_sh,
                                  long long k_sb, long long k_sn, long long k_sh,
                                  long long v_sb, long long v_sn, long long v_sh,
                                  int batch, int n, int heads, int head_dim, int kv_len,
                                  float q_scale, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n)
    return (int)cudaErrorInvalidValue;
  const attn::Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                     static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
                     static_cast<float2*>(stats), attn::Strides{q_sb, q_sn, q_sh}, attn::Strides{k_sb, k_sn, k_sh},
                     attn::Strides{v_sb, v_sn, v_sh}, n, heads, kv_len, 0, q_scale, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)attn::launch<64>(mha_attention_kernel<64>, a, batch, s);
  if (head_dim == 128) return (int)attn::launch<128>(mha_attention_kernel<128>, a, batch, s);
  if (head_dim == 256) return (int)attn::launch<256>(mha_attention_kernel<256>, a, batch, s);
  return (int)cudaErrorInvalidValue;
}
