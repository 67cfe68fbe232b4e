// Non-causal softmax attention read straight off the fused QKV projection.
//
// Replaces the TPU kernel `_qkv_kernel` of the JAX package
// (denseclip_vit_multimodal_tpu/ops/mha_kernel.py, reached through
// `_qkv_fwd_impl` / `mha_qkv_attention`).  Same function, Hopper tiling:
//
//   qkv [B, N, 3*H*D] bf16  ->  out [B, N, H*D] bf16,   D in {64, 128}
//   q, k, v of head h are read in place by stride: columns h*D, H*D + h*D
//   and 2*H*D + h*D of every token row (no head split, no transpose).
//
// Numerics follow the TPU kernel's rounding points:
//   * q * (scale * log2 e) is computed in fp32 and rounded to bf16 before
//     Q K^T (the constant itself stays fp32);
//   * scores are fp32 (bf16 x bf16 products, fp32 accumulation);
//   * the softmax uses exp2; P is rounded to bf16 for P V, which accumulates
//     in fp32; the row sum is taken over the fp32 P;
//   * one division by the row sum on the output.
// Keys >= valid_len are masked exactly (and never loaded), so the TPU
// kernel's zero-pad mass subtraction (mha_kernel.py:416-436) is not needed:
// any N is accepted and the ragged edge of the last K/V tile is masked here.
//
// Design.  The TPU kernel keeps a head's whole K/V in VMEM and runs a
// one-shot softmax.  On Hopper K+V of one head at N = 1536 is 384 KB of bf16,
// more than the 227 KB of shared memory a block may use, so this kernel
// streams K/V through shared memory in tiles of 128 keys with an online
// softmax in fp32 (flash-attention style): the body in attention_fwd.cuh,
// which K3 (mha_attention.cu) and K6 (ln_qkv_attention.cu) share.  Here it
// reads q, k and v of head h as strided views of the fused projection (row
// stride 3*H*D) through TMA tensor maps.  A producer warpgroup keeps the
// tiles in flight; consumer warpgroups of 64 query rows (three at D = 64,
// two at D = 128) run both products as wgmma, the softmax in registers.
//
// Bound on an H100 SXM at the slide shape [10, 1536, 2304], valid_len 1522,
// H 12, D 64: 4*B*H*N*valid_len*D = 71.8 GFLOP of bf16 tensor-core work
// (0.0726 ms at 989 TFLOP/s) against 94 MB of qkv/out traffic (0.028 ms at
// 3.35 TB/s), and 281 M exp2 (about 0.07 ms on the special-function
// units): compute-bound.  Measured 0.180-0.184 ms (the mma.sync body before it: 0.470),
// about the products and the exp2 added; the source note of
// attention_fwd.cuh says why.

#include "attention_fwd.cuh"

namespace {

using namespace dclip;

template <int D>
__global__ void __launch_bounds__(attn::threads<D>(), 1)
qkv_attention_kernel(const __grid_constant__ attn::Params p) {
  attn::forward<attn::TpuPolicy, D>(p);
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers of
// contiguous bf16 tensors (16-byte aligned); `stream` is a cudaStream_t.
// `stats` is null, or an fp32 [B, H, N, 2] buffer that receives each query
// row's softmax max (log2 units) and row sum, which the backward
// (qkv_attention_bwd.cu) reads instead of recomputing them.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int qkv_attention_bf16(const void* qkv, void* out, void* stats,
                                  int batch, int n, int heads, int head_dim,
                                  int kv_len, float q_scale, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n)
    return (int)cudaErrorInvalidValue;
  const auto* base = static_cast<const __nv_bfloat16*>(qkv);
  const long long hd = (long long)heads * head_dim;
  const attn::Strides st{(long long)n * 3 * hd, 3 * hd, head_dim};
  const attn::Args a{base, base + hd, base + 2 * hd, static_cast<__nv_bfloat16*>(out),
                     static_cast<float2*>(stats), st, st, st, n, heads, kv_len, 0, q_scale, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)attn::launch<64>(qkv_attention_kernel<64>, a, batch, s);
  if (head_dim == 128) return (int)attn::launch<128>(qkv_attention_kernel<128>, a, batch, s);
  return (int)cudaErrorInvalidValue;
}
