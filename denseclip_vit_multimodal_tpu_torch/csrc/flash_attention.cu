// Long-sequence softmax attention on [B, N, H, D] (flash attention forward, K4).
//
// Replaces the bundled TPU kernel `jax.experimental.pallas.ops.tpu.
// flash_attention` (forward body `_flash_attention_kernel_single_batch`),
// which the JAX package calls at denseclip_vit_multimodal_tpu/ops/
// attention.py:130 for causal attention and for sequences longer than 8448
// tokens (the 1.25 / 1.5 / 1.75 scales of multi-scale evaluation on a
// 1024x2048 frame: 12801 / 18433 / 25089 tokens; training crops past the
// one-shot limit).
//
//   q, k, v [B, N, H, D] bf16, read by stride (row stride 3*H*D when they
//   are views of the fused qkv projection), D in {64, 128, 256}
//   out     [B, N, H, D] bf16, contiguous
//   stats   null, or [B, H, N] float2: each query row's max of the scaled
//           logits (log2 units) and its sum of exp2(s - max), the residuals
//           the backward (K4b, flash_attention_bwd.cu) reads; the bundled
//           kernel saves the same pair in natural units (m, l)
//
// Numerics follow the bundled kernel's rounding points (the forward core's
// `BundledPolicy`):
//   * s = q k^T in fp32 from the UNSCALED bf16 q, then s *= sm_scale and
//     into log2 units in fp32 (bundled_logit.cuh, the expression K4b uses);
//   * keys >= kv_len (and, when causal, keys after the query) are excluded;
//     keys >= kv_len are never loaded (the K / V tensor maps end there), so
//     a NaN in a pad row cannot reach a real row through 0 * NaN; query rows
//     past N come from TMA's zero fill and are never written;
//   * online softmax with fp32 max and sum; exp(x) is exp2(x * log2 e);
//   * P is rounded to bf16 for P V, which accumulates in fp32; the row sum is
//     taken over the fp32 P; one division by it at the end (the bundled
//     kernel renormalises at every step: equal up to fp32 rounding).
//
// Design: the forward core attention_fwd.cuh, which K1, K3 and K6 share
// under the TPU kernels' numerics.  One block per (q-tile, head, batch): a
// TMA producer warpgroup streams 128-byte-swizzled K / V tiles through
// two-stage mbarrier rings; consumer warpgroups of 64 query rows (three at
// D = 64, two at D = 128 and 256) run S = Q K^T and O += P V as wgmma and
// the online softmax in registers.  Causal blocks load the key tiles up to
// their last row only, and each consumer masks key > row on the tiles that
// reach past its first row.
//
// Bound on an H100 SXM at the largest evaluation shape [2, 25216, 12, 64],
// valid_len 25089: 4*B*H*valid_len^2*D = 3.87 TFLOP of bf16 tensor-core work
// (3.91 ms at 989 TFLOP/s) against 310 MB of q/k/v/out traffic (0.09 ms at
// 3.35 TB/s): operation-bound, and B*H*valid_len^2 = 15.1 G exp2 on the
// special-function units (16 a clock an SM: about 4 ms at 1.8 GHz) come on
// top where a consumer does not overlap them with the products.

#include "attention_fwd.cuh"

namespace {

using namespace dclip;

template <int D>
__global__ void __launch_bounds__(attn::threads<D>(), 1)
flash_attention_kernel(const __grid_constant__ attn::Params p) {
  attn::forward<attn::BundledPolicy, D>(p);
}

}  // namespace

// Plain C entry point for ctypes.  q / k / v are device pointers of bf16
// [B, N, H, D] tensors with unit stride over D, 16-byte aligned, whose
// batch / token / head strides (in elements, multiples of 8) are given; out
// is a contiguous bf16 [B, N, H, D] buffer; `stats` is null or an fp32
// [B, H, N, 2] buffer for the row residuals.  `stream` is a cudaStream_t.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    void* stats,
                                    long long q_sb, long long q_sn, long long q_sh,
                                    long long k_sb, long long k_sn, long long k_sh,
                                    long long v_sb, long long v_sn, long long v_sh,
                                    int batch, int n, int heads, int head_dim, int kv_len,
                                    int causal, float sm_scale, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n)
    return (int)cudaErrorInvalidValue;
  const attn::Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                     static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
                     static_cast<float2*>(stats), attn::Strides{q_sb, q_sn, q_sh},
                     attn::Strides{k_sb, k_sn, k_sh}, attn::Strides{v_sb, v_sn, v_sh},
                     n, heads, kv_len, causal != 0, 1.f, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)attn::launch<64>(flash_attention_kernel<64>, a, batch, s);
  if (head_dim == 128) return (int)attn::launch<128>(flash_attention_kernel<128>, a, batch, s);
  if (head_dim == 256) return (int)attn::launch<256>(flash_attention_kernel<256>, a, batch, s);
  return (int)cudaErrorInvalidValue;
}
