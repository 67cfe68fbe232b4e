// Attention off the fused QKV projection with the out-projection fused as an
// epilogue, in fp32 (K7 on fp32 inputs): the experiment of
// tools/exp_outproj_epilogue.py.
//
// Replaces the TPU kernel `_qkv_out_kernel` of the JAX package's
// tools/exp_outproj_epilogue.py (reached through `qkv_out_attention`) on
// fp32 qkv and W_out, which the TPU kernel takes as it takes bf16:
//
//   qkv [B, N, 3*H*D] fp32 (contiguous), D in {64, 128}, H*D a multiple of
//   64;  w_out [H*D, H*D] fp32 ([in, out]: y = o @ w_out)
//   ->  out [B, N, H*D] fp32 (before the bias), contiguous.
//
// Numerics follow the TPU kernel's fp32 rounding points, per head:
//   * K1's fp32 attention (attention_fp32.cuh): q * (scale * log2 e) in
//     fp32, 3xTF32 scores, exp2 softmax, 3xTF32 P V, one division; keys >=
//     valid_len excluded exactly and never loaded (the script's iota mask;
//     its zero-pad denominator correction is the same number);
//   * under DENSECLIP_FAST_EXP2, which the TPU kernel reads through `_exp2`:
//     p = exp2_poly(s - m) against the row's final max, floored at 0 where
//     the script pads the keys with zeros (exp mode 2: no valid_len, N not a
//     multiple of 128; softmax_exp.cuh);
//   * the product of the heads' fp32 outputs with W_out, 3xTF32 products
//     summed over all H*D inputs, a k-tile at a time from zero, each added
//     with one rounding (the TPU kernel sums per lane block of heads, then
//     over the blocks: equal up to fp32 rounding).
//
// Design: two launches, counted as one K7 launch.  The TPU kernel keeps an
// fp32 [bq, H*D] block in VMEM across the heads; the bf16 kernel keeps the
// bf16 heads in shared memory (qkv_out_attention.cu), but an fp32 [64, H*D]
// block is 192 KB at H*D = 768 beside the K / V planes of the fp32 core.  So
// (a) K1's fp32 body writes every head's output into an fp32 [B, N, H*D]
// workspace (the caller's), and (b) the 3xTF32 product gemm_fp32.cuh
// multiplies it by W_out (an MN-major B in a KN plane, which mma.sync reads
// and TF32 wgmma could not).  The workspace makes one round trip through device
// memory (49 MB at the experiment's shape, about 30 us at 3.35 TB/s: noise
// beside the products).
//
// Bound on an H100 SXM at the experiment's shape [10, 1601, 2304], H 12,
// D 64: attention 4*B*H*N^2*D = 78.7 GFLOP plus the projection 2*B*N*(H*D)^2
// = 18.9 GFLOP at the 3xTF32 ceiling of 165 TFLOP/s: 0.592 ms,
// operation-bound (1.46 ms at the fp32 FMA peak; PERF.md gives the measured
// time).

#include "attention_fp32.cuh"
#include "gemm_fp32.cuh"

namespace {

using namespace dclip::f32;
namespace softmax = dclip::softmax;

template <int D, int kMode>  // softmax::kExact, or kPoly under DENSECLIP_FAST_EXP2
__global__ void __launch_bounds__(Cfg<D>::kThreads, Cfg<D>::kMinBlocks)
qkv_out_attention_fp32_kernel(const Args a) {
  forward<TpuPolicy, D, kMode>(a);
}

template <int D>
cudaError_t run_attention(const Args& a, int batch, int mode, cudaStream_t s) {
  void (*const kernels[2])(Args) = {qkv_out_attention_fp32_kernel<D, softmax::kExact>,
                                    qkv_out_attention_fp32_kernel<D, softmax::kPoly>};
  return launch_mode<D>(kernels, mode, a, batch, s);
}

}  // namespace

// Plain C entry point for ctypes.  qkv [B, N, 3*H*D], w_out [H*D, H*D], the
// workspace ws [B, N, H*D] (overwritten) and out [B, N, H*D] are contiguous
// fp32 device tensors (16-byte aligned); q_scale is scale * log2 e;
// exp_mode 0 (exp2), 1 (DENSECLIP_FAST_EXP2) or 2 (its zero-pad max);
// `stream` is a cudaStream_t.  Returns the cudaError_t of the launches (0 =
// cudaSuccess), or cudaErrorInvalidValue before any launch for a shape or
// mode it does not take.
extern "C" int qkv_out_attention_fp32(const void* qkv, const void* w, void* ws, void* out,
                                      int batch, int n, int heads, int head_dim, int kv_len,
                                      float q_scale, int exp_mode, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || kv_len < 1 || kv_len > n ||
      (head_dim != 64 && head_dim != 128) || exp_mode < softmax::kExact ||
      exp_mode > softmax::kPolyZeroed)
    return (int)cudaErrorInvalidValue;
  const auto* base = static_cast<const float*>(qkv);
  auto* o = static_cast<float*>(ws);
  const int hd = heads * head_dim;
  const Strides st{(long long)n * 3 * hd, 3LL * hd, head_dim};
  const Args a{base, base + hd, base + 2 * hd, o, nullptr, st, st, st,
               n, heads, kv_len, 0, q_scale, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = head_dim == 64 ? run_attention<64>(a, batch, exp_mode, s)
                                   : run_attention<128>(a, batch, exp_mode, s);
  if (err != cudaSuccess) return (int)err;
  const GemmArgs g{o, static_cast<const float*>(w), static_cast<float*>(out), nullptr, nullptr,
                   nullptr, nullptr, batch * n, hd, hd, 0, 1.f};
  return (int)launch_gemm<false, false>(g, s);
}
