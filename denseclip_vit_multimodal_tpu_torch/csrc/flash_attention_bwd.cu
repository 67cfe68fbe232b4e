// Backward of the long-sequence flash attention (K4b): the backward core
// `attention_bwd.cuh` with the bundled kernels' numerics (`BundledPolicy`),
// whose header note gives the TPU kernels replaced (the bundled
// `_flash_attention_dkv_kernel` and `_flash_attention_dq_kernel`, reached
// from the JAX package's ops/attention.py:130 when the backbone trains on
// more than 8448 tokens or through a causal tower), the bound on an H100 and
// the design.  This file holds the kernels' names and the plain C entry
// point.

#include "attention_bwd.cuh"

namespace {

using namespace dclip::bwd;

template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks) flash_bwd_dq_kernel(const Args a) {
  dq<BundledPolicy, C>(a);
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks) flash_bwd_dkdv_kernel(const Args a) {
  dkdv<BundledPolicy, C>(a);
}

struct Run {
  template <class C>
  static cudaError_t go(const Args& a, int batch, cudaStream_t s) {
    return launch<BundledPolicy, C>(flash_bwd_dq_kernel<C>, flash_bwd_dkdv_kernel<C>, a, batch, s);
  }
};

}  // namespace

// Plain C entry point for ctypes.  q / k / v are device pointers of bf16
// [B, N, H, D] tensors with unit stride over D, 16-byte aligned, whose batch /
// token / head strides (in elements, multiples of 8) are given; dout, dq, dk
// and dv are contiguous bf16 [B, N, H, D]; head dim 64, 128 or 256; stats is the
// fp32 [B, H, N, 2] buffer K4's forward filled and di fp32 [B, H, N].
// Launches the dk/dv kernel, then the dq kernel, on `stream` (a
// cudaStream_t).  Returns the cudaError_t of the launches (0 = cudaSuccess).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const void* stats, const void* di,
                                        void* dq, void* dk, void* dv,
                                        long long q_sb, long long q_sn, long long q_sh,
                                        long long k_sb, long long k_sn, long long k_sh,
                                        long long v_sb, long long v_sn, long long v_sh,
                                        int batch, int n, int heads, int head_dim, int kv_len,
                                        int causal, float sm_scale, void* stream) {
  const long long hd = (long long)heads * head_dim;
  const Strides flat{(long long)n * hd, hd, head_dim};
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), nullptr, static_cast<const bf16*>(dout),
               static_cast<const float2*>(stats),
               const_cast<float*>(static_cast<const float*>(di)), nullptr, nullptr,
               static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
               Strides{q_sb, q_sn, q_sh}, Strides{k_sb, k_sn, k_sh}, Strides{v_sb, v_sn, v_sh},
               flat, flat, flat, flat, flat, n, heads, kv_len, causal, 0.f, sm_scale};
  return dispatch<Run>(head_dim, a, batch, stream);
}
