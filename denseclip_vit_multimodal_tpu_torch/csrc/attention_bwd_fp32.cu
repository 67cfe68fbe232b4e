// The fp32 attention backwards: K2 (off the fused QKV projection) and K3's
// backward (on strided q / k / v), both under the TPU `_bwd_kernel`'s
// numerics, and K4b (the long-sequence flash backward) under the bundled
// kernels'.  All three instantiate the SIMT core attention_bwd_fp32.cuh,
// whose header note gives the TPU kernels replaced, the numerics, the design
// and the bound on an H100.  This file holds the kernels' names and the
// plain C entry points.

#include "attention_bwd_fp32.cuh"

namespace {

using namespace dclip::f32;

template <class P, int D>  // TpuBwd, or TpuPolyBwd under DENSECLIP_FAST_EXP2
__global__ void __launch_bounds__(kThreads, BwdCfg<D>::kDqMinBlocks)
oneshot_bwd_fp32_dq_kernel(const BwdArgs a) {
  dq<P, D>(a);
}

template <class P, int D>
__global__ void __launch_bounds__(kThreads, BwdCfg<D>::kDkdvMinBlocks)
oneshot_bwd_fp32_dkdv_kernel(const BwdArgs a) {
  dkdv<P, D>(a);
}

template <int D>
__global__ void __launch_bounds__(kThreads, BwdCfg<D>::kDqMinBlocks)
bundled_bwd_fp32_dq_kernel(const BwdArgs a) {
  dq<BundledBwd, D>(a);
}

template <int D>
__global__ void __launch_bounds__(kThreads, BwdCfg<D>::kDkdvMinBlocks)
bundled_bwd_fp32_dkdv_kernel(const BwdArgs a) {
  dkdv<BundledBwd, D>(a);
}

template <class P, int D>
cudaError_t go(const BwdArgs& a, int batch, cudaStream_t s) {
  if constexpr (P::kPrescaled)
    return launch_bwd<P, D>(oneshot_bwd_fp32_dq_kernel<P, D>, oneshot_bwd_fp32_dkdv_kernel<P, D>,
                            a, batch, s);
  else
    return launch_bwd<P, D>(bundled_bwd_fp32_dq_kernel<D>, bundled_bwd_fp32_dkdv_kernel<D>, a,
                            batch, s);
}

// Head dim 64, 128 (and 256 with `d256`); anything else:
// cudaErrorInvalidValue, nothing launched.
template <class P>
int dispatch(int head_dim, bool d256, const BwdArgs& a, int batch, void* stream) {
  if (batch < 1 || a.n < 1 || a.heads < 1 || a.kv_len < 1 || a.kv_len > a.n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)go<P, 64>(a, batch, s);
  if (head_dim == 128) return (int)go<P, 128>(a, batch, s);
  if (head_dim == 256 && d256) return (int)go<P, 256>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points for ctypes.  Each launches two kernels on `stream` (a
// cudaStream_t) and returns the cudaError_t of the launches (0 =
// cudaSuccess).  stats is the fp32 [B, H, N, 2] buffer the fp32 forward
// filled; q_scale = scale * log2 e, scale the softmax scale.

namespace {

// K2: qkv / dqkv [B, N, 3*H*D] and out / dout [B, N, H*D] are contiguous fp32
// device tensors (16-byte aligned); dcoef is fp32 [B, H, N] scratch (Dc,
// written by the dq kernel for the dk/dv kernel); head dim 64 or 128.
template <class P>
int qkv_bwd(const void* qkv, const void* out, const void* dout,
            const void* stats, void* dcoef, void* dqkv, int batch,
            int n, int heads, int head_dim, int kv_len, float q_scale,
            float scale, void* stream){
  const auto* x = static_cast<const float*>(qkv);
  auto* dx = static_cast<float*>(dqkv);
  const long long hd = (long long)heads * head_dim;
  const Strides fused{(long long)n * 3 * hd, 3 * hd, head_dim};
  const Strides flat{(long long)n * hd, hd, head_dim};
  const BwdArgs a{x, x + hd, x + 2 * hd, static_cast<const float*>(out),
                  static_cast<const float*>(dout), static_cast<const float2*>(stats),
                  static_cast<float*>(dcoef), dx, dx + hd, dx + 2 * hd,
                  fused, fused, fused, flat, flat, fused, fused, fused,
                  n, heads, kv_len, 0, q_scale, scale};
  return dispatch<P>(head_dim, false, a, batch, stream);
}

// K3's backward: q / k / v are fp32 [B, N, H, D] device tensors with unit
// stride over D, 16-byte aligned, whose batch / token / head strides (in
// elements, multiples of 4) are given; out, dout, dq, dk and dv are
// contiguous fp32 [B, N, H, D]; dcoef as K2's; head dim 64, 128 or 256.
template <class P>
int mha_bwd(const void* q, const void* k, const void* v,
            const void* out, const void* dout, const void* stats,
            void* dcoef, void* dq, void* dk, void* dv,
            long long q_sb, long long q_sn, long long q_sh,
            long long k_sb, long long k_sn, long long k_sh,
            long long v_sb, long long v_sn, long long v_sh,
            int batch, int n, int heads, int head_dim, int kv_len,
            float q_scale, float scale, void* stream){
  const long long hd = (long long)heads * head_dim;
  const Strides flat{(long long)n * hd, hd, head_dim};
  const BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(out),
                  static_cast<const float*>(dout), static_cast<const float2*>(stats),
                  static_cast<float*>(dcoef), static_cast<float*>(dq), static_cast<float*>(dk),
                  static_cast<float*>(dv), Strides{q_sb, q_sn, q_sh}, Strides{k_sb, k_sn, k_sh},
                  Strides{v_sb, v_sn, v_sh}, flat, flat, flat, flat, flat,
                  n, heads, kv_len, 0, q_scale, scale};
  return dispatch<P>(head_dim, true, a, batch, stream);
}

}  // namespace

extern "C" int qkv_attention_bwd_fp32(const void* qkv, const void* out, const void* dout,
                                      const void* stats, void* dcoef, void* dqkv, int batch,
                                      int n, int heads, int head_dim, int kv_len, float q_scale,
                                      float scale, void* stream) {
  return qkv_bwd<TpuBwd>(qkv, out, dout, stats, dcoef, dqkv, batch, n, heads, head_dim, kv_len,
                         q_scale, scale, stream);
}

// K2 under DENSECLIP_FAST_EXP2 (`fast_exp2` nonzero: p by the polynomial
// from the stats of K1 under the same knob; zero: K2 as above).
extern "C" int qkv_attention_bwd_fp32_knob(const void* qkv, const void* out, const void* dout,
                                           const void* stats, void* dcoef, void* dqkv, int batch,
                                           int n, int heads, int head_dim, int kv_len,
                                           float q_scale, float scale, int fast_exp2,
                                           void* stream) {
  return (fast_exp2 ? qkv_bwd<TpuPolyBwd> : qkv_bwd<TpuBwd>)(
      qkv, out, dout, stats, dcoef, dqkv, batch, n, heads, head_dim, kv_len, q_scale, scale,
      stream);
}

extern "C" int mha_attention_bwd_fp32(const void* q, const void* k, const void* v,
                                      const void* out, const void* dout, const void* stats,
                                      void* dcoef, void* dq, void* dk, void* dv,
                                      long long q_sb, long long q_sn, long long q_sh,
                                      long long k_sb, long long k_sn, long long k_sh,
                                      long long v_sb, long long v_sn, long long v_sh,
                                      int batch, int n, int heads, int head_dim, int kv_len,
                                      float q_scale, float scale, void* stream) {
  return mha_bwd<TpuBwd>(q, k, v, out, dout, stats, dcoef, dq, dk, dv, q_sb, q_sn, q_sh, k_sb,
                         k_sn, k_sh, v_sb, v_sn, v_sh, batch, n, heads, head_dim, kv_len,
                         q_scale, scale, stream);
}

// K3's backward under DENSECLIP_FAST_EXP2 (`fast_exp2` as K2's).
extern "C" int mha_attention_bwd_fp32_knob(const void* q, const void* k, const void* v,
                                           const void* out, const void* dout, const void* stats,
                                           void* dcoef, void* dq, void* dk, void* dv,
                                           long long q_sb, long long q_sn, long long q_sh,
                                           long long k_sb, long long k_sn, long long k_sh,
                                           long long v_sb, long long v_sn, long long v_sh,
                                           int batch, int n, int heads, int head_dim, int kv_len,
                                           float q_scale, float scale, int fast_exp2,
                                           void* stream) {
  return (fast_exp2 ? mha_bwd<TpuPolyBwd> : mha_bwd<TpuBwd>)(
      q, k, v, out, dout, stats, dcoef, dq, dk, dv, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb,
      v_sn, v_sh, batch, n, heads, head_dim, kv_len, q_scale, scale, stream);
}

// K4b: q / k / v as K3's backward; dout, dq, dk and dv contiguous fp32
// [B, N, H, D]; di fp32 [B, H, N] = rowsum(O * dO); `causal` nonzero masks
// keys after the query; head dim 64, 128 or 256.  Launches the dk/dv kernel,
// then the dq kernel.
extern "C" int flash_attention_bwd_fp32(const void* q, const void* k, const void* v,
                                        const void* dout, const void* stats, const void* di,
                                        void* dq, void* dk, void* dv,
                                        long long q_sb, long long q_sn, long long q_sh,
                                        long long k_sb, long long k_sn, long long k_sh,
                                        long long v_sb, long long v_sn, long long v_sh,
                                        int batch, int n, int heads, int head_dim, int kv_len,
                                        int causal, float sm_scale, void* stream) {
  const long long hd = (long long)heads * head_dim;
  const Strides flat{(long long)n * hd, hd, head_dim};
  const BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), nullptr, static_cast<const float*>(dout),
                  static_cast<const float2*>(stats),
                  const_cast<float*>(static_cast<const float*>(di)), static_cast<float*>(dq),
                  static_cast<float*>(dk), static_cast<float*>(dv), Strides{q_sb, q_sn, q_sh},
                  Strides{k_sb, k_sn, k_sh}, Strides{v_sb, v_sn, v_sh}, flat, flat, flat, flat,
                  flat, n, heads, kv_len, causal != 0, 0.f, sm_scale};
  return dispatch<BundledBwd>(head_dim, true, a, batch, stream);
}
