// The bundled flash kernels' softmax logit, shared by the forward core
// (attention_fwd.cuh, K4) and the backward core (attention_bwd.cuh, K4b):
// K4b rebuilds p = exp2(logit - m) from the row max m that K4 wrote, so both
// must form the logit the same way, bit for bit.  The bundled kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py:386-411) takes
// s = q k^T in fp32 from the unscaled bf16 q, then s *= sm_scale in fp32;
// exp(x) is computed as exp2(x * log2 e).  Both products are rounded on
// their own (__fmul_rn), so that the compiler never contracts the second
// one with a later subtraction of the row max into one FMA.
// ops/_build.py hashes this header into the name of every library built
// from csrc/.

#pragma once

namespace dclip {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float bundled_logit(float s, float scale) {
  return __fmul_rn(__fmul_rn(s, scale), kLog2e);
}

}  // namespace dclip
