// The softmax's exp under the JAX package's knobs, shared by the forward
// cores (attention_fwd.cuh, attention_fp32.cuh), K7 (qkv_out_attention.cu)
// and the backward cores (attention_bwd.cuh, attention_bwd_fp32.cuh).
// ops/_build.py hashes this header into the name of every library built
// from csrc/.
//
// Replaces `_exp2_poly` / `_exp2` and the bf16 exp pass of
// `_softmax_unnormalized` (denseclip_vit_multimodal_tpu/ops/mha_kernel.py),
// which the TPU kernels K1, K2, K3, K3's backward, K6 and K7 run when
// DENSECLIP_FAST_EXP2=1 or DENSECLIP_EXP_BF16=1.
//
// Exp modes (ops/mha_kernel.py: EXP_EXACT ... EXP_BF16, the same numbers):
//   kExact      exp2 (each core's own: ex2.approx.ftz in the bf16 cores,
//               exp2f in the fp32 ones), the online softmax;
//   kPoly       exp2_poly(s - m), m the row max of the valid keys;
//   kPolyZeroed exp2_poly(s - m), m that max floored at 0: where JAX pads N
//               to 128 with zero keys (no valid_len), their scores 0 join
//               the max (and their mass is subtracted from the sum again);
//   kBf16       bf16(exp2(bf16(s - m))), summed in fp32 (bf16 kernels only).
// Under the three knob modes p is formed against the row's FINAL max, as
// JAX's one-shot kernels form it: a polynomial or bf16 exp applied at a
// running max, then rescaled, lands as far from JAX's as no knob at all.
// So the forward cores run a first pass over K for the row max, and the
// backward cores rebuild p from the forward's max.  Masked keys weigh
// exactly 0 (JAX's polynomial gives its finfo.min scores 2^-126 * c0, below
// every fp32 sum they join).

#pragma once

#include <cuda_bf16.h>

namespace dclip {
namespace softmax {

enum ExpMode : int { kExact = 0, kPoly = 1, kPolyZeroed = 2, kBf16 = 3 };

__host__ __device__ constexpr bool two_pass(int mode) { return mode != kExact; }

// JAX's `_exp2_poly`, bit for bit: x clamped at -126 (a NaN stays NaN, as
// jnp.maximum keeps it), xi = floor(x), the cubic of xf = x - xi in fp32
// with every operation rounded on its own (no FMA contraction), then xi
// added to the exponent bits.
__device__ __forceinline__ float exp2_poly(float x) {
  // the constants as JAX rounds its Python floats: to double, then to fp32
  constexpr float c0 = (float)0.9999413315491341, c1 = (float)0.6957344083154011;
  constexpr float c2 = (float)0.2261244071264617, c3 = (float)0.07808251030411106;
  x = x < -126.f ? -126.f : x;
  const float xi = floorf(x);
  const float xf = __fsub_rn(x, xi);
  float p = __fadd_rn(c2, __fmul_rn(xf, c3));
  p = __fadd_rn(c1, __fmul_rn(xf, p));
  p = __fadd_rn(c0, __fmul_rn(xf, p));
  return __int_as_float(__float_as_int(p) + (int)((unsigned)(int)xi << 23));
}

// The bf16 exp pass: (s - m) rounded to bf16, exp2 of it, rounded to bf16.
__device__ __forceinline__ float exp2_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(exp2f(__bfloat162float(__float2bfloat16_rn(x)))));
}

// p of a live score `s` against the final row max `m` under a knob mode;
// a masked score (-inf) gives exactly 0.
template <int kMode>
__device__ __forceinline__ float knob_exp(float s, float m) {
  if (s == __int_as_float(0xff800000)) return 0.f;
  if constexpr (kMode == kBf16)
    return exp2_bf16(s - m);
  else
    return exp2_poly(s - m);
}

// The kernel variant of an exp mode (kPolyZeroed runs kPoly's, with the
// row max floored at 0 by `max_floor`), or -1 for a mode that is none.
__host__ __device__ constexpr int variant(int mode) {
  return mode == kPolyZeroed ? kPoly : mode < 0 || mode > 3 ? -1 : mode;
}

// The floor of the row max under an exp mode: 0 under kPolyZeroed, else
// -FLT_MAX (no floor: a row always sees a finite score).
inline float max_floor(int mode) { return mode == kPolyZeroed ? 0.f : -3.402823466e38f; }

}  // namespace softmax
}  // namespace dclip
