// bf16 for the CPU emulation (cuda_runtime.h here): 16-bit storage and
// round-to-nearest-even conversion, as on the card.
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 a, b; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) { uint32_t u = (uint32_t)h.x << 16; float f; memcpy(&f, &u, 4); return f; }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)}; }
