// csrc/mma_tf32.cuh emulated on the CPU (cuda_runtime.h here), from the PTX
// ISA's definitions: the split's rounding to TF32 (10 mantissa bits, to
// nearest, ties away from zero, as cvt.rna.tf32.f32 rounds) is the header's
// own integer code; mma.sync m16n8k8 .tf32 rebuilds A and B from the 32
// lanes' fragments, reads each operand's TF32 bits (the low 13 bits
// ignored, as the tensor cores ignore them) and sums in fp32 in k order.  mma_3xtf32 exchanges its twelve registers once
// and runs its three products in the header's order.  Each exchange takes
// one warp barrier: the lanes write one of two banks in turns, and a lane
// writes a bank again only after every lane has passed the barrier of the
// exchange in between, so after its last read of that bank.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>
namespace dclip {
inline uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;  // sign-magnitude: ties away from zero
}
struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };
inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}
inline FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}
inline FragB split_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}
namespace tf32emu {
// This lane's registers (a0-a3 of each A, b0-b1 of each B, `count` pairs)
// into its bank; the warp's table after the barrier.
inline const uint32_t (*exchange(const uint32_t* regs, int count))[12] {
  static thread_local unsigned calls = 0;  // a new std::thread per block: 0 at its start
  auto& w = emu::warp();
  auto& bank = w.tf32[calls++ & 1];
  for (int i = 0; i < count; ++i) bank[emu::lane()][i] = regs[i];
  w.bar.arrive_and_wait();
  return bank;
}
inline float tf32(uint32_t v) { return __uint_as_float(v & 0xffffe000u); }
// c += A B from the table: A's registers at column `ia` (a0-a3), B's at `ib` (b0, b1).
inline void product(float c[4], const uint32_t (*tab)[12], int ia, int ib) {
  const int l = emu::lane(), g = l / 4, t = l % 4;
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), n = 2 * t + (e & 1);
    float s = c[e];
    for (int k = 0; k < 8; ++k)
      s += tf32(tab[(r % 8) * 4 + k % 4][ia + (r >= 8) + 2 * (k >= 4)]) *
           tf32(tab[n * 4 + k % 4][ib + (k >= 4)]);
    c[e] = s;
  }
}
}  // namespace tf32emu
inline void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  const uint32_t regs[6] = {a[0], a[1], a[2], a[3], b0, b1};
  tf32emu::product(c, tf32emu::exchange(regs, 6), 0, 4);
}
inline void mma_3xtf32(float c[4], const FragA& a, const FragB& b) {
  uint32_t regs[12];
  for (int i = 0; i < 4; ++i) regs[i] = a.hi[i], regs[4 + i] = a.lo[i];
  for (int i = 0; i < 2; ++i) regs[8 + i] = b.hi[i], regs[10 + i] = b.lo[i];
  const auto tab = tf32emu::exchange(regs, 12);
  tf32emu::product(c, tab, 4, 8);   // lo_a hi_b
  tf32emu::product(c, tab, 0, 10);  // hi_a lo_b
  tf32emu::product(c, tab, 0, 8);   // hi_a hi_b
}
inline void mma_3xtf32_rn(float acc[4], const FragA& a, const FragB& b) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(c, a, b);
  for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], c[i]);
}
}  // namespace dclip
