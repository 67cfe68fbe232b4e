// The helpers of csrc/mma_bf16.cuh that the attention cores use, emulated on
// the CPU (cuda_runtime.h here): mma.sync m16n8k16 rebuilds A and B from
// the 32 lanes' fragments and sums in fp32 in k order; ldmatrix reads the
// rows the lanes address; cp.async queues its copy until the wait.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
namespace dclip {
constexpr int kVec = 8;
union Vec8 { uint4 u; __nv_bfloat16 h[kVec]; };
inline float bf(uint16_t x) { __nv_bfloat16 h{x}; return __bfloat162float(h); }
inline void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  auto& w = emu::warp();
  int l = emu::lane();
  for (int i = 0; i < 4; ++i) w.slot[l][i] = a[i];
  w.slot[l][4] = b0; w.slot[l][5] = b1;
  w.bar.arrive_and_wait();
  auto A = [&](int r, int k) {
    int reg = (r >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0);
    uint32_t v = (uint32_t)w.slot[(r % 8) * 4 + (k % 8) / 2][reg];
    return bf((uint16_t)(k % 2 ? v >> 16 : v & 0xffff));
  };
  auto B = [&](int k, int n) {
    uint32_t v = (uint32_t)w.slot[n * 4 + (k % 8) / 2][4 + (k >= 8)];
    return bf((uint16_t)(k % 2 ? v >> 16 : v & 0xffff));
  };
  int g = l / 4, t = l % 4;
  float out[4];
  for (int e = 0; e < 4; ++e) {
    int r = g + 8 * (e >> 1), n = 2 * t + (e & 1);
    float s = c[e];
    for (int k = 0; k < 16; ++k) s += A(r, k) * B(k, n);
    out[e] = s;
  }
  w.bar.arrive_and_wait();
  for (int e = 0; e < 4; ++e) c[e] = out[e];
}
inline uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__float2bfloat16_rn(lo).x | ((uint32_t)__float2bfloat16_rn(hi).x << 16);
}
// A shared-window address: the offset from the block's shared memory.
inline uint32_t smem_addr(const void* p) {
  return (uint32_t)((const unsigned char*)p - emu::smem_base);
}
inline void cp_async16(void* dst, const void* src, int src_bytes) {
  emu::open_group.push_back({dst, src, 16, src_bytes});
}
inline void cp_async_commit() { emu::groups.push_back(emu::open_group); emu::open_group.clear(); }
template <int N>
inline void cp_async_wait() {
  while ((int)emu::groups.size() > N) { emu::run(emu::groups.front()); emu::groups.erase(emu::groups.begin()); }
}
template <int kMats, bool kTrans>
inline void ldmatrix(uint32_t* r, const void* p) {
  auto& w = emu::warp();
  int l = emu::lane();
  w.slot[l][7] = (uint64_t)(size_t)p;
  w.bar.arrive_and_wait();
  int g = l / 4, t = l % 4;
  for (int i = 0; i < kMats; ++i) {
    uint16_t e[2];
    for (int j = 0; j < 2; ++j) {
      if (!kTrans) e[j] = ((const uint16_t*)(size_t)w.slot[i * 8 + g][7])[2 * t + j];
      else e[j] = ((const uint16_t*)(size_t)w.slot[i * 8 + 2 * t + j][7])[g];
    }
    r[i] = (uint32_t)e[0] | ((uint32_t)e[1] << 16);
  }
  w.bar.arrive_and_wait();
}
inline void ldmatrix_x4(uint32_t r[4], const void* p) { ldmatrix<4, false>(r, p); }
inline void ldmatrix_x4_trans(uint32_t r[4], const void* p) { ldmatrix<4, true>(r, p); }
}  // namespace dclip
