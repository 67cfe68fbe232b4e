// A CPU emulation of the CUDA subset the port's kernels use, so that the
// CPU tests can run `csrc/attention_bwd.cuh` (and the sources on
// hopper.cuh, the int8 prologue, the fp32 SIMT cores and the 3xTF32
// backward core) as written: every CUDA thread of a block is a std::thread,
// `__syncthreads` a block barrier, and the warp-level operations (shuffles,
// ldmatrix, mma.sync; mma_bf16.cuh and mma_tf32.cuh here) exchange their
// operands through a per-warp slot table between two warp barriers
// (mma_tf32.cuh: one, over two banks of its own table in turns).  cp.async
// copies are deferred to the issuing thread's `cp.async.wait_group`, the
// latest moment the hardware may complete them.
// Blocks run one after another, the last of the grid first, and share one
// dynamic shared-memory array of 227 KB, filled with 0xff before each
// block.  tests/test_torch_cuda_emulated.py
// compiles a kernel source against these headers with the host compiler,
// `kernel<<<grid, threads, smem, stream>>>(args)` rewritten to
// `emu_launch(kernel, grid, threads, smem, args)` and each kernel's
// `extern __shared__ ... smem_raw[]` to a pointer to that array.

#pragma once

#include <barrier>
#include <cassert>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <set>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(x)
#define __launch_bounds__(...)
#define __grid_constant__

struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct alignas(8) uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern thread_local dim3 threadIdx, blockIdx, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
// Two SMs: a persistent kernel's blocks each take several tiles.
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 2;
  return cudaSuccess;
}
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline unsigned max(unsigned a, unsigned b) { return a > b ? a : b; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
// One rounding each, never an FMA (the host compiler targets no FMA unit).
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }  // IEEE: correctly rounded
inline float __int2float_rn(int i) { return (float)i; }
// a + b rounded toward -inf: the nearest sum, one step down when TwoSum's
// exact error says it lies above the true sum.
inline float __fadd_rd(float a, float b) {
  const float s = a + b, bb = s - a, err = (a - (s - bb)) + (b - bb);
  return err < 0.f ? std::nextafter(s, -INFINITY) : s;
}
// Byte n of the result is byte (s >> 4n) & 7 of {y, x} (x the low word).
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n) r |= (unsigned)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
}
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }

namespace emu {

constexpr size_t kSmemBytes = 232448;  // what one block may use on an H100

struct Warp {
  std::barrier<> bar{32};
  uint64_t slot[32][8];
  uint32_t tf32[2][32][12];  // mma_tf32.cuh's operands: two banks, used in turns
};

struct Block {
  std::barrier<> bar;
  std::vector<Warp*> warps;
  explicit Block(int threads) : bar(threads) {
    for (int i = 0; i < threads / 32; ++i) warps.push_back(new Warp);
  }
  ~Block() {
    for (auto* w : warps) delete w;
  }
};

extern thread_local Block* cur;
inline Warp& warp() { return *cur->warps[threadIdx.x >> 5]; }
inline int lane() { return threadIdx.x & 31; }

struct Copy {
  void* dst;
  const void* src;
  int bytes, src_bytes;  // src_bytes < bytes: the rest is zero-filled
};
extern thread_local std::vector<std::vector<Copy>> groups;  // committed, oldest first
extern thread_local std::vector<Copy> open_group;
inline void run(const std::vector<Copy>& g) {
  for (const auto& c : g) {
    memset(c.dst, 0, c.bytes);
    if (c.src_bytes) memcpy(c.dst, c.src, c.src_bytes);
  }
}
extern unsigned char* smem_base;

// The block's mbarriers and named barriers (hopper.cuh here), keyed by
// shared address / barrier id, reset before each block.
struct MBar {
  uint32_t expected, pending, phase;  // phase: completed phases so far
  long long tx;                       // bytes still to arrive in this phase
  std::set<unsigned> arrived;         // threads that arrived in this phase
};
struct Named {
  int arrived = 0;
  unsigned generation = 0;
};
struct Sync {
  std::mutex mu;
  std::condition_variable cv;
  std::map<uint32_t, MBar> mbars;
  std::map<int, Named> named;
};
extern Sync bars;

}  // namespace emu

inline void __syncthreads() { emu::cur->bar.arrive_and_wait(); }
// Every lane of the warp (the fp32 SIMT cores call it with all 32).
inline void __syncwarp(unsigned = 0xffffffffu) { emu::warp().bar.arrive_and_wait(); }

template <class T>  // float, int or unsigned
inline T __shfl_xor_sync(unsigned, T v, int o) {
  static_assert(sizeof(T) == 4);
  auto& w = emu::warp();
  const int l = emu::lane();
  uint32_t u;
  memcpy(&u, &v, 4);
  w.slot[l][0] = u;
  w.bar.arrive_and_wait();
  const uint32_t r = (uint32_t)w.slot[l ^ o][0];
  w.bar.arrive_and_wait();
  T f;
  memcpy(&f, &r, 4);
  return f;
}

namespace emu {
inline std::mutex atomics;
}
inline unsigned atomicMax(unsigned* p, unsigned v) {
  std::lock_guard<std::mutex> lk(emu::atomics);
  const unsigned old = *p;
  if (v > old) *p = v;
  return old;
}

template <class A>
void emu_launch(void (*kernel)(A), dim3 grid, int threads, size_t smem, const A& a) {
  assert(smem <= emu::kSmemBytes - 1024);  // the launch would be refused on the card
  // Last block first: on the card blocks run in no order, and a block that
  // writes past its own rows (into the next batch element's, say) is then
  // overwritten by nothing.
  for (unsigned z = grid.z; z-- > 0;)
    for (unsigned y = grid.y; y-- > 0;)
      for (unsigned x = grid.x; x-- > 0;) {
        memset(emu::smem_base, 0xff, emu::kSmemBytes);
        emu::bars.mbars.clear();
        emu::bars.named.clear();
        emu::Block blk(threads);
        std::vector<std::thread> ts;
        for (int i = 0; i < threads; ++i)
          ts.emplace_back([&, i] {
            threadIdx = dim3(i);
            blockIdx = dim3(x, y, z);
            gridDim = grid;
            emu::cur = &blk;
            emu::groups.clear();
            emu::open_group.clear();
            kernel(a);
          });
        for (auto& t : ts) t.join();
        // every phase that an arrival opened was completed by the block
        for (const auto& kv : emu::bars.mbars)
          assert(kv.second.pending == kv.second.expected && kv.second.tx == 0 &&
                 "a block ended with an mbarrier phase open");
      }
}
