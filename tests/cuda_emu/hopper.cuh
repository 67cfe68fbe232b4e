// csrc/hopper.cuh emulated on the CPU (cuda_runtime.h here), from the PTX
// ISA's definitions rather than from the kernels that use it:
//   * mbarrier: an expected arrival count, pending arrivals, a transaction
//     count in bytes and the number of completed phases; a phase completes
//     when its arrivals and bytes are all in, and try_wait.parity(p) passes
//     once the phase of parity p is complete (a fresh barrier's "previous"
//     phase, parity 1, counts as complete).  Eight guard bytes at the
//     barrier's shared address catch a tile written over it.  A thread that
//     arrives twice in one phase fails (its second arrival belongs to a
//     later phase: on the card it would complete this one early), and so
//     does a block that ends with a phase open (cuda_runtime.h).
//   * TMA (cp.async.bulk.tensor, 2-d and 4-d maps): the box at the given
//     coordinates, elements past the map's extent as zeros, stored
//     box-row-major at the destination with the swizzle of the shared
//     address: 128-byte (16-byte chunk bits [4, 7) XOR address bits
//     [7, 10)) or 64-byte (bits [4, 6) XOR bits [7, 9)); the whole box's
//     bytes then complete the barrier's transaction count.
//   * TMA stores (cp.async.bulk.tensor shared -> global, 2-d): queued in
//     the thread's bulk group at issue and written at the bulk wait that
//     retires the group (the latest moment the hardware may read the
//     source), unswizzled as the loads are swizzled, elements past the
//     map's extent not written;
//   * wgmma: queued at issue and computed at the wait that retires its
//     group (the latest moment the hardware may complete it), reading the
//     accumulator, the A registers and shared memory then.  Operands come
//     from the matrix descriptors (start, LBO, SBO; layout type 1, the
//     128-byte swizzle, or 2, the 64-byte one) in the canonical K-major
//     layout (8-row groups SBO apart, rows of the swizzle's width, k
//     contiguous) and, 128-byte only, B MN-major (the transpose bit of
//     wgmma_ss_tb and wgmma_rs_tb; wgmma_ss and wgmma_rs read B K-major);
//     A from registers in the per-warp fragment layout: bf16 a0 row g,
//     k 2t..2t+1; a1 row g + 8; a2 / a3 k + 8; 8-bit a0 row g, k 4t..4t+3
//     (lowest k in the lowest byte); a1 row g + 8; a2 / a3 k + 16.  d[i] is
//     row 16 * warp + g + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2t + i % 2;
//     bf16 sums in fp32 in k order, 8-bit sums (s8 x s8 -> s32, m64nNk32,
//     B K-major only) exact.
//   * wgmma.fence / commit_group / wait_group are warp-synchronous (`.sync`:
//     every lane of the warp reaches them before any goes on), which is what
//     lets one lane release a tile for its warp after the wait;
//   * a named barrier counts arrivals per id; setmaxnreg and the proxy
//     fences are no-ops.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace emu {

constexpr uint64_t kGuard = 0x6d62617272696572ull;

inline unsigned char* shared(uint32_t addr) { return smem_base + addr; }

inline MBar& mbar(uint32_t bar) {  // caller holds bars.mu
  uint64_t guard;
  memcpy(&guard, shared(bar), 8);
  assert(guard == kGuard && "mbarrier overwritten or never initialised");
  return bars.mbars.at(bar);
}

inline void mbar_check(MBar& m) {  // caller holds bars.mu
  assert(m.tx >= 0 && "more bytes arrived than expected");
  if (m.pending == 0 && m.tx == 0) {
    m.phase += 1;
    m.pending = m.expected;
    m.arrived.clear();
    bars.cv.notify_all();
  }
}

inline void arrive(MBar& m) {  // caller holds bars.mu
  assert(m.pending > 0 && "more arrivals than expected in a phase");
  const bool first = m.arrived.insert(threadIdx.x).second;
  assert(first && "a thread arrived twice in one phase");
  (void)first;
  m.pending -= 1;
}

inline void complete_tx(uint32_t bar, long long bytes) {
  std::lock_guard<std::mutex> lk(bars.mu);
  MBar& m = mbar(bar);
  m.tx -= bytes;
  mbar_check(m);
}

inline uint32_t swizzle128(uint32_t addr) { return addr ^ (((addr >> 7) & 7u) << 4); }
inline uint32_t swizzle64(uint32_t addr) { return addr ^ (((addr >> 7) & 3u) << 4); }

struct Desc {
  uint32_t start, lbo, sbo, row;  // row: bytes of a swizzled row (128 or 64)
  uint32_t at(uint32_t addr) const { return row == 128 ? swizzle128(addr) : swizzle64(addr); }
};

inline Desc decode(uint64_t d) {
  const uint32_t layout = (d >> 62) & 3;
  assert((layout == 1 || layout == 2) && "only the 128- and 64-byte swizzles are emulated");
  assert(((d >> 49) & 7) == 0 && "base offset 0 only");
  return {(uint32_t)(d & 0x3FFF) << 4, (uint32_t)((d >> 16) & 0x3FFF) << 4,
          (uint32_t)((d >> 32) & 0x3FFF) << 4, layout == 1 ? 128u : 64u};
}

// K-major (row `mn` of the M or N extent, byte `kb` of its k extent): 8 rows
// of the swizzle's width per SBO-strided group, k contiguous.
inline const unsigned char* kmajor_byte(const Desc& d, int mn, int kb) {
  return shared(d.at(d.start + (mn / 8) * d.sbo + (mn % 8) * d.row + kb));
}

inline float kmajor(const Desc& d, int mn, int k) {  // bf16, k < 16
  __nv_bfloat16 h;
  memcpy(&h.x, kmajor_byte(d, mn, 2 * k), 2);
  return __bfloat162float(h);
}

// MN-major (bf16, 128-byte swizzle): 64 contiguous elements along MN per
// LBO-strided atom, 8 k-rows of 128 bytes per SBO-strided group.
inline float mnmajor(const Desc& d, int k, int mn) {
  assert(d.row == 128 && "MN-major operands are emulated with the 128-byte swizzle only");
  __nv_bfloat16 h;
  memcpy(&h.x, shared(swizzle128(d.start + (mn / 64) * d.lbo + (mn % 64) * 2 + (k / 8) * d.sbo +
                                 (k % 8) * 128)),
         2);
  return __bfloat162float(h);
}

struct Mma {
  bool a_regs;  // A from registers (else from the descriptor da)
  bool s8;      // s8 x s8 -> s32, k 32 (else bf16 x bf16 -> fp32, k 16)
  bool b_mn;    // B MN-major (the transpose bit; else K-major)
  void* d;
  const uint32_t* a;
  uint64_t da, db;
  int acc, n;
};
inline thread_local std::vector<Mma> mma_open;                 // issued, not committed
inline thread_local std::vector<std::vector<Mma>> mma_groups;  // committed, oldest first

// m64nNk32 with s8 operands: A's two rows of this thread (from the
// registers' 8-bit fragment or K-major in shared memory) times B K-major.
inline void run_mma_s8(const Mma& op) {
  const int w = (threadIdx.x >> 5) & 3;
  const int l = lane(), g = l / 4, t = l % 4;
  int av[2][32];
  if (op.a_regs) {
    auto& wp = warp();
    for (int i = 0; i < 4; ++i) wp.slot[l][i] = op.a[i];
    wp.bar.arrive_and_wait();
    for (int r = 0; r < 2; ++r)
      for (int k = 0; k < 32; ++k) {
        const int row = g + 8 * r;  // in the warp's 16
        const uint32_t v = (uint32_t)wp.slot[(row % 8) * 4 + (k % 16) / 4][(row >= 8) + 2 * (k >= 16)];
        av[r][k] = (int8_t)(v >> (8 * (k % 4)));
      }
    wp.bar.arrive_and_wait();
  } else {
    const Desc da = decode(op.da);
    for (int r = 0; r < 2; ++r)
      for (int k = 0; k < 32; ++k) av[r][k] = (int8_t)*kmajor_byte(da, 16 * w + g + 8 * r, k);
  }
  const Desc db = decode(op.db);
  int* d = static_cast<int*>(op.d);
  for (int i = 0; i < op.n / 2; ++i) {
    const int r = (i / 2) % 2, col = 8 * (i / 4) + 2 * t + i % 2;
    int s = 0;
    for (int k = 0; k < 32; ++k) s += av[r][k] * (int8_t)*kmajor_byte(db, col, k);
    d[i] = op.acc ? d[i] + s : s;
  }
}

inline void run_mma(const Mma& op) {
  if (op.s8) return run_mma_s8(op);
  const int w = (threadIdx.x >> 5) & 3;  // warp in the warpgroup: rows 16w .. 16w + 15
  const int l = lane(), g = l / 4, t = l % 4;
  float av[2][16];  // this thread's two rows of A
  if (op.a_regs) {
    auto& wp = warp();
    for (int i = 0; i < 4; ++i) wp.slot[l][i] = op.a[i];
    wp.bar.arrive_and_wait();
    for (int r = 0; r < 2; ++r)
      for (int k = 0; k < 16; ++k) {
        const int row = g + 8 * r;  // in the warp's 16
        const uint32_t v = (uint32_t)wp.slot[(row % 8) * 4 + (k % 8) / 2][(row >= 8) + 2 * (k >= 8)];
        __nv_bfloat16 h{(uint16_t)(k % 2 ? v >> 16 : v & 0xffff)};
        av[r][k] = __bfloat162float(h);
      }
    wp.bar.arrive_and_wait();
  } else {
    const Desc da = decode(op.da);
    for (int r = 0; r < 2; ++r)
      for (int k = 0; k < 16; ++k) av[r][k] = kmajor(da, 16 * w + g + 8 * r, k);
  }
  const Desc db = decode(op.db);
  float* d = static_cast<float*>(op.d);
  for (int i = 0; i < op.n / 2; ++i) {
    const int r = (i / 2) % 2, col = 8 * (i / 4) + 2 * t + i % 2;
    float s = 0.f;
    for (int k = 0; k < 16; ++k)
      s += av[r][k] * (op.b_mn ? mnmajor(db, k, col) : kmajor(db, col, k));
    d[i] = op.acc ? d[i] + s : s;
  }
}

}  // namespace emu

namespace dclip {
namespace sm90 {

inline void mbar_init(uint32_t bar, uint32_t count) {
  std::lock_guard<std::mutex> lk(emu::bars.mu);
  memcpy(emu::shared(bar), &emu::kGuard, 8);
  emu::bars.mbars[bar] = {count, count, 0, 0, {}};
}

inline void fence_barrier_init() {}

inline void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lk(emu::bars.mu);
  emu::MBar& m = emu::mbar(bar);
  m.tx += bytes;
  emu::arrive(m);
  emu::mbar_check(m);
}

inline void mbar_arrive(uint32_t bar) {
  std::lock_guard<std::mutex> lk(emu::bars.mu);
  emu::MBar& m = emu::mbar(bar);
  emu::arrive(m);
  emu::mbar_check(m);
}

inline void mbar_wait(uint32_t bar, uint32_t parity) {
  std::unique_lock<std::mutex> lk(emu::bars.mu);
  emu::bars.cv.wait(lk, [&] { return (emu::mbar(bar).phase & 1u) != parity; });
}

// The box of `map` at coordinates c[0 .. rank), innermost first.
inline void tma_load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar, const int* c) {
  const CUtensorMap& m = *map;
  assert(dst % 128 == 0);
  uint32_t box[4] = {1, 1, 1, 1};
  for (uint32_t d = 0; d < m.rank; ++d) box[d] = m.box[d];
  uint32_t off = 0;
  for (uint32_t i3 = 0; i3 < box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < box[1]; ++i1)
        for (uint32_t i0 = 0; i0 < box[0]; ++i0, off += m.elem_bytes) {
          const uint32_t i[4] = {i0, i1, i2, i3};
          bool in = true;
          long long src = 0;
          for (uint32_t d = 0; d < m.rank; ++d) {
            const long long x = c[d] + (long long)i[d];
            in = in && x >= 0 && x < (long long)m.dim[d];
            src += x * (long long)m.stride[d];
          }
          const uint32_t at = m.swizzle == CU_TENSOR_MAP_SWIZZLE_128B  ? emu::swizzle128(dst + off)
                              : m.swizzle == CU_TENSOR_MAP_SWIZZLE_64B ? emu::swizzle64(dst + off)
                                                                       : dst + off;
          if (in) memcpy(emu::shared(at), m.base + src, m.elem_bytes);
          else memset(emu::shared(at), 0, m.elem_bytes);
        }
  emu::complete_tx(bar, off);
}

inline void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                        int c3) {
  assert(map->rank == 4);
  const int c[4] = {c0, c1, c2, c3};
  tma_load_box(dst, map, bar, c);
}

inline void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  assert(map->rank == 2);
  const int c[2] = {c0, c1};
  tma_load_box(dst, map, bar, c);
}

struct BulkStore {
  const CUtensorMap* map;
  uint32_t src;
  int c0, c1;
};
inline thread_local std::vector<BulkStore> bulk_open;                 // issued, not committed
inline thread_local std::vector<std::vector<BulkStore>> bulk_groups;  // committed, oldest first

inline void run_store(const BulkStore& st) {
  const CUtensorMap& m = *st.map;
  uint32_t off = 0;
  for (uint32_t i1 = 0; i1 < m.box[1]; ++i1)
    for (uint32_t i0 = 0; i0 < m.box[0]; ++i0, off += m.elem_bytes) {
      const long long x0 = st.c0 + (long long)i0, x1 = st.c1 + (long long)i1;
      if (x0 < 0 || x0 >= (long long)m.dim[0] || x1 < 0 || x1 >= (long long)m.dim[1]) continue;
      const uint32_t at = m.swizzle == CU_TENSOR_MAP_SWIZZLE_128B  ? emu::swizzle128(st.src + off)
                          : m.swizzle == CU_TENSOR_MAP_SWIZZLE_64B ? emu::swizzle64(st.src + off)
                                                                   : st.src + off;
      memcpy(const_cast<unsigned char*>(m.base) + x0 * m.stride[0] + x1 * m.stride[1],
             emu::shared(at), m.elem_bytes);
    }
}

inline void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  assert(map->rank == 2 && src % 128 == 0);
  bulk_open.push_back({map, src, c0, c1});
}

inline void bulk_commit() {
  bulk_groups.push_back(bulk_open);
  bulk_open.clear();
}

template <int kPending>
inline void bulk_wait() {
  while ((int)bulk_groups.size() > kPending) {
    for (const auto& st : bulk_groups.front()) run_store(st);
    bulk_groups.erase(bulk_groups.begin());
  }
}

template <int kPending>
inline void bulk_wait_read() {
  bulk_wait<kPending>();
}

inline void named_barrier_sync(int id, int threads) {
  std::unique_lock<std::mutex> lk(emu::bars.mu);
  emu::Named& b = emu::bars.named[id];
  const unsigned gen = b.generation;
  if (++b.arrived == threads) {
    b.arrived = 0;
    b.generation += 1;
    emu::bars.cv.notify_all();
  } else {
    emu::bars.cv.wait(lk, [&] { return emu::bars.named[id].generation != gen; });
  }
}

// ex2.approx.ftz: subnormal results flushed to 0 (a +0 for the -inf of a
// masked score).
inline float exp2_ftz(float x) {
  const float y = exp2f(x);
  return std::fpclassify(y) == FP_SUBNORMAL ? 0.f : y;
}

inline void fence_proxy_async() {}
template <int kRegs>
inline void setmaxnreg_dec() {}
template <int kRegs>
inline void setmaxnreg_inc() {}
template <int kN, class T>
inline void fence_regs(T*) {}

// `.sync`: a thread waits for every lane of its warp to reach the instruction.
inline void wgmma_fence() { emu::warp().bar.arrive_and_wait(); }

inline void wgmma_commit() {
  emu::warp().bar.arrive_and_wait();
  emu::mma_groups.push_back(emu::mma_open);
  emu::mma_open.clear();
}

template <int kPending>
inline void wgmma_wait() {
  emu::warp().bar.arrive_and_wait();
  while ((int)emu::mma_groups.size() > kPending) {
    for (const auto& op : emu::mma_groups.front()) emu::run_mma(op);
    emu::mma_groups.erase(emu::mma_groups.begin());
  }
  emu::warp().bar.arrive_and_wait();
}

template <int N>
inline void wgmma_ss(float* d, uint64_t da, uint64_t db, int acc) {
  emu::mma_open.push_back({false, false, false, d, nullptr, da, db, acc, N});
}

template <int N>
inline void wgmma_rs(float* d, const uint32_t* a, uint64_t db, int acc) {
  emu::mma_open.push_back({true, false, false, d, a, 0, db, acc, N});
}

template <int N>
inline void wgmma_ss_tb(float* d, uint64_t da, uint64_t db, int acc) {
  emu::mma_open.push_back({false, false, true, d, nullptr, da, db, acc, N});
}

template <int N>
inline void wgmma_rs_tb(float* d, const uint32_t* a, uint64_t db, int acc) {
  emu::mma_open.push_back({true, false, true, d, a, 0, db, acc, N});
}

template <int N>
inline void wgmma_ss_s8(int* d, uint64_t da, uint64_t db, int acc) {
  emu::mma_open.push_back({false, true, false, d, nullptr, da, db, acc, N});
}

template <int N>
inline void wgmma_rs_s8(int* d, const uint32_t* a, uint64_t db, int acc) {
  emu::mma_open.push_back({true, true, false, d, a, 0, db, acc, N});
}

}  // namespace sm90
}  // namespace dclip
