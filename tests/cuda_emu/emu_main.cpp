// The CPU emulation's thread-local state (cuda_runtime.h).
#include "cuda_runtime.h"

thread_local dim3 threadIdx, blockIdx;

namespace emu {
thread_local Block* cur;
thread_local std::vector<std::vector<Copy>> groups;
thread_local std::vector<Copy> open_group;
unsigned char* smem_base;
Sync bars;
}  // namespace emu
