// The CPU emulation's state (cuda_runtime.h): per thread, and the blocks'
// one dynamic shared-memory array.
#include "cuda_runtime.h"

thread_local dim3 threadIdx, blockIdx, gridDim;

namespace emu {
thread_local Block* cur;
thread_local std::vector<std::vector<Copy>> groups;
thread_local std::vector<Copy> open_group;
alignas(1024) unsigned char smem_storage[kSmemBytes];
unsigned char* smem_base = smem_storage;
Sync bars;
}  // namespace emu
