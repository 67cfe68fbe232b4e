// CUDA's tensor maps (cuda.h) for the CPU emulation (cuda_runtime.h here):
// cuTensorMapEncodeTiled, reached as on the card through the runtime's
// cudaGetDriverEntryPointByVersion, checks the documented constraints of
// a tiled map (bf16 or 8-bit elements; no swizzle, or the 64- or 128-byte
// one) and records it; hopper.cuh's TMA load reads the record.
#pragma once

#include "cuda_runtime.h"

typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUresult;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
typedef enum { CU_TENSOR_MAP_DATA_TYPE_UINT8 = 0, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 } CUtensorMapDataType;
typedef enum { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 } CUtensorMapInterleave;
typedef enum { CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_64B = 2, CU_TENSOR_MAP_SWIZZLE_128B = 3 } CUtensorMapSwizzle;
typedef enum { CU_TENSOR_MAP_L2_PROMOTION_NONE = 0, CU_TENSOR_MAP_L2_PROMOTION_L2_256B = 3 } CUtensorMapL2promotion;
typedef enum { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 } CUtensorMapFloatOOBfill;

struct alignas(64) CUtensorMap {
  const unsigned char* base;
  uint32_t rank, elem_bytes;
  uint64_t dim[5], stride[5];  // stride[0] = the element's bytes; the rest in bytes
  uint32_t box[5];
  CUtensorMapSwizzle swizzle;
};

inline CUresult emu_encode_tiled(CUtensorMap* m, CUtensorMapDataType type, cuuint32_t rank,
                                 void* addr, const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t* elem_strides,
                                 CUtensorMapInterleave interleave, CUtensorMapSwizzle swizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  const uint32_t eb = type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1 : 2;
  bool ok = (type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 || type == CU_TENSOR_MAP_DATA_TYPE_UINT8) &&
            rank >= 1 && rank <= 5 &&
            (uintptr_t)addr % 16 == 0 && interleave == CU_TENSOR_MAP_INTERLEAVE_NONE;
  for (uint32_t i = 0; ok && i < rank; ++i) {
    ok = dims[i] >= 1 && dims[i] <= (1ull << 32) && box[i] >= 1 && box[i] <= 256 &&
         elem_strides[i] == 1;
    if (ok && i > 0) ok = strides[i - 1] % 16 == 0 && strides[i - 1] < (1ull << 40);
  }
  ok = ok && (box[0] * eb) % 16 == 0;
  if (ok && swizzle == CU_TENSOR_MAP_SWIZZLE_128B) ok = box[0] * eb <= 128;
  if (ok && swizzle == CU_TENSOR_MAP_SWIZZLE_64B) ok = box[0] * eb <= 64;
  if (!ok) return CUDA_ERROR_INVALID_VALUE;
  m->base = static_cast<const unsigned char*>(addr);
  m->rank = rank;
  m->elem_bytes = eb;
  m->stride[0] = eb;
  for (uint32_t i = 0; i < rank; ++i) {
    m->dim[i] = dims[i];
    m->box[i] = box[i];
    if (i > 0) m->stride[i] = strides[i - 1];
  }
  m->swizzle = swizzle;
  return CUDA_SUCCESS;
}

enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0, cudaDriverEntryPointSymbolNotFound = 1 };
enum { cudaEnableDefault = 0 };

inline cudaError_t cudaGetDriverEntryPointByVersion(const char* symbol, void** fn, unsigned,
                                                    unsigned long long,
                                                    cudaDriverEntryPointQueryResult* found) {
  const bool known = strcmp(symbol, "cuTensorMapEncodeTiled") == 0;
  *fn = known ? reinterpret_cast<void*>(&emu_encode_tiled) : nullptr;
  *found = known ? cudaDriverEntryPointSuccess : cudaDriverEntryPointSymbolNotFound;
  return cudaSuccess;
}
