// cuTensorMapEncodeTiled, looked up at first use through
// cudaGetDriverEntryPointByVersion (the libraries link only the CUDA
// runtime; CUDA 12.5 or later), and the 2-d bf16 map built on it.  Host code
// shared by the kernels that load tiles with TMA (attention_fwd.cuh,
// qkv_attention_int8.cu, ln_qkv_attention.cu).  ops/_build.py
// hashes this header into the name of every library built from csrc/.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing here links libcuda
#include <cuda_runtime.h>

namespace dclip {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Returns cuTensorMapEncodeTiled with the primary context of the calling
// thread's device current.  The driver function fails (201,
// CUDA_ERROR_INVALID_CONTEXT) in a thread where no runtime call has made a
// context current yet: an autograd worker or a server thread on device 0,
// where PyTorch skips cudaSetDevice because its cached device already
// matches.  cudaSetDevice makes the device's primary context current
// (CUDA 12) and does not synchronize.
inline cudaError_t encode_fn(EncodeTiled* fn) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                           &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || f == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(f);
  }
  *fn = cached;
  return cudaSuccess;
}

// The map of a row-major bf16 matrix [rows, cols] (row stride `ld`
// elements, a multiple of 8), in boxes of 64 columns (one 128-byte swizzled
// row) x `box_rows` rows; elements past either extent arrive as zeros.
inline cudaError_t make_map_2d(CUtensorMap* m, const void* ptr, unsigned long long rows,
                               unsigned long long cols, unsigned long long ld,
                               unsigned box_rows) {
  EncodeTiled encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace dclip
