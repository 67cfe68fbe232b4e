// cuTensorMapEncodeTiled, looked up at first use through
// cudaGetDriverEntryPointByVersion (the libraries link only the CUDA
// runtime; CUDA 12.5 or later).  Host code shared by the kernels that load
// tiles with TMA (attention_fwd.cuh, qkv_attention_int8.cu).  ops/_build.py
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

}  // namespace dclip
