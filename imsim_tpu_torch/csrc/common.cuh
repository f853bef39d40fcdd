// Shared helpers of the port's CUDA kernels (plain C interface, no
// PyTorch headers).  Every entry point returns cudaGetLastError() as an
// int; the Python wrapper raises when it is not 0.
#pragma once

#include <cuda_runtime.h>

#define IMSIM_API extern "C" __attribute__((visibility("default")))

static inline int imsim_last_error() {
  return static_cast<int>(cudaGetLastError());
}
