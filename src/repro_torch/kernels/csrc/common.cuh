// Shared helpers for the port's kernels. Each kernel file exposes plain C
// entry points (loaded with ctypes): they launch on the caller's stream and
// return cudaGetLastError(), which the Python wrapper turns into an error.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Element types the kernels take, as the wrappers encode them.
enum BnnDtype : int { BNN_F32 = 0, BNN_BF16 = 1 };

__device__ __forceinline__ float bnn_to_float(float v) { return v; }
__device__ __forceinline__ float bnn_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
