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

// Eq. 1: a value signs +1 iff it is at least the smallest normal f32, 2^-126
// (FLT_MIN; a bf16 converts to f32 exactly and has f32's exponent range).
// Subnormals of either sign, +-0 and NaN sign -1, as in the reference, whose
// XLA CPU reads a subnormal as zero. The comparison is the whole rule: the
// kernels build without -ftz, so nothing else flushes. Python holds the same
// value (core/binarize.py: SIGN_MIN).
constexpr float kBnnSignMin = 1.17549435082228750797e-38f;  // 2^-126

__device__ __forceinline__ bool bnn_sign(float v) { return v >= kBnnSignMin; }

// The reference's XLA CPU runs with DAZ and FTZ set: every subnormal input
// and result of an f32 operation reads as a zero of its sign. A chain of
// float steps that applies bnn_ftz to each input and each result gives the
// reference's bits; the kernels build without -ftz, so nothing else flushes
// and K2's and K4's float epilogues keep their subnormals. Python holds the
// same rule (core/binarize.py: flush_subnormal).
__device__ __forceinline__ float bnn_ftz(float v) {
  return fabsf(v) < kBnnSignMin ? copysignf(0.0f, v) : v;
}
