// K3: fused sign-binarize + bitpack of activations along the last axis,
// (M, K) f32 or bf16 -> (M, ceil(K/32)) int32; bit b of word [m, j] is
// x[m, 32*j + b] > 0 (Eq. 1: 0, -0.0 and NaN give bit 0).
//
// Replaces the TPU kernel sign_pack_pallas (src/repro/xnor/kernel.py:
// _sign_pack_kernel).
//
// Bound on this card: device-memory bytes. Each activation is read once and
// one int32 is written per 32 of them; the compare is free beside the load.
// At the serving shapes (4 x 2048 f32) that is 33 KB, so in practice a launch
// is bound by its latency.
//
// Design: one warp per output word. Lane l reads x[m, 32*j + l] (a 128-byte
// coalesced load for f32) and __ballot_sync of (x > 0) is the word itself:
// lane b sets bit b, which is the xnor/packing.py layout. Lanes past K vote 0,
// the same as padding with zeros, so no caller pads. A bf16 value converts to
// f32 exactly, so comparing the converted value is comparing in bf16. Warps
// walk the words with a grid stride, so any M fits the grid.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
sign_pack_kernel(const T* __restrict__ x, int32_t* __restrict__ out, int64_t M,
                 int64_t K, int64_t k32) {
  const int lane = threadIdx.x & 31;
  const int64_t n_words = M * k32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t word = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
       word < n_words; word += stride) {
    const int64_t m = word / k32;
    const int64_t col = (word - m * k32) * 32 + lane;
    const bool one = col < K && bnn_to_float(x[m * K + col]) > 0.0f;
    const uint32_t bits = __ballot_sync(0xffffffffu, one);
    if (lane == 0) out[word] = static_cast<int32_t>(bits);
  }
}

}  // namespace

// x: (M, K) f32 or bf16 (dtype: BnnDtype), row-major and contiguous;
// out: (M, ceil(K/32)) int32. M >= 1, K >= 1.
extern "C" int bnn_sign_pack(const void* x, void* out, int64_t M, int64_t K,
                             int dtype, void* stream) {
  const int64_t k32 = (K + 31) / 32;
  const int64_t blocks = (M * k32 + kWarps - 1) / kWarps;
  const unsigned grid = static_cast<unsigned>(blocks < 65535 ? blocks : 65535);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* op = static_cast<int32_t*>(out);
  if (dtype == BNN_BF16) {
    sign_pack_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), op, M, K, k32);
  } else {
    sign_pack_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), op, M, K, k32);
  }
  return static_cast<int>(cudaGetLastError());
}
