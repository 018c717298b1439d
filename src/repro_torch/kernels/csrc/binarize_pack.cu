// K1: fused binarize + bitpack of a (K, N) master weight into (ceil(K/32), N)
// int32 words; bit b of word [k32, n] is the sign of w[32*k32 + b, n].
//
// Replaces the TPU kernel binarize_pack_pallas
// (src/repro/kernels/stoch_binarize.py: _det_kernel and _stoch_kernel, the
// variant that takes its uniform words as an operand).
//
// Bound on this card: device-memory bytes. Each weight is read once (plus one
// uint32 word for the stochastic rule) and one int32 is written per 32
// weights; there is no arithmetic worth counting. At 2048 x 2048 f32 that is
// 17.3 MB (det) or 34.1 MB (stoch).
//
// Design: one thread owns one output word and walks its 32 rows, so the 32
// threads of a warp read 32 neighbouring columns of one row at each step
// (128-byte coalesced loads) and write 32 neighbouring words once. Words are
// ORed in registers; nothing is staged in shared memory because nothing is
// reused. Rows >= K give bit 0, the same as padding with -1. The stochastic
// threshold uses round-to-nearest intrinsics for every step so that no
// contraction or fast-math rewrite can move a bit away from the reference:
//   p = clip((w + 1) * 0.5, 0, 1),  bit = (float(u) < p * 2^32) | (p >= 1).
// p >= 1 is forced to 1: words >= 2^32 - 128 round up to 2^32 in f32 and
// would tie with the threshold.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool kStoch>
__global__ void __launch_bounds__(kThreads)
binarize_pack_kernel(const T* __restrict__ w, const uint32_t* __restrict__ bits,
                     int32_t* __restrict__ out, int64_t K, int64_t N,
                     int64_t n_words) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n_words) return;
  const int64_t k32 = idx / N;
  const int64_t n = idx - k32 * N;
  const int64_t row0 = k32 * 32;
  const int64_t left = K - row0;
  const int rows = left < 32 ? static_cast<int>(left) : 32;
  uint32_t word = 0;
#pragma unroll 8
  for (int b = 0; b < rows; ++b) {
    const int64_t off = (row0 + b) * N + n;
    const float v = bnn_to_float(w[off]);
    bool one;
    if constexpr (kStoch) {
      const float p =
          fminf(fmaxf(__fmul_rn(__fadd_rn(v, 1.0f), 0.5f), 0.0f), 1.0f);
      const float thresh = __fmul_rn(p, 4294967296.0f);
      const float u = __uint2float_rn(bits[off]);
      one = (u < thresh) || (p >= 1.0f);
    } else {
      one = v > 0.0f;
    }
    word |= static_cast<uint32_t>(one) << b;
  }
  out[idx] = static_cast<int32_t>(word);
}

template <typename T>
void launch(const void* w, const void* bits, void* out, int64_t K, int64_t N,
            int stochastic, cudaStream_t stream) {
  const int64_t n_words = ((K + 31) / 32) * N;
  const unsigned blocks = static_cast<unsigned>((n_words + kThreads - 1) / kThreads);
  const T* wp = static_cast<const T*>(w);
  const uint32_t* bp = static_cast<const uint32_t*>(bits);
  int32_t* op = static_cast<int32_t*>(out);
  if (stochastic) {
    binarize_pack_kernel<T, true><<<blocks, kThreads, 0, stream>>>(wp, bp, op, K, N, n_words);
  } else {
    binarize_pack_kernel<T, false><<<blocks, kThreads, 0, stream>>>(wp, bp, op, K, N, n_words);
  }
}

}  // namespace

// w: (K, N) f32 or bf16 (dtype: BnnDtype); bits: (K, N) uint32 words, read
// only when stochastic != 0; out: (ceil(K/32), N) int32. All row-major and
// contiguous. K >= 1, N >= 1.
extern "C" int bnn_binarize_pack(const void* w, const void* bits, void* out,
                                 int64_t K, int64_t N, int dtype, int stochastic,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BNN_BF16) {
    launch<__nv_bfloat16>(w, bits, out, K, N, stochastic, s);
  } else {
    launch<float>(w, bits, out, K, N, stochastic, s);
  }
  return static_cast<int>(cudaGetLastError());
}
