// K4: XNOR-popcount matmul over bitpacked operands,
//   dot[m, n] = k_total - 2 * sum_j popc(a[m, j] XOR w[j, n]),
// a (M, W) int32 (packed along the last axis), w (W, N) int32 (packed along
// the first axis), out (M, N) int32, or f32(dot) * scale[n] when a scale is
// given.
//
// Replaces the TPU kernel xnor_matmul_pallas (src/repro/xnor/kernel.py:
// _xnor_kernel and _xnor_scaled_kernel).
//
// Bound on this card: at the serving shapes the bytes (the packed operands and
// the output are a few hundred KB), and past them the popc issue rate of the
// CUDA cores (16 a clock per SM; XOR and the add issue at 64). Nothing here
// touches the tensor cores; a b1 mma.sync version is later work.
//
// Design (simple and exact first): a 256-thread block owns a 4 x 64 output
// tile, thread (ty, tx) = (tid / 64, tid % 64) the element (ty, tx), so the
// serving batch of 4 rows fills the tile with no zero rows. Per step the
// block stages 32 words of its 4 a rows and the matching 32 x 64 w words in
// shared memory (coalesced 128/256-byte loads); a warp shares one row, so
// the a read is a broadcast and the w read hits 32 distinct banks. The sum
// is an int32 of popcounts, exact; the flush writes k_total - 2*acc, or
// __int2float_rn(dot) * scale with round-to-nearest, which is bit-equal to
// the reference's dot.astype(f32) * scale. Ragged M, N and W are masked:
// out-of-range words stage as 0 on both sides and XOR to 0, and rows or
// columns past the edge are not stored, so no caller pads and layouts with
// self-cancelling surplus words (allow_extra_words) need nothing special.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;                 // output columns per block
constexpr int kBM = kThreads / kBN;     // 4 output rows per block
constexpr int kKW = 32;                 // words per step

__global__ void __launch_bounds__(kThreads)
xnor_matmul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ w,
                   const float* __restrict__ scale, void* __restrict__ out,
                   int64_t M, int64_t W, int64_t N, int k_total) {
  __shared__ uint32_t as[kBM][kKW];
  __shared__ uint32_t ws[kKW][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % kBN;
  const int ty = tid / kBN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kBN;

  int acc = 0;
  for (int64_t kw0 = 0; kw0 < W; kw0 += kKW) {
    for (int e = tid; e < kBM * kKW; e += kThreads) {
      const int r = e / kKW;
      const int c = e % kKW;
      const int64_t m = m0 + r;
      const int64_t kw = kw0 + c;
      as[r][c] = (m < M && kw < W) ? a[m * W + kw] : 0u;
    }
    for (int e = tid; e < kKW * kBN; e += kThreads) {
      const int r = e / kBN;
      const int c = e % kBN;
      const int64_t kw = kw0 + r;
      const int64_t n = n0 + c;
      ws[r][c] = (kw < W && n < N) ? w[kw * N + n] : 0u;
    }
    __syncthreads();
    const int steps = W - kw0 < kKW ? static_cast<int>(W - kw0) : kKW;
#pragma unroll 8
    for (int kk = 0; kk < steps; ++kk) acc += __popc(as[ty][kk] ^ ws[kk][tx]);
    __syncthreads();
  }

  const int64_t m = m0 + ty;
  const int64_t n = n0 + tx;
  if (m >= M || n >= N) return;
  const int dot = k_total - 2 * acc;
  if (scale != nullptr) {
    static_cast<float*>(out)[m * N + n] = __fmul_rn(__int2float_rn(dot), scale[n]);
  } else {
    static_cast<int32_t*>(out)[m * N + n] = dot;
  }
}

}  // namespace

// a: (M, W) int32; w: (W, N) int32; scale: (N,) f32 or null; out: (M, N)
// int32 when scale is null, else f32. All row-major and contiguous.
// M, W, N >= 1; N <= 65535 * 64.
extern "C" int bnn_xnor_matmul(const void* a, const void* w, const void* scale,
                               void* out, int64_t M, int64_t W, int64_t N,
                               int k_total, void* stream) {
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((N + kBN - 1) / kBN));
  xnor_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(scale), out, M, W, N, k_total);
  return static_cast<int>(cudaGetLastError());
}
