// K2: out (M, N) f32 = x (M, K) @ unpack(w (ceil(K/32), N) int32)[:K] [* scale],
// with bit 1 -> +1 and bit 0 -> -1, summed in f32.
//
// Replaces the TPU kernel binary_matmul_pallas
// (src/repro/kernels/binary_matmul.py: _bmm_kernel and _bmm_scaled_kernel).
//
// Bound on this card: at the serving shapes the f32 operations on CUDA cores
// (2*M*K*N at 67 TFLOP/s, the data sheet's non-tensor f32 rate); the packed
// weights are only K*N/8 bytes, 1/32 of an f32 matrix, so bytes bound it only
// when M is a handful of rows and K*N is huge.
//
// Design (simple and exact first; wgmma/TMA are later work): each 256-thread
// block owns a 32 x 64 output tile, each thread a 2 x 4 micro-tile whose four
// columns are strided by 16 so that word loads and output stores coalesce.
// Per step the block stages a 32 x 64 activation tile (two packed word rows)
// in shared memory, padded by one column so the row-wise reads of a warp hit
// distinct banks, and the matching 2 x 64 packed words. Each thread expands a
// bit to +-1.0f in registers (the sign bit is the inverted weight bit) and
// accumulates with an FMA whose product is exact: the paper's sign-controlled
// accumulation. Only the order of the f32 sum differs from the reference.
// The scale is applied once at the flush. Ragged M, N and K are masked here:
// out-of-range activations stage as 0 and out-of-range words as 0, and rows
// or columns past the edge are not stored, so no caller pads.
#include "common.cuh"

namespace {

constexpr int kBM = 32;                  // output rows per block
constexpr int kBN = 64;                  // output columns per block
constexpr int kTM = 2;                   // rows per thread
constexpr int kTN = 4;                   // columns per thread
constexpr int kTX = kBN / kTN;           // 16 threads across N
constexpr int kThreads = kTX * (kBM / kTM);  // 256
constexpr int kKW = 2;                   // packed word rows per step
constexpr int kBK = 32 * kKW;            // activations per step

template <typename T>
__global__ void __launch_bounds__(kThreads)
binary_matmul_kernel(const T* __restrict__ x, const int32_t* __restrict__ w,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int64_t M, int64_t K, int64_t N) {
  __shared__ float xs[kBM][kBK + 1];
  __shared__ uint32_t ws[kKW][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  const int64_t k32_total = (K + 31) / 32;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int64_t kw0 = 0; kw0 < k32_total; kw0 += kKW) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK;
      const int c = e % kBK;
      const int64_t m = m0 + r;
      const int64_t k = kw0 * 32 + c;
      xs[r][c] = (m < M && k < K) ? bnn_to_float(x[m * K + k]) : 0.0f;
    }
    for (int e = tid; e < kKW * kBN; e += kThreads) {
      const int r = e / kBN;
      const int c = e % kBN;
      const int64_t kw = kw0 + r;
      const int64_t n = n0 + c;
      ws[r][c] = (kw < k32_total && n < N) ? static_cast<uint32_t>(w[kw * N + n]) : 0u;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kKW; ++r) {
      uint32_t inv[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) inv[j] = ~ws[r][tx + kTX * j];
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        float xv[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i) xv[i] = xs[ty * kTM + i][r * 32 + b];
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          // bit b of the word -> +1.0f (bit 1) or -1.0f (bit 0)
          const float pm =
              __uint_as_float(0x3f800000u | ((inv[j] << (31 - b)) & 0x80000000u));
#pragma unroll
          for (int i = 0; i < kTM; ++i) acc[i][j] = fmaf(xv[i], pm, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int64_t n = n0 + tx + kTX * j;
    if (n >= N) continue;
    const float s = scale != nullptr ? scale[n] : 1.0f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int64_t m = m0 + ty * kTM + i;
      if (m < M) out[m * N + n] = scale != nullptr ? acc[i][j] * s : acc[i][j];
    }
  }
}

}  // namespace

// x: (M, K) f32 or bf16 (dtype: BnnDtype), the compute dtype; w: (ceil(K/32), N)
// int32; scale: (N,) f32 or null; out: (M, N) f32. All row-major, contiguous.
// M <= 65535 * 32, K >= 1, N >= 1.
extern "C" int bnn_binary_matmul(const void* x, const void* w, const void* scale,
                                 void* out, int64_t M, int64_t K, int64_t N,
                                 int dtype, void* stream) {
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + kBM - 1) / kBM));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* wp = static_cast<const int32_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (dtype == BNN_BF16) {
    binary_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wp, sp, op, M, K, N);
  } else {
    binary_matmul_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), wp, sp, op, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}
