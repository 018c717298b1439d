// K2: out (M, N) f32 = x (M, K) @ unpack(w (ceil(K/32), N) int32)[:K] [* scale],
// with bit 1 -> +1 and bit 0 -> -1, summed in f32.
//
// Replaces the TPU kernel binary_matmul_pallas
// (src/repro/kernels/binary_matmul.py: _bmm_kernel and _bmm_scaled_kernel).
//
// Bound on this card: the f32 operations on CUDA cores (2*M*K*N at
// 67 TFLOP/s, the data sheet's non-tensor f32 rate); the packed weights are
// only K*N/8 bytes. At the serving shapes (M = 4, K = N = 2048 or 512) both
// bounds are under a microsecond, so what limits the kernel is latency:
// how many SMs it keeps busy and how many dependent steps each block takes.
//
// Design, for the serving batch of 4 rows: a block of 8 warps owns 32
// columns (one per lane) and 4 rows (every thread accumulates all four), and
// a cluster of 8 blocks splits K into 8 slices, so N = 2048 runs 512 blocks
// and N = 512 runs 128 where a 32-column block alone would give 64 and 16.
// Each block walks its K slice in steps of 8 word rows, one per warp: a warp
// loads its word row with one coalesced 128-byte load (issued before the
// step's barrier, so it overlaps the staging), the block stages the 4 x 256
// activations of the step in shared memory once, and every lane reads them
// as warp-wide broadcasts. Each bit becomes +-1.0f in registers (the sign
// bit is the inverted weight bit) and an FMA with an exact product adds it
// to the f32 sum: the paper's sign-controlled accumulation, in full f32 (no
// TF32). The partial sums are reduced in a fixed order, with no atomics, so
// two calls give bit-identical output: the 8 warps through shared memory,
// then the 8 blocks of the cluster through distributed shared memory, read
// by rank 0 in rank order. The scale is applied once at that flush. Larger M
// runs one 4-row group per grid.y; past grid.y's 65535 the launch takes the
// kStride instantiation, whose blocks walk their 4-row groups with a grid
// stride (a cluster takes the same groups, so each group's reduction keeps
// its order). It is a separate instantiation because in one kernel the loop
// slows the serving shapes (60 registers against 40). Ragged M,
// N and K are masked here (rows
// and activations past the edge stage as 0, words past N load as 0, and
// nothing past the edge is stored), so no caller pads.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 4;                // output rows per block: the serving batch
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;   // 256
constexpr int kSplit = 8;               // blocks per cluster, each one K slice
constexpr int kStage = 32 * kWarps;     // activations per row per step (a word row per warp)

__device__ __forceinline__ float lane4(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

template <typename T, bool kStride>
__global__ void __cluster_dims__(1, 1, kSplit) __launch_bounds__(kThreads)
binary_matmul_kernel(const T* __restrict__ x, const int32_t* __restrict__ w,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int64_t M, int64_t K, int64_t N) {
  __shared__ __align__(16) float xs[kRows][kStage];
  __shared__ float part[kWarps][kRows][32];
  __shared__ float blk[kRows][32];       // this block's sum, read by rank 0

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned split = cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  const int64_t k32_total = (K + 31) / 32;
  const int64_t per = (k32_total + kSplit - 1) / kSplit;
  const int64_t kw_begin = split * per;
  const int64_t kw_end = kw_begin + per < k32_total ? kw_begin + per : k32_total;

  // one 4-row group; blocks of the kStride instantiation walk several
  auto row_group = [&](int64_t group) {
    const int64_t m0 = group * kRows;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;

    for (int64_t kw0 = kw_begin; kw0 < kw_end; kw0 += kWarps) {
      const int64_t kw = kw0 + warp;
      const bool live = kw < kw_end;
      const uint32_t inv = ~((live && n < N) ? static_cast<uint32_t>(w[kw * N + n]) : 0u);
      const int64_t k_end = kw_end * 32 < K ? kw_end * 32 : K;   // this slice's last activation
      for (int e = threadIdx.x; e < kRows * kStage; e += kThreads) {
        const int r = e / kStage;
        const int c = e % kStage;
        const int64_t m = m0 + r;
        const int64_t k = kw0 * 32 + c;
        xs[r][c] = (m < M && k < k_end) ? bnn_to_float(x[m * K + k]) : 0.0f;
      }
      __syncthreads();
      if (live) {
#pragma unroll
        for (int b4 = 0; b4 < 8; ++b4) {
          float4 xv[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            xv[r] = reinterpret_cast<const float4*>(&xs[r][warp * 32])[b4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int b = 4 * b4 + t;
            // bit b of the word -> +1.0f (bit 1) or -1.0f (bit 0)
            const float pm = __uint_as_float(0x3f800000u | ((inv << (31 - b)) & 0x80000000u));
#pragma unroll
            for (int r = 0; r < kRows; ++r) acc[r] = fmaf(lane4(xv[r], t), pm, acc[r]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) part[warp][r][lane] = acc[r];
    __syncthreads();
    const int r = threadIdx.x >> 5;        // threads 0..127: one (row, column) each
    if (threadIdx.x < kRows * 32) {
      float s = part[0][r][lane];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) s += part[q][r][lane];
      blk[r][lane] = s;
    }
    cluster.sync();
    if (split == 0 && threadIdx.x < kRows * 32) {
      float s = *cluster.map_shared_rank(&blk[r][lane], 0);
#pragma unroll
      for (unsigned q = 1; q < kSplit; ++q) s += *cluster.map_shared_rank(&blk[r][lane], q);
      const int64_t m = m0 + r;
      if (m < M && n < N) out[m * N + n] = scale != nullptr ? s * scale[n] : s;
    }
    cluster.sync();                        // every blk is read before the next group writes it
  };
  if constexpr (kStride) {
    const int64_t groups = (M + kRows - 1) / kRows;
    for (int64_t group = blockIdx.y; group < groups; group += gridDim.y) row_group(group);
  } else {
    row_group(blockIdx.y);
  }
}

template <typename T>
void launch(dim3 grid, cudaStream_t s, bool stride, const T* x, const int32_t* w,
            const float* scale, float* out, int64_t M, int64_t K, int64_t N) {
  if (stride) {
    binary_matmul_kernel<T, true><<<grid, kThreads, 0, s>>>(x, w, scale, out, M, K, N);
  } else {
    binary_matmul_kernel<T, false><<<grid, kThreads, 0, s>>>(x, w, scale, out, M, K, N);
  }
}

}  // namespace

// x: (M, K) f32 or bf16 (dtype: BnnDtype), the compute dtype; w: (ceil(K/32), N)
// int32; scale: (N,) f32 or null; out: (M, N) f32. All row-major, contiguous.
// M >= 1, K >= 1, N >= 1.
extern "C" int bnn_binary_matmul(const void* x, const void* w, const void* scale,
                                 void* out, int64_t M, int64_t K, int64_t N,
                                 int dtype, void* stream) {
  const int64_t groups = (M + kRows - 1) / kRows;
  const bool stride = groups > 65535;
  const dim3 grid(static_cast<unsigned>((N + 31) / 32),
                  static_cast<unsigned>(stride ? 65535 : groups), kSplit);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* wp = static_cast<const int32_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (dtype == BNN_BF16) {
    launch<__nv_bfloat16>(grid, s, stride, static_cast<const __nv_bfloat16*>(x), wp, sp, op, M, K,
                          N);
  } else {
    launch<float>(grid, s, stride, static_cast<const float*>(x), wp, sp, op, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}
