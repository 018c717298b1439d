// K2: out (M, N) f32 = x (M, K) @ unpack(w (ceil(K/32), N) int32)[:K] [* scale],
// with bit 1 -> +1 and bit 0 -> -1, summed in f32; in its expert-batched mode
// the same for each of E experts in one launch: x (E, M, K), w (E, ceil(K/32),
// N), scale (E, N), out (E, M, N), expert e's rows past rows[e] written as
// +0 [* scale].
//
// Replaces the TPU kernel binary_matmul_pallas
// (src/repro/kernels/binary_matmul.py: _bmm_kernel and _bmm_scaled_kernel),
// and, batched, the reference MoE's jax.vmap of it over the experts
// (src/repro/models/moe.py: _expert_matmul).
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
//
// So for one (row, column) the sum is a fixed tree: K splits into 8 slices
// of per = ceil(ceil(K/32) / 8) word rows; in slice s, chain c (warp c)
// sums word rows s*per + c + 8j (j = 0, 1, ...), bits 0..31 in order, by
// fmaf from +0; the slice's sum is the left fold of chains 0..7, the result
// the left fold of slices 0..7, times the scale once.
//
// Expert-batched mode (binary_matmul_batched_kernel), for an MoE layer's
// experts at decode: Moonlight's 64 experts x 8 rows x 2048 x 1408, where 4
// tokens x top-6 fill at most 24 of the 512 rows and 24 of the 64 experts.
// Its bound is the routed bytes: the live experts' words, their rows of x
// and the (E, M, N) output written once (~12 MB, ~3.5 us at 24 experts).
// Its first design was the 2-D kernel with the expert on grid.z (E x 8-block
// clusters), which paid for every row and expert: both 4-row groups of all
// 64 experts, so every word was read twice, and 45,056-65,536 blocks that
// each walked one 8-word step behind two barriers and two cluster syncs.
// Now the MoE layer passes its per-expert counts (rows, the assignments
// before the capacity cut, clamped here to M): a block owns one (expert,
// 128-column tile) across all of K, reads rows[e] first, writes +0 [*
// scale] to the rows past it, and returns before loading a word if none is
// live. There is no cluster: its 8 blocks became the block's 8 warps, warp
// s taking K slice s with the 2-D kernel's slice bounds; a lane takes 4
// columns with one 16-byte load per word row. Each warp stages its slice's
// words (one word row per chain while per <= 8, as at K <= 2048) and the
// live rows of x for them in its own shared memory, all loads issued before
// any FMA and behind a __syncwarp only, so each word is read once and used
// for every live row, up to 8 rows at a time in registers (FMAs only on
// live rows). A thread computes chain c, folds it into a running slice sum,
// then chain c + 1 (two accumulators per (row, column), not eight), and the
// block folds the 8 slice sums through shared memory in slice order, times
// the scale once: the same tree as above, so every live row is bit for bit
// the 2-D kernel's on its slices. CUDA cores, not tensor cores: an MMA
// would sum in another order. With one row an expert, as at decode, the
// kernel is issue-bound rather than byte-bound: each bit's +-1 takes two
// ops (walk) that no other row shares. Any E <= 65535 (grid.y), M, K and N
// work, ragged edges masked; past per = 8 (K > 2048) a warp stages 8 word
// rows of one chain at a time, reading the words again for each 8-row
// chunk: not tuned, no served path sends it.
#include <cooperative_groups.h>

#include <type_traits>

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

// --- expert-batched mode ---

constexpr int kBRows = 8;                               // rows a chunk holds in registers
constexpr int kBCols = 128;                             // columns per block, 4 per lane
constexpr int kBEntries = 8;                            // word rows a warp stages at once
constexpr int kBXsBytes = kBRows * kBEntries * 32 * 4;  // f32 x: 8 rows x 8 word rows
constexpr int kBWarpBytes = kBXsBytes + kBEntries * 32 * 16;   // + the words, 16 B a lane
constexpr int kBSmem = kWarps * kBWarpBytes;            // 96 KB, dynamic
static_assert(kWarps == kSplit, "a warp takes the K slice a cluster block took");

// The 4 words of columns n0..n0+3 in one word row (0 past N); one 16-byte
// load where the row's words are 16-byte aligned.
__device__ __forceinline__ uint4 load_words(const int32_t* __restrict__ row, int64_t n0,
                                            int64_t N, bool vec) {
  if (n0 >= N) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + n0));
  uint4 v;
  v.x = static_cast<uint32_t>(__ldg(row + n0));
  v.y = n0 + 1 < N ? static_cast<uint32_t>(__ldg(row + n0 + 1)) : 0u;
  v.z = n0 + 2 < N ? static_cast<uint32_t>(__ldg(row + n0 + 2)) : 0u;
  v.w = n0 + 3 < N ? static_cast<uint32_t>(__ldg(row + n0 + 3)) : 0u;
  return v;
}

// acc[r][c] += the staged word row i's 32 terms for rows r < R and the
// lane's 4 columns, bits in order (the 2-D kernel's FMAs, row for row). The
// +-1 of 4 bits x 4 columns is made once and used for all R rows, in two
// integer ops a bit: the word is bit-reversed once, so bit b sits at bit 31
// after b doublings, and one LOP3 turns bit 31 into +-1.0f. The doubling is
// a multiply by `two` and the LOP3's constant `minus_one` is a register
// (both read at run time, so the compiler cannot fold them): the doubling
// then issues as an IMAD on the FMA pipe rather than a shift on the integer
// pipe, and the LOP3 takes its two constants in one op, so the integer
// pipe, at half the FMA pipe's rate, carries one op a bit.
template <int R>
__device__ __forceinline__ void walk(const float* xs, const uint4* ws, int i, int lane,
                                     uint32_t two, uint32_t minus_one,
                                     float (&acc)[kBRows][4]) {
  const uint4 wd = ws[i * 32 + lane];
  uint32_t rev[4] = {__brev(wd.x), __brev(wd.y), __brev(wd.z), __brev(wd.w)};
#pragma unroll
  for (int b4 = 0; b4 < 8; ++b4) {
    float pm[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // bit 1 -> +1.0f, bit 0 -> -1.0f
        pm[t][c] = __uint_as_float((rev[c] & 0x80000000u) ^ minus_one);
        rev[c] *= two;
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 xv = reinterpret_cast<const float4*>(xs + r * (kBEntries * 32) + i * 32)[b4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(lane4(xv, t), pm[t][c], acc[r][c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
binary_matmul_batched_kernel(const T* __restrict__ x, const int32_t* __restrict__ w,
                             const float* __restrict__ scale, const int64_t* __restrict__ rows,
                             float* __restrict__ out, int64_t M, int64_t K, int64_t N,
                             bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warp's staging: x (kBRows x 8 word rows x 32, f32), then its slice
  // sums (kBRows x kBCols) once the x is used; and the words (8 x 32 lanes)
  float* xs = reinterpret_cast<float*>(smem + warp * kBWarpBytes);
  uint4* ws = reinterpret_cast<uint4*>(smem + warp * kBWarpBytes + kBXsBytes);

  const int64_t e = blockIdx.y;
  const int64_t n_tile = static_cast<int64_t>(blockIdx.x) * kBCols;
  const int64_t n0 = n_tile + lane * 4;
  const int64_t k32 = (K + 31) / 32;
  const uint32_t two = blockDim.x / (kThreads / 2);   // 2 and -1.0f, read at run time (walk)
  const uint32_t minus_one = 0xbf800000u * (two >> 1);
  x += e * M * K;
  w += e * k32 * N;
  if (scale != nullptr) scale += e * N;
  out += e * M * N;
  int64_t live = M;
  if (rows != nullptr) {
    const int64_t r = rows[e];
    live = r < 0 ? 0 : (r < M ? r : M);
  }

  // rows past the count: +0 [* scale], what the product gives on zero rows
  for (int64_t p = threadIdx.x; p < (M - live) * kBCols; p += kThreads) {
    const int64_t n = n_tile + p % kBCols;
    if (n < N) out[(live + p / kBCols) * N + n] = scale != nullptr ? 0.0f * scale[n] : 0.0f;
  }
  if (live == 0) return;

  // warp s = K slice s, with the 2-D kernel's bounds
  const int64_t per = (k32 + kSplit - 1) / kSplit;
  const int64_t kb = warp * per;
  const int64_t ke = kb + per < k32 ? kb + per : k32;
  const int nw = ke > kb ? static_cast<int>(ke - kb) : 0;   // used only while per <= 8
  const bool one_round = per <= kBEntries;                  // a word row per chain

  // word rows base + stride * i (i < cnt) into ws, and rows m0..m0+nr-1 of
  // x for them into xs (0 past K, past cnt and past nr), P entries a pass
  // with every load of a pass issued before its stores (fewer inside the
  // chain loop, where the sums hold registers)
  auto stage = [&](auto pass_tag, bool words, int64_t m0, int nr, int64_t base,
                   int64_t stride, int cnt) {
    constexpr int P = decltype(pass_tag)::value;
#pragma unroll 1
    for (int i0 = 0; i0 < kBEntries; i0 += P) {
      uint4 wv[P];
      float xv[kBRows][P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int i = i0 + j;
        const int64_t kw = base + stride * i;
        if (words) wv[j] = i < cnt ? load_words(w + kw * N, n0, N, vec) : make_uint4(0, 0, 0, 0);
        const int64_t k = kw * 32 + lane;
#pragma unroll
        for (int r = 0; r < kBRows; ++r)
          xv[r][j] = (r < nr && i < cnt && k < K) ? bnn_to_float(x[(m0 + r) * K + k]) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int i = i0 + j;
        if (words) ws[i * 32 + lane] = wv[j];
#pragma unroll
        for (int r = 0; r < kBRows; ++r) xs[r * (kBEntries * 32) + i * 32 + lane] = xv[r][j];
      }
    }
  };

  // the slice sums of rows m0..m0+R-1: chain c, then folded, then chain c + 1
  auto slice_sums = [&](auto rows_tag, int64_t m0, float (&blk)[kBRows][4]) {
    constexpr int R = decltype(rows_tag)::value;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) blk[r][c] = 0.0f;
#pragma unroll 1
    for (int chain = 0; chain < kWarps; ++chain) {
      float acc[kBRows][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 1
      for (int64_t j0 = kb + chain; j0 < ke; j0 += kWarps * kBEntries) {
        int i0 = chain, i1 = chain + 1;     // one round: staged up front, entry = chain
        if (!one_round) {
          const int64_t left = (ke - j0 + kWarps - 1) / kWarps;
          const int cnt = left < kBEntries ? static_cast<int>(left) : kBEntries;
          __syncwarp();
          stage(std::integral_constant<int, 1>{}, true, m0, R, j0, kWarps, cnt);
          __syncwarp();
          i0 = 0;
          i1 = cnt;
        }
#pragma unroll 1
        for (int i = i0; i < i1; ++i) walk<R>(xs, ws, i, lane, two, minus_one, acc);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) blk[r][c] = chain == 0 ? acc[r][c] : blk[r][c] + acc[r][c];
    }
  };

  for (int64_t m0 = 0; m0 < live; m0 += kBRows) {
    const int nr = live - m0 < kBRows ? static_cast<int>(live - m0) : kBRows;
    if (one_round) {                        // the words with the first chunk, once
      __syncwarp();
      stage(std::integral_constant<int, 4>{}, m0 == 0, m0, nr, kb, 1, nw);
      __syncwarp();
    }
    float blk[kBRows][4];
    switch (nr) {
      case 1: slice_sums(std::integral_constant<int, 1>{}, m0, blk); break;
      case 2: slice_sums(std::integral_constant<int, 2>{}, m0, blk); break;
      case 3: slice_sums(std::integral_constant<int, 3>{}, m0, blk); break;
      case 4: slice_sums(std::integral_constant<int, 4>{}, m0, blk); break;
      case 5: slice_sums(std::integral_constant<int, 5>{}, m0, blk); break;
      case 6: slice_sums(std::integral_constant<int, 6>{}, m0, blk); break;
      case 7: slice_sums(std::integral_constant<int, 7>{}, m0, blk); break;
      default: slice_sums(std::integral_constant<int, 8>{}, m0, blk); break;
    }
    __syncwarp();                           // xs is read; it now takes the slice sums
#pragma unroll
    for (int r = 0; r < kBRows; ++r)
      if (r < nr)
        reinterpret_cast<float4*>(xs + r * kBCols)[lane] =
            make_float4(blk[r][0], blk[r][1], blk[r][2], blk[r][3]);
    __syncthreads();
    for (int p = threadIdx.x; p < nr * kBCols; p += kThreads) {
      const int r = p / kBCols;
      const int col = p % kBCols;
      const int64_t n = n_tile + col;
      float s = reinterpret_cast<const float*>(smem)[r * kBCols + col];
#pragma unroll
      for (int q = 1; q < kWarps; ++q)
        s += reinterpret_cast<const float*>(smem + q * kBWarpBytes)[r * kBCols + col];
      if (n < N) out[(m0 + r) * N + n] = scale != nullptr ? s * scale[n] : s;
    }
    __syncthreads();                        // the sums are read before the next chunk stages
  }
}

template <typename T>
int launch_batched(dim3 grid, cudaStream_t s, const T* x, const int32_t* w, const float* scale,
                   const int64_t* rows, float* out, int64_t M, int64_t K, int64_t N, bool vec) {
  const cudaError_t attr = cudaFuncSetAttribute(
      binary_matmul_batched_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  binary_matmul_batched_kernel<T><<<grid, kThreads, kBSmem, s>>>(x, w, scale, rows, out, M, K,
                                                                 N, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (E, M, K) f32 or bf16 (dtype: BnnDtype), the compute dtype; w: (E,
// ceil(K/32), N) int32; scale: (E, N) f32 or null; rows: (E,) int64 or
// null (every row live); out: (E, M, N) f32. All row-major, contiguous.
// 1 <= E <= 65535 (grid.y), M >= 1, K >= 1, N >= 1.
extern "C" int bnn_binary_matmul_batched(const void* x, const void* w, const void* scale,
                                         const void* rows, void* out, int64_t E, int64_t M,
                                         int64_t K, int64_t N, int dtype, void* stream) {
  const dim3 grid(static_cast<unsigned>((N + kBCols - 1) / kBCols), static_cast<unsigned>(E));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* wp = static_cast<const int32_t*>(w);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(wp) % 16 == 0;
  const float* sp = static_cast<const float*>(scale);
  const int64_t* rp = static_cast<const int64_t*>(rows);
  float* op = static_cast<float*>(out);
  if (dtype == BNN_BF16) {
    return launch_batched<__nv_bfloat16>(grid, s, static_cast<const __nv_bfloat16*>(x), wp, sp,
                                         rp, op, M, K, N, vec);
  }
  return launch_batched<float>(grid, s, static_cast<const float*>(x), wp, sp, rp, op, M, K, N,
                               vec);
}

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
