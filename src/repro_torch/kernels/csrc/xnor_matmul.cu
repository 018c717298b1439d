// K4: XNOR-popcount matmul over bitpacked operands,
//   dot[m, n] = k_total - 2 * sum_j popc(a[m, j] XOR w[j, n]),
// a (M, W) int32 (packed along the last axis), w (W, N) int32 (packed along
// the first axis), out (M, N) int32, or f32(dot) * scale[n] when a scale is
// given. For a convolution lowered onto it (xnor/conv/ops.py) the flush also
// adds the exact zero-padding border correction: output row m is pixel
// (oh, ow) = ((m / OW) % OH, m % OW), and every tap (dy, dx) of that pixel
// that reads a zero-padded input position adds tap_sums[dy * kw + dx, n]
// (the per-tap sum of sign(w), kept on the weight leaf since pack time).
//
// Replaces the TPU kernel xnor_matmul_pallas (src/repro/xnor/kernel.py:
// _xnor_kernel and _xnor_scaled_kernel), and the border-correction and
// epilogue ops that follow it on the conv path (src/repro/xnor/conv/ops.py).
//
// Bound on this card: at the serving shapes the operands and the output are a
// few hundred KB, so the bytes bound is a fraction of a microsecond; the
// popcount work, one popc per (row, column, word) on the CUDA cores (16 a
// clock per SM), is the larger bound at VGG's shapes (0.3-1.1 us a layer at
// the peak rate). At these sizes latency rules: launching the blocks and
// each round of dependent L2 loads cost about as much as the popcounts.
//
// Why the CUDA cores: the tensor cores' 1-bit MMA (mma.sync.m16n8k256 .b1
// with .and.popc) compiles for sm_90a, but Hopper has no 1-bit tensor-core
// instruction, so ptxas expands it into integer code (no BMMA in the SASS),
// and a version built on it ran slower than this one.
//
// Design. A thread owns one output column (lanes on neighbouring columns, so
// each weight word is one coalesced load) and R rows (each weight word is
// reused for R popcounts; the a words are warp-wide broadcasts). The block's
// warps split W, each taking kChunk words at a time with every load issued
// before the popcounts, and reduce their partial counts in shared memory
// (integer sums: exact in any order), one warp a row. The entry picks the
// variant by shape: R = 4 rows for M >= 64, where blocks are plenty, R = 1
// below that (the 16-row deep conv layers and the batch-4 FC layers: 4x the
// blocks for the same work); and the warps a block gets from the card's
// occupancy, so that the blocks fit in as few waves as the word rounds allow.
// Blocks are numbered along grid.x, columns fastest (neighbouring blocks share
// their a rows in L2), so no grid dimension limits M or N. The flush's
// operands, the block's 32 scales and tap sums, are copied to shared memory
// with cp.async at the start, so they arrive during the K loop. The flush
// writes k_total - 2 * count, plus, for a pixel that touches the padding
// (found with 32-bit integer arithmetic; one warp shares a row, so the test
// does not diverge), the tap sums of its padded taps; then the int32 value or
// __fmul_rn(__int2float_rn(dot), scale[n]), which is bit-equal to the
// reference's (dot + corr).astype(f32) * scale. Rows and columns past the
// edge, and words past W, are never loaded or stored, so no caller pads, and
// layouts with self-cancelling surplus words (allow_extra_words) need nothing
// special.
#include "common.cuh"

namespace {

constexpr int kChunk = 4;               // words of W a warp loads at once
constexpr int kMaxTaps = 25;            // taps whose sums a block stages (up to 5 x 5)

// Where a convolution's zero-padded taps fall; tap_sums null: no correction.
struct ConvBorder {
  const int32_t* tap_sums;              // (kh * kw, N) int32
  int h, w, oh, ow;                     // input and output spatial extents
  int kh, kw, sh, sw, ph0, pw0;         // kernel, stride, leading padding
};

struct Flush {
  const float* scale;                   // (N,) f32, or null for int32 output
  void* out;                            // (M, N)
  int64_t M, N;
  int k_total;
  ConvBorder border;
};

// Warps a block may have.
template <int R>
__host__ __device__ constexpr int max_warps() { return R == 1 ? 32 : 16; }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

// Bit t set: tap t of output row m reads a zero-padded position. Every
// lane of a warp has the same m, so the same mask; taps <= 32.
__device__ __forceinline__ unsigned padded_taps(const ConvBorder& b, int64_t m) {
  const int img = b.oh * b.ow;
  const int pix = m < 0x7FFFFFFF ? static_cast<int>(m) % img : static_cast<int>(m % img);
  const int ih0 = (pix / b.ow) * b.sh - b.ph0;
  const int iw0 = (pix % b.ow) * b.sw - b.pw0;
  if (ih0 >= 0 && iw0 >= 0 && ih0 + b.kh <= b.h && iw0 + b.kw <= b.w) return 0u;
  unsigned cols = 0u;                   // bit dx: column iw0 + dx is padding
  for (int dx = 0; dx < b.kw; ++dx) cols |= static_cast<unsigned>(iw0 + dx < 0 || iw0 + dx >= b.w) << dx;
  const unsigned row = (1u << b.kw) - 1u;
  unsigned mask = 0u;
  for (int dy = 0; dy < b.kh; ++dy)
    mask |= (ih0 + dy < 0 || ih0 + dy >= b.h ? row : cols) << (dy * b.kw);
  return mask;
}

// The correction of one output: the tap sums of its padded taps, from the
// block's staged copy (or, past kMaxTaps taps, from global memory, testing
// every tap).
__device__ __forceinline__ int correction(const Flush& f, int64_t m, int64_t n, unsigned mask,
                                          const int (*tap_sums)[32], int lane) {
  const ConvBorder& b = f.border;
  int corr = 0;
  if (b.kh * b.kw <= kMaxTaps) {
    for (; mask != 0u; mask &= mask - 1u) corr += tap_sums[__ffs(mask) - 1][lane];
    return corr;
  }
  const int pix = static_cast<int>(m % (static_cast<int64_t>(b.oh) * b.ow));
  const int ih0 = (pix / b.ow) * b.sh - b.ph0;
  const int iw0 = (pix % b.ow) * b.sw - b.pw0;
  for (int dy = 0, t = 0; dy < b.kh; ++dy) {
    for (int dx = 0; dx < b.kw; ++dx, ++t) {
      if (ih0 + dy < 0 || ih0 + dy >= b.h || iw0 + dx < 0 || iw0 + dx >= b.w)
        corr += __ldg(b.tap_sums + t * f.N + n);
    }
  }
  return corr;
}

template <int R>
__global__ void __launch_bounds__(32 * max_warps<R>())
xnor_matmul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ w, int64_t W,
                   int64_t col_blocks, Flush f) {
  __shared__ int part[max_warps<R>()][R][32];
  __shared__ int tap_sums[kMaxTaps][32];    // this block's columns
  __shared__ float scale[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x % col_blocks) * 32;
  const int64_t n = n0 + lane;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / col_blocks) * R;
  const bool col_ok = n < f.N;
  const ConvBorder& b = f.border;
  const int taps = b.kh * b.kw;

  // The flush's operands (the block's scale and tap sums) are copied to
  // shared memory asynchronously, so they arrive while the K loop runs.
  {
    const int cols = f.N - n0 < 32 ? static_cast<int>(f.N - n0) : 32;
    if (f.scale != nullptr && static_cast<int>(threadIdx.x) < cols)
      cp_async4(&scale[threadIdx.x], f.scale + n0 + threadIdx.x);
    if (b.tap_sums != nullptr && taps <= kMaxTaps) {
      for (int i = threadIdx.x; i < taps * 32; i += blockDim.x) {
        if (i % 32 < cols)
          cp_async4(&tap_sums[i / 32][i % 32], b.tap_sums + (i / 32) * f.N + n0 + i % 32);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // Each warp takes kChunk consecutive words at a time, all loads issued
  // before any popcount; words past W and rows past M load as 0.
  int acc[R] = {};
  for (int64_t j0 = static_cast<int64_t>(warp) * kChunk; j0 < W;
       j0 += static_cast<int64_t>(warps) * kChunk) {
    uint32_t wv[kChunk], av[R][kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      wv[c] = (j0 + c < W && col_ok) ? __ldg(w + (j0 + c) * f.N + n) : 0u;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        av[r][c] = (j0 + c < W && m0 + r < f.M) ? __ldg(a + (m0 + r) * W + j0 + c) : 0u;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < kChunk; ++c) acc[r] += __popc(av[r][c] ^ wv[c]);
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) part[warp][r][lane] = acc[r];
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // One warp a row: the partial counts in a fixed order, the correction, the
  // scale, the store.
  for (int r = warp; r < R; r += warps) {
    const int64_t m = m0 + r;
    if (m >= f.M || !col_ok) continue;
    int count = 0;
    for (int q = 0; q < warps; ++q) count += part[q][r][lane];
    int dot = f.k_total - 2 * count;
    if (b.tap_sums != nullptr) {
      dot += correction(f, m, n, taps <= kMaxTaps ? padded_taps(b, m) : 0u, tap_sums, lane);
    }
    if (f.scale != nullptr) {
      static_cast<float*>(f.out)[m * f.N + n] = __fmul_rn(__int2float_rn(dot), scale[lane]);
    } else {
      static_cast<int32_t*>(f.out)[m * f.N + n] = dot;
    }
  }
}

// Blocks of each size one SM holds at once, for one row tiling, read once.
template <int R>
const int* blocks_per_sm() {
  static int table[max_warps<R>() + 1] = {};
  if (table[1] == 0) {
    for (int wp = 1; wp <= max_warps<R>(); ++wp)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&table[wp], xnor_matmul_kernel<R>, 32 * wp, 0);
  }
  return table;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Warps a block gets: the count that minimises the waves of blocks times
// the chunk rounds each warp walks plus two (a block's launch, reduction and
// flush), taking the larger count on a tie.
template <int R>
int pick_warps(int64_t blocks, int64_t chunks) {
  const int* per_sm = blocks_per_sm<R>();
  const int64_t sms = sm_count();
  int best = 1;
  int64_t best_cost = -1;
  const int top = chunks < max_warps<R>() ? static_cast<int>(chunks) : max_warps<R>();
  for (int wp = top; wp >= 1; --wp) {
    const int64_t resident = static_cast<int64_t>(per_sm[wp] > 0 ? per_sm[wp] : 1) * sms;
    const int64_t cost = (blocks + resident - 1) / resident * ((chunks + wp - 1) / wp + 2);
    if (best_cost < 0 || cost < best_cost) best = wp, best_cost = cost;
  }
  return best;
}

template <int R>
cudaError_t launch(const uint32_t* a, const uint32_t* w, int64_t W, int64_t N, const Flush& f,
                   cudaStream_t s) {
  const int64_t col_blocks = (N + 31) / 32;
  const int64_t blocks = (f.M + R - 1) / R * col_blocks;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  const int wp = pick_warps<R>(blocks, (W + kChunk - 1) / kChunk);
  xnor_matmul_kernel<R><<<static_cast<unsigned>(blocks), 32 * wp, 0, s>>>(a, w, W, col_blocks, f);
  return cudaGetLastError();
}

}  // namespace

// a: (M, W) int32; w: (W, N) int32; scale: (N,) f32 or null; out: (M, N)
// int32 when scale is null, else f32. tap_sums: (kh * kw, N) int32 or null;
// when given, geo holds (h, w, oh, ow, kh, kw, sh, sw, ph0, pw0): row m of a
// is the im2col patch of output pixel m of an (h, w) -> (oh, ow) convolution
// with kernel (kh, kw), stride (sh, sw) and leading padding (ph0, pw0), and
// its border correction is added. All row-major and contiguous; M, W, N >= 1.
extern "C" int bnn_xnor_matmul(const void* a, const void* w, const void* scale,
                               const void* tap_sums, void* out, int64_t M, int64_t W,
                               int64_t N, int k_total, const int* geo, void* stream) {
  ConvBorder border{static_cast<const int32_t*>(tap_sums), 0, 0, 1, 1, 0, 0, 0, 0, 0, 0};
  if (tap_sums != nullptr) {
    border = ConvBorder{border.tap_sums, geo[0], geo[1], geo[2], geo[3], geo[4], geo[5],
                        geo[6], geo[7], geo[8], geo[9]};
  }
  const Flush f{static_cast<const float*>(scale), out, M, N, k_total, border};
  const uint32_t* ap = static_cast<const uint32_t*>(a);
  const uint32_t* wp = static_cast<const uint32_t*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 4 rows a thread where the blocks are plenty; 1 below that (4x the blocks)
  const cudaError_t err = M >= 64 ? launch<4>(ap, wp, W, N, f, s) : launch<1>(ap, wp, W, N, f, s);
  return static_cast<int>(err);
}
