// K1: fused binarize + bitpack of a (K, N) master weight into (ceil(K/32), N)
// int32 words; bit b of word [k32, n] is the sign of w[32*k32 + b, n].
//
// Replaces the TPU kernel binarize_pack_pallas
// (src/repro/kernels/stoch_binarize.py): _det_kernel, _stoch_kernel (the
// variant that takes its uniform words as an operand) and
// _stoch_kernel_tpu_prng (the variant that draws them on chip). The first
// two are modes of one tiled kernel, with a third mode that computes the
// operand words the reference's caller draws (jax.random.bits) in its loop;
// the on-chip variant is a kernel of its own.
//
// Modes and what bounds each on this card:
//   det (0)      Eq. 1. Device-memory bytes: each weight read once, one int32
//                written per 32 weights (17.3 MB at 2048 x 2048 f32).
//   operand (1)  Eq. 3 against (K, N) uint32 words read from memory. Bytes,
//                twice det's for f32 (34.1 MB at 2048 x 2048).
//   threefry (3) Eq. 3 against the reference's own words, computed here:
//                word (r, c) is x0 ^ x1 of threefry2x32((k0, k1),
//                (i >> 32, i & 0xFFFFFFFF)) at i = r * draw_cols + c, the
//                row-major index in the shape the reference draws over
//                (core/prng.py: bits). The words never reach memory, so the
//                bytes are det's; the integer work is ~75 32-bit operations
//                a word (20 rounds of add, funnel shift and xor, 5 key
//                injections of two adds, the counter and the final xor).
//                The 20 shifts and 21 xors issue only on the ALU pipe, 64 a
//                clock per SM; the adds issue there or on the FMA pipe (as
//                IMAD), so the shifts and xors set the least time, ~0.010
//                ms at 2048 x 2048, twice the bytes' time: this mode is
//                bound by its integer operations.
//   on-chip (2)  Eq. 3 against Philox4x32-10 words drawn here (one call per
//                4 weights, 10 rounds of about 8 integer instructions): at
//                2048 x 2048 about as long as the bytes.
//
// Design (det, operand, threefry): a block of 8 warps owns a tile of one
// word row (32 weight rows) by 32 * V columns, V the columns of a 16-byte
// load (4 f32, 8 bf16). Warp j takes rows 4j..4j+3 and lane l columns
// V*l..V*l+V-1, so each thread issues its 4 rows' loads (and the operand's
// words) at once, 16 bytes each where the row is aligned, and the operand
// mode's two streams load together. At f32, det reaches ~73% of the bytes'
// bound at 2048 x 2048 with no dirty line in L2 (the rest is a launch's
// ramp; 54% when it must first write back dirty lines); at bf16, V = 8 holds
// 55 registers, so an SM holds 4 blocks and large leaves run below a
// one-thread-a-word design (PERF.md). A thread ORs its rows' bits into V
// partial words; the 8 warps' partials meet in shared memory and 32 * V
// threads OR and store them (coalesced). A row that is not 16-byte aligned, or a vector
// that crosses N, takes masked element loads. The grid is (column tiles,
// word rows), and blocks walk the word rows with a stride of grid.y, so any
// number of word rows fits; a leaf whose 16-byte tiles would not give every
// SM a block takes tiles of one column a thread instead (V = 1), which gives
// V times the tiles: at the classifiers' small leaves that is 1-18% less
// device time in det and 11-44% in threefry than V = 16 bytes (PERF.md).
// Rows >= K give bit 0, the same as padding with -1.
// The threefry mode gives each thread 4V independent chains of rounds to
// interleave; its rotates are single funnel shifts.
//
// Design (on-chip mode): one Philox call a thread. With one thread a word,
// each thread ran 8 calls in series (80 dependent rounds) on a grid of a
// single wave, and the rounds did not hide under the loads (0.0176 ms at
// 2048 x 2048 against det's 0.0100; this design 0.0107, PERF.md). Here a
// block is 8 warps x 32 neighbouring columns of one word row: warp j issues
// the 4 loads of rows 4j..4j+3 (128-byte coalesced), draws their Philox
// block meanwhile, sets bits 4j..4j+3, and the 8 partial words are ORed
// through shared memory; warp 0 stores. That is 8x the warps, each with a
// short dependent chain, so the scheduler overlaps one warp's rounds with
// other warps' loads.
//
// The stochastic threshold uses round-to-nearest intrinsics for every step
// so that no contraction or fast-math rewrite can move a bit away from the
// reference:
//   p = clip((w + 1) * 0.5, 0, 1),  bit = (float(u) < p * 2^32) | (p >= 1).
// p >= 1 is forced to 1: words >= 2^32 - 128 round up to 2^32 in f32 and
// would tie with the threshold.
//
// On-chip words: the TPU's hardware bits cannot be reproduced, so the kernel
// draws from a stateless counter-based Philox4x32-10 written here (no
// cuRAND). Word u[k, n] is lane k & 3 of philox((k >> 2, n, 0, 0),
// (seed, 0)): it depends on (seed, k, n) only, never on the launch shape,
// and the plain version (kernels/stoch_binarize.py: onchip_words) computes
// the same words on any device.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 32 / kWarps;    // a word's 32 rows over the 8 warps
enum Mode : int { kDet = 0, kOperand = 1, kOnChip = 2, kThreefry = 3 };

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// One round of threefry2x32: add, rotate left by r, xor.
__device__ __forceinline__ void threefry_round(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r);
  x1 ^= x0;
}

// x0 ^ x1 of threefry2x32 with 20 rounds of the counter (i >> 32, i mod 2^32)
// under the key schedule ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA): jax.random.bits'
// word at row-major index i (core/prng.py: threefry2x32, bits).
__device__ __forceinline__ uint32_t threefry_bits(uint3 ks, uint64_t i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + ks.x;
  uint32_t x1 = static_cast<uint32_t>(i) + ks.y;
  threefry_round(x0, x1, 13); threefry_round(x0, x1, 15);
  threefry_round(x0, x1, 26); threefry_round(x0, x1, 6);
  x0 += ks.y; x1 += ks.z + 1u;
  threefry_round(x0, x1, 17); threefry_round(x0, x1, 29);
  threefry_round(x0, x1, 16); threefry_round(x0, x1, 24);
  x0 += ks.z; x1 += ks.x + 2u;
  threefry_round(x0, x1, 13); threefry_round(x0, x1, 15);
  threefry_round(x0, x1, 26); threefry_round(x0, x1, 6);
  x0 += ks.x; x1 += ks.y + 3u;
  threefry_round(x0, x1, 17); threefry_round(x0, x1, 29);
  threefry_round(x0, x1, 16); threefry_round(x0, x1, 24);
  x0 += ks.y; x1 += ks.z + 4u;
  threefry_round(x0, x1, 13); threefry_round(x0, x1, 15);
  threefry_round(x0, x1, 26); threefry_round(x0, x1, 6);
  x0 += ks.z; x1 += ks.x + 5u;
  return x0 ^ x1;
}

// Eq. 2-3 against one uniform uint32 word.
__device__ __forceinline__ uint32_t stoch_bit(float v, uint32_t word) {
  const float p = fminf(fmaxf(__fmul_rn(__fadd_rn(v, 1.0f), 0.5f), 0.0f), 1.0f);
  const float thresh = __fmul_rn(p, 4294967296.0f);
  const float u = __uint2float_rn(word);
  return static_cast<uint32_t>((u < thresh) || (p >= 1.0f));
}

// V neighbouring elements of a row, loaded as one 16-byte vector (V = 4 f32
// or uint32, 8 bf16; two vectors for 8 uint32) when aligned.
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Lanes {
  T e[V];
};

// Lanes at p, of which `left` (>= 1) lie before the end of the row: vector
// loads where p is 16-byte aligned and all V lie in the row, else element
// loads of those that do (the rest left zero). Within a warp the choice is
// the same for every lane but the one at the ragged edge.
template <typename T, int V>
__device__ __forceinline__ Lanes<T, V> load_lanes(const T* __restrict__ p, int64_t left) {
  using L = Lanes<T, V>;
  if (left >= V && reinterpret_cast<uintptr_t>(p) % alignof(L) == 0) {
    if constexpr (sizeof(L) % 16 == 0) {
      L x;
      const uint4* src = reinterpret_cast<const uint4*>(p);
      uint4* dst = reinterpret_cast<uint4*>(x.e);
#pragma unroll
      for (int q = 0; q < static_cast<int>(sizeof(L) / 16); ++q) dst[q] = __ldg(src + q);
      return x;
    } else {
      return *reinterpret_cast<const L*>(p);
    }
  }
  L x = {};
#pragma unroll
  for (int c = 0; c < V; ++c)
    if (c < left) x.e[c] = p[c];
  return x;
}

// Per-launch arguments of the tiled modes.
struct Tiles {
  int64_t K, N;
  uint3 ks;              // threefry key schedule
  int64_t draw_cols;     // columns of the shape the threefry words are drawn over
};

// Det, operand and threefry modes: block (x, y) takes the tile of column
// tile x and word rows y, y + gridDim.y, ... (a grid stride, so any number
// of word rows fits grid.y's 65,535; see the head of the file).
template <typename T, int kMode, int V>
__global__ void __launch_bounds__(kThreads)
binarize_pack_kernel(const T* __restrict__ w, const uint32_t* __restrict__ bits,
                     int32_t* __restrict__ out, Tiles a) {
  __shared__ Lanes<uint32_t, V> part[kWarps][32];   // [warp][lane] partial words
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * (32 * V);
  const int64_t col = col0 + lane * V;
  const int64_t n_k32 = (a.K + 31) / 32;
  for (int64_t k32 = blockIdx.y; k32 < n_k32; k32 += gridDim.y) {
    const int64_t row0 = k32 * 32 + warp * kRowsPerWarp;
    Lanes<uint32_t, V> acc = {};
    if (col < a.N) {
      Lanes<T, V> wv[kRowsPerWarp];
      Lanes<uint32_t, V> uv[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (row0 + r < a.K) {
          wv[r] = load_lanes<T, V>(w + (row0 + r) * a.N + col, a.N - col);
          if (kMode == kOperand)
            uv[r] = load_lanes<uint32_t, V>(bits + (row0 + r) * a.N + col, a.N - col);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (row0 + r >= a.K) break;
        const int shift = warp * kRowsPerWarp + r;
        const uint64_t i0 = static_cast<uint64_t>(row0 + r) * a.draw_cols + col;
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const float v = bnn_to_float(wv[r].e[c]);
          uint32_t one;
          if (kMode == kDet) {
            one = static_cast<uint32_t>(bnn_sign(v));
          } else if (kMode == kOperand) {
            one = stoch_bit(v, uv[r].e[c]);
          } else {
            one = stoch_bit(v, threefry_bits(a.ks, i0 + c));
          }
          acc.e[c] |= one << shift;
        }
      }
    }
    part[warp][lane] = acc;
    __syncthreads();
    if (threadIdx.x < 32 * V) {
      const int64_t n = col0 + threadIdx.x;
      if (n < a.N) {
        const uint32_t* flat = &part[0][0].e[0];
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < kWarps; ++j) word |= flat[j * 32 * V + threadIdx.x];
        out[k32 * a.N + n] = static_cast<int32_t>(word);
      }
    }
    __syncthreads();
  }
}

// On-chip mode: grid (ceil(N / 32), min(ceil(K / 32), 65535)); a block
// walks word rows k32 with a grid stride.
template <typename T>
__global__ void __launch_bounds__(kThreads)
binarize_pack_onchip_kernel(const T* __restrict__ w, int32_t* __restrict__ out,
                            int64_t K, int64_t N, uint32_t seed) {
  __shared__ uint32_t part[kThreads];        // [warp][lane] partial words
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  const int64_t n_k32 = (K + 31) / 32;
  const uint2 key = make_uint2(seed, 0u);
  for (int64_t k32 = blockIdx.y; k32 < n_k32; k32 += gridDim.y) {
    const int64_t row0 = k32 * 32 + 4 * warp;
    uint32_t bits = 0;
    if (n < N && row0 < K) {
      float v[4];
#pragma unroll
      for (int l = 0; l < 4; ++l)
        v[l] = row0 + l < K ? bnn_to_float(w[(row0 + l) * N + n]) : 0.0f;
      const uint4 r = philox4x32_10(
          make_uint4(static_cast<uint32_t>(k32 * 8 + warp), static_cast<uint32_t>(n), 0u, 0u),
          key);
      const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (row0 + l < K) bits |= stoch_bit(v[l], u[l]) << l;
    }
    part[threadIdx.x] = bits << (4 * warp);
    __syncthreads();
    if (warp == 0 && n < N) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < kThreads / 32; ++j) word |= part[j * 32 + lane];
      out[k32 * N + n] = static_cast<int32_t>(word);
    }
    __syncthreads();
  }
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

// Launches the tiled kernel at V columns a thread: grid (column tiles,
// min(word rows, 65535)).
template <typename T, int kMode, int V>
void launch_tiles(const T* w, const uint32_t* bits, int32_t* out, Tiles a,
                  cudaStream_t stream) {
  const int64_t n_k32 = (a.K + 31) / 32;
  const dim3 grid(static_cast<unsigned>((a.N + 32 * V - 1) / (32 * V)),
                  static_cast<unsigned>(n_k32 < 65535 ? n_k32 : 65535));
  binarize_pack_kernel<T, kMode, V><<<grid, kThreads, 0, stream>>>(w, bits, out, a);
}

// 16-byte tiles, unless they would leave an SM without a block.
template <typename T, int kMode>
void launch_mode(const T* w, const uint32_t* bits, int32_t* out, Tiles a,
                 cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t vec_tiles = ((a.K + 31) / 32) * ((a.N + 32 * kVec - 1) / (32 * kVec));
  if (vec_tiles >= sm_count()) {
    launch_tiles<T, kMode, kVec>(w, bits, out, a, stream);
  } else {
    launch_tiles<T, kMode, 1>(w, bits, out, a, stream);
  }
}

template <typename T>
void launch(const void* w, const void* bits, void* out, int64_t K, int64_t N, int mode,
            uint32_t seed, uint32_t k0, uint32_t k1, int64_t draw_cols, cudaStream_t stream) {
  const T* wp = static_cast<const T*>(w);
  const uint32_t* bp = static_cast<const uint32_t*>(bits);
  int32_t* op = static_cast<int32_t*>(out);
  Tiles a = {K, N, make_uint3(k0, k1, k0 ^ k1 ^ 0x1BD11BDAu), draw_cols};
  if (mode == kOnChip) {
    const int64_t n_k32 = (K + 31) / 32;
    const dim3 grid(static_cast<unsigned>((N + 31) / 32),
                    static_cast<unsigned>(n_k32 < 65535 ? n_k32 : 65535));
    binarize_pack_onchip_kernel<T><<<grid, kThreads, 0, stream>>>(wp, op, K, N, seed);
  } else if (mode == kThreefry) {
    launch_mode<T, kThreefry>(wp, bp, op, a, stream);
  } else if (mode == kOperand) {
    launch_mode<T, kOperand>(wp, bp, op, a, stream);
  } else {
    launch_mode<T, kDet>(wp, bp, op, a, stream);
  }
}

}  // namespace

// w: (K, N) f32 or bf16 (dtype: BnnDtype); bits: (K, N) uint32 words, read
// only in mode 1 (operand); out: (ceil(K/32), N) int32. All row-major and
// contiguous. mode: 0 det, 1 operand words, 2 on-chip Philox words under
// seed, 3 the threefry words of key (k0, k1) drawn over draw_cols (>= N)
// columns. K >= 1, N >= 1; the on-chip counter takes K < 2^34 and N < 2^32.
extern "C" int bnn_binarize_pack(const void* w, const void* bits, void* out,
                                 int64_t K, int64_t N, int dtype, int mode,
                                 uint32_t seed, uint32_t k0, uint32_t k1,
                                 int64_t draw_cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BNN_BF16) {
    launch<__nv_bfloat16>(w, bits, out, K, N, mode, seed, k0, k1, draw_cols, s);
  } else {
    launch<float>(w, bits, out, K, N, mode, seed, k0, k1, draw_cols, s);
  }
  return static_cast<int>(cudaGetLastError());
}
