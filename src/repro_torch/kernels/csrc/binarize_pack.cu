// K1: fused binarize + bitpack of a (K, N) master weight into (ceil(K/32), N)
// int32 words; bit b of word [k32, n] is the sign of w[32*k32 + b, n].
//
// Replaces the TPU kernel binarize_pack_pallas
// (src/repro/kernels/stoch_binarize.py): _det_kernel, _stoch_kernel (the
// variant that takes its uniform words as an operand) and
// _stoch_kernel_tpu_prng (the variant that draws them on chip): the first
// two are template modes of one kernel, the third a kernel of its own.
//
// Bound on this card: device-memory bytes. Each weight is read once (plus one
// uint32 word for the operand rule) and one int32 is written per 32 weights.
// At 2048 x 2048 f32 that is 17.3 MB (det, on-chip) or 34.1 MB (operand).
// The on-chip rule adds one Philox call per 4 weights, 10 rounds of about 8
// 32-bit integer instructions each (four multiply halves, two three-way XORs,
// two key bumps): at 2048 x 2048 that integer work takes about as long as the
// bytes at the card's peak rates.
//
// Design (det and operand modes): one thread owns one output word and walks
// its 32 rows, so the 32 threads of a warp read 32 neighbouring columns of
// one row at each step (128-byte coalesced loads) and write 32 neighbouring
// words once. Words are ORed in registers; nothing is staged in shared
// memory because nothing is reused. Rows >= K give bit 0, the same as
// padding with -1.
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
enum Mode : int { kDet = 0, kOperand = 1, kOnChip = 2 };

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

// Eq. 2-3 against one uniform uint32 word.
__device__ __forceinline__ uint32_t stoch_bit(float v, uint32_t word) {
  const float p = fminf(fmaxf(__fmul_rn(__fadd_rn(v, 1.0f), 0.5f), 0.0f), 1.0f);
  const float thresh = __fmul_rn(p, 4294967296.0f);
  const float u = __uint2float_rn(word);
  return static_cast<uint32_t>((u < thresh) || (p >= 1.0f));
}

template <typename T, int kMode>
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
    const uint32_t one =
        kMode == kOperand ? stoch_bit(v, bits[off]) : static_cast<uint32_t>(bnn_sign(v));
    word |= one << b;
  }
  out[idx] = static_cast<int32_t>(word);
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

template <typename T>
void launch(const void* w, const void* bits, void* out, int64_t K, int64_t N,
            int mode, uint32_t seed, cudaStream_t stream) {
  const int64_t n_words = ((K + 31) / 32) * N;
  const unsigned blocks = static_cast<unsigned>((n_words + kThreads - 1) / kThreads);
  const T* wp = static_cast<const T*>(w);
  const uint32_t* bp = static_cast<const uint32_t*>(bits);
  int32_t* op = static_cast<int32_t*>(out);
  if (mode == kOnChip) {
    const int64_t n_k32 = (K + 31) / 32;
    const dim3 grid(static_cast<unsigned>((N + 31) / 32),
                    static_cast<unsigned>(n_k32 < 65535 ? n_k32 : 65535));
    binarize_pack_onchip_kernel<T><<<grid, kThreads, 0, stream>>>(wp, op, K, N, seed);
  } else if (mode == kOperand) {
    binarize_pack_kernel<T, kOperand><<<blocks, kThreads, 0, stream>>>(
        wp, bp, op, K, N, n_words);
  } else {
    binarize_pack_kernel<T, kDet><<<blocks, kThreads, 0, stream>>>(
        wp, bp, op, K, N, n_words);
  }
}

}  // namespace

// w: (K, N) f32 or bf16 (dtype: BnnDtype); bits: (K, N) uint32 words, read
// only in mode 1 (operand); out: (ceil(K/32), N) int32. All row-major and
// contiguous. mode: 0 det, 1 operand words, 2 on-chip Philox words under
// seed. K >= 1, N >= 1; the on-chip counter takes K < 2^34 and N < 2^32.
extern "C" int bnn_binarize_pack(const void* w, const void* bits, void* out,
                                 int64_t K, int64_t N, int dtype, int mode,
                                 uint32_t seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BNN_BF16) {
    launch<__nv_bfloat16>(w, bits, out, K, N, mode, seed, s);
  } else {
    launch<float>(w, bits, out, K, N, mode, seed, s);
  }
  return static_cast<int>(cudaGetLastError());
}
