// K3: fused sign-binarize + bitpack of activations along the last axis,
// (M, K) f32 or bf16 -> (M, ceil(K/32)) int32; bit b of word [m, j] is
// bnn_sign(y[m, 32*j + b]) (Eq. 1: y >= 2^-126; subnormals, +-0 and NaN give
// bit 0), where y is x, or,
// with the producer prologue, the eval-mode batch norm of x plus a bias:
//
//   y = (((x + bias[n]) - mean[n]) * rsqrt(var[n] + eps)) * scale[n] + shift[n]
//
// with every input and every intermediate result flushed as the reference's
// XLA CPU flushes them (bnn_ftz).
//
// Replaces the TPU kernel sign_pack_pallas (src/repro/xnor/kernel.py:
// _sign_pack_kernel), and with the prologue also the chain before it
// (src/repro/models/mnist_fc.py: apply_linear's bias add, batch_norm and
// binarize(h, "det")), which the reference runs as separate XLA ops.
//
// bn_sign_kernel is the same prologue and sign without the pack: (M, K) f32
// in, (M, K) f32 +-1 out, for the sign sites whose consumer reads floats
// (a dense layer, or K5 in front of an xnor conv). It takes the place of the
// eager ops of the chain at those sites.
//
// Bound on this card: device-memory bytes. Each activation is read once
// (with the prologue also five f32 vectors of K) and one int32 is written
// per 32 of them (bn_sign: one f32 per activation); the compare is free
// beside the load. At the serving shapes (4 x 2048 f32) that is 33 KB (75
// KB with the prologue), so in practice a launch is bound by its latency.
// The prologue removes the elementwise launches the unfused chain takes
// before it (11 a site on the H100, PERF.md).
//
// Design: one warp per output word. Lane l reads x[m, 32*j + l] (a 128-byte
// coalesced load for f32), and with the prologue the five vectors at the
// same column (128-byte loads each, cached across the M rows);
// __ballot_sync of bnn_sign(y) is the word itself: lane b sets bit b, which is
// the xnor/packing.py layout. Lanes past K vote 0, the same as padding with
// zeros, so no caller pads. A bf16 value converts to f32 exactly, so
// comparing the converted value is comparing in bf16. Warps walk the words
// with a grid stride, so any M fits the grid. bn_sign_kernel: one thread per
// activation, grid stride, the column from a 32-bit index where M * K fits.
//
// The prologue must give the reference's bits, so every step is one
// correctly rounded f32 operation in the chain's order, flushed after:
// __fadd_rn / __fsub_rn / __fmul_rn keep nvcc from contracting a multiply
// and an add into one FMA, and rsqrtf is held equal to torch.rsqrt over
// every positive normal f32 (xnor/cases.py: rsqrt_sweep; a subnormal
// var + eps is flushed before it). The prologue takes f32 activations only:
// in bf16 the chain rounds twice more, and the wrappers refuse bf16.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Per-column vectors of the prologue, each (K,) f32.
struct Prologue {
  const float* bias;
  const float* scale;
  const float* shift;
  const float* mean;
  const float* var;
  float eps;
};

// The chain's steps in its order, each input and each result flushed.
__device__ __forceinline__ float bn_eval(float v, const Prologue& p, int64_t n) {
  const float inv_std = rsqrtf(bnn_ftz(__fadd_rn(bnn_ftz(p.var[n]), p.eps)));
  const float t = bnn_ftz(__fadd_rn(bnn_ftz(v), bnn_ftz(p.bias[n])));
  const float c = bnn_ftz(__fsub_rn(t, bnn_ftz(p.mean[n])));
  const float y = bnn_ftz(__fmul_rn(c, inv_std));
  const float z = bnn_ftz(__fmul_rn(y, bnn_ftz(p.scale[n])));
  return bnn_ftz(__fadd_rn(z, bnn_ftz(p.shift[n])));
}

template <typename T, bool kBN>
__global__ void __launch_bounds__(kThreads)
sign_pack_kernel(const T* __restrict__ x, const Prologue bn, int32_t* __restrict__ out,
                 int64_t M, int64_t K, int64_t k32) {
  const int lane = threadIdx.x & 31;
  const int64_t n_words = M * k32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t word = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
       word < n_words; word += stride) {
    const int64_t m = word / k32;
    const int64_t col = (word - m * k32) * 32 + lane;
    bool one = false;
    if (col < K) {
      float v = bnn_to_float(x[m * K + col]);
      if constexpr (kBN) v = bn_eval(v, bn, col);
      one = bnn_sign(v);
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, one);
    if (lane == 0) out[word] = static_cast<int32_t>(bits);
  }
}

template <typename T, bool kBN>
void launch(const void* x, const Prologue& bn, int32_t* out, int64_t M, int64_t K,
            cudaStream_t s) {
  const int64_t k32 = (K + 31) / 32;
  const int64_t blocks = (M * k32 + kWarps - 1) / kWarps;
  const unsigned grid = static_cast<unsigned>(blocks < 65535 ? blocks : 65535);
  sign_pack_kernel<T, kBN><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), bn, out,
                                                     M, K, k32);
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
bn_sign_kernel(const float* __restrict__ x, const Prologue bn, float* __restrict__ out,
               I total, I K) {
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; i < total; i += stride) {
    out[i] = bnn_sign(bn_eval(x[i], bn, static_cast<int64_t>(i % K))) ? 1.0f : -1.0f;
  }
}

}  // namespace

// x: (M, K) f32 or bf16 (dtype: BnnDtype), row-major and contiguous;
// out: (M, ceil(K/32)) int32. M >= 1, K >= 1. bias, scale, shift, mean and
// var: all null (plain K3), or all (K,) f32 (the prologue, f32 x only).
extern "C" int bnn_sign_pack(const void* x, const void* bias, const void* scale,
                             const void* shift, const void* mean, const void* var,
                             float eps, void* out, int64_t M, int64_t K, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* op = static_cast<int32_t*>(out);
  const Prologue bn{static_cast<const float*>(bias), static_cast<const float*>(scale),
                    static_cast<const float*>(shift), static_cast<const float*>(mean),
                    static_cast<const float*>(var), eps};
  if (bias != nullptr) {
    if (dtype != BNN_F32 || !scale || !shift || !mean || !var) return cudaErrorInvalidValue;
    launch<float, true>(x, bn, op, M, K, s);
  } else if (dtype == BNN_BF16) {
    launch<__nv_bfloat16, false>(x, bn, op, M, K, s);
  } else {
    launch<float, false>(x, bn, op, M, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x and out: (M, K) f32, row-major and contiguous; out[m, n] = +1 if
// bnn_sign(y[m, n]) else -1, y the flushed prologue above. M >= 1, K >= 1;
// bias, scale, shift, mean and var: (K,) f32, none null.
extern "C" int bnn_bn_sign(const void* x, const void* bias, const void* scale,
                           const void* shift, const void* mean, const void* var, float eps,
                           void* out, int64_t M, int64_t K, void* stream) {
  if (!bias || !scale || !shift || !mean || !var) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Prologue bn{static_cast<const float*>(bias), static_cast<const float*>(scale),
                    static_cast<const float*>(shift), static_cast<const float*>(mean),
                    static_cast<const float*>(var), eps};
  const int64_t total = M * K;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < (1 << 20) ? blocks : (1 << 20));
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  if (total < (int64_t{1} << 32) - int64_t{grid} * kThreads) {
    bn_sign_kernel<uint32_t><<<grid, kThreads, 0, s>>>(xp, bn, op, static_cast<uint32_t>(total),
                                                       static_cast<uint32_t>(K));
  } else {
    bn_sign_kernel<int64_t><<<grid, kThreads, 0, s>>>(xp, bn, op, total, K);
  }
  return static_cast<int>(cudaGetLastError());
}
