// K5: fused im2col + sign-binarize + bitpack of a conv input,
// NHWC (B, H, W, C) f32 or bf16 -> (B, OH, OW, kh*kw*cw) int32 with
// cw = ceil(C/32), in the per-tap word layout of xnor/conv/packing.py: word
// t*cw + j of output pixel (oy, ox) holds the signs (x > 0) of channels
// 32*j .. 32*j + 31 of input pixel (oy*sh + dy - ph0, ox*sw + dx - pw0),
// t = dy*kw + dx. Taps that fall outside the image and channels >= C give
// bit 0, the zero padding of the reference.
//
// Replaces the TPU kernel patch_pack_pallas (src/repro/xnor/conv/kernel.py:
// _patch_pack_kernel).
//
// Bound on this card: device-memory bytes: the input is read once (each pixel
// feeds up to kh*kw patches, but the repeats hit L1/L2) and the packed patches
// are written once. At VGG-16's conv/2 (4 x 16 x 16 x 64 f32) that is 262 KB
// in and 74 KB out, so at the serving shapes a launch is bound by latency.
//
// Design: unlike the TPU kernel (one program per whole zero-padded image in
// VMEM), warps tile the output words. One warp per (b, oy, ox, tap, word):
// lane l reads channel 32*j + l of the tap's input pixel (128 coalesced bytes
// for f32) and __ballot_sync of (x > 0) is the word. The input is not padded:
// an out-of-range tap votes 0 in the kernel, which drops the reference's pad
// copy and its stride slack while giving the same words. Consecutive warps
// write consecutive words.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Geometry {
  int64_t B, H, W, C, OH, OW;
  int kh, kw, sh, sw, ph0, pw0;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
patch_pack_kernel(const T* __restrict__ x, int32_t* __restrict__ out, Geometry g) {
  const int lane = threadIdx.x & 31;
  const int64_t cw = (g.C + 31) / 32;
  const int64_t row_words = g.kh * g.kw * cw;     // words per output pixel
  const int64_t n_words = g.B * g.OH * g.OW * row_words;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t word = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
       word < n_words; word += stride) {
    const int64_t pix = word / row_words;       // (b, oy, ox) flattened
    const int64_t r = word - pix * row_words;
    const int64_t tap = r / cw;
    const int64_t c = (r - tap * cw) * 32 + lane;
    const int64_t ox = pix % g.OW;
    const int64_t oy = (pix / g.OW) % g.OH;
    const int64_t b = pix / (g.OW * g.OH);
    const int64_t iy = oy * g.sh + tap / g.kw - g.ph0;
    const int64_t ix = ox * g.sw + tap % g.kw - g.pw0;
    bool one = false;
    if (c < g.C && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
      one = bnn_to_float(x[((b * g.H + iy) * g.W + ix) * g.C + c]) > 0.0f;
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, one);
    if (lane == 0) out[word] = static_cast<int32_t>(bits);
  }
}

}  // namespace

// x: (B, H, W, C) f32 or bf16 (dtype: BnnDtype), NHWC, contiguous; out:
// (B, OH, OW, kh*kw*ceil(C/32)) int32. Output pixel (oy, ox), tap (dy, dx)
// reads input pixel (oy*sh + dy - ph0, ox*sw + dx - pw0). All sizes >= 1.
extern "C" int bnn_patch_pack(const void* x, void* out, int64_t B, int64_t H,
                              int64_t W, int64_t C, int64_t OH, int64_t OW, int kh,
                              int kw, int sh, int sw, int ph0, int pw0, int dtype,
                              void* stream) {
  const Geometry g{B, H, W, C, OH, OW, kh, kw, sh, sw, ph0, pw0};
  const int64_t n_words = B * OH * OW * kh * kw * ((C + 31) / 32);
  const int64_t blocks = (n_words + kWarps - 1) / kWarps;
  const unsigned grid = static_cast<unsigned>(blocks < 65535 ? blocks : 65535);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* op = static_cast<int32_t*>(out);
  if (dtype == BNN_BF16) {
    patch_pack_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), op, g);
  } else {
    patch_pack_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), op, g);
  }
  return static_cast<int>(cudaGetLastError());
}
