// K5: fused im2col + sign-binarize + bitpack of a conv input,
// NHWC (B, H, W, C) f32 or bf16 -> (B, OH, OW, kh*kw*cw) int32 with
// cw = ceil(C/32), in the per-tap word layout of xnor/conv/packing.py: word
// t*cw + j of output pixel (oy, ox) holds the Eq.-1 signs (bnn_sign) of channels
// 32*j .. 32*j + 31 of input pixel (oy*sh + dy - ph0, ox*sw + dx - pw0),
// t = dy*kw + dx. Taps that fall outside the image and channels >= C give
// bit 0, the zero padding of the reference; so do 0, -0.0, NaN and subnormals.
//
// Replaces the TPU kernel patch_pack_pallas (src/repro/xnor/conv/kernel.py:
// _patch_pack_kernel, pallas_call at :76), which packs each pixel's words
// once and then gathers them per tap.
//
// Bound on this card: device-memory bytes, the input read once and the
// packed patches written once (at VGG-16's conv/2, 4 x 16 x 16 x 64 f32, 262
// KB in and 74 KB out: 0.1 us at 3.35 TB/s). At the serving shapes a launch
// is bound by latency instead: the launch itself, one round trip to L2 for
// the input, and the instructions each warp issues on the way.
//
// What held back the kernel this one replaced: it gave one warp to each
// output word (131,328 warps for VGG-16's 11 conv inputs at batch 4), and
// each warp split a flat 64-bit word index into (b, oy, ox, tap, j) before
// its one 128-byte load and ballot. Its sm_90a SASS has 528 instructions, 292
// of them in the loop over words, with six 64-bit division sites, each a
// 32-bit path (I2F, MUFU.RCP, F2I) beside a CALL to the 64-bit routine. Every
// input sign was also recomputed for each of the kh*kw patches that read it.
//
// Design, stage then copy (the TPU kernel's order, in a layout for the SMs):
// a block owns one tile of one image: `rows` output rows x `cols` output
// columns x `words` channel words x a `taps_y` x `taps_x` window of the kernel
// (the plan, chosen on the host by xnor/conv/kernel.py::patch_pack_tiles so
// that staging a tile takes one pass of loads).
//  1. Stage: the block sign-packs every input word the tile reads into shared
//     memory, once: ((rows-1)*sh + taps_y) input rows x ((cols-1)*sw +
//     taps_x) input columns x `words` words. A word is 32 channels read by a
//     group of lanes, 16 bytes a lane (8 lanes for f32, 4 for bf16) where C
//     and the address allow aligned vector loads, else element by element;
//     the group ORs its bits together with shuffles (the 16-byte loads took
//     1.3-3.6% less time than element loads alone at VGG-16's six larger
//     conv inputs on the H100). A warp keeps kUnroll such loads in flight.
//     Pixels outside the image and words past the last channel are staged
//     as zero words, so the copy has no border branches.
//  2. Copy: the block's threads walk the tile's output words in the output's
//     own order (pixel, tap, word), consecutive threads on consecutive words;
//     each word is one shared-memory read and one store.
// Index arithmetic: the host computes every tile-wide quantity (the strides
// of the full tile, the steps of both walks, multiply-and-shift constants for
// the few divisions left), a thread walks its words by adds and carries, and
// everything is 32-bit unless the input or the output holds 2^31 elements or
// more (then an int64 instantiation). Tiles at the ragged ends of each axis
// keep the full tile's strides and skip what lies past the edge. The plan
// keeps a tile within 48 KB of shared memory, so no image size, channel
// count or kernel window is refused: wide rows, wide C and large kernels are
// tiled by columns, words and taps.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;   // staging loads a warp keeps in flight

// n / d for 0 <= n < 2^31 by one multiply and one shift (Granlund and
// Montgomery 1994, theorem 4.2 with N = 31): l = ceil(log2 d),
// m = floor(2^(31+l) / d) + 1 < 2^32.
struct Div {
  uint32_t m;
  int shift;
};

Div make_div(int64_t d) {
  int l = 0;
  while ((int64_t{1} << l) < d) ++l;
  return {static_cast<uint32_t>((uint64_t{1} << (31 + l)) / static_cast<uint64_t>(d) + 1),
          31 + l};
}

__device__ __forceinline__ int divide(int n, Div d) {
  return static_cast<int>((static_cast<uint64_t>(static_cast<uint32_t>(n)) * d.m) >> d.shift);
}

// Everything the kernel needs that does not depend on the thread: the
// geometry, the full tile (ragged tiles at the ends of each axis use the
// same strides and mask what lies past the edge) and the steps of the two
// walks, all computed on the host.
struct Geometry {
  int64_t B, H, W, C, OH, OW;
  int kh, kw, sh, sw, ph0, pw0, cw;
  int rows, cols, words, taps_y, taps_x;   // the tile (PatchTiles)
  int cols_in, S, R;                       // staged columns and words; words a pixel
  int64_t n_rows;                          // row bands
  int n_cols, n_words, n_taps_y, n_taps_x; // tiles along the other axes
  Div by_words, by_cols_in, by_taps_x, by_R, by_cols;
  Div by_n_words, by_n_taps_y, by_n_taps_x;
  int d_j, d_c, d_r;                       // staging walk: kWarps*V words a step
  int e_r, e_x, e_y;                       // copy walk: kThreads positions a step
};

int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// Eq.-1 bits (bnn_sign) of the 16 bytes a lane read: 4 f32 or 8 bf16 channels.
__device__ __forceinline__ uint32_t sign_bits(uint4 v, float) {
  return bnn_sign(__uint_as_float(v.x)) | bnn_sign(__uint_as_float(v.y)) << 1 |
         bnn_sign(__uint_as_float(v.z)) << 2 | bnn_sign(__uint_as_float(v.w)) << 3;
}
__device__ __forceinline__ uint32_t sign_bits(uint4 v, __nv_bfloat16) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bits |= static_cast<uint32_t>(bnn_sign(__uint_as_float(u[i] << 16))) << (2 * i);
    bits |= static_cast<uint32_t>(bnn_sign(__uint_as_float(u[i] & 0xffff0000u))) << (2 * i + 1);
  }
  return bits;
}

// The raw bits of channels c .. c+V-1 of the pixel at `px`, zero for
// channels >= C; kVec: one 16-byte load (C % V == 0, x 16-byte aligned).
template <typename T, bool kVec, typename I>
__device__ __forceinline__ uint4 load_channels(const T* __restrict__ px, I c, I C) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (kVec) return __ldg(reinterpret_cast<const uint4*>(px + c));
  using Raw = typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type;
  const Raw* p = reinterpret_cast<const Raw*>(px);
  uint32_t u[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (c + e < C) {
      const uint32_t r = __ldg(p + c + e);
      if constexpr (sizeof(T) == 4) u[e] = r;
      else u[e / 2] |= r << (16 * (e % 2));
    }
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// I: the index type, int32_t when the input and the output each hold fewer
// than 2^31 elements (every serving shape), else int64_t.
template <typename T, bool kVec, typename I>
__global__ void __launch_bounds__(kThreads)
patch_pack_kernel(const T* __restrict__ x, int32_t* __restrict__ out, const Geometry g) {
  using U = typename std::make_unsigned<I>::type;
  constexpr int V = 16 / sizeof(T);     // channels a lane reads
  constexpr int L = 32 / V;             // lanes that build one word
  extern __shared__ uint32_t stage[];   // staged word (rr * cols_in + cc) * words + jj
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = lane % L, sub = lane / L;
  const I H = g.H, W = g.W, C = g.C, OH = g.OH, OW = g.OW;
  const I row_words = static_cast<I>(g.kh) * g.kw * g.cw;
  const int64_t n_x = static_cast<int64_t>(g.n_cols) * g.n_words * g.n_taps_y * g.n_taps_x;
  // where this thread starts its two walks, the same in every tile
  const int s0 = warp * V + sub;
  const int p0 = divide(s0, g.by_words), c0 = divide(p0, g.by_cols_in);
  const int j_0 = s0 - p0 * g.words, cc_0 = p0 - c0 * g.cols_in, rr_0 = c0;
  const int q0 = divide(tid, g.by_R), y_1 = divide(q0, g.by_cols);
  const int r_1 = tid - q0 * g.R, x_1 = q0 - y_1 * g.cols;
  bool first = true;

  for (int64_t xi = blockIdx.x; xi < n_x; xi += gridDim.x) {
    // the tile's column, word and tap tiles
    int ct, jt, ty, tx;
    if constexpr (sizeof(I) == 4) {
      int q = static_cast<int>(xi), d = divide(q, g.by_n_taps_x);
      tx = q - d * g.n_taps_x;
      q = d;
      d = divide(q, g.by_n_taps_y);
      ty = q - d * g.n_taps_y;
      q = d;
      d = divide(q, g.by_n_words);
      jt = q - d * g.n_words;
      ct = d;
    } else {
      int64_t q = xi;
      tx = static_cast<int>(q % g.n_taps_x);
      q /= g.n_taps_x;
      ty = static_cast<int>(q % g.n_taps_y);
      q /= g.n_taps_y;
      jt = static_cast<int>(q % g.n_words);
      ct = static_cast<int>(q / g.n_words);
    }
    const I ox0 = static_cast<I>(ct) * g.cols;
    const int j0 = jt * g.words, dy0 = ty * g.taps_y, dx0 = tx * g.taps_x;
    const int ncol = OW - ox0 < g.cols ? static_cast<int>(OW - ox0) : g.cols;
    const int nj = min(g.words, g.cw - j0);
    const int nty = min(g.taps_y, g.kh - dy0), ntx = min(g.taps_x, g.kw - dx0);
    const I cbase = 32 * static_cast<I>(j0) + V * part;

    for (int64_t band = blockIdx.y; band < g.n_rows; band += gridDim.y) {
      const I oy0 = static_cast<I>(band) * g.rows;
      const int nrow = OH - oy0 < g.rows ? static_cast<int>(OH - oy0) : g.rows;
      const I iy0 = oy0 * g.sh - g.ph0 + dy0, ix0 = ox0 * g.sw - g.pw0 + dx0;
      for (int64_t bi = blockIdx.z; bi < g.B; bi += gridDim.z) {
        const I b = static_cast<I>(bi);
        const T* xb = x + b * H * W * C;
        if (!first) __syncthreads();            // the last tile's copy is done
        first = false;
        // 1. stage every input word the tile reads, once; a warp's V lane
        // groups take staged words s0, s0 + kWarps*V, ...
        int s = s0, jj = j_0, cc = cc_0, rr = rr_0;
        while (s - sub < g.S) {                 // warp-uniform
          uint4 raw[kUnroll];
          int at[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const I iy = iy0 + rr, ix = ix0 + cc, c = cbase + 32 * jj;
            const bool in = s < g.S && static_cast<U>(iy) < static_cast<U>(H) &&
                            static_cast<U>(ix) < static_cast<U>(W) && c < C;
            raw[u] = in ? load_channels<T, kVec>(xb + (iy * W + ix) * C, c, C)
                        : make_uint4(0, 0, 0, 0);
            at[u] = s;
            s += kWarps * V;
            jj += g.d_j;
            const int carry = jj >= g.words;
            jj -= carry ? g.words : 0;
            cc += g.d_c + carry;
            rr += g.d_r;
            if (cc >= g.cols_in) { cc -= g.cols_in; ++rr; }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            uint32_t w = sign_bits(raw[u], T()) << (V * part);
#pragma unroll
            for (int o = 1; o < L; o <<= 1) w |= __shfl_xor_sync(0xffffffffu, w, o);
            if (part == 0 && at[u] < g.S) stage[at[u]] = w;
          }
        }
        __syncthreads();
        // 2. copy: thread tid takes the tile's output positions tid,
        // tid + kThreads, ... in output order (pixel, tap, word); position r
        // of a pixel is tap (dyl, dxl) of the tile's window, word jw
        int32_t* ob = out + ((b * OH + oy0) * OW + ox0) * row_words + j0;
        int r = r_1, oxl = x_1, oyl = y_1;
        while (oyl < nrow) {
          const int t = divide(r, g.by_words), jw = r - t * g.words;
          const int dyl = divide(t, g.by_taps_x), dxl = t - dyl * g.taps_x;
          if (oxl < ncol && jw < nj && dyl < nty && dxl < ntx) {
            const int sy = oyl * g.sh + dyl, sx = oxl * g.sw + dxl;
            const I tap = static_cast<I>(dy0 + dyl) * g.kw + dx0 + dxl;
            ob[(oyl * OW + oxl) * row_words + tap * g.cw + jw] =
                static_cast<int32_t>(stage[(sy * g.cols_in + sx) * g.words + jw]);
          }
          r += g.e_r;
          const int carry = r >= g.R;
          r -= carry ? g.R : 0;
          oxl += g.e_x + carry;
          oyl += g.e_y;
          if (oxl >= g.cols) { oxl -= g.cols; ++oyl; }
        }
      }
    }
  }
}

template <typename T>
int launch(const T* x, int32_t* out, Geometry g, dim3 grid, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int ds = kWarps * V, d_p = ds / g.words;
  g.d_j = ds % g.words;
  g.d_c = d_p % g.cols_in;
  g.d_r = d_p / g.cols_in;
  const bool vec = g.C % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int64_t in_elems = g.B * g.H * g.W * g.C;
  const int64_t out_words = g.B * g.OH * g.OW * g.kh * g.kw * g.cw;
  const bool small = in_elems < (int64_t{1} << 31) && out_words < (int64_t{1} << 31);
  auto kernel = small ? (vec ? patch_pack_kernel<T, true, int32_t>
                             : patch_pack_kernel<T, false, int32_t>)
                      : (vec ? patch_pack_kernel<T, true, int64_t>
                             : patch_pack_kernel<T, false, int64_t>);
  kernel<<<grid, kThreads, 4 * g.S, s>>>(x, out, g);
  return static_cast<int>(cudaGetLastError());
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

// x: (B, H, W, C) f32 or bf16 (dtype: BnnDtype), NHWC, contiguous; out:
// (B, OH, OW, kh*kw*ceil(C/32)) int32. Output pixel (oy, ox), tap (dy, dx)
// reads input pixel (oy*sh + dy - ph0, ox*sw + dx - pw0). All sizes >= 1.
// The tile (rows, cols, words, taps_y, taps_x) comes from
// xnor/conv/kernel.py::patch_pack_tiles, which keeps its staged words within
// 48 KB of shared memory.
extern "C" int bnn_patch_pack(const void* x, void* out, int64_t B, int64_t H,
                              int64_t W, int64_t C, int64_t OH, int64_t OW, int kh,
                              int kw, int sh, int sw, int ph0, int pw0, int dtype,
                              int rows, int cols, int words, int taps_y, int taps_x,
                              void* stream) {
  Geometry g{B, H, W, C, OH, OW, kh, kw, sh, sw, ph0, pw0,
             static_cast<int>(cdiv(C, 32)), rows, cols, words, taps_y, taps_x};
  g.cols_in = (cols - 1) * sw + taps_x;
  g.S = ((rows - 1) * sh + taps_y) * g.cols_in * words;
  g.R = taps_y * taps_x * words;
  g.n_rows = cdiv(OH, rows);
  g.n_cols = static_cast<int>(cdiv(OW, cols));
  g.n_words = static_cast<int>(cdiv(g.cw, words));
  g.n_taps_y = static_cast<int>(cdiv(kh, taps_y));
  g.n_taps_x = static_cast<int>(cdiv(kw, taps_x));
  g.by_words = make_div(words);
  g.by_cols_in = make_div(g.cols_in);
  g.by_taps_x = make_div(taps_x);
  g.by_R = make_div(g.R);
  g.by_cols = make_div(cols);
  g.by_n_words = make_div(g.n_words);
  g.by_n_taps_y = make_div(g.n_taps_y);
  g.by_n_taps_x = make_div(g.n_taps_x);
  const int e_p = kThreads / g.R;
  g.e_r = kThreads % g.R;
  g.e_x = e_p % cols;
  g.e_y = e_p / cols;
  const int64_t n_x = static_cast<int64_t>(g.n_cols) * g.n_words * g.n_taps_y * g.n_taps_x;
  const dim3 grid(static_cast<unsigned>(min64(n_x, 0x7fffffff)),
                  static_cast<unsigned>(min64(g.n_rows, 65535)),
                  static_cast<unsigned>(min64(B, 65535)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* op = static_cast<int32_t*>(out);
  if (dtype == BNN_BF16)
    return launch(static_cast<const __nv_bfloat16*>(x), op, g, grid, s);
  return launch(static_cast<const float*>(x), op, g, grid, s);
}
