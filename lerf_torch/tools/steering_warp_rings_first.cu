// K5's rings instance as it was first built, kept as the yardstick
// of the rings instance in lerf_torch/csrc/steering_warp.cu for
// chip_smoke.py (phase 51) and lerf_torch/tools/probe_lut_kernels.py
// (--rings, and --k5 with this file), which build it on its own and time it
// beside the kernel as built.  It is not part of the kernel library;
// nothing on a serving path launches it.  Its C entry has the library's
// name and arguments, lerf_steering_warp_rings, so a caller binds either
// the same way (each library is loaded on its own).
//
// The function: the rings warp, lerf_tpu/ops/resample.py::
// steering_gaussian_warp_rings / amplified_linear_warp_rings, every input
// pair and both output types, support 2.
//
// Design: the matrix instances' block, written out again.  A block owns a
// 16 x 32 output tile (256 threads, two rows a thread).  Step 1 loads each
// output's corner, its two float2 distances and then, dependent on the
// corner, its ring rows and columns (load_window); step 2 reduces the
// footprint by shared atomics between two barriers; step 3 loads the
// source box and decodes it into shared memory where it fits
// (kTileEntries); step 4 sums.  Three global round trips one after the
// other in every block, at four blocks an SM (kMinBlocks): 0.1177 ms at
// 360x640 -> 1440x2560 on an H100 80GB HBM3 at 700 W, 24 % of its bound.
// The device functions below are the library's as they were then,
// verbatim.
#include <cfloat>
#include <climits>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

template <typename InT>
constexpr bool kIsBf16 = std::is_same<InT, bf16>::value;

// v rounded to bf16, as a float: one bf16 operation is float, then this
__device__ __forceinline__ float bfr(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kTileH = 16;                  // outputs a block: rows
constexpr int kTileW = 32;                  // and columns (one warp a row)
constexpr int kThreadRows = 8;              // 256 threads
constexpr int kRowsPerThread = kTileH / kThreadRows;
constexpr int kTileEntries = 2048;          // entries of footprint: 32 KB
constexpr int kMinBlocks = 4;               // blocks an SM (register cap)
constexpr double kEps = 1.1920928955078125e-07;   // float32 eps (_EPS)

// One homography's geometry, by value: the inverse matrix row-major, the
// unpadded input and the output sizes, the leading pads, the support; and
// the first output row a launch computes, row0: its OH rows are the whole
// output's rows [row0, row0 + OH), written as its rows 0 .. OH - 1.
struct Warp {
  double m[9];
  int H, W, OH, OW, pad_r, pad_c, S;
  int row0;
};

// The linear kernel's branch of a float64 distance, as _branch_masks:
// bit 0 for -1 <= d < 0, bit 1 for 0 <= d <= 1.
__device__ __forceinline__ unsigned branch(double d) {
  return (-1.0 <= d && d < 0.0) ? 1u : ((0.0 <= d && d <= 1.0) ? 2u : 0u);
}

// One output's window.  KS > 0: the support known at compile time, its
// S rows, columns and float32 distances in registers, and where kBits (the
// linear mode) the 2S branches two bits each in one word (rows from bit 0,
// columns from bit 2 KS): the Gaussian mode evaluates no branch.
template <int KS, bool kBits>
struct Window {
  int r[KS], q[KS];
  float dx[KS], dy[KS];
  unsigned bits;

  __device__ void set(double sy, double sx, const Warp& w) {
    bits = 0u;
    fill(sy, w.H, w.pad_r, r, dx, 0);
    fill(sx, w.W, w.pad_c, q, dy, 2 * KS);
  }
  // _warp_axis at S = KS straight into registers, each value computed
  // once (a constant S / 2, no Axis kept).
  __device__ void fill(double src, int n, int pad, int* f, float* d,
                       int shift) {
    const double g = fmin(fmax(src, 0.0), (double)n);
    const int left = (int)ceil(__dsub_rn(__dsub_rn(g, 0.5 * KS), kEps)) + pad;
    const double gp = __dadd_rn(g, (double)pad);
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      f[s] = min(max(left + s, 0), n - 1);
      const double d64 = __dsub_rn(gp, (double)f[s]);
      d[s] = __double2float_rn(d64);
      if constexpr (kBits) bits |= branch(d64) << (shift + 2 * s);
    }
  }
  __device__ int support() const { return KS; }
  __device__ int row(int s) const { return r[s]; }
  __device__ int col(int t) const { return q[t]; }
  __device__ float dxs(int s) const { return dx[s]; }
  __device__ float dyt(int t) const { return dy[t]; }
  __device__ unsigned bxs(int s) const { return (bits >> (2 * s)) & 3u; }
  __device__ unsigned byt(int t) const {
    return (bits >> (2 * (KS + t))) & 3u;
  }
};

// The tile entry: {feature, 2 rho, sx, sy} or, linear, {feature, alpha};
// float32, or for bf16 inputs bf16.
struct __align__(8) Bf4 {
  bf16 x, y, z, w;
};
struct __align__(4) Bf2 {
  bf16 x, y;
};
template <bool kLinear, typename InT>
using Entry = typename std::conditional<
    kIsBf16<InT>, typename std::conditional<kLinear, Bf2, Bf4>::type,
    typename std::conditional<kLinear, float2, float4>::type>::type;

// A stored hyper value in [0, 1]: an int32 code divided by norm, a float32
// map value as it is.
__device__ __forceinline__ float unit(int code, float norm) {
  return (float)code / norm;
}
__device__ __forceinline__ float unit(float h, float) { return h; }
__device__ __forceinline__ float unit(bf16 h, float) {
  return __bfloat162float(h);
}

// Source pixel (sr, sc) of channel c (negative: a pad row / column)
// decoded; HypT: the maps' type, bf16 maps decoded in bf16.
template <bool kLinear, typename InT, typename HypT>
__device__ __forceinline__ Entry<kLinear, InT> decode(
    const InT* img, const HypT* codes, int c, int sr, int sc, int H, int W,
    float norm, float max_sigma) {
  const size_t e = ((size_t)c * H + max(sr, 0)) * W + max(sc, 0);
  if constexpr (kIsBf16<HypT>) {              // the twin's bf16 decode
    const HypT* h = codes + e * (kLinear ? 1 : 3);
    const float rho = bfr(bfr(unit(__ldg(h), norm) * 2.0f) - 1.0f);
    const float ms = bfr(max_sigma);
    float sx = 0.0f, sy = 0.0f;
    if constexpr (!kLinear) {
      sx = bfr(unit(__ldg(h + 1), norm) * ms);
      sy = bfr(unit(__ldg(h + 2), norm) * ms);
    }
    if constexpr (!kIsBf16<InT>) {            // float32 feature: float32
      const float x = (sr >= 0 && sc >= 0) ? (float)__ldg(img + e) : 0.0f;
      if constexpr (kLinear)
        return make_float2(x, rho);
      else
        return make_float4(x, 2.0f * rho, sx, sy);
    } else {
      const bf16 n = (sr >= 0 && sc >= 0) ? __ldg(img + e)
                                          : __float2bfloat16_rn(0.0f);
      if constexpr (kLinear)
        return {n, __float2bfloat16_rn(rho)};
      else
        return {n, __float2bfloat16_rn(2.0f * rho), __float2bfloat16_rn(sx),
                __float2bfloat16_rn(sy)};
    }
  } else if constexpr (kLinear) {
    const float a = unit(__ldg(codes + e), norm) * 2.0f - 1.0f;
    const float v = (sr >= 0 && sc >= 0) ? (float)__ldg(img + e) : 0.0f;
    return make_float2(v, a);
  } else {
    const InT* code = codes + e * 3;
    const float rho = unit(__ldg(code), norm) * 2.0f - 1.0f;
    const float sx = unit(__ldg(code + 1), norm) * max_sigma;
    const float sy = unit(__ldg(code + 2), norm) * max_sigma;
    const float v = (sr >= 0 && sc >= 0) ? (float)__ldg(img + e) : 0.0f;
    return make_float4(v, 2.0f * rho, sx, sy);
  }
}

// decode, or with kEdges (the rings instance's windows) also the pad row /
// column past the far edge, sr / sc = H / W: feature 0 and the codes of the
// last row / column, as the +-1-padded planes hold them.
template <bool kLinear, typename InT, bool kEdges, typename HypT>
__device__ __forceinline__ Entry<kLinear, InT> fetch(
    const InT* img, const HypT* codes, int c, int sr, int sc, int H, int W,
    float norm, float max_sigma) {
  if constexpr (kEdges) {
    Entry<kLinear, InT> v = decode<kLinear, InT>(
        img, codes, c, min(sr, H - 1), min(sc, W - 1), H, W, norm, max_sigma);
    if (sr >= H || sc >= W) {
      if constexpr (kIsBf16<InT>)
        v.x = __float2bfloat16_rn(0.0f);
      else
        v.x = 0.0f;
    }
    return v;
  } else {
    return decode<kLinear, InT>(img, codes, c, sr, sc, H, W, norm,
                                max_sigma);
  }
}

// One branch of the amplified-linear kernel: a x + 1 (bit 0), 1 - a x (bit
// 1), else 0, as lerf_tpu's (a x + 1) neg + (1 - a x) pos gives it.
__device__ __forceinline__ float lin(float a, float x, unsigned mask) {
  const float ax = a * x;
  return (mask & 1u) ? ax + 1.0f : ((mask & 2u) ? 1.0f - ax : 0.0f);
}

// One neighbour's weight in the twin's float order: the Gaussian flushed
// below FLT_MIN, the linear kernel clipped at 0 on both axes.
__device__ __forceinline__ float weight(float4 p, float dx, float dy,
                                        unsigned, unsigned) {
  const float a = p.z * dx;
  const float b = p.w * dy;
  const float xn = a * a;
  const float yn = b * b;
  const float xy = a * p.w * dy;
  const float w = expf(-0.5f * (xn - p.y * xy + yn));
  return w < FLT_MIN ? 0.0f : w;
}

__device__ __forceinline__ float weight(float2 p, float dx, float dy,
                                        unsigned bx, unsigned by) {
  return fmaxf(lin(p.y, dx, bx), 0.0f) * fmaxf(lin(p.y, dy, by), 0.0f);
}

// The bf16 instance's Gaussian weights of the thread's two rows (the lanes
// of each pair), entries p0 and p1, distances dx = (dx_0, dx_1) and dy:
// the twin's bf16 steps in its order, each a native bf16 pair operation
// (one rounding to nearest even, as the twin's float operation then
// rounding gives it: lerf_torch/tools/bf16_steps_exhaustive.cu), expf in
// float32 and one rounding, flushed below FLT_MIN.  The flush is on the
// float32 exp, before its rounding: the bf16 value is below FLT_MIN exactly
// where the float32 one is below kKeep = 2^-126 - 2^-134, the midpoint
// that rounds (to even) up to FLT_MIN.  n: the features (n_0, n_1).
constexpr float kKeep = 0x1.fep-127f;

__device__ __forceinline__ bf162 weight_pair(Bf4 p0, Bf4 p1, bf162 dx,
                                             bf162 dy, bf162& n) {
  const bf162 lo0 = __halves2bfloat162(p0.x, p0.y);
  const bf162 hi0 = __halves2bfloat162(p0.z, p0.w);
  const bf162 lo1 = __halves2bfloat162(p1.x, p1.y);
  const bf162 hi1 = __halves2bfloat162(p1.z, p1.w);
  n = __lows2bfloat162(lo0, lo1);
  const bf162 two_rho = __highs2bfloat162(lo0, lo1);
  const bf162 sx = __lows2bfloat162(hi0, hi1);
  const bf162 sy = __highs2bfloat162(hi0, hi1);
  const bf162 a = __hmul2_rn(sx, dx);
  const bf162 b = __hmul2_rn(sy, dy);
  const bf162 xn = __hmul2_rn(a, a);
  const bf162 yn = __hmul2_rn(b, b);
  const bf162 xy = __hmul2_rn(__hmul2_rn(a, sy), dy);
  const bf162 e = __hmul2_rn(
      __float2bfloat162_rn(-0.5f),
      __hadd2_rn(__hsub2_rn(xn, __hmul2_rn(two_rho, xy)), yn));
  const float w0 = expf(__low2float(e)), w1 = expf(__high2float(e));
  return __floats2bfloat162_rn(w0 < kKeep ? 0.0f : w0,
                               w1 < kKeep ? 0.0f : w1);
}

// The bf16 linear weight of one output: (a dx, a dy) one pair product,
// each branch's value a x + 1 (bit 0) and 1 - a x (bit 1) one pair add,
// picked per axis on its branch bits; the clip and the product float32
// (lerf_tpu's float32 branch masks promote the weight).  dxy: the
// output's (dx, dy), bf16.
__device__ __forceinline__ float weight_bf16(Bf2 p, bf162 dxy, unsigned bx,
                                             unsigned by) {
  const bf162 one = __float2bfloat162_rn(1.0f);
  const bf162 ax = __hmul2_rn(__bfloat162bfloat162(p.y), dxy);
  const bf162 neg = __hadd2_rn(ax, one);
  const bf162 pos = __hsub2_rn(one, ax);
  const float lx = (bx & 1u) ? __low2float(neg)
                             : ((bx & 2u) ? __low2float(pos) : 0.0f);
  const float ly = (by & 1u) ? __high2float(neg)
                             : ((by & 2u) ? __high2float(pos) : 0.0f);
  return fmaxf(lx, 0.0f) * fmaxf(ly, 0.0f);
}

// The quotient the epilogue finishes: the bf16 Gaussian's rounded to bf16
// (its float32 sums at supports other than 2 rounded first).
template <bool kLinear, typename InT>
__device__ __forceinline__ float quotient(float wn, float ws, int S) {
  if constexpr (kIsBf16<InT> && !kLinear)
    return S == 2 ? bfr(wn / ws) : bfr(bfr(wn) / bfr(ws));
  return wn / ws;
}

__device__ __forceinline__ float finish(float v, float, float*) { return v; }

// nan_to_num(nan=0), then clip(rint(.), 0, norm): +inf clips to norm
__device__ __forceinline__ unsigned char finish(float v, float norm,
                                                unsigned char*) {
  if (isnan(v)) v = 0.0f;
  return (unsigned char)fminf(fmaxf(rintf(v), 0.0f), norm);
}

// The bf16 instance's sums and epilogue: rows 2q and 2q + 1 of the thread
// are the lanes of each pair (past the output's bottom edge the second
// lane repeats the first and is not written), their distances rounded to
// bf16 once (at a compile-time support; at any other, once where each is
// derived).  Gaussian: weight_pair; at support 2 (the twin's four-block
// path) each sum a rounded bf16 pair add; at any other (its torch.sum of
// bf16 products, accumulated in float32) each product a rounded pair
// product and the sums float32, per lane.  Linear: weight_bf16 an output
// at a time, float32 sums.
template <int KS, typename OutT, bool kLinear, bool kEdges = false>
__device__ __forceinline__ void sums_bf16(
    Window<KS, kLinear>* px, const bool* ok,
    const Entry<kLinear, bf16>* tile, bool shared, int r_lo, int c_lo,
    int nr, int nc, const bf16* __restrict__ img,
    const bf16* __restrict__ codes, OutT* __restrict__ out, const Warp& w,
    int C, float max_sigma, float norm) {
  static_assert(kRowsPerThread % 2 == 0, "pairs of a thread's rows");
  const int j = blockIdx.x * kTileW + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; q += 2) {
    if (!ok[q]) return;
    if (!ok[q + 1]) px[q + 1] = px[q];
    const Window<KS, kLinear>& p0 = px[q];
    const Window<KS, kLinear>& p1 = px[q + 1];
    const int S = p0.support();
    const int i = blockIdx.y * kTileH + threadIdx.y + q * kThreadRows;
    auto dxp = [&](int s) {
      return __floats2bfloat162_rn(p0.dxs(s), p1.dxs(s));
    };
    auto dyp = [&](int t) {
      return __floats2bfloat162_rn(p0.dyt(t), p1.dyt(t));
    };
    bf162 dx2[KS > 0 ? KS : 1], dy2[KS > 0 ? KS : 1];
    if constexpr (KS > 0) {
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        dx2[s] = dxp(s);
        dy2[s] = dyp(s);
      }
    }
    auto entry = [&](const Window<KS, kLinear>& p, int c, int s, int t) {
      return shared
                 ? tile[(c * nr + p.row(s) - r_lo) * nc + p.col(t) - c_lo]
                 : fetch<kLinear, bf16, kEdges>(
                       img, codes, c, p.row(s) - w.pad_r, p.col(t) - w.pad_c,
                       w.H, w.W, norm, max_sigma);
    };
    for (int c = 0; c < C; ++c) {
      float wn[2] = {0.0f, 0.0f}, ws[2] = {0.0f, 0.0f};
      bf162 wn2 = __float2bfloat162_rn(0.0f), ws2 = wn2;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        bf162 dx;
        if constexpr (KS > 0) dx = dx2[s]; else dx = dxp(s);
#pragma unroll
        for (int t = 0; t < S; ++t) {
          bf162 dy;
          if constexpr (KS > 0) dy = dy2[t]; else dy = dyp(t);
          const Entry<kLinear, bf16> v0 = entry(p0, c, s, t);
          const Entry<kLinear, bf16> v1 = entry(p1, c, s, t);
          if constexpr (kLinear) {
            const float w0 = weight_bf16(v0, __lows2bfloat162(dx, dy),
                                         p0.bxs(s), p0.byt(t));
            const float w1 = weight_bf16(v1, __highs2bfloat162(dx, dy),
                                         p1.bxs(s), p1.byt(t));
            wn[0] += w0 * __bfloat162float(v0.x);
            wn[1] += w1 * __bfloat162float(v1.x);
            ws[0] += w0;
            ws[1] += w1;
          } else {
            bf162 n;
            const bf162 wt = weight_pair(v0, v1, dx, dy, n);
            if (S == 2) {
              wn2 = __hadd2_rn(wn2, __hmul2_rn(wt, n));
              ws2 = __hadd2_rn(ws2, wt);
            } else {
              const bf162 wx = __hmul2_rn(wt, n);
              wn[0] += __low2float(wx);
              wn[1] += __high2float(wx);
              ws[0] += __low2float(wt);
              ws[1] += __high2float(wt);
            }
          }
        }
      }
      if (!kLinear && S == 2) {
        wn[0] = __low2float(wn2);
        wn[1] = __high2float(wn2);
        ws[0] = __low2float(ws2);
        ws[1] = __high2float(ws2);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (ok[q + k])
          out[((size_t)c * w.OH + i + k * kThreadRows) * w.OW + j] =
              finish(quotient<kLinear, bf16>(wn[k], ws[k], S), norm, out);
    }
  }
}

// The rings instance's geometry (lerf_torch/ops/resample.py::WarpRings on
// the card): output n's neighbour (s, t) is row ring_x[corner[n] / (W + 3) +
// s] and column ring_y[corner[n] % (W + 3) + t] of the +-1-padded planes
// (row r is source row r - 1, so 0 and H + 1 are the pad rows), its
// distances dis_x[n] = (dx_0, dx_1) and dis_y[n] (float32, cast once from
// the host's float64), and in the linear mode its branch bits[n], laid out
// as Window's (two bits a row from bit 0, a column from bit 4).  w: the
// sizes, both pads 1 (row r of the planes is padded row r), support 2.
struct Rings {
  Warp w;
  const int* ring_x;          // [H + 4]
  const int* ring_y;          // [W + 4]
  const int* corner;          // [OH * OW]
  const float2* dis_x;        // [OH * OW]
  const float2* dis_y;
  const unsigned char* bits;  // [OH * OW], linear only
};

// Step 1 of the rings instance for output n: its window read from memory
// where the matrix instances derive it.  A corner or ring value outside the
// planes clamps into them (the plain twin clamps the same); the rings the
// host or the card makes are inside.
template <bool kBits>
__device__ __forceinline__ void load_window(Window<2, kBits>& p,
                                            const Rings& g, size_t n) {
  const int stride = g.w.W + 3;
  const int c = min(max(__ldg(g.corner + n), 0), (g.w.H + 3) * stride - 1);
  const int cx = c / stride;
  const int cy = c - cx * stride;
  const float2 dx = __ldg(g.dis_x + n);
  const float2 dy = __ldg(g.dis_y + n);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    p.r[s] = min(max(__ldg(g.ring_x + cx + s), 0), g.w.H + 1);
    p.q[s] = min(max(__ldg(g.ring_y + cy + s), 0), g.w.W + 1);
  }
  p.dx[0] = dx.x;
  p.dx[1] = dx.y;
  p.dy[0] = dy.x;
  p.dy[1] = dy.y;
  p.bits = kBits ? (unsigned)__ldg(g.bits + n) : 0u;
}

// The rings instance's entry of source pixel (sr, sc) of the +-1-padded
// planes' row sr + 1, column sc + 1: fetch's, with the pad past the far
// edge; with kWide (a bf16 feature and bf16 maps under float32 rings) the
// bf16 entry widened to float32, exactly, since its feature and decoded
// values are bf16 numbers: the entry the float32-feature, bf16-map decode
// gives (lerf_tpu promotes bf16 maps against float32 distances).
template <bool kLinear, typename InT, bool kWide>
using RingEntry =
    Entry<kLinear, typename std::conditional<kWide, float, InT>::type>;

template <bool kLinear, typename InT, bool kWide, typename HypT>
__device__ __forceinline__ RingEntry<kLinear, InT, kWide> ring_entry(
    const InT* img, const HypT* codes, int c, int sr, int sc, int H, int W,
    float norm, float max_sigma) {
  const Entry<kLinear, InT> v = fetch<kLinear, InT, true>(
      img, codes, c, sr, sc, H, W, norm, max_sigma);
  if constexpr (!kWide) {
    return v;
  } else if constexpr (kLinear) {
    return make_float2(__bfloat162float(v.x), __bfloat162float(v.y));
  } else {
    return make_float4(__bfloat162float(v.x), __bfloat162float(v.y),
                       __bfloat162float(v.z), __bfloat162float(v.w));
  }
}

// K5's rings instance, first design: step 1 loads each output's window
// (load_window); steps 2-4 are the matrix instances' (warp_block's in the
// library), at support 2, on the windows as they come: the footprint
// reduced from the loaded rows and columns (in any order), the tile where
// it fits, the direct path where it does not, the same sums and epilogue.
// kWide: bf16 inputs under float32 rings, the float32 steps on widened
// entries (ring_entry).  out [C, OH, OW].
template <typename OutT, bool kLinear, typename InT, typename HypT = InT,
          bool kWide = false>
__global__ void __launch_bounds__(kTileW * kThreadRows, kMinBlocks)
    steering_warp_rings_kernel(const InT* __restrict__ img,
                               const HypT* __restrict__ codes,
                               OutT* __restrict__ out,
                               const __grid_constant__ Rings g, int C,
                               float max_sigma, float norm) {
  using CompT = typename std::conditional<kWide, float, InT>::type;
  __shared__ RingEntry<kLinear, InT, kWide> tile[kTileEntries];  // [C][r][c]
  __shared__ int box[4];                  // row min, max, column min, max
  const Warp& w = g.w;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int j = blockIdx.x * kTileW + threadIdx.x;

  // 1. this thread's windows, read from memory
  Window<2, kLinear> px[kRowsPerThread];
  bool ok[kRowsPerThread];
  int rmin = INT_MAX, rmax = INT_MIN, cmin = INT_MAX, cmax = INT_MIN;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = blockIdx.y * kTileH + threadIdx.y + k * kThreadRows;
    ok[k] = j < w.OW && i < w.OH;
    if (!ok[k]) continue;
    load_window(px[k], g, (size_t)i * w.OW + j);
    rmin = min(rmin, min(px[k].r[0], px[k].r[1]));
    rmax = max(rmax, max(px[k].r[0], px[k].r[1]));
    cmin = min(cmin, min(px[k].q[0], px[k].q[1]));
    cmax = max(cmax, max(px[k].q[0], px[k].q[1]));
  }

  // 2. the block's footprint in the planes' rows and columns
  if (tid == 0) {
    box[0] = box[2] = INT_MAX;
    box[1] = box[3] = INT_MIN;
  }
  __syncthreads();
  rmin = __reduce_min_sync(0xffffffffu, rmin);
  rmax = __reduce_max_sync(0xffffffffu, rmax);
  cmin = __reduce_min_sync(0xffffffffu, cmin);
  cmax = __reduce_max_sync(0xffffffffu, cmax);
  if ((tid & 31) == 0) {
    atomicMin(box, rmin);
    atomicMax(box + 1, rmax);
    atomicMin(box + 2, cmin);
    atomicMax(box + 3, cmax);
  }
  __syncthreads();
  const int r_lo = box[0], c_lo = box[2];
  const int nr = box[1] - r_lo + 1, nc = box[3] - c_lo + 1;
  const bool shared = (long long)C * nr * nc <= kTileEntries;  // block-uniform

  // 3. the footprint decoded once into shared memory, where it fits (row r
  // of the planes is source row r - 1)
  if (shared) {
    const int plane = nr * nc;
    for (int e = tid; e < plane * C; e += kTileW * kThreadRows) {
      const int c = e / plane;
      const int rc = e - c * plane;
      const int r = rc / nc;
      tile[e] = ring_entry<kLinear, InT, kWide>(
          img, codes, c, r_lo + r - 1, c_lo + (rc - r * nc) - 1, w.H, w.W,
          norm, max_sigma);
    }
    __syncthreads();
  }

  // 4. the weighted sums, s-major, t-minor, and the epilogue
  if constexpr (kIsBf16<CompT>) {
    sums_bf16<2, OutT, kLinear, true>(px, ok, tile, shared, r_lo, c_lo, nr,
                                      nc, img, codes, out, w, C, max_sigma,
                                      norm);
  } else {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      if (!ok[k]) continue;
      const Window<2, kLinear>& p = px[k];
      const int i = blockIdx.y * kTileH + threadIdx.y + k * kThreadRows;
      for (int c = 0; c < C; ++c) {
        float wn = 0.0f, ws = 0.0f;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const RingEntry<kLinear, InT, kWide> v =
                shared ? tile[(c * nr + p.r[s] - r_lo) * nc + p.q[t] - c_lo]
                       : ring_entry<kLinear, InT, kWide>(
                             img, codes, c, p.r[s] - 1, p.q[t] - 1, w.H, w.W,
                             norm, max_sigma);
            const float wt = weight(v, p.dx[s], p.dy[t], p.bxs(s), p.byt(t));
            wn += wt * v.x;
            ws += wt;
          }
        }
        out[((size_t)c * w.OH + i) * w.OW + j] =
            finish(quotient<kLinear, CompT>(wn, ws, 2), norm, out);
      }
    }
  }
}

int make_warp(const double* inv, int H, int W, int OH, int OW, int pad_r,
              int pad_c, int S, int row0, int rows, Warp* w) {
  if (H < 1 || W < 1 || pad_r < 0 || pad_c < 0 || S < 1 || row0 < 0 ||
      rows < 0 || (long long)row0 + rows > OH ||
      (rows + kTileH - 1) / kTileH > 65535)
    return (int)cudaErrorInvalidValue;
  memcpy(w->m, inv, sizeof(w->m));
  w->H = H;
  w->W = W;
  w->OH = rows;             // the window's: the geometry needs no OH
  w->OW = OW;
  w->pad_r = pad_r;
  w->pad_c = pad_c;
  w->S = S;
  w->row0 = row0;
  return 0;
}

dim3 grid_of(const Warp& w) {
  return dim3((w.OW + kTileW - 1) / kTileW, (w.OH + kTileH - 1) / kTileH);
}

template <typename OutT, bool kLinear, typename InT, typename HypT,
          bool kWide>
void launch_rings(const void* img, const void* codes, void* out,
                  const Rings& g, int C, float max_sigma, float norm,
                  cudaStream_t s) {
  steering_warp_rings_kernel<OutT, kLinear, InT, HypT, kWide>
      <<<grid_of(g.w), dim3(kTileW, kThreadRows), 0, s>>>(
          (const InT*)img, (const HypT*)codes, (OutT*)out, g, C, max_sigma,
          norm);
}

template <bool kLinear, typename InT, typename HypT = InT,
          bool kWide = false>
void rings_out(const void* img, const void* codes, void* out, const Rings& g,
               int C, float max_sigma, float norm, int out_u8,
               cudaStream_t s) {
  if (out_u8)
    launch_rings<unsigned char, kLinear, InT, HypT, kWide>(
        img, codes, out, g, C, max_sigma, norm, s);
  else
    launch_rings<float, kLinear, InT, HypT, kWide>(img, codes, out, g, C,
                                                   max_sigma, norm, s);
}

template <bool kLinear>
void rings_in(const void* img, const void* codes, void* out, const Rings& g,
              int C, float max_sigma, float norm, int out_u8, int in_type,
              cudaStream_t s) {
  if (in_type == 1)
    rings_out<kLinear, float>(img, codes, out, g, C, max_sigma, norm, out_u8,
                              s);
  else if (in_type == 2)
    rings_out<kLinear, bf16>(img, codes, out, g, C, max_sigma, norm, out_u8,
                             s);
  else if (in_type == 3)
    rings_out<kLinear, float, bf16>(img, codes, out, g, C, max_sigma, norm,
                                    out_u8, s);
  else if (in_type == 4)
    rings_out<kLinear, bf16, bf16, true>(img, codes, out, g, C, max_sigma,
                                         norm, out_u8, s);
  else
    rings_out<kLinear, int>(img, codes, out, g, C, max_sigma, norm, out_u8,
                            s);
}

}  // namespace

// K5's rings instance, first design (the library's entry of the same
// name, lerf_torch/ops/kernels/warp.py::steering_warp_rings, takes the same
// arguments): the warp of one frame through rings (struct Rings says how),
// all device pointers: ring_x [ring_x_len] and ring_y [ring_y_len] int32,
// which must be H + 4 and W + 4 long; corner [OH * OW] int32; dis_x, dis_y [OH * OW, 2]
// float32 (8-byte aligned); bits [OH * OW] uint8, given in the linear mode
// (linear 1) and null in the Gaussian one.  img, codes, out, the mode, the
// types and the epilogue as lerf_steering_warp_batch takes them, and
// in_type 4: a bf16 feature and bf16 maps under float32 rings (decoded in
// bf16, weighted, summed and divided in float32); support 2.
extern "C" int lerf_steering_warp_rings(
    const void* img, const void* codes, void* out, const void* ring_x,
    int ring_x_len, const void* ring_y, int ring_y_len, const void* corner,
    const void* dis_x, const void* dis_y, const void* bits, int C, int H,
    int W, int OH, int OW, int linear, float max_sigma, float norm,
    int out_u8, void* stream, int in_type) {
  if (H < 1 || W < 1 || C < 0 || OH < 0 || OW < 0 ||
      ring_x_len != H + 4 || ring_y_len != W + 4 || in_type < 0 ||
      in_type > 4 || (linear != 0) != (bits != nullptr) ||
      (long long)(H + 3) * (W + 3) > INT_MAX ||
      (OH + kTileH - 1) / kTileH > 65535)
    return (int)cudaErrorInvalidValue;
  if ((long long)C * OH * OW == 0) return 0;
  if (out_u8 && !(norm <= 255.0f)) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)dis_x % sizeof(float2) || (uintptr_t)dis_y % sizeof(float2))
    return (int)cudaErrorMisalignedAddress;
  Rings g;
  memset(&g, 0, sizeof(g));
  static const double kNoMatrix[9] = {};   // the rings instance reads none
  const int err = make_warp(kNoMatrix, H, W, OH, OW, 1, 1, 2, 0, OH, &g.w);
  if (err) return err;
  g.ring_x = (const int*)ring_x;
  g.ring_y = (const int*)ring_y;
  g.corner = (const int*)corner;
  g.dis_x = (const float2*)dis_x;
  g.dis_y = (const float2*)dis_y;
  g.bits = (const unsigned char*)bits;
  cudaStream_t s = (cudaStream_t)stream;
  if (linear)
    rings_in<true>(img, codes, out, g, C, max_sigma, norm, out_u8, in_type,
                   s);
  else
    rings_in<false>(img, codes, out, g, C, max_sigma, norm, out_u8, in_type,
                    s);
  return (int)cudaGetLastError();
}
