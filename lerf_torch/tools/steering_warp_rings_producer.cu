// K5's rings instance in the producer-warp design, kept so that its
// measurement can be made again: lerf_torch/tools/probe_lut_kernels.py
// --rings builds it on its own and times it beside the kernel as built
// (lerf_torch/csrc/steering_warp.cu) and its first design
// (steering_warp_rings_first.cu beside this file), in alternating rounds,
// each output held bit-equal to the kernel's.  It is not part of the kernel
// library; nothing on a serving path launches it.  Its C entry has the
// library's name and arguments, lerf_steering_warp_rings.
//
// The function: the rings warp, lerf_tpu/ops/resample.py::
// steering_gaussian_warp_rings / amplified_linear_warp_rings, every input
// pair and both output types, support 2.
//
// Design (the section "the rings instance" below): persistent blocks of 8
// consumer warps and one producer warp; the producer streams each tile's
// rings (three stages) and then its source box (two raw boxes) into shared
// memory, every copy completing on an mbarrier, while the consumers sum the
// tile before.  kBulk picks the copies: cp.async.bulk (one a span) or
// 16-byte cp.async by the producer's lanes.  On an H100 80GB HBM3 at 700 W,
// 360x640 -> 1440x2560, LUT codes, uint8 (CUDA-graph replays): 0.1433 ms
// with cp.async, 0.1642 with bulk copies, against the first design's
// 0.1187 in the same rounds (PERF.md section 6): the one producer warp's
// chain (wait for the rings, reduce the footprint, start the box's copies)
// is serial, and its pipeline alone, without the sums, took 0.076 ms.
// A span's 16-byte chunks may reach up to 15 bytes past either end of the
// array they copy from (read, never used): safe under PyTorch's caching
// allocator, which rounds blocks up, not for every buffer.
//
// The device functions before that section are the library's as they were
// when this design was measured (decode with kPlain, for the staged copy).
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

// A value of the inputs: through the read-only cache, or with kPlain a
// plain load (a staged copy in shared memory).
template <bool kPlain, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kPlain)
    return *p;
  else
    return __ldg(p);
}

// Source pixel (sr, sc) of channel c (negative: a pad row / column)
// decoded; HypT: the maps' type, bf16 maps decoded in bf16; kPlain: the
// values read by plain loads.
template <bool kLinear, typename InT, typename HypT, bool kPlain = false>
__device__ __forceinline__ Entry<kLinear, InT> decode(
    const InT* img, const HypT* codes, int c, int sr, int sc, int H, int W,
    float norm, float max_sigma) {
  const size_t e = ((size_t)c * H + max(sr, 0)) * W + max(sc, 0);
  if constexpr (kIsBf16<HypT>) {              // the twin's bf16 decode
    const HypT* h = codes + e * (kLinear ? 1 : 3);
    const float rho = bfr(bfr(unit(load<kPlain>(h), norm) * 2.0f) - 1.0f);
    const float ms = bfr(max_sigma);
    float sx = 0.0f, sy = 0.0f;
    if constexpr (!kLinear) {
      sx = bfr(unit(load<kPlain>(h + 1), norm) * ms);
      sy = bfr(unit(load<kPlain>(h + 2), norm) * ms);
    }
    if constexpr (!kIsBf16<InT>) {            // float32 feature: float32
      const float x = (sr >= 0 && sc >= 0) ? (float)load<kPlain>(img + e) : 0.0f;
      if constexpr (kLinear)
        return make_float2(x, rho);
      else
        return make_float4(x, 2.0f * rho, sx, sy);
    } else {
      const bf16 n = (sr >= 0 && sc >= 0) ? load<kPlain>(img + e)
                                          : __float2bfloat16_rn(0.0f);
      if constexpr (kLinear)
        return {n, __float2bfloat16_rn(rho)};
      else
        return {n, __float2bfloat16_rn(2.0f * rho), __float2bfloat16_rn(sx),
                __float2bfloat16_rn(sy)};
    }
  } else if constexpr (kLinear) {
    const float a = unit(load<kPlain>(codes + e), norm) * 2.0f - 1.0f;
    const float v = (sr >= 0 && sc >= 0) ? (float)load<kPlain>(img + e) : 0.0f;
    return make_float2(v, a);
  } else {
    const InT* code = codes + e * 3;
    const float rho = unit(load<kPlain>(code), norm) * 2.0f - 1.0f;
    const float sx = unit(load<kPlain>(code + 1), norm) * max_sigma;
    const float sy = unit(load<kPlain>(code + 2), norm) * max_sigma;
    const float v = (sr >= 0 && sc >= 0) ? (float)load<kPlain>(img + e) : 0.0f;
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
// The thread's first row is output row i0, its column j.
template <int KS, typename OutT, bool kLinear, bool kEdges = false>
__device__ __forceinline__ void sums_bf16_at(
    Window<KS, kLinear>* px, const bool* ok,
    const Entry<kLinear, bf16>* tile, bool shared, int r_lo, int c_lo,
    int nr, int nc, const bf16* __restrict__ img,
    const bf16* __restrict__ codes, OutT* __restrict__ out, const Warp& w,
    int C, float max_sigma, float norm, unsigned i0, int j) {
  static_assert(kRowsPerThread % 2 == 0, "pairs of a thread's rows");
#pragma unroll
  for (int q = 0; q < kRowsPerThread; q += 2) {
    if (!ok[q]) return;
    if (!ok[q + 1]) px[q + 1] = px[q];
    const Window<KS, kLinear>& p0 = px[q];
    const Window<KS, kLinear>& p1 = px[q + 1];
    const int S = p0.support();
    const int i = i0 + q * kThreadRows;
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
// corner / (W + 3) is umulhi(corner, magic) >> shift (Divider).
struct Divider {
  unsigned magic;
  int shift;
  __device__ int operator()(int n) const {
    return (int)(__umulhi((unsigned)n, magic) >> shift);
  }
};

struct Rings {
  Warp w;
  const int* ring_x;          // [H + 4]
  const int* ring_y;          // [W + 4]
  const int* corner;          // [OH * OW]
  const float2* dis_x;        // [OH * OW]
  const float2* dis_y;
  const unsigned char* bits;  // [OH * OW], linear only
  Divider stride;             // by W + 3
};

// floor(n / d) for 0 <= n < 2^31 and 4 <= d < 2^31, exact: with l =
// ceil(log2 d), magic = ceil(2^(31 + l) / d) < 2^32 and magic d - 2^(31 +
// l) < d <= 2^l, so floor(n magic / 2^(31 + l)) = floor(n / d) for every n
// below 2^31 (Granlund and Montgomery 1994, theorem 4.2); the high word of
// n magic is that product over 2^32, shifted right by l - 1 more.  The
// corner is clamped into [0, (H + 3)(W + 3)), below 2^31 by the entry's
// check.
Divider divider(int d) {
  int l = 0;
  while ((1ll << l) < d) ++l;
  const unsigned long long p = 1ull << (31 + l);
  return {(unsigned)((p + (unsigned long long)d - 1) / d), l - 1};
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

template <bool kLinear, typename InT, bool kWide>
__device__ __forceinline__ RingEntry<kLinear, InT, kWide> widen(
    Entry<kLinear, InT> v) {
  if constexpr (!kWide) {
    return v;
  } else if constexpr (kLinear) {
    return make_float2(__bfloat162float(v.x), __bfloat162float(v.y));
  } else {
    return make_float4(__bfloat162float(v.x), __bfloat162float(v.y),
                       __bfloat162float(v.z), __bfloat162float(v.w));
  }
}

template <bool kLinear, typename InT, bool kWide, typename HypT>
__device__ __forceinline__ RingEntry<kLinear, InT, kWide> ring_entry(
    const InT* img, const HypT* codes, int c, int sr, int sc, int H, int W,
    float norm, float max_sigma) {
  return widen<kLinear, InT, kWide>(fetch<kLinear, InT, true>(
      img, codes, c, sr, sc, H, W, norm, max_sigma));
}

// The same entry from a staged copy of the source: f and h point at the
// clamped pixel's feature and codes in shared memory (decode's operations
// on them, kPlain), the feature 0 off the image, as fetch gives it.
template <bool kLinear, typename InT, bool kWide, typename HypT>
__device__ __forceinline__ RingEntry<kLinear, InT, kWide> staged_entry(
    const InT* f, const HypT* h, int sr, int sc, int H, int W, float norm,
    float max_sigma) {
  Entry<kLinear, InT> v =
      decode<kLinear, InT, HypT, true>(f, h, 0, 0, 0, 1, 1, norm, max_sigma);
  if (sr < 0 || sc < 0 || sr >= H || sc >= W) {
    if constexpr (kIsBf16<InT>)
      v.x = __float2bfloat16_rn(0.0f);
    else
      v.x = 0.0f;
  }
  return widen<kLinear, InT, kWide>(v);
}

// -- the rings instance: a persistent, pipelined block -----------------------
//
// kRingsBlocks blocks an SM, each walking the frame's 16 x 32 output tiles
// in a static stride (tile t = blockIdx.x + k gridDim.x), 288 threads: warps
// 0-7 the consumers (thread (x, y) the outputs of tile rows y and y + 8,
// column x, as warp_block's), warp 8 the producer.  The producer copies
// the rings of a tile's 16 rows into one of kRingStages stages three tiles
// ahead; reduces the footprint of the tile two ahead from its stage by
// warp reductions; and copies that footprint's source rows (feature and
// codes) into one of kRawBuffers raw boxes, two tiles ahead.  Every copy is
// asynchronous and completes on an mbarrier: with kBulk one bulk copy
// (cp.async.bulk) a span, else 16-byte cp.async by the producer's lanes.
// The consumers read their windows from the stage, decode the raw box into
// the tile (decode's operations, kPlain) between two barriers of their
// own, and sum: the sums (s-major, t-minor, weight, weight_pair,
// weight_bf16, quotient, finish) are the library's functions.  A tile whose
// footprint exceeds kTileEntries, or whose raw box exceeds kRawBytes,
// takes the direct path, each neighbour from global memory (ring_entry);
// every barrier still completes once a tile.
constexpr int kRingsConsumers = kTileW * kThreadRows;   // 256 threads
constexpr int kRingsThreads = kRingsConsumers + kTileW; // and the producer
constexpr int kRingsBlocks = 2;       // blocks an SM: 112 registers a thread
constexpr int kRingStages = 3;        // tiles of rings in shared memory
constexpr int kRawBuffers = 2;        // tiles of source rows
constexpr bool kBulk = false;         // bulk copies, else 16-byte cp.async
// A stage row: the 16-byte-aligned spans around one tile row's 32 corners
// (128 bytes), dis_x and dis_y (256 each) and bits (32); each span starts
// where its first byte's address falls modulo 16.
constexpr int kCornerSpan = 144, kDisSpan = 272, kBitsSpan = 48;
constexpr int kRowSpan = kCornerSpan + 2 * kDisSpan + kBitsSpan;
constexpr int kStageBytes = kTileH * kRowSpan;
// A raw box: per channel and source row, the 16-byte-aligned spans of the
// footprint's feature and codes.
constexpr int kRawBytes = 16384;
constexpr int kMapInts = 2048;        // ring maps held in shared memory
constexpr int kBarBytes = 256;        // the mbarriers and the boxes
constexpr unsigned long long kWaitLimitNs = 2000000000ull;

// The tile's footprint and the source rows and columns it reads.
struct Box {
  int shared;                 // decoded into the tile (else the direct path)
  int r_lo, c_lo, nr, nc;     // rows and columns of the padded planes
  int a0, b0, nrr, bw;        // the source rows and columns, clamped
  int pf, pc;                 // bytes of a row's feature and codes spans
};

struct RingsBars {
  unsigned long long full[kRingStages], empty[kRingStages];
  unsigned long long raw_full[kRawBuffers], raw_empty[kRawBuffers];
  Box box[kRawBuffers];
};
static_assert(sizeof(RingsBars) <= kBarBytes, "barriers");

// Dynamic shared memory of an instance whose tile entry takes entry_bytes:
// the barriers, the stages, the raw boxes, the tile and, where they fit,
// the ring maps (map_ints: H + W + 8, or 0).
__host__ __device__ constexpr int rings_smem(int entry_bytes, int map_ints) {
  return kBarBytes + kRingStages * kStageBytes + kRawBuffers * kRawBytes +
         kTileEntries * entry_bytes + 4 * map_ints;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(void* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of this parity.  A wait
// longer than kWaitLimitNs (2 s, far above any launch) traps: a lost
// arrive ends in __trap(), a sticky error that ends the process's CUDA
// context (every later call in it fails), not a hang.
__device__ __forceinline__ void mbar_wait(void* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  unsigned long long start = 0;
  for (unsigned spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (done) return;
    if (spins % 1024 == 0) {
      const unsigned long long now = global_ns();
      if (start == 0)
        start = now;
      else if (now - start > kWaitLimitNs)
        __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(void* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive, and expect this many bytes of bulk copies before the phase ends
__device__ __forceinline__ void mbar_expect_tx(void* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// arrive once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_copies(void* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global memory to
// shared memory, the barrier told of their arrival
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, void* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// A span's 16-byte chunks [k0, n16) stepping by dk, by cp.async
__device__ __forceinline__ void copy_chunks(char* dst, const char* src,
                                            uint32_t bytes, int k0, int dk) {
  for (int k = k0; k < (int)(bytes / 16); k += dk)
    copy16(dst + 16 * k, src + 16 * k);
}

// generic-proxy accesses before async-proxy ones (the stage's reuse)
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the consumers' own barrier (named barrier 1, 256 threads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kRingsConsumers) : "memory");
}

// floor(n / d) for 0 <= n < 2^22 and 1 <= d < 2^24 from rcp = 1.0f / d:
// (n + 0.5) / d lies at least 0.5 / d from every integer, and the two
// roundings err by at most (n + 0.5) / d 2^-23 < 0.5 / d.
__device__ __forceinline__ int small_div(int n, float rcp) {
  return (int)(((float)n + 0.5f) * rcp);
}

// The 16-byte-aligned span [*from, *from + return) around bytes [p, p + n)
// of an array: every 16-byte chunk of it holds a byte of the array, so it
// lies in the array's pages (the bytes around the array are read, never
// used).
__device__ __forceinline__ uint32_t span16(const void* p, int n,
                                           const char** from) {
  const uintptr_t a = (uintptr_t)p;
  *from = (const char*)(a & ~(uintptr_t)15);
  return (uint32_t)(((a + n + 15) & ~(uintptr_t)15) - (a & ~(uintptr_t)15));
}

// The most bytes span16 takes for n bytes of values aligned to es bytes.
__device__ __forceinline__ int span16_max(int n, int es) {
  return (n + 16 - es + 15) & ~15;
}

// The window of the output whose corner is c: its ring rows and columns of
// the planes, clamped into them (the plain twin clamps the same; the rings
// the host or the card makes are inside).
template <bool kBits>
__device__ __forceinline__ void ring_window(Window<2, kBits>& p, int c,
                                            const int* rx, const int* ry,
                                            const Rings& g) {
  const int stride = g.w.W + 3;
  c = min(max(c, 0), (g.w.H + 3) * stride - 1);
  const int cx = g.stride(c);
  const int cy = c - cx * stride;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    p.r[s] = min(max(rx[cx + s], 0), g.w.H + 1);
    p.q[s] = min(max(ry[cy + s], 0), g.w.W + 1);
  }
}

// The stage's row: the tile row's first output n0 (its spans start at the
// addresses' offsets modulo 16).
struct StageRow {
  const char* base;
  size_t n0;
  __device__ int corner(int x, const Rings& g) const {
    return *(const int*)(base + ((uintptr_t)(g.corner + n0) & 15) + 4 * x);
  }
  __device__ float2 dis(int k, int x, const Rings& g) const {
    const float2* a = k == 0 ? g.dis_x : g.dis_y;
    return *(const float2*)(base + kCornerSpan + k * kDisSpan +
                            ((uintptr_t)(a + n0) & 15) + 8 * x);
  }
  __device__ unsigned bits(int x, const Rings& g) const {
    return *(const unsigned char*)(base + kCornerSpan + 2 * kDisSpan +
                                   ((uintptr_t)(g.bits + n0) & 15) + x);
  }
};

// The producer's copy of tile (ty, tx)'s rings into stage: lanes y and y +
// 16 row y (the corners and dis_x; dis_y and the bits).
__device__ __forceinline__ void start_rings(const Rings& g, int ty, int tx,
                                            char* stage, void* full,
                                            int lane) {
  const Warp& w = g.w;
  const int y = lane % kTileH, i = ty * kTileH + y, j0 = tx * kTileW;
  const int m = min(kTileW, w.OW - j0);
  const size_t n0 = (size_t)i * w.OW + j0;
  char* dst = stage + y * kRowSpan;
  const char *a_at = nullptr, *b_at = nullptr;
  uint32_t a_n = 0, b_n = 0;
  char *a_to = dst, *b_to = dst;
  if (i < w.OH) {
    if (lane < kTileH) {
      a_n = span16(g.corner + n0, 4 * m, &a_at);
      b_n = span16(g.dis_x + n0, 8 * m, &b_at);
      b_to = dst + kCornerSpan;
    } else {
      a_n = span16(g.dis_y + n0, 8 * m, &a_at);
      a_to = dst + kCornerSpan + kDisSpan;
      if (g.bits != nullptr) b_n = span16(g.bits + n0, m, &b_at);
      b_to = dst + kCornerSpan + 2 * kDisSpan;
    }
  }
  if constexpr (kBulk) {
    const uint32_t total = __reduce_add_sync(0xffffffffu, a_n + b_n);
    if (lane == 0) mbar_expect_tx(full, total);
    __syncwarp();
    if (a_n) bulk_copy(a_to, a_at, a_n, full);
    if (b_n) bulk_copy(b_to, b_at, b_n, full);
  } else {
    copy_chunks(a_to, a_at, a_n, 0, 1);
    copy_chunks(b_to, b_at, b_n, 0, 1);
    mbar_arrive_copies(full);
  }
}

// The producer's footprint of tile (ty, tx) from its stage: each lane the
// column j0 + lane of every row, reduced over the warp (with monotone ring
// maps from the corners' ring positions alone); and the source rows and
// columns it reads, and whether the tile fits.
template <typename InT, typename HypT, int K>
__device__ __forceinline__ Box footprint(const Rings& g, int ty, int tx,
                                         const char* stage, const int* rx,
                                         const int* ry, bool monotone, int C,
                                         int lane) {
  const Warp& w = g.w;
  const int j = tx * kTileW + lane, stride = w.W + 3;
  int rmin = INT_MAX, rmax = INT_MIN, cmin = INT_MAX, cmax = INT_MIN;
  if (monotone) {           // the ring positions' range, then the rings'
#pragma unroll
    for (int y = 0; y < kTileH; ++y) {
      const int i = ty * kTileH + y;
      if (i >= w.OH || j >= w.OW) continue;
      const StageRow row{stage + y * kRowSpan, (size_t)i * w.OW + j - lane};
      const int c = min(max(row.corner(lane, g), 0), (w.H + 3) * stride - 1);
      const int cx = g.stride(c);
      rmin = min(rmin, cx);
      rmax = max(rmax, cx);
      cmin = min(cmin, c - cx * stride);
      cmax = max(cmax, c - cx * stride);
    }
    rmin = __reduce_min_sync(0xffffffffu, rmin);
    rmax = __reduce_max_sync(0xffffffffu, rmax);
    cmin = __reduce_min_sync(0xffffffffu, cmin);
    cmax = __reduce_max_sync(0xffffffffu, cmax);
    rmin = min(max(rx[rmin], 0), w.H + 1);
    rmax = min(max(rx[rmax + 1], 0), w.H + 1);
    cmin = min(max(ry[cmin], 0), w.W + 1);
    cmax = min(max(ry[cmax + 1], 0), w.W + 1);
  } else {
#pragma unroll 4
    for (int y = 0; y < kTileH; ++y) {
      const int i = ty * kTileH + y;
      if (i >= w.OH || j >= w.OW) continue;
      const StageRow row{stage + y * kRowSpan, (size_t)i * w.OW + j - lane};
      Window<2, false> p;
      ring_window(p, row.corner(lane, g), rx, ry, g);
      rmin = min(rmin, min(p.r[0], p.r[1]));
      rmax = max(rmax, max(p.r[0], p.r[1]));
      cmin = min(cmin, min(p.q[0], p.q[1]));
      cmax = max(cmax, max(p.q[0], p.q[1]));
    }
    rmin = __reduce_min_sync(0xffffffffu, rmin);
    rmax = __reduce_max_sync(0xffffffffu, rmax);
    cmin = __reduce_min_sync(0xffffffffu, cmin);
    cmax = __reduce_max_sync(0xffffffffu, cmax);
  }
  Box b;
  b.r_lo = rmin;
  b.c_lo = cmin;
  b.nr = rmax - rmin + 1;
  b.nc = cmax - cmin + 1;
  // padded rows r_lo .. r_lo + nr - 1 are source rows one less, clamped
  b.a0 = min(max(b.r_lo - 1, 0), w.H - 1);
  b.nrr = min(max(b.r_lo + b.nr - 2, 0), w.H - 1) - b.a0 + 1;
  b.b0 = min(max(b.c_lo - 1, 0), w.W - 1);
  b.bw = min(max(b.c_lo + b.nc - 2, 0), w.W - 1) - b.b0 + 1;
  b.pf = span16_max(b.bw * (int)sizeof(InT), (int)sizeof(InT));
  b.pc = span16_max(b.bw * K * (int)sizeof(HypT), (int)sizeof(HypT));
  b.shared = (long long)C * b.nr * b.nc <= kTileEntries &&
             (long long)C * b.nrr * (b.pf + b.pc) <= kRawBytes;
  return b;
}

// The source rows of channel c, row a0 + rr, columns b0 .. b0 + bw - 1:
// the feature's and the codes' first values.
template <typename InT, typename HypT, int K>
__device__ __forceinline__ void source_row(const InT* img, const HypT* codes,
                                           const Box& b, const Warp& w,
                                           int c, int rr, const InT** f,
                                           const HypT** h) {
  const size_t e = ((size_t)c * w.H + b.a0 + rr) * w.W + b.b0;
  *f = img + e;
  *h = codes + e * K;
}

// The producer's copy of the box's source rows into raw (a lane a channel
// and row at a time: the spans of its feature and its codes), and the box
// written beside it, then the barrier's arrivals.
template <typename InT, typename HypT, int K>
__device__ __forceinline__ void start_raw(const InT* img, const HypT* codes,
                                          const Box& b, const Warp& w, int C,
                                          char* raw, Box* slot, void* full,
                                          int lane) {
  const int segs = b.shared ? C * b.nrr : 0;
  const float rcp = 1.0f / (float)max(b.nrr, 1);
  if constexpr (kBulk) {
    uint32_t total = 0;
    for (int sgm = lane; sgm < segs; sgm += 32) {
      const int c = small_div(sgm, rcp);
      const InT* f;
      const HypT* h;
      const char* at;
      source_row<InT, HypT, K>(img, codes, b, w, c, sgm - c * b.nrr, &f, &h);
      total += span16(f, b.bw * (int)sizeof(InT), &at) +
               span16(h, b.bw * K * (int)sizeof(HypT), &at);
    }
    total = __reduce_add_sync(0xffffffffu, total);
    if (lane == 0) {
      *slot = b;
      mbar_expect_tx(full, total);
    }
    __syncwarp();
    for (int sgm = lane; sgm < segs; sgm += 32) {
      const int c = small_div(sgm, rcp);
      const InT* f;
      const HypT* h;
      const char *f_at, *h_at;
      source_row<InT, HypT, K>(img, codes, b, w, c, sgm - c * b.nrr, &f, &h);
      char* dst = raw + sgm * (b.pf + b.pc);
      // the spans first: an argument's evaluation order is unspecified
      const uint32_t fn = span16(f, b.bw * (int)sizeof(InT), &f_at);
      const uint32_t hn = span16(h, b.bw * K * (int)sizeof(HypT), &h_at);
      bulk_copy(dst, f_at, fn, full);
      bulk_copy(dst + b.pf, h_at, hn, full);
    }
  } else {
    for (int sgm = lane; sgm < segs; sgm += 32) {
      const int c = small_div(sgm, rcp);
      const InT* f;
      const HypT* h;
      const char *f_at, *h_at;
      source_row<InT, HypT, K>(img, codes, b, w, c, sgm - c * b.nrr, &f, &h);
      char* dst = raw + sgm * (b.pf + b.pc);
      const uint32_t fn = span16(f, b.bw * (int)sizeof(InT), &f_at);
      const uint32_t hn = span16(h, b.bw * K * (int)sizeof(HypT), &h_at);
      copy_chunks(dst, f_at, fn, 0, 1);
      copy_chunks(dst + b.pf, h_at, hn, 0, 1);
    }
    mbar_arrive_copies(full);
    if (lane == 0) {
      *slot = b;
      mbar_arrive(full);
    }
  }
}

// The consumers' decode of the raw box into the tile (entry e: channel c,
// plane row r_lo + r, column c_lo + q).
template <bool kLinear, typename InT, bool kWide, typename HypT, int K>
__device__ __forceinline__ void decode_box(
    const InT* img, const HypT* codes, const Box& b, const Warp& w, int C,
    const char* raw, RingEntry<kLinear, InT, kWide>* tile, float norm,
    float max_sigma, int tid) {
  const int plane = b.nr * b.nc;
  const float rcp_plane = 1.0f / (float)plane, rcp_nc = 1.0f / (float)b.nc;
  for (int e = tid; e < C * plane; e += kRingsConsumers) {
    const int c = small_div(e, rcp_plane);
    const int rc = e - c * plane;
    const int r = small_div(rc, rcp_nc);
    const int sr = b.r_lo + r - 1, sc = b.c_lo + (rc - r * b.nc) - 1;
    const int rr = min(max(sr, 0), w.H - 1) - b.a0;
    const int cc = min(max(sc, 0), w.W - 1) - b.b0;
    const InT* f;
    const HypT* h;
    source_row<InT, HypT, K>(img, codes, b, w, c, rr, &f, &h);
    const char* seg = raw + (c * b.nrr + rr) * (b.pf + b.pc);
    tile[e] = staged_entry<kLinear, InT, kWide>(
        (const InT*)(seg + ((uintptr_t)f & 15)) + cc,
        (const HypT*)(seg + b.pf + ((uintptr_t)h & 15)) + cc * K, sr, sc,
        w.H, w.W, norm, max_sigma);
  }
}

// The float32 sums of the thread's two outputs, rows i0 and i0 + 8 of
// column j (warp_block's step 4 at support 2, its functions).
template <typename OutT, bool kLinear, typename InT, typename HypT,
          bool kWide>
__device__ __forceinline__ void sums_f32(
    const Window<2, kLinear>* px, const bool* ok,
    const RingEntry<kLinear, InT, kWide>* tile, const Box& b,
    const InT* __restrict__ img, const HypT* __restrict__ codes,
    OutT* __restrict__ out, const Warp& w, int C, float max_sigma,
    float norm, int i0, int j) {
  using CompT = typename std::conditional<kWide, float, InT>::type;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (!ok[k]) continue;
    const Window<2, kLinear>& p = px[k];
    const int i = i0 + k * kThreadRows;
    for (int c = 0; c < C; ++c) {
      float wn = 0.0f, ws = 0.0f;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const RingEntry<kLinear, InT, kWide> v =
              b.shared
                  ? tile[(c * b.nr + p.r[s] - b.r_lo) * b.nc + p.q[t] -
                         b.c_lo]
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

// K5's rings instance (the design above).  kWide: bf16 inputs under float32
// rings, the float32 steps on widened entries.  out [C, OH, OW]; map_ints:
// H + W + 8 where the ring maps are held in shared memory, else 0.
template <typename OutT, bool kLinear, typename InT, typename HypT = InT,
          bool kWide = false>
__global__ void __launch_bounds__(kRingsThreads, kRingsBlocks)
    steering_warp_rings_kernel(const InT* __restrict__ img,
                               const HypT* __restrict__ codes,
                               OutT* __restrict__ out,
                               const __grid_constant__ Rings g, int C,
                               float max_sigma, float norm, int map_ints) {
  using E = RingEntry<kLinear, InT, kWide>;
  constexpr int K = kLinear ? 1 : 3;
  // bulk copies complete on the tx count of one arrival, cp.async ones on
  // an arrival of each producer lane (and of lane 0 for the box)
  constexpr int kCopyArrivals = kBulk ? 1 : kTileW;
  extern __shared__ __align__(128) char smem[];
  RingsBars& bar = *reinterpret_cast<RingsBars*>(smem);
  char* stages = smem + kBarBytes;
  char* raw = stages + kRingStages * kStageBytes;
  E* tile = (E*)(raw + kRawBuffers * kRawBytes);
  int* maps = (int*)(tile + kTileEntries);
  const Warp& w = g.w;
  const int tid = threadIdx.y * kTileW + threadIdx.x, lane = threadIdx.x;

  // the ring maps, whether they are monotone, and the barriers
  const int* rx = g.ring_x;
  const int* ry = g.ring_y;
  bool up = true;
  for (int k = tid; k < w.H + 3; k += kRingsThreads)
    up = up && rx[k] <= rx[k + 1];
  for (int k = tid; k < w.W + 3; k += kRingsThreads)
    up = up && ry[k] <= ry[k + 1];
  if (map_ints > 0) {
    for (int k = tid; k < w.H + 4; k += kRingsThreads) maps[k] = rx[k];
    for (int k = tid; k < w.W + 4; k += kRingsThreads)
      maps[w.H + 4 + k] = ry[k];
    rx = maps;
    ry = maps + w.H + 4;
  }
  if (tid == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(&bar.full[s], kCopyArrivals);
      mbar_init(&bar.empty[s], kThreadRows);       // a consumer warp each
    }
    for (int s = 0; s < kRawBuffers; ++s) {
      mbar_init(&bar.raw_full[s], kCopyArrivals + (kBulk ? 0 : 1));
      mbar_init(&bar.raw_empty[s], kThreadRows);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const bool monotone = __syncthreads_and(up);

  const int ntx = (w.OW + kTileW - 1) / kTileW;
  const int tiles = ntx * ((w.OH + kTileH - 1) / kTileH);
  const int n = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                (int)gridDim.x;
  if (n <= 0) return;
  auto tile_at = [&](int k, int& ty, int& tx) {
    const int t = blockIdx.x + k * gridDim.x;
    ty = t / ntx;
    tx = t - ty * ntx;
  };

  if (threadIdx.y == kThreadRows) {
    // the producer: rings three tiles ahead, the raw box two
    int ty, tx;
    auto rings_of = [&](int k) {
      tile_at(k, ty, tx);
      start_rings(g, ty, tx, stages + (k % kRingStages) * kStageBytes,
                  &bar.full[k % kRingStages], lane);
    };
    auto raw_of = [&](int k) {
      const int s = k % kRingStages, b = k % kRawBuffers;
      mbar_wait(&bar.full[s], (k / kRingStages) & 1);
      tile_at(k, ty, tx);
      const Box box = footprint<InT, HypT, K>(
          g, ty, tx, stages + s * kStageBytes, rx, ry, monotone, C, lane);
      start_raw<InT, HypT, K>(img, codes, box, w, C, raw + b * kRawBytes,
                              &bar.box[b], &bar.raw_full[b], lane);
    };
    for (int k = 0; k < min(n, kRingStages); ++k) rings_of(k);
    for (int k = 0; k < min(n, kRawBuffers); ++k) raw_of(k);
    for (int k = 0; k < n; ++k) {
      if (k + kRingStages < n) {       // once the consumers hold tile k's
        mbar_wait(&bar.empty[k % kRingStages], (k / kRingStages) & 1);
        proxy_fence();
        rings_of(k + kRingStages);
      }
      if (k + kRawBuffers < n) {       // once they decoded tile k
        mbar_wait(&bar.raw_empty[k % kRawBuffers], (k / kRawBuffers) & 1);
        proxy_fence();
        raw_of(k + kRawBuffers);
      }
    }
    // no copy outlives the warp that started it
    for (int k = max(n - kRawBuffers, 0); k < n; ++k)
      mbar_wait(&bar.raw_full[k % kRawBuffers], (k / kRawBuffers) & 1);
    return;
  }

  // the consumers
  for (int k = 0; k < n; ++k) {
    const int s = k % kRingStages, rb = k % kRawBuffers;
    int ty, tx;
    tile_at(k, ty, tx);
    const int i0 = ty * kTileH + threadIdx.y, j = tx * kTileW + lane;
    mbar_wait(&bar.full[s], (k / kRingStages) & 1);
    Window<2, kLinear> px[kRowsPerThread];
    bool ok[kRowsPerThread];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const int i = i0 + q * kThreadRows;
      ok[q] = j < w.OW && i < w.OH;
      if (!ok[q]) continue;
      const StageRow row{stages + s * kStageBytes +
                             (threadIdx.y + q * kThreadRows) * kRowSpan,
                         (size_t)i * w.OW + tx * kTileW};
      ring_window(px[q], row.corner(lane, g), rx, ry, g);
      const float2 dx = row.dis(0, lane, g), dy = row.dis(1, lane, g);
      px[q].dx[0] = dx.x;
      px[q].dx[1] = dx.y;
      px[q].dy[0] = dy.x;
      px[q].dy[1] = dy.y;
      px[q].bits = kLinear ? row.bits(lane, g) : 0u;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar.empty[s]);
    mbar_wait(&bar.raw_full[rb], (k / kRawBuffers) & 1);
    const Box b = bar.box[rb];
    if (b.shared) {
      consumers_sync();                    // the last tile's sums are done
      decode_box<kLinear, InT, kWide, HypT, K>(
          img, codes, b, w, C, raw + rb * kRawBytes, tile, norm, max_sigma,
          tid);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar.raw_empty[rb]);
    if (b.shared) consumers_sync();        // the tile is whole
    if constexpr (kIsBf16<typename std::conditional<kWide, float,
                                                    InT>::type>) {
      sums_bf16_at<2, OutT, kLinear, true>(
          px, ok, tile, b.shared, b.r_lo, b.c_lo, b.nr, b.nc, img, codes,
          out, w, C, max_sigma, norm, (unsigned)i0, j);
    } else {
      sums_f32<OutT, kLinear, InT, HypT, kWide>(px, ok, tile, b, img, codes,
                                                out, w, C, max_sigma, norm,
                                                i0, j);
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

// One launch on stream s: min(tiles, SMs x kRingsBlocks) persistent blocks
// of 288 threads.  Returns a CUDA error code.
template <typename OutT, bool kLinear, typename InT, typename HypT,
          bool kWide>
int launch_rings(const void* img, const void* codes, void* out,
                 const Rings& g, int C, float max_sigma, float norm,
                 cudaStream_t s) {
  const auto kernel = steering_warp_rings_kernel<OutT, kLinear, InT, HypT,
                                                 kWide>;
  const int entry = (int)sizeof(RingEntry<kLinear, InT, kWide>);
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) ||
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           rings_smem(entry, kMapInts))))
    return (int)err;
  const Warp& w = g.w;
  const long long tiles = (long long)((w.OW + kTileW - 1) / kTileW) *
                          ((w.OH + kTileH - 1) / kTileH);
  const long long blocks = (long long)sms * kRingsBlocks;
  const int grid = (int)(tiles < blocks ? tiles : blocks);
  const int maps = w.H + w.W + 8 <= kMapInts ? w.H + w.W + 8 : 0;
  kernel<<<grid, dim3(kTileW, kThreadRows + 1), rings_smem(entry, maps),
           s>>>((const InT*)img, (const HypT*)codes, (OutT*)out, g, C,
                max_sigma, norm, maps);
  return (int)cudaGetLastError();
}

template <bool kLinear, typename InT, typename HypT = InT,
          bool kWide = false>
int rings_out(const void* img, const void* codes, void* out, const Rings& g,
              int C, float max_sigma, float norm, int out_u8,
              cudaStream_t s) {
  if (out_u8)
    return launch_rings<unsigned char, kLinear, InT, HypT, kWide>(
        img, codes, out, g, C, max_sigma, norm, s);
  return launch_rings<float, kLinear, InT, HypT, kWide>(
      img, codes, out, g, C, max_sigma, norm, s);
}

template <bool kLinear>
int rings_in(const void* img, const void* codes, void* out, const Rings& g,
             int C, float max_sigma, float norm, int out_u8, int in_type,
             cudaStream_t s) {
  if (in_type == 1)
    return rings_out<kLinear, float>(img, codes, out, g, C, max_sigma, norm,
                                     out_u8, s);
  if (in_type == 2)
    return rings_out<kLinear, bf16>(img, codes, out, g, C, max_sigma, norm,
                                    out_u8, s);
  if (in_type == 3)
    return rings_out<kLinear, float, bf16>(img, codes, out, g, C, max_sigma,
                                           norm, out_u8, s);
  if (in_type == 4)
    return rings_out<kLinear, bf16, bf16, true>(img, codes, out, g, C,
                                                max_sigma, norm, out_u8, s);
  return rings_out<kLinear, int>(img, codes, out, g, C, max_sigma, norm,
                                 out_u8, s);
}

}  // namespace

// K5's rings instance, the producer-warp design (the library's entry of the
// same name, lerf_torch/ops/kernels/warp.py::steering_warp_rings, takes the
// same arguments and checks them the same way).
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
  if ((uintptr_t)dis_x % sizeof(float2) || (uintptr_t)dis_y % sizeof(float2) ||
      (uintptr_t)corner % sizeof(int))
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
  g.stride = divider(W + 3);
  cudaStream_t s = (cudaStream_t)stream;
  if (linear)
    return rings_in<true>(img, codes, out, g, C, max_sigma, norm, out_u8,
                          in_type, s);
  return rings_in<false>(img, codes, out, g, C, max_sigma, norm, out_u8,
                         in_type, s);
}
