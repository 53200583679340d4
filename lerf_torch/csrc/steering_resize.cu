// K1: steerable resize from the stage-2 codes, for sm_90a.
//
// Replaces: lerf_tpu/ops/pallas/resize_kernel.py::steering_gaussian_resize_pallas
// (body _kernel), which computes lerf_tpu/ops/resample.py::steering_gaussian_resize.
// Unlike the Pallas kernel (periodic scales, support 2, no antialias), this one
// takes every ResizeGeometry: periodic and non-periodic scales and the
// antialiased downscale with its inflated support.  A second mode computes
// lerf_tpu/ops/resample.py::amplified_linear_resize (LeRF-L), which on the TPU
// is XLA: one code a pixel, alpha = code / norm * 2 - 1 (max_alpha 1), and the
// weight max(lin(alpha, dx), 0) * max(lin(alpha, dy), 0), lin(a, x) = a x + 1
// on the negative branch, 1 - a x on the positive one, 0 off both.  The
// branches are the host's float64 masks of min_scale * dis (2 bits an output
// and neighbour, uint8 operands): the reference resolves them in float64,
// where a float32 distance can land on the other side of 0 or 1.  In this mode
// the distances arrive as float32(min_scale * dis), scaled in float64 on the
// host, and an antialiased weight is min_scale * w after the product, as
// lerf_tpu does; the window entry is float2 {feature, alpha}.
// Both modes take the stage outputs in either of two forms: int32 feature
// and int32 codes (the LUT and SRNet forms; a code decodes as code / norm),
// or float32 feature and float32 hyper maps in [0, 1] (the IMDN form, the
// Pallas kernel's own inputs), decoded as h * 2 - 1 and h * max_sigma, the
// float operations of lerf_tpu's steering_gaussian_resize.  The input type
// is a template parameter: the window fill alone differs, and the int32
// instantiations are the code they were before the float one was added.
// A third type, bf16 feature and bf16 hyper maps (the IMDN form's bf16
// compute type, lerf_tpu's IMDN2(dtype=bfloat16)), runs lerf_tpu's resize
// in img.dtype = bf16, whose plain twin is lerf_torch/ops/resample.py::
// steering_gaussian_resize / amplified_linear_resize on bf16 tensors: every
// operation in float, then rounded to bf16 (__float2bfloat16_rn), in the
// twin's order.  The decode (h * 2 - 1, h * max_sigma, max_sigma rounded to
// bf16 first), the distances (float64 -> float32 -> bf16, as PyTorch casts
// them), min_scale rounded to bf16 (lerf_tpu's jnp.asarray(min_scale,
// bf16)) and its products, each step of the weight and its expf, the
// s-major, t-minor sums of w n and w, and wn / ws: each rounded to bf16;
// the uint8 epilogue rounds that bf16 quotient half to even.  In the linear
// mode lerf_tpu's float32 branch masks promote the weight to float32: the
// product a x and lin(a, x) round to bf16, the rest (the clip, the product
// of the two axes, min_scale times it, the sums, the quotient) is float32.
// The window holds bf16 entries {feature, 2 rho, sx, sy} (8 bytes) or
// {feature, alpha} (4), half the float ones, from maps of half the bytes.
// A fourth pair, a float32 feature with bf16 maps (the bf16 form without
// its feature tower, two_stage=False, whose feature is round(img * norm) in
// float32), decodes the maps in bf16 as above and runs the rest in
// float32, as lerf_tpu's promotion of the bf16 decoded maps against
// float32 distances does: the float instance with the bf16 decode
// (template parameter HypT).  A fifth, a bf16 feature with float32 maps,
// is lerf_tpu's resize with img.dtype = bf16 and float32 maps: the maps
// decoded in float32, the distances and min_scale in bf16 (float64 ->
// float32 -> bf16, and the antialias's product m d rounded to bf16, as the
// bf16 instance takes them), the rest float32 (the bf16 distances widen at
// their first product with a float32 map); the feature is read as bf16 and
// widened in registers.  Its window holds float entries, as the float32
// instance's.
//
// The bf16 instance runs each of those bf16 steps as one native bf16
// instruction on a pair of values (__hmul2_rn, __hadd2_rn, __hsub2_rn:
// mul / add / sub.rn.bf16x2, one rounding to nearest even, no contraction).
// Every operand is a bf16 value, and float32's 24 bits hold more than
// twice bf16's 8 plus 2, so the twin's float operation rounded to bf16 is
// the correctly rounded bf16 result, which the native instruction gives:
// lerf_torch/tools/bf16_steps_exhaustive.cu checks each step the kernel
// uses against float-then-round over all 2^32 operand pairs on the card,
// both lanes, signed zeros and subnormals included, with 0 mismatches
// (also the HFMA2 forms a x 1 + b and a x b + (-0) in which ptxas emits
// some of these adds and products).  No other fused form: __hfma rounds
// a x b + c once where the twin rounds twice.  The Gaussian pairs a
// thread's outputs 2k and 2k + 1 (add_pair): the window entries of the two
// neighbours transposed into (n, n'), (2 rho, 2 rho'), (sx, sx'), (sy, sy')
// (four byte permutes), then the twelve steps as ten pair operations and
// expf in float32 with one pair rounding; the distances rounded to bf16
// once a thread (FovBf).  The linear mode takes (a dx, a dy) as one pair
// product and each branch's value as one pair add.  Its times: PERF.md
// section 6 (lerf_torch/tools/probe_lut_kernels.py --k1).
//
// What bounds it on the H100: operations.  At 360x640 -> x4 it reads 11 MB of
// int32 feature and codes and writes 11 MB of uint8 (0.0066 ms at 3.35 TB/s);
// each of the 11 M outputs takes 4 neighbours at ~15 float32 operations and
// one expf each, which with --fmad=false run as single instructions: by
// count ~23 instructions and one 16-byte shared-memory read a neighbour.
// On the card it runs at about half the schedulers' instruction rate;
// without expf it is 13 % faster, without the window load 5 %
// (lerf_torch/tools/probe_lut_kernels.py).
//
// What the design does about it:
// - A block covers a tile_h x tile_w tile of one channel's output; the grid
//   is (column tiles, row tiles, C), so no thread divides a flat index.
// - The field of view is monotone (fov = left + 0..S-1, left non-decreasing),
//   so a tile reads one contiguous source window.  The block loads it once
//   and decodes it into shared memory as float4 {feature, 2*rho, sx, sy}:
//   the feature zero outside the image (constant pad), the codes read at the
//   edge-clamped index (edge pad), decoded with the float operations of
//   split_gaussian_hyper + decode_gaussian_hyper (code / norm * 2 - 1,
//   code / norm * max_sigma).  The three divisions then run once a source
//   pixel instead of once a neighbour, and each neighbour is one 16-byte
//   shared-memory read.  2*rho is exact, so storing it changes no bit.
// - The host picks the tile per geometry (kernels/resize.py) so the window,
//   whose span grows with the support S that antialiasing inflates, fits in
//   shared memory; a negative pad (crop) needs no special case.  Where not
//   even one output's S x S window fits (S >= 122: an antialiased downscale
//   below about 1/61), the block walks its window in strips of rows, the
//   sums still in s order.
// - A thread takes one output row and kVec adjacent columns: its rows and
//   dis_x, and its columns' cols and dis_y, sit in registers when S is a
//   compile-time 2 or 4 (every upscale; x0.5 antialiased) and are read from
//   L1 in the loop for any other S.
// - The epilogue writes float32 wn / ws, or uint8 clip(rint(wn / ws), 0,
//   norm) (rint rounds half to even, as torch.round), kVec outputs in one
//   store where the row is aligned, one by one at a ragged edge.
// Sums run s-major, t-minor, as the JAX path's _per_block_reduce does; the
// library is built without fast math and without FMA contraction, so each
// product, the expf and the final division are single IEEE operations in
// the order of the plain PyTorch twin.
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 4;                  // adjacent outputs a thread
static_assert(kVec % 2 == 0, "the bf16 instance pairs adjacent outputs");
constexpr int kMaxThreads = 256;         // a block; the host's tiles fit
constexpr int kMaxSmem = 232448;         // the H100's opt-in block limit
constexpr int kDefaultSmem = 48 * 1024;  // above this only after opting in

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

template <typename InT>
constexpr bool kIsBf16 = std::is_same<InT, bf16>::value;

// The type of the window's entries and of the steps: bf16 where the
// feature and the maps both are, else float32 (a bf16 feature or bf16 maps
// beside float32 ones widen exactly into float32 entries).
template <typename InT, typename HypT>
using StepT = typename std::conditional<kIsBf16<InT> && kIsBf16<HypT>, bf16,
                                        float>::type;

// v rounded to bf16, as a float: one bf16 operation is float, then this
__device__ __forceinline__ float bfr(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A thread's distance: the Gaussian antialias scales it by m (scale).
__device__ __forceinline__ float dist(float d, int scale, float m) {
  return scale ? m * d : d;
}

// The bf16 instance's: the float32 distance rounded to bf16, and the
// Gaussian antialias's product with m (bf16 there) rounded once more.
__device__ __forceinline__ bf16 dist_bf16(float d, int scale, float m) {
  const float b = bfr(d);
  return __float2bfloat16_rn(scale ? m * b : b);
}

// A float instance's distance: in bf16 (kBfDis: a bf16 feature beside
// float32 maps, whose distances lerf_tpu casts to img.dtype), widened.
template <bool kBfDis>
__device__ __forceinline__ float dist_in(float d, int scale, float m) {
  if constexpr (kBfDis) return __bfloat162float(dist_bf16(d, scale, m));
  return dist(d, scale, m);
}

// The geometry's device arrays: rows / cols [O, S], the mode's distances,
// and in the linear mode the branch bits (bit 0 negative, bit 1 positive).
struct Geo {
  const int* rows;
  const int* cols;
  const float* dis_x;
  const float* dis_y;
  const unsigned char* mask_x;
  const unsigned char* mask_y;
};

// A thread's field of view, local to the block's source window.  KS > 0:
// the support is known at compile time and the values sit in registers.
// scale: the Gaussian mode's antialias, which scales the distances by m;
// kBfDis: the distances in bf16 (dist_in).
template <int KS, bool kLinear, bool kBfDis = false>
struct Fov {
  static constexpr int KM = kLinear ? KS : 1;   // masks: the linear mode's
  int lr[KS];
  float dx[KS];
  unsigned char mx[KM];
  int lc[kVec][KS];
  float dy[kVec][KS];
  unsigned char my[kVec][KM];

  __device__ void load(const Geo& g, int i, const int* j, int r_lo, int c_lo,
                       int, int scale, float m) {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      lr[s] = g.rows[i * KS + s] - r_lo;
      dx[s] = dist_in<kBfDis>(g.dis_x[i * KS + s], scale, m);
      if (kLinear) mx[s % KM] = g.mask_x[i * KS + s];
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
#pragma unroll
      for (int t = 0; t < KS; ++t) {
        lc[v][t] = g.cols[j[v] * KS + t] - c_lo;
        dy[v][t] = dist_in<kBfDis>(g.dis_y[j[v] * KS + t], scale, m);
        if (kLinear) my[v][t % KM] = g.mask_y[j[v] * KS + t];
      }
    }
  }
  __device__ int row(int s) const { return lr[s]; }
  __device__ float dxs(int s) const { return dx[s]; }
  __device__ unsigned mxs(int s) const { return mx[s % KM]; }
  __device__ int col(int v, int t) const { return lc[v][t]; }
  __device__ float dyt(int v, int t) const { return dy[v][t]; }
  __device__ unsigned myt(int v, int t) const { return my[v][t % KM]; }
};

// Any other support: read each value where it is used.
template <bool kLinear, bool kBfDis>
struct Fov<0, kLinear, kBfDis> {
  Geo g;
  int i, j[kVec], r_lo, c_lo, S, scale;
  float m;

  __device__ void load(const Geo& g_, int i_, const int* j_, int r_lo_,
                       int c_lo_, int S_, int scale_, float m_) {
    g = g_;
    i = i_; r_lo = r_lo_; c_lo = c_lo_; S = S_; scale = scale_; m = m_;
    for (int v = 0; v < kVec; ++v) j[v] = j_[v];
  }
  __device__ int row(int s) const { return g.rows[i * S + s] - r_lo; }
  __device__ float dxs(int s) const {
    return dist_in<kBfDis>(g.dis_x[i * S + s], scale, m);
  }
  __device__ unsigned mxs(int s) const { return g.mask_x[i * S + s]; }
  __device__ int col(int v, int t) const {
    return g.cols[j[v] * S + t] - c_lo;
  }
  __device__ float dyt(int v, int t) const {
    return dist_in<kBfDis>(g.dis_y[j[v] * S + t], scale, m);
  }
  __device__ unsigned myt(int v, int t) const {
    return g.mask_y[j[v] * S + t];
  }
};

// The bf16 instance's field of view: the distances rounded to bf16 once a
// thread (dist_bf16) and held as the pairs the neighbour loop takes: dxp(s)
// = (dx_s, dx_s), dyp(k, t) = (dy of output 2k, dy of output 2k + 1) at t.
// KS > 0 in registers; any other support read where used, as Fov.
template <int KS, bool kLinear>
struct FovBf {
  static constexpr int KM = kLinear ? KS : 1;
  int lr[KS];
  bf162 dx[KS];
  unsigned char mx[KM];
  int lc[kVec][KS];
  bf162 dy[kVec / 2][KS];
  unsigned char my[kVec][KM];

  __device__ void load(const Geo& g, int i, const int* j, int r_lo, int c_lo,
                       int, int scale, float m) {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      lr[s] = g.rows[i * KS + s] - r_lo;
      dx[s] = __bfloat162bfloat162(dist_bf16(g.dis_x[i * KS + s], scale, m));
      if (kLinear) mx[s % KM] = g.mask_x[i * KS + s];
    }
#pragma unroll
    for (int t = 0; t < KS; ++t) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        lc[v][t] = g.cols[j[v] * KS + t] - c_lo;
        if (kLinear) my[v][t % KM] = g.mask_y[j[v] * KS + t];
      }
#pragma unroll
      for (int k = 0; k < kVec / 2; ++k)
        dy[k][t] = __halves2bfloat162(
            dist_bf16(g.dis_y[j[2 * k] * KS + t], scale, m),
            dist_bf16(g.dis_y[j[2 * k + 1] * KS + t], scale, m));
    }
  }
  __device__ int row(int s) const { return lr[s]; }
  __device__ bf162 dxp(int s) const { return dx[s]; }
  __device__ unsigned mxs(int s) const { return mx[s % KM]; }
  __device__ int col(int v, int t) const { return lc[v][t]; }
  __device__ bf162 dyp(int k, int t) const { return dy[k][t]; }
  __device__ bf16 dyv(int v, int t) const {
    return (v & 1) ? __high2bfloat16(dy[v / 2][t])
                   : __low2bfloat16(dy[v / 2][t]);
  }
  __device__ unsigned myt(int v, int t) const { return my[v][t % KM]; }
};

template <bool kLinear>
struct FovBf<0, kLinear> {
  Geo g;
  int i, j[kVec], r_lo, c_lo, S, scale;
  float m;

  __device__ void load(const Geo& g_, int i_, const int* j_, int r_lo_,
                       int c_lo_, int S_, int scale_, float m_) {
    g = g_;
    i = i_; r_lo = r_lo_; c_lo = c_lo_; S = S_; scale = scale_; m = m_;
    for (int v = 0; v < kVec; ++v) j[v] = j_[v];
  }
  __device__ int row(int s) const { return g.rows[i * S + s] - r_lo; }
  __device__ bf162 dxp(int s) const {
    return __bfloat162bfloat162(dist_bf16(g.dis_x[i * S + s], scale, m));
  }
  __device__ unsigned mxs(int s) const { return g.mask_x[i * S + s]; }
  __device__ int col(int v, int t) const {
    return g.cols[j[v] * S + t] - c_lo;
  }
  __device__ bf162 dyp(int k, int t) const {
    return __halves2bfloat162(
        dist_bf16(g.dis_y[j[2 * k] * S + t], scale, m),
        dist_bf16(g.dis_y[j[2 * k + 1] * S + t], scale, m));
  }
  __device__ bf16 dyv(int v, int t) const {
    return dist_bf16(g.dis_y[j[v] * S + t], scale, m);
  }
  __device__ unsigned myt(int v, int t) const {
    return g.mask_y[j[v] * S + t];
  }
};

// The field of view of an instance: the bf16 instance's pairs, else
// float distances, in bf16 for a bf16 feature beside float32 maps.
template <int KS, bool kLinear, typename InT, typename HypT>
using FovOf = typename std::conditional<
    kIsBf16<InT> && kIsBf16<HypT>, FovBf<KS, kLinear>,
    Fov<KS, kLinear, kIsBf16<InT>>>::type;

// The window entry: {feature, 2 rho, sx, sy} or, linear, {feature, alpha};
// float32, or for bf16 inputs bf16 (Entry<kLinear, StepT<InT, HypT>>).
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

// One branch of the amplified-linear kernel: a x + 1 (bit 0), 1 - a x (bit
// 1), else 0, as lerf_tpu's (a x + 1) neg + (1 - a x) pos gives it.
__device__ __forceinline__ float lin(float a, float x, unsigned mask) {
  const float ax = a * x;
  return (mask & 1u) ? ax + 1.0f : ((mask & 2u) ? 1.0f - ax : 0.0f);
}

__device__ __forceinline__ float finish(float v, float, float*) { return v; }

// clip(rint(.), 0, norm); a 0/0 window (NaN) writes 0, as the warp's
// nan_to_num does (fmaxf returns its other operand for a NaN)
__device__ __forceinline__ unsigned char finish(float v, float norm,
                                                unsigned char*) {
  return (unsigned char)fminf(fmaxf(rintf(v), 0.0f), norm);
}

// kVec outputs in one aligned store (4 bytes of uint8, 16 of float32)
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const T* o) {
  struct alignas(sizeof(T) * kVec) Vec { T v[kVec]; } w;
#pragma unroll
  for (int v = 0; v < kVec; ++v) w.v[v] = o[v];
  *reinterpret_cast<Vec*>(p) = w;
}

// A stored hyper value in [0, 1]: an int32 code divided by norm, a float32
// map value as it is.
__device__ __forceinline__ float unit(int code, float norm) {
  return (float)code / norm;
}
__device__ __forceinline__ float unit(float h, float) { return h; }
__device__ __forceinline__ float unit(bf16 h, float) {
  return __bfloat162float(h);
}

// The bf16 instance's Gaussian neighbours of outputs 2k and 2k + 1 (the
// lanes of each pair), entries p0 and p1, their distances dx = (dx, dx) and
// dy: the twin's twelve bf16 steps in its order, each a native bf16 pair
// operation (one rounding to nearest even, as the twin's float operation
// then rounding gives it: lerf_torch/tools/bf16_steps_exhaustive.cu), expf
// in float32 and one rounding; then the weight into the sums, one rounded
// add each.  The window entries are transposed into pairs of a field:
// (n0, n1), (2 rho0, 2 rho1), (sx0, sx1), (sy0, sy1).
__device__ __forceinline__ void add_pair(Bf4 p0, Bf4 p1, bf162 dx, bf162 dy,
                                         int antialias, bf162 m, bf162& wn,
                                         bf162& ws) {
  const bf162 lo0 = __halves2bfloat162(p0.x, p0.y);
  const bf162 hi0 = __halves2bfloat162(p0.z, p0.w);
  const bf162 lo1 = __halves2bfloat162(p1.x, p1.y);
  const bf162 hi1 = __halves2bfloat162(p1.z, p1.w);
  const bf162 n = __lows2bfloat162(lo0, lo1);
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
  bf162 w = __floats2bfloat162_rn(expf(__low2float(e)),
                                  expf(__high2float(e)));
  if (antialias) w = __hmul2_rn(m, w);
  wn = __hadd2_rn(wn, __hmul2_rn(w, n));
  ws = __hadd2_rn(ws, w);
}

// The bf16 linear neighbour: (a dx, a dy) one pair product, each branch's
// value a x + 1 (bit 0) and 1 - a x (bit 1) one pair add, picked per axis
// on its branch bits; the rest float32 (lerf_tpu's float32 branch masks
// promote the weight).  dxy: the output's (dx, dy), bf16.
__device__ __forceinline__ void add_bf16(Bf2 p, bf162 dxy, unsigned mx,
                                         unsigned my, int antialias, float m,
                                         float& wn, float& ws) {
  const bf162 one = __float2bfloat162_rn(1.0f);
  const bf162 ax = __hmul2_rn(__bfloat162bfloat162(p.y), dxy);
  const bf162 neg = __hadd2_rn(ax, one);
  const bf162 pos = __hsub2_rn(one, ax);
  const float lx = (mx & 1u) ? __low2float(neg)
                             : ((mx & 2u) ? __low2float(pos) : 0.0f);
  const float ly = (my & 1u) ? __high2float(neg)
                             : ((my & 2u) ? __high2float(pos) : 0.0f);
  float w = fmaxf(lx, 0.0f) * fmaxf(ly, 0.0f);
  if (antialias) w = m * w;
  wn += w * __bfloat162float(p.x);
  ws += w;
}

// The quotient the epilogue finishes: the bf16 Gaussian's rounded to bf16.
template <bool kLinear, typename InT>
__device__ __forceinline__ float quotient(float wn, float ws) {
  if constexpr (kIsBf16<InT> && !kLinear) return bfr(wn / ws);
  return wn / ws;
}

// Window rows [k0, k0 + nrows) of the block's source window, decoded into
// shared memory as {feature, 2 rho, sx, sy} or, linear, {feature, alpha}.
// HypT: the maps' type, bf16 maps decoded in bf16.
template <bool kLinear, typename InT, typename HypT>
__device__ __forceinline__ void load_window(
    Entry<kLinear, StepT<InT, HypT>>* win, const InT* x, const HypT* hyp,
    int r_lo, int c_lo, int k0, int nrows, int wc, int pitch, int H, int W,
    float norm, float max_sigma) {
  const int nthreads = blockDim.x * blockDim.y;
  for (int e = threadIdx.y * blockDim.x + threadIdx.x; e < nrows * wc;
       e += nthreads) {
    const int r = e / wc;
    const int q = e - r * wc;
    const int gr = r_lo + k0 + r, gc = c_lo + q;
    const int rc = min(max(gr, 0), H - 1);
    const int cc = min(max(gc, 0), W - 1);
    const float n = (gr >= 0 && gr < H && gc >= 0 && gc < W)
                        ? (float)__ldg(x + (size_t)gr * W + gc) : 0.0f;
    if constexpr (kIsBf16<HypT>) {            // the twin's bf16 decode
      const HypT* code = hyp + ((size_t)rc * W + cc) * (kLinear ? 1 : 3);
      const float rho = bfr(bfr(unit(__ldg(code), norm) * 2.0f) - 1.0f);
      const float ms = bfr(max_sigma);
      float sx = 0.0f, sy = 0.0f;
      if constexpr (!kLinear) {
        sx = bfr(unit(__ldg(code + 1), norm) * ms);
        sy = bfr(unit(__ldg(code + 2), norm) * ms);
      }
      if constexpr (!kIsBf16<InT>) {          // float32 feature: float32
        if constexpr (kLinear)
          win[r * pitch + q] = {n, rho};
        else
          win[r * pitch + q] = {n, 2.0f * rho, sx, sy};
      } else if constexpr (kLinear) {
        win[r * pitch + q] = {__float2bfloat16_rn(n),
                              __float2bfloat16_rn(rho)};
      } else {
        win[r * pitch + q] = {
            __float2bfloat16_rn(n), __float2bfloat16_rn(2.0f * rho),
            __float2bfloat16_rn(sx), __float2bfloat16_rn(sy)};
      }
    } else if constexpr (kLinear) {
      const HypT* code = hyp + (size_t)rc * W + cc;
      win[r * pitch + q] =
          make_float2(n, unit(__ldg(code), norm) * 2.0f - 1.0f);
    } else {
      const HypT* code = hyp + ((size_t)rc * W + cc) * 3;
      const float rho = unit(__ldg(code), norm) * 2.0f - 1.0f;
      const float sx = unit(__ldg(code + 1), norm) * max_sigma;
      const float sy = unit(__ldg(code + 2), norm) * max_sigma;
      win[r * pitch + q] = make_float4(n, 2.0f * rho, sx, sy);
    }
  }
}

// The bf16 instance's sums over the neighbours whose source row lies in
// window rows [k0, k0 + nrows), s-major, t-minor, into wn / ws (floats
// holding bf16 values in the Gaussian mode, so the pairs' pack and unpack
// are exact).  Gaussian: outputs 2k and 2k + 1 a pair (add_pair), each sum
// a bf16 pair; linear: an output at a time, (dx, dy) a pair, the sums
// float32.
template <bool kStrip, int KS, bool kLinear>
__device__ __forceinline__ void accumulate_bf16(
    const Entry<kLinear, bf16>* win, const FovBf<KS, kLinear>& fov,
    int S_rt, int pitch, int k0, int nrows, int antialias, float m,
    float* wn, float* ws) {
  const int S = KS > 0 ? KS : S_rt;
  const bf162 m2 = __float2bfloat162_rn(m);
  bf162 wn2[kVec / 2], ws2[kVec / 2];
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    wn2[k] = __floats2bfloat162_rn(wn[2 * k], wn[2 * k + 1]);
    ws2[k] = __floats2bfloat162_rn(ws[2 * k], ws[2 * k + 1]);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = fov.row(s) - k0;
    if (kStrip && (r < 0 || r >= nrows)) continue;
    const Entry<kLinear, bf16>* wrow = win + r * pitch;
    const bf162 dx = fov.dxp(s);
#pragma unroll
    for (int t = 0; t < S; ++t) {
      if constexpr (kLinear) {
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          add_bf16(wrow[fov.col(v, t)],
                   __halves2bfloat162(__low2bfloat16(dx), fov.dyv(v, t)),
                   fov.mxs(s), fov.myt(v, t), antialias, m, wn[v], ws[v]);
      } else {
#pragma unroll
        for (int k = 0; k < kVec / 2; ++k)
          add_pair(wrow[fov.col(2 * k, t)], wrow[fov.col(2 * k + 1, t)], dx,
                   fov.dyp(k, t), antialias, m2, wn2[k], ws2[k]);
      }
    }
  }
  if constexpr (!kLinear) {
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      wn[2 * k] = __low2float(wn2[k]);
      wn[2 * k + 1] = __high2float(wn2[k]);
      ws[2 * k] = __low2float(ws2[k]);
      ws[2 * k + 1] = __high2float(ws2[k]);
    }
  }
}

// The weighted sums over the neighbours whose source row lies in window
// rows [k0, k0 + nrows), s-major, t-minor.  kStrip false: all of them (the
// whole window is in shared memory).
template <bool kStrip, int KS, bool kLinear, typename InT, typename HypT>
__device__ __forceinline__ void accumulate(
    const Entry<kLinear, StepT<InT, HypT>>* win,
    const FovOf<KS, kLinear, InT, HypT>& fov, int S_rt, int pitch, int k0,
    int nrows, int antialias, float m, float* wn, float* ws) {
  using E = Entry<kLinear, StepT<InT, HypT>>;
  if constexpr (kIsBf16<StepT<InT, HypT>>) {
    accumulate_bf16<kStrip, KS, kLinear>(win, fov, S_rt, pitch, k0, nrows,
                                         antialias, m, wn, ws);
  } else {
    const int S = KS > 0 ? KS : S_rt;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = fov.row(s) - k0;
      if (kStrip && (r < 0 || r >= nrows)) continue;
      const E* wrow = win + r * pitch;
      const float dx = fov.dxs(s);
#pragma unroll
      for (int t = 0; t < S; ++t) {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const E p = wrow[fov.col(v, t)];
          const float dy = fov.dyt(v, t);
          float w;
          if constexpr (kLinear) {              // {n, alpha}
            w = fmaxf(lin(p.y, dx, fov.mxs(s)), 0.0f) *
                fmaxf(lin(p.y, dy, fov.myt(v, t)), 0.0f);
          } else {                              // {n, 2 rho, sx, sy}
            const float a = p.z * dx;
            const float b = p.w * dy;
            const float xn = a * a;
            const float yn = b * b;
            const float xy = a * p.w * dy;
            w = expf(-0.5f * (xn - p.y * xy + yn));
          }
          if (antialias) w = m * w;
          wn[v] += w * p.x;
          ws[v] += w;
        }
      }
    }
  }
}

// geo: rows [OH, S] / cols [OW, S] (source indices, may fall outside the
// image), the mode's distances and masks.  hyper_c: codes a pixel (3, or 1
// in the linear mode).  scale: the Gaussian antialias's m * distance.
// InT: int (feature 0..norm, codes), float (feature, hyper maps in
// [0, 1]) or bf16 (the same in bf16); HypT the maps' type, bf16 beside a
// float feature or float beside a bf16 one.
template <int KS, typename OutT, bool kLinear, typename InT,
          typename HypT = InT>
__global__ void __launch_bounds__(kMaxThreads) steering_resize_kernel(
    const InT* __restrict__ img,      // [C, H, W] feature
    const HypT* __restrict__ codes,   // [C, H, W, hyper_c] codes or maps
    OutT* __restrict__ out,           // [C, OH, OW] float32 or uint8
    const Geo geo, int H, int W, int OH, int OW, int S_rt, int tile_h,
    int tile_w, int strip, int pitch, int vec_ok, int antialias, int scale,
    float m, float max_sigma, float norm) {
  extern __shared__ __align__(16) unsigned char smem[];
  using E = Entry<kLinear, StepT<InT, HypT>>;
  E* win = reinterpret_cast<E*>(smem);
  if constexpr (kIsBf16<InT>) m = bfr(m);   // lerf_tpu's bf16 min_scale
  const int S = KS > 0 ? KS : S_rt;
  const int hyper_c = kLinear ? 1 : 3;
  const int c = blockIdx.z;
  const int i0 = blockIdx.y * tile_h, j0 = blockIdx.x * tile_w;
  const int i_end = min(i0 + tile_h, OH) - 1;   // the tile's last row
  const int j_end = min(j0 + tile_w, OW) - 1;   // and column
  const int r_lo = geo.rows[i0 * S], c_lo = geo.cols[j0 * S];
  const int wr = geo.rows[i_end * S + S - 1] - r_lo + 1;
  const int wc = geo.cols[j_end * S + S - 1] - c_lo + 1;
  const InT* x = img + (size_t)c * H * W;
  const HypT* hyp = codes + (size_t)c * H * W * hyper_c;
  // the whole window fits in shared memory: always for S 2 and 4 (a
  // one-output window of 4 x 4 fits, so the host's tile holds its whole
  // window), else unless the window is walked in strips of rows (S >= 121)
  const bool whole = KS > 0 || wr <= strip;

  // 1. the source window (or its first strip), decoded once
  load_window<kLinear, InT>(win, x, hyp, r_lo, c_lo, 0, whole ? wr : strip,
                            wc, pitch, H, W, norm, max_sigma);
  __syncthreads();

  // 2. kVec outputs of one row a thread (reading the field of view before
  // the window measured 3 % slower: more registers); threads past the
  // tile's edge still load the later strips
  const int i = i0 + threadIdx.y;
  const int jb = j0 + kVec * threadIdx.x;
  const bool active = i <= i_end && jb <= j_end;
  if (whole && !active) return;
  int j[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) j[v] = min(jb + v, j_end);
  FovOf<KS, kLinear, InT, HypT> fov;
  fov.load(geo, min(i, i_end), j, r_lo, c_lo, S, scale, m);

  // 3. the weighted sums, s-major, t-minor (the strips run in row order,
  // and a thread's rows rise with s)
  float wn[kVec], ws[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) wn[v] = ws[v] = 0.0f;
  if (whole) {
    accumulate<false, KS, kLinear, InT, HypT>(win, fov, S, pitch, 0, wr,
                                              antialias, m, wn, ws);
  } else {
    for (int k0 = 0;;) {
      accumulate<true, KS, kLinear, InT, HypT>(win, fov, S, pitch, k0,
                                               min(strip, wr - k0), antialias,
                                               m, wn, ws);
      k0 += strip;
      if (k0 >= wr) break;
      __syncthreads();
      load_window<kLinear, InT>(win, x, hyp, r_lo, c_lo, k0,
                                min(strip, wr - k0), wc, pitch, H, W, norm,
                                max_sigma);
      __syncthreads();
    }
    if (!active) return;
  }

  // 4. epilogue
  OutT o[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v)
    o[v] = finish(quotient<kLinear, StepT<InT, HypT>>(wn[v], ws[v]), norm,
                  out);
  OutT* dst = out + ((size_t)c * OH + i) * OW + jb;
  if (vec_ok && jb + kVec - 1 <= j_end) {
    store_vec(dst, o);
  } else {
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      if (jb + v <= j_end) dst[v] = o[v];
  }
}

// The launch parameters every instantiation shares.
struct Launch {
  const void* img;
  const void* codes;
  void* out;
  Geo geo;
  int C, H, W, OH, OW, S, tile_h, tile_w, strip, pitch, smem, antialias,
      scale;
  float m, max_sigma, norm;
};

template <int KS, typename OutT, bool kLinear, typename InT,
          typename HypT = InT>
cudaError_t launch(const Launch& a, cudaStream_t stream) {
  auto kernel = steering_resize_kernel<KS, OutT, kLinear, InT, HypT>;
  if (a.smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.OW + a.tile_w - 1) / a.tile_w,
                  (a.OH + a.tile_h - 1) / a.tile_h, a.C);
  const dim3 block((a.tile_w + kVec - 1) / kVec, a.tile_h);
  const int vec_ok = a.OW % kVec == 0 && a.tile_w % kVec == 0;
  kernel<<<grid, block, a.smem, stream>>>(
      (const InT*)a.img, (const HypT*)a.codes, (OutT*)a.out, a.geo, a.H, a.W,
      a.OH, a.OW, a.S, a.tile_h, a.tile_w, a.strip, a.pitch, vec_ok,
      a.antialias, a.scale, a.m, a.max_sigma, a.norm);
  return cudaGetLastError();
}

template <typename OutT, bool kLinear, typename InT, typename HypT = InT>
cudaError_t dispatch(const Launch& a, cudaStream_t stream) {
  switch (a.S) {
    case 2:
      return launch<2, OutT, kLinear, InT, HypT>(a, stream);
    case 4:
      return launch<4, OutT, kLinear, InT, HypT>(a, stream);
    default:
      return launch<0, OutT, kLinear, InT, HypT>(a, stream);
  }
}

template <bool kLinear, typename InT, typename HypT = InT>
cudaError_t dispatch_out(const Launch& a, int out_u8, cudaStream_t stream) {
  return out_u8 ? dispatch<unsigned char, kLinear, InT, HypT>(a, stream)
                : dispatch<float, kLinear, InT, HypT>(a, stream);
}

template <bool kLinear>
cudaError_t dispatch_mode(const Launch& a, int out_u8, int in_type,
                          cudaStream_t stream) {
  switch (in_type) {
    case 1:
      return dispatch_out<kLinear, float>(a, out_u8, stream);
    case 2:
      return dispatch_out<kLinear, bf16>(a, out_u8, stream);
    case 3:
      return dispatch_out<kLinear, float, bf16>(a, out_u8, stream);
    case 5:
      return dispatch_out<kLinear, bf16, float>(a, out_u8, stream);
    default:
      return dispatch_out<kLinear, int>(a, out_u8, stream);
  }
}

}  // namespace

// tile_h x tile_w outputs a block.  win_cols: the widest source window of
// any tile of this geometry; win_rows: the source rows a block holds in
// shared memory at once, the tallest window's where it fits (the host
// computes both), else fewer, and the kernel walks a taller window in strips
// of win_rows rows.  linear: 0 the steerable Gaussian (codes [C, H, W, 3],
// dis_* the float32 distances, scaled by min_scale here when antialias), 1
// the amplified-linear kernel (codes [C, H, W, 1], dis_* float32(min_scale
// * dis), mask_* their float64 branch bits [O, S] uint8).  out_u8: 1 writes
// uint8 clip(rint(.), 0, norm) (norm <= 255), 0 float32 (for bf16 inputs
// the bf16 quotient, widened).  in_type: 0 img int32 feature and codes
// int32 codes (code / norm), 1 img float32 feature and codes float32 hyper
// maps in [0, 1], 2 the same in bf16, 3 img float32 and codes bf16 maps,
// 5 img bf16 and codes float32 maps (4 is the rings warp's alone); the
// last argument, after the stream, so that a caller written for the entry
// without it still calls the int32 kernels.
extern "C" int lerf_steering_resize(
    const void* img, const void* codes, void* out, const void* rows,
    const void* cols, const void* dis_x, const void* dis_y,
    const void* mask_x, const void* mask_y, int C, int H, int W, int OH,
    int OW, int S, int antialias, int linear, float min_scale,
    float max_sigma, float norm, int tile_h, int tile_w,
    int win_rows, int win_cols, int out_u8, void* stream, int in_type) {
  if ((long long)C * OH * OW == 0) return 0;
  if (S < 1 || tile_h < 1 || tile_w < 1 || win_rows < 1 || win_cols < 1 ||
      C > 65535 || (OH + tile_h - 1) / tile_h > 65535 ||
      ((tile_w + kVec - 1) / kVec) * tile_h > kMaxThreads ||
      (out_u8 && !(norm <= 255.0f)) ||
      (linear && (mask_x == nullptr || mask_y == nullptr)) || in_type < 0 ||
      in_type > 5 || in_type == 4)
    return (int)cudaErrorInvalidValue;
  const long long entry = in_type == 2
                              ? (linear ? sizeof(Bf2) : sizeof(Bf4))
                              : (linear ? sizeof(float2) : sizeof(float4));
  const long long smem = (long long)win_rows * win_cols * entry;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  const Launch a{img, codes, out,
                 {(const int*)rows, (const int*)cols, (const float*)dis_x,
                  (const float*)dis_y, (const unsigned char*)mask_x,
                  (const unsigned char*)mask_y},
                 C, H, W, OH, OW, S, tile_h, tile_w, win_rows, win_cols,
                 (int)smem, antialias, antialias && !linear, min_scale,
                 max_sigma, norm};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(linear ? dispatch_mode<true>(a, out_u8, in_type, s)
                      : dispatch_mode<false>(a, out_u8, in_type, s));
}
