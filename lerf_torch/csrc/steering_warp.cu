// K5: steerable homographic warp from the stage-2 codes, for sm_90a.
//
// Replaces: the warp of lerf_tpu/ops/resample.py::steering_gaussian_warp
// (u8_inputs=True) and ::amplified_linear_warp, which on the TPU is no Pallas
// kernel but an XLA row gather (_rowpack_warp_gather) followed by some twenty
// elementwise passes, the float64 host geometry it gathers through
// (lerf_tpu/ops/geometry.py::_warp_grid / _warp_axis), and the NaN -> 0
// uint8 epilogue of lerf_tpu/pipeline.py::_quantize_device(nan_to_zero=True).
// The plain PyTorch twins are lerf_torch/ops/resample.py::
// steering_warp_codes_plain (the warp) and lerf_torch/ops/geometry.py::
// warp_operands_plain (the geometry).
//
// What bounds it on the H100: instruction issue, not bytes.  At 3x360x640 ->
// 1440x2560 the function reads 11 MB of int32 feature and codes and writes
// 11 MB of uint8 (0.0066 ms at 3.35 TB/s); its float32 work, 12
// neighbour-channels an output at a weight and an expf each, takes 0.010 ms
// at 67 T/s, its float64 geometry 0.0027 ms at 34 T/s.  The first design
// (lerf_torch/tools/steering_warp_first.cu) read 24 bytes of host geometry
// an output (88 MB) and decoded every gathered neighbour's codes with three
// IEEE divisions (36 an output): 0.186 ms on an H100 80GB HBM3 at 700 W,
// its float32 output as fast as its uint8 one.  This design measures
// 0.113 ms there with its register cap, 0.126 without; from that 0.126,
// the direct path in every block takes 0.212, windows from integer
// arithmetic instead of the float64 geometry 0.098, no expf 0.117, the
// host's operands read instead of the geometry 0.131
// (lerf_torch/tools/probe_lut_kernels.py): the per-neighbour decode and
// the float64 geometry were the costs, the operand bytes hardly.
//
// What the design does about it:
// - No geometry from the host.  Each thread derives its outputs' window
//   rows, columns and distances from the nine float64 entries of the
//   inverse homography and the two pads, in the operation order of
//   _warp_grid / _warp_axis: each step one IEEE double operation (__dmul_rn,
//   __dadd_rn, __dsub_rn, __ddiv_rn: no contraction into FMA whatever the
//   flags), the distances cast to float32 once (__double2float_rn), so they
//   are the host's bit for bit.  Two float64 divisions and some thirty
//   other float64 operations an output, on the FP64 pipe.  The column's
//   terms are computed once a thread.  lerf_warp_geometry writes the same
//   values as the host's per-pixel operands, for the checks only.
// - The source tile decoded once.  A block owns a 16 x 32 output tile
//   (256 threads, two rows a thread).  It reduces its windows to the
//   footprint rectangle in padded coordinates; where that rectangle times C
//   fits kTileEntries, the block loads it once, coalesced, decoded into
//   shared memory as float4 {feature, 2 rho, sx, sy} with the twin's float
//   operations (code / norm * 2 - 1, code / norm * max_sigma; 2 rho is
//   exact): padded row or column -1 is the pad, feature 0 (constant pad)
//   and the codes of row / column 0 (edge pad).  The neighbour loop then
//   reads shared memory only: three divisions a source pixel instead of
//   three a neighbour.
// - Blocks whose footprint does not fit (strong minification, or near the
//   horizon of a projective map) take the direct path in the same kernel:
//   each neighbour decoded from global memory, as the first design did.
// - All C channels in one block, so the geometry is derived once an output;
//   a warp writes 32 adjacent outputs of a row (one 32-byte sector in
//   uint8).
// - Any support S, at run time (the deploy form's 2 compiled with its
//   windows in registers; any other S derives each row, column and distance
//   where it is used).  The footprint grows with S, and a block whose
//   footprint exceeds the tile takes the direct path.
// - The amplified-linear mode (LeRF-L): one code a pixel, decoded into a
//   float2 {feature, alpha} tile entry as alpha = code / norm * 2 - 1
//   (max_alpha 1); the weight max(lin(alpha, dx), 0) * max(lin(alpha, dy), 0),
//   lin(a, x) = a x + 1 on the negative branch, 1 - a x on the positive one,
//   0 off both.  The branches are those of the reference's float64 masks:
//   evaluated here on the float64 distance before its one cast to float32,
//   the same double the host's geometry holds, so they are the host masks
//   of lerf_tpu's _branch_masks bit for bit, with no per-pixel operand.
// - The validity mask (lerf_tpu/ops/resample.py::nearest_warp_mask_on_device,
//   and the static warp's in-program nearest_warp_mask), where asked for:
//   the support-1 axis of _warp_axis on the same float64 grid, reduced to
//   the one test that can fail (inside()), one byte an output, bit-equal
//   to the host's float64 mask.  A null mask skips it at run time, a
//   branch uniform over the launch.
// - Float inputs (the IMDN form: lerf_tpu's float-row warp,
//   steering_gaussian_warp(u8_inputs=False)): float32 feature and float32
//   hyper maps in [0, 1], decoded as h * 2 - 1 and h * max_sigma where the
//   int32 path divides its code by norm first.  The input type is a
//   template parameter of the tile fill and the direct path's decode alone;
//   the int32 instantiations are the code they were before.
// - bf16 inputs (the IMDN form's bf16 compute type, lerf_tpu's
//   IMDN2(dtype=bfloat16)): bf16 feature and hyper maps, lerf_tpu's warp run
//   in img.dtype = bf16 (_warp_dis_flat(geom, img.dtype)), whose plain twin
//   is the port's steering_gaussian_warp / amplified_linear_warp on bf16
//   tensors.  The geometry stays float64, one IEEE step at a time; only the
//   final distance is cast, float64 -> float32 -> bf16, as PyTorch casts the
//   host's float64 distances.  Every operation of the twin rounds to bf16,
//   in the twin's order: the decode (max_sigma rounded to bf16 first), each
//   step of the Gaussian weight and its expf, the flush below FLT_MIN; at
//   support 2 (the twin's four-block path) each add of the sums and the
//   quotient; at any other support (its torch.sum of bf16 products,
//   accumulated in float32) each product, the two sums once, then the
//   quotient.  The linear mode's float32 branch masks promote its weight
//   to float32: a x and lin(a, x) round to bf16, the rest is float32.  The
//   tile holds bf16 entries, half the float ones.  A float32 feature with
//   bf16 maps (the bf16 form without its feature tower, two_stage=False)
//   decodes the maps in bf16 and runs the rest in float32, as lerf_tpu's
//   promotion against its float32 distances does (template parameter
//   HypT).  A bf16 feature with float32 maps is lerf_tpu's warp with
//   img.dtype = bf16 beside float32 maps: the distances cast float64 ->
//   float32 -> bf16 (its _warp_dis_flat(geom, img.dtype)), the maps decoded
//   in float32, the weights, the flush, the sums and the quotient float32;
//   the feature read as bf16 and widened in registers, into float entries
//   (Window's kBfDis, template parameters InT = bf16, HypT = float).
//   Each bf16 step runs as one native bf16 instruction on a pair of values
//   (__hmul2_rn, __hadd2_rn, __hsub2_rn), which gives the twin's float
//   operation rounded to bf16 bit for bit: every operand is a bf16 value
//   and float32's 24 bits exceed twice bf16's 8 plus 2, so float-then-round
//   is the correctly rounded bf16 result.  0 mismatches over all 2^32
//   operand pairs a step on the card, both lanes
//   (lerf_torch/tools/bf16_steps_exhaustive.cu; also the HFMA2 forms a x 1
//   + b and a x b + (-0) in which ptxas emits some of them).  No other
//   fused form: __hfma rounds a x b + c once where the twin rounds twice.
//   The pair is the thread's two rows (sums_bf16): the tile entries of the
//   two neighbours transposed into (n, n'), (2 rho, 2 rho'), ...
//   (weight_pair), the distances rounded to bf16 once a thread at support
//   2 (at others once where each is derived); the flush tests the float32
//   exp against 2^-126 - 2^-134, the midpoint that rounds up to FLT_MIN,
//   before its one rounding.  Its times: PERF.md section 6
//   (lerf_torch/tools/probe_lut_kernels.py --k5).
// - A frames axis (the jax.vmap of lerf_tpu/pipeline.py::_warp_batch_fn):
//   blockIdx.z is the frame, each with its own inverse and pads from a
//   small array passed by value; the frames share the sizes, the support
//   and the mode.  A single frame is a batch of one.
// - A window of output rows (lerf_tpu/parallel/spatial.py's row-sharded
//   warps, whose shards each take a slab of output rows): a launch
//   computes rows [row0, row0 + rows) of the whole output and writes them
//   as its rows 0 .. rows - 1; each window, weight and mask bit is derived
//   for the global row row0 + i with the same float64 steps, so a window
//   is bit-equal to the same rows of the whole launch.  The grid covers
//   the window's rows (Warp::OH is the window's height; the whole
//   output's bounds the window on the host).  A first version kept the
//   window's height in a field of its own beside the whole output's: 3 %
//   slower on the main path; this one is within 0.3 % of the kernel
//   without the window (NVIDIA H100 80GB HBM3, 700.00 W;
//   lerf_torch/tools/probe_lut_kernels.py, PERF.md).
// - The warp's geometry as data (lerf_tpu/ops/resample.py::
//   steering_gaussian_warp_rings / amplified_linear_warp_rings, on the TPU
//   an XLA row gather from a corner-indexed packed operand and the weighted
//   sums): the rings instance (steering_warp_rings_kernel, C entry
//   lerf_steering_warp_rings) takes lerf_torch/ops/resample.py::WarpRings
//   in place of the matrix: each output's window is rows ring_x[corner /
//   (W + 3) + s], columns ring_y[corner % (W + 3) + t] of the +-1-padded
//   planes (0 and H + 1 the pad rows: fetch's kEdges), its float32
//   distances and, linear, the host's float64 branch masks packed in one
//   byte.  Its bound is bytes, 20 of rings an output (74 MB at 1440 x
//   2560: 0.029 ms at 3.35 TB/s), above its float32 work; what holds it
//   is latency.  Its first design (lerf_torch/tools/steering_warp_rings_
//   first.cu, the matrix instances' block with the windows loaded) waits
//   on three global round trips and three barriers a block, one after the
//   other, at four blocks an SM.  This design (the section "the rings
//   instance" below): persistent blocks walk the tiles; each thread
//   copies its own outputs' rings two tiles ahead (cp.async) and adds its
//   outputs of the next tile to that tile's footprint, so one barrier a
//   tile completes a footprint and a second the decoded tile; a tile too
//   wide for the tile takes the direct path, each neighbour from global
//   memory; the sums are the matrix instances' functions.  On an H100
//   80GB HBM3 at 700 W it measured 1.5-3 % faster than the first design
//   on the LUT form's codes under a homography and a radial grid, 19 %
//   slower on a grid whose tiles all take the direct path.  A
//   producer warp that streams each tile's rings and source box into
//   shared memory ahead of 8 consumer warps, on mbarriers
//   (lerf_torch/tools/steering_warp_rings_producer.cu), measured slower
//   than both: the one producer warp serialises the loads it was to hide
//   (PERF.md section 6, lerf_torch/tools/probe_lut_kernels.py --rings).
//   corner / (W + 3) is a multiply by a reciprocal, exact for every corner
//   (divider).
//   Support 2, every input pair; the rings' type sets the
//   weights' as lerf_tpu's promotion does, so bf16 inputs under float32
//   rings take the float32 steps on their bf16 entries widened (in_type
//   4), and only bf16 rings the bf16 steps.  The matrix instances' SASS is
//   the parent source's (the probe's --k5 --sass).  Times: PERF.md
//   section 6 (lerf_torch/tools/probe_lut_kernels.py --rings).
//   warp_rings_geometry_kernel (lerf_warp_rings_geometry) writes a
//   homography's rings from the same float64 derivation, equal to the
//   host's.
// Semantics, those of the JAX path's geometry (_warp_axis): a pixel's S
// rows are clip(left + s, 0, H - 1) in padded coordinates, left = ceil((g -
// S/2) - eps) + pad_r, clipped to the UNPADDED bounds, and its source row is
// that minus pad_r (0 .. S/2); a negative source row is a pad row.
// Neighbours run s-major, t-minor ((0,0), (0,1), (1,0), (1,1) at S = 2); the
// Gaussian weight is exp(-0.5 * ((sx dx)^2 - 2 rho (sx dx)(sy dy) +
// (sy dy)^2)) in the plain twin's operation order, flushed to 0 below
// FLT_MIN (the reference backends flush subnormals, so such a window is 0/0
// = NaN there; a linear weight is 0 or at least 2^-48, never subnormal);
// one division at the end.  Built without fast math and without
// FMA contraction, so each float32 operation is a single IEEE operation as
// in the twin; expf may differ from PyTorch's exp by a few ulp.  A
// projection 0/0 (output on the horizon line through the origin) is NaN on
// the host and clips to 0 here.
#include <atomic>
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

// The type of the tile's entries and of the steps: bf16 where the feature
// and the maps both are, else float32 (a bf16 feature or bf16 maps beside
// float32 ones widen exactly into float32 entries).
template <typename InT, typename HypT>
using CompT = typename std::conditional<kIsBf16<InT> && kIsBf16<HypT>, bf16,
                                        float>::type;

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
constexpr int kMaxFrames = 16;              // frames a batch launch takes

// One homography's geometry, by value: the inverse matrix row-major, the
// unpadded input and the output sizes, the leading pads, the support; and
// the first output row a launch computes, row0: its OH rows are the whole
// output's rows [row0, row0 + OH), written as its rows 0 .. OH - 1.
struct Warp {
  double m[9];
  int H, W, OH, OW, pad_r, pad_c, S;
  int row0;
};

// A batch of homographies: frame f's warp, and the validity mask [frames,
// OH, OW] (uint8 0 / 1) of the white frame's border, or null.  1.7 KB of
// the 4 KB of kernel parameters.
struct Frames {
  Warp f[kMaxFrames];
  unsigned char* mask;
  int border;
};

// The terms of _warp_grid that depend on the output column j only:
// inv[k, 0] * x + inv[k, 2] for the denominator and both numerators.
struct Column {
  double den, num_x, num_y;
};

__device__ __forceinline__ Column column_terms(const Warp& w, int j) {
  const double x = (double)j;
  return {__dadd_rn(__dmul_rn(w.m[6], x), w.m[8]),
          __dadd_rn(__dmul_rn(w.m[0], x), w.m[2]),
          __dadd_rn(__dmul_rn(w.m[3], x), w.m[5])};
}

// _warp_axis on one coordinate: g = clip(src, 0, n), left = ceil((g - S/2)
// - eps) + pad, f_s = clip(left + s, 0, n - 1), d_s = (g + pad) - f_s in
// float64 (the host's dis), cast to float32 once where it is used.
struct Axis {
  int left, n;
  double gp;                                // g + pad
  __device__ int at(int s) const { return min(max(left + s, 0), n - 1); }
  __device__ double d(int s) const { return __dsub_rn(gp, (double)at(s)); }
};

__device__ __forceinline__ Axis axis(double src, int n, int pad, int S) {
  const double g = fmin(fmax(src, 0.0), (double)n);
  return {(int)ceil(__dsub_rn(__dsub_rn(g, 0.5 * S), kEps)) + pad, n,
          __dadd_rn(g, (double)pad)};
}

// The linear kernel's branch of a float64 distance, as _branch_masks:
// bit 0 for -1 <= d < 0, bit 1 for 0 <= d <= 1.
__device__ __forceinline__ unsigned branch(double d) {
  return (-1.0 <= d && d < 0.0) ? 1u : ((0.0 <= d && d <= 1.0) ? 2u : 0u);
}

// A distance cast once from its float64 value: to float32, and with
// kBfDis (a bf16 feature beside float32 maps) on to bf16, widened back.
template <bool kBfDis>
__device__ __forceinline__ float cast_dis(double d) {
  if constexpr (kBfDis) return bfr(__double2float_rn(d));
  return __double2float_rn(d);
}

// One output's window.  KS > 0: the support known at compile time, its
// S rows, columns and float32 distances in registers, and where kBits (the
// linear mode) the 2S branches two bits each in one word (rows from bit 0,
// columns from bit 2 KS): the Gaussian mode evaluates no branch.  kBfDis:
// the distances in bf16 (cast_dis); the branches are the float64 ones.
template <int KS, bool kBits, bool kBfDis = false>
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
      d[s] = cast_dis<kBfDis>(d64);
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

// Any other support: the two axes, each value derived where it is used.
template <bool kBits, bool kBfDis>
struct Window<0, kBits, kBfDis> {
  Axis ar, ac;
  int S;

  __device__ void set(double sy, double sx, const Warp& w) {
    ar = axis(sy, w.H, w.pad_r, w.S);
    ac = axis(sx, w.W, w.pad_c, w.S);
    S = w.S;
  }
  __device__ int support() const { return S; }
  __device__ int row(int s) const { return ar.at(s); }
  __device__ int col(int t) const { return ac.at(t); }
  __device__ float dxs(int s) const { return cast_dis<kBfDis>(ar.d(s)); }
  __device__ float dyt(int t) const { return cast_dis<kBfDis>(ac.d(t)); }
  __device__ unsigned bxs(int s) const { return branch(ar.d(s)); }
  __device__ unsigned byt(int t) const { return branch(ac.d(t)); }
};

// _warp_grid at output (i, j): den = (i20 x + i22) + i21 y, src = (...) /
// den; x the column coordinate, y the row one (before the clip).
struct Source {
  double x, y;
};

__device__ __forceinline__ Source source_at(const Warp& w, const Column& col,
                                            int i) {
  const double y = (double)i;
  const double den = __dadd_rn(col.den, __dmul_rn(w.m[7], y));
  return {__ddiv_rn(__dadd_rn(col.num_x, __dmul_rn(w.m[1], y)), den),
          __ddiv_rn(__dadd_rn(col.num_y, __dmul_rn(w.m[4], y)), den)};
}

// The window at output (i, j): the row from src_y, the column from src_x.
template <int KS, bool kBits, bool kBfDis = false>
__device__ __forceinline__ Window<KS, kBits, kBfDis> window_at(
    const Warp& w, const Column& col, int i) {
  const Source src = source_at(w, col, i);
  Window<KS, kBits, kBfDis> p;
  p.set(src.y, src.x, w);
  return p;
}

// The validity mask on one axis: the support-1 box warp of the
// border-zeroed white frame (_mask_from_grid) on g = clip(src, 0, n).
// There ceil((g - 0.5) - eps) >= 0, so _warp_axis's leading pad is 0, and
// the distance to the clipped row f = min(ceil((g - 0.5) - eps), n - 1)
// lies in [-1, 1], where the box is 1: the output is inside where f lands
// on a white row, [border, n - 1 - border].  A NaN coordinate (0/0 on the
// horizon) is outside, as the host's NaN compares.
__device__ __forceinline__ bool inside(double src, int n, int border) {
  if (isnan(src)) return false;
  const double g = fmin(fmax(src, 0.0), (double)n);
  const int f = min((int)ceil(__dsub_rn(__dsub_rn(g, 0.5), kEps)), n - 1);
  return f >= border && f <= n - 1 - border;
}

// The mask bit of an output whose grid point is src: both axes inside.
__device__ __forceinline__ unsigned char valid_at(const Source& src,
                                                  const Warp& w, int border) {
  return inside(src.y, w.H, border) && inside(src.x, w.W, border);
}

// The tile entry: {feature, 2 rho, sx, sy} or, linear, {feature, alpha};
// float32, or for bf16 inputs bf16 (Entry<kLinear, CompT<InT, HypT>>).
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
__device__ __forceinline__ Entry<kLinear, CompT<InT, HypT>> decode(
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
    const HypT* code = codes + e * 3;
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
__device__ __forceinline__ Entry<kLinear, CompT<InT, HypT>> fetch(
    const InT* img, const HypT* codes, int c, int sr, int sc, int H, int W,
    float norm, float max_sigma) {
  if constexpr (kEdges) {
    Entry<kLinear, CompT<InT, HypT>> v = decode<kLinear, InT>(
        img, codes, c, min(sr, H - 1), min(sc, W - 1), H, W, norm, max_sigma);
    if (sr >= H || sc >= W) {
      if constexpr (kIsBf16<CompT<InT, HypT>>)
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

// sums_bf16_at for the block's own tile (blockIdx.x, blockIdx.y).
template <int KS, typename OutT, bool kLinear, bool kEdges = false>
__device__ __forceinline__ void sums_bf16(
    Window<KS, kLinear>* px, const bool* ok,
    const Entry<kLinear, bf16>* tile, bool shared, int r_lo, int c_lo,
    int nr, int nc, const bf16* __restrict__ img,
    const bf16* __restrict__ codes, OutT* __restrict__ out, const Warp& w,
    int C, float max_sigma, float norm) {
  sums_bf16_at<KS, OutT, kLinear, kEdges>(
      px, ok, tile, shared, r_lo, c_lo, nr, nc, img, codes, out, w, C,
      max_sigma, norm, blockIdx.y * kTileH + threadIdx.y,
      blockIdx.x * kTileW + threadIdx.x);
}

// At least kMinBlocks blocks an SM: registers capped at 64 (80 uncapped,
// three blocks an SM), which measured 10 % faster; six blocks (40) slower
// (lerf_torch/tools/probe_lut_kernels.py).
// One block's outputs of one frame, and the frame's validity mask [OH, OW]
// where mask is not null.  InT: int (feature 0..norm, codes), float
// (feature, hyper maps in [0, 1]) or bf16 (the same in bf16); HypT the
// maps' type, bf16 beside a float feature or float beside a bf16 one (its
// distances in bf16: Window's kBfDis).  The rings instance
// (steering_warp_rings_kernel) shares the functions of steps 3 and 4
// (decode through fetch, weight, weight_pair, weight_bf16, quotient,
// finish, sums_bf16_at) and the tile's layout, not the steps themselves:
// it reads its windows from its own copies of the rings, completes each
// footprint with one barrier and walks many tiles a block.
template <int KS, typename OutT, bool kLinear, typename InT, typename HypT>
__device__ __forceinline__ void warp_block(
    const InT* __restrict__ img,     // [C, H, W] feature
    const HypT* __restrict__ codes,  // [C, H, W, 3 or 1] codes or maps
    OutT* __restrict__ out,          // [C, OH, OW] float32 or uint8
    const Warp& w, int C, float max_sigma, float norm,
    unsigned char* __restrict__ mask, int border) {
  using E = Entry<kLinear, CompT<InT, HypT>>;
  constexpr bool kBfDis = kIsBf16<InT> && !kIsBf16<HypT>;
  __shared__ E tile[kTileEntries];        // [C][rows][cols]
  __shared__ int box[4];                  // row min, max, column min, max
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int j = blockIdx.x * kTileW + threadIdx.x;

  // 1. this thread's windows, from the matrix in float64
  const Column col = column_terms(w, min(j, w.OW - 1));
  Window<KS, kLinear, kBfDis> px[kRowsPerThread];
  bool ok[kRowsPerThread];
  int rmin = INT_MAX, rmax = INT_MIN, cmin = INT_MAX, cmax = INT_MIN;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = blockIdx.y * kTileH + threadIdx.y + k * kThreadRows;
    ok[k] = j < w.OW && i < w.OH;
    if (!ok[k]) continue;
    const Source src = source_at(w, col, w.row0 + i);   // window and mask
    px[k].set(src.y, src.x, w);
    if (mask != nullptr)
      mask[(size_t)i * w.OW + j] = valid_at(src, w, border);
    const int S = px[k].support();
    rmin = min(rmin, px[k].row(0));
    rmax = max(rmax, px[k].row(S - 1));
    cmin = min(cmin, px[k].col(0));
    cmax = max(cmax, px[k].col(S - 1));
  }

  // 2. the block's footprint: the rectangle of padded rows and columns its
  // windows read
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
  const bool shared = (long long)nr * nc * C <= kTileEntries;  // block-uniform

  // 3. the footprint decoded once into shared memory, where it fits
  if (shared) {
    const int plane = nr * nc;
    for (int e = tid; e < plane * C; e += kTileW * kThreadRows) {
      const int c = e / plane;
      const int rc = e - c * plane;
      const int r = rc / nc;
      tile[e] = decode<kLinear, InT>(img, codes, c, r_lo + r - w.pad_r,
                                c_lo + (rc - r * nc) - w.pad_c, w.H, w.W,
                                norm, max_sigma);
    }
    __syncthreads();
  }

  // 4. the weighted sums, s-major, t-minor, and the epilogue
  if constexpr (kIsBf16<CompT<InT, HypT>>) {
    sums_bf16<KS, OutT, kLinear>(px, ok, tile, shared, r_lo, c_lo, nr, nc,
                                 img, codes, out, w, C, max_sigma, norm);
  } else {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      if (!ok[k]) continue;
      const Window<KS, kLinear, kBfDis>& p = px[k];
      const int S = p.support();
      const int i = blockIdx.y * kTileH + threadIdx.y + k * kThreadRows;
      for (int c = 0; c < C; ++c) {
        float wn = 0.0f, ws = 0.0f;
        // each row, distance and branch read where it is used: hoisted out
        // of the t loop they cost the support-2 path about 2 %
        // (lerf_torch/tools/probe_lut_kernels.py)
#pragma unroll
        for (int s = 0; s < S; ++s) {
#pragma unroll
          for (int t = 0; t < S; ++t) {
            const E v =
                shared
                    ? tile[(c * nr + p.row(s) - r_lo) * nc + p.col(t) - c_lo]
                    : decode<kLinear, InT>(img, codes, c, p.row(s) - w.pad_r,
                                           p.col(t) - w.pad_c, w.H, w.W,
                                           norm, max_sigma);
            const float wt =
                weight(v, p.dxs(s), p.dyt(t), p.bxs(s), p.byt(t));
            wn += wt * v.x;
            ws += wt;
          }
        }
        out[((size_t)c * w.OH + i) * w.OW + j] =
            finish(quotient<kLinear, CompT<InT, HypT>>(wn, ws, S), norm,
                   out);
      }
    }
  }
}

// Frame blockIdx.z of a batch: img [frames, C, H, W], codes [frames, C, H,
// W, 3 or 1], out [frames, C, rows, OW] (the window's rows), the warp from
// the by-value array (__grid_constant__: indexed in place, never copied).
template <int KS, typename OutT, bool kLinear, typename InT,
          typename HypT = InT>
__global__ void __launch_bounds__(kTileW * kThreadRows, kMinBlocks)
    steering_warp_kernel(const InT* __restrict__ img,
                         const HypT* __restrict__ codes,
                         OutT* __restrict__ out,
                         const __grid_constant__ Frames fr, int C,
                         float max_sigma, float norm) {
  const int f = blockIdx.z;
  const Warp& w = fr.f[f];
  const size_t plane = (size_t)w.H * w.W, out_plane = (size_t)w.OH * w.OW;
  warp_block<KS, OutT, kLinear, InT, HypT>(
      img + f * C * plane, codes + f * C * plane * (kLinear ? 1 : 3),
      out + f * C * out_plane, w, C, max_sigma, norm,
      fr.mask == nullptr ? nullptr : fr.mask + f * out_plane, fr.border);
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
// gives (lerf_tpu promotes bf16 maps against float32 distances).  The
// rings' distances are their own, in every instance: no cast to the
// feature's type (lerf_tpu's rings carry theirs).
template <bool kLinear, typename InT, typename HypT, bool kWide>
using RingT = typename std::conditional<kWide, float, CompT<InT, HypT>>::type;

template <bool kLinear, typename InT, typename HypT, bool kWide>
using RingEntry = Entry<kLinear, RingT<kLinear, InT, HypT, kWide>>;

template <bool kLinear, typename InT, bool kWide, typename HypT>
__device__ __forceinline__ RingEntry<kLinear, InT, HypT, kWide> ring_entry(
    const InT* img, const HypT* codes, int c, int sr, int sc, int H, int W,
    float norm, float max_sigma) {
  const Entry<kLinear, CompT<InT, HypT>> v = fetch<kLinear, InT, true>(
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

// -- the rings instance: a persistent, pipelined block -----------------------
//
// kRingsBlocks blocks an SM, each walking the frame's 16 x 32 output tiles
// in a static stride (tile t = blockIdx.x + k gridDim.x); thread (x, y)
// owns the outputs of tile rows y and y + 8, column x, as warp_block's.
// While the block sums tile k, each thread's copies of its own outputs'
// rings of tile k + 2 (corner, distances, the linear mode's branch word)
// are in flight into one of two stages, by cp.async: asynchronous, no
// register holds them, and the thread's own data, so no barrier orders
// them.  At the start of tile k each thread waits for its own copies,
// reads its windows of tile k and adds its outputs' windows of tile k + 1
// to that tile's footprint (warp reductions, four shared atomics a warp;
// with monotone ring maps from the extreme ring positions alone); one
// barrier completes the footprint and frees the tile; the block decodes
// tile k's footprint into the tile from global memory (warp_block's
// step 3; the source, 11 MB at 3 x 360 x 640, fits in L2) and, after a
// second barrier, sums (the sums, s-major, t-minor, weight, weight_pair,
// weight_bf16, quotient and finish are warp_block's functions).  A tile
// whose footprint exceeds kTileEntries takes the direct path: each
// neighbour from global memory (ring_entry).  Unlike the producer-warp
// design (lerf_torch/tools/steering_warp_rings_producer.cu) no warp copies
// for the others and no mbarrier tracks the copies: each thread waits for
// its own (cp.async.wait_all), and the source box is read after the
// footprint's barrier, from L2, not staged ahead: staging it cost more
// than it hid.
constexpr int kRingsThreads = kTileW * kThreadRows;   // 256
// blocks an SM: __launch_bounds__ holds a thread to 80 registers so that
// they fit, and 3 x 57,408 bytes of shared memory fit an SM's 228 KB
constexpr int kRingsBlocks = 3;
constexpr int kSlots = kTileH * kTileW;               // a stage's outputs
constexpr int kMapInts = 1024;        // ring maps held in shared memory
constexpr int kHeadBytes = 64;        // three footprints in the making

// A stage: per output of the tile its corner, dis_x, dis_y and, linear,
// the 4-byte word that holds its branch byte.
__host__ __device__ constexpr int stage_bytes(bool linear) {
  return kSlots * (4 + 2 * 8 + (linear ? 4 : 0));
}

// Dynamic shared memory of an instance whose tile entry takes entry_bytes:
// the footprints, two stages, the tile and, where they fit, the ring maps
// (map_ints: H + W + 8, or 0).  At most 57,408 bytes.
__host__ __device__ constexpr int rings_smem(int entry_bytes, bool linear,
                                             int map_ints) {
  return kHeadBytes + 2 * stage_bytes(linear) + kTileEntries * entry_bytes +
         4 * map_ints;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's cp.async copies landed
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// floor(n / d) for 0 <= n < 2^22 and 1 <= d < 2^24 from rcp = 1.0f / d:
// (n + 0.5) / d lies at least 0.5 / d from every integer, and the two
// roundings err by at most (n + 0.5) / d 2^-23 < 0.5 / d.
__device__ __forceinline__ int small_div(int n, float rcp) {
  return (int)(((float)n + 0.5f) * rcp);
}

// The branch byte bits[n] into *to, at its place in the 4-byte word that
// holds it: the word copied asynchronously where it lies inside bits[0 ..
// total), else (at either end of the array) the byte loaded alone.  The
// word starts at most 3 bytes before bits + n, so 3 <= n and n + 4 <=
// total keep it inside whatever the array's alignment.
__device__ __forceinline__ void copy_bits(unsigned* to,
                                          const unsigned char* bits,
                                          size_t n, size_t total) {
  const uintptr_t at = (uintptr_t)(bits + n), word = at & ~(uintptr_t)3;
  if (n >= 3 && n + 4 <= total)
    copy_async<4>(to, (const void*)word);
  else
    *to = (unsigned)bits[n] << (8 * (at & 3));
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

// A stage's arrays.
template <bool kLinear>
struct Stage {
  int* corner;
  float2* dis_x;
  float2* dis_y;
  unsigned* bits;       // linear only
  __device__ explicit Stage(char* p)
      : corner((int*)p),
        dis_x((float2*)(p + 4 * kSlots)),
        dis_y((float2*)(p + 12 * kSlots)),
        bits((unsigned*)(p + 20 * kSlots)) {}
};

// This thread's outputs of tile (ty, tx): output q is tile row
// threadIdx.y + 8 q, its slot in a stage and its index n in the frame.
struct Outputs {
  int i0, j, slot0;
  bool ok[kRowsPerThread];
  __device__ Outputs(const Warp& w, int ty, int tx) {
    i0 = ty * kTileH + threadIdx.y;
    j = tx * kTileW + threadIdx.x;
    slot0 = threadIdx.y * kTileW + threadIdx.x;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q)
      ok[q] = j < w.OW && i0 + q * kThreadRows < w.OH;
  }
  __device__ int slot(int q) const { return slot0 + q * kThreadRows * kTileW; }
  __device__ size_t n(int q, const Warp& w) const {
    return (size_t)(i0 + q * kThreadRows) * w.OW + j;
  }
};

// This thread's copies of its outputs' rings into a stage.
template <bool kLinear>
__device__ __forceinline__ void copy_rings(const Rings& g, const Outputs& o,
                                           Stage<kLinear> st) {
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    if (!o.ok[q]) continue;
    const size_t n = o.n(q, g.w);
    const int k = o.slot(q);
    copy_async<4>(st.corner + k, g.corner + n);
    copy_async<8>(st.dis_x + k, g.dis_x + n);
    copy_async<8>(st.dis_y + k, g.dis_y + n);
    if constexpr (kLinear)
      copy_bits(st.bits + k, g.bits, n, (size_t)g.w.OH * g.w.OW);
  }
}

// This thread's windows from a stage.
template <bool kLinear>
__device__ __forceinline__ void read_windows(const Rings& g, const Outputs& o,
                                             Stage<kLinear> st, const int* rx,
                                             const int* ry,
                                             Window<2, kLinear>* px) {
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    if (!o.ok[q]) continue;
    const int k = o.slot(q);
    ring_window(px[q], st.corner[k], rx, ry, g);
    const float2 dx = st.dis_x[k], dy = st.dis_y[k];
    px[q].dx[0] = dx.x;
    px[q].dx[1] = dx.y;
    px[q].dy[0] = dy.x;
    px[q].dy[1] = dy.y;
    px[q].bits = 0u;
    if constexpr (kLinear)
      px[q].bits =
          (st.bits[k] >> (8 * ((uintptr_t)(g.bits + o.n(q, g.w)) & 3))) &
          0xffu;
  }
}

// This thread's outputs' windows added to a footprint (row min, max,
// column min, max in shared memory): a warp's reduced, then four atomics.
// With monotone ring maps the windows' extremes are the rings at the
// extreme corners' ring positions, so only those are looked up.
template <bool kLinear>
__device__ __forceinline__ void add_footprint(const Rings& g,
                                              const Outputs& o,
                                              Stage<kLinear> st,
                                              const int* rx, const int* ry,
                                              bool monotone, int* box) {
  const Warp& w = g.w;
  const int stride = w.W + 3;
  int rmin = INT_MAX, rmax = INT_MIN, cmin = INT_MAX, cmax = INT_MIN;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    if (!o.ok[q]) continue;
    if (monotone) {
      const int c =
          min(max(st.corner[o.slot(q)], 0), (w.H + 3) * stride - 1);
      const int cx = g.stride(c), cy = c - cx * stride;
      rmin = min(rmin, cx);
      rmax = max(rmax, cx + 1);
      cmin = min(cmin, cy);
      cmax = max(cmax, cy + 1);
    } else {
      Window<2, false> p;
      ring_window(p, st.corner[o.slot(q)], rx, ry, g);
      rmin = min(rmin, min(p.r[0], p.r[1]));
      rmax = max(rmax, max(p.r[0], p.r[1]));
      cmin = min(cmin, min(p.q[0], p.q[1]));
      cmax = max(cmax, max(p.q[0], p.q[1]));
    }
  }
  rmin = __reduce_min_sync(0xffffffffu, rmin);
  rmax = __reduce_max_sync(0xffffffffu, rmax);
  cmin = __reduce_min_sync(0xffffffffu, cmin);
  cmax = __reduce_max_sync(0xffffffffu, cmax);
  if (threadIdx.x == 0 && rmin != INT_MAX) {     // the warp has outputs
    if (monotone) {           // ring positions to rows and columns
      rmin = min(max(rx[rmin], 0), w.H + 1);
      rmax = min(max(rx[rmax], 0), w.H + 1);
      cmin = min(max(ry[cmin], 0), w.W + 1);
      cmax = min(max(ry[cmax], 0), w.W + 1);
    }
    atomicMin(box, rmin);
    atomicMax(box + 1, rmax);
    atomicMin(box + 2, cmin);
    atomicMax(box + 3, cmax);
  }
}

__device__ __forceinline__ void reset_footprint(int* box) {
  box[0] = box[2] = INT_MAX;
  box[1] = box[3] = INT_MIN;
}

// The tile's footprint: rows r_lo .. r_lo + nr - 1 and columns c_lo ..
// c_lo + nc - 1 of the padded planes; whether it fits the tile.
struct Box {
  int shared, r_lo, c_lo, nr, nc;
};

__device__ __forceinline__ Box box_of(const int* fp, int C) {
  Box b;
  b.r_lo = fp[0];
  b.c_lo = fp[2];
  b.nr = fp[1] - fp[0] + 1;
  b.nc = fp[3] - fp[2] + 1;
  b.shared = (long long)C * b.nr * b.nc <= kTileEntries;
  return b;
}

// The block's decode of box b into the tile (entry e: channel c, plane
// row r_lo + r, column c_lo + q), from global memory (ring_entry).
template <bool kLinear, typename InT, bool kWide, typename HypT>
__device__ __forceinline__ void decode_tile(
    const InT* img, const HypT* codes, const Box& b, const Warp& w, int C,
    RingEntry<kLinear, InT, HypT, kWide>* tile, float norm, float max_sigma,
    int tid) {
  const int plane = b.nr * b.nc;
  const float rcp_plane = 1.0f / (float)plane, rcp_nc = 1.0f / (float)b.nc;
  for (int e = tid; e < C * plane; e += kRingsThreads) {
    const int c = small_div(e, rcp_plane);
    const int rc = e - c * plane;
    const int r = small_div(rc, rcp_nc);
    tile[e] = ring_entry<kLinear, InT, kWide>(
        img, codes, c, b.r_lo + r - 1, b.c_lo + (rc - r * b.nc) - 1, w.H,
        w.W, norm, max_sigma);
  }
}

// The float32 sums of the thread's two outputs, rows i0 and i0 + 8 of
// column j (warp_block's step 4 at support 2, its functions), each
// output's in warp_block's order.  On the tile's path kSumRows outputs a
// channel at a time, so that their neighbours are in flight together, each
// neighbour's place in a plane of the tile found once; on the direct path
// each neighbour from global memory, one output at a time.
constexpr int kSumRows = 2;

template <typename OutT, bool kLinear, typename InT, typename HypT,
          bool kWide>
__device__ __forceinline__ void sums_f32(
    const Window<2, kLinear>* px, const bool* ok,
    const RingEntry<kLinear, InT, HypT, kWide>* tile, const Box& b,
    const InT* __restrict__ img, const HypT* __restrict__ codes,
    OutT* __restrict__ out, const Warp& w, int C, float max_sigma,
    float norm, int i0, int j) {
  using E = RingEntry<kLinear, InT, HypT, kWide>;
  static_assert(kRowsPerThread == 2, "a thread's two rows");
  // past the bottom edge the second row repeats the first, not written
  // (selected, not indexed at run time: the windows stay in registers)
  const Window<2, kLinear> pw[2] = {px[0], ok[1] ? px[1] : px[0]};
  // the weighted sums and the epilogue of channel c of row k
  auto channel = [&](int c, int k, const E* v) {
    const Window<2, kLinear>& p = pw[k];
    float wn = 0.0f, ws = 0.0f;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const E& e = v[2 * s + t];
        const float wt = weight(e, p.dx[s], p.dy[t], p.bxs(s), p.byt(t));
        wn += wt * e.x;
        ws += wt;
      }
    }
    if (ok[k])
      out[((size_t)c * w.OH + i0 + k * kThreadRows) * w.OW + j] =
          finish(quotient<kLinear, RingT<kLinear, InT, HypT, kWide>>(
                     wn, ws, 2),
                 norm, out);
  };
  if (b.shared) {
    if (!ok[0]) return;
    const int plane = b.nr * b.nc;
#pragma unroll
    for (int k0 = 0; k0 < kRowsPerThread; k0 += kSumRows) {
      if (!ok[k0]) return;
      int at[kSumRows][4];    // each neighbour's place in a plane of the tile
#pragma unroll
      for (int k = 0; k < kSumRows; ++k)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          at[k][n] = (pw[k0 + k].r[n / 2] - b.r_lo) * b.nc +
                     pw[k0 + k].q[n % 2] - b.c_lo;
      for (int c = 0; c < C; ++c) {
        E v[kSumRows][4];
#pragma unroll
        for (int k = 0; k < kSumRows; ++k)
#pragma unroll
          for (int n = 0; n < 4; ++n) v[k][n] = tile[c * plane + at[k][n]];
#pragma unroll
        for (int k = 0; k < kSumRows; ++k) channel(c, k0 + k, v[k]);
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (!ok[k]) return;
    const Window<2, kLinear>& p = pw[k];
    for (int c = 0; c < C; ++c) {
      E v[4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
        v[n] = ring_entry<kLinear, InT, kWide>(img, codes, c, p.r[n / 2] - 1,
                                               p.q[n % 2] - 1, w.H, w.W,
                                               norm, max_sigma);
      channel(c, k, v);
    }
  }
}

// K5's rings instance (the design above).  kWide: bf16 inputs under float32
// rings, the float32 steps on widened entries; a bf16 feature beside
// float32 maps takes float entries under either rings type.  out [C, OH,
// OW]; map_ints: H + W + 8 where the ring maps are held in shared memory,
// else 0.
template <typename OutT, bool kLinear, typename InT, typename HypT = InT,
          bool kWide = false>
__global__ void __launch_bounds__(kRingsThreads, kRingsBlocks)
    steering_warp_rings_kernel(const InT* __restrict__ img,
                               const HypT* __restrict__ codes,
                               OutT* __restrict__ out,
                               const __grid_constant__ Rings g, int C,
                               float max_sigma, float norm, int map_ints) {
  using E = RingEntry<kLinear, InT, HypT, kWide>;
  extern __shared__ __align__(16) char smem[];
  int(*fp)[4] = reinterpret_cast<int(*)[4]>(smem);   // 3 footprints
  char* stages = smem + kHeadBytes;
  E* tile = (E*)(stages + 2 * stage_bytes(kLinear));
  int* maps = (int*)(tile + kTileEntries);
  const Warp& w = g.w;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  auto stage = [&](int k) {
    return Stage<kLinear>(stages + (k % 2) * stage_bytes(kLinear));
  };

  const int ntx = (w.OW + kTileW - 1) / kTileW;
  const int tiles = ntx * ((w.OH + kTileH - 1) / kTileH);
  const int n = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                (int)gridDim.x;
  if (n <= 0) return;
  const float rcp_ntx = 1.0f / (float)ntx;
  auto outputs = [&](int k) {
    const int t = blockIdx.x + k * gridDim.x;
    const int ty = tiles < (1 << 22) ? small_div(t, rcp_ntx) : t / ntx;
    return Outputs(w, ty, t - ty * ntx);
  };

  // the ring maps, whether they are monotone, and the footprints
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
  if (tid < 3) reset_footprint(fp[tid]);
  const bool monotone = __syncthreads_and(up);

  // tile 0's rings and footprint, tile 1's rings
  copy_rings(g, outputs(0), stage(0));
  if (n > 1) copy_rings(g, outputs(1), stage(1));
  copies_commit();
  copies_wait();
  add_footprint(g, outputs(0), stage(0), rx, ry, monotone, fp[0]);
  __syncthreads();
  Box b = box_of(fp[0], C);

  for (int k = 0; k < n; ++k) {
    const Outputs o = outputs(k);
    copies_wait();                  // tile k + 1's rings
    Window<2, kLinear> px[kRowsPerThread];
    read_windows(g, o, stage(k), rx, ry, px);
    if (k + 1 < n)
      add_footprint(g, outputs(k + 1), stage(k + 1), rx, ry, monotone,
                    fp[(k + 1) % 3]);
    __syncthreads();                // the footprint, the tile is free
    if (tid == 0) reset_footprint(fp[(k + 2) % 3]);
    const Box next = box_of(fp[(k + 1) % 3], C);
    if (k + 2 < n) copy_rings(g, outputs(k + 2), stage(k));
    copies_commit();
    if (b.shared)
      decode_tile<kLinear, InT, kWide, HypT>(img, codes, b, w, C, tile, norm,
                                             max_sigma, tid);
    __syncthreads();                // the tile is whole
    if constexpr (kIsBf16<RingT<kLinear, InT, HypT, kWide>>) {
      sums_bf16_at<2, OutT, kLinear, true>(
          px, o.ok, tile, b.shared, b.r_lo, b.c_lo, b.nr, b.nc, img, codes,
          out, w, C, max_sigma, norm, (unsigned)o.i0, o.j);
    } else {
      sums_f32<OutT, kLinear, InT, HypT, kWide>(px, o.ok, tile, b, img,
                                                codes, out, w, C, max_sigma,
                                                norm, o.i0, o.j);
    }
    b = next;
  }
}

// The rings of one homography from the derivation the matrix instances
// make (window_at), at support 2: per output the ring position of its
// first neighbour on each axis, left + 1 with left the UNCLIPPED window
// start ceil((g - 1) - eps) + pad, as corner = (left_r + 1) (W + 3) +
// (left_c + 1), and its float32 distances; equal to the host's
// warp_rings(WarpOperands.create(...)) (lerf_torch/ops/geometry.py::
// _serving_axis).
__global__ void __launch_bounds__(kTileW * kThreadRows)
    warp_rings_geometry_kernel(int* __restrict__ corner,
                               float2* __restrict__ dis_x,
                               float2* __restrict__ dis_y, const Warp w) {
  const int j = blockIdx.x * kTileW + threadIdx.x;
  if (j >= w.OW) return;
  const Column col = column_terms(w, j);
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = blockIdx.y * kTileH + threadIdx.y + k * kThreadRows;
    if (i >= w.OH) return;
    const size_t n = (size_t)i * w.OW + j;
    const Window<0, false> p = window_at<0, false>(w, col, i);
    corner[n] = (p.ar.left + 1) * (w.W + 3) + (p.ac.left + 1);
    dis_x[n] = make_float2(p.dxs(0), p.dxs(1));
    dis_y[n] = make_float2(p.dyt(0), p.dyt(1));
  }
}

// The per-pixel geometry of the host's WarpOperands from window_at: the
// window corner (row, col) as geometry.window_corner recovers it from the
// clipped indices (f_0 where above 0, else f_S-1 - (S - 1)), the 2S
// distances (dx_0..dx_S-1, dy_0..dy_S-1) and their float64 branch bits;
// and the validity mask (valid_at) where valid is not null, for output
// rows [row0, row0 + rows), written as rows 0 .. rows - 1.  Null corners:
// the mask alone.
__global__ void __launch_bounds__(kTileW * kThreadRows) warp_geometry_kernel(
    int2* __restrict__ corners, float* __restrict__ dis,
    unsigned char* __restrict__ masks, unsigned char* __restrict__ valid,
    const Warp w, int border) {
  const int j = blockIdx.x * kTileW + threadIdx.x;
  if (j >= w.OW) return;
  const Column col = column_terms(w, j);
  const int S = w.S;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = blockIdx.y * kTileH + threadIdx.y + k * kThreadRows;
    if (i >= w.OH) return;
    const size_t n = (size_t)i * w.OW + j;
    if (valid != nullptr)
      valid[n] = valid_at(source_at(w, col, w.row0 + i), w, border);
    if (corners == nullptr) continue;
    const Window<0, true> p = window_at<0, true>(w, col, w.row0 + i);
    corners[n] = make_int2(
        p.row(0) == 0 ? p.row(S - 1) - (S - 1) : p.row(0),
        p.col(0) == 0 ? p.col(S - 1) - (S - 1) : p.col(0));
    for (int s = 0; s < S; ++s) {
      dis[n * 2 * S + s] = p.dxs(s);
      dis[n * 2 * S + S + s] = p.dyt(s);
      masks[n * 2 * S + s] = (unsigned char)p.bxs(s);
      masks[n * 2 * S + S + s] = (unsigned char)p.byt(s);
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

template <typename OutT, bool kLinear, typename InT, typename HypT = InT>
void launch(const void* img, const void* codes, void* out, const Frames& fr,
            int frames, int C, float max_sigma, float norm, cudaStream_t s) {
  const dim3 block(kTileW, kThreadRows);
  dim3 grid = grid_of(fr.f[0]);
  grid.z = frames;
  if (fr.f[0].S == 2)
    steering_warp_kernel<2, OutT, kLinear, InT, HypT><<<grid, block, 0, s>>>(
        (const InT*)img, (const HypT*)codes, (OutT*)out, fr, C, max_sigma,
        norm);
  else
    steering_warp_kernel<0, OutT, kLinear, InT, HypT><<<grid, block, 0, s>>>(
        (const InT*)img, (const HypT*)codes, (OutT*)out, fr, C, max_sigma,
        norm);
}

template <bool kLinear, typename InT, typename HypT = InT>
void launch_out(const void* img, const void* codes, void* out,
                const Frames& fr, int frames, int C, float max_sigma,
                float norm, int out_u8, cudaStream_t s) {
  if (out_u8)
    launch<unsigned char, kLinear, InT, HypT>(img, codes, out, fr, frames, C,
                                              max_sigma, norm, s);
  else
    launch<float, kLinear, InT, HypT>(img, codes, out, fr, frames, C,
                                      max_sigma, norm, s);
}

template <bool kLinear>
void launch_in(const void* img, const void* codes, void* out,
               const Frames& fr, int frames, int C, float max_sigma,
               float norm, int out_u8, int in_type, cudaStream_t s) {
  if (in_type == 1)
    launch_out<kLinear, float>(img, codes, out, fr, frames, C, max_sigma,
                               norm, out_u8, s);
  else if (in_type == 2)
    launch_out<kLinear, bf16>(img, codes, out, fr, frames, C, max_sigma,
                              norm, out_u8, s);
  else if (in_type == 3)
    launch_out<kLinear, float, bf16>(img, codes, out, fr, frames, C,
                                     max_sigma, norm, out_u8, s);
  else if (in_type == 5)
    launch_out<kLinear, bf16, float>(img, codes, out, fr, frames, C,
                                     max_sigma, norm, out_u8, s);
  else
    launch_out<kLinear, int>(img, codes, out, fr, frames, C, max_sigma, norm,
                             out_u8, s);
}

// One rings launch on stream s: min(tiles, SMs x kRingsBlocks) persistent
// blocks, the SM count asked once a device, the instance's shared-memory
// limit raised once a device.  Returns a CUDA error code.
template <typename OutT, bool kLinear, typename InT, typename HypT,
          bool kWide>
int launch_rings(const void* img, const void* codes, void* out,
                 const Rings& g, int C, float max_sigma, float norm,
                 cudaStream_t s) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> sms_of[kMaxDevices];   // 0: not yet asked
  const auto kernel = steering_warp_rings_kernel<OutT, kLinear, InT, HypT,
                                                 kWide>;
  const int entry = (int)sizeof(RingEntry<kLinear, InT, HypT, kWide>);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int sms = sms_of[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             rings_smem(entry, kLinear, kMapInts))) ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)))
      return (int)err;
    sms_of[dev].store(sms, std::memory_order_relaxed);
  }
  const Warp& w = g.w;
  const long long tiles = (long long)((w.OW + kTileW - 1) / kTileW) *
                          ((w.OH + kTileH - 1) / kTileH);
  const long long blocks = (long long)sms * kRingsBlocks;
  const int grid = (int)(tiles < blocks ? tiles : blocks);
  const int maps = w.H + w.W + 8 <= kMapInts ? w.H + w.W + 8 : 0;
  kernel<<<grid, dim3(kTileW, kThreadRows), rings_smem(entry, kLinear, maps),
           s>>>(
      (const InT*)img, (const HypT*)codes, (OutT*)out, g, C, max_sigma, norm,
      maps);
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
  if (in_type == 5)
    return rings_out<kLinear, bf16, float>(img, codes, out, g, C, max_sigma,
                                           norm, out_u8, s);
  return rings_out<kLinear, int>(img, codes, out, g, C, max_sigma, norm,
                                 out_u8, s);
}

}  // namespace

// K5 over a batch of frames (1 .. kMaxFrames; a single frame is a batch of
// one), frame f with its own inverse homography (invs[9 f .. 9 f + 8],
// row-major float64, host memory, read before the call returns) and the
// geometry's leading pads (pads[2 f], pads[2 f + 1]: pad_r, pad_c).  img
// [frames, C, H, W] (int32, float32 or bf16: in_type), H and W unpadded;
// codes [frames, C, H, W, 3] (linear 0: the steerable Gaussian) or [frames,
// C, H, W, 1] (linear 1: the amplified-linear kernel); out [frames, C, OH, OW]: out_u8 1 writes
// uint8 clip(rint(nan_to_num(.)), 0, norm) (norm <= 255), 0 float32 with
// NaN where a window's weights all vanish (for bf16 inputs the bf16
// quotient, widened).  S: the support.  mask [frames, OH, OW] uint8 0 / 1,
// the validity mask of the white frame's border, written in the same
// launch, or null for none.  in_type: 0 img int32 feature and codes int32
// codes (code / norm), 1 img float32 feature and codes float32 hyper maps
// in [0, 1], 2 the same in bf16, 3 img float32 and codes bf16 maps, 5 img
// bf16 and codes float32 maps (4 is the rings instance's alone); after the
// stream, so that a caller written for the entry without it still calls
// the int32 kernels.  row0, rows: the window of output rows [row0, row0 + rows) of
// the OH x OW output this launch computes (0, OH: all of it); out and mask
// hold the window alone ([frames, C, rows, OW], [frames, rows, OW]), each
// row bit-equal to the same row of the whole launch: the geometry and the
// mask are derived for the global row.
extern "C" int lerf_steering_warp_batch(
    const void* img, const void* codes, void* out, void* mask,
    const double* invs, const int* pads, int frames, int C, int H, int W,
    int OH, int OW, int S, int linear, float max_sigma, float norm,
    int out_u8, int border, void* stream, int in_type, int row0,
    int rows) {
  if (frames < 1 || frames > kMaxFrames || border < 0 || in_type < 0 ||
      in_type > 5 || in_type == 4)
    return (int)cudaErrorInvalidValue;
  if ((long long)C * rows * OW == 0) return 0;
  if (out_u8 && !(norm <= 255.0f)) return (int)cudaErrorInvalidValue;
  Frames fr;
  memset(&fr, 0, sizeof(fr));
  for (int f = 0; f < frames; ++f) {
    int err = make_warp(invs + 9 * f, H, W, OH, OW, pads[2 * f],
                        pads[2 * f + 1], S, row0, rows, &fr.f[f]);
    if (err) return err;
  }
  fr.mask = (unsigned char*)mask;
  fr.border = border;
  cudaStream_t s = (cudaStream_t)stream;
  if (linear)
    launch_in<true>(img, codes, out, fr, frames, C, max_sigma, norm, out_u8,
                    in_type, s);
  else
    launch_in<false>(img, codes, out, fr, frames, C, max_sigma, norm, out_u8,
                     in_type, s);
  return (int)cudaGetLastError();
}

// The geometry K5 derives, written out: corners [OH * OW] int2, dis
// [OH * OW, 2S] float32 and masks [OH * OW, 2S] uint8, as WarpOperands lays
// them out, and valid [OH * OW] uint8 0 / 1, the validity mask of the
// white frame's border; with row0, rows the window [row0, row0 + rows) of
// the output alone ([rows * OW] each).  Either part may be null (corners,
// dis and masks together).  For the checks and the mask alone; K5 does
// not read them.
extern "C" int lerf_warp_geometry(void* corners, void* dis, void* masks,
                                  void* valid, const double* inv, int H,
                                  int W, int OH, int OW, int pad_r,
                                  int pad_c, int S, int border,
                                  void* stream, int row0, int rows) {
  if ((long long)rows * OW == 0) return 0;
  if ((uintptr_t)corners % sizeof(int2) || (uintptr_t)dis % sizeof(float))
    return (int)cudaErrorMisalignedAddress;
  if (border < 0) return (int)cudaErrorInvalidValue;
  Warp w;
  int err = make_warp(inv, H, W, OH, OW, pad_r, pad_c, S, row0, rows, &w);
  if (err) return err;
  warp_geometry_kernel<<<grid_of(w), dim3(kTileW, kThreadRows), 0,
                         (cudaStream_t)stream>>>(
      (int2*)corners, (float*)dis, (unsigned char*)masks,
      (unsigned char*)valid, w, border);
  return (int)cudaGetLastError();
}

// K5's rings instance (lerf_torch/ops/kernels/warp.py::steering_warp_rings):
// the warp of one frame through rings (struct Rings says how), all device
// pointers: ring_x [ring_x_len] and ring_y [ring_y_len] int32, which must be
// H + 4 and W + 4 long; corner [OH * OW] int32; dis_x, dis_y [OH * OW, 2]
// float32 (8-byte aligned); bits [OH * OW] uint8, given in the linear mode
// (linear 1) and null in the Gaussian one.  img, codes, out, the mode, the
// types and the epilogue as lerf_steering_warp_batch takes them, and
// in_type 4: a bf16 feature and bf16 maps under float32 rings (decoded in
// bf16, weighted, summed and divided in float32); in_type 5 (a bf16
// feature, float32 maps) and 3 under rings of either type, their distances
// float32 (bf16 ones widened exactly); support 2.
extern "C" int lerf_steering_warp_rings(
    const void* img, const void* codes, void* out, const void* ring_x,
    int ring_x_len, const void* ring_y, int ring_y_len, const void* corner,
    const void* dis_x, const void* dis_y, const void* bits, int C, int H,
    int W, int OH, int OW, int linear, float max_sigma, float norm,
    int out_u8, void* stream, int in_type) {
  if (H < 1 || W < 1 || C < 0 || OH < 0 || OW < 0 ||
      ring_x_len != H + 4 || ring_y_len != W + 4 || in_type < 0 ||
      in_type > 5 || (linear != 0) != (bits != nullptr) ||
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

// The rings instance's persistent blocks an SM (kRingsBlocks): the grid of
// a launch is min(tiles, SMs x this), which kernels/warp.py::rings_grid
// reads here rather than restating it.
extern "C" int lerf_rings_blocks_per_sm() { return kRingsBlocks; }

// The rings of one homography (warp_rings_geometry_kernel) from its float64
// inverse (host memory) and the support-2 geometry's leading pads: corner
// [OH * OW] int32, dis_x and dis_y [OH * OW, 2] float32 (8-byte aligned).
// The ring maps themselves are the host's (H + 4 and W + 4 values from the
// pads alone).
extern "C" int lerf_warp_rings_geometry(void* corner, void* dis_x,
                                        void* dis_y, const double* inv,
                                        int H, int W, int OH, int OW,
                                        int pad_r, int pad_c, void* stream) {
  if ((long long)OH * OW == 0) return 0;
  if ((uintptr_t)dis_x % sizeof(float2) || (uintptr_t)dis_y % sizeof(float2))
    return (int)cudaErrorMisalignedAddress;
  if ((long long)(H + 3) * (W + 3) > INT_MAX) return (int)cudaErrorInvalidValue;
  Warp w;
  int err = make_warp(inv, H, W, OH, OW, pad_r, pad_c, 2, 0, OH, &w);
  if (err) return err;
  warp_rings_geometry_kernel<<<grid_of(w), dim3(kTileW, kThreadRows), 0,
                               (cudaStream_t)stream>>>(
      (int*)corner, (float2*)dis_x, (float2*)dis_y, w);
  return (int)cudaGetLastError();
}
