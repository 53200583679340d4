// K6: the steerable resize's backward (the training step's), for sm_90a.
//
// Replaces: no TPU kernel.  On the TPU it is XLA's autodiff of
// lerf_tpu/ops/resample.py::steering_gaussian_resize /
// amplified_linear_resize inside jax.value_and_grad
// (lerf_tpu/train/train_step.py:111-128,163).  The forward is K1's float
// mode (float32 feature and hyper maps in [0, 1], float32 out).  K6 takes
// dL/dout and gives dL/dfeature and dL/dhyper: (rho, sx, sy) maps for the
// steerable Gaussian, the alpha map for the amplified-linear kernel.
//
// The math.  For output o with weights w_ok over its S x S window k:
// out_o = sum_k w_ok f_k / W_o, W_o = sum_k w_ok, so
//   dL/df_k     = sum_o P_o w_ok,                   P_o = g_o / W_o
//   dL/dtheta_k = sum_o (P_o f_k - Q_o) dw_ok/dtheta_k,  Q_o = P_o out_o
// with, for the Gaussian (a = sx dx, b = sy dy): dw/drho = w a b,
// dw/dsx = w dx (rho b - a), dw/dsy = w dy (rho a - b); then x 2 (rho),
// x max_sigma (sx, sy) for the decode.  For the linear kernel, w =
// max(lin_x, 0) max(lin_y, 0) with dlin/dalpha = x on the negative branch,
// -x on the positive one, passed where lin >= 0 (torch.clamp's
// convention), then x 2.  The weights are K1's own float operations in
// K1's order (no FMA contraction: the library builds with --fmad=false).
// Like K1 (and unlike K5) the resize keeps subnormal weights.
//
// The design: deterministic, no atomics, two passes.
// - Pass 1, a thread an output: recompute W_o and out_o over the window
//   (the sums in K1's s-major, t-minor order, so out_o is K1's) and write
//   P_o and Q_o.
// - Pass 2, a thread a source pixel and channel: gather over the outputs
//   whose window holds the pixel.  The field of view is separable and
//   monotone (rows[i, s] = rows[i, 0] + s, rows[i, 0] non-decreasing), so
//   the outputs that read source row r are one range of output rows,
//   [inv_rows[r].x, inv_rows[r].y), with s = r - rows[i, 0]; the host
//   builds these per-axis inverse lists with the geometry.  A border pixel
//   also gathers the pad positions that copy it (the hyper maps pad by
//   edge replication): they send a hyper gradient with f = 0 and no
//   feature gradient (the image pads with zeros).  Each thread sums its
//   terms in one fixed order and writes its own outputs, so a rerun gives
//   the same bits.
//
// What bounds it on the H100: neither pass is near the card's rates at the
// training shapes (16 x 48 x 48 -> x4: it moves ~3.5 MB and evaluates 2.4
// M weights); two launches of a few microseconds each, so the launches
// bound it.  A simple kernel that is right comes first.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The geometry's device arrays, as K1 takes them: rows / cols [O, S] in
// unpadded source coordinates, the mode's float32 distances [O, S] and in
// the linear mode the branch bits (bit 0 negative, bit 1 positive).
struct Geo {
  const int* rows;
  const int* cols;
  const float* dis_x;
  const float* dis_y;
  const unsigned char* mask_x;
  const unsigned char* mask_y;
};

// The launch parameters both passes share.
struct Shape {
  int C, H, W, OH, OW, S, antialias, scale;
  float m, max_sigma;
};

// One decoded hyper value: the Gaussian's {2 rho, sx, sy} as K1 stores it,
// or the linear kernel's alpha in .x.
template <bool kLinear>
__device__ __forceinline__ float3 decode(const float* hyp, size_t pix,
                                         float max_sigma) {
  if constexpr (kLinear) {
    return make_float3(hyp[pix] * 2.0f - 1.0f, 0.0f, 0.0f);
  } else {
    const float* h = hyp + pix * 3;
    const float rho = h[0] * 2.0f - 1.0f;
    return make_float3(2.0f * rho, h[1] * max_sigma, h[2] * max_sigma);
  }
}

// K1's branch of the amplified-linear kernel and its derivative in alpha.
__device__ __forceinline__ float lin(float a, float x, unsigned mask) {
  const float ax = a * x;
  return (mask & 1u) ? ax + 1.0f : ((mask & 2u) ? 1.0f - ax : 0.0f);
}
__device__ __forceinline__ float dlin(float x, unsigned mask) {
  return (mask & 1u) ? x : ((mask & 2u) ? -x : 0.0f);
}

// The distance of output i's s-th neighbour: K1's m * dis in the Gaussian
// antialias ("scale"), else the distance as given.
__device__ __forceinline__ float dist(const float* dis, int k, int scale,
                                      float m) {
  return scale ? m * dis[k] : dis[k];
}

// The Gaussian weight, K1's operations in K1's order.
__device__ __forceinline__ float gauss(float3 h, float dx, float dy,
                                       int antialias, float m, float* a,
                                       float* b) {
  *a = h.y * dx;
  *b = h.z * dy;
  const float xn = *a * *a;
  const float yn = *b * *b;
  const float xy = *a * h.z * dy;
  const float w = expf(-0.5f * (xn - h.x * xy + yn));
  return antialias ? m * w : w;
}

// Pass 1: a thread an output o = (c, i, j).  P_o = g_o / W_o, Q_o = P_o
// out_o.
template <bool kLinear>
__global__ void __launch_bounds__(kThreads) resize_bwd_out_kernel(
    const float* __restrict__ img, const float* __restrict__ hyp,
    const float* __restrict__ grad, float* __restrict__ p_out,
    float* __restrict__ q_out, const Geo geo, const Shape a) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)a.C * a.OH * a.OW;
  if (idx >= total) return;
  const int j = (int)(idx % a.OW);
  const int i = (int)((idx / a.OW) % a.OH);
  const int c = (int)(idx / ((long long)a.OH * a.OW));
  const int hc = kLinear ? 1 : 3;
  const float* x = img + (size_t)c * a.H * a.W;
  const float* hy = hyp + (size_t)c * a.H * a.W * hc;
  float wn = 0.0f, ws = 0.0f;
  for (int s = 0; s < a.S; ++s) {
    const int r = geo.rows[i * a.S + s];
    const int rc = min(max(r, 0), a.H - 1);
    const float dx = dist(geo.dis_x, i * a.S + s, a.scale, a.m);
    for (int t = 0; t < a.S; ++t) {
      const int q = geo.cols[j * a.S + t];
      const int qc = min(max(q, 0), a.W - 1);
      const float dy = dist(geo.dis_y, j * a.S + t, a.scale, a.m);
      const float n = (r >= 0 && r < a.H && q >= 0 && q < a.W)
                          ? x[(size_t)r * a.W + q] : 0.0f;
      const float3 h = decode<kLinear>(hy, (size_t)rc * a.W + qc,
                                       a.max_sigma);
      float w;
      if constexpr (kLinear) {
        w = fmaxf(lin(h.x, dx, geo.mask_x[i * a.S + s]), 0.0f) *
            fmaxf(lin(h.x, dy, geo.mask_y[j * a.S + t]), 0.0f);
        if (a.antialias) w = a.m * w;
      } else {
        float ga, gb;
        w = gauss(h, dx, dy, a.antialias, a.m, &ga, &gb);
      }
      wn += w * n;
      ws += w;
    }
  }
  const float p = grad[idx] / ws;
  p_out[idx] = p;
  q_out[idx] = p * (wn / ws);
}

// Pass 2: a thread a source pixel (c, y, x).  Virtual source rows (and
// columns) run over the pads too: the pixel gathers its own row y and, on
// the first or last row, the pad rows that copy it; inv_rows[r - r_min] is
// the range of output rows that read virtual row r.
template <bool kLinear>
__global__ void __launch_bounds__(kThreads) resize_bwd_src_kernel(
    const float* __restrict__ img, const float* __restrict__ hyp,
    const float* __restrict__ p_in, const float* __restrict__ q_in,
    float* __restrict__ grad_img, float* __restrict__ grad_hyp,
    const Geo geo, const int2* __restrict__ inv_rows,
    const int2* __restrict__ inv_cols, int r_min, int n_r, int c_min,
    int n_c, const Shape a) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)a.C * a.H * a.W;
  if (idx >= total) return;
  const int x = (int)(idx % a.W);
  const int y = (int)((idx / a.W) % a.H);
  const int c = (int)(idx / ((long long)a.H * a.W));
  const float f = img[idx];
  const float3 h = decode<kLinear>(hyp, (size_t)idx, a.max_sigma);
  const float rho = 0.5f * h.x;              // exact: h.x = 2 rho
  const int r_lo = y == 0 ? min(r_min, 0) : y;
  const int r_hi = y == a.H - 1 ? max(r_min + n_r - 1, y) : y;
  const int q_lo = x == 0 ? min(c_min, 0) : x;
  const int q_hi = x == a.W - 1 ? max(c_min + n_c - 1, x) : x;
  const size_t plane = (size_t)c * a.OH * a.OW;
  float gf = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
  for (int r = r_lo; r <= r_hi; ++r) {
    if (r - r_min < 0 || r - r_min >= n_r) continue;
    const int2 ir = inv_rows[r - r_min];
    for (int i = ir.x; i < ir.y; ++i) {
      const int ks = i * a.S + (r - geo.rows[i * a.S]);
      const float dx = dist(geo.dis_x, ks, a.scale, a.m);
      const unsigned mx = kLinear ? geo.mask_x[ks] : 0u;
      for (int q = q_lo; q <= q_hi; ++q) {
        if (q - c_min < 0 || q - c_min >= n_c) continue;
        const int2 iq = inv_cols[q - c_min];
        const bool inside = r == y && q == x;
        const float n = inside ? f : 0.0f;
        for (int j = iq.x; j < iq.y; ++j) {
          const int kt = j * a.S + (q - geo.cols[j * a.S]);
          const float dy = dist(geo.dis_y, kt, a.scale, a.m);
          const size_t o = plane + (size_t)i * a.OW + j;
          const float p = p_in[o];
          const float coef = p * n - q_in[o];
          if constexpr (kLinear) {
            const unsigned my = geo.mask_y[kt];
            const float lx = lin(h.x, dx, mx), ly = lin(h.x, dy, my);
            const float cx = fmaxf(lx, 0.0f), cy = fmaxf(ly, 0.0f);
            float w = cx * cy;
            float dw = (lx >= 0.0f ? dlin(dx, mx) * cy : 0.0f) +
                       (ly >= 0.0f ? cx * dlin(dy, my) : 0.0f);
            if (a.antialias) {
              w = a.m * w;
              dw = a.m * dw;
            }
            if (inside) gf += p * w;
            g0 += coef * dw;
          } else {
            float ga, gb;
            const float w = gauss(h, dx, dy, a.antialias, a.m, &ga, &gb);
            if (inside) gf += p * w;
            g0 += coef * (w * ga * gb);
            g1 += coef * (w * dx * (rho * gb - ga));
            g2 += coef * (w * dy * (rho * ga - gb));
          }
        }
      }
    }
  }
  grad_img[idx] = gf;
  if constexpr (kLinear) {
    grad_hyp[idx] = 2.0f * g0;
  } else {
    grad_hyp[idx * 3] = 2.0f * g0;
    grad_hyp[idx * 3 + 1] = a.max_sigma * g1;
    grad_hyp[idx * 3 + 2] = a.max_sigma * g2;
  }
}

template <bool kLinear>
cudaError_t launch(const void* img, const void* hyp, const void* grad,
                   void* p_buf, void* q_buf, void* grad_img, void* grad_hyp,
                   const Geo& geo, const int2* inv_rows, const int2* inv_cols,
                   int r_min, int n_r, int c_min, int n_c, const Shape& a,
                   cudaStream_t stream) {
  const long long n_out = (long long)a.C * a.OH * a.OW;
  const long long n_src = (long long)a.C * a.H * a.W;
  resize_bwd_out_kernel<kLinear>
      <<<(unsigned)((n_out + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>((const float*)img, (const float*)hyp, (const float*)grad,
                   (float*)p_buf, (float*)q_buf, geo, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  resize_bwd_src_kernel<kLinear>
      <<<(unsigned)((n_src + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>((const float*)img, (const float*)hyp,
                   (const float*)p_buf, (const float*)q_buf,
                   (float*)grad_img, (float*)grad_hyp, geo, inv_rows,
                   inv_cols, r_min, n_r, c_min, n_c, a);
  return cudaGetLastError();
}

}  // namespace

// img [C, H, W] float32 feature, hyp [C, H, W, 3] (Gaussian) or [C, H, W,
// 1] (linear) float32 maps in [0, 1], grad [C, OH, OW] dL/dout; p_buf /
// q_buf [C, OH, OW] float32 scratch; grad_img / grad_hyp the outputs, in
// img's / hyp's shapes.  rows / cols [O, S] int32 and the distances (and
// linear masks) as K1 takes them (kernels/resize.ResizeOperands);
// inv_rows [n_r, 2] / inv_cols [n_c, 2] int32: for virtual source row
// r_min + k, the range [lo, hi) of output rows whose window holds it.
extern "C" int lerf_steering_resize_bwd(
    const void* img, const void* hyp, const void* grad, void* p_buf,
    void* q_buf, void* grad_img, void* grad_hyp, const void* rows,
    const void* cols, const void* dis_x, const void* dis_y,
    const void* mask_x, const void* mask_y, const void* inv_rows,
    const void* inv_cols, int r_min, int n_r, int c_min, int n_c, int C,
    int H, int W, int OH, int OW, int S, int antialias, int linear,
    float min_scale, float max_sigma, void* stream) {
  if ((long long)C * H * W == 0 || (long long)C * OH * OW == 0) return 0;
  if (S < 1 || n_r < 1 || n_c < 1 ||
      (linear && (mask_x == nullptr || mask_y == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Geo geo{(const int*)rows, (const int*)cols, (const float*)dis_x,
                (const float*)dis_y, (const unsigned char*)mask_x,
                (const unsigned char*)mask_y};
  const Shape a{C, H, W, OH, OW, S, antialias, antialias && !linear,
                min_scale, max_sigma};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(linear
                   ? launch<true>(img, hyp, grad, p_buf, q_buf, grad_img,
                                  grad_hyp, geo, (const int2*)inv_rows,
                                  (const int2*)inv_cols, r_min, n_r, c_min,
                                  n_c, a, s)
                   : launch<false>(img, hyp, grad, p_buf, q_buf, grad_img,
                                   grad_hyp, geo, (const int2*)inv_rows,
                                   (const int2*)inv_cols, r_min, n_r, c_min,
                                   n_c, a, s));
}
