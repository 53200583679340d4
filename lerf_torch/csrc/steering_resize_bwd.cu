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
// The design: one launch, deterministic, no atomics.  A block takes one
// tile of source pixels of one plane; the host plans the tiles once per
// geometry (kernels/resize_bwd.plan_tiles): for each band of tile rows
// (and of tile columns) the outputs whose windows touch it, the source
// window those outputs read, and the band's geometry packed as the block
// stages it (distances, window offsets, each virtual row's outputs, the
// linear branch bits).  The field of view is separable and monotone
// (rows[i, s] = rows[i, 0] + s, rows[i, 0] non-decreasing), so each of
// these is one range.
// - Staging, one batch of cp.async copies (one wait for all): the window
//   (feature zero outside the image, hyper maps by edge replication),
//   dL/dout of the touching outputs and both bands' geometry; then the
//   window decoded in place as K1 decodes it.
// - Phase A, a thread an output: W_o and out_o over the window, the sums
//   in K1's s-major, t-minor order so out_o is K1's; P_o and Q_o stay in
//   shared memory.  Outputs in the tile's halo are worked out again by the
//   neighbouring tile: that recompute replaces a round trip of P and Q
//   through device memory and a second launch.
// - Phase B, G lanes a source pixel: the pixel gathers over the outputs
//   whose window holds it (virtual row r's range, s = r - rows[i, 0]);
//   lane l takes the l-th, (l + G)-th, ... output row and every output
//   column, all from shared memory, then the lanes combine by a fixed
//   __shfl_xor_sync butterfly that leaves each writing lane one value.  A
//   border pixel also gathers the pad positions that copy it ("virtual"
//   rows and columns: the hyper maps pad by edge replication): they send
//   a hyper gradient with f = 0 and no feature gradient (the image pads
//   with zeros).  Every sum runs in one fixed order whatever the tile, so
//   a rerun gives the same bits.
//
// What bounds it on the H100: not bytes (at the training shape, 16 x 48 x
// 48 -> x4, it moves ~3.5 MB) but instructions: each output's S x S
// weights are worked out twice (phase A, and phase B for the derivatives)
// in IEEE float32 without FMA contraction, ~25 and ~45 instructions a
// weight, plus the tiles' halo.  The host picks the tile that keeps ~32
// warps on every SM with the least halo (resize_bwd.pick_plan).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;

// One band of tile rows (or columns): the source rows it owns [lo, hi),
// the outputs whose windows touch them [o_lo, o_hi) (pads included: a
// border band owns the pad positions that copy it), the source window
// those outputs read [w_lo, w_lo + w_n), the virtual rows of its pixels
// that outputs read [v_lo, v_lo + n_v), and its geometry in the plan's
// arrays (kernels/resize_bwd.band_geometry): geo_f[f_at ..] the outputs'
// distances [o_hi - o_lo, S]; geo_i[i_at ..] (i_n words) each output's
// window offset (rows[o, 0] - w_lo), then each virtual row's range of
// outputs [lo, hi), then in the linear mode the outputs' branch bits
// [o_hi - o_lo, S].
struct Band {
  int lo, hi, o_lo, o_hi, w_lo, w_n, v_lo, n_v, f_at, i_at, i_n, unused;
};

// The launch's constant arguments, made once per geometry and plane count
// by the host (kernels/resize_bwd.GradOperands) and passed by address.
struct Plan {
  const Band* bands;             // n_ty row bands, then n_tx column bands
  const float* geo_f;
  const int* geo_i;
  int H, W, OH, OW, S;
  int antialias, linear;
  int tile_h, tile_w, group, threads, n_ty, n_tx, smem;
  float min_scale;
};

// The window's entry: {feature, 2 rho, sx, sy}, or {feature, alpha}.
template <bool kLinear>
struct Entry {
  using T = float4;
};
template <>
struct Entry<true> {
  using T = float2;
};

__device__ __forceinline__ float3 hyper_of(float4 e) {
  return make_float3(e.y, e.z, e.w);
}
__device__ __forceinline__ float3 hyper_of(float2 e) {
  return make_float3(e.y, 0.0f, 0.0f);
}

// K1's decode of one position's hyper maps, in place in its window entry
// {f, h0, h1, h2} -> {f, 2 rho, sx, sy} (rho = 2 h0 - 1), or {f, h0} ->
// {f, 2 h0 - 1}.
__device__ __forceinline__ void decode(float4* e, float max_sigma) {
  const float rho = e->y * 2.0f - 1.0f;
  e->y = 2.0f * rho;
  e->z = e->z * max_sigma;
  e->w = e->w * max_sigma;
}
__device__ __forceinline__ void decode(float2* e, float) {
  e->y = e->y * 2.0f - 1.0f;
}

// One 4-byte asynchronous copy from device to shared memory, or (``read``
// false) a zero into shared memory.
__device__ __forceinline__ void copy4(void* dst, const void* src, bool read) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(read ? 4 : 0));
}
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K1's branch of the amplified-linear kernel and its derivative in alpha.
__device__ __forceinline__ float lin(float a, float x, unsigned mask) {
  const float ax = a * x;
  return (mask & 1u) ? ax + 1.0f : ((mask & 2u) ? 1.0f - ax : 0.0f);
}
__device__ __forceinline__ float dlin(float x, unsigned mask) {
  return (mask & 1u) ? x : ((mask & 2u) ? -x : 0.0f);
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

// K1's weight of one neighbour.
template <bool kLinear>
__device__ __forceinline__ float weight(float3 h, float dx, float dy,
                                        unsigned mx, unsigned my,
                                        int antialias, float m) {
  if constexpr (kLinear) {
    const float w = fmaxf(lin(h.x, dx, mx), 0.0f) *
                    fmaxf(lin(h.x, dy, my), 0.0f);
    return antialias ? m * w : w;
  } else {
    float a, b;
    return gauss(h, dx, dy, antialias, m, &a, &b);
  }
}

// The sum of each of V values (V = 4: the feature's and the Gaussian's
// three hyper gradients; V = 2: the feature's and alpha's) over a group of
// G lanes, by a fixed butterfly whose first steps halve the values a lane
// holds: a lane ends with the sums of values [*at, *at + returned count)
// in v[0..], and lanes that differ only in the bits writers() returns hold
// the same sums.  Fixed order: a rerun gives the same bits.
template <int V>
__device__ __forceinline__ int group_sum(float (&v)[4], int G, int lane,
                                         int* at) {
  constexpr unsigned kAll = 0xffffffffu;
  int off = G >> 1, n = V;
  *at = 0;
  if (V == 4 && off > 0) {
    const bool up = lane & off;
    const float s0 = up ? v[0] : v[2], s1 = up ? v[1] : v[3];
    v[0] = (up ? v[2] : v[0]) + __shfl_xor_sync(kAll, s0, off);
    v[1] = (up ? v[3] : v[1]) + __shfl_xor_sync(kAll, s1, off);
    *at += up ? 2 : 0;
    n = 2;
    off >>= 1;
  }
  if (n == 2 && off > 0) {
    const bool up = lane & off;
    v[0] = (up ? v[1] : v[0]) + __shfl_xor_sync(kAll, up ? v[0] : v[1], off);
    *at += up ? 1 : 0;
    n = 1;
    off >>= 1;
  }
  for (; off > 0; off >>= 1) v[0] += __shfl_xor_sync(kAll, v[0], off);
  return n;
}

// The lane bits group_sum<V> sums over without halving: of the lanes that
// hold the same sums, the one with these bits clear writes them.
__device__ __forceinline__ int writers(int G, int V) {
  return G > V ? G / V - 1 : 0;
}

// A block: one source tile (band blockIdx.y of rows, blockIdx.x of
// columns) of plane blockIdx.z.  KS > 0: the support at compile time (the
// main path's 2, whose loops unroll), KS = 0: p.S at run time.
template <bool kLinear, int KS>
__global__ void __launch_bounds__(kMaxThreads) resize_bwd_kernel(
    const float* __restrict__ img, const float* __restrict__ hyp,
    const float* __restrict__ grad, float* __restrict__ grad_img,
    float* __restrict__ grad_hyp, const Plan p, float max_sigma) {
  using E = typename Entry<kLinear>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const Band br = p.bands[blockIdx.y];
  const Band bc = p.bands[p.n_ty + blockIdx.x];
  const int c = blockIdx.z, S = KS ? KS : p.S;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int hc = kLinear ? 1 : 3, ne = kLinear ? 2 : 4;
  const int ni = br.o_hi - br.o_lo, nj = bc.o_hi - bc.o_lo;
  const int nwc = bc.w_n;
  const int stride = nj | 1;   // odd: a group's lanes (one output row each)
                               // fall in different banks
  const float m = p.min_scale;
  const float* x = img + (size_t)c * p.H * p.W;
  const float* hy = hyp + (size_t)c * p.H * p.W * hc;
  const float* g_out = grad + (size_t)c * p.OH * p.OW;

  // shared memory, in the host's order (resize_bwd.smem_bytes): the
  // window, P and Q, the bands' distances, the bands' integer geometry
  E* win = reinterpret_cast<E*>(smem);
  float2* pq = reinterpret_cast<float2*>(win + br.w_n * nwc);
  float* sdx = reinterpret_cast<float*>(pq + ni * stride);
  float* sdy = sdx + ni * S;
  int* gr = reinterpret_cast<int*>(sdy + nj * S);
  int* gc = gr + br.i_n;
  const int* off_r = gr;                      // window offsets
  const int* off_c = gc;
  const int* inv_r = gr + ni;                 // virtual rows' outputs
  const int* inv_c = gc + nj;
  const int* smx = inv_r + 2 * br.n_v;        // linear branch bits
  const int* smy = inv_c + 2 * bc.n_v;

  // Staging, one batch of asynchronous copies: the window raw (the
  // feature, 0 outside the image; the hyper maps of the nearest image
  // position), dL/dout of the touching outputs (into P's place) and both
  // bands' geometry; then the window decoded and the Gaussian antialias's
  // distances scaled (K1's m * dis) in place.
  for (int k = tid; k < br.w_n * nwc; k += nt) {
    const int r = br.w_lo + k / nwc, q = bc.w_lo + k % nwc;
    const bool inside = r >= 0 && r < p.H && q >= 0 && q < p.W;
    const int rc = min(max(r, 0), p.H - 1), qc = min(max(q, 0), p.W - 1);
    float* e = reinterpret_cast<float*>(win + k);
    copy4(e, x + (inside ? (size_t)r * p.W + q : 0), inside);
    for (int h = 0; h < hc; ++h)
      copy4(e + 1 + h, hy + ((size_t)rc * p.W + qc) * hc + h, true);
  }
  {
    const int di = nj ? nt / nj : 0, dj = nt - di * nj;
    int i = nj ? tid / nj : 0, j = tid - i * nj;
    for (int o = tid; o < ni * nj; o += nt) {
      copy4(&pq[i * stride + j].x,
            g_out + (size_t)(br.o_lo + i) * p.OW + bc.o_lo + j, true);
      j += dj;
      i += di;
      if (j >= nj) {
        j -= nj;
        ++i;
      }
    }
  }
  for (int k = tid; k < ni * S; k += nt)
    copy4(sdx + k, p.geo_f + br.f_at + k, true);
  for (int k = tid; k < nj * S; k += nt)
    copy4(sdy + k, p.geo_f + bc.f_at + k, true);
  for (int k = tid; k < br.i_n; k += nt)
    copy4(gr + k, p.geo_i + br.i_at + k, true);
  for (int k = tid; k < bc.i_n; k += nt)
    copy4(gc + k, p.geo_i + bc.i_at + k, true);
  copies_done();
  __syncthreads();
  for (int k = tid; k < br.w_n * nwc; k += nt) decode(win + k, max_sigma);
  if (p.antialias && !kLinear) {
    for (int k = tid; k < ni * S; k += nt) sdx[k] = m * sdx[k];
    for (int k = tid; k < nj * S; k += nt) sdy[k] = m * sdy[k];
  }
  __syncthreads();

  // Phase A: a thread an output (i, j), stepped without a division.
  // P_o = g_o / W_o, Q_o = P_o out_o.
  {
    const int di = nj ? nt / nj : 0, dj = nt - di * nj;
    int i = nj ? tid / nj : 0, j = tid - i * nj;
    for (int o = tid; o < ni * nj; o += nt) {
      float wn = 0.0f, ws = 0.0f;
      for (int s = 0; s < S; ++s) {
        const E* row = win + (off_r[i] + s) * nwc + off_c[j];
        const float dx = sdx[i * S + s];
        const unsigned mx = kLinear ? smx[i * S + s] : 0u;
        for (int t = 0; t < S; ++t) {
          const E e = row[t];
          const float w = weight<kLinear>(hyper_of(e), dx, sdy[j * S + t],
                                          mx, kLinear ? smy[j * S + t] : 0u,
                                          p.antialias, m);
          wn += w * e.x;
          ws += w;
        }
      }
      float2* v = pq + i * stride + j;
      const float pv = v->x / ws;
      *v = make_float2(pv, pv * (wn / ws));
      j += dj;
      i += di;
      if (j >= nj) {
        j -= nj;
        ++i;
      }
    }
  }
  __syncthreads();

  // Phase B: G lanes a source pixel (y, x); every thread runs the same
  // rounds, so each group's lanes meet at the shuffles.
  const int G = p.group, lane = tid & (G - 1), groups = nt / G;
  const int bw = bc.hi - bc.lo, npix = (br.hi - br.lo) * bw;
  const int vr_hi = br.v_lo + br.n_v - 1, vc_hi = bc.v_lo + bc.n_v - 1;
  for (int base = 0; base < npix; base += groups) {
    const int pix = base + tid / G;
    const bool valid = pix < npix;
    const int y = br.lo + (valid ? pix / bw : 0);
    const int xq = bc.lo + (valid ? pix % bw : 0);
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // dL/df, then the hyper maps'
    // the pixel's virtual rows and columns that outputs read: its own, and
    // on the border the pads that copy it
    const int r_lo = y == 0 ? br.v_lo : max(y, br.v_lo);
    const int r_hi = y == p.H - 1 ? vr_hi : min(y, vr_hi);
    const int q_lo = xq == 0 ? bc.v_lo : max(xq, bc.v_lo);
    const int q_hi = xq == p.W - 1 ? vc_hi : min(xq, vc_hi);
    if (valid && r_lo <= r_hi && q_lo <= q_hi) {
      // the pixel's window entry (one of its pads' where the window holds
      // only those: then no output reads the pixel itself and f is unused)
      const E e = win[(min(max(y, br.w_lo), br.w_lo + br.w_n - 1) - br.w_lo) *
                          nwc +
                      min(max(xq, bc.w_lo), bc.w_lo + nwc - 1) - bc.w_lo];
      const float f = e.x;
      const float3 h = hyper_of(e);
      const float rho = 0.5f * h.x;              // exact: h.x = 2 rho
      // the pixel's output rows, numbered k over its virtual rows: the
      // lane takes k = lane, lane + G, ..., so the group's lanes run each
      // step together (no lane waits on another's turn)
      int before = 0;
      for (int r = r_lo; r <= r_hi; ++r) {
        const int i_lo = inv_r[2 * (r - br.v_lo)];
        const int i_hi = inv_r[2 * (r - br.v_lo) + 1];
        const int first = i_lo + ((lane - before) & (G - 1));
        before += i_hi - i_lo;
        for (int i = first; i < i_hi; i += G) {
          const int ii = i - br.o_lo;
          const int s = r - br.w_lo - off_r[ii];
          const float dx = sdx[ii * S + s];
          const unsigned mx = kLinear ? smx[ii * S + s] : 0u;
          for (int q = q_lo; q <= q_hi; ++q) {
            const int j_lo = inv_c[2 * (q - bc.v_lo)];
            const int j_hi = inv_c[2 * (q - bc.v_lo) + 1];
            const bool inside = r == y && q == xq;
            const float n = inside ? f : 0.0f;
            for (int j = j_lo; j < j_hi; ++j) {
              const int jj = j - bc.o_lo;
              const int t = q - bc.w_lo - off_c[jj];
              const float dy = sdy[jj * S + t];
              const float2 pqv = pq[ii * stride + jj];
              const float coef = pqv.x * n - pqv.y;
              if constexpr (kLinear) {
                const unsigned my = smy[jj * S + t];
                const float lx = lin(h.x, dx, mx), ly = lin(h.x, dy, my);
                const float cx = fmaxf(lx, 0.0f), cy = fmaxf(ly, 0.0f);
                float w = cx * cy;
                float dw = (lx >= 0.0f ? dlin(dx, mx) * cy : 0.0f) +
                           (ly >= 0.0f ? cx * dlin(dy, my) : 0.0f);
                if (p.antialias) {
                  w = m * w;
                  dw = m * dw;
                }
                if (inside) v[0] += pqv.x * w;
                v[1] += coef * dw;
              } else {
                float ga, gb;
                const float w = gauss(h, dx, dy, p.antialias, m, &ga, &gb);
                if (inside) v[0] += pqv.x * w;
                v[1] += coef * (w * ga * gb);
                v[2] += coef * (w * dx * (rho * gb - ga));
                v[3] += coef * (w * dy * (rho * ga - gb));
              }
            }
          }
        }
      }
    }
    int at = 0;
    const int n = group_sum<kLinear ? 2 : 4>(v, G, lane, &at);
    if (valid && (lane & writers(G, ne)) == 0) {
      const size_t idx = ((size_t)c * p.H + y) * p.W + xq;
#pragma unroll
      for (int k = 0; k < (kLinear ? 2 : 4); ++k) {
        if (k >= n) break;
        const int which = at + k;         // the pixel's value at + k
        if (which == 0) {
          grad_img[idx] = v[k];
        } else {
          const float chain = which == 1 ? 2.0f : max_sigma;
          grad_hyp[idx * hc + which - 1] = chain * v[k];
        }
      }
    }
  }
}

// Opt the kernel into the plan's dynamic shared memory above the default
// 48 KB, once per device and instance (the largest asked for so far).
template <bool kLinear, int KS>
cudaError_t allow_smem(int bytes) {
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (bytes <= 48 * 1024 || (dev < 64 && bytes <= allowed[dev]))
    return cudaSuccess;
  err = cudaFuncSetAttribute(resize_bwd_kernel<kLinear, KS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return err;
}

template <bool kLinear, int KS>
cudaError_t launch(const void* img, const void* hyp, const void* grad,
                   void* grad_img, void* grad_hyp, int C, float max_sigma,
                   const Plan& p, cudaStream_t stream) {
  cudaError_t err = allow_smem<kLinear, KS>(p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)p.n_tx, (unsigned)p.n_ty, (unsigned)C);
  resize_bwd_kernel<kLinear, KS><<<grid, p.threads, p.smem, stream>>>(
      (const float*)img, (const float*)hyp, (const float*)grad,
      (float*)grad_img, (float*)grad_hyp, p, max_sigma);
  return cudaGetLastError();
}

}  // namespace

// img [C, H, W] float32 feature, hyp [C, H, W, 3] (Gaussian) or [C, H, W,
// 1] (linear) float32 maps in [0, 1], grad [C, OH, OW] dL/dout; grad_img /
// grad_hyp the outputs, in img's / hyp's shapes.  plan: the host's Plan
// (above) for this geometry, mode and C.
extern "C" int lerf_steering_resize_bwd(const void* img, const void* hyp,
                                        const void* grad, void* grad_img,
                                        void* grad_hyp, int C,
                                        float max_sigma, const void* plan,
                                        void* stream) {
  const Plan& p = *(const Plan*)plan;
  if ((long long)C * p.H * p.W == 0 || (long long)C * p.OH * p.OW == 0)
    return 0;
  const int G = p.group;
  if (p.S < 1 || G < 1 || G > 32 || (G & (G - 1)) != 0 || p.threads < 32 ||
      p.threads > kMaxThreads || p.threads % 32 != 0 || C > 65535 ||
      p.n_ty > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto go = p.linear ? (p.S == 2 ? launch<true, 2> : launch<true, 0>)
                           : (p.S == 2 ? launch<false, 2> : launch<false, 0>);
  return (int)go(img, hyp, grad, grad_img, grad_hyp, C, max_sigma, p, s);
}
