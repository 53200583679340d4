// K1: steerable-Gaussian resize from the stage-2 codes, for sm_90a.
//
// Replaces: lerf_tpu/ops/pallas/resize_kernel.py::steering_gaussian_resize_pallas
// (body _kernel), which computes lerf_tpu/ops/resample.py::steering_gaussian_resize.
// Unlike the Pallas kernel (periodic scales, support 2, no antialias), this one
// takes every ResizeGeometry: periodic and non-periodic scales and the
// antialiased downscale with its inflated support.
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
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 4;                  // adjacent outputs a thread
constexpr int kMaxThreads = 256;         // a block; the host's tiles fit
constexpr int kMaxSmem = 232448;         // the H100's opt-in block limit
constexpr int kDefaultSmem = 48 * 1024;  // above this only after opting in

// A thread's field of view, local to the block's source window.  KS > 0:
// the support is known at compile time and the values sit in registers.
template <int KS>
struct Fov {
  int lr[KS];
  float dx[KS];
  int lc[kVec][KS];
  float dy[kVec][KS];

  __device__ void load(const int* rows, const int* cols, const float* dis_x,
                       const float* dis_y, int i, const int* j, int r_lo,
                       int c_lo, int, int antialias, float m) {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      lr[s] = rows[i * KS + s] - r_lo;
      dx[s] = antialias ? m * dis_x[i * KS + s] : dis_x[i * KS + s];
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
#pragma unroll
      for (int t = 0; t < KS; ++t) {
        lc[v][t] = cols[j[v] * KS + t] - c_lo;
        dy[v][t] = antialias ? m * dis_y[j[v] * KS + t] : dis_y[j[v] * KS + t];
      }
    }
  }
  __device__ int row(int s) const { return lr[s]; }
  __device__ float dxs(int s) const { return dx[s]; }
  __device__ int col(int v, int t) const { return lc[v][t]; }
  __device__ float dyt(int v, int t) const { return dy[v][t]; }
};

// Any other support: read each value where it is used.
template <>
struct Fov<0> {
  const int* rows;
  const int* cols;
  const float* dis_x;
  const float* dis_y;
  int i, j[kVec], r_lo, c_lo, S, antialias;
  float m;

  __device__ void load(const int* rows_, const int* cols_,
                       const float* dis_x_, const float* dis_y_, int i_,
                       const int* j_, int r_lo_, int c_lo_, int S_,
                       int antialias_, float m_) {
    rows = rows_; cols = cols_; dis_x = dis_x_; dis_y = dis_y_;
    i = i_; r_lo = r_lo_; c_lo = c_lo_; S = S_; antialias = antialias_;
    m = m_;
    for (int v = 0; v < kVec; ++v) j[v] = j_[v];
  }
  __device__ int row(int s) const { return rows[i * S + s] - r_lo; }
  __device__ float dxs(int s) const {
    return antialias ? m * dis_x[i * S + s] : dis_x[i * S + s];
  }
  __device__ int col(int v, int t) const { return cols[j[v] * S + t] - c_lo; }
  __device__ float dyt(int v, int t) const {
    return antialias ? m * dis_y[j[v] * S + t] : dis_y[j[v] * S + t];
  }
};

__device__ __forceinline__ float finish(float v, float, float*) { return v; }

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

// Window rows [k0, k0 + nrows) of the block's source window, decoded into
// shared memory as {feature, 2 rho, sx, sy}.
__device__ __forceinline__ void load_window(
    float4* win, const int* x, const int* hyp, int r_lo, int c_lo, int k0,
    int nrows, int wc, int pitch, int H, int W, float norm, float max_sigma) {
  const int nthreads = blockDim.x * blockDim.y;
  for (int e = threadIdx.y * blockDim.x + threadIdx.x; e < nrows * wc;
       e += nthreads) {
    const int r = e / wc;
    const int q = e - r * wc;
    const int gr = r_lo + k0 + r, gc = c_lo + q;
    const int rc = min(max(gr, 0), H - 1);
    const int cc = min(max(gc, 0), W - 1);
    const int* code = hyp + ((size_t)rc * W + cc) * 3;
    const float rho = (float)__ldg(code) / norm * 2.0f - 1.0f;
    const float sx = (float)__ldg(code + 1) / norm * max_sigma;
    const float sy = (float)__ldg(code + 2) / norm * max_sigma;
    const float n = (gr >= 0 && gr < H && gc >= 0 && gc < W)
                        ? (float)__ldg(x + (size_t)gr * W + gc) : 0.0f;
    win[r * pitch + q] = make_float4(n, 2.0f * rho, sx, sy);
  }
}

// The weighted sums over the neighbours whose source row lies in window
// rows [k0, k0 + nrows), s-major, t-minor.  kStrip false: all of them (the
// whole window is in shared memory).
template <bool kStrip, int KS>
__device__ __forceinline__ void accumulate(
    const float4* win, const Fov<KS>& fov, int S_rt, int pitch, int k0,
    int nrows, int antialias, float m, float* wn, float* ws) {
  const int S = KS > 0 ? KS : S_rt;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = fov.row(s) - k0;
    if (kStrip && (r < 0 || r >= nrows)) continue;
    const float4* wrow = win + r * pitch;
    const float dx = fov.dxs(s);
#pragma unroll
    for (int t = 0; t < S; ++t) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float4 p = wrow[fov.col(v, t)];   // {n, 2 rho, sx, sy}
        const float dy = fov.dyt(v, t);
        const float a = p.z * dx;
        const float b = p.w * dy;
        const float xn = a * a;
        const float yn = b * b;
        const float xy = a * p.w * dy;
        float w = expf(-0.5f * (xn - p.y * xy + yn));
        if (antialias) w = m * w;
        wn[v] += w * p.x;
        ws[v] += w;
      }
    }
  }
}

template <int KS, typename OutT>
__global__ void __launch_bounds__(kMaxThreads) steering_resize_kernel(
    const int* __restrict__ img,      // [C, H, W] int32 feature (0..norm)
    const int* __restrict__ codes,    // [C, H, W, 3] int32 hyper codes
    OutT* __restrict__ out,           // [C, OH, OW] float32 or uint8
    const int* __restrict__ rows,     // [OH, S] source rows, may be outside [0, H)
    const int* __restrict__ cols,     // [OW, S] source cols, may be outside [0, W)
    const float* __restrict__ dis_x,  // [OH, S]
    const float* __restrict__ dis_y,  // [OW, S]
    int H, int W, int OH, int OW, int S_rt, int tile_h, int tile_w,
    int strip, int pitch, int vec_ok, int antialias, float m,
    float max_sigma, float norm) {
  extern __shared__ float4 win[];     // [strip rows][pitch]
  const int S = KS > 0 ? KS : S_rt;
  const int c = blockIdx.z;
  const int i0 = blockIdx.y * tile_h, j0 = blockIdx.x * tile_w;
  const int i_end = min(i0 + tile_h, OH) - 1;   // the tile's last row
  const int j_end = min(j0 + tile_w, OW) - 1;   // and column
  const int r_lo = rows[i0 * S], c_lo = cols[j0 * S];
  const int wr = rows[i_end * S + S - 1] - r_lo + 1;
  const int wc = cols[j_end * S + S - 1] - c_lo + 1;
  const int* x = img + (size_t)c * H * W;
  const int* hyp = codes + (size_t)c * H * W * 3;
  // the whole window fits in shared memory: always for S 2 and 4 (a
  // one-output window of 4 x 4 fits, so the host's tile holds its whole
  // window), else unless the window is walked in strips of rows (S >= 121)
  const bool whole = KS > 0 || wr <= strip;

  // 1. the source window (or its first strip), decoded once
  load_window(win, x, hyp, r_lo, c_lo, 0, whole ? wr : strip, wc, pitch, H,
              W, norm, max_sigma);
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
  Fov<KS> fov;
  fov.load(rows, cols, dis_x, dis_y, min(i, i_end), j, r_lo, c_lo, S,
           antialias, m);

  // 3. the weighted sums, s-major, t-minor (the strips run in row order,
  // and a thread's rows rise with s)
  float wn[kVec], ws[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) wn[v] = ws[v] = 0.0f;
  if (whole) {
    accumulate<false>(win, fov, S, pitch, 0, wr, antialias, m, wn, ws);
  } else {
    for (int k0 = 0;;) {
      accumulate<true>(win, fov, S, pitch, k0, min(strip, wr - k0),
                       antialias, m, wn, ws);
      k0 += strip;
      if (k0 >= wr) break;
      __syncthreads();
      load_window(win, x, hyp, r_lo, c_lo, k0, min(strip, wr - k0), wc,
                  pitch, H, W, norm, max_sigma);
      __syncthreads();
    }
    if (!active) return;
  }

  // 4. epilogue
  OutT o[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) o[v] = finish(wn[v] / ws[v], norm, out);
  OutT* dst = out + ((size_t)c * OH + i) * OW + jb;
  if (vec_ok && jb + kVec - 1 <= j_end) {
    store_vec(dst, o);
  } else {
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      if (jb + v <= j_end) dst[v] = o[v];
  }
}

template <int KS, typename OutT>
cudaError_t launch(const void* img, const void* codes, void* out,
                   const void* rows, const void* cols, const void* dis_x,
                   const void* dis_y, int C, int H, int W, int OH, int OW,
                   int S, int tile_h, int tile_w, int strip, int pitch,
                   int smem, int antialias, float m, float max_sigma,
                   float norm, cudaStream_t stream) {
  auto kernel = steering_resize_kernel<KS, OutT>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((OW + tile_w - 1) / tile_w, (OH + tile_h - 1) / tile_h, C);
  const dim3 block((tile_w + kVec - 1) / kVec, tile_h);
  const int vec_ok = OW % kVec == 0 && tile_w % kVec == 0;
  kernel<<<grid, block, smem, stream>>>(
      (const int*)img, (const int*)codes, (OutT*)out, (const int*)rows,
      (const int*)cols, (const float*)dis_x, (const float*)dis_y, H, W, OH,
      OW, S, tile_h, tile_w, strip, pitch, vec_ok, antialias, m, max_sigma,
      norm);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(const void* img, const void* codes, void* out,
                     const void* rows, const void* cols, const void* dis_x,
                     const void* dis_y, int C, int H, int W, int OH, int OW,
                     int S, int tile_h, int tile_w, int strip, int pitch,
                     int smem, int antialias, float m, float max_sigma,
                     float norm, cudaStream_t stream) {
  switch (S) {
    case 2:
      return launch<2, OutT>(img, codes, out, rows, cols, dis_x, dis_y, C, H,
                             W, OH, OW, S, tile_h, tile_w, strip, pitch,
                             smem, antialias, m, max_sigma, norm, stream);
    case 4:
      return launch<4, OutT>(img, codes, out, rows, cols, dis_x, dis_y, C, H,
                             W, OH, OW, S, tile_h, tile_w, strip, pitch,
                             smem, antialias, m, max_sigma, norm, stream);
    default:
      return launch<0, OutT>(img, codes, out, rows, cols, dis_x, dis_y, C, H,
                             W, OH, OW, S, tile_h, tile_w, strip, pitch,
                             smem, antialias, m, max_sigma, norm, stream);
  }
}

}  // namespace

// tile_h x tile_w outputs a block.  win_cols: the widest source window of
// any tile of this geometry; win_rows: the source rows a block holds in
// shared memory at once, the tallest window's where it fits (the host
// computes both), else fewer, and the kernel walks a taller window in strips
// of win_rows rows.  out_u8: 1 writes uint8 clip(rint(.), 0, norm) (norm <=
// 255), 0 float32.
extern "C" int lerf_steering_resize(
    const void* img, const void* codes, void* out, const void* rows,
    const void* cols, const void* dis_x, const void* dis_y,
    int C, int H, int W, int OH, int OW, int S,
    int antialias, float min_scale, float max_sigma, float norm,
    int tile_h, int tile_w, int win_rows, int win_cols, int out_u8,
    void* stream) {
  if ((long long)C * OH * OW == 0) return 0;
  if (S < 1 || tile_h < 1 || tile_w < 1 || win_rows < 1 || win_cols < 1 ||
      C > 65535 || (OH + tile_h - 1) / tile_h > 65535 ||
      ((tile_w + kVec - 1) / kVec) * tile_h > kMaxThreads ||
      (out_u8 && !(norm <= 255.0f)))
    return (int)cudaErrorInvalidValue;
  const long long smem = (long long)win_rows * win_cols * sizeof(float4);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      out_u8 ? dispatch<unsigned char>(img, codes, out, rows, cols, dis_x,
                                       dis_y, C, H, W, OH, OW, S, tile_h,
                                       tile_w, win_rows, win_cols, (int)smem,
                                       antialias, min_scale, max_sigma, norm,
                                       s)
             : dispatch<float>(img, codes, out, rows, cols, dis_x, dis_y, C,
                               H, W, OH, OW, S, tile_h, tile_w, win_rows,
                               win_cols, (int)smem, antialias, min_scale,
                               max_sigma, norm, s);
  return (int)err;
}
