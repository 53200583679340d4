// The IMDN towers' convolutions (LeRF-Net's feature and hyper towers), for
// sm_90a, each with the elementwise work around it in its epilogue.
//
// Replaces: no TPU kernel.  lerf_tpu runs the towers as XLA convolutions
// (lerf_tpu/models/imdn_s2d.py:148-162); the port ran them on cuDNN's
// float32 implicit GEMM plus a separate pass over the activation for each
// bias add, leaky ReLU, residual add and concat (≈ 170 launches a frame).
// This file takes over every conv of the float32 "base" towers
// (kernels/imdn_conv.py; models/imdn_s2d.apply_tower_kernel).
//
// What it computes: a SAME-padded, stride-1 3x3 or 1x1 convolution of an
// NCHW float32 activation (any frame count), then in registers, in the
// plain code's order: + bias; leaky_relu(0.05) optionally; + a residual
// optionally; and a store that sends channels below `split` to one buffer
// (the module's distilled channels, a slice of its concat buffer) and the
// rest to another (what the next conv reads), so no concat is ever copied.
// The tower's last conv instead clamps to [-1, 1] and scales (stage 1:
// y * half + half; stage 2: y * 0.5 + 0.5, which is y / 2 + 0.5 exactly)
// and stores channel o * C + c at [c, pixel, o], the [..., C, H, W, oC]
// order the resize reads.  The module's end (imdn_tail_kernel) keeps c4
// (3x3, rc -> dc) in registers, joins it with the distilled channels read
// at the same pixel, and applies c5 (1x1) + bias + the module's input and,
// on the tower's last module, the tower's lr conv (1x1) + bias + the fea
// output, in one launch.
//
// Arithmetic: float32 FFMA only (no tensor cores, no TF32), explicit
// __fmaf_rn (the library builds with --fmad=false, so nothing else is
// contracted); each output sums its products in one fixed order, input
// channel, then kernel row, then kernel column, from 0, then adds the
// bias.  The order depends on nothing but the weights' shape, so a frame
// gives the same bits alone or in a batch, on any tile.
//
// What bounds it on the H100: a 3x3 12 -> 12 conv does 2,592 flop a
// pixel against 96 bytes read and written, 27 flop a byte, near the
// card's float32 ridge (67 T/s over 3.35 TB/s, 20), so the copies have to
// run under the sums.  The design:
// - Persistent blocks (as many as fit on the SMs at once), each walking
//   tiles of 8 rows x 16 * P columns of every frame.  A tile's input with
//   its 1-pixel halo, 12 input channels at a time (a chunk), is staged
//   into shared memory with cp.async, 16-byte vectors along W where the
//   rows allow it, pixels outside the image written as zeros (SAME
//   padding: no bounds test in the inner loop).  Two buffers: the next
//   chunk (of this tile or the block's next one) is copied while this one
//   is summed.
// - The weights and biases of the block's group of G output channels sit
//   in shared memory for the whole launch, G padded to a multiple of 4 so
//   each tap's G weights are float4 loads; every lane reads the same
//   weight, a broadcast.
// - A thread keeps P adjacent pixels x G output channels in registers
//   (4 x 12 = 48 accumulators); one row of P + 2 inputs, read with float4
//   loads, feeds G x 3 taps of each of its pixels: per input channel and
//   kernel row, 9 weight float4s and 3 input loads against 144 FFMAs.
// - More output channels than G run as more groups (blockIdx.y), each
//   over the whole input; the towers' widths at nf 12 (3, 9, 12) are one
//   group each.
#include <climits>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsX = 16;       // threads along W
constexpr int kThreadsY = 8;        // threads along H, an output row each
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kChunk = 12;          // input channels staged at a time
constexpr int kP = 4;               // adjacent output pixels a thread
constexpr int kMaxCin = 128;        // weights staged for the whole input

// The module's end: c4's outputs (padded), the distilled channels c5
// reads beside them (padded) and c5's / lr's width (padded).
constexpr int kTailG = 3;
constexpr int kTailDist = 9;
constexpr int kTailNf = kTailDist + kTailG;
// c5's weights [kTailNf][kTailNf] and bias, then lr's, as packed on the
// host (kernels/imdn_conv.TailWeights)
constexpr int kFuseFloats = 2 * (kTailNf * kTailNf + kTailNf);

enum Epilogue { kStore = 0, kTowerEnd = 1 };

// The staged input tile of a K x K conv with P pixels a thread: rows
// y0 - K/2 .. y0 + 8 + K/2, columns x0 - 4 * (K/2) .. x0 + 16 P + 4 * (K/2)
// (4 columns each side, so rows start on 16 bytes; the 3x3 conv reads one
// of them).
template <int K, int P = kP>
struct Tile {
  static constexpr int kHalo = K / 2;
  static constexpr int kPadL = 4 * kHalo;
  static constexpr int kW = kThreadsX * P;
  static constexpr int kH = kThreadsY;
  static constexpr int kRows = kH + 2 * kHalo;
  static constexpr int kStride = kW + 2 * kPadL;
  static constexpr int kPlane = kRows * kStride;
};

// Where the launch's tiles lie: item = frame * tiles + tile, tile = row of
// tiles * tiles_x + column; a block takes items blockIdx.x + k gridDim.x.
struct Walk {
  long long x_batch;       // the input's frame stride
  int cin, H, W, tiles_x, tiles, items, vec;
};

struct ConvArgs {
  const float* x;          // [frames][cin][H][W] (a frame's channels dense)
  const float* w;          // [groups][cin][K*K][GP], zero-padded
  const float* b;          // [groups][GP]
  float* out;              // channels >= split (tower end: all)
  float* dist;             // channels < split
  const float* res;        // residual, [frames][cout][H][W], or null
  long long out_batch, dist_batch, res_batch;
  int cout, split, act;
  int stage, oc;           // tower end: 1 or 2, and oC (stage 2's order)
  float half;              // tower end, stage 1
  Walk walk;
};

struct TailArgs {
  const float* x;          // c4's input [frames][cin][H][W]
  const float* w;          // c4's weights [cin][9][4], zero-padded
  const float* b;          // [4]
  const float* fuse;       // c5's then lr's weights and biases (kFuseFloats)
  const float* dist;       // the distilled channels [frames][n_dist][H][W]
  const float* res;        // the module's input [frames][nf][H][W]
  const float* h;          // the tower's fea output (lr's residual) or null
  float* out;              // [frames][nf][H][W]
  long long dist_batch, res_batch, h_batch, out_batch;
  int nf, n_dist;
  Walk walk;
};

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool read) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(read ? 16 : 0));
}
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool read) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(read ? 4 : 0));
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void copies_left() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// nc channels of the tile at (x0, y0) into in_s, zeros outside the image;
// 16-byte copies where every row starts on 16 bytes (vec), else 4-byte.
template <int K, int P>
__device__ __forceinline__ void stage_tile(float* in_s, const float* x,
                                           int nc, long long HW, int H,
                                           int W, int x0, int y0, int vec) {
  using T = Tile<K, P>;
  const int gy0 = y0 - T::kHalo, gx0 = x0 - T::kPadL;
  if (vec) {
    constexpr int kVecs = T::kStride / 4;
    const int total = nc * T::kRows * kVecs;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int j = i % kVecs, rc = i / kVecs;
      const int r = rc % T::kRows, ci = rc / T::kRows;
      const int gy = gy0 + r, gx = gx0 + 4 * j;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* src = inside ? x + ci * HW + (long long)gy * W + gx : x;
      copy16(in_s + rc * T::kStride + 4 * j, src, inside);
    }
  } else {
    const int total = nc * T::kRows * T::kStride;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int j = i % T::kStride, rc = i / T::kStride;
      const int r = rc % T::kRows, ci = rc / T::kRows;
      const int gy = gy0 + r, gx = gx0 + j;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* src = inside ? x + ci * HW + (long long)gy * W + gx : x;
      copy4(in_s + rc * T::kStride + j, src, inside);
    }
  }
}

// v[i] = the input under tap column i - K/2 of the thread's pixel 0, for
// i < P + K - 1, from one staged row (row: the row's column of pixel 0
// minus kPadL, 16-byte aligned).
template <int K, int P>
__device__ __forceinline__ void load_row(const float* row,
                                         float (&v)[P + K - 1]) {
  if constexpr (K == 3) {
    float4 t = *reinterpret_cast<const float4*>(row);
    v[0] = t.w;
#pragma unroll
    for (int j = 0; j < P / 4; ++j) {
      t = *reinterpret_cast<const float4*>(row + 4 + 4 * j);
      v[1 + 4 * j] = t.x;
      v[2 + 4 * j] = t.y;
      v[3 + 4 * j] = t.z;
      v[4 + 4 * j] = t.w;
    }
    v[P + K - 2] = row[4 + P];
  } else {
#pragma unroll
    for (int j = 0; j < P / 4; ++j) {
      const float4 t = *reinterpret_cast<const float4*>(row + 4 * j);
      v[4 * j] = t.x;
      v[4 * j + 1] = t.y;
      v[4 * j + 2] = t.z;
      v[4 * j + 3] = t.w;
    }
  }
}

// acc[p][g] += the products of nc staged input channels (in_s) with their
// weights (w_s: [nc][K*K][GP]), input channel, then kernel row, then
// kernel column, for the thread's P pixels and the group's G outputs.
template <int K, int G, int P>
__device__ __forceinline__ void sum_chunk(const float* in_s,
                                          const float* w_s, int nc,
                                          float (&acc)[P][G]) {
  using T = Tile<K, P>;
  constexpr int GP = (G + 3) & ~3;
  const int tx = threadIdx.x % kThreadsX, ty = threadIdx.x / kThreadsX;
#pragma unroll 1
  for (int ci = 0; ci < nc; ++ci) {
    const float* row = in_s + ci * T::kPlane + ty * T::kStride + tx * P;
    const float* wc = w_s + ci * K * K * GP;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      float v[P + K - 1];
      load_row<K, P>(row + ky * T::kStride, v);
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        float wr[GP];
        const float4* w4 =
            reinterpret_cast<const float4*>(wc + (ky * K + kx) * GP);
#pragma unroll
        for (int j = 0; j < GP / 4; ++j) {
          const float4 t = w4[j];
          wr[4 * j] = t.x;
          wr[4 * j + 1] = t.y;
          wr[4 * j + 2] = t.z;
          wr[4 * j + 3] = t.w;
        }
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int g = 0; g < G; ++g)
            acc[p][g] = __fmaf_rn(v[p + kx], wr[g], acc[p][g]);
      }
    }
  }
}

// The block's walk: every item (a tile of a frame) from blockIdx.x in
// steps of gridDim.x, each item's input channels in chunks of kChunk.  The
// next chunk (of this item or the next) is copied into the other of the
// two buffers at in_s (each min(cin, kChunk) planes) while this one is
// summed; after an item's last chunk, epi(frame, x0, y0, acc).  w_s holds
// the group's weights [cin][K*K][GP], staged by the caller before the
// call (the first barrier here publishes them).
template <int K, int G, int P, typename Epi>
__device__ __forceinline__ void walk_tiles(const float* x, const Walk a,
                                           const float* w_s, float* in_s,
                                           Epi&& epi) {
  using T = Tile<K, P>;
  constexpr int GP = (G + 3) & ~3;
  const long long HW = (long long)a.H * a.W;
  const int chunks = (a.cin + kChunk - 1) / kChunk;
  const int buf = min(a.cin, kChunk) * T::kPlane;
  auto stage = [&](int item, int chunk, int b) {
    const int n = item / a.tiles, t = item % a.tiles;
    const int c0 = chunk * kChunk;
    stage_tile<K, P>(in_s + b * buf, x + n * a.x_batch + c0 * HW,
                     min(kChunk, a.cin - c0), HW, a.H, a.W,
                     (t % a.tiles_x) * T::kW, (t / a.tiles_x) * T::kH,
                     a.vec);
    commit_copies();
  };
  int item = blockIdx.x, chunk = 0, b = 0;
  if (item >= a.items) return;      // the whole block: no barrier skipped
  stage(item, 0, 0);
  float acc[P][G];
  for (;;) {
    int next = item, next_chunk = chunk + 1;
    if (next_chunk == chunks) {
      next += gridDim.x;
      next_chunk = 0;
    }
    const bool more = next < a.items;
    if (more) {
      stage(next, next_chunk, b ^ 1);
      copies_left<1>();
    } else {
      copies_left<0>();
    }
    __syncthreads();        // the chunk's copies (every thread's) landed
    if (chunk == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int g = 0; g < G; ++g) acc[p][g] = 0.0f;
    }
    const int c0 = chunk * kChunk;
    sum_chunk<K, G, P>(in_s + b * buf, w_s + c0 * K * K * GP,
                       min(kChunk, a.cin - c0), acc);
    if (chunk == chunks - 1) {
      const int t = item % a.tiles;
      epi(item / a.tiles, (t % a.tiles_x) * T::kW, (t / a.tiles_x) * T::kH,
          acc);
    }
    if (!more) return;
    __syncthreads();        // every thread is done with buffer b
    item = next;
    chunk = next_chunk;
    b ^= 1;
  }
}

// P pixels from src (n of them inside the image), as one float4 a 4
// where vec and all P are inside.
template <int P>
__device__ __forceinline__ void load_px(const float* src, int n, int vec,
                                        float (&v)[P]) {
  if (vec && n == P) {
#pragma unroll
    for (int j = 0; j < P / 4; ++j) {
      const float4 t = *reinterpret_cast<const float4*>(src + 4 * j);
      v[4 * j] = t.x;
      v[4 * j + 1] = t.y;
      v[4 * j + 2] = t.z;
      v[4 * j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = p < n ? src[p] : 0.0f;
  }
}

template <int P>
__device__ __forceinline__ void store_px(float* dst, int n, int vec,
                                         const float (&v)[P]) {
  if (vec && n == P) {
#pragma unroll
    for (int j = 0; j < P / 4; ++j)
      *reinterpret_cast<float4*>(dst + 4 * j) =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (p < n) dst[p] = v[p];
  }
}

__device__ __forceinline__ float leaky(float y) {
  return y > 0.0f ? y : __fmul_rn(y, 0.05f);
}

template <int K, int G, int EPI>
__global__ void __launch_bounds__(kThreads)
    imdn_conv_kernel(const ConvArgs a) {
  constexpr int P = kP;
  constexpr int GP = (G + 3) & ~3;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                             // [cin][K*K][GP]
  float* b_s = w_s + a.walk.cin * K * K * GP;    // [GP]
  float* in_s = b_s + GP;                        // 2 x [chunk][kPlane]

  const int group = blockIdx.y;
  const int nw = a.walk.cin * K * K * GP;
  const float* wg = a.w + (long long)group * nw;
  for (int i = threadIdx.x; i < nw; i += kThreads) w_s[i] = wg[i];
  if (threadIdx.x < GP) b_s[threadIdx.x] = a.b[group * GP + threadIdx.x];

  const int H = a.walk.H, W = a.walk.W, vec = a.walk.vec;
  const long long HW = (long long)H * W;
  const int tx = threadIdx.x % kThreadsX, ty = threadIdx.x / kThreadsX;
  walk_tiles<K, G, P>(a.x, a.walk, w_s, in_s, [=](int n, int x0, int y0,
                                                  const float (&acc)[P][G]) {
    const int gy = y0 + ty, gx = x0 + tx * P;
    const int n_in = min(P, W - gx);
    if (gy >= H || n_in <= 0) return;
    const long long pix = (long long)gy * W + gx;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int co = group * G + g;
      if (co >= a.cout) continue;
      float y[P];
#pragma unroll
      for (int p = 0; p < P; ++p) y[p] = __fadd_rn(acc[p][g], b_s[g]);
      if constexpr (EPI == kStore) {
        if (a.act) {
#pragma unroll
          for (int p = 0; p < P; ++p) y[p] = leaky(y[p]);
        }
        if (a.res != nullptr) {
          float r[P];
          load_px<P>(a.res + n * a.res_batch + co * HW + pix, n_in, vec, r);
#pragma unroll
          for (int p = 0; p < P; ++p) y[p] = __fadd_rn(y[p], r[p]);
        }
        float* dst = co < a.split
                         ? a.dist + n * a.dist_batch + co * HW
                         : a.out + n * a.out_batch + (co - a.split) * HW;
        store_px<P>(dst + pix, n_in, vec, y);
      } else {
        const int C = a.cout / a.oc;
        const int c = co % C, o = co / C;
        float* dst = a.out + n * a.out_batch + (c * HW + pix) * a.oc + o;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float t = y[p] < -1.0f ? -1.0f : (y[p] > 1.0f ? 1.0f : y[p]);
          t = a.stage == 1 ? __fadd_rn(__fmul_rn(t, a.half), a.half)
                           : __fadd_rn(__fmul_rn(t, 0.5f), 0.5f);
          if (p < n_in) dst[p * a.oc] = t;
        }
      }
    }
  });
}

__global__ void __launch_bounds__(kThreads)
    imdn_tail_kernel(const TailArgs a) {
  constexpr int P = kP;
  constexpr int NF = kTailNf;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                          // c4 [cin][9][4]
  float* b_s = w_s + a.walk.cin * 9 * 4;      // [4]
  float* f_s = b_s + 4;                       // c5, b5, lr, blr
  float* in_s = f_s + kFuseFloats;            // 2 x [chunk][kPlane]

  for (int i = threadIdx.x; i < a.walk.cin * 9 * 4; i += kThreads)
    w_s[i] = a.w[i];
  if (threadIdx.x < 4) b_s[threadIdx.x] = a.b[threadIdx.x];
  for (int i = threadIdx.x; i < kFuseFloats; i += kThreads)
    f_s[i] = a.fuse[i];

  const int H = a.walk.H, W = a.walk.W, vec = a.walk.vec;
  const long long HW = (long long)H * W;
  const int tx = threadIdx.x % kThreadsX, ty = threadIdx.x / kThreadsX;
  walk_tiles<3, kTailG, P>(a.x, a.walk, w_s, in_s, [=](
      int n, int x0, int y0, const float (&acc)[P][kTailG]) {
    const int gy = y0 + ty, gx = x0 + tx * P;
    const int n_in = min(P, W - gx);
    if (gy >= H || n_in <= 0) return;
    const long long pix = (long long)gy * W + gx;

    // c5's input: the distilled channels, then c4 (+ its bias)
    float v[P][NF];
#pragma unroll
    for (int j = 0; j < kTailDist; ++j) {
      float t[P];
      if (j < a.n_dist) {
        load_px<P>(a.dist + n * a.dist_batch + j * HW + pix, n_in, vec, t);
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p) t[p] = 0.0f;
      }
#pragma unroll
      for (int p = 0; p < P; ++p) v[p][j] = t[p];
    }
#pragma unroll
    for (int j = 0; j < kTailG; ++j)
#pragma unroll
      for (int p = 0; p < P; ++p)
        v[p][kTailDist + j] = __fadd_rn(acc[p][j], b_s[j]);

    // c5 (1x1) + bias + the module's input
    const float* w5 = f_s;
    const float* b5 = w5 + NF * NF;
    float y[P][NF];
#pragma unroll
    for (int co = 0; co < NF; ++co) {
      float wr[NF];
      const float4* w4 = reinterpret_cast<const float4*>(w5 + co * NF);
#pragma unroll
      for (int j = 0; j < NF / 4; ++j) {
        const float4 t = w4[j];
        wr[4 * j] = t.x;
        wr[4 * j + 1] = t.y;
        wr[4 * j + 2] = t.z;
        wr[4 * j + 3] = t.w;
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float s = 0.0f;
#pragma unroll
        for (int ci = 0; ci < NF; ++ci) s = __fmaf_rn(v[p][ci], wr[ci], s);
        y[p][co] = __fadd_rn(s, b5[co]);
      }
      if (co < a.nf) {
        float r[P];
        load_px<P>(a.res + n * a.res_batch + co * HW + pix, n_in, vec, r);
#pragma unroll
        for (int p = 0; p < P; ++p) y[p][co] = __fadd_rn(y[p][co], r[p]);
      }
    }
    if (a.h == nullptr) {
#pragma unroll
      for (int co = 0; co < NF; ++co) {
        if (co >= a.nf) continue;
        float t[P];
#pragma unroll
        for (int p = 0; p < P; ++p) t[p] = y[p][co];
        store_px<P>(a.out + n * a.out_batch + co * HW + pix, n_in, vec, t);
      }
      return;
    }
    // the tower's lr (1x1) + bias + the fea output, on its last module
    const float* wl = b5 + NF;
    const float* bl = wl + NF * NF;
#pragma unroll
    for (int co = 0; co < NF; ++co) {
      if (co >= a.nf) continue;
      float wr[NF];
      const float4* w4 = reinterpret_cast<const float4*>(wl + co * NF);
#pragma unroll
      for (int j = 0; j < NF / 4; ++j) {
        const float4 t = w4[j];
        wr[4 * j] = t.x;
        wr[4 * j + 1] = t.y;
        wr[4 * j + 2] = t.z;
        wr[4 * j + 3] = t.w;
      }
      float r[P], z[P];
      load_px<P>(a.h + n * a.h_batch + co * HW + pix, n_in, vec, r);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float s = 0.0f;
#pragma unroll
        for (int ci = 0; ci < NF; ++ci) s = __fmaf_rn(y[p][ci], wr[ci], s);
        z[p] = __fadd_rn(__fadd_rn(s, bl[co]), r[p]);
      }
      store_px<P>(a.out + n * a.out_batch + co * HW + pix, n_in, vec, z);
    }
  });
}

// The persistent blocks a kernel keeps resident on the current card at
// this shared memory: its SMs times the blocks that fit on one.  Asked
// once a kernel, card and size and kept (a tower's launches repeat a
// handful of sizes); the kernel's shared-memory limit on the card is only
// ever raised, to the largest size asked.  Returns the blocks, or minus a
// CUDA error code.
int resident_blocks(const void* kern, size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> known;
  static std::map<std::pair<const void*, int>, size_t> raised;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kern, dev, smem);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  size_t& limit = raised[std::make_pair(kern, dev)];
  int sms = 0, per_sm = 0;
  if ((smem > 48 * 1024 && smem > limit &&
       (err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                           kThreads, smem))) {
    cudaGetLastError();                    // not left for the next launch
    return -(int)err;
  }
  if (smem > limit) limit = smem;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  known[key] = per_sm * sms;
  return per_sm * sms;
}

// The walk's tiles and its grid of persistent blocks: as many as stay
// resident on the card at this shared memory, at most one an item.
// Returns the blocks, or minus a CUDA error code.
template <int K>
int plan_walk(Walk& w, int frames, const void* kern, size_t smem) {
  using T = Tile<K>;
  w.tiles_x = (w.W + T::kW - 1) / T::kW;
  w.tiles = w.tiles_x * ((w.H + T::kH - 1) / T::kH);
  const long long items = (long long)frames * w.tiles;
  if (items > INT_MAX) return -(int)cudaErrorInvalidValue;
  w.items = (int)items;
  const int blocks = resident_blocks(kern, smem);
  return blocks < 0 ? blocks : min(w.items, blocks);
}

template <int K, int G, int EPI>
int launch_conv(ConvArgs a, int frames, cudaStream_t stream) {
  using T = Tile<K>;
  constexpr int GP = (G + 3) & ~3;
  const int groups = (a.cout + G - 1) / G;
  const size_t smem =
      sizeof(float) * ((size_t)a.walk.cin * K * K * GP + GP +
                       2 * (size_t)min(a.walk.cin, kChunk) * T::kPlane);
  auto kern = imdn_conv_kernel<K, G, EPI>;
  const int blocks =
      plan_walk<K>(a.walk, frames, (const void*)kern, smem);
  if (blocks < 0) return -blocks;
  kern<<<dim3(blocks, groups), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

Walk make_walk(long long x_batch, int cin, int H, int W, int vec) {
  Walk w;
  w.x_batch = x_batch;
  w.cin = cin;
  w.H = H;
  w.W = W;
  w.vec = vec;
  w.tiles_x = w.tiles = w.items = 0;
  return w;
}

}  // namespace

// One conv with its epilogue (kernels/imdn_conv.conv / tower_end).  group:
// the output channels a block computes (3, 9 or 12 for 3x3, 12 for 1x1),
// as the weights were packed; end: 0 the store epilogue (act, res,
// split), 1 the tower's end (stage, half, oc).  Returns a CUDA error code,
// 0 on success.
extern "C" int lerf_imdn_conv(const void* x, long long x_batch,
                              const void* w, const void* b, void* out,
                              long long out_batch, void* dist,
                              long long dist_batch, int split,
                              const void* res, long long res_batch,
                              int frames, int cin, int cout, int H, int W,
                              int k, int group, int act, int end,
                              int stage, float half, int oc, int vec,
                              void* stream) {
  if (frames == 0 || H == 0 || W == 0) return 0;
  if (frames < 0 || cin < 1 || cin > kMaxCin || cout < 1 || H < 0 ||
      W < 0 || split < 0 || split > cout ||
      (end && (oc < 1 || cout % oc != 0 || (stage != 1 && stage != 2))))
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.x = (const float*)x;
  a.w = (const float*)w;
  a.b = (const float*)b;
  a.out = (float*)out;
  a.dist = (float*)dist;
  a.res = (const float*)res;
  a.out_batch = out_batch;
  a.dist_batch = dist_batch;
  a.res_batch = res_batch;
  a.cout = cout;
  a.split = split;
  a.act = act;
  a.stage = stage;
  a.oc = oc;
  a.half = half;
  a.walk = make_walk(x_batch, cin, H, W, vec);
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 1 && group == 12 && !end)
    return launch_conv<1, 12, kStore>(a, frames, s);
  if (k != 3) return (int)cudaErrorInvalidValue;
  if (end) {
    if (group == 3) return launch_conv<3, 3, kTowerEnd>(a, frames, s);
    if (group == 9) return launch_conv<3, 9, kTowerEnd>(a, frames, s);
    if (group == 12) return launch_conv<3, 12, kTowerEnd>(a, frames, s);
  } else {
    if (group == 3) return launch_conv<3, 3, kStore>(a, frames, s);
    if (group == 9) return launch_conv<3, 9, kStore>(a, frames, s);
    if (group == 12) return launch_conv<3, 12, kStore>(a, frames, s);
  }
  return (int)cudaErrorInvalidValue;
}

// A module's end (kernels/imdn_conv.tail): c4 (3x3, cin -> at most 3) in
// registers, c5 (1x1 over the n_dist distilled channels and c4's) + bias
// + res, and with h non-null the tower's lr (1x1) + bias + h, into out
// (nf <= 12 channels).
extern "C" int lerf_imdn_tail(const void* x, long long x_batch,
                              const void* w, const void* b, const void* fuse,
                              const void* dist, long long dist_batch,
                              int n_dist, const void* res,
                              long long res_batch, const void* h,
                              long long h_batch, void* out,
                              long long out_batch, int frames, int cin,
                              int nf, int H, int W, int vec, void* stream) {
  if (frames == 0 || H == 0 || W == 0) return 0;
  if (frames < 0 || cin < 1 || cin > kMaxCin || nf < 1 || nf > kTailNf ||
      n_dist < 0 || n_dist > kTailDist || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  using T = Tile<3>;
  TailArgs a;
  a.x = (const float*)x;
  a.w = (const float*)w;
  a.b = (const float*)b;
  a.fuse = (const float*)fuse;
  a.dist = (const float*)dist;
  a.res = (const float*)res;
  a.h = (const float*)h;
  a.out = (float*)out;
  a.dist_batch = dist_batch;
  a.res_batch = res_batch;
  a.h_batch = h_batch;
  a.out_batch = out_batch;
  a.nf = nf;
  a.n_dist = n_dist;
  a.walk = make_walk(x_batch, cin, H, W, vec);
  const size_t smem =
      sizeof(float) * ((size_t)cin * 9 * 4 + 4 + kFuseFloats +
                       2 * (size_t)min(cin, kChunk) * T::kPlane);
  const int blocks =
      plan_walk<3>(a.walk, frames, (const void*)imdn_tail_kernel, smem);
  if (blocks < 0) return -blocks;
  imdn_tail_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
