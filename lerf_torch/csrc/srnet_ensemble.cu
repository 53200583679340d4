// K3: the float SRUnit (micro-net) ensemble of one stage — every mode x 4
// rotations, sampling included — for sm_90a.
//
// Replaces: lerf_tpu/ops/pallas/srnet_kernel.py, _ensemble_sum_flat (the
// pl.pallas_call at :94) with _make_kernel and ensemble_sum_on_image. For
// each pixel it computes  sum_m round(tanh(W6.[h1..h5] + b6) * half)  where
// h1 = relu(W1.x4_m + b1), hk = relu(Wk.[h1..hk-1] + bk), k = 2..5, and x4_m
// are the member's 4 edge-clamped neighbours.
//
// What bounds it on the H100: the multiply-adds. One member costs
// 4.nf + nf.(nf+2nf+3nf+4nf) + 5nf.oC of them per pixel (41,536 at nf = 64,
// oC = 1), ~6.9e11 flop for a 3 x 360 x 640 stage. Kept in float32, they
// run on the tensor cores as three TF32 products each (3xTF32, below):
// 2.1e12 flop at 495 Tflop/s, ~4.2 ms a stage, against ~10 ms for float32
// on the CUDA cores. The image in, the weights and the [N, oC] result out
// are a few MB.
//
// What the design does about it:
// - Every dense layer is a matrix product [pixels x fan-in] . [fan-in x
//   outputs] on mma.sync.m16n8k8 (TF32 in, float32 accumulators): 16 pixels
//   a fragment row block (M), 8 outputs an n-tile (N), 8 inputs a k-step.
// - 3xTF32: each operand is split x = hi + lo with hi = tf32(x) and
//   lo = tf32(x - hi), and the product is lo.hi' + hi.lo' + hi.hi', each
//   exact in the tensor core; the dropped lo.lo' and the rounding of lo
//   leave ~2^-22..2^-21 of each product, float32's own rounding. The tensor
//   core truncates the sums it carries, so each two k-steps' products are
//   summed from zero there and added to the float32 accumulators with IEEE
//   adds (kgroup). The weights come split from the host
//   (StackedHeads.frags) in B-fragment order: per k-step and n-tile, each
//   lane's {hi, hi, lo, lo} of its two inputs as one float4. The
//   activations are split as they are loaded into A fragments (8 bytes a
//   row: a lane's two inputs of a k-step are adjacent columns); each A
//   fragment serves four n-tiles.
// - A block of 8 warps owns 128 pixels and walks the members in order. The
//   tile's activations [128][5.nf] (168 KB at nf = 64, rows padded to 8 mod
//   32 floats so the fragment loads are free of bank conflicts) stay in
//   shared memory for the whole chain. Warps w and w + 4 share the 32-pixel
//   group w % 4: in the hidden layers both compute its two m-tiles, each
//   against half the n-tiles; in the head, whose 1 or 3 outputs are padded
//   to one n-tile with zero weights, each takes one m-tile and keeps its
//   member sums in registers. (One warp per m-tile against all n-tiles, or
//   16 warps a block, measured slower.)
// - A group reads only the samples and activations its own two warps
//   wrote, so those two sync with a named barrier; the block shares only
//   the weights.
// - The weights stream through shared memory in 16 KB chunks (a few k-steps
//   of one member's layer) with cp.async, a ring of 3 buffers guarded by
//   mbarriers (full: the chunk has landed; empty: every warp has multiplied
//   it): the next two chunks, of this layer or the next, load while the
//   tensor cores work on this one, and no block-wide barrier holds every
//   warp to the slowest. Each weight is read from L2 once per 128 pixels:
//   12 members x 344 KB (hi and lo, padded) x 5,400 tiles ~ 22.8 GB a
//   stage at nf = 64, where the 64-pixel CUDA-core design read ~21 GB of
//   unsplit weights (the split doubles the bytes, the tile halves them).
// - nf is padded to a multiple of 16 with zero weights and biases (a padded
//   feature is relu(0) = 0 and feeds zero weights); layer 1's 4 inputs are
//   padded to one k-step.
// - The sampling is the kernel's own: the member's rotated offsets are a
//   by-value parameter and each index is clamped to the image, which
//   replaces the all-sides edge pad. Each member's samples load during the
//   previous member's layers.
//
// - nf up to 128: the float32 tile is 128 pixels up to nf 64 and 64 pixels
//   (4 warps) above it, where 128 rows of 5.nf floats would not fit.
//
// Numbers: float32 throughout (no plain TF32). Against the plain twin the
// products carry ~2^-22 relative error and are summed in another order,
// which can move a member's round(tanh * half) at a .5 edge: callers hold
// the sums within 2.
//
// K3's bf16 instance (bf16 heads) is srnet_ensemble_bf16.cu.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxMembers = 20;          // 5 modes x 4 rotations
constexpr int kMaxNf = 128;              // the activation tile's budget
constexpr int kFragFloats = 128;         // one (k-step, n-tile) B fragment
constexpr int kChunkFloats = 4096;       // 16 KB a weight buffer
constexpr int kStages = 3;               // weight buffers: 2 chunks in flight

// A block of TILE pixels: TILE / 16 warps (the head gives each an m-tile),
// two warps to each 32-pixel group of the hidden layers.
template <int TILE>
struct Tile {
  static constexpr int kWarps = TILE / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kGroups = kWarps / 2;
};

struct Members {
  int n;
  int off[kMaxMembers][8];               // (row, col) x 4 roles, rotated
};

struct Weights {  // layer k: w [M, k-steps, n-tiles, 32, 4] frags, b [M, out]
  const float* w[6];
  const float* b[6];
};

// nf padded to a multiple of 16: the two warps of a pixel group take the
// same number of n-tiles, and the k-steps of every layer but the first come
// in pairs
__host__ __device__ __forceinline__ int padded_nf(int nf) {
  return (nf + 15) & ~15;
}

// k-steps of layer l (0..4 hidden, 5 the head) at padded width nfp: even
// but for layer 1's one
__device__ __forceinline__ int ksteps_of(int l, int nfp) {
  return l == 0 ? 1 : l * nfp / 8;
}

__device__ __forceinline__ int ntiles_of(int l, int nt) {
  return l < 5 ? nt : 1;
}

// k-steps of the chunk that starts at k-step k0 of layer l: an even count
__device__ __forceinline__ int chunk_ksteps(int l, int k0, int nfp, int nt) {
  return min(ksteps_of(l, nfp) - k0,
             (kChunkFloats / kFragFloats / ntiles_of(l, nt)) & ~1);
}

// The weight chunks in the order the block consumes them: member, layer,
// first k-step.
struct Cursor {
  int m, l, k0;

  __device__ __forceinline__ void advance(int nfp, int nt) {
    k0 += chunk_ksteps(l, k0, nfp, nt);
    if (k0 == ksteps_of(l, nfp)) {
      k0 = 0;
      if (++l == 6) {
        l = 0;
        ++m;
      }
    }
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_addr(bar))
               : "memory");
}

// arrive once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the two warps of a 32-pixel group (named barriers 1..kGroups)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(group + 1) : "memory");
}

// Start the copy of the chunk at c into buf.
template <int THREADS>
__device__ __forceinline__ void issue(const Cursor& c, const Weights& wt,
                                      int nfp, int nt, float* buf) {
  const int nts = ntiles_of(c.l, nt);
  const float* src = wt.w[c.l] + ((size_t)c.m * ksteps_of(c.l, nfp) + c.k0) *
                                     nts * kFragFloats;
  const int n16 = chunk_ksteps(c.l, c.k0, nfp, nt) * nts * kFragFloats / 4;
  for (int i = threadIdx.x; i < n16; i += THREADS)
    cp_async16(buf + 4 * i, src + 4 * i);
}

// Row stride of the activation tile in floats: at least 5.nfp, and 8
// mod 32, so that a fragment load (8 rows x 4 float2) is free of bank
// conflicts in each half-warp.
__host__ __device__ constexpr int act_stride(int nfp) {
  int s = 5 * nfp;
  while (s % 32 != 8) ++s;
  return s;
}

// A fragment of rows r, r + 8 of a [.][stride] tile, k-step at column
// col0: lane (g, q) takes columns col0 + 2q and col0 + 2q + 1 as the
// fragment's k = q and k = q + 4 (one 8-byte load a row; the weights' B
// fragments pair the same inputs, so the k-step's sum is unchanged), split
// into hi and lo. hi is x rounded to TF32, to nearest with ties away from
// zero, as the host rounds the weights, in two integer operations; lo =
// x - hi is exact and goes to the tensor core as it is, which reads its top
// 19 bits (lo truncated to TF32, an error of at most 2^-21 of x). No
// conversion instruction: those issue at a quarter of the float32 rate.
__device__ __forceinline__ void load_a(const float* src, int stride, int r,
                                       int col0, int q, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float2 top =
      *reinterpret_cast<const float2*>(src + r * stride + col0 + 2 * q);
  const float2 bot =
      *reinterpret_cast<const float2*>(src + (r + 8) * stride + col0 + 2 * q);
  const float a[4] = {top.x, bot.x, top.y, bot.y};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = (__float_as_uint(a[e]) + 0x1000u) & 0xffffe000u;
    lo[e] = __float_as_uint(a[e] - __uint_as_float(hi[e]));
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// acc[mt][j] += A[mt] . B[j] over KS k-steps (1 or 2) of MT m-tiles and NTW
// n-tiles in ~float32 (3xTF32): the two cross terms, then hi.hi, summed
// from zero in the tensor core, then added to acc with one IEEE add. The
// tensor core aligns its addends to the largest and truncates; starting
// from zero every two k-steps keeps that truncation to 16 products instead
// of the whole running sum, whose error would grow with the fan-in. The
// products go out term by term across the tiles: a tile's products wait
// on each other, the tiles do not. wf[32 (s nt + j)] is k-step s's B
// fragment of n-tile j.
//
// J0, NJ: the n-tiles J0 .. J0 + NJ - 1 of acc. Above 4 n-tiles a warp
// takes them in two calls (kgroup_all): the same operations on each
// accumulator, half the registers for b and t.
template <int KS, int MT, int NTW, int J0 = 0, int NJ = NTW>
__device__ __forceinline__ void kgroup(float (&acc)[MT][NTW][4],
                                       const uint32_t (&ah)[KS][MT][4],
                                       const uint32_t (&al)[KS][MT][4],
                                       const float4* wf, int nt) {
  float4 b[KS][NJ];
  float t[MT][NJ][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[s][j] = wf[32 * (s * nt + J0 + j)];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[mt][j][e] = 0.0f;
#pragma unroll
  for (int term = 0; term < 3; ++term)
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_tf32(t[mt][j], term == 0 ? al[s][mt] : ah[s][mt],
                   term == 1 ? b[s][j].z : b[s][j].x,
                   term == 1 ? b[s][j].w : b[s][j].y);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][J0 + j][e] += t[mt][j][e];
}

template <int KS, int MT, int NTW>
__device__ __forceinline__ void kgroup_all(float (&acc)[MT][NTW][4],
                                           const uint32_t (&ah)[KS][MT][4],
                                           const uint32_t (&al)[KS][MT][4],
                                           const float4* wf, int nt) {
  if constexpr (NTW <= 4) {
    kgroup<KS, MT, NTW>(acc, ah, al, wf, nt);
  } else {
    kgroup<KS, MT, NTW, 0, NTW / 2>(acc, ah, al, wf, nt);
    kgroup<KS, MT, NTW, NTW / 2, NTW - NTW / 2>(acc, ah, al, wf, nt);
  }
}

// NTW: hidden n-tiles per warp, padded_nf(nf) / 16; TILE: pixels a block
template <int OC, int NTW, int TILE>
__global__ void __launch_bounds__(Tile<TILE>::kThreads, 1)
    srnet_ensemble_kernel(const float* __restrict__ img,  // [C, H, W] float32
                          float* __restrict__ out,  // [C, H, W, OC] float32
                          const Members mem, const Weights wt, int C, int H,
                          int W, int nf, float half) {
  constexpr int kTile = TILE, kWarps = Tile<TILE>::kWarps;
  constexpr int kThreads = Tile<TILE>::kThreads;
  constexpr int kGroups = Tile<TILE>::kGroups;
  constexpr int nfp = 16 * NTW, nt = 2 * NTW, stride = act_stride(nfp);
  extern __shared__ float4 smem4[];
  float* wbuf = reinterpret_cast<float*>(smem4);  // [kStages][kChunkFloats]
  float* act = wbuf + kStages * kChunkFloats;     // [kTile][stride]
  float* x4 = act + kTile * stride;               // [kTile][8], 4..7 zero
  // the weight ring's barriers: full[s] completes when buffer s's chunk
  // has landed (every thread arrives as its copies land), empty[s] when
  // every warp has multiplied it
  uint64_t* full = reinterpret_cast<uint64_t*>(x4 + kTile * 8);
  uint64_t* empty = full + kStages;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  // Warps w and w + kGroups share pixel group w % kGroups: in the hidden
  // layers both compute its rows prow + 16 mt + g (+8), each against half
  // the n-tiles (n0 .. n0 + NTW - 1); in the head each takes 16 of them,
  // rows hrow + g (+8). A group reads only activations and samples that
  // its own two warps wrote, so two warps sync on them, not the block.
  const int group = warp % kGroups;
  const int prow = 32 * group;
  const int n0 = (warp / kGroups) * NTW;
  const int hrow = prow + 16 * (warp / kGroups);

  const long long total = (long long)C * H * W;
  const long long base = (long long)blockIdx.x * kTile;
  // the samples this thread gathers: roles 2 gk, 2 gk + 1 of pixel gp (a
  // pixel past the end repeats the last one and is not written)
  const int gp = threadIdx.x % kTile;
  const int gk = threadIdx.x / kTile;
  const long long n = min(base + gp, total - 1);
  const int j = (int)(n % W);
  const long long ci = n / W;
  const int i = (int)(ci % H);
  const float* xc = img + (ci / H) * (long long)H * W;
  // member m's samples, loaded a member ahead so their latency hides
  // behind the previous member's layers
  float xv[2];
  auto gather = [&](int m) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int role = 2 * gk + k;
      const int r = min(max(i + mem.off[m][2 * role], 0), H - 1);
      const int c = min(max(j + mem.off[m][2 * role + 1], 0), W - 1);
      xv[k] = xc[r * W + c];
    }
  };

  // member sums of head outputs (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8,
  // 2q + 1)
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  x4[gp * 8 + 4 + 2 * gk] = x4[gp * 8 + 5 + 2 * gk] = 0.0f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kThreads);
      mbar_init(&empty[s], kWarps);
    }
  }
  __syncthreads();
  // the weight ring: chunk c lands in buffer c % kStages, kStages - 1
  // chunks ahead of the one being multiplied
  Cursor next = {0, 0, 0};
  for (int s = 0; s < kStages - 1; ++s) {
    if (next.m < mem.n) {
      issue<kThreads>(next, wt, nfp, nt, wbuf + s * kChunkFloats);
      next.advance(nfp, nt);
      mbar_arrive_copies(&full[s]);
    }
  }
  gather(0);
  int c = 0;                             // chunks multiplied so far
  for (int m = 0; m < mem.n; ++m) {
    // this thread's samples (the group's pixels); the group's previous
    // reads of x4, in the previous member's layer 1, lie behind a group
    // barrier
    x4[gp * 8 + 2 * gk] = xv[0];
    x4[gp * 8 + 2 * gk + 1] = xv[1];
    if (m + 1 < mem.n) gather(m + 1);
    group_sync(group);
    for (int l = 0; l < 6; ++l) {
      float acc[2][NTW][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][jn][e] = 0.0f;
      // this layer's biases of the columns this thread writes, loaded
      // before its products
      float bf[NTW][2];
      if (l < 5) {
#pragma unroll
        for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = (n0 + jn) * 8 + 2 * q + e;
            bf[jn][e] = col < nf ? __ldg(wt.b[l] + m * nf + col) : 0.0f;
          }
      }
      const int ks = ksteps_of(l, nfp);
      for (int k0 = 0; k0 < ks;) {
        const int kc = chunk_ksteps(l, k0, nfp, nt);
        const int buf = c % kStages;
        mbar_wait(&full[buf], (c / kStages) & 1);
        const float4* wf =
            reinterpret_cast<const float4*>(wbuf + buf * kChunkFloats) + lane;
        if (l == 0) {                    // one k-step, 4 inputs
          uint32_t ah[1][2][4], al[1][2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            load_a(x4, 8, prow + 16 * mt + g, 0, q, ah[0][mt], al[0][mt]);
          kgroup_all(acc, ah, al, wf + 32 * n0, nt);
        } else if (l < 5) {
#pragma unroll 1
          for (int kk = 0; kk < kc; kk += 2) {
            uint32_t ah[2][2][4], al[2][2][4];
#pragma unroll
            for (int s = 0; s < 2; ++s)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
                load_a(act, stride, prow + 16 * mt + g, (k0 + kk + s) * 8, q,
                       ah[s][mt], al[s][mt]);
            kgroup_all(acc, ah, al, wf + 32 * (kk * nt + n0), nt);
          }
        } else {
          float (&hacc)[1][1][4] =
              reinterpret_cast<float (&)[1][1][4]>(acc[0][0]);
#pragma unroll 4
          for (int kk = 0; kk < kc; kk += 2) {
            uint32_t ah[2][1][4], al[2][1][4];
#pragma unroll
            for (int s = 0; s < 2; ++s)
              load_a(act, stride, hrow + g, (k0 + kk + s) * 8, q, ah[s][0],
                     al[s][0]);
            kgroup(hacc, ah, al, wf + 32 * kk, 1);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[buf]);
        // refill the buffer of chunk c - 1 with chunk c + kStages - 1 once
        // every warp has multiplied chunk c - 1: a warp runs up to a chunk
        // ahead of the slowest
        if (next.m < mem.n) {
          const int cn = c + kStages - 1, to = cn % kStages;
          if (cn >= kStages) mbar_wait(&empty[to], (cn / kStages - 1) & 1);
          issue<kThreads>(next, wt, nfp, nt, wbuf + to * kChunkFloats);
          next.advance(nfp, nt);
          mbar_arrive_copies(&full[to]);
        }
        ++c;
        k0 += kc;
      }
      if (l < 5) {
        // bias, ReLU, into feature segment l
#pragma unroll
        for (int jn = 0; jn < NTW; ++jn) {
          const int col = (n0 + jn) * 8 + 2 * q;
          const float b0 = bf[jn][0], b1 = bf[jn][1];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int r = prow + 16 * mt + g;
            float* dst = act + r * stride + l * nfp + col;
            *reinterpret_cast<float2*>(dst) =
                make_float2(fmaxf(acc[mt][jn][0] + b0, 0.0f),
                            fmaxf(acc[mt][jn][1] + b1, 0.0f));
            *reinterpret_cast<float2*>(dst + 8 * stride) =
                make_float2(fmaxf(acc[mt][jn][2] + b0, 0.0f),
                            fmaxf(acc[mt][jn][3] + b1, 0.0f));
          }
        }
        group_sync(group);               // segment l, for the next layer
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 2 * q + (e & 1);
          if (col < OC) {
            const float v = acc[0][0][e] + __ldg(wt.b[5] + m * OC + col);
            sum[e] += rintf(tanhf(v) * half);
          }
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = 2 * q + (e & 1);
    const long long p = base + hrow + g + (e >> 1) * 8;
    if (col < OC && p < total) out[p * OC + col] = sum[e];
  }
}

// ---- launch -----------------------------------------------------------------

// Dynamic shared memory of a block (StackedHeads' smem_bytes on the host).
template <int NTW, int TILE>
constexpr size_t smem_bytes() {
  return (size_t)(kStages * kChunkFloats + TILE * act_stride(16 * NTW) +
                  TILE * 8) *
             sizeof(float) +
         2 * kStages * sizeof(uint64_t);
}

template <int OC, int NTW, int TILE>
int launch(const float* img, float* out, const Members& mem,
           const Weights& wt, int C, int H, int W, int nf, float half,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NTW, TILE>();
  static_assert(smem <= 232448, "a block's shared memory over the opt-in");
  const auto kernel = srnet_ensemble_kernel<OC, NTW, TILE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)C * H * W;
  const long long blocks = (total + TILE - 1) / TILE;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, 2 * TILE, smem, stream>>>(img, out, mem, wt, C,
                                                       H, W, nf, half);
  return (int)cudaGetLastError();
}

template <int OC>
int launch_nf(const float* img, float* out, const Members& mem,
              const Weights& wt, int C, int H, int W, int nf, float half,
              cudaStream_t stream) {
// 128 pixels a block up to nf 64, 64 above
#define LERF_NTW(n)                                                        \
  case n:                                                                  \
    return launch<OC, n, n <= 4 ? 128 : 64>(img, out, mem, wt, C, H, W, nf, \
                                            half, stream);
  switch (padded_nf(nf) / 16) {
    LERF_NTW(1)
    LERF_NTW(2)
    LERF_NTW(3)
    LERF_NTW(4)
    LERF_NTW(5)
    LERF_NTW(6)
    LERF_NTW(7)
    LERF_NTW(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LERF_NTW
}

}  // namespace

// members: host int32 [M, 8] rotated offsets; w*: device B fragments
// [M, k-steps, n-tiles, 32, 4] (StackedHeads.frags): float32 TF32 hi / lo
// pairs; b*: device float32 [M, out].
extern "C" int lerf_srnet_ensemble(
    const void* img, void* out, const void* w1, const void* w2,
    const void* w3, const void* w4, const void* w5, const void* w6,
    const void* b1, const void* b2, const void* b3, const void* b4,
    const void* b5, const void* b6, const void* members, int M, int C, int H,
    int W, int nf, int oc, float half, void* stream) {
  if (M < 1 || M > kMaxMembers || nf < 1 || nf > kMaxNf)
    return (int)cudaErrorInvalidValue;
  if ((long long)C * H * W == 0) return 0;
  Members mem = {};
  mem.n = M;
  const int* src = (const int*)members;
  for (int m = 0; m < M; ++m)
    for (int k = 0; k < 8; ++k) mem.off[m][k] = src[m * 8 + k];
  const void* ws[6] = {w1, w2, w3, w4, w5, w6};
  const void* bs[6] = {b1, b2, b3, b4, b5, b6};
  Weights wt;
  for (int k = 0; k < 6; ++k) {
    wt.w[k] = (const float*)ws[k];
    wt.b[k] = (const float*)bs[k];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (oc) {
    case 1:
      return launch_nf<1>((const float*)img, (float*)out, mem, wt, C, H, W,
                          nf, half, s);
    case 3:
      return launch_nf<3>((const float*)img, (float*)out, mem, wt, C, H, W,
                          nf, half, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
