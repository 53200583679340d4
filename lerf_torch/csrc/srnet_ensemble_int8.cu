// K4: the int8 SRUnit (micro-net) ensemble of one stage — every mode x 4
// rotations, sampling included — for sm_90a.
//
// Replaces: lerf_tpu/ops/pallas/srnet_kernel_int8.py, _ensemble_sum_flat_int8
// (the pl.pallas_call at :190) with _make_kernel_int8, _requant and
// _sample_x4q. The chain is K3's with int8 weights and activations: int32
// dot products, each hidden layer requantized as clip(rint(float(acc) * c +
// b), 0, 127) (the clip at 0 is the ReLU), the head tanh(float(acc) * c6 +
// b6) in float32, and sum_m round(head * half) per pixel.
//
// What bounds it on the H100: the int8 multiply-adds (~3.4e11 a stage at
// nf = 64) take ~0.35 ms at the tensor cores' int8 rate; the float32
// requantization and head (~5 operations per hidden activation, 320 of them
// per member and pixel) ~0.2 ms at 67 Tflop/s; the bytes (int32 codes in,
// ~0.5 MB of weights, float32 [N, oC] out) less.
//
// What the design does about it:
// - Every layer is a matrix product on mma.sync.m16n8k32 (s8 x s8 -> s32):
//   16 pixels a fragment row block (M), 8 outputs an n-tile (N), 32 inputs
//   a k-step. Integer products and sums are exact in any order, so the
//   accumulators equal the plain twin's int32 dots.
// - The weights come from the host in B-fragment order (QuantHeads.frags):
//   per k-step and n-tile, each lane's two words of four consecutive inputs
//   of one output, 8 bytes. Fan-ins are padded to a multiple of 32 and nf
//   to a multiple of 8 with zero weights (exact); layer 1's 4 inputs take
//   one k-step.
// - A block of 8 warps owns 128 pixels and walks the members in order; two
//   blocks share an SM up to nf 64, one above (nf up to 128: 83 KB of
//   activations). The tile's int8 activations [128][5.nf] (42 KB at
//   nf = 64, rows padded so the fragment loads are free of bank conflicts)
//   stay in shared memory. In the hidden layers warp w computes pixels
//   32.(w % 4) .. +31 (two m-tiles) against half the n-tiles; the
//   requantization runs on the accumulator fragments in registers — a
//   __fmul_rn and a __fadd_rn (two IEEE roundings, never an FMA), rintf and
//   the clip, the plain twin's arithmetic, without conversion instructions
//   (requant) — and stores int8 activations for the next layer. In the
//   head (oC outputs padded to one n-tile) warp w computes pixels
//   16.w .. +15, and those threads keep the member sum in registers.
// - The weights stream through shared memory in 16 KB chunks with
//   cp.async, a ring of 4 buffers: 3 chunks (about one member's weights at
//   nf = 64) load while the tensor cores work on the fourth. Each weight is
//   read from L2 once per 128 pixels: 12 members x 45 KB x 5,400 tiles
//   ~ 2.9 GB a stage at nf = 64, where the 64-pixel __dp4a design read
//   ~5.4 GB.
// - The kernel reads the int32 code image and forms code - 128 itself from
//   each member's edge-clamped neighbours, as K3 does for floats.
//
// Hidden activations are bit-equal to the plain twin's; only tanhf may
// differ by an ulp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxMembers = 20;          // 5 modes x 4 rotations
constexpr int kMaxNf = 128;
constexpr int kTile = 128;               // pixels per block; 2 blocks an SM
constexpr int kWarps = kTile / 16;       // the head gives each warp an m-tile
constexpr int kThreads = 32 * kWarps;
constexpr int kGroups = kWarps / 2;      // hidden layers: 32-pixel groups
constexpr int kFragWords = 64;           // one (k-step, n-tile) B fragment
constexpr int kChunkWords = 4096;        // 16 KB a weight buffer
constexpr int kStages = 4;               // weight buffers: 3 chunks in flight

struct Members {
  int n;
  int off[kMaxMembers][8];               // (row, col) x 4 roles, rotated
};

struct QWeights {  // layer k: w [M, k-steps, n-tiles, 32, 8] int8 frags,
  const int* w[6];                       // c, b [M, out]
  const float* c[6];
  const float* b[6];
};

// nf padded to a multiple of 16, so the two warps of a pixel group take
// the same number of n-tiles
__host__ __device__ __forceinline__ int padded_nf(int nf) {
  return (nf + 15) & ~15;
}

// k-steps of layer l (0..4 hidden, 5 the head) at padded width nfp
__device__ __forceinline__ int ksteps_of(int l, int nfp) {
  return l == 0 ? 1 : (l * nfp + 31) / 32;
}

__device__ __forceinline__ int ntiles_of(int l, int nt) {
  return l < 5 ? nt : 1;
}

__device__ __forceinline__ int chunk_ksteps(int l, int k0, int nfp, int nt) {
  return min(ksteps_of(l, nfp) - k0,
             kChunkWords / (ntiles_of(l, nt) * kFragWords));
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until the oldest chunk still in flight has landed
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// Start the copy of the chunk at c into buf.
__device__ __forceinline__ void issue(const Cursor& c, const QWeights& wt,
                                      int nfp, int nt, int* buf) {
  const int nts = ntiles_of(c.l, nt);
  const int* src = wt.w[c.l] + ((size_t)c.m * ksteps_of(c.l, nfp) + c.k0) *
                                   nts * kFragWords;
  const int n16 = chunk_ksteps(c.l, c.k0, nfp, nt) * nts * kFragWords / 4;
  for (int i = threadIdx.x; i < n16; i += kThreads)
    cp_async16(buf + 4 * i, src + 4 * i);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       int2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// A fragment: rows r, r + 8, input bytes col .. +3 and col + 16 .. +19 of
// the activation tile (row stride in words)
__device__ __forceinline__ void load_a(const int* act, int wstride, int r,
                                       int col, int (&a)[4]) {
  const int w = col / 4;
  a[0] = act[r * wstride + w];
  a[1] = act[(r + 8) * wstride + w];
  a[2] = act[r * wstride + w + 4];
  a[3] = act[(r + 8) * wstride + w + 4];
}

constexpr float kMagic = 12582912.0f;    // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;

// clip(rint(float(acc) * c + b), 0, 127) in the low byte: a multiply and
// an add, each rounded on its own (never an FMA), rint half to even.
// Without conversion instructions, which issue at a quarter of the float32
// rate: an int32 |acc| < 2^22 is exactly magic + acc - magic, and for v in
// [0, 127] the low byte of v + magic is rint(v) (clipping first and
// rounding after gives the same integer). A hidden layer's |acc| <= 127 *
// 127 * 4 * 64 < 2^22 at nf <= 64; above (WIDE), up to 127 * 127 * 4 * 128
// < 2^23, acc converts with an I2F, exact below 2^24.
template <bool WIDE>
__device__ __forceinline__ unsigned requant(int acc, float c, float b) {
  const float a = WIDE ? (float)acc
                       : __fsub_rn(__int_as_float(kMagicBits + acc), kMagic);
  const float v = __fadd_rn(__fmul_rn(a, c), b);
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, 0.0f), 127.0f), kMagic));
}

// Row stride of the activation tile in words: every k-step a layer reads
// lies inside the row, and stride % 8 == 4 spreads a fragment load's 8
// rows x 4 words over the 32 banks.
__host__ __device__ __forceinline__ int act_words(int nfp) {
  int w = (5 * nfp + 31) / 32 * 8;
  while (w % 8 != 4) ++w;
  return w;
}

// NTW: hidden n-tiles per warp, padded_nf(nf) / 16
template <int OC, int NTW>
__global__ void __launch_bounds__(kThreads, NTW <= 4 ? 2 : 1)
    srnet_ensemble_int8_kernel(
    const int* __restrict__ codes,       // [C, H, W] int32, 0..255
    float* __restrict__ out,             // [C, H, W, OC] float32
    const Members mem, const QWeights wt, int C, int H, int W, int nf,
    float half) {
  constexpr int nfp = 16 * NTW, nt = 2 * NTW;
  const int wstride = act_words(nfp);
  extern __shared__ int4 smem4[];
  int* wbuf = reinterpret_cast<int*>(smem4);     // [kStages][kChunkWords]
  int* act = wbuf + kStages * kChunkWords;       // [kTile][wstride] words
  int* x4 = act + kTile * wstride;               // [kTile] words (4 roles)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  // hidden layers: rows prow + 16 mt + g (+8), n-tiles n0 .. n0 + NTW - 1
  const int prow = 32 * (warp % kGroups);
  const int n0 = (warp / kGroups) * NTW;
  // head: rows hrow + g (+8)
  const int hrow = 16 * warp;

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
  const int* xc = codes + (ci / H) * (long long)H * W;
  // member m's samples, loaded a member ahead so their latency hides
  // behind the previous member's layers
  int xv[2];
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

  // the weight ring: chunk c lands in buffer c % kStages, kStages - 1
  // chunks ahead of the one being multiplied
  Cursor next = {0, 0, 0};
  for (int s = 0; s < kStages - 1; ++s) {
    if (next.m < mem.n) {
      issue(next, wt, nfp, nt, wbuf + s * kChunkWords);
      next.advance(nfp, nt);
    }
    cp_async_commit();
  }
  gather(0);
  int buf = 0;
  for (int m = 0; m < mem.n; ++m) {
    // x4 was last read by the previous member's layer 1, several barriers
    // ago; the first chunk's barrier below publishes these writes
#pragma unroll
    for (int k = 0; k < 2; ++k)
      reinterpret_cast<signed char*>(x4)[gp * 4 + 2 * gk + k] =
          (signed char)(min(max(xv[k], 0), 255) - 128);
    if (m + 1 < mem.n) gather(m + 1);
    for (int l = 0; l < 6; ++l) {
      int acc[2][NTW][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][jn][e] = 0;
      // this layer's scales and biases of the columns this thread
      // requantizes, loaded before its products
      float cf[NTW][2], bf[NTW][2];
      if (l < 5) {
#pragma unroll
        for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = (n0 + jn) * 8 + 2 * q + e;
            cf[jn][e] = col < nf ? __ldg(wt.c[l] + m * nf + col) : 0.0f;
            bf[jn][e] = col < nf ? __ldg(wt.b[l] + m * nf + col) : 0.0f;
          }
      }
      const int ks = ksteps_of(l, nfp);
      for (int k0 = 0; k0 < ks;) {
        const int kc = chunk_ksteps(l, k0, nfp, nt);
        cp_async_wait_oldest();
        // one barrier a chunk: it publishes this chunk and the previous
        // layer's activations, and frees the buffer refilled below (read
        // in the previous chunk). Activation writes cannot race reads: a
        // layer's epilogue writes only its own segment, which no warp
        // reads before the next chunk's barrier.
        __syncthreads();
        if (next.m < mem.n) {
          issue(next, wt, nfp, nt,
                wbuf + (buf + kStages - 1) % kStages * kChunkWords);
          next.advance(nfp, nt);
        }
        cp_async_commit();
        const int2* wf =
            reinterpret_cast<const int2*>(wbuf + buf * kChunkWords);
        if (l < 5) {
#pragma unroll 2
          for (int kk = 0; kk < kc; ++kk) {
            int a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const int r = prow + 16 * mt + g;
              if (l == 0) {              // 4 input bytes, k-step 0 only
                a[mt][0] = q == 0 ? x4[r] : 0;
                a[mt][1] = q == 0 ? x4[r + 8] : 0;
                a[mt][2] = a[mt][3] = 0;
              } else {
                load_a(act, wstride, r, (k0 + kk) * 32 + 4 * q, a[mt]);
              }
            }
#pragma unroll
            for (int jn = 0; jn < NTW; ++jn) {
              const int2 b = wf[(kk * nt + n0 + jn) * 32 + lane];
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][jn], a[mt], b);
            }
          }
        } else {
#pragma unroll 2
          for (int kk = 0; kk < kc; ++kk) {
            int a[4];
            load_a(act, wstride, hrow + g, (k0 + kk) * 32 + 4 * q, a);
            mma_s8(acc[0][0], a, wf[kk * 32 + lane]);
          }
        }
        buf = (buf + 1) % kStages;
        k0 += kc;
      }
      if (l < 5) {
        // requantize into feature segment l: two columns' low bytes,
        // packed by one byte permute
        unsigned char* bytes = reinterpret_cast<unsigned char*>(act);
#pragma unroll
        for (int jn = 0; jn < NTW; ++jn) {
          const int col = (n0 + jn) * 8 + 2 * q;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = prow + 16 * mt + g + 8 * h;
              const unsigned v = __byte_perm(
                  requant<(NTW > 4)>(acc[mt][jn][2 * h], cf[jn][0],
                                     bf[jn][0]),
                  requant<(NTW > 4)>(acc[mt][jn][2 * h + 1], cf[jn][1],
                                     bf[jn][1]),
                  0x0040);
              *reinterpret_cast<unsigned short*>(
                  bytes + r * wstride * 4 + l * nfp + col) = (unsigned short)v;
            }
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 2 * q + (e & 1);
          if (col < OC) {
            const float v = __fadd_rn(
                __fmul_rn((float)acc[0][0][e], __ldg(wt.c[5] + m * OC + col)),
                __ldg(wt.b[5] + m * OC + col));
            sum[e] += rintf(__fmul_rn(tanhf(v), half));
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

template <int OC, int NTW>
int launch(const int* codes, float* out, const Members& mem,
           const QWeights& wt, int C, int H, int W, int nf, float half,
           cudaStream_t stream) {
  const size_t smem =
      (size_t)(kStages * kChunkWords + kTile * act_words(16 * NTW) + kTile) *
      sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      srnet_ensemble_int8_kernel<OC, NTW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)C * H * W;
  const long long blocks = (total + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  srnet_ensemble_int8_kernel<OC, NTW>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(codes, out, mem, wt, C,
                                                     H, W, nf, half);
  return (int)cudaGetLastError();
}

template <int OC>
int launch_nf(const int* codes, float* out, const Members& mem,
              const QWeights& wt, int C, int H, int W, int nf, float half,
              cudaStream_t stream) {
  switch (padded_nf(nf) / 16) {
    case 1:
      return launch<OC, 1>(codes, out, mem, wt, C, H, W, nf, half, stream);
    case 2:
      return launch<OC, 2>(codes, out, mem, wt, C, H, W, nf, half, stream);
    case 3:
      return launch<OC, 3>(codes, out, mem, wt, C, H, W, nf, half, stream);
    case 4:
      return launch<OC, 4>(codes, out, mem, wt, C, H, W, nf, half, stream);
    case 5:
      return launch<OC, 5>(codes, out, mem, wt, C, H, W, nf, half, stream);
    case 6:
      return launch<OC, 6>(codes, out, mem, wt, C, H, W, nf, half, stream);
    case 7:
      return launch<OC, 7>(codes, out, mem, wt, C, H, W, nf, half, stream);
    case 8:
      return launch<OC, 8>(codes, out, mem, wt, C, H, W, nf, half, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// members: host int32 [M, 8] rotated offsets; w*: device int8 B fragments
// [M, k-steps, n-tiles, 32, 8] (QuantHeads.frags); c*, b*: device float32
// [M, out].
extern "C" int lerf_srnet_ensemble_int8(
    const void* codes, void* out, const void* w1, const void* w2,
    const void* w3, const void* w4, const void* w5, const void* w6,
    const void* c1, const void* c2, const void* c3, const void* c4,
    const void* c5, const void* c6, const void* b1, const void* b2,
    const void* b3, const void* b4, const void* b5, const void* b6,
    const void* members, int M, int C, int H, int W, int nf, int oc,
    float half, void* stream) {
  if (M < 1 || M > kMaxMembers || nf < 1 || nf > kMaxNf)
    return (int)cudaErrorInvalidValue;
  if ((long long)C * H * W == 0) return 0;
  Members mem = {};
  mem.n = M;
  const int* src = (const int*)members;
  for (int m = 0; m < M; ++m)
    for (int k = 0; k < 8; ++k) mem.off[m][k] = src[m * 8 + k];
  const void* ws[6] = {w1, w2, w3, w4, w5, w6};
  const void* cs[6] = {c1, c2, c3, c4, c5, c6};
  const void* bs[6] = {b1, b2, b3, b4, b5, b6};
  QWeights wt;
  for (int k = 0; k < 6; ++k) {
    wt.w[k] = (const int*)ws[k];
    wt.c[k] = (const float*)cs[k];
    wt.b[k] = (const float*)bs[k];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (oc) {
    case 1:
      return launch_nf<1>((const int*)codes, (float*)out, mem, wt, C, H, W,
                          nf, half, s);
    case 3:
      return launch_nf<3>((const int*)codes, (float*)out, mem, wt, C, H, W,
                          nf, half, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
