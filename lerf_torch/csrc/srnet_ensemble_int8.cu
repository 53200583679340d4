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
// nf = 64) would take ~0.35 ms at the tensor cores' int8 rate; the float32
// requantization and head (~5 operations per hidden activation, 320 of them
// per member and pixel) ~0.2 ms at 67 Tflop/s; the bytes (int32 codes in,
// ~0.6 MB of weights, float32 [N, oC] out) less. This first design runs the
// products on the CUDA cores, so instruction throughput, not those bounds,
// sets its pace.
//
// What the design does about it: the layout of K3 — one block of 256
// threads per 64-pixel tile, the members in order, every activation in
// shared memory — with int8 data packed four to a 32-bit word. Activations
// are [features / 4][64 pixels] words (20 KB at nf = 64), weights are stored
// [inputs / 4][outputs] words, so a thread's 4-output x 4-pixel tile takes
// one 16-byte load of each per step and 16 __dp4a (64 int8 multiply-adds).
// The requantization is a __fmul_rn and a __fadd_rn — two IEEE roundings,
// never an FMA — then rintf and the clip, exactly the plain twin's
// arithmetic, so hidden activations are bit-equal to it; only tanhf may
// differ by an ulp. The kernel reads the int32 code image and forms
// code - 128 itself from each member's edge-clamped neighbours, as K3 does
// for floats. Tensor-core int8 (mma.sync / wgmma) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxMembers = 20;          // 5 modes x 4 rotations
constexpr int kTile = 64;                // pixels per block
constexpr int kThreads = 256;
constexpr int kParts = kThreads / kTile; // head-layer input groups

struct Members {
  int n;
  int off[kMaxMembers][8];               // (row, col) x 4 roles, rotated
};

struct QWeights {  // layer k: w [M, in/4, out] int8x4 words, c, b [M, out]
  const int* w[6];
  const float* c[6];
  const float* b[6];
};

__device__ __forceinline__ int requant(int acc, float c, float b) {
  const float v = __fadd_rn(__fmul_rn((float)acc, c), b);
  return (int)fminf(fmaxf(rintf(v), 0.0f), 127.0f);
}

// out word [f/4][p] = int8 x 4 of requant(sum_i w[i][f] . in[i][p]) over
// fan_in/4 words i. Thread t computes features 4*(t / 16) .. +3 (one output
// word) of pixels 4*(t % 16) .. +3.
__device__ __forceinline__ void dense_requant(
    const int* __restrict__ in, int words, const int* __restrict__ w,
    const float* __restrict__ c, const float* __restrict__ b,
    int* __restrict__ out, int nf) {
  const int tiles = (nf / 4) * (kTile / 4);
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int f0 = (t / (kTile / 4)) * 4;
    const int p0 = (t % (kTile / 4)) * 4;
    int acc[4][4];
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[f][p] = 0;
#pragma unroll 4
    for (int i = 0; i < words; ++i) {
      const int4 a = *reinterpret_cast<const int4*>(in + i * kTile + p0);
      const int4 wv =
          __ldg(reinterpret_cast<const int4*>(w + (size_t)i * nf + f0));
      const int wf[4] = {wv.x, wv.y, wv.z, wv.w};
      const int ap[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[f][p] = __dp4a(wf[f], ap[p], acc[f][p]);
    }
    float cf[4], bf[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      cf[f] = __ldg(c + f0 + f);
      bf[f] = __ldg(b + f0 + f);
    }
    int q[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      unsigned word = 0;
#pragma unroll
      for (int f = 0; f < 4; ++f)
        word |= (unsigned)requant(acc[f][p], cf[f], bf[f]) << (8 * f);
      q[p] = (int)word;
    }
    *reinterpret_cast<int4*>(out + (f0 / 4) * kTile + p0) =
        make_int4(q[0], q[1], q[2], q[3]);
  }
}

template <int OC>
__global__ void __launch_bounds__(kThreads) srnet_ensemble_int8_kernel(
    const int* __restrict__ codes,       // [C, H, W] int32, 0..255
    float* __restrict__ out,             // [C, H, W, OC] float32
    const Members mem, const QWeights wt, int C, int H, int W, int nf,
    float half) {
  extern __shared__ int4 smem4[];
  int* act = reinterpret_cast<int*>(smem4);       // [5 nf / 4][kTile] words
  int* x4 = act + (5 * nf / 4) * kTile;           // [kTile] words (4 roles)
  int* red = x4 + kTile;                          // [kParts][OC][kTile]

  const long long total = (long long)C * H * W;
  const long long base = (long long)blockIdx.x * kTile;
  // the sample this thread gathers: role k of pixel p (a pixel past the
  // end repeats the last one and is not written)
  const int gp = threadIdx.x % kTile;
  const int gk = threadIdx.x / kTile;
  const long long n = min(base + gp, total - 1);
  const int j = (int)(n % W);
  const long long ci = n / W;
  const int i = (int)(ci % H);
  const int* xc = codes + (ci / H) * (long long)H * W;
  // head layer: this thread's pixel and input-word range
  const int hp = threadIdx.x % kTile;
  const int part = threadIdx.x / kTile;
  const int words = 5 * nf / 4;
  const int chunk = (words + kParts - 1) / kParts;
  const int i0 = part * chunk;
  const int i1 = min(words, i0 + chunk);

  float sum[OC];
#pragma unroll
  for (int o = 0; o < OC; ++o) sum[o] = 0.0f;

  for (int m = 0; m < mem.n; ++m) {
    const int r = min(max(i + mem.off[m][2 * gk], 0), H - 1);
    const int c = min(max(j + mem.off[m][2 * gk + 1], 0), W - 1);
    const int code = min(max(xc[r * W + c], 0), 255);
    reinterpret_cast<signed char*>(x4)[gp * 4 + gk] =
        (signed char)(code - 128);
    __syncthreads();
    dense_requant(x4, 1, wt.w[0] + (size_t)m * nf, wt.c[0] + m * nf,
                  wt.b[0] + m * nf, act, nf);
    __syncthreads();
    for (int l = 1; l < 5; ++l) {
      dense_requant(act, l * nf / 4, wt.w[l] + (size_t)m * (l * nf / 4) * nf,
                    wt.c[l] + m * nf, wt.b[l] + m * nf,
                    act + (l * nf / 4) * kTile, nf);
      __syncthreads();
    }
    // head: exact int32 partial dots over this thread's input words
    const int* w6 = wt.w[5] + (size_t)m * words * OC;
    int s[OC];
#pragma unroll
    for (int o = 0; o < OC; ++o) s[o] = 0;
    for (int k = i0; k < i1; ++k) {
      const int a = act[k * kTile + hp];
#pragma unroll
      for (int o = 0; o < OC; ++o) s[o] = __dp4a(__ldg(w6 + k * OC + o), a, s[o]);
    }
#pragma unroll
    for (int o = 0; o < OC; ++o) red[(part * OC + o) * kTile + hp] = s[o];
    __syncthreads();
    if (threadIdx.x < kTile) {
#pragma unroll
      for (int o = 0; o < OC; ++o) {
        int acc = 0;
        for (int q = 0; q < kParts; ++q)
          acc += red[(q * OC + o) * kTile + threadIdx.x];
        const float v = __fadd_rn(__fmul_rn((float)acc,
                                            __ldg(wt.c[5] + m * OC + o)),
                                  __ldg(wt.b[5] + m * OC + o));
        sum[o] += rintf(__fmul_rn(tanhf(v), half));
      }
    }
    // the next member's x4 writes touch neither red nor act, and its first
    // act write comes after the next __syncthreads
  }
  if (threadIdx.x < kTile && base + threadIdx.x < total) {
#pragma unroll
    for (int o = 0; o < OC; ++o) out[(base + threadIdx.x) * OC + o] = sum[o];
  }
}

template <int OC>
int launch(const int* codes, float* out, const Members& mem,
           const QWeights& wt, int C, int H, int W, int nf, float half,
           cudaStream_t stream) {
  const size_t smem =
      (size_t)((5 * nf / 4) + 1 + kParts * OC) * kTile * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      srnet_ensemble_int8_kernel<OC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)C * H * W;
  const long long blocks = (total + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  srnet_ensemble_int8_kernel<OC><<<(unsigned)blocks, kThreads, smem, stream>>>(
      codes, out, mem, wt, C, H, W, nf, half);
  return (int)cudaGetLastError();
}

}  // namespace

// members: host int32 [M, 8] rotated offsets; w*: device int32 words
// [M, in/4, out]; c*, b*: device float32 [M, out].
extern "C" int lerf_srnet_ensemble_int8(
    const void* codes, void* out, const void* w1, const void* w2,
    const void* w3, const void* w4, const void* w5, const void* w6,
    const void* c1, const void* c2, const void* c3, const void* c4,
    const void* c5, const void* c6, const void* b1, const void* b2,
    const void* b3, const void* b4, const void* b5, const void* b6,
    const void* members, int M, int C, int H, int W, int nf, int oc,
    float half, void* stream) {
  if (M < 1 || M > kMaxMembers || nf < 4 || nf % 4 != 0)
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
      return launch<1>((const int*)codes, (float*)out, mem, wt, C, H, W, nf,
                       half, s);
    case 3:
      return launch<3>((const int*)codes, (float*)out, mem, wt, C, H, W, nf,
                       half, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
