// K3: the float SRUnit (micro-net) ensemble of one stage — every mode x 4
// rotations, sampling included — for sm_90a.
//
// Replaces: lerf_tpu/ops/pallas/srnet_kernel.py, _ensemble_sum_flat (the
// pl.pallas_call at :94) with _make_kernel and ensemble_sum_on_image. For
// each pixel it computes  sum_m round(tanh(W6.[h1..h5] + b6) * half)  where
// h1 = relu(W1.x4_m + b1), hk = relu(Wk.[h1..hk-1] + bk), k = 2..5, and x4_m
// are the member's 4 edge-clamped neighbours.
//
// What bounds it on the H100: float32 arithmetic. One member costs
// 4.nf + nf.(nf+2nf+3nf+4nf) + 5nf.oC multiply-adds per pixel (41,536 at
// nf = 64, oC = 1), so a 3 x 360 x 640 stage is ~6.9e11 flop against the
// card's 67 Tflop/s of float32 outside the tensor cores (~10 ms); the image
// in, ~2 MB of weights and the [N, oC] result out are a few MB of bytes.
//
// What the design does about it: one block of 256 threads owns a tile of 64
// pixels and walks the members in order, as the Pallas kernel walks its
// unrolled member loop. The tile's activations [5.nf][64] (80 KB at nf = 64)
// live in shared memory for the whole chain, so no activation touches device
// memory; each thread computes a 4-feature x 4-pixel register tile of every
// dense layer with explicit fmaf (16 fma per two 16-byte loads: a float4 of
// activations from shared memory, a float4 of weights through L1 — the
// weights stay [in][out] as the params hold them, so 4 outputs of one input
// are adjacent, and all 12 members' ~2 MB stay resident in L2). Two blocks
// fit on an SM. The head layer (oC outputs over 5.nf inputs) splits its
// inputs over 4 thread groups and reduces in shared memory. The member sum
// is a per-pixel float32 register of the first 64 threads. The sampling is
// the kernel's own: the member's rotated offsets are a by-value parameter
// (as in K2) and each index is clamped to the image, which replaces the
// all-sides edge pad, so no [M, 4, N] operand exists in device memory.
//
// Numbers: full float32 on the CUDA cores (no TF32, no bf16). The products
// use explicit fmaf (one rounding per multiply-add) whatever --fmad says;
// against the plain twin only the summation order differs, which can move a
// member's round(tanh * half) at a .5 edge: callers hold the sums within 2.
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

struct Weights {                         // layer k: w [M, in, out], b [M, out]
  const float* w[6];
  const float* b[6];
};

// out[f][p] = relu(b[f] + sum_i w[i][f] * in[i][p]), f < nf, p < kTile.
// Thread t computes features 4*(t / 16) .. +3 of pixels 4*(t % 16) .. +3.
__device__ __forceinline__ void dense_relu(
    const float* __restrict__ in, int fan_in, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ out, int nf) {
  const int tiles = (nf / 4) * (kTile / 4);
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int f0 = (t / (kTile / 4)) * 4;
    const int p0 = (t % (kTile / 4)) * 4;
    float acc[4][4];
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[f][p] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < fan_in; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(in + i * kTile + p0);
      const float4 wv =
          __ldg(reinterpret_cast<const float4*>(w + (size_t)i * nf + f0));
      const float wf[4] = {wv.x, wv.y, wv.z, wv.w};
      const float ap[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[f][p] = fmaf(wf[f], ap[p], acc[f][p]);
    }
    const float4 bv = __ldg(reinterpret_cast<const float4*>(b + f0));
    const float bf[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      float4 o;
      o.x = fmaxf(acc[f][0] + bf[f], 0.0f);
      o.y = fmaxf(acc[f][1] + bf[f], 0.0f);
      o.z = fmaxf(acc[f][2] + bf[f], 0.0f);
      o.w = fmaxf(acc[f][3] + bf[f], 0.0f);
      *reinterpret_cast<float4*>(out + (f0 + f) * kTile + p0) = o;
    }
  }
}

template <int OC>
__global__ void __launch_bounds__(kThreads, 2) srnet_ensemble_kernel(
    const float* __restrict__ img,       // [C, H, W] float32
    float* __restrict__ out,             // [C, H, W, OC] float32
    const Members mem, const Weights wt, int C, int H, int W, int nf,
    float half) {
  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);   // [5 nf][kTile]
  float* x4 = act + 5 * nf * kTile;               // [4][kTile]
  float* red = x4 + 4 * kTile;                    // [kParts][OC][kTile]

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
  const float* xc = img + (ci / H) * (long long)H * W;
  // head layer: this thread's pixel and input range
  const int hp = threadIdx.x % kTile;
  const int part = threadIdx.x / kTile;
  const int chunk = (5 * nf + kParts - 1) / kParts;
  const int i0 = part * chunk;
  const int i1 = min(5 * nf, i0 + chunk);

  float sum[OC];
#pragma unroll
  for (int o = 0; o < OC; ++o) sum[o] = 0.0f;

  for (int m = 0; m < mem.n; ++m) {
    const int r = min(max(i + mem.off[m][2 * gk], 0), H - 1);
    const int c = min(max(j + mem.off[m][2 * gk + 1], 0), W - 1);
    x4[gk * kTile + gp] = xc[r * W + c];
    __syncthreads();
    dense_relu(x4, 4, wt.w[0] + (size_t)m * 4 * nf, wt.b[0] + m * nf, act,
               nf);
    __syncthreads();
    for (int l = 1; l < 5; ++l) {
      dense_relu(act, l * nf, wt.w[l] + (size_t)m * l * nf * nf,
                 wt.b[l] + m * nf, act + l * nf * kTile, nf);
      __syncthreads();
    }
    // head: partial sums over this thread's input range
    const float* w6 = wt.w[5] + (size_t)m * 5 * nf * OC;
    float s[OC];
#pragma unroll
    for (int o = 0; o < OC; ++o) s[o] = 0.0f;
    for (int k = i0; k < i1; ++k) {
      const float a = act[k * kTile + hp];
#pragma unroll
      for (int o = 0; o < OC; ++o) s[o] = fmaf(__ldg(w6 + k * OC + o), a, s[o]);
    }
#pragma unroll
    for (int o = 0; o < OC; ++o) red[(part * OC + o) * kTile + hp] = s[o];
    __syncthreads();
    if (threadIdx.x < kTile) {
#pragma unroll
      for (int o = 0; o < OC; ++o) {
        float v = red[o * kTile + threadIdx.x];
        for (int q = 1; q < kParts; ++q)
          v += red[(q * OC + o) * kTile + threadIdx.x];
        v += __ldg(wt.b[5] + m * OC + o);
        sum[o] += rintf(tanhf(v) * half);
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
int launch(const float* img, float* out, const Members& mem,
           const Weights& wt, int C, int H, int W, int nf, float half,
           cudaStream_t stream) {
  const size_t smem = (size_t)(5 * nf + 4 + kParts * OC) * kTile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      srnet_ensemble_kernel<OC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)C * H * W;
  const long long blocks = (total + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  srnet_ensemble_kernel<OC><<<(unsigned)blocks, kThreads, smem, stream>>>(
      img, out, mem, wt, C, H, W, nf, half);
  return (int)cudaGetLastError();
}

}  // namespace

// members: host int32 [M, 8] rotated offsets; w*/b*: device float32 stacks.
extern "C" int lerf_srnet_ensemble(
    const void* img, void* out, const void* w1, const void* w2,
    const void* w3, const void* w4, const void* w5, const void* w6,
    const void* b1, const void* b2, const void* b3, const void* b4,
    const void* b5, const void* b6, const void* members, int M, int C, int H,
    int W, int nf, int oc, float half, void* stream) {
  if (M < 1 || M > kMaxMembers || nf < 4 || nf % 4 != 0)
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
      return launch<1>((const float*)img, (float*)out, mem, wt, C, H, W, nf,
                       half, s);
    case 3:
      return launch<3>((const float*)img, (float*)out, mem, wt, C, H, W, nf,
                       half, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
