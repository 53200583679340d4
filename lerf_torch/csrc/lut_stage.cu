// K2: one whole LUT stage — every mode x 4 rotations of the 4D-simplex
// ensemble plus the stage epilogue — for sm_90a.
//
// Replaces: the LUT-stage ensemble of lerf_tpu/ops/lut_pipeline.py
// (lut_ensemble / lut_ensemble_packed with lut_stage1,
// lut_stage1_intermediate and lut_stage2; simplex arithmetic from
// lerf_tpu/ops/simplex.py: simplex4d, simplex_weights16, round_half_even_div).
// On the TPU these were XLA gathers, not a Pallas kernel: Mosaic cannot
// express the table lookup.
//
// What bounds it on the H100: neither device-memory bytes (the image in, the
// int32 result out and at most ~1.5 MB of int8 tables) nor arithmetic (5
// multiply-adds per member and output channel plus the rank sort) is close
// to the kernel's time at the first design; the 5 scattered table reads per
// member and channel, 60 (stage 1) or 180 (stage 2) per pixel, are served by
// L1/L2 and their latency sets the pace.
//
// What the design does about it: one thread per (channel, pixel), pixel
// column fastest.  The tables stay flat int8 [L^4, oC] (one stage's tables
// are <= 6 x 83,521 x 3 B, so they stay resident in the 50 MB L2 across the
// whole launch), the oC values of one corner are adjacent bytes, and the 4
// samples of each member are edge-clamped reads of the unpadded image
// (== the all-sides edge pad of the JAX path).  Every member's sum and the
// epilogue stay in registers: one launch reads the image once and writes the
// stage output once, with no [members, ...] intermediates in device memory.
// The member geometry (rotated offsets, table index) is a kernel parameter,
// uniform across the warp, so it comes from the constant cache.
// All arithmetic is int32 and the division is an exact round-half-to-even,
// so the result is bit-equal to the plain twin and to lerf_tpu.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxMembers = 20;          // 5 modes x 4 rotations

struct Members {
  int n;
  int off[kMaxMembers][8];               // (row, col) x 4 roles, rotated
  int table[kMaxMembers];                // index of the member's table
};

template <int OC>
__global__ void lut_stage_kernel(
    const int* __restrict__ img,            // [C, H, W] int32, 0..255
    const signed char* __restrict__ tables, // [K, L4, OC] int8
    int* __restrict__ out,                  // [C, H, W, OC] int32
    const Members mem, int C, int H, int W, int L4, int interval,
    int den, int bias, int norm) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long total = (long long)C * H * W;
  if (idx >= total) return;
  const int j = (int)(idx % W);
  const long long ci = idx / W;
  const int i = (int)(ci % H);
  const int c = (int)(ci / H);
  const int* x = img + (size_t)c * H * W;

  const int q = 1 << interval;
  const int mask = q - 1;
  const int L = (1 << (8 - interval)) + 1;
  const int step[4] = {L * L * L, L * L, L, 1};   // corner raise per role

  int acc[OC];
#pragma unroll
  for (int ch = 0; ch < OC; ++ch) acc[ch] = 0;

  for (int m = 0; m < mem.n; ++m) {
    int v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = min(max(i + mem.off[m][2 * k], 0), H - 1);
      const int cc = min(max(j + mem.off[m][2 * k + 1], 0), W - 1);
      v[k] = x[r * W + cc];
    }
    const int base = (((v[0] >> interval) * L + (v[1] >> interval)) * L
                      + (v[2] >> interval)) * L + (v[3] >> interval);
    const int f[4] = {v[0] & mask, v[1] & mask, v[2] & mask, v[3] & mask};
    // rank 0 = largest fraction; the later role wins ties (simplex.py)
    const int fab = f[0] > f[1], fac = f[0] > f[2], fad = f[0] > f[3];
    const int fbc = f[1] > f[2], fbd = f[1] > f[3], fcd = f[2] > f[3];
    const int rank[4] = {3 - (fab + fac + fad),
                         3 - ((1 - fab) + fbc + fbd),
                         3 - ((1 - fac) + (1 - fbc) + fcd),
                         3 - ((1 - fad) + (1 - fbd) + (1 - fcd))};
    int vt[4] = {0, 0, 0, 0};
    int ot[4] = {0, 0, 0, 0};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        vt[t] += rank[k] == t ? f[k] : 0;
        ot[t] += rank[k] == t ? step[k] : 0;
      }
    }
    const int c1 = base + ot[0];
    const int c2 = c1 + ot[1];
    const int c3 = c2 + ot[2];
    const int c4 = c3 + ot[3];
    const int w0 = q - vt[0], w1 = vt[0] - vt[1], w2 = vt[1] - vt[2];
    const int w3 = vt[2] - vt[3], w4 = vt[3];
    const signed char* tab = tables + (size_t)mem.table[m] * L4 * OC;
#pragma unroll
    for (int ch = 0; ch < OC; ++ch) {
      acc[ch] += w0 * tab[base * OC + ch] + w1 * tab[c1 * OC + ch]
                 + w2 * tab[c2 * OC + ch] + w3 * tab[c3 * OC + ch]
                 + w4 * tab[c4 * OC + ch];
    }
  }

  // epilogue: round_half_even(clip(acc + bias*den, 0, norm*den) / den)
#pragma unroll
  for (int ch = 0; ch < OC; ++ch) {
    const int num = min(max(acc[ch] + bias * den, 0), norm * den);
    const int qd = num / den;
    const int twice = 2 * (num % den);
    const int up = (twice > den) || (twice == den && (qd & 1));
    out[idx * OC + ch] = qd + up;
  }
}

template <int OC>
void launch(const void* img, const void* tables, void* out,
            const Members& mem, int C, int H, int W, int L4, int interval,
            int den, int bias, int norm, cudaStream_t stream) {
  const long long total = (long long)C * H * W;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  lut_stage_kernel<OC><<<(unsigned)blocks, threads, 0, stream>>>(
      (const int*)img, (const signed char*)tables, (int*)out, mem,
      C, H, W, L4, interval, den, bias, norm);
}

}  // namespace

// members: host int32 [M, 9] — 8 rotated offsets, then the table index.
extern "C" int lerf_lut_stage(
    const void* img, const void* tables, void* out, const void* members,
    int M, int C, int H, int W, int oc, int L4, int interval, int den,
    int bias, int norm, void* stream) {
  if (M < 1 || M > kMaxMembers) return (int)cudaErrorInvalidValue;
  const long long total = (long long)C * H * W;
  if (total == 0) return 0;
  if ((total + 255) / 256 > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  Members mem = {};
  mem.n = M;
  const int* src = (const int*)members;
  for (int m = 0; m < M; ++m) {
    for (int k = 0; k < 8; ++k) mem.off[m][k] = src[m * 9 + k];
    mem.table[m] = src[m * 9 + 8];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (oc) {
    case 1:
      launch<1>(img, tables, out, mem, C, H, W, L4, interval, den, bias,
                norm, s);
      break;
    case 3:
      launch<3>(img, tables, out, mem, C, H, W, L4, interval, den, bias,
                norm, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* lerf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
