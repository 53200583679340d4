// K5: steerable-Gaussian homographic warp from the stage-2 codes, for sm_90a.
//
// Replaces: the support-2 warp of lerf_tpu/ops/resample.py::
// steering_gaussian_warp (u8_inputs=True), which on the TPU is no Pallas
// kernel but an XLA row gather (_rowpack_warp_gather) followed by some twenty
// elementwise passes, and the NaN -> 0 uint8 epilogue of
// lerf_tpu/pipeline.py::_quantize_device(nan_to_zero=True).  The plain
// PyTorch twin is lerf_torch/ops/resample.py::steering_warp_codes_plain.
//
// What bounds it on the H100: bytes.  At 3x360x640 -> 1440x2560 the function
// reads 11 MB of int32 feature and codes and 88 MB of per-pixel geometry
// (24 bytes an output pixel) and writes 11 MB of uint8: 0.033 ms at
// 3.35 TB/s; its 0.68 G float32 operations (chip_smoke.k5_work) take
// 0.010 ms at 67 T/s.  It measures 0.187 ms on an H100 (700 W), the
// float32 mode with 4x the output bytes the same, so the instructions
// (three IEEE divisions and an expf a neighbour and channel) are the
// likelier limit (PERF.md).
//
// What the design does about it: one thread per output pixel, all C
// channels, so the geometry (one 8-byte corner and one 16-byte distance load,
// both coalesced) is read once a pixel and not once a channel; the output is
// written once, as uint8 on the main path, with no float32 intermediate in
// device memory.  The 2x2 source windows of neighbouring outputs overlap (a
// x4 zoom reads each source pixel ~16 times), so the gathers of feature and
// codes mostly hit L1 / L2.  A source tile in shared memory and geometry
// computed on the card are later work.
//
// Semantics, those of the JAX path's geometry (lerf_tpu/ops/geometry.py::
// _warp_axis): a pixel's two rows are clip(corner + s, 0, H - 1) in padded
// coordinates, clipped to the UNPADDED bounds, and its source row is that
// minus pad_r (0 or 1); source row -1 is the pad row, where the feature is 0
// (constant pad) and the codes are row 0's (edge pad); likewise columns.
// Neighbours run (0,0), (0,1), (1,0), (1,1); the codes decode as
// code / norm * 2 - 1 and code / norm * max_sigma; the weight is
// exp(-0.5 * ((sx dx)^2 - 2 rho (sx dx)(sy dy) + (sy dy)^2)) in the plain
// twin's operation order, flushed to 0 below FLT_MIN (the reference backends
// flush subnormals, so such a window is 0/0 = NaN there); one division at
// the end.  Built without fast math and without FMA contraction, so each
// operation is a single IEEE operation as in the twin; expf may differ from
// PyTorch's exp by a few ulp.
#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float finish(float v, float, float*) { return v; }

// nan_to_num(nan=0), then clip(rint(.), 0, norm): +inf clips to norm
__device__ __forceinline__ unsigned char finish(float v, float norm,
                                                unsigned char*) {
  if (isnan(v)) v = 0.0f;
  return (unsigned char)fminf(fmaxf(rintf(v), 0.0f), norm);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads) steering_warp_kernel(
    const int* __restrict__ img,        // [C, H, W] int32 feature (0..norm)
    const int* __restrict__ codes,      // [C, H, W, 3] int32 hyper codes
    OutT* __restrict__ out,             // [C, N] float32 or uint8
    const int2* __restrict__ corners,   // [N] (row, col), padded coordinates
    const float4* __restrict__ dis,     // [N] (dx0, dx1, dy0, dy1)
    int C, int H, int W, int N, int pad_r, int pad_c, float max_sigma,
    float norm) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int2 corner = __ldg(corners + n);
  const float4 d = __ldg(dis + n);
  const float dx[2] = {d.x, d.y};
  const float dy[2] = {d.z, d.w};
  int r[2], q[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    r[s] = min(max(corner.x + s, 0), H - 1) - pad_r;   // -1: the pad row
    q[s] = min(max(corner.y + s, 0), W - 1) - pad_c;
  }
  const size_t plane = (size_t)H * W;
  for (int c = 0; c < C; ++c) {
    const int* x = img + c * plane;
    const int* hyp = codes + c * plane * 3;
    float wn = 0.0f, ws = 0.0f;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const size_t e = (size_t)max(r[s], 0) * W + max(q[t], 0);
        const float v =
            (r[s] >= 0 && q[t] >= 0) ? (float)__ldg(x + e) : 0.0f;
        const int* code = hyp + e * 3;
        const float rho = (float)__ldg(code) / norm * 2.0f - 1.0f;
        const float sx = (float)__ldg(code + 1) / norm * max_sigma;
        const float sy = (float)__ldg(code + 2) / norm * max_sigma;
        const float a = sx * dx[s];
        const float b = sy * dy[t];
        const float xn = a * a;
        const float yn = b * b;
        const float xy = a * sy * dy[t];
        float w = expf(-0.5f * (xn - 2.0f * rho * xy + yn));
        if (w < FLT_MIN) w = 0.0f;
        wn += w * v;
        ws += w;
      }
    }
    out[c * (size_t)N + n] = finish(wn / ws, norm, out);
  }
}

template <typename OutT>
cudaError_t launch(const void* img, const void* codes, void* out,
                   const void* corners, const void* dis, int C, int H, int W,
                   int N, int pad_r, int pad_c, float max_sigma, float norm,
                   cudaStream_t stream) {
  const int blocks = (N + kThreads - 1) / kThreads;
  steering_warp_kernel<OutT><<<blocks, kThreads, 0, stream>>>(
      (const int*)img, (const int*)codes, (OutT*)out, (const int2*)corners,
      (const float4*)dis, C, H, W, N, pad_r, pad_c, max_sigma, norm);
  return cudaGetLastError();
}

}  // namespace

// N = oH * oW output pixels.  pad_r, pad_c: the geometry's leading pads
// (0 or 1).  out_u8: 1 writes uint8 clip(rint(nan_to_num(.)), 0, norm)
// (norm <= 255), 0 float32 with NaN where a window's weights all vanish.
extern "C" int lerf_steering_warp(const void* img, const void* codes,
                                  void* out, const void* corners,
                                  const void* dis, int C, int H, int W, int N,
                                  int pad_r, int pad_c, float max_sigma,
                                  float norm, int out_u8, void* stream) {
  if ((long long)C * N == 0) return 0;
  if (H < 1 || W < 1 || pad_r < 0 || pad_c < 0 ||
      (out_u8 && !(norm <= 255.0f)))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)corners % sizeof(int2) || (uintptr_t)dis % sizeof(float4))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      out_u8 ? launch<unsigned char>(img, codes, out, corners, dis, C, H, W,
                                     N, pad_r, pad_c, max_sigma, norm, s)
             : launch<float>(img, codes, out, corners, dis, C, H, W, N,
                             pad_r, pad_c, max_sigma, norm, s);
  return (int)err;
}
