// K5's first design, kept for lerf_torch/tools/probe_lut_kernels.py to time
// beside the kernel as built (lerf_torch/csrc/steering_warp.cu); it is not
// part of the kernel library.
//
// One thread per output pixel, all C channels.  The per-pixel geometry comes
// from the host (WarpOperands: an int2 window corner in padded coordinates
// and a float4 of distances, 24 bytes a pixel), and every gathered
// neighbour's codes are decoded from global memory (three IEEE divisions a
// neighbour and channel).  Same contract as the kernel as built: the weight
// in the plain twin's float order, flushed below FLT_MIN, one division at
// the end, NaN -> 0 in the uint8 epilogue.
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
