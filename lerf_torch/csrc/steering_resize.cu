// K1: steerable-Gaussian resize from the stage-2 codes, for sm_90a.
//
// Replaces: lerf_tpu/ops/pallas/resize_kernel.py::steering_gaussian_resize_pallas
// (body _kernel), which computes lerf_tpu/ops/resample.py::steering_gaussian_resize.
// Unlike the Pallas kernel (periodic scales, support 2, no antialias), this one
// takes every ResizeGeometry: periodic and non-periodic scales and the
// antialiased downscale with its inflated support.
//
// What bounds it on the H100: bytes.  At 360x640 -> x4 it writes 1440*2560*3
// float32 (44 MB) and reads ~11 MB of feature and codes; its arithmetic
// (~15 flops and one expf per neighbour, 4 neighbours per output) is below the
// byte time at 3.35 TB/s.
//
// What the design does about it: one thread per output pixel (c, i, j), j
// fastest, so the 44 MB of output is written once, coalesced, and nothing
// else goes to device memory: the S x S neighbour lattice, the decoded hyper
// maps and the padded planes never exist.  The thread reads its field of view
// from the host geometry (rows/cols, already shifted into unpadded source
// coordinates) and maps the pads itself: the image is zero outside the source
// (constant pad), the hyper codes are read at the clamped index (edge pad); a
// negative pad (crop) needs no special case.  Neighbouring output pixels share
// source pixels, so the gathers hit L1/L2.  The codes are decoded in the
// kernel (code / norm, then 2u-1 or u*max_sigma) exactly as
// split_gaussian_hyper + decode_gaussian_hyper do.  Sums run s-major,
// t-minor, as the JAX path's _per_block_reduce does; the library is built
// without fast math and without FMA contraction, so each product and the
// expf are single IEEE operations in the order of the plain PyTorch twin.
#include <cuda_runtime.h>

namespace {

__global__ void steering_resize_kernel(
    const int* __restrict__ img,      // [C, H, W] int32 feature (0..norm)
    const int* __restrict__ codes,    // [C, H, W, 3] int32 hyper codes
    float* __restrict__ out,          // [C, OH, OW]
    const int* __restrict__ rows,     // [OH, S] source rows, may be outside [0, H)
    const int* __restrict__ cols,     // [OW, S] source cols, may be outside [0, W)
    const float* __restrict__ dis_x,  // [OH, S]
    const float* __restrict__ dis_y,  // [OW, S]
    int C, int H, int W, int OH, int OW, int S,
    int antialias, float m, float max_sigma, float norm) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long total = (long long)C * OH * OW;
  if (idx >= total) return;
  const int j = (int)(idx % OW);
  const long long ci = idx / OW;
  const int i = (int)(ci % OH);
  const int c = (int)(ci / OH);
  const int* x = img + (size_t)c * H * W;
  const int* hyp = codes + (size_t)c * H * W * 3;

  float wn = 0.0f, ws = 0.0f;
  for (int s = 0; s < S; ++s) {
    const int row = rows[i * S + s];
    const bool row_in = row >= 0 && row < H;
    const int rc = min(max(row, 0), H - 1);
    float dx = dis_x[i * S + s];
    if (antialias) dx = m * dx;
    for (int t = 0; t < S; ++t) {
      const int col = cols[j * S + t];
      const int cc = min(max(col, 0), W - 1);
      float dy = dis_y[j * S + t];
      if (antialias) dy = m * dy;
      const int* code = hyp + ((size_t)rc * W + cc) * 3;
      const float rho = (float)code[0] / norm * 2.0f - 1.0f;
      const float sx = (float)code[1] / norm * max_sigma;
      const float sy = (float)code[2] / norm * max_sigma;
      const float n = (row_in && col >= 0 && col < W)
                          ? (float)x[(size_t)row * W + col] : 0.0f;
      const float a = sx * dx;
      const float b = sy * dy;
      const float xn = a * a;
      const float yn = b * b;
      const float xy = a * sy * dy;
      float w = expf(-0.5f * (xn - 2.0f * rho * xy + yn));
      if (antialias) w = m * w;
      wn += w * n;
      ws += w;
    }
  }
  out[idx] = wn / ws;
}

}  // namespace

extern "C" int lerf_steering_resize(
    const void* img, const void* codes, void* out, const void* rows,
    const void* cols, const void* dis_x, const void* dis_y,
    int C, int H, int W, int OH, int OW, int S,
    int antialias, float min_scale, float max_sigma, float norm,
    void* stream) {
  const long long total = (long long)C * OH * OW;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  steering_resize_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const int*)img, (const int*)codes, (float*)out, (const int*)rows,
      (const int*)cols, (const float*)dis_x, (const float*)dis_y,
      C, H, W, OH, OW, S, antialias, min_scale, max_sigma, norm);
  return (int)cudaGetLastError();
}
