// K2's row mode as it was first built, kept as the yardstick of the
// row mode in lerf_torch/csrc/lut_stage.cu for chip_smoke.py (phase 49)
// and lerf_torch/tools/probe_lut_kernels.py --rows, which build it on its
// own and time it beside the kernel as built. It is not part of the kernel
// library; nothing on a serving path launches it. Its C entry,
// lerf_lut_stage_rows_first, takes the row mode's per-member descriptors
// (lerf_torch.ops.kernels.lut_stage.row_members; it ignores their last
// column, whether a member's slots are copied).
//
// The function: the packed and cell layouts' LUT-stage ensembles,
// lerf_tpu/ops/lut_pipeline.py lut_ensemble_packed (build_packed_tables)
// and lut_ensemble on cell tables (lerf_tpu/ops/simplex.py simplex4d_cells,
// build_cell_table), each with the stage epilogue.
//
// Design: the flat mode's block (a 16 x 32 tile of one channel and its
// 3-pixel halo in shared memory, 2 pixels a thread, the sorting network,
// the epilogue). Member i at output pixel p reads the row of the cell that
// its own samples index in canonical order (the group's anchor p +
// delta_i), its slot of that row, and picks its 5 corners by role-permuted
// bits; fractions and ties stay in role order. The cell index weighs role
// k's MSBs by (L-1)^(3 - perm_k), role k raises corner bit 3 - perm_k, and
// the corner reads use the layout's strides (packed8: one 16-byte load a
// channel; int32: one 4-byte load a corner and channel), straight from
// global memory: every member fetches its slot on its own.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxMembers = 20;          // 5 modes x 4 rotations
constexpr int kHalo = 3;                 // MAX_PAD of the stage geometry
constexpr int kTileW = 32;               // columns of a block: one warp
constexpr int kThreadRows = 8;           // warps of a block
constexpr int kRowsPerThread = 2;        // pixels of a thread, one column
constexpr int kTileH = kThreadRows * kRowsPerThread;
constexpr int kPitch = kTileW + 2 * kHalo;
constexpr int kTileBytes = (kTileH + 2 * kHalo) * kPitch;

// Row mode: a member's samples (tile offsets, role order), each role's
// weight in the cell index and corner bit, and where its slot of a row is.
struct RowMembers {
  int n;
  int soff[kMaxMembers][4];
  int cmul[kMaxMembers][4];              // (L-1)^(3 - perm_k)
  int cbit[kMaxMembers][4];              // 1 << (3 - perm_k)
  const char* rows[kMaxMembers];         // the member's slot of cell 0
  int rstride[kMaxMembers];              // bytes a cell row
  int cstride[kMaxMembers];              // elements between channels
  int bstride[kMaxMembers];              // elements between corners
};

// corner c of a 16-corner row (bit 3: role a raised ... bit 0: role d),
// sign-extended
__device__ __forceinline__ int row_byte(uint4 r, int c) {
  const uint32_t lo = __byte_perm(r.x, r.y, c & 7);
  const uint32_t hi = __byte_perm(r.z, r.w, c & 7);
  return (int)(signed char)(c & 8 ? hi : lo);
}

// one comparator of a descending sorting network
__device__ __forceinline__ void order(uint32_t& a, uint32_t& b) {
  const uint32_t hi = max(a, b);
  b = min(a, b);
  a = hi;
}

// The block's tile and its halo of one channel, edge-clamped, as bytes.
__device__ __forceinline__ void load_tile(unsigned char* tile, const int* x,
                                          int H, int W, int i0, int j0) {
  for (int e = threadIdx.y * kTileW + threadIdx.x; e < kTileBytes;
       e += kTileW * kThreadRows) {
    const int r = e / kPitch;
    const int gr = min(max(i0 - kHalo + r, 0), H - 1);
    const int gc = min(max(j0 - kHalo + e - r * kPitch, 0), W - 1);
    tile[e] = (unsigned char)__ldg(x + (size_t)gr * W + gc);
  }
  __syncthreads();
}

// round_half_even(clip(acc + bias*den, 0, norm*den) / den) into out
template <int OC, int DEN>
__device__ __forceinline__ void epilogue(const int (&acc)[kRowsPerThread][OC],
                                         int* out, int c, int H, int W,
                                         int i0, int j, int den_rt, int bias,
                                         int norm) {
  const int den = DEN > 0 ? DEN : den_rt;
#pragma unroll
  for (int p = 0; p < kRowsPerThread; ++p) {
    const int i = i0 + threadIdx.y + p * kThreadRows;
    if (i >= H || j >= W) continue;
    int* dst = out + (((size_t)c * H + i) * W + j) * OC;
#pragma unroll
    for (int ch = 0; ch < OC; ++ch) {
      const int num = min(max(acc[p][ch] + bias * den, 0), norm * den);
      const int qd = num / den;
      const int twice = 2 * (num - qd * den);
      const int up = (twice > den) || (twice == den && (qd & 1));
      dst[ch] = qd + up;
    }
  }
}

// Row mode. ELEM: bytes a table value (1: packed8, 4: packed32 / cells).
template <int OC, int ELEM, int DEN>
__global__ void __launch_bounds__(kTileH * kTileW / kRowsPerThread)
    lut_rows_kernel(
    const int* __restrict__ img,            // [C, H, W] int32, 0..255
    int* __restrict__ out,                  // [C, H, W, OC] int32
    const __grid_constant__ RowMembers mem, int H, int W, int interval,
    int den_rt, int bias, int norm) {
  __shared__ unsigned char tile[kTileBytes];
  const int c = blockIdx.z;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  load_tile(tile, img + (size_t)c * H * W, H, W, i0, j0);

  const int q = 1 << interval;
  const int mask = q - 1;
  constexpr int sh = 4;                  // corner bits take the low 4
  const int j = j0 + threadIdx.x;
  const unsigned char* t0 =
      tile + (threadIdx.y + kHalo) * kPitch + threadIdx.x + kHalo;

  int acc[kRowsPerThread][OC];
#pragma unroll
  for (int p = 0; p < kRowsPerThread; ++p)
#pragma unroll
    for (int ch = 0; ch < OC; ++ch) acc[p][ch] = 0;

#pragma unroll 1
  for (int m = 0, nm = mem.n; m < nm; ++m) {
#pragma unroll
    for (int p = 0; p < kRowsPerThread; ++p) {
      const unsigned char* tp = t0 + p * kThreadRows * kPitch;
      int v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = tp[mem.soff[m][r]];
      int cell = 0;
      uint32_t key[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cell += (v[k] >> interval) * mem.cmul[m][k];
        key[k] = ((uint32_t)(v[k] & mask) << (sh + 2)) |
                 ((uint32_t)k << sh) | (uint32_t)mem.cbit[m][k];
      }
      order(key[0], key[1]);
      order(key[2], key[3]);
      order(key[0], key[2]);
      order(key[1], key[3]);
      order(key[1], key[2]);
      int cn[5], vt[4];
      cn[0] = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        vt[t] = (int)(key[t] >> (sh + 2));
        cn[t + 1] = cn[t] + (int)(key[t] & 15u);
      }
      const int wt[5] = {q - vt[0], vt[0] - vt[1], vt[1] - vt[2],
                         vt[2] - vt[3], vt[3]};
      const char* row = mem.rows[m] + (size_t)cell * mem.rstride[m];
      if constexpr (ELEM == 1) {
        // packed8: a channel's 16 corners are one 16-byte load
#pragma unroll
        for (int ch = 0; ch < OC; ++ch) {
          const uint4 r = __ldg(reinterpret_cast<const uint4*>(row) + ch);
          acc[p][ch] += wt[0] * row_byte(r, 0) + wt[4] * row_byte(r, 15);
#pragma unroll
          for (int k = 1; k < 4; ++k) acc[p][ch] += wt[k] * row_byte(r, cn[k]);
        }
      } else {
        const int* vals = reinterpret_cast<const int*>(row);
        const int cs = mem.cstride[m], bs = mem.bstride[m];
#pragma unroll
        for (int ch = 0; ch < OC; ++ch) {
          acc[p][ch] += wt[0] * __ldg(vals + ch * cs) +
                        wt[4] * __ldg(vals + ch * cs + 15 * bs);
#pragma unroll
          for (int k = 1; k < 4; ++k)
            acc[p][ch] += wt[k] * __ldg(vals + ch * cs + cn[k] * bs);
        }
      }
    }
  }
  epilogue<OC, DEN>(acc, out, c, H, W, i0, j, den_rt, bias, norm);
}

}  // namespace

// Row mode. tables: host array of M device pointers, member m's slot of
// cell 0 of its table; members: host int32 [M, 16] — 8 rotated offsets
// (row, col per role), perm (the canonical position of each role), then
// the row's bytes, the elements between channels and between corners, 0.
// elem: bytes a value (1 or 4).
extern "C" int lerf_lut_stage_rows_first(
    const void* img, const void* const* tables, void* out,
    const void* members, int M, int C, int H, int W, int oc, int elem,
    int interval, int den, int bias, int norm, void* stream) {
  if (M < 1 || M > kMaxMembers || den < 1 || interval < 1 || interval > 8 ||
      (elem != 1 && elem != 4))
    return (int)cudaErrorInvalidValue;
  if ((long long)C * H * W == 0) return 0;
  if (C > 65535 || (H + kTileH - 1) / kTileH > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int cells = 1 << (8 - interval);          // (L-1) a role
  RowMembers mem = {};
  mem.n = M;
  const int* src = (const int*)members;
  for (int m = 0; m < M; ++m) {
    const int* d = src + m * 16;
    int seen = 0;
    for (int k = 0; k < 4; ++k) {
      const int r = d[2 * k], cc = d[2 * k + 1], perm = d[8 + k];
      if (r < -kHalo || r > kHalo || cc < -kHalo || cc > kHalo || perm < 0 ||
          perm > 3 || (seen >> perm) & 1)
        return (int)cudaErrorInvalidValue;
      seen |= 1 << perm;
      mem.soff[m][k] = r * kPitch + cc;
      mem.cbit[m][k] = 1 << (3 - perm);
      int mul = 1;
      for (int e = 0; e < 3 - perm; ++e) mul *= cells;
      mem.cmul[m][k] = mul;
    }
    mem.rows[m] = (const char*)tables[m];
    mem.rstride[m] = d[12];
    mem.cstride[m] = d[13];
    mem.bstride[m] = d[14];
    if (elem == 1 && (d[12] % 16 || ((uintptr_t)tables[m]) % 16 ||
                      d[13] != 16 || d[14] != 1))
      return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, C);
  const dim3 block(kTileW, kThreadRows);
  cudaStream_t s = (cudaStream_t)stream;
#define LERF_ROWS(OC, ELEM)                                                 \
  switch (den) {                                                            \
    case 48:                                                                \
      lut_rows_kernel<OC, ELEM, 48><<<grid, block, 0, s>>>(                 \
          (const int*)img, (int*)out, mem, H, W, interval, den, bias, norm); \
      break;                                                                \
    case 192:                                                               \
      lut_rows_kernel<OC, ELEM, 192><<<grid, block, 0, s>>>(                \
          (const int*)img, (int*)out, mem, H, W, interval, den, bias, norm); \
      break;                                                                \
    default:                                                                \
      lut_rows_kernel<OC, ELEM, 0><<<grid, block, 0, s>>>(                  \
          (const int*)img, (int*)out, mem, H, W, interval, den, bias, norm); \
  }
  if (oc == 1 && elem == 1) {
    LERF_ROWS(1, 1)
  } else if (oc == 1) {
    LERF_ROWS(1, 4)
  } else if (oc == 3 && elem == 1) {
    LERF_ROWS(3, 1)
  } else if (oc == 3) {
    LERF_ROWS(3, 4)
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef LERF_ROWS
  return (int)cudaGetLastError();
}
