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
// int32 result out and at most ~3 MB of int8 tables) nor the blend's
// multiply-adds.  The data-dependent table reads, served by L1/L2, and the
// integer work around them (sample addressing, rank sort, corner picking)
// set the pace: on the main path's data (lerf_torch/tools/probe_lut_kernels
// .py) stage 1 on a uniformly random frame spends about half its time in
// the L2 traffic of its random cell rows, stage 2 about two thirds in the
// integer work.
//
// What the design does about it:
// - A block covers a kTileH x kTileW tile of one channel; the grid is
//   (column tiles, row tiles, C), so no thread divides a flat index.  The
//   tile and its kHalo-pixel halo (MAX_PAD: the rotated offsets reach
//   -3..+3) are loaded once, edge-clamped (== the all-sides edge pad of the
//   JAX path), into shared memory as bytes; all 48 role samples of a pixel
//   come from there.
// - A thread takes kRowsPerThread pixels of one column, so two pixels'
//   gathers are in flight at once beside the other resident warps'.
// - The rank order of the 4 fractions is a 5-comparator sorting network on
//   packed (fraction, role, corner raise) keys, unsigned max/min each,
//   instead of 16 compare-and-select pairs: the ALU work a member was the
//   larger half of the first design's time.
// - For oC = 3 each corner's values sit in one 4-byte word of a padded
//   [K, L^4, 4] copy of the tables (FlatTables.padded): a corner is one
//   aligned read-only load instead of 3 byte loads.  For oC = 1 the 16
//   corners of each MSB cell sit in one 16-byte row of a [K, (L-1)^4, 16]
//   copy (FlatTables.cells, the JAX package's packed-row idea): a member is
//   one 16-byte load, and its 5 corners are picked from the row by the
//   raised-role bits.  A random gather costs an L1 sector whatever its
//   width, so this trades 5 sectors a member for 1.  One stage's copies
//   (<= 6 x 83,521 x 4 B, or 3 x 65,536 x 16 B) stay resident in the L2.
// - The epilogue's divisor is a template constant for the shipped stages
//   (48: 3 modes x 16; 192: 12 members x 16), so the round-half-even
//   division compiles to multiply-shift; other (modes, interval) keep a
//   runtime divisor.
// The member geometry (rotated offsets, table index) is a __grid_constant__
// kernel parameter, uniform across the warp, read from the constant bank.
// All arithmetic is int32 and the division is an exact round-half-to-even,
// so the result is bit-equal to the plain twin and to lerf_tpu.
//
// Row mode (lut_rows_kernel, lerf_lut_stage_rows): lerf_tpu's other table
// layouts, read as they are. packed8 / packed32 (lut_ensemble_packed,
// build_packed_tables): the members of a rotation group share one row of
// [G, oC, 16 corners] int8 or int32 a cell, its corner bits in the group's
// canonical position space; cells (build_cell_table): one int32 row of
// [16 corners, oC] a cell and member. Member i at output pixel p reads the
// row of the cell that its own samples index in canonical order (the
// group's anchor p + delta_i), its slot of that row, and picks its 5
// corners by role-permuted bits; fractions and ties stay in role order. A
// member is the flat mode's work with three changes: the cell index weighs
// role k's MSBs by (L-1)^(3 - perm_k), role k raises corner bit 3 - perm_k,
// and the corner reads use the layout's strides (packed8: one 16-byte load
// a channel, as the oC-1 cell rows; int32: one 4-byte load a corner and
// channel). The same tile, sort and epilogue, so the result is bit-equal to
// the flat mode and to the twin. Bound: the rows (packed8 192 + 576 bytes a
// cell over 16^4 cells, 12.6 + 37.7 MB; int32 4x) no longer stay in the
// L2's share a stage may count on as the flat copies do, and a member reads
// a slot of 16 (int8) or 64 bytes a channel out of a random row. Not done:
// staging a tile's anchor rows in shared memory so that a group's members
// read one fetched row (fewer sectors for the 2x2 modes).
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

struct Members {
  int n;
  int off[kMaxMembers][8];               // (row, col) x 4 roles, rotated
  int soff[kMaxMembers][4];              // the same as tile offsets
  int tbase[kMaxMembers];                // first row of the member's table
};

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

__device__ __forceinline__ uint4 corner_row(const uint4* rows, int cell) {
  return __ldg(rows + cell);
}

__device__ __forceinline__ uint32_t corner_word(const uint32_t* words,
                                                int corner) {
  return __ldg(words + corner);
}

// byte k of a corner word, sign-extended
__device__ __forceinline__ int word_byte(uint32_t w, int k) {
  return (int)(w << (24 - 8 * k)) >> 24;
}

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

// DEN: the epilogue divisor when known at compile time, else 0.
template <int OC, int DEN>
__global__ void __launch_bounds__(kTileW * kThreadRows) lut_stage_kernel(
    const int* __restrict__ img,            // [C, H, W] int32, 0..255
    const void* __restrict__ tables,        // oC 1: cell rows; 3: words
    int* __restrict__ out,                  // [C, H, W, OC] int32
    const __grid_constant__ Members mem, int H, int W, int interval,
    int den_rt, int bias, int norm) {
  __shared__ unsigned char tile[kTileBytes];
  const int c = blockIdx.z;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  const int* x = img + (size_t)c * H * W;
  load_tile(tile, x, H, W, i0, j0);

  const int q = 1 << interval;
  const int mask = q - 1;
  const int L = (1 << (8 - interval)) + 1;
  // cells: the base indexes rows of (L-1)^4 cells and a corner is 4 bits
  constexpr bool kCells = OC == 1;
  const int R = kCells ? L - 1 : L;
  const int r1 = kCells ? 2 : L, r2 = kCells ? 4 : L * L;
  const int r3 = kCells ? 8 : L * L * L;
  // A role's sort key packs (fraction, role, corner raise) in one word:
  // the raise (L^(3-role), or the role's cell bit) in the low `sh` bits,
  // the role above it and the fraction on top, so one unsigned compare
  // orders by fraction, the later role first on ties (rank 0 = largest;
  // simplex.py), and carries the raise along.  The three take at most 27
  // bits.
  const int sh = 32 - __clz(r3);
  const uint32_t role_raise[4] = {(0u << sh) | (uint32_t)r3,
                                  (1u << sh) | (uint32_t)r2,
                                  (2u << sh) | (uint32_t)r1,
                                  (3u << sh) | 1u};
  const uint32_t raise_mask = (1u << sh) - 1;
  const int j = j0 + threadIdx.x;
  const unsigned char* t0 =
      tile + (threadIdx.y + kHalo) * kPitch + threadIdx.x + kHalo;

  int acc[kRowsPerThread][OC];
#pragma unroll
  for (int p = 0; p < kRowsPerThread; ++p)
#pragma unroll
    for (int ch = 0; ch < OC; ++ch) acc[p][ch] = 0;

  // not unrolled: unrolled fully, the oC-1 stages spilled (ptxas: 928
  // bytes of stack) and ran 4x slower; unrolled by 2, no faster
#pragma unroll 1
  for (int m = 0; m < mem.n; ++m) {
#pragma unroll
    for (int p = 0; p < kRowsPerThread; ++p) {
      const unsigned char* tp = t0 + p * kThreadRows * kPitch;
      int v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = tp[mem.soff[m][k]];
      const int base = (((v[0] >> interval) * R + (v[1] >> interval)) * R
                        + (v[2] >> interval)) * R + (v[3] >> interval);
      uint32_t key[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        key[k] = ((uint32_t)(v[k] & mask) << (sh + 2)) | role_raise[k];
      order(key[0], key[1]);
      order(key[2], key[3]);
      order(key[0], key[2]);
      order(key[1], key[3]);
      order(key[1], key[2]);
      int cn[5], vt[4];
      cn[0] = kCells ? 0 : base;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        vt[t] = (int)(key[t] >> (sh + 2));
        cn[t + 1] = cn[t] + (int)(key[t] & raise_mask);
      }
      const int wt[5] = {q - vt[0], vt[0] - vt[1], vt[1] - vt[2],
                         vt[2] - vt[3], vt[3]};
      if constexpr (kCells) {
        const uint4 row = corner_row((const uint4*)tables + mem.tbase[m],
                                     base);
        // the first corner raises no role, the last all four
        acc[p][0] += wt[0] * row_byte(row, 0) + wt[4] * row_byte(row, 15);
#pragma unroll
        for (int k = 1; k < 4; ++k) acc[p][0] += wt[k] * row_byte(row, cn[k]);
      } else {
        const uint32_t* words = (const uint32_t*)tables + mem.tbase[m];
        uint32_t cw[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) cw[k] = corner_word(words, cn[k]);
#pragma unroll
        for (int k = 0; k < 5; ++k)
#pragma unroll
          for (int ch = 0; ch < OC; ++ch)
            acc[p][ch] += wt[k] * word_byte(cw[k], ch);
      }
    }
  }

  epilogue<OC, DEN>(acc, out, c, H, W, i0, j, den_rt, bias, norm);
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

template <int OC, int DEN>
void launch(const void* img, const void* tables, void* out,
            const Members& mem, int C, int H, int W, int interval, int den,
            int bias, int norm, cudaStream_t stream) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, C);
  const dim3 block(kTileW, kThreadRows);
  lut_stage_kernel<OC, DEN><<<grid, block, 0, stream>>>(
      (const int*)img, tables, (int*)out, mem, H, W, interval, den, bias,
      norm);
}

// The shipped stages' divisors are template constants: 48 (stage 1, 3
// modes x 16) and 192 (the intermediate stage and stage 2, 12 members x
// 16); any other runs with a runtime divisor.
template <int OC>
void dispatch(const void* img, const void* tables, void* out,
              const Members& mem, int C, int H, int W, int interval, int den,
              int bias, int norm, cudaStream_t stream) {
  switch (den) {
    case 48:
      launch<OC, 48>(img, tables, out, mem, C, H, W, interval, den, bias,
                     norm, stream);
      break;
    case 192:
      launch<OC, 192>(img, tables, out, mem, C, H, W, interval, den, bias,
                      norm, stream);
      break;
    default:
      launch<OC, 0>(img, tables, out, mem, C, H, W, interval, den, bias,
                    norm, stream);
  }
}

}  // namespace

// members: host int32 [M, 9] — 8 rotated offsets, then the table index.
// tables: int8 [K, L4, 4] for oc 3 (each corner's values in one word, the
// fourth byte zero); int8 [K, (L-1)^4, 16] for oc 1 (each MSB cell's 16
// corners in one row, corner bit 3 = role a raised ... bit 0 = role d).
extern "C" int lerf_lut_stage(
    const void* img, const void* tables, void* out, const void* members,
    int M, int C, int H, int W, int oc, int L4, int interval, int den,
    int bias, int norm, void* stream) {
  if (M < 1 || M > kMaxMembers || den < 1 || interval < 1 || interval > 8)
    return (int)cudaErrorInvalidValue;
  const int cells = 1 << (4 * (8 - interval));   // (L-1)^4
  const int rows = oc == 1 ? cells : L4;
  if ((long long)C * H * W == 0) return 0;
  if (C > 65535 || (H + kTileH - 1) / kTileH > 65535)
    return (int)cudaErrorInvalidConfiguration;
  Members mem = {};
  mem.n = M;
  const int* src = (const int*)members;
  for (int m = 0; m < M; ++m) {
    for (int k = 0; k < 8; ++k) {
      const int o = src[m * 9 + k];
      if (o < -kHalo || o > kHalo) return (int)cudaErrorInvalidValue;
      mem.off[m][k] = o;
    }
    for (int k = 0; k < 4; ++k)
      mem.soff[m][k] = mem.off[m][2 * k] * kPitch + mem.off[m][2 * k + 1];
    mem.tbase[m] = src[m * 9 + 8] * rows;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (oc) {
    case 1:
      dispatch<1>(img, tables, out, mem, C, H, W, interval, den, bias, norm,
                  s);
      break;
    case 3:
      dispatch<3>(img, tables, out, mem, C, H, W, interval, den, bias, norm,
                  s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Row mode. tables: host array of M device pointers, member m's slot of
// cell 0 of its table; members: host int32 [M, 16] — 8 rotated offsets
// (row, col per role), perm (the canonical position of each role), then
// the row's bytes, the elements between channels and between corners, 0.
// elem: bytes a value (1 or 4).
extern "C" int lerf_lut_stage_rows(
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

extern "C" const char* lerf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
