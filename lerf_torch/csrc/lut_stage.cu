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
// [16 corners, oC] a cell and member, a group of one. Member i at output
// pixel p reads the row of the group's anchor p + delta_i (the cell its
// own samples index in canonical order), its slot of that row, and picks
// its 5 corners by role-permuted bits; fractions and ties stay in role
// order. The same sort and rounding as the flat mode, so the result is
// bit-equal to the flat mode and to the twin.
//
// What bounds it (lerf_torch/tools/probe_lut_kernels.py --rows, both
// stages of the bench bank on a random and a smooth frame; PERF.md): the
// slot reads. With the corner index standing in for every table value the
// first design takes about a seventh of its time on packed32 and cells and
// three fifths on packed8: a member's slot is a 16- to 192-byte piece of a
// random row, read by one load a channel (int8) or one 4-byte load a
// corner and channel (int32: 15 at oC 3), each warp instruction on 32
// different rows, so the L1's request rate, not bytes, sets the pace; a
// smooth frame's lanes share rows and coalesce.
//
// What the design does about it: the int32 layouts' stage-2 slots (oC 3,
// 192 bytes) are staged. A member's warp copies the 32 slots of its pixels
// into shared memory by 16-byte cp.async, a slot's 12 copies on
// neighbouring lanes (a few L1 requests a row instead of one a value), and
// each lane reads its 15 values there; a warp whose 32 pixels lie on 16
// or fewer runs of equal cells (a smooth frame) reads each slot directly,
// where its lanes coalesce already. The copies go through L1 (.ca):
// through L2 only (.cg) stage 2 took 2.6-4.6x longer on both frames. The
// other members keep the first design's loop: int8 slots are one 16-byte
// load a channel already, and int32 stage-1 slots (64 bytes) gained on
// the random frame but lost on the smooth one. Which members copy is a
// static choice by slot size (the wrapper's SLOT_MIN_BYTES). The int32
// instances take one pixel a thread (an 8 x 32 tile); the slot-copying
// one's 77 registers leave three blocks an SM (its 53 KB of shared memory
// would leave four: held to 64 registers for four, it spilled and its
// stage 2 took a fifth longer). The int8 ones take the first design's two.
//
// Staging each rotation group's anchor rows once a tile in shared memory
// (16-byte cp.async, the next group's rows in flight while a group
// blends) was built, held bit-equal and probed, and lost on every layout
// (1.6-1.9x the first design's time; PERF.md): a group's members read
// disjoint slots of a row, so a row staged once moves the bytes its
// members' slot reads move, while its buffers (41-111 KB a block) cut
// residency to one or two blocks an SM and the L1 the slot reads hit. TMA
// serves neither design: its copies are boxes of a tensor, and Hopper's
// TMA has no row gather.
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

// ---------------------------------------------------------------------------
// Row mode
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;         // 8 warps a block
constexpr int kRowTileW = 32;            // a warp on 32 pixels of a tile row
constexpr int kRowPitch = kRowTileW + 2 * kHalo;
constexpr int kSmemDefault = 48 * 1024;  // dynamic shared memory without opt-in
constexpr int kMaxDevices = 16;

// One instance's tile and slot copies. int8 rows (packed8): the first
// design's block, two pixels a thread, 16 x 32. int32 rows: one pixel a
// thread, 8 x 32 (with SLOTS, so the slot buffers, a warp's 32 slots,
// leave room for four blocks an SM and some L1; the registers allow
// three). A slotted member's warp copies its
// slots when its 32 pixels lie on more than kDirectRuns runs of equal
// cells; on fewer (a smooth frame) each lane reads its own slot, where
// lanes on one row coalesce already.
template <int OC, int ELEM, bool SLOTS>
struct RowShape {
  static constexpr int kPx = ELEM == 1 ? 2 : 1;          // pixels a thread
  static constexpr int kH = kPx * kRowThreads / kRowTileW;  // tile rows
  static constexpr int kTileAlloc =
      ((kH + 2 * kHalo) * kRowPitch + 15) / 16 * 16;
  static constexpr int kSlotChunks = OC * ELEM;          // 16-byte copies
  static constexpr int kSlotPitch = 16 * (kSlotChunks | 1);  // odd chunks
  static constexpr int kDirectRuns = 16;
  static constexpr int kSlotBytes =
      SLOTS ? kRowThreads * kPx * kSlotPitch : 0;
  static_assert(kRowThreads % kRowTileW == 0 && kRowTileW == 32 &&
                    kPx <= 2 && (!SLOTS || ELEM == 4),
                "a warp on 32 pixels of a tile row; slots only for int32");
};

// The launch's members, mode by mode, group by group (lerf_tpu's order):
// samples (tile offsets, role order), each role's corner bit and cell
// weight, the member's slot of row 0 and the bytes a row, and whether its
// slots are copied by warps.
struct RowPlan {
  int nm;
  const char* base[kMaxMembers];         // the slot of row 0
  int rbytes[kMaxMembers];               // bytes a row
  int slotted[kMaxMembers];
  int soff[kMaxMembers][4];
  int cbit[kMaxMembers][4];              // 1 << (3 - perm_k)
  int cmul[kMaxMembers][4];              // (L-1)^(3 - perm_k)
  int cstride[kMaxMembers];              // elements between channels
  int bstride[kMaxMembers];              // elements between corners
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most the N newest commit groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the same for a count an unrolled loop folds to a constant (at most 1)
__device__ __forceinline__ void cp_async_wait_newest(int n) {
  if (n > 0)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// A table value: from a copied slot in shared memory, or (kGlobal) from
// the table in global memory through the read-only path.
template <bool kGlobal>
__device__ __forceinline__ int row_value(const int* p) {
  if constexpr (kGlobal) return __ldg(p);
  return *p;
}

template <bool kGlobal>
__device__ __forceinline__ uint4 row_chunk(const uint4* p) {
  if constexpr (kGlobal) return __ldg(p);
  return *p;
}

// The block's tile and its halo of one channel, edge-clamped, as bytes.
template <int TH>
__device__ __forceinline__ void load_row_tile(unsigned char* tile,
                                              const int* x, int H, int W,
                                              int i0, int j0) {
  constexpr int n = (TH + 2 * kHalo) * kRowPitch;
  for (int e = threadIdx.x; e < n; e += kRowThreads) {
    const int r = e / kRowPitch;
    const int gr = min(max(i0 - kHalo + r, 0), H - 1);
    const int gc = min(max(j0 - kHalo + e - r * kRowPitch, 0), W - 1);
    tile[e] = (unsigned char)__ldg(x + (size_t)gr * W + gc);
  }
}

// A member's samples at one pixel: its corners (cn: the raised bits of the
// first k roles in rank order) and their weights, and the cell its samples
// index with the member's own weights (its anchor's canonical cell).
__device__ __forceinline__ int member_corners(const unsigned char* tp,
                                              const int (&soff)[4],
                                              const int (&cbit)[4],
                                              const int (&cmul)[4],
                                              int interval, int (&cn)[5],
                                              int (&wt)[5]) {
  constexpr int sh = 4;                  // corner bits take the low 4
  const int q = 1 << interval;
  int cell = 0;
  uint32_t key[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int v = tp[soff[k]];
    cell += (v >> interval) * cmul[k];
    key[k] = ((uint32_t)(v & (q - 1)) << (sh + 2)) | ((uint32_t)k << sh) |
             (uint32_t)cbit[k];
  }
  order(key[0], key[1]);
  order(key[2], key[3]);
  order(key[0], key[2]);
  order(key[1], key[3]);
  order(key[1], key[2]);
  int vt[4];
  cn[0] = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    vt[t] = (int)(key[t] >> (sh + 2));
    cn[t + 1] = cn[t] + (int)(key[t] & 15u);
  }
  wt[0] = q - vt[0];
  wt[1] = vt[0] - vt[1];
  wt[2] = vt[1] - vt[2];
  wt[3] = vt[2] - vt[3];
  wt[4] = vt[3];
  return cell;
}

// A member's weighted corners from its slot.
template <int OC, int ELEM, bool kGlobal>
__device__ __forceinline__ void add_corners(int (&acc)[OC], const char* slot,
                                            int cs, int bs,
                                            const int (&cn)[5],
                                            const int (&wt)[5]) {
  if constexpr (ELEM == 1) {
    // packed8: a channel's 16 corners are one 16-byte load
#pragma unroll
    for (int ch = 0; ch < OC; ++ch) {
      const uint4 r = row_chunk<kGlobal>(reinterpret_cast<const uint4*>(slot)
                                         + ch);
      acc[ch] += wt[0] * row_byte(r, 0) + wt[4] * row_byte(r, 15);
#pragma unroll
      for (int k = 1; k < 4; ++k) acc[ch] += wt[k] * row_byte(r, cn[k]);
    }
  } else {
    const int* vals = reinterpret_cast<const int*>(slot);
#pragma unroll
    for (int ch = 0; ch < OC; ++ch) {
      const int* vc = vals + ch * cs;
      acc[ch] += wt[0] * row_value<kGlobal>(vc) +
                 wt[4] * row_value<kGlobal>(vc + 15 * bs);
#pragma unroll
      for (int k = 1; k < 4; ++k)
        acc[ch] += wt[k] * row_value<kGlobal>(vc + cn[k] * bs);
    }
  }
}

// Row mode. ELEM: bytes a table value (1: packed8, 4: packed32 / cells).
// Dynamic shared memory: the tile and (SLOTS) each warp's slot buffer.
template <int OC, int ELEM, int DEN, bool SLOTS>
__global__ void __launch_bounds__(kRowThreads) lut_rows_kernel(
    const int* __restrict__ img,            // [C, H, W] int32, 0..255
    int* __restrict__ out,                  // [C, H, W, OC] int32
    const __grid_constant__ RowPlan plan, int H, int W, int interval,
    int den_rt, int bias, int norm) {
  using S = RowShape<OC, ELEM, SLOTS>;
  constexpr int kPx = S::kPx;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tile = smem;
  const int c = blockIdx.z;
  const int i0 = blockIdx.y * S::kH, j0 = blockIdx.x * kRowTileW;
  load_row_tile<S::kH>(tile, img + (size_t)c * H * W, H, W, i0, j0);
  __syncthreads();

  // a thread's pixels: column `lane` of tile rows warp + 8p
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* wbuf =
      smem + S::kTileAlloc + warp * kPx * 32 * S::kSlotPitch;
  int acc[kPx][OC];
#pragma unroll
  for (int p = 0; p < kPx; ++p)
#pragma unroll
    for (int ch = 0; ch < OC; ++ch) acc[p][ch] = 0;

#pragma unroll 1
  for (int m = 0, nm = plan.nm; m < nm; ++m) {
    const char* base = plan.base[m];
    int cn[kPx][5], wt[kPx][5], cell[kPx];
    bool copied[kPx];
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      cell[p] = member_corners(
          tile + (warp + 8 * p + kHalo) * kRowPitch + lane + kHalo,
          plan.soff[m], plan.cbit[m], plan.cmul[m], interval, cn[p], wt[p]);
      copied[p] = false;
      if constexpr (SLOTS) {
        if (plan.slotted[m]) {
          // the warp's 32 slots into its buffer, 16 bytes a copy, a slot's
          // copies on neighbouring lanes, if its pixels lie on many cells
          const int left = __shfl_up_sync(0xffffffffu, cell[p], 1);
          const unsigned heads =
              __ballot_sync(0xffffffffu, lane == 0 || left != cell[p]);
          copied[p] = __popc(heads) > S::kDirectRuns;
          if (copied[p]) {
            unsigned char* sb = wbuf + p * 32 * S::kSlotPitch;
#pragma unroll
            for (int i = 0; i < S::kSlotChunks; ++i) {
              const int e = lane + 32 * i;
              const int r = e / S::kSlotChunks, k = e % S::kSlotChunks;
              const int cr = __shfl_sync(0xffffffffu, cell[p], r);
              cp_async16(sb + r * S::kSlotPitch + 16 * k,
                         base + (size_t)cr * plan.rbytes[m] + 16 * k);
            }
          }
          cp_async_commit();
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      if (copied[p]) {
        cp_async_wait_newest(kPx - 1 - p);  // set p in, p + 1 may fly
        __syncwarp();
        add_corners<OC, ELEM, false>(
            acc[p], (const char*)(wbuf + (p * 32 + lane) * S::kSlotPitch),
            plan.cstride[m], plan.bstride[m], cn[p], wt[p]);
      } else {
        add_corners<OC, ELEM, true>(
            acc[p], base + (size_t)cell[p] * plan.rbytes[m],
            plan.cstride[m], plan.bstride[m], cn[p], wt[p]);
      }
    }
    if constexpr (SLOTS) __syncwarp();    // the buffer free for the next
  }

  // round_half_even(clip(acc + bias*den, 0, norm*den) / den) into out
  const int d = DEN > 0 ? DEN : den_rt;
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    const int i = i0 + warp + 8 * p, j = j0 + lane;
    if (i >= H || j >= W) continue;
    int* dst = out + (((size_t)c * H + i) * W + j) * OC;
#pragma unroll
    for (int ch = 0; ch < OC; ++ch) {
      const int num = min(max(acc[p][ch] + bias * d, 0), norm * d);
      const int qd = num / d;
      const int twice = 2 * (num - qd * d);
      dst[ch] = qd + ((twice > d) || (twice == d && (qd & 1)));
    }
  }
}

// One row-mode launch; above 48 KB of dynamic shared memory the kernel
// instance first opts in on the current device (once a size).
template <int OC, int ELEM, int DEN, bool SLOTS>
int launch_rows(const RowPlan& plan, const void* img, void* out, int C,
                int H, int W, int interval, int den, int bias, int norm,
                cudaStream_t stream) {
  using S = RowShape<OC, ELEM, SLOTS>;
  if ((H + S::kH - 1) / S::kH > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int smem = S::kTileAlloc + S::kSlotBytes;
  static int opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > kSmemDefault && (dev >= kMaxDevices || smem > opted[dev])) {
    err = cudaFuncSetAttribute(lut_rows_kernel<OC, ELEM, DEN, SLOTS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) {
      cudaGetLastError();                  // not left for the next launch
      return (int)err;
    }
    if (dev < kMaxDevices) opted[dev] = smem;
  }
  const dim3 grid((W + kRowTileW - 1) / kRowTileW, (H + S::kH - 1) / S::kH,
                  C);
  lut_rows_kernel<OC, ELEM, DEN, SLOTS>
      <<<grid, kRowThreads, smem, stream>>>((const int*)img, (int*)out, plan,
                                            H, W, interval, den, bias, norm);
  return (int)cudaGetLastError();
}

template <int OC, int ELEM, bool SLOTS>
int dispatch_den(const RowPlan& plan, const void* img, void* out, int C,
                 int H, int W, int interval, int den, int bias, int norm,
                 cudaStream_t s) {
  switch (den) {
    case 48:
      return launch_rows<OC, ELEM, 48, SLOTS>(plan, img, out, C, H, W,
                                              interval, den, bias, norm, s);
    case 192:
      return launch_rows<OC, ELEM, 192, SLOTS>(plan, img, out, C, H, W,
                                               interval, den, bias, norm, s);
    default:
      return launch_rows<OC, ELEM, 0, SLOTS>(plan, img, out, C, H, W,
                                             interval, den, bias, norm, s);
  }
}

// int8 rows never copy slots (one 16-byte load a channel already)
template <int OC, int ELEM>
int dispatch_rows(const RowPlan& plan, bool slotted, const void* img,
                  void* out, int C, int H, int W, int interval, int den,
                  int bias, int norm, cudaStream_t s) {
  if constexpr (ELEM == 4) {
    if (slotted)
      return dispatch_den<OC, ELEM, true>(plan, img, out, C, H, W, interval,
                                          den, bias, norm, s);
  }
  if (slotted) return (int)cudaErrorInvalidValue;
  return dispatch_den<OC, ELEM, false>(plan, img, out, C, H, W, interval,
                                       den, bias, norm, s);
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

// Row mode. tables: host array of M device pointers, each member's slot of
// row 0; members: host int32 [M, 16], per member its 8 rotated offsets
// (row, col per role), perm (the canonical position of each role), the
// row's bytes, the elements between channels and between corners, and 1
// if its slots are copied by warps (int32 values only), else 0. elem:
// bytes a value (1 or 4).
extern "C" int lerf_lut_stage_rows(
    const void* img, const void* const* tables, void* out,
    const void* members, int M, int C, int H, int W, int oc, int elem,
    int interval, int den, int bias, int norm, void* stream) {
  if (M < 1 || M > kMaxMembers || den < 1 || interval < 1 || interval > 8 ||
      (elem != 1 && elem != 4) || (oc != 1 && oc != 3))
    return (int)cudaErrorInvalidValue;
  if ((long long)C * H * W == 0) return 0;
  if (C > 65535) return (int)cudaErrorInvalidConfiguration;
  const int cells = 1 << (8 - interval);          // (L-1) a role
  RowPlan plan = {};
  plan.nm = M;
  bool slotted = false;
  for (int m = 0; m < M; ++m) {
    const int* d = (const int*)members + m * 16;
    const int rb = d[12], cs = d[13], bs = d[14], slots = d[15];
    if (rb < 16 * oc * elem || cs < 0 || bs < 0 || (slots != 0 && slots != 1)
        || ((oc - 1) * cs + 15 * bs + 1) * elem > rb)
      return (int)cudaErrorInvalidValue;
    // a slot read as 16-byte pieces (int8 rows) or copied whole (16 x oc
    // values, 16 bytes a copy)
    if ((elem == 1 || slots) &&
        (rb % 16 || ((uintptr_t)tables[m]) % 16 ||
         (oc - 1) * cs + 15 * bs >= 16 * oc))
      return (int)cudaErrorInvalidValue;
    if (elem == 1 && (cs != 16 || bs != 1)) return (int)cudaErrorInvalidValue;
    slotted |= slots;
    int seen = 0;
    for (int k = 0; k < 4; ++k) {
      const int r = d[2 * k], cc = d[2 * k + 1], perm = d[8 + k];
      if (r < -kHalo || r > kHalo || cc < -kHalo || cc > kHalo || perm < 0 ||
          perm > 3 || (seen >> perm) & 1)
        return (int)cudaErrorInvalidValue;
      seen |= 1 << perm;
      plan.soff[m][k] = r * kRowPitch + cc;
      plan.cbit[m][k] = 1 << (3 - perm);
      int mul = 1;
      for (int e = 0; e < 3 - perm; ++e) mul *= cells;
      plan.cmul[m][k] = mul;
    }
    plan.base[m] = (const char*)tables[m];
    plan.rbytes[m] = rb;
    plan.slotted[m] = slots;
    plan.cstride[m] = cs;
    plan.bstride[m] = bs;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (oc == 1 && elem == 1)
    return dispatch_rows<1, 1>(plan, slotted, img, out, C, H, W, interval,
                               den, bias, norm, s);
  if (oc == 1)
    return dispatch_rows<1, 4>(plan, slotted, img, out, C, H, W, interval,
                               den, bias, norm, s);
  if (elem == 1)
    return dispatch_rows<3, 1>(plan, slotted, img, out, C, H, W, interval,
                               den, bias, norm, s);
  return dispatch_rows<3, 4>(plan, slotted, img, out, C, H, W, interval, den,
                             bias, norm, s);
}

extern "C" const char* lerf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
