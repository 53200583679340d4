#!/usr/bin/env python3
"""What bounds K1, K2 and K5 on the card: time variants of each kernel with
one part taken out.

    python3 lerf_torch/tools/probe_lut_kernels.py [--k5 OTHER.cu ...]
                                                  [--k1 OTHER.cu ...]
                                                  [--rounds N] [--sass]
                                                  [--k6]
                                                  [--rows [--k2 OTHER.cu]]
                                                  [--rings [--k5 OTHER.cu]]

Each variant is the kernel's source with one text substitution, built on
its own with the package's nvcc flags and timed with CUDA events beside
the kernel as built, on the LUT form's main-path data: chip_smoke's
seed-0 3×360×640 frame and random bank, K2 at stage 1 (oC 1) on the frame
and at stage 2 (oC 3) on stage 1's output, K1 at ×4 (uint8 output) and K5
under the main path's homography to 1440×2560 (uint8 output) on both
stages' outputs.

* K1: float32 output instead of uint8; no ``expf``; no window load (the
  shared-memory window filled with constants, no global reads or
  decoding); the field of view read before the window instead of after
  it; 2 or 8 adjacent outputs a thread instead of 4; a register cap for 6
  or 8 blocks an SM; and the kernel as
  built at other tile shapes.
* K2: no table gathers (the corner index stands in for the table value);
  byte corners from the flat tables instead of the padded words (oC 3)
  and the 16-byte cell rows (oC 1); the samples read from
  global memory instead of the shared-memory tile; one or four pixels a
  thread instead of two; a runtime divisor in the epilogue; the member
  loop unrolled by 2; a register cap for 4 or 8 blocks an SM.
* K5: float32 output instead of uint8; no ``expf``; the direct path in
  every block (each neighbour decoded from global memory, no shared-memory
  tile); each window from integer arithmetic instead of the float64
  geometry (the ×4 zoom without its jitter: what the geometry costs);
  the row window's add taken out;
  4 output rows a thread instead of 2; no register cap, or one for 6
  blocks an SM instead of 4; 32-row tiles; the host's per-pixel operands (24 bytes an output, made by
  ``WarpOperands.create``) read instead of the geometry derived in
  float64; each source pixel's feature loaded before its codes; and the
  first design, ``steering_warp_first.cu`` beside this script (host
  operands, each neighbour decoded, one output a thread).  K5 as built is
  also timed writing the validity mask.
* ``--k5 OTHER.cu``: another K5 source (an earlier commit's
  ``steering_warp.cu``, say: one with the batch entry
  ``lerf_steering_warp_batch`` is called as the kernel as built, one frame
  and no mask; one with the earlier single-frame ``lerf_steering_warp``
  with that entry's arguments, and one whose ``lerf_steering_warp`` takes
  no support and mode with the support-2 Gaussian arguments only),
  timed beside the kernel as built in ``--rounds`` alternating rounds, so
  the two compare within one process on one card: its int32 instance on
  the LUT stages' codes and, where its batch entry takes them, its float32
  instance on the same values as float maps (``code / 255``); each
  round's output held to the kernel's.  ``--k1 OTHER.cu``: another K1
  source (an earlier commit's ``steering_resize.cu``) timed the same way
  beside K1 as built, its int32 and float32 instances at ×4 (uint8
  output), outputs held equal.  Then the bf16 instances against the first
  ``--k1`` / ``--k5`` source's (``probe_bf16``): every case of
  ``bf16_cases`` (chip_smoke phase 50's and the card tests' bf16 cases:
  both weights, K1 at every scale, K5 under every matrix with the mask,
  supports 2 and 4, a batch of 4, the float-feature / bf16-map pair; the
  wrappers launching the other source's C entry, ``other_library``) held
  bit-equal once; then, in ``--rounds`` alternating rounds on the bf16
  IMDN form's own stage outputs, K1 at ×4 and K5 under the main
  homography at supports 2 and 4, both weights, and the pair, uint8
  output, each by events, CUDA-graph replays and the profiler, outputs
  held bit-equal every round (exit 1 if any case differs).  ``--sass``
  also prints, for K5 and K1 as built and each ``--k5`` / ``--k1`` source,
  each kernel's registers and its SASS instruction count by opcode
  (``cuobjdump``), and each instance beside the other source's
  (``compare_sass``: registers, whether the opcode counts are the same,
  and a bf16 instance's HFMA2 instructions).

* ``--k6``: K6 alone (nothing of the above), on chip_smoke's phase-27
  inputs at the training shape (16 planes of 48² → ×4, support 2) and the
  frame (3 × 360×640 → ×4), both modes: the kernel as built on the tile
  it picks and with one part taken out (``K6_VARIANTS``: no ``expf``, no
  phase A, no phase B, staging alone, nothing but the launch and the
  geometry, a 256-thread register budget), forced onto each of the four
  largest planned tiles at 128, 256 and 512 threads a block, and its
  first design (``steering_resize_bwd_first.cu`` beside this script, which
  sums in another order), in ``--rounds`` alternating rounds, each by
  events and by the profiler.

* ``--rows``: K2's row mode alone (nothing of the above), on chip_smoke's
  phase-49 data: the packed8, packed32 and cells layouts of the bench
  bank, stage 1 on the seed-0 random frame and on the smooth frame, stage
  2 on flat stage 1's output of each, timed by CUDA-graph replays
  (``chip_smoke.graph_ms``, both stages summed) in ``--rounds``
  alternating rounds, each call's output held to the kernel's.  Two
  designs: the kernel as built (``csrc/lut_stage.cu``), under each plan of
  ``ROW_PLANS`` (every member's slots copied by warps, every member on
  the first design's loop, and the plan ``row_members`` ships; int8 rows
  copy no slots), and the first design (``lut_rows_first.cu`` beside this
  script).  Each with one part taken out (``ROWS_VARIANTS``): no row
  reads (the corner index stands in for each table value, as in flat K2's
  "no table gathers"), no sort, no pixel tile (the blend's samples from
  global memory); the kernel also without its slot copies, with copies to
  L2 only (``cp.async.cg``), with other run thresholds for copying, with
  one or two pixels a thread, with the slot-copying instance held to 64
  registers (four blocks an SM).  Prints each variant library's
  row-kernel registers and
  loads by kind (``cuobjdump``).  ``--k2 OTHER.cu``: another flat K2
  source (the parent commit's ``lut_stage.cu``, say) timed beside flat K2
  as built in the same rounds, by events (phase 5's measure) and by graph
  replays, on both frames.

* ``--rings``: K5's rings instance alone (nothing of the above), on the
  LUT form's main-path stage outputs (the frame and bank above; the
  linear mode on the first code plane) through the rings of
  ``warp_matrix()`` (the host's fused precompute), of chip_smoke's radial
  distortion grid and of its row-shuffled form (most tiles on the direct
  path), both modes, uint8 and float32 output: the kernel as built
  (``csrc/steering_warp.cu``), its first design
  (``steering_warp_rings_first.cu`` beside this script, C entry of the
  same name), the producer-warp design (``steering_warp_rings_producer.cu``
  beside this script: a producer warp streams each tile's rings and source
  box into shared memory on mbarriers for 8 consumer warps) and each
  ``--k5`` source holding ``lerf_steering_warp_rings``
  (the wrapper pointed at the other library, ``other_library``), by
  CUDA-graph replays in ``--rounds`` alternating rounds, every output held
  bit-equal to the kernel's every round (exit 1 if any differs).  Each
  round also times, on the main grid, the variants of
  ``RINGS_VARIANTS``: the first design with its windows from the
  output's position (no rings read), with a box from the block's position
  (no footprint reduction: no atomics, no barriers between its steps),
  without ``expf``, at 2 or 6 blocks an SM instead of 4; the kernel as
  built without ``expf``, with the direct path in every tile, at two
  blocks an SM instead of three, with one output's neighbours in flight
  at a time instead of both, at four blocks an SM (64 registers) with
  both or one, with each footprint from every output's window instead of
  the ring positions' range, without its sums or its decode (what the
  rest costs); the producer-warp design with bulk copies
  (``cp.async.bulk``) in place of its lanes' 16-byte ``cp.async``.  Prints
  each rings instance's registers and SASS instruction count; with
  ``--sass`` also each ``--k5`` source's matrix instances beside the
  kernel's (``compare_sass``).

Only variants that keep the arithmetic compute the right numbers; each
line says whether its output equals the kernel's.  Prints one JSON line
per variant and the card line (name, power limit).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

# K5's window and mask for one output, which two variants replace
WINDOW = """\
    const Source src = source_at(w, col, w.row0 + i);   // window and mask
    px[k].set(src.y, src.x, w);
    if (mask != nullptr)
      mask[(size_t)i * w.OW + j] = valid_at(src, w, border);"""
# kernel source → {variant: [(old text, new text), ...]}
VARIANTS = {
    "steering_resize": {
        "no expf": [("w = expf(-0.5f * (xn - p.y * xy + yn));",
                     "w = -0.5f * (xn - p.y * xy + yn);")],
        "no window load": [(
            "win[r * pitch + q] = make_float4(n, 2.0f * rho, sx, sy);",
            "win[r * pitch + q] = make_float4(1.0f, 0.5f, (float)gr,"
            " (float)gc);")],
        "field of view read before the window": [
            ("  // 1. the source window (or its first strip), decoded once\n"
             "  load_window<kLinear, InT>(win, x, hyp, r_lo, c_lo, 0, whole ?"
             " wr : strip,\n"
             "                            wc, pitch, H, W, norm, max_sigma);\n"
             "  __syncthreads();\n\n", ""),
            ("  if (whole && !active) return;\n  int j[kVec];",
             "  int j[kVec];"),
            ("scale, m);\n\n  // 3.",
             "scale, m);\n"
             "  load_window<kLinear, InT>(win, x, hyp, r_lo, c_lo, 0, whole ?"
             " wr : strip,\n"
             "                            wc, pitch, H, W, norm, max_sigma);\n"
             "  __syncthreads();\n"
             "  if (whole && !active) return;\n\n  // 3.")],
        "2 outputs a thread": [("constexpr int kVec = 4;",
                                "constexpr int kVec = 2;")],
        "8 outputs a thread": [("constexpr int kVec = 4;",
                                "constexpr int kVec = 8;")],
        "at least 6 blocks an SM": [(
            "__launch_bounds__(kMaxThreads)",
            "__launch_bounds__(kMaxThreads, 6)")],
        "at least 8 blocks an SM": [(
            "__launch_bounds__(kMaxThreads)",
            "__launch_bounds__(kMaxThreads, 8)")],
    },
    "lut_stage": {
        "no table gathers": [
            ("return __ldg(words + corner);", "return (uint32_t)corner;"),
            ("return __ldg(rows + cell);",
             "return make_uint4(cell, cell >> 3, cell << 2, cell ^ 7);")],
        # both stages read the flat [K, L4, oC] table a byte a corner and
        # channel
        "byte corners": [
            ("constexpr bool kCells = OC == 1;",
             "constexpr bool kCells = false;"),
            ("        const uint32_t* words = (const uint32_t*)tables"
             " + mem.tbase[m];\n"
             "        uint32_t cw[5];\n"
             "#pragma unroll\n"
             "        for (int k = 0; k < 5; ++k)"
             " cw[k] = corner_word(words, cn[k]);\n",
             "        const signed char* bytes =\n"
             "            (const signed char*)tables"
             " + (size_t)mem.tbase[m] * OC;\n"),
            ("acc[p][ch] += wt[k] * word_byte(cw[k], ch);",
             "acc[p][ch] += wt[k] * __ldg(bytes + cn[k] * OC + ch);"),
            ("const int rows = oc == 1 ? cells : L4;",
             "const int rows = L4;")],
        "samples from global memory": [(
            "v[k] = tp[mem.soff[m][k]];",
            "v[k] = __ldg(x + min(max(i0 + (int)threadIdx.y + p * kThreadRows"
            " + mem.off[m][2 * k], 0), H - 1) * W"
            " + min(max(j + mem.off[m][2 * k + 1], 0), W - 1));")],
        "one pixel a thread": [("constexpr int kRowsPerThread = 2;",
                                "constexpr int kRowsPerThread = 1;")],
        "four pixels a thread": [("constexpr int kRowsPerThread = 2;",
                                  "constexpr int kRowsPerThread = 4;")],
        "runtime divisor": [("const int den = DEN > 0 ? DEN : den_rt;",
                             "const int den = den_rt;")],
        "member loop unrolled by 2": [("#pragma unroll 1\n  for (int m = 0;",
                                       "#pragma unroll 2\n  for (int m = 0;")],
        "at least 4 blocks an SM": [(
            "__launch_bounds__(kTileW * kThreadRows)",
            "__launch_bounds__(kTileW * kThreadRows, 4)")],
        "at least 8 blocks an SM": [(
            "__launch_bounds__(kTileW * kThreadRows)",
            "__launch_bounds__(kTileW * kThreadRows, 8)")],
    },
    "steering_warp": {
        "no expf": [("const float w = expf(-0.5f * (xn - p.y * xy + yn));",
                     "const float w = -0.5f * (xn - p.y * xy + yn);")],
        "direct path": [(
            "const bool shared = (long long)nr * nc * C <= kTileEntries;",
            "const bool shared = false;")],
        # a window from integer arithmetic (the ×4 zoom without the
        # jitter): what the float64 geometry costs, without reading operands
        # (and without the mask, which the probe's calls do not ask for)
        "geometry from integers": [(
            WINDOW,
            "    if constexpr (KS == 2) {\n"
            "      const int r0 = min((w.row0 + i) / 4, w.H - 1),"
            " q0 = min(j / 4, w.W - 1);\n"
            "      px[k].r[0] = r0; px[k].r[1] = min(r0 + 1, w.H - 1);\n"
            "      px[k].q[0] = q0; px[k].q[1] = min(q0 + 1, w.W - 1);\n"
            "      px[k].dx[0] = 0.375f; px[k].dx[1] = -0.625f;\n"
            "      px[k].dy[0] = 0.375f; px[k].dy[1] = -0.625f;\n"
            "    } else {\n"
            "      px[k] = window_at<KS, kLinear>(w, col, w.row0 + i);\n"
            "    }")],
        "4 rows a thread": [("constexpr int kThreadRows = 8;",
                             "constexpr int kThreadRows = 4;")],
        "no register cap": [("constexpr int kMinBlocks = 4;",
                             "constexpr int kMinBlocks = 1;")],
        "at least 6 blocks an SM": [("constexpr int kMinBlocks = 4;",
                                     "constexpr int kMinBlocks = 6;")],
        "32-row tiles": [("constexpr int kTileH = 16;",
                          "constexpr int kTileH = 32;")],
        # the support-2 Gaussian path's loop order, fields and load order
        "row, distance and branch hoisted out of the column loop": [
            ("#pragma unroll\n        for (int s = 0; s < S; ++s) {\n",
             "#pragma unroll\n        for (int s = 0; s < S; ++s) {\n"
             "          const int r = p.row(s);\n"
             "          const float dx = p.dxs(s);\n"
             "          const unsigned bx = p.bxs(s);\n"),
            ("                    ? tile[(c * nr + p.row(s) - r_lo) * nc"
             " + p.col(t) - c_lo]",
             "                    ? tile[(c * nr + r - r_lo) * nc"
             " + p.col(t) - c_lo]"),
            ("decode<kLinear, InT>(img, codes, c, p.row(s) - w.pad_r,",
             "decode<kLinear, InT>(img, codes, c, r - w.pad_r,"),
            ("weight(v, p.dxs(s), p.dyt(t), p.bxs(s), p.byt(t));",
             "weight(v, dx, p.dyt(t), bx, p.byt(t));")],
        "support fixed at 2 (no run-time field)": [
            ("  int H, W, OH, OW, pad_r, pad_c, S;",
             "  int H, W, OH, OW, pad_r, pad_c;\n  static constexpr int S = 2;"),
            ("  w->S = S;\n", "")],
        "no branch word in the Gaussian window": [
            ("    bits = 0u;\n    fill(sy", "    if constexpr (kBits) bits = 0u;\n    fill(sy")],
        "feature loaded before the codes": [
            ("    const float v = (sr >= 0 && sc >= 0) ? (float)__ldg(img + e)"
             " : 0.0f;\n    return make_float4(", "    return make_float4("),
            ("    const InT* code = codes + e * 3;\n",
             "    const float v = (sr >= 0 && sc >= 0) ? (float)__ldg(img + e)"
             " : 0.0f;\n    const InT* code = codes + e * 3;\n")],
        # the row window's add taken out (the global row is the local
        # one): what the window costs the whole launch
        "no row window": [
            ("source_at(w, col, w.row0 + i);", "source_at(w, col, i);")],
        # the entry takes the host's corners and distances after the
        # stream and in_type; each thread reads its windows from them
        "host operands": [
            ("struct Warp {\n  double m[9];",
             "struct Warp {\n  const int2* corners;\n  const float4* dis;\n"
             "  double m[9];"),
            (WINDOW,
             "    if constexpr (KS == 2) {\n"
             "      const size_t n_ = (size_t)(w.row0 + i) * w.OW + j;\n"
             "      const int2 c_ = __ldg(w.corners + n_);\n"
             "      const float4 d_ = __ldg(w.dis + n_);\n"
             "      for (int s = 0; s < 2; ++s) {\n"
             "        px[k].r[s] = min(max(c_.x + s, 0), w.H - 1);\n"
             "        px[k].q[s] = min(max(c_.y + s, 0), w.W - 1);\n"
             "      }\n"
             "      px[k].dx[0] = d_.x; px[k].dx[1] = d_.y;\n"
             "      px[k].dy[0] = d_.z; px[k].dy[1] = d_.w;\n"
             "    } else {\n"
             "      px[k] = window_at<KS, kLinear>(w, col, w.row0 + i);\n"
             "    }"),
            ("    int out_u8, int border, void* stream, int in_type, int row0,\n"
             "    int rows) {",
             "    int out_u8, int border, void* stream, int in_type, int row0,\n"
             "    int rows, const void* corners, const void* dis) {"),
            ("  fr.border = border;\n",
             "  fr.border = border;\n"
             "  fr.f[0].corners = (const int2*)corners;\n"
             "  fr.f[0].dis = (const float4*)dis;\n")],
    },
}
# K6 with one part taken out, timed by ``--k6`` on the tile it picks
_K6_NO_A = ("      float wn = 0.0f, ws = 0.0f;\n"
            "      for (int s = 0; s < S; ++s) {",
            "      pq[i * stride + j] = make_float2(1.0f, 0.5f);\n"
            "      if (S > 0) {\n        j += dj;\n        i += di;\n"
            "        if (j >= nj) {\n          j -= nj;\n          ++i;\n"
            "        }\n        continue;\n      }\n"
            "      float wn = 0.0f, ws = 0.0f;\n"
            "      for (int s = 0; s < S; ++s) {")
_K6_NO_B = ("    if (valid && r_lo <= r_hi && q_lo <= q_hi) {",
            "    if (valid && r_lo <= r_hi && q_lo <= q_hi && S < 0) {")
K6_VARIANTS = {
    "no expf": [("  const float w = expf(-0.5f * (xn - h.x * xy + yn));",
                 "  const float w = -0.5f * (xn - h.x * xy + yn);")],
    "staging and phase A only": [_K6_NO_B],
    "staging and phase B only": [_K6_NO_A],
    "staging only": [_K6_NO_A, _K6_NO_B],
    "empty": [
        ("  for (int base = 0; base < npix; base += groups) {",
         "  for (int base = 0; base < npix && S < 0; base += groups) {"),
        ("    for (int o = tid; o < ni * nj; o += nt) {\n      float wn",
         "    for (int o = tid; o < ni * nj && S < 0; o += nt) {\n"
         "      float wn"),
        ("  for (int k = tid; k < br.w_n * nwc; k += nt) {",
         "  for (int k = tid; k < br.w_n * nwc && S < 0; k += nt) {")],
    "launch bounds 256": [("constexpr int kMaxThreads = 512;",
                           "constexpr int kMaxThreads = 256;")],
}
# K2's row mode with one part taken out (``--rows``): the kernel as built
# (csrc/lut_stage.cu) and the first design (lut_rows_first.cu beside this
# script).
_ROW_VALUE = """__device__ __forceinline__ int row_value(const int* p) {
  if constexpr (kGlobal) return __ldg(p);
  return *p;
}"""
_ROW_CHUNK = """__device__ __forceinline__ uint4 row_chunk(const uint4* p) {
  if constexpr (kGlobal) return __ldg(p);
  return *p;
}"""
# the corner index stands in for each table value, as flat K2's "no table
# gathers" has it
_NO_ROW_READS = [
    (_ROW_VALUE, "__device__ __forceinline__ int row_value(const int* p) {\n"
     "  return (int)(((uintptr_t)p >> 2) & 127);\n}"),
    (_ROW_CHUNK, "__device__ __forceinline__ uint4 row_chunk(const uint4* p) {\n"
     "  const unsigned a = (unsigned)(uintptr_t)p;\n"
     "  return make_uint4(a, a >> 3, a << 2, a ^ 7);\n}")]
_NO_SORT = [("  order(key[0], key[1]);\n  order(key[2], key[3]);\n"
             "  order(key[0], key[2]);\n  order(key[1], key[3]);\n"
             "  order(key[1], key[2]);\n  int vt[4];", "  int vt[4];")]
# the blend's samples read from the image through the tile address they
# would have come from (the tile itself still loaded)
_PROBE_SAMPLE = (
    "__shared__ const int* probe_img;\n"
    "__shared__ int probe_h, probe_w, probe_i0, probe_j0;\n"
    "__device__ __forceinline__ int probe_sample(const unsigned char* tp,"
    " int so) {\n"
    "  extern __shared__ __align__(16) unsigned char smem[];\n"
    "  const int e = (int)(tp - smem) + so;\n"
    "  const int r = e / kRowPitch, q = e - r * kRowPitch;\n"
    "  const int gr = min(max(probe_i0 - kHalo + r, 0), probe_h - 1);\n"
    "  const int gc = min(max(probe_j0 - kHalo + q, 0), probe_w - 1);\n"
    "  return __ldg(probe_img + (size_t)gr * probe_w + gc);\n}\n\n"
    "// A member's samples at one pixel:")
_PROBE_SET = ("  probe_img = img + (size_t)c * H * W;\n"
              "  probe_h = H;\n  probe_w = W;\n"
              "  probe_i0 = i0;\n  probe_j0 = j0;\n")


def _no_pixel_tile(load):
    return [("// A member's samples at one pixel:", _PROBE_SAMPLE),
            ("    const int v = tp[soff[k]];",
             "    const int v = probe_sample(tp, soff[k]);"),
            (load, load + _PROBE_SET)]


ROWS_VARIANTS = {
    "lut_stage": {
        "no row reads": _NO_ROW_READS,
        "no slot copies": [("              cp_async16(sb + r * S::kSlotPitch"
                            " + 16 * k,",
                            "              if (k < 0) cp_async16(sb + r *"
                            " S::kSlotPitch + 16 * k,")],
        "no sort": _NO_SORT,
        "no pixel tile": _no_pixel_tile(
            "  load_row_tile<S::kH>(tile, img + (size_t)c * H * W, H, W, i0,"
            " j0);\n"),
        "slots copied to L2 only (.cg)": [("cp.async.ca.shared.global",
                                           "cp.async.cg.shared.global")],
        "slots: always copied": [(
            "  static constexpr int kDirectRuns = 16;",
            "  static constexpr int kDirectRuns = -1;")],
        "slots: never copied": [(
            "  static constexpr int kDirectRuns = 16;",
            "  static constexpr int kDirectRuns = 32;")],
        "slots: copied above 8 runs": [(
            "  static constexpr int kDirectRuns = 16;",
            "  static constexpr int kDirectRuns = 8;")],
        "slots: copied above 24 runs": [(
            "  static constexpr int kDirectRuns = 16;",
            "  static constexpr int kDirectRuns = 24;")],
        "two pixels a thread": [(
            "  static constexpr int kPx = ELEM == 1 ? 2 : 1;",
            "  static constexpr int kPx = 2;")],
        "one pixel a thread": [(
            "  static constexpr int kPx = ELEM == 1 ? 2 : 1;",
            "  static constexpr int kPx = 1;")],
        "slot instance at four blocks an SM": [(
            "__global__ void __launch_bounds__(kRowThreads) lut_rows_kernel(",
            "__global__ void __launch_bounds__(kRowThreads, SLOTS ? 4 : 1)"
            " lut_rows_kernel(")],
    },
    "lut_rows_first": {
        "no row reads": [
            ("const uint4 r = __ldg(reinterpret_cast<const uint4*>(row) + ch);",
             "const uint4 r = make_uint4(cell, cell >> 3, cell << 2, ch);"),
            ("          acc[p][ch] += wt[0] * __ldg(vals + ch * cs) +\n"
             "                        wt[4] * __ldg(vals + ch * cs + 15 * bs);",
             "          acc[p][ch] += wt[0] * (cell & 127) +\n"
             "                        wt[4] * ((cell + cs) & 127);"),
            ("acc[p][ch] += wt[k] * __ldg(vals + ch * cs + cn[k] * bs);",
             "acc[p][ch] += wt[k] * ((cell + cn[k] * bs) & 127);")],
        "no sort": [("      order(key[0], key[1]);\n"
                     "      order(key[2], key[3]);\n"
                     "      order(key[0], key[2]);\n"
                     "      order(key[1], key[3]);\n"
                     "      order(key[1], key[2]);\n", "")],
        "no pixel tile": [
            ("  load_tile(tile, img + (size_t)c * H * W, H, W, i0, j0);\n", ""),
            ("      for (int r = 0; r < 4; ++r) v[r] = tp[mem.soff[m][r]];",
             "      for (int r = 0; r < 4; ++r) {\n"
             "        const int so = mem.soff[m][r] + kHalo * kPitch + kHalo;\n"
             "        const int orow = so / kPitch - kHalo;\n"
             "        const int ocol = so % kPitch - kHalo;\n"
             "        v[r] = __ldg(img + (size_t)c * H * W + (size_t)min(max(i0"
             " + (int)threadIdx.y + p * kThreadRows + orow, 0), H - 1) * W"
             " + min(max(j + ocol, 0), W - 1));\n      }")],
    },
}
# K5's rings instance with one part taken out (``--rings``): its first
# design (steering_warp_rings_first.cu beside this script) and the kernel
# as built (csrc/steering_warp.cu)
_FIRST_BOX = ("""  if (tid == 0) {
    box[0] = box[2] = INT_MAX;
    box[1] = box[3] = INT_MIN;
  }
  __syncthreads();
  rmin = __reduce_min_sync(0xffffffffu, rmin);
  rmax = __reduce_max_sync(0xffffffffu, rmax);
  cmin = __reduce_min_sync(0xffffffffu, cmin);
  cmax = __reduce_max_sync(0xffffffffu, cmax);
  if ((tid & 31) == 0) {
    atomicMin(box, rmin);
    atomicMax(box + 1, rmax);
    atomicMin(box + 2, cmin);
    atomicMax(box + 3, cmax);
  }
  __syncthreads();
  const int r_lo = box[0], c_lo = box[2];
  const int nr = box[1] - r_lo + 1, nc = box[3] - c_lo + 1;
  const bool shared = (long long)C * nr * nc <= kTileEntries;  // block-uniform
""", """  // a 6 x 10 box from the block's position (the x4 zoom's size)
  const int r_lo = max(min((int)blockIdx.y * 4, w.H - 4), 0);
  const int c_lo = max(min((int)blockIdx.x * 8, w.W - 8), 0);
  const int nr = 6, nc = 10;
  const bool shared = true;
""")
RINGS_VARIANTS = {
    "steering_warp_rings_first": {
        # each window from the output's position (the x4 zoom), no rings read
        "constant windows": [(
            "    load_window(px[k], g, (size_t)i * w.OW + j);",
            "    px[k].r[0] = min(i / 4 + 1, w.H + 1);\n"
            "    px[k].r[1] = min(i / 4 + 2, w.H + 1);\n"
            "    px[k].q[0] = min(j / 4 + 1, w.W + 1);\n"
            "    px[k].q[1] = min(j / 4 + 2, w.W + 1);\n"
            "    px[k].dx[0] = 0.375f; px[k].dx[1] = -0.625f;\n"
            "    px[k].dy[0] = 0.375f; px[k].dy[1] = -0.625f;\n"
            "    px[k].bits = kLinear ? 0xaau : 0u;")],
        # no reduction: a box from the block's position, the tile's index
        # clamped into it (the values are wrong, the work the same)
        "no footprint reduction": [
            _FIRST_BOX,
            ("                shared ? tile[(c * nr + p.r[s] - r_lo) * nc"
             " + p.q[t] - c_lo]",
             "                shared ? tile[min(max((c * nr + p.r[s] - r_lo)"
             " * nc + p.q[t] - c_lo, 0), kTileEntries - 1)]")],
        "no expf": [("const float w = expf(-0.5f * (xn - p.y * xy + yn));",
                     "const float w = -0.5f * (xn - p.y * xy + yn);")],
        "at least 2 blocks an SM": [("constexpr int kMinBlocks = 4;",
                                     "constexpr int kMinBlocks = 2;")],
        "at least 6 blocks an SM": [("constexpr int kMinBlocks = 4;",
                                     "constexpr int kMinBlocks = 6;")],
    },
    "steering_warp": {
        "no expf": [("const float w = expf(-0.5f * (xn - p.y * xy + yn));",
                     "const float w = -0.5f * (xn - p.y * xy + yn);")],
        "direct path in every tile": [(
            "  b.shared = (long long)C * b.nr * b.nc <= kTileEntries;",
            "  b.shared = C < 0;")],
        "two blocks an SM": [("constexpr int kRingsBlocks = 3;",
                              "constexpr int kRingsBlocks = 2;")],
        "one output's neighbours in flight at a time": [(
            "constexpr int kSumRows = 2;", "constexpr int kSumRows = 1;")],
        "four blocks an SM": [
            ("constexpr int kRingsBlocks = 3;",
             "constexpr int kRingsBlocks = 4;"),
            ("constexpr int kMapInts = 1024;",
             "constexpr int kMapInts = 1008;")],
        "four blocks an SM, one output's neighbours at a time": [
            ("constexpr int kRingsBlocks = 3;",
             "constexpr int kRingsBlocks = 4;"),
            ("constexpr int kMapInts = 1024;",
             "constexpr int kMapInts = 1008;"),
            ("constexpr int kSumRows = 2;", "constexpr int kSumRows = 1;")],
        "no footprint from the ring positions": [(
            "  const bool monotone = __syncthreads_and(up);",
            "  const bool monotone = __syncthreads_and(up) && C < 0;")],
        # what the rest costs without the sums or the decode
        "no sums": [(
            "      sums_f32<OutT, kLinear, InT, HypT, kWide>(px, o.ok, tile,"
            " b, img,",
            "      if (C < 0) sums_f32<OutT, kLinear, InT, HypT, kWide>(px,"
            " o.ok, tile, b, img,")],
        "no decode": [(
            "      decode_tile<kLinear, InT, kWide, HypT>(img, codes, b, w, C,"
            " tile, norm,",
            "      if (C < 0) decode_tile<kLinear, InT, kWide, HypT>(img,"
            " codes, b, w, C, tile, norm,")],
    },
    "steering_warp_rings_producer": {
        "bulk copies (cp.async.bulk)": [(
            "constexpr bool kBulk = false;", "constexpr bool kBulk = true;")],
    },
}
ROW_LAYOUTS = ("packed8", "packed32", "cells")
# which members the kernel copies the slots of: every member, none (the
# first design's loop), or as ``row_members`` ships the plan
ROW_PLANS = {"slots by warps": 1, "first design's loop": 0,
             "the shipped plan": None}
# the kernel-as-built variants' plans (default: the shipped one)
ROW_VARIANT_PLANS = {
    "two pixels a thread": ("the shipped plan", "slots by warps"),
    "slots: copied above 24 runs": ("the shipped plan", "slots by warps")}
# kernel → {variant: source file beside this script}: whole other designs
OTHER_SOURCES = {"steering_warp": {"first design": "steering_warp_first.cu"}}
K1_TILES = ((16, 64), (8, 64), (16, 32), (8, 32), (32, 32), (4, 64))


def build_variants(tmp, k5_sources=(), variants=None, others=(),
                   k1_sources=()):
    """Every variant's shared library, built in parallel: {(kernel,
    variant): path}; ``k5_sources`` / ``k1_sources``, other K5 / K1
    sources, under their paths; ``variants``: {kernel: {variant:
    substitutions}} (a kernel's
    source in ``csrc/`` or, a first design, beside this script) instead of
    ``VARIANTS`` and the other designs; ``others``: (kernel, name, path)
    of more whole sources."""
    from lerf_torch.ops.kernels import _build

    jobs = {}
    here = os.path.dirname(os.path.abspath(__file__))
    others = list(others) + ([] if variants else [
        (kernel, name, os.path.join(here, fname))
        for kernel, named in OTHER_SOURCES.items()
        for name, fname in named.items()])
    for kernel, name, path in others + [
            ("steering_warp", p, p) for p in k5_sources] + [
            ("steering_resize", p, p) for p in k1_sources]:
        stem = os.path.join(tmp, f"{kernel}_{len(jobs)}")
        with open(path) as f, open(stem + ".cu", "w") as g:
            g.write(f.read())
        jobs[(kernel, name)] = stem
    for kernel, named in (variants or VARIANTS).items():
        path = os.path.join(_build.CSRC, kernel + ".cu")
        if not os.path.exists(path):                 # a first design
            path = os.path.join(here, kernel + ".cu")
        with open(path) as f:
            src = f.read()
        for name, subs in {"as built": [], **named}.items():
            text = src
            for old, new in subs:
                if text.count(old) != 1:
                    raise RuntimeError(f"{kernel} / {name}: substitution "
                                       f"not found once: {old[:60]!r}")
                text = text.replace(old, new)
            stem = os.path.join(tmp, f"{kernel}_{len(jobs)}")
            with open(stem + ".cu", "w") as f:
                f.write(text)
            jobs[(kernel, name)] = stem
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                      stem + ".cu", "-o", stem + ".so"]
                     for stem in jobs.values()])
    return {key: stem + ".so" for key, stem in jobs.items()}


def sass_rows(lib, kernel="steering_warp_kernel"):
    """{kernel function: (registers, Counter of SASS opcodes)} of the
    ``kernel`` instances (default K5's) in a built library, by
    ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    regs = dict(re.findall(
        rf"Function (\S*{kernel}\S*):\s*REG:(\d+)",
        subprocess.run([tool, "-res-usage", lib], capture_output=True,
                       text=True, check=True).stdout))
    rows, fn = {}, None
    for line in subprocess.run([tool, "-sass", lib], capture_output=True,
                               text=True, check=True).stdout.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1) if kernel in head.group(1) else None
            if fn:
                rows[fn] = (int(regs.get(fn, -1)), collections.Counter())
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if fn and op:
            rows[fn][1][op.group(1)] += 1
    return rows


def sass_lines(lib, kernel, opcode):
    """{kernel function: [its SASS instructions whose opcode starts with
    ``opcode``, register numbers replaced by R]}, by ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    rows, fn = {}, None
    for line in subprocess.run([tool, "-sass", lib], capture_output=True,
                               text=True, check=True).stdout.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1) if kernel in head.group(1) else None
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if fn and op and re.match(r"(@!?U?P\w+\s+)?" + opcode,
                                  op.group(1)):
            rows.setdefault(fn, []).append(
                re.sub(r"\bR\d+\b", "R", op.group(1)))
    return rows


def plain_name(fn):
    """A kernel function's mangled name without its source file's anonymous
    namespace (which names the file), so two sources' instances compare."""
    return re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "",
                  fn)


def compare_sass(libs, kernel, key, other, emit):
    """Registers and SASS opcode counts of every ``key`` instance of
    ``kernel`` as built beside another source's (``other``, its path), and
    each bf16 instance's HFMA2 instructions (a bf16 multiply is an HFMA2
    with the addend -RZ)."""
    mine = {plain_name(f): r for f, r in sass_rows(
        libs[(kernel, "as built")], key).items()}
    theirs = {plain_name(f): r for f, r in sass_rows(
        libs[(kernel, other)], key).items()}
    hfma = {plain_name(f): sorted(set(v)) for f, v in sass_lines(
        libs[(kernel, "as built")], key, "HFMA2").items()}
    for fn in sorted(set(mine) | set(theirs)):
        a, b = mine.get(fn), theirs.get(fn)
        emit({"kernel": kernel, "function": fn, "bf16": "nv_bfloat16" in fn,
              "registers": [a and a[0], b and b[0]],
              "instructions": [a and sum(a[1].values()),
                               b and sum(b[1].values())],
              "same_opcode_counts": bool(a and b and a[1] == b[1]),
              **({"opcodes": dict(sorted(a[1].items())),
                  "other_opcodes": dict(sorted(b[1].items())),
                  "hfma2": hfma.get(fn, [])}
                 if a and b and "nv_bfloat16" in fn else {})})


def k6_variant(fn, feat, hyper, g, args, max_sigma=10.0):
    """One launch of a K6 variant's library on the wrapper's arguments."""
    import torch

    grads = (torch.full_like(feat, float("nan")),
             torch.full_like(hyper, float("nan")))
    err = fn(feat.data_ptr(), hyper.data_ptr(), g.data_ptr(),
             grads[0].data_ptr(), grads[1].data_ptr(), feat.shape[0],
             max_sigma, ctypes.addressof(args),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K6 variant: CUDA error {err}")
    return grads


def probe_k6(rounds: int) -> int:
    """The ``--k6`` section (the module docstring)."""
    import torch

    import chip_smoke as cs
    from lerf_torch.ops.kernels import _build
    from lerf_torch.ops.kernels import resize_bwd as k6

    cs.CARD = card = cs.card_line()
    dev = torch.device("cuda")
    first_build = cs.start_k6_first_build()
    _build.library()
    first = cs.k6_first_design(first_build)
    variants = {}
    with tempfile.TemporaryDirectory() as tmp:
        for (_, name), path in build_variants(
                tmp, variants={"steering_resize_bwd": K6_VARIANTS}).items():
            fn = ctypes.CDLL(path).lerf_steering_resize_bwd
            fn.argtypes = _build.library().lerf_steering_resize_bwd.argtypes
            fn.restype = ctypes.c_int
            variants[name] = fn
    rng = np.random.RandomState(7)
    for name, planes, size, scale, support in cs.K6_CASES:
        if name not in cs.K6_TIMED:
            continue
        for linear in (False, True):
            geom, feat, hyper, g = cs.k6_inputs(dev, rng, planes, size,
                                                scale, support, linear)
            ops = k6.GradOperands.create(geom, dev, linear=linear)
            picked, args = ops.launch_plan(planes)
            want = k6.steering_resize_grad(feat, hyper, g, geom,
                                           linear=linear, operands=ops)
            calls = {"first design": lambda: first(feat, hyper, g, ops,
                                                   linear)}
            for vname, fn in variants.items():
                calls[vname] = (lambda fn=fn, args=args: k6_variant(
                    fn, feat, hyper, g, args))
            for plan in ops.plans[:4]:
                for threads in (128, 256, 512):
                    forced = k6.GradOperands.create(
                        geom, dev, linear=linear, tiles=(plan.tile,),
                        threads=threads)
                    calls[plan.tile, threads] = (
                        lambda o=forced: k6.steering_resize_grad(
                            feat, hyper, g, geom, linear=linear,
                            operands=o))
            nbytes, nops = cs.k6_work(planes, *size, *geom.out_sz,
                                      geom.support, linear)
            b_ms, _ = cs.bound(nbytes, nops)
            for rnd in range(rounds):
                order = list(calls) if rnd % 2 == 0 else list(calls)[::-1]
                for key in order:
                    out = calls[key]()
                    equal = all(torch.equal(a, b) for a, b in zip(out, want))
                    ms = cs.event_ms(calls[key], iters=50)
                    prof_ms, prof_n = cs.k6_profiler_ms(calls[key])
                    tile = (key if isinstance(key, str)
                            else {"tile": list(key[0]), "threads": key[1]})
                    print(json.dumps({
                        "kernel": "steering_resize_bwd", "case": name,
                        "linear": linear, "round": rnd, "variant": tile,
                        "picked": key == (picked.tile, picked.threads),
                        "ms": ms, "profiler_ms": prof_ms,
                        "profiler_launches_a_call": prof_n,
                        "bound_ms": b_ms, "share_of_bound": b_ms / ms,
                        "equals_kernel": equal, "card": card}), flush=True)
    print(card)
    return 0


def probe_rows(rounds: int, k2_sources=()) -> int:
    """The ``--rows`` section (the module docstring)."""
    import torch

    import chip_smoke as cs
    from lerf_torch.ops import lut_pipeline as lp
    from lerf_torch.ops.kernels import _build
    from lerf_torch.ops.kernels import lut_stage as k2

    cs.CARD = card = cs.card_line()
    dev = torch.device("cuda")
    lib = _build.library()
    bank = cs.bench_bank()
    frames = {"random": np.random.RandomState(0).randint(
        0, 256, (cs.LR_H, cs.LR_W, 3)).astype(np.uint8),
        "smooth": cs.smooth_frame()}
    flat = (lp.FlatTables.create(bank.stage1, dev),
            lp.FlatTables.create(bank.stage2, dev))
    inputs = {}
    for name, f in frames.items():
        x = torch.from_numpy(np.ascontiguousarray(
            f.transpose(2, 0, 1)).astype(np.int32)).to(dev)
        inputs[name] = (x, lp.lut_stage1(x, flat[0], cs.MODES))
    stages = ((False, 48, 0), (True, 192, 127))   # split_r, den, bias
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, variants=ROWS_VARIANTS, others=[
            ("lut_stage", path, path) for path in k2_sources])
        dlls = {key: ctypes.CDLL(path) for key, path in libs.items()}
        # each row-kernel instance's registers and its loads by kind
        # (LDL: local memory, spills; LDC: the parameter bank; LD: generic)
        for (kernel, name), path in libs.items():
            for fn, (nreg, opc) in sass_rows(path, "lut_rows_kernel").items():
                inst = re.search(r"lut_rows_kernelILi(\d)ELi(\d)ELi(\d+)E",
                                 fn)
                print(json.dumps({
                    "sass": kernel, "variant": name,
                    "instance": inst.groups() if inst else fn,
                    "registers": nreg, **{op: opc.get(op, 0) for op in (
                        "LDL", "STL", "LDC", "LD", "LDG", "LDS", "LDGSTS",
                        "SHFL")},
                    "instructions": sum(opc.values())}), flush=True)

    def row_call(entry, tables, how):
        """A call of the kernel (or a variant) on (stage, x) through
        ``entry``, its members' slots copied as ``ROW_PLANS[how]`` says."""
        entry.argtypes = lib.lerf_lut_stage_rows.argtypes
        entry.restype = ctypes.c_int

        def run(stage, x):
            split_r, den, bias = stages[stage]
            plan = k2.row_members(tables[stage], cs.MODES, split_r,
                                  x.device)
            if ROW_PLANS[how] is not None:
                members = plan.members.copy()
                members[:, 15] = ROW_PLANS[how]
                plan = dataclasses.replace(plan, members=members)
            out = torch.empty(x.shape + (plan.oc,), dtype=torch.int32,
                              device=dev)
            _build.check(entry(*k2.rows_args(
                x, out, plan, interval=4, den=den, bias=bias, norm=255,
                stream=torch.cuda.current_stream().cuda_stream)),
                "K2 rows variant")
            return out
        return run

    def first(entry, tables):
        call = cs.k2_rows_first_call(entry)

        def run(stage, x):
            split_r, den, bias = stages[stage]
            return call(x, tables[stage], cs.MODES, split_r, den, bias)
        return run

    def flat_call(entry):
        entry.argtypes = lib.lerf_lut_stage.argtypes
        entry.restype = ctypes.c_int

        def run(stage, x):
            split_r, den, bias = stages[stage]
            t = flat[stage]
            oc = t.table.shape[-1]
            words = t.padded if oc == 3 else t.cells
            members = lp.member_descriptors(cs.MODES, split_r, t.keys)
            out = torch.empty(x.shape + (oc,), dtype=torch.int32, device=dev)
            _build.check(entry(
                x.data_ptr(), words.data_ptr(), out.data_ptr(),
                members.ctypes.data, len(members), 3, cs.LR_H, cs.LR_W, oc,
                cs.L4, 4, den, bias, 255,
                torch.cuda.current_stream().cuda_stream), "K2 flat")
            return out
        return run

    def emit(row):
        print(json.dumps({**row, "card": card}), flush=True)

    def time_calls(calls, want, label):
        """``calls`` {name: run(stage, x)} on each frame, in alternating
        rounds: each call's graph ms a stage and whether it equals
        ``want``; flat calls also by events."""
        for frame, (x, feat) in inputs.items():
            ins = (x, feat)
            ref = [want(stage, ins[stage]) for stage in (0, 1)]
            equal = {name: all(torch.equal(run(stage, ins[stage]), ref[stage])
                               for stage in (0, 1))
                     for name, run in calls.items()}
            for rnd in range(rounds):
                names = list(calls) if rnd % 2 == 0 else list(calls)[::-1]
                for name in names:
                    run = calls[name]
                    ms = [cs.graph_ms(lambda s=stage: run(s, ins[s]))
                          for stage in (0, 1)]
                    row = {**label, "frame": frame, "round": rnd,
                           "variant": name, "graph_ms": sum(ms),
                           "stage_graph_ms": ms, "equals_kernel": equal[name]}
                    if label.get("kernel") == "lut_stage_kernel":
                        row["events_ms"] = [cs.event_ms(
                            lambda s=stage: run(s, ins[s]), iters=50)
                            for stage in (0, 1)]
                    emit(row)

    for layout in ROW_LAYOUTS:
        tables = [lp.stage_tables(bank.stage1, layout, cs.MODES,
                                  split_r=False, device=dev),
                  lp.stage_tables(bank.stage2, layout, cs.MODES,
                                  split_r=True, device=dev)]
        # int8 rows copy no slots (the kernel refuses the plan)
        hows = [how for how in ROW_PLANS
                if not (layout == "packed8" and how == "slots by warps")]
        calls = {f"as built, {how}": row_call(lib.lerf_lut_stage_rows,
                                              tables, how) for how in hows}
        calls["first design"] = first(
            dlls[("lut_rows_first", "as built")].lerf_lut_stage_rows_first,
            tables)
        for (kernel, name), dll in dlls.items():
            if name == "as built":
                continue
            if kernel == "lut_stage" and name in ROWS_VARIANTS["lut_stage"]:
                for how in ROW_VARIANT_PLANS.get(name, ("the shipped plan",)):
                    if how not in hows:
                        continue
                    calls[f"{name}, {how}"] = row_call(
                        dll.lerf_lut_stage_rows, tables, how)
            elif kernel == "lut_rows_first":
                calls[f"first design, {name}"] = first(
                    dll.lerf_lut_stage_rows_first, tables)

        def want(stage, x, tables=tables):
            split_r, den, bias = stages[stage]
            return k2.lut_stage(x, tables[stage], cs.MODES, split_r=split_r,
                                den=den, bias=bias)
        time_calls(calls, want, {"kernel": "lut_rows_kernel",
                                 "layout": layout})
    if k2_sources:
        calls = {"as built": flat_call(lib.lerf_lut_stage)}
        for path in k2_sources:
            calls[path] = flat_call(dlls[("lut_stage", path)].lerf_lut_stage)
        time_calls(calls, calls["as built"], {"kernel": "lut_stage_kernel",
                                              "layout": "flat"})
    print(card)
    return 0


def same_bits(a, b) -> bool:
    """Two outputs bit for bit (float32 ones by their bit patterns)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


@contextlib.contextmanager
def other_library(k1_path=None, k5_path=None):
    """The wrappers (``kernels.resize``, ``kernels.warp``) launching K1's
    and / or K5's C entries (K5's batch entry and its rings entry, those
    the other library holds) from another source's library (built alone by
    ``build_variants``), everything else from the package's."""
    from lerf_torch.ops.kernels import _build

    real = _build.library()

    class Lib:
        def __getattr__(self, name):
            return getattr(real, name)

    lib = Lib()
    for path, entry in ((k1_path, "lerf_steering_resize"),
                        (k5_path, "lerf_steering_warp_batch"),
                        (k5_path, "lerf_steering_warp_rings")):
        # a K5 source may hold either entry (a first design the rings one)
        if path is not None and hasattr(ctypes.CDLL(path), entry):
            fn = getattr(ctypes.CDLL(path), entry)
            fn.argtypes = getattr(real, entry).argtypes
            fn.restype = ctypes.c_int
            setattr(lib, entry, fn)
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = real


def bf16_cases(dev):
    """The bf16 cases that K1's and K5's bf16 instances are held to (the
    wrappers' calls, each returning its outputs): chip_smoke phase 50's
    (K1 at ×4, ×2.5, ×3.55 and ×0.5, K5 under its four matrices with the
    mask and under the main one at support 4, a batch of 4 frames with
    masks, both weights; a float32 feature with bf16 maps) and the card
    tests' (tests/test_torch_kernels.py: every ``RESIZE_CASES`` and
    ``WARP_CASES`` entry, supports 2 and 4, the batch), float32 and uint8
    outputs.  {name: call}."""
    import importlib.util

    import torch

    import chip_smoke as cs
    from lerf_torch.ops.geometry import ResizeGeometry
    from lerf_torch.ops.kernels import resize as k1
    from lerf_torch.ops.kernels import warp as k5

    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(ROOT, "tests", "test_torch_kernels.py"))
    ct = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ct)
    bf, u8 = torch.bfloat16, torch.uint8
    cases = {}

    def resize(name, feat, hyper, geom, linear):
        cases[name] = lambda: [
            k1.steering_resize(feat, hyper, geom, linear=linear),
            k1.steering_resize(feat, hyper, geom, linear=linear,
                               out_dtype=u8)]

    def warp(name, feat, hyper, params, linear):
        def run():
            mask = torch.empty(params.out_sz, dtype=torch.bool, device=dev)
            return [k5.steering_warp(feat, hyper, params, linear=linear,
                                     mask_out=mask),
                    k5.steering_warp(feat, hyper, params, linear=linear,
                                     out_dtype=u8), mask]
        cases[name] = run

    def batch(name, feats, hypers, warps, linear):
        def run():
            masks = torch.empty((len(warps),) + warps[0].out_sz,
                                dtype=torch.bool, device=dev)
            return [k5.steering_warp_batch(feats, hypers, warps,
                                           linear=linear, out_dtype=u8,
                                           mask_out=masks), masks]
        cases[name] = run

    rng = np.random.RandomState(15)
    shape = (3, cs.LR_H, cs.LR_W)
    big = {lin: tuple(t.to(bf) for t in cs.float_inputs(
        rng, shape, 1 if lin else 3, dev)) for lin in (False, True)}
    warps = [k5.WarpParams.create(shape[1:], cs.warp_matrix(s), cs.WARP_OUT)
             for s in range(4)]
    for lin in (False, True):
        mode = "linear" if lin else "gauss"
        feat, hyper = big[lin]
        for scale in (4.0, 2.5, 3.55, 0.5):
            resize(f"phase50 K1 {mode} x{scale}", feat, hyper,
                   ResizeGeometry.create(shape[1:], scale_factors=[scale] * 2),
                   lin)
        for name, (matrix, out_sz) in cs.WARP_CASES.items():
            warp(f"phase50 K5 {mode} {name} S=2", feat, hyper,
                 k5.WarpParams.create(shape[1:], matrix, out_sz), lin)
        main, out_sz = cs.WARP_CASES["main"]
        warp(f"phase50 K5 {mode} main S=4", feat, hyper,
             k5.WarpParams.create(shape[1:], main, out_sz, support=4), lin)
        batch(f"phase50 K5 {mode} batch of 4",
              torch.cat([feat, feat.flip(-1), feat.flip(-2), feat * 0.5]),
              torch.cat([hyper, hyper.flip(-2), hyper.flip(-3), 1 - hyper]),
              warps, lin)
        mixed = feat.to(torch.float32).round()
        resize(f"phase50 K1 {mode} float32 feature", mixed, hyper,
               ResizeGeometry.create(shape[1:], scale_factors=[cs.SCALE] * 2),
               lin)
        warp(f"phase50 K5 {mode} float32 feature", mixed, hyper, warps[0],
             lin)
        oc = 1 if lin else 3
        feat, hyper = (t.to(dev) for t in ct.bf16_inputs(oc=oc))
        for name, (scale, aa) in ct.RESIZE_CASES.items():
            resize(f"card K1 {mode} {name}", feat, hyper,
                   ResizeGeometry.create(feat.shape[1:],
                                         scale_factors=list(scale),
                                         antialias=aa), lin)
        for name, support in [(c, 2) for c in ct.WARP_CASES] + [
                ("rotation", 4), ("x2.5-wide", 4)]:
            matrix, wshape, out_sz = ct.WARP_CASES[name]
            f, h = (t.to(dev) for t in ct.bf16_inputs(wshape, oc=oc))
            warp(f"card K5 {mode} {name} S={support}", f, h,
                 k5.WarpParams.create(wshape[1:], matrix, out_sz,
                                      support=support), lin)
        f, h = (t.to(dev) for t in ct.bf16_inputs((12, 45, 77), oc=oc))
        batch(f"card K5 {mode} batch of 4", f, h,
              [k5.WarpParams.create((45, 77), ct.jitter_matrix(
                  s, (2.5, 2.5)), (112, 192)) for s in range(4)], lin)
    return cases


def probe_bf16(k1_other, k5_other, rounds, emit):
    """K1's and K5's bf16 instances (and the float32-feature / bf16-map
    pair) as built against another source's, in ``rounds`` alternating
    rounds on the bf16 IMDN form's own stage outputs (chip_smoke phase
    50's: the seed-0 model's bf16 towers on the seed-0 frame): K1 at ×4,
    K5 under the main homography at supports 2 and 4, both weights, uint8
    output, each by events, CUDA-graph replays and the profiler, the
    outputs held equal every round.  First every case of ``bf16_cases``
    run through both, outputs ``torch.equal`` (NaN where NaN).  Returns
    the cases that differ."""
    import torch

    import chip_smoke as cs
    from lerf_torch.ops.geometry import ResizeGeometry
    from lerf_torch.ops.kernels import resize as k1
    from lerf_torch.ops.kernels import warp as k5
    from lerf_torch.pipeline import NetPredictor

    dev = torch.device("cuda")
    k1_path, k5_path = k1_other, k5_other
    differ = []
    for name, call in bf16_cases(dev).items():
        want = call()
        with other_library(k1_path, k5_path):
            got = call()
        equal = all(same_bits(a, b) for a, b in zip(want, got))
        emit({"bf16_case": name, "equals_other": equal})
        if not equal:
            differ.append(name)

    frame = np.random.RandomState(0).randint(0, 256, (cs.LR_H, cs.LR_W, 3))
    x = torch.from_numpy(np.ascontiguousarray(frame.transpose(2, 0, 1))
                         .astype(np.float32) / 255).to(dev)
    feat, hyper = NetPredictor.from_imdn(cs.imdn_bf16_model())._stages(x)
    hyper = hyper.contiguous()
    lin_hyper = hyper[..., :1].contiguous()
    geom = ResizeGeometry.create((cs.LR_H, cs.LR_W),
                                 scale_factors=[cs.SCALE] * 2)
    ops = {lin: k1.ResizeOperands.create(geom, dev, linear=lin)
           for lin in (False, True)}
    u8 = torch.uint8
    timed = {
        "K1 bf16 gauss x4": ("steering_resize_kernel", lambda: k1.steering_resize(
            feat, hyper, geom, operands=ops[False], out_dtype=u8)),
        "K1 bf16 linear x4": ("steering_resize_kernel", lambda: k1.steering_resize(
            feat, lin_hyper, geom, operands=ops[True], linear=True,
            out_dtype=u8)),
        "K1 float32 feature, bf16 maps, gauss x4": (
            "steering_resize_kernel", lambda: k1.steering_resize(
                feat.float(), hyper, geom, operands=ops[False],
                out_dtype=u8))}
    for support in (2, 4):
        params = k5.WarpParams.create((cs.LR_H, cs.LR_W),
                                      cs.WARP_CASES["main"][0], cs.WARP_OUT,
                                      support=support)
        for lin in (False, True):
            mode = "linear" if lin else "gauss"
            h = lin_hyper if lin else hyper
            timed[f"K5 bf16 {mode} main S={support}"] = (
                "steering_warp_kernel",
                lambda h=h, p=params, lin=lin: k5.steering_warp(
                    feat, h, p, linear=lin, out_dtype=u8))
        if support == 2:
            timed["K5 float32 feature, bf16 maps, gauss main S=2"] = (
                "steering_warp_kernel", lambda p=params: k5.steering_warp(
                    feat.float(), hyper, p, out_dtype=u8))
    for rnd in range(rounds):
        for name, (key, fn) in timed.items():
            for source in ("as built", "other"):
                lib = (other_library(k1_path, k5_path) if source == "other"
                       else contextlib.nullcontext())
                kernel = k1_path if "K1" in name else k5_path
                if source == "other" and kernel is None:
                    continue
                with lib:
                    out = fn()
                    row = {"kernel": name, "source": source if
                           source == "as built" else kernel, "round": rnd,
                           "ms": cs.event_ms(fn, iters=50),
                           "graph_ms": cs.graph_ms(fn),
                           **cs.kernel_device_ms(fn, key)}
                if source == "as built":
                    want = out
                else:
                    row["equals_kernel"] = same_bits(out, want)
                    if not row["equals_kernel"]:
                        differ.append(f"{name} round {rnd}")
                emit(row)
    return differ


RINGS_FIRST = "steering_warp_rings_first.cu"
# the producer-warp design (mbarriers, rings and source box streamed ahead)
RINGS_PRODUCER = "steering_warp_rings_producer.cu"


def rings_cases(dev):
    """``--rings``' data: the LUT form's main-path stage outputs (the
    probe's seed-0 frame and bench bank; the linear mode on the first code
    plane) and the rings of ``warp_matrix()`` (the host's fused
    precompute), of chip_smoke's radial distortion grid and of its
    row-shuffled form, uploaded.  {(grid, linear): (feat, codes,
    DeviceRings)}."""
    import torch

    import chip_smoke as cs
    from lerf_torch.ops import lut_pipeline as lp
    from lerf_torch.ops.geometry import WarpOperands
    from lerf_torch.ops.kernels import warp as k5
    from lerf_torch.ops.resample import warp_rings, warp_serving_host_fused

    in_sz = (cs.LR_H, cs.LR_W)
    img = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (3,) + in_sz).astype(np.int32)).to(dev)
    bank = cs.bench_bank()
    feat = lp.lut_stage1(img, lp.FlatTables.create(bank.stage1, dev),
                         cs.MODES)
    codes = lp.lut_stage2(feat, lp.FlatTables.create(bank.stage2, dev),
                          cs.MODES)
    cases = {}
    for linear in (False, True):
        c = codes[..., :1].contiguous() if linear else codes
        main, _ = warp_serving_host_fused(in_sz, cs.warp_matrix(),
                                          cs.WARP_OUT, linear=linear)
        grids = {"main": main}
        for name in ("radial", "shuffled"):
            gx, gy = cs.distortion_grid(in_sz, cs.WARP_OUT,
                                        name == "shuffled")
            grids[name] = warp_rings(WarpOperands.from_grid(
                gx, gy, in_sz, cs.WARP_OUT), linear=linear)
        for name, r in grids.items():
            cases[(name, linear)] = (feat, c, k5.upload_rings(
                r, dev, linear=linear))
    torch.cuda.synchronize()
    return cases


def probe_rings(rounds: int, k5_sources=(), sass=False) -> int:
    """The ``--rings`` section (the module docstring).  Returns 1 if any
    source's output differs from the kernel's."""
    import torch

    import chip_smoke as cs
    from lerf_torch.ops.kernels import warp as k5

    cs.CARD = card = cs.card_line()
    dev = torch.device("cuda")
    here = os.path.dirname(os.path.abspath(__file__))
    cases = rings_cases(dev)
    differ = []

    def emit(row):
        print(json.dumps({**row, "card": card}), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, variants=RINGS_VARIANTS, others=[
            ("steering_warp", "first design", os.path.join(here,
                                                           RINGS_FIRST)),
            ("steering_warp", "producer warp", os.path.join(
                here, RINGS_PRODUCER))] + [
            ("steering_warp", p, p) for p in k5_sources])
        for (kernel, name), path in libs.items():
            for fn, (nreg, opc) in sass_rows(
                    path, "steering_warp_rings_kernel").items():
                emit({"sass": kernel, "variant": name, "function": fn,
                      "registers": nreg,
                      "instructions": sum(opc.values())})
        if sass:
            for p in k5_sources:
                compare_sass(libs, "steering_warp", "steering_warp_kernel",
                             p, emit)

        def call(grid, linear, out_dtype):
            feat, codes, rings = cases[(grid, linear)]
            return lambda: k5.steering_warp_rings(
                feat, codes, rings, out_sz=cs.WARP_OUT, linear=linear,
                out_dtype=out_dtype)

        # the kernel against its first design and the other sources,
        # alternating, every case held bit-equal every round
        others = ["first design", "producer warp"] + list(k5_sources)
        for rnd in range(rounds):
            for (grid, linear) in cases:
                for out_dtype in (torch.uint8, torch.float32):
                    fn = call(grid, linear, out_dtype)
                    want = fn()
                    row = {"grid": grid,
                           "mode": "linear" if linear else "gauss",
                           "out": str(out_dtype).replace("torch.", ""),
                           "round": rnd}
                    emit({**row, "source": "as built",
                          "graph_ms": cs.graph_ms(fn)})
                    for other in others:
                        with other_library(None, libs[("steering_warp",
                                                       other)]):
                            got = fn()
                            ms = cs.graph_ms(fn)
                        equal = same_bits(got, want)
                        emit({**row, "source": other, "graph_ms": ms,
                              "equals_kernel": equal})
                        if not equal:
                            differ.append(f"{other} {row}")
            # each variant once a round, the main grid, uint8
            for kernel, named in RINGS_VARIANTS.items():
                for name in named:
                    for linear in (False, True):
                        fn = call("main", linear, torch.uint8)
                        want = fn()
                        with other_library(None, libs[(kernel, name)]):
                            got = fn()
                            ms = cs.graph_ms(fn)
                        emit({"kernel": kernel, "variant": name,
                              "grid": "main",
                              "mode": "linear" if linear else "gauss",
                              "out": "uint8", "round": rnd, "graph_ms": ms,
                              "equals_kernel": same_bits(got, want)})
    print(card)
    if differ:
        print(f"rings outputs differ from the kernel's: {differ}",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k5", action="append", default=[], metavar="OTHER.cu",
                    help="another K5 source to time beside the kernel")
    ap.add_argument("--k1", action="append", default=[], metavar="OTHER.cu",
                    help="another K1 source to time beside the kernel")
    ap.add_argument("--rounds", type=int, default=5,
                    help="alternating rounds of the --k5 / --k1 comparison")
    ap.add_argument("--sass", action="store_true",
                    help="print K5's registers and SASS opcode counts")
    ap.add_argument("--k6", action="store_true",
                    help="time K6's tiles and its first design only")
    ap.add_argument("--rows", action="store_true",
                    help="time K2's row mode, its variants and its first "
                    "design only")
    ap.add_argument("--k2", action="append", default=[], metavar="OTHER.cu",
                    help="with --rows: another flat K2 source to time "
                    "beside the kernel")
    ap.add_argument("--rings", action="store_true",
                    help="time K5's rings instance, its variants and its "
                    "first design only (and each --k5 source's rings "
                    "entry)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_lut_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    if args.k6:
        return probe_k6(args.rounds)
    if args.rows:
        return probe_rows(args.rounds, args.k2)
    if args.rings:
        return probe_rings(args.rounds, args.k5, args.sass)
    from lerf_torch.ops import lut_pipeline as lp
    from lerf_torch.ops.geometry import ResizeGeometry
    from lerf_torch.ops.kernels import resize as k1
    from lerf_torch.ops.kernels import warp as k5
    from lerf_torch.ops.resample import quantize_device

    card = cs.card_line()
    dev = torch.device("cuda")
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = vp(torch.cuda.current_stream().cuda_stream)
    shape = (3, cs.LR_H, cs.LR_W)
    # the main path's data: chip_smoke's frame, its stage 1 and stage 2
    img = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, shape).astype(np.int32)).to(dev)
    bank = cs.bench_bank()
    stages = {"stage1": (lp.FlatTables.create(bank.stage1, dev), False, 48,
                         0),
              "stage2": (lp.FlatTables.create(bank.stage2, dev), True, 192,
                         127)}
    feat = lp.lut_stage1(img, stages["stage1"][0], cs.MODES)
    codes = lp.lut_stage2(feat, stages["stage2"][0], cs.MODES)
    stage_in = {"stage1": img, "stage2": feat}
    geom = ResizeGeometry.create(shape[1:], scale_factors=[cs.SCALE] * 2)
    ops = k1.ResizeOperands.create(geom, dev)
    oh, ow = geom.out_sz

    # the same values as the float32 instances take them: the feature as
    # float32, the maps code / 255
    ffeat = feat.to(torch.float32)
    fcodes = lp.divide_exact(codes.to(torch.float32), 255)

    def k1_args(out, tile, u8, floats=False):
        f, c = (ffeat, fcodes) if floats else (feat, codes)
        ptrs = (f, c, out, ops.rows, ops.cols, ops.dis_x, ops.dis_y)
        return [*(vp(t.data_ptr()) for t in ptrs), vp(None), vp(None),
                *map(i32, (3, cs.LR_H, cs.LR_W, oh, ow, geom.support,
                           int(geom.antialias), 0)),
                f32(geom.min_scale), f32(10.0), f32(255.0),
                *map(i32, (*tile, u8)), stream, i32(int(floats))]

    members = {stage: lp.member_descriptors(cs.MODES, split_r, t.keys)
               for stage, (t, split_r, _, _) in stages.items()}

    def k2_args(stage, out, table):
        tables, _, den, bias = stages[stage]
        return [vp(stage_in[stage].data_ptr()), vp(table.data_ptr()),
                vp(out.data_ptr()),
                vp(members[stage].ctypes.data),
                *map(i32, (len(members[stage]), *shape,
                           tables.table.shape[-1], cs.L4, 4, den, bias,
                           255)),
                stream]

    def emit(kernel, name, ms, equal, **extra):
        print(json.dumps({"kernel": kernel, "variant": name, **extra,
                          "ms": ms, "equals_kernel": equal, "card": card}),
              flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, args.k5, k1_sources=args.k1)
        for kernel, key, others in (
                ("steering_warp", "steering_warp_kernel", args.k5),
                ("steering_resize", "steering_resize_kernel", args.k1)):
            for name in ["as built"] + others if args.sass else []:
                for fn, (nreg, opc) in sass_rows(libs[(kernel, name)],
                                                 key).items():
                    print(json.dumps({"kernel": kernel, "source": name,
                                      "function": fn, "registers": nreg,
                                      "instructions": sum(opc.values()),
                                      "opcodes": dict(sorted(opc.items()))}),
                          flush=True)
                if args.sass and name != "as built":
                    compare_sass(libs, kernel, key, name,
                                 lambda row: print(json.dumps(row),
                                                   flush=True))
        fns = {}
        for key, path in libs.items():
            lib = ctypes.CDLL(path)
            # K5's one entry takes a batch; earlier sources and the first
            # design have a single-frame lerf_steering_warp
            fn = getattr(lib, "lerf_" + key[0] + "_batch", None) \
                or getattr(lib, "lerf_" + key[0])
            fn.restype = ctypes.c_int
            fns[key] = fn

        def timed(fn, args, what):
            def run():
                err = fn(*args)
                if err:
                    raise RuntimeError(f"{what}: CUDA error {err}")
            return cs.event_ms(run, iters=20, warmup=2)

        # K1
        u8 = torch.empty(3, oh, ow, dtype=torch.uint8, device=dev)
        want_u8 = torch.empty_like(u8)
        base = fns[("steering_resize", "as built")]
        ms = timed(base, k1_args(want_u8, ops.tile, 1), "K1")
        emit("steering_resize", "as built", ms, True, tile=list(ops.tile))
        f32_out = torch.empty(3, oh, ow, device=dev)
        ms = timed(base, k1_args(f32_out, ops.tile, 0), "K1 float")
        emit("steering_resize", "float32 output", ms, bool(torch.equal(
            quantize_device(f32_out, 255), want_u8)))
        for name in VARIANTS["steering_resize"]:
            ms = timed(fns[("steering_resize", name)],
                       k1_args(u8, ops.tile, 1), f"K1 {name}")
            emit("steering_resize", name, ms, bool(torch.equal(u8, want_u8)))
        rows, cols = (t.cpu().numpy() for t in (ops.rows, ops.cols))
        for th, tw in K1_TILES:
            tile = (th, tw, k1._window_span(rows, th),
                    k1._window_span(cols, tw))
            ms = timed(base, k1_args(u8, tile, 1), f"K1 tile {tile}")
            emit("steering_resize", "as built, tile", ms,
                 bool(torch.equal(u8, want_u8)), tile=list(tile))

        # K2
        for stage, (tables, _, _, _) in stages.items():
            oc = tables.table.shape[-1]
            words = tables.padded if oc == 3 else tables.cells
            want = torch.empty(*shape, oc, dtype=torch.int32, device=dev)
            out = torch.empty_like(want)
            ms = timed(fns[("lut_stage", "as built")],
                       k2_args(stage, want, words), "K2")
            emit("lut_stage", "as built", ms, True, stage=stage)
            for name in VARIANTS["lut_stage"]:
                table = tables.table if name == "byte corners" else words
                ms = timed(fns[("lut_stage", name)],
                           k2_args(stage, out, table), f"K2 {name}")
                emit("lut_stage", name, ms, bool(torch.equal(out, want)),
                     stage=stage)

        # K5 on the main path's homography
        params = k5.WarpParams.create(shape[1:], cs.WARP_CASES["main"][0],
                                      cs.WARP_OUT)
        host = k5.WarpOperands.create(params.geometry(), dev)
        inv = (ctypes.c_double * 9)(*params.inv)
        pads = (ctypes.c_int * 2)(*params.pad)
        woh, wow = cs.WARP_OUT
        mask = torch.empty(cs.WARP_OUT, dtype=torch.uint8, device=dev)

        def k5_args(out, u8, operands=False, with_mask=False, floats=False):
            """lerf_steering_warp_batch's arguments, one frame."""
            f, c = (ffeat, fcodes) if floats else (feat, codes)
            args = [vp(f.data_ptr()), vp(c.data_ptr()),
                    vp(out.data_ptr()),
                    vp(mask.data_ptr() if with_mask else None), inv, pads,
                    *map(i32, (1, 3, cs.LR_H, cs.LR_W, woh, wow,
                               params.support, 0)),
                    f32(10.0), f32(255.0), i32(u8), i32(4), stream,
                    i32(int(floats)), i32(0), i32(woh)]
            if operands:
                args += [vp(host.corners.data_ptr()), vp(host.dis.data_ptr())]
            return args

        def single_args(out, u8):
            """An earlier source's single-frame lerf_steering_warp."""
            return [vp(feat.data_ptr()), vp(codes.data_ptr()),
                    vp(out.data_ptr()), inv,
                    *map(i32, (3, cs.LR_H, cs.LR_W, woh, wow, *params.pad,
                               params.support, 0)),
                    f32(10.0), f32(255.0), i32(u8), stream]

        def first_args(out):
            return [*(vp(t.data_ptr()) for t in (feat, codes, out,
                                                 host.corners, host.dis)),
                    *map(i32, (3, cs.LR_H, cs.LR_W, woh * wow, *params.pad)),
                    f32(10.0), f32(255.0), i32(1), stream]

        want = torch.empty(3, woh, wow, dtype=torch.uint8, device=dev)
        out = torch.empty_like(want)
        base = fns[("steering_warp", "as built")]
        ms = timed(base, k5_args(want, 1), "K5")
        emit("steering_warp", "as built", ms, True)
        ms = timed(base, k5_args(out, 1, with_mask=True), "K5 mask")
        emit("steering_warp", "as built, with the mask", ms,
             bool(torch.equal(out, want)))
        f32_out = torch.empty(3, woh, wow, device=dev)
        ms = timed(base, k5_args(f32_out, 0), "K5 float")
        emit("steering_warp", "float32 output", ms, bool(torch.equal(
            quantize_device(f32_out, 255, nan_to_zero=True), want)))
        for name in VARIANTS["steering_warp"]:
            ms = timed(fns[("steering_warp", name)],
                       k5_args(out, 1, name == "host operands"), f"K5 {name}")
            emit("steering_warp", name, ms, bool(torch.equal(out, want)))
        ms = timed(fns[("steering_warp", "first design")], first_args(out),
                   "K5 first design")
        emit("steering_warp", "first design", ms, bool(torch.equal(out, want)))

        # other K5 sources against the kernel as built, alternating: the
        # int32 instance and, where the other's batch entry takes it, the
        # float32 one on the same values
        def other_args(path, floats):
            with open(path) as f:
                text = f.read()
            if "lerf_steering_warp_batch" in text:
                return k5_args(out, 1, floats=floats)
            if floats:
                return None
            a = single_args(out, 1)
            return a if "int S, int linear" in text else a[:11] + a[13:]

        want_f = torch.empty_like(want)
        other = {(path, floats): other_args(path, floats)
                 for path in args.k5 for floats in (False, True)}
        other = {k: a for k, a in other.items() if a is not None}
        for rnd in range(args.rounds if other else 0):
            for (path, floats), a in other.items():
                ref = want_f if floats else want
                inputs = "float32" if floats else "int32"
                ms = timed(base, k5_args(ref, 1, floats=floats), "K5")
                emit("steering_warp", "as built", ms, True, round=rnd,
                     inputs=inputs)
                out.zero_()
                ms = timed(fns[("steering_warp", path)], a, f"K5 {path}")
                emit("steering_warp", path, ms, bool(torch.equal(out, ref)),
                     round=rnd, inputs=inputs)

        # other K1 sources against the kernel as built, alternating: the
        # int32 and float32 instances at x4, uint8 output
        base1 = fns[("steering_resize", "as built")]
        want1 = {fl: torch.empty(3, oh, ow, dtype=torch.uint8, device=dev)
                 for fl in (False, True)}
        for rnd in range(args.rounds if args.k1 else 0):
            for path in args.k1:
                for floats in (False, True):
                    inputs = "float32" if floats else "int32"
                    ms = timed(base1, k1_args(want1[floats], ops.tile, 1,
                                              floats), "K1")
                    emit("steering_resize", "as built", ms, True, round=rnd,
                         inputs=inputs)
                    u8.zero_()
                    ms = timed(fns[("steering_resize", path)],
                               k1_args(u8, ops.tile, 1, floats),
                               f"K1 {path}")
                    emit("steering_resize", path, ms,
                         bool(torch.equal(u8, want1[floats])), round=rnd,
                         inputs=inputs)

        # the bf16 instances against the other sources' (the first of each)
        differ = []
        if args.k1 or args.k5:
            differ = probe_bf16(
                libs[("steering_resize", args.k1[0])] if args.k1 else None,
                libs[("steering_warp", args.k5[0])] if args.k5 else None,
                args.rounds, lambda row: print(json.dumps(
                    {**row, "card": card}), flush=True))
    print(card)
    if differ:
        print(f"bf16 outputs differ from the other source's: {differ}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
