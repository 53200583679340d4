#!/usr/bin/env python3
"""On-card smoke test of the lerf_torch port: one CUDA card, no arguments.

    python3 chip_smoke.py

Drives the port's two forms on a 360×640 RGB frame, each through its SR
path at ×4 and its homographic warp, both to 1440×2560, in both kernels,
LeRF-G and LeRF-L, and the SR and warp serving forms — the LUT form,
``LutPredictor(bank).upscale`` / ``.warp`` with the seed-0 random bank of
the shipped LeRF-G shapes (modes s,c,t, 2 stages, 17⁴-entry int8 tables,
oC 3), and the micro-net (SRNet) form,
``NetPredictor.from_srnets(params, backend=...).upscale`` / ``.warp`` at
the reference width nf = 64 with seed-0 numpy weights, for the float (K3)
and the int8 (K4) backends — and the IMDN (LeRF-Net) form,
``NetPredictor.from_imdn(IMDN2(nf=12))`` with weights from a
``torch.Generator`` seeded 0, whose float feature and hyper maps K1 and K5
take in their float mode (and in bf16, ``IMDN2(dtype=torch.bfloat16)``,
their bf16 instances), and the network → LUT transfer; then trains:
the reference's LeRF-G run at full width through the port's trainer (K1
forward, K6 backward), its validation, checkpoint and resume, LUT
fine-tuning and IMDN2; then serves: the async forms through pinned
staging on the predictor's side stream, the streaming engine, the HTTP
daemon, the several-input CLI and the N-D resize; and holds each
hand-written kernel against its plain PyTorch twin on the card:

1. the card (``nvidia-smi`` name and power limit), torch, the kernel build
   with each kernel's registers, stack, spills and static shared memory
   from ``-Xptxas -v``;
2. K1 (steering resize) vs its plain twin at 360×640, ×4 / ×2.5 / ×3.55 /
   ×0.5: float32 max-abs ≤ 1e-3 (whether it is bit-equal printed: the
   twin's decode divides exactly, ``ops.lut_pipeline.divide_exact``); K1's
   uint8 mode exactly equal to its float mode quantized; uint8 mismatches
   with the twin must be .5 ties;
3. K2 (LUT stage) vs its plain twin, bit-equal: stage 1, stage 2 and a
   3-stage bank's intermediate stage;
4. LUT form end to end on the card vs ``device="cpu"``: feat and hyper
   bit-equal, uint8 equal but for .5 ties; K1 launched once, K2 twice;
5. LUT form timing: the whole ``upscale`` call, its device part, a
   profile, the device part's kernels (K1 and K2 and nothing else), each
   kernel (K1 in its main-path uint8 mode, its float mode beside it) by
   CUDA events around back-to-back calls, with torch.profiler's device
   time of the kernel alone beside it (events read the host's rate once a
   wrapper's Python costs more than its kernel), and its plain twin, with
   each kernel's bound;
6. K3 (float SRUnit ensemble, 3xTF32 on the tensor cores) and K4 (int8
   tensor cores) vs their plain twins at the stage shapes, 3×360×640 with
   oC 1 and oC 3 — K3 sums within 2 on < 0.5 % of pixels (products with
   ~2⁻²² relative error, summed in another order), K4 within 1 on < 0.1 %
   (bit-equal int8 arithmetic, ``tanhf`` ulps) — with each kernel's time,
   its twin's, its bound (K3's the faster of float32 on the CUDA cores and
   3xTF32 on the tensor cores, all parts printed) and its share of it;
7. net form end to end, per backend: the 360×640 frame on the card (K1
   launched once, K3 or K4 twice, nothing else), then a 96×160 crop on
   the card vs ``device="cpu"``: feat and hyper codes within 1 on < 0.5 %
   of pixels, uint8 equal to the plain resize of the card's own stages
   but for .5 ties;
8. net form timing per backend: the whole call, its device part, a
   profile;
9. K5 (steering warp) vs its plain twin at 3×360×640 for four
   homographies — the main path's (``bench_lut_warp``'s ×4 zoom composed
   with bench.py's projective jitter, seed 0), a pure ×2.5 zoom, one
   whose output corner (0, 0) lies above and left of the image
   (``pad0 = 1`` on both axes, distances of 2 on the far side, NaN
   windows) and a 1/16 minification, whose every block's footprint
   exceeds K5's shared-memory tile (the kernel's direct path; the share
   of such blocks printed for each): the geometry K5 derives on the card
   (``lerf_warp_geometry``) bit-equal to the host's per-pixel operands;
   float32 max-abs ≤ 1e-3 on finite values, the NaN pattern equal (count
   printed), the uint8 mode equal to the float mode with NaN → 0
   quantized, uint8 mismatches with the twin only at .5 ties;
10. LUT warp end to end, ``LutPredictor(bank).warp(frame, M, (1440,
   2560), return_aux=True)`` on the card vs ``device="cpu"`` on the full
   frame: feat and hyper bit-equal, the mask equal, uint8 equal but for
   .5 ties; K2 launched twice, K5 once, K1 never; the first call of the
   homography (``first_call_s``: its parameters, and K5 writes the mask,
   which the predictor keeps: a repeated call runs K5 without it); the
   device part (``run_warp_device``) launches K2 and K5 and nothing else
   (profiler); then the whole call (median of 20), the device part
   (events), a profile, and K5 alone beside its twin and its bound (the
   larger of bytes, float32 and float64 operations, all parts printed);
11. net warp per backend: K3 or K4 twice and K5 once on the full frame, a
   96×160 crop against the CPU path (phase 7's tolerances, the mask
   equal, uint8 equal to the plain warp of the card's own stages but for
   .5 ties), the whole call (median of 10), its device part, a profile;
12. K1's amplified-linear (LeRF-L) mode vs its twin at the phase 2 scales
   (one α code a pixel): float32 max-abs ≤ 1e-3 (bit-equality printed),
   the uint8 mode its float mode quantized (NaN → 0), uint8 mismatches
   only at .5 ties;
13. K5's linear mode vs its twin at the four phase 9 matrices, and K5 at
   supports 3 and 4, Gaussian and linear, at the main matrix and the ×2.5
   zoom: the card's geometry (corners, distances, the linear mode's
   float64 branch masks) bit-equal to the host's, finite values within
   1e-3, the NaN pattern equal (counts printed), uint8 only at ties;
14. the LeRF-L LUT form (``bench_bank(out_c=1)``: stage 2 gives α) on the
   full frame, ``upscale`` ×4 and ``warp``, on the card vs the CPU: feat
   and hyper bit-equal, the mask equal, uint8 equal but for ties; K2
   twice and K1 (SR) or K5 (warp) once, and the device parts launching
   nothing else (profiler); the whole calls (median of 20), the device
   parts, and K1's and K5's linear modes alone by events and by the
   profiler beside their twins and bounds;
15. the LeRF-L micro-net form (nf 64, K3): K3 twice and K1 or K5 once on
   the full frame, the warp's frame against the plain warp of its own
   stages, a 96×160 crop against the CPU path (phase 7's tolerances);
16. the LUT warp at ``supp_size`` 4 (K2 twice, K5 once), then K5 alone at
   support 4 beside its twin and its bound;
17. the SR serving forms, LUT form, LeRF-G and LeRF-L:
   ``upscale_dynamic`` at ×4 and ×2.5 (granularity 0 and 64, which the
   port ignores: PyTorch needs no shape buckets) and ×0.5,
   ``upscale_bucketed(..., 64)`` at ×4 (``upscale`` itself) and
   ``upscale_batch`` of 4 frames at ×4, each bit-equal to ``upscale`` on
   the card frame by frame and each call K2 twice and K1 once (the batch
   too); the batch's and ``upscale_dynamic``'s ms a call beside
   ``upscale``'s;
18. K5's validity mask on the card for ``warp_matrix(0..3)``, the pad-1
   matrix and the ×2.5 zoom: alone (``warp_mask``), written in K5's own
   launch (``mask_out``) at supports 2 and 4, and from the inverse alone
   (``nearest_warp_mask_on_device``), each ``torch.equal`` to the host's
   float64 mask; the frame unchanged by asking for the mask;
19. ``steering_warp_batch`` over 4 frames under ``warp_matrix(0..3)``,
   Gaussian and linear, uint8 and float32: one launch, each frame
   bit-equal to its own K5 call and its mask to the host's, each frame
   against its twin with phase 9's tolerance;
20. ``warp_dynamic`` and ``warp_device`` (LUT, LeRF-G) for 4 matrices,
   each bit-equal to ``warp`` on the card (frame and mask) with K2 twice
   and K5 once a call; the first call on a new homography by ``warp``,
   ``warp_dynamic`` and ``warp_device`` (``first_call_s``);
21. ``warp_batch`` of 4 frames (per-frame matrices, and one shared) in the
   LUT form (LeRF-G, LeRF-L) and the net form on K4: each frame and mask
   bit-equal to that frame's ``warp``, K2 (or K4) twice and K5 once a
   call;
22. the whole calls of ``warp``, ``warp_dynamic``, ``warp_device`` and
   ``warp_batch`` (a frame) in one run, and K5 alone without the mask,
   with it and over 4 frames (events in two alternating rounds, the
   profiler, twins, bounds);
23. K1's and K5's float modes (float32 feature in [0, 254] and hyper
   maps in [0, 1]) against their twins, lerf_tpu's float ops
   (``steering_gaussian_resize`` / ``amplified_linear_resize``,
   ``steering_gaussian_warp`` / ``amplified_linear_warp`` with
   ``u8_inputs=False``): K1 at the phase 2 scales, K5 at the phase 9
   matrices with the mask (``torch.equal`` to the host's), at support 4
   and over a batch of 4 frames (each bit-equal to its own call), both
   kernels; the NaN pattern equal, finite values within 1e-3, uint8 the
   float mode quantized and off the twin only at .5 ties;
24. the IMDN form at full width (nf 12, 5 modules a tower), backends
   "base" and "s2d": ``upscale`` ×4 (one K1 launch, no other kernel of
   the port) and ``warp`` under ``warp_matrix()`` (one K5 launch), a
   96×160 crop against the CPU path (feature within 1e-3, hyper maps
   within 1e-5, frames within one level on ≤ 0.1 %, the SR frame the twin
   resize of the card's own stages but for .5 ties, the mask equal); the
   whole calls, the device parts, the towers' device time (the profiler's
   cuDNN rows, and with the elementwise rows) beside their bound; then K1
   and K5 alone, float mode on the towers' outputs beside int32 mode on
   the LUT stages', alternating;
25. the IMDN serving forms (``upscale_dynamic``, ``upscale_batch`` of 4,
   ``warp_dynamic``, ``warp_device``, ``warp_batch`` of 4), each bit-equal
   to ``upscale`` / ``warp`` on the card frame by frame with one K1 or K5
   launch a call, and their times;
26. ``transfer_to_lut`` of the nf 64 SRNet params on the card against the
   CPU's (≤ 1 LSB, ≥ 99.9 % equal), its seconds, and ``LutPredictor`` on
   that bank upscaling on the card (K2 twice, K1 once);
27. K6 (the training resize's backward) against its twin on the card at
   the LeRF training shape (16 planes of 48×48 → ×4, support 2), at
   support 4, ×2.5 and the frame (3 × 360×640 → ×4), both modes: each
   gradient within 1e-4 of its largest value, a second launch bit-equal,
   the twin against autograd of the plain op; then K6 and its first
   design (``lerf_torch/tools/steering_resize_bwd_first.cu``, built beside
   the library) in alternating rounds at the training shape and the
   frame, by events and by the profiler, with the bound and share; the
   twin and K1's float-mode float32-out forward beside;
28. the trainer at full width, the reference's LeRF-G run (SRNetsSWF2, nf
   64, modes sct, 2 stages, --twoStage, oC 3, ×4, crop 48, batch 16, lr0
   1e-3) for 50 steps on a synthetic DIV2K layout, through
   ``lerf_torch.train.loop.train`` with the host sampler and with
   ``--device_data`` (K1 and K6 once a step; validation on a synthetic
   Set5 at the last step through ``NetPredictor.from_srnets``: K3 twice
   and K1 once an image and scale); then its step: one step on the card
   against the CPU's from the same params and batch (loss, gradient norm,
   params after Adam), ms a step (events; the host clock with the
   sampler's pinned batches), the profiler's split and busy share, peak
   memory, the bound, and from the profiler's rows K1 + K6 and no gather;
29. the run resumed from its step-25 checkpoint: the final params bit-equal
   to the uninterrupted run's;
30. the trained params transferred on the card, ``--lutft`` for 10 steps at
   17⁴ tables (K1 + K6 a step, validation by ``LutPredictor``: K2 + K1),
   and ``LUTft_*.npy`` served by ``LutPredictor`` (K2 twice, K1 once);
31. IMDN2 (nf 12) trained 5 steps, and its step with TF32 allowed outside
   it: no TF32 kernel in the forward or the backward;
32. the async forms (``upscale_dynamic_async``, ``warp_dynamic_async``,
   ``warp_device_async``) of the LUT form (LeRF-G, LeRF-L), the net form
   on K4 and the IMDN form at 360×640 → ×4 and ``warp_matrix(0..3)`` →
   1440×2560: each future's frame and mask bit-equal to the synchronous
   form, to ``upscale`` / ``warp`` and to the host-staged path (the forms
   before the pinned staging: host layout and cast, pageable copies), the
   stage kernels and one K1 or K5 a request (counts at 0 before each), the
   dispatch's host ms and the whole request's;
33. pinned-buffer reuse: 8 distinct frames dispatched before any
   ``result()``, SR and warp, each bit-equal to its synchronous call; the
   serving cache cut to 2 and 8 new scales dispatched (entries evicted
   while requests are in flight), each checked again;
34. ``stream_upscale`` and ``stream_warp`` over 32 frames at depths 1, 2
   and 4 against the sequential loop, in alternating rounds: every result
   bit-equal, ms a frame, the device ms a frame (profiler) and the busy
   share;
35. the pinned memory kept results hold: ``upscale`` results kept until
   the caching host allocator's pool has grown by 8 blocks, then dropped,
   then as many calls more: the pool's blocks and bytes after each, the
   bytes a kept result added (its block), and the pool neither growing
   nor shrinking on the second leg;
36. the HTTP daemon on 127.0.0.1:0 in a thread (LUT form, full frame):
   upscale npy, warp npz and masked npy, both batch routes and
   ``--geometry device``, each equal to the in-process predictor, the
   launches of one request each; one client × 8 requests, then 4
   concurrent clients × 8 requests on frames of their own (a fresh
   daemon), each client a process of its own (``chip_smoke.py
   --http-client``) whose responses are held to the in-process
   predictor's by SHA-256; /healthz's p50 / p99 of each request part
   (decode, dispatch, total, encode) for each; a net-form (K4) request;
37. ``cli.upscale`` on a directory of 4 PNGs (360×640) with
   ``--dynamicSR`` and with ``--matrix … --dynamicWarp``: each output
   equal to the one-file call's;
38. ``ops.resize`` and ``cli.make_benchmark``'s ``downscale`` on a
   1440×2560 frame, the card against the CPU (float32 within 1e-3, uint8
   but for .5 ties);
39. K5 on 4 windows of output rows (``rows=``) for ``warp_matrix(0..3)``,
   supports 2 and 4, Gaussian and linear, int32 and float inputs, with the
   mask: each window ``torch.equal`` to the same rows of the whole launch
   and its mask to the host's rows; ``warp_matrix(0)``'s windows against
   their plain twin (the host geometry's rows) within phase 9's tolerance;
40. K1 on ``ResizeOperands.rows_window`` at phase 2's scales, int32 and
   float: each window ``torch.equal`` to the whole launch's rows and
   within phase 2's tolerance of its twin (the geometry's rows);
41. the multi-device slice on the one card, meshes ``[cuda:0] × 2`` and
   ``× 4`` (a stream a shard): ``sharded_lut_sr_pipeline``,
   ``sharded_lut_warp_pipeline`` (frame and mask),
   ``sharded_dynamic_sr_pipeline``, ``sharded_dynamic_warp_pipeline`` and
   ``sharded_devgeo_warp_pipeline`` at 360×640 → ×4 (LeRF-G bank of
   phase 4), each bit-equal to its single-device form (``upscale``,
   ``warp``, ``upscale_dynamic``, ``warp_dynamic``, ``warp_device``) with
   2 K2 and one K1 or K5 launch a shard and ONE all-gather (``transfers``
   1 + n(n-1)); SR at 1080×1920 → ×2 (a 2160×3840 output) bit-equal to
   ``upscale``; the whole calls and their device parts at 1, 2 and 4
   shards beside the predictor's (on one card the cost of sharding, not a
   scale-out);
42. the sharded net form: K4 ``sharded_net_sr_pipeline`` on the frame and
   K3 on the 96×160 crop, codes within the net gates of the single-device
   predictor's, K3 or K4 twice and K1 once a shard;
43. the sharded IMDN form (nf 12), base and s2d, band (44-row halos) and
   exchange (the input row-sharded, ONE ``exchange_halos``: 2 neighbour
   transfers across each interior boundary, no all-gather) forms, feature
   within 1e-3 and hyper maps within 1e-5 of the single-device towers; the
   SR pipeline's frame within one level on ≤ 0.1 %;
44. ``upscale_batch`` of 4 frames on mesh predictors (LUT, net on K4)
   over 2 and 4 shards: each frame bit-equal to ``upscale``, 2 K2 (K4) and
   one K1 a shard, no collective;
45. (with the training phases, on their synthetic DIV2K) data-parallel
   training: 5 LeRF-G steps (batch 16, crop 48, nf 64) on ``[cuda:0] ×
   2`` against the single-device step from the same state and batches,
   each step's loss within 1e-5 relative and every parameter within 1e-5
   of the params' largest magnitude, one K1 and one K6 launch a shard a
   step;
46. K3's bf16 kernel (lerf_tpu's compute type for bf16 heads: bf16
   samples and activations, float32 sums, biases and head; ``wgmma`` on
   shared-memory tiles, the weights by bulk copies) against its twin at the stage shapes, 3×360×640 with
   oC 1 and oC 3, nf 64: the share of differing sums and the largest
   difference (within ``K3_BF16_TOL``), its first design's beside
   (``lerf_torch/tools/srnet_ensemble_bf16_first.cu``, built beside the
   library), ptxas registers and spills of both designs' instances, the
   kernel and its first design in alternating rounds by events and by the
   profiler, the twin's time, the bound (one bf16 tensor-core pass) and
   share, and the weight bytes a frame each design implies it reads from
   L2 (worked out from its tiles, not measured);
47. the bf16 net form: ``NetPredictor.from_srnets`` on the seed-0 nf 64
   params rounded to bf16, ``upscale`` ×4 and ``warp`` to 1440×2560 (K3's
   bf16 kernel twice and K1 or K5 once, the counts read from the
   wrappers), a 96×160 crop against the CPU path (phase 7's tolerances),
   the whole calls, the device parts and the device part's bound;
48. nf 128: K3 float32 (64-pixel tiles), K3 bf16 and K4 each against its
   twin on a 3×96×160 crop (oC 1 and 3; phase 6's tolerances, bf16's its
   own), each instance's time at the stage shapes beside its twin's and
   its bound, K3 bf16 as phase 46 has it (its first design, alternating
   rounds, the implied L2 weight bytes), and the launches of ``from_srnets`` at nf
   128 on the crop (two of the stage kernel a call);
49. the LUT table layouts (``"flat"``, ``"packed8"``, ``"packed32"``,
   ``"cells"``): K2's row mode on each (the int32 layouts' stage-2 slots
   copied into shared memory by warps), stage 1 and stage 2 on both frames
   below bit-equal to flat K2, to the twin and to its first design
   (``K2_ROWS_FIRST``, built beside the library);
   ``LutPredictor(table_layout=...)`` SR and warp
   bit-equal to the flat predictor on the card, K2 twice and K1 or K5 once
   a call; on bench.py's uniform random frame and on a smooth frame (a
   seeded uniform field box-blurred and stretched to 0..255: neighbouring
   pixels share lattice cells, as in photographs), each layout's K2 times
   (events, the profiler, and a CUDA graph's replays, which the choice
   reads; the first design's graph replays in alternating rounds and, on
   the random frame, its profiler time beside), whole ``upscale`` calls
   and device parts, the
   bound from the table rows that frame touches, and the layout the
   numbers favour;
50. the IMDN form's bf16 compute type (``IMDN2(nf=12,
   dtype=torch.bfloat16)``, phase 24's weights): first the native bf16
   steps K1's and K5's bf16 instances run, each against the twin's
   float-then-round over all 2^32 operand pairs (``BF16_STEPS``, one
   summary line of mismatches a step; any in a step the kernels use
   fails the phase); K1's and K5's bf16
   instances (lerf_tpu's resize and warp run in bf16, every operation
   rounded to bf16) against their twins on the card, K1 at phase 2's
   scales and K5 at phase 9's matrices with the mask, at support 4 and
   over 4 frames (each bit-equal to its own call), both weights, within
   ``K_BF16_ULPS``; then ``NetPredictor.from_imdn`` on the bf16 model,
   backends base and s2d, ``upscale`` ×4 and ``warp`` under
   ``warp_matrix()``, each call exactly one K1 (K5) launch and that one
   the bf16 instance (the maps reach it as bf16), a 96×160 crop against
   the CPU path (``IMDN_BF16_*_TOL``, the mask equal, the SR frame within
   a level of the twin resize of the card's own bf16 stages), the whole
   calls, the device parts, the towers' profiler time in bf16 beside
   float32's in the same call, and K1 / K5 bf16 alone beside their twins
   and bounds;
51. K5's rings instance (the warp's geometry as data) at full width: the
   host rings of ``warp_matrix()`` from ``warp_serving_host_fused`` (the
   C library at 1 thread and at ``native_threads()`` bit-equal to numpy,
   each timed) and ``warp_rings_on_device`` (the rings geometry kernel,
   equal to the host's and to its twin on the card); the LeRF-G LUT
   stages warped through each, the rings made inside the counted run
   (2 K2 + 1 rings launch, + 1 geometry launch for the card's rings),
   equal to K5's matrix instance; the rings instance ``torch.equal`` to
   the matrix instance in uint8 (LUT, both modes) and in float32 (the
   IMDN form's float32 and bf16 maps, both modes, bf16 maps under float32
   and under bf16 rings); a radial distortion and its row-shuffled form
   (``WarpOperands.from_grid``: every block tiled, most on the direct
   path) ``torch.equal`` to its twin; the rings instance's persistent
   grid and ptxas's registers (a line of their own); its time by
   CUDA-graph replays beside its first design (``RINGS_FIRST``, built
   beside the library) and the matrix instance in
   alternating rounds on the main frame, and beside its first design on
   both grids (each round's outputs ``torch.equal``), the geometry
   kernel's by graph replays, the upload of the pinned rings, their
   bounds (bytes: 20 of rings an output read, or written; the rings
   instance's also in the linear mode, on float32 maps and in its bf16
   instance);
52. the exact-division findings (K1 bit-equal to its twin or not at each
   phase 2 scale, in both modes; the net crop's feat / hyper-code
   difference shares under K3 and K4), the kernels line (K1's and K5's
   rows with their ``linear`` and ``float`` modes, K1's and K5's
   ``window``, and K5's ``support4``, ``mask`` and ``batch4`` beside; K6's
   with its ``linear`` mode; then one row for each instance this slice
   added: K3 bf16, K3 / K3 bf16 / K4 at nf 128 and K2's row mode on each
   layout, its first design's times beside, and K1's and K5's bf16
   instances, with the PR that redesigned them and where their earlier
   design's times stand: the probe, not this script, times that design;
   K5's rings instance and the rings geometry kernel), the card line
   and, last, the result line.

Any failure exits non-zero; without a CUDA card it exits 1 and prints no
result.  Imports neither JAX nor lerf_tpu.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

LR_H, LR_W, SCALE = 360, 640, 4.0
MODES = ("s", "c", "t")
L4 = 17 ** 4
NF = 64               # the reference SRNet's width
CROP_H, CROP_W = 96, 160   # the net form's card-vs-CPU crop
K1_ATOL = 1e-3        # float32 ops in one order; exp differs by a few ulp
TIE_TOL = 1e-3        # a uint8 mismatch needs a value this close to k + .5
# (max level difference, share of pixels that may differ)
K3_TOL = (2, 0.005)   # the same float32 products summed in another order
# K3 bf16 against its twin: lerf_tpu's float-kernel bound; an activation on
# a bf16 rounding edge rounds either way under another float32 sum order
K3_BF16_TOL = (2, 0.005)
K4_TOL = (1, 0.001)   # int8 arithmetic bit-equal; tanhf may differ by ulps
NET_STAGE_TOL = (1, 0.005)   # feat / hyper codes, card vs CPU
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; float32 outside the
# tensor cores, which also bounds int32 throughput from above; TF32 and
# int8 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12
TENSOR_TF32_OPS_PER_S = 495e12
TENSOR_INT8_OPS_PER_S = 1979e12
TENSOR_BF16_OPS_PER_S = 989e12
WIDE_NF = 128          # phase 48: the widest nf the kernels take
LAYOUTS = ("flat", "packed8", "packed32", "cells")
SMOOTH_BOX = 15        # phase 49's smooth frame: 3 box passes of this width
# K3 keeps float32 on the tensor cores as three TF32 products a multiply-add
TF32_PRODUCTS_PER_F32 = 3
# operations counted per unit of work for the bound:
#  K1, per output pixel and neighbour: weight 11 (exp counted as 1),
#  accumulate 3; antialias adds 1; per source pixel the decode, 8 (3 div,
#  4 mul, 1 sub); per output the epilogue, 4 in uint8 (div, rint, clip)
K1_OPS_PER_NEIGHBOUR = 14
K1_OPS_PER_SOURCE = 8
K1_OPS_PER_OUTPUT_U8 = 4
#  K2, per pixel, member and output channel: the 5 multiply-adds of the blend
K2_OPS_PER_MEMBER_CHANNEL = 10
#  K4, per member and pixel: requantizing a hidden activation (convert,
#  multiply, add, round, clip) and finishing a head output (convert,
#  multiply, add, tanh, scale, round, sum)
K4_F32_OPS_PER_HIDDEN = 5
K4_F32_OPS_PER_HEAD = 7
#  K5, per output pixel, channel and neighbour: the weight's 11 (exp as
#  one) and 3 for the sums; per output and channel the epilogue, 5 in
#  uint8 (div, NaN test, rint, two clips); the decode at least once a
#  source pixel (K1_OPS_PER_SOURCE).  Its geometry in float64: per output
#  the grid's three row-term adds and two divisions, and per axis the
#  clip (2), (g - 1) - eps (2), ceil, + pad, two distances and their
#  casts (4): 25; per output row and column the grid's products and the
#  column's adds, 3 and 6
K5_OPS_PER_NEIGHBOUR = 14
K5_OPS_PER_OUTPUT_U8 = 5
K5_F64_OPS_PER_ROW = 3
K5_F64_OPS_PER_COLUMN = 6
#  the amplified-linear modes (LeRF-L), per output (and channel) and
#  neighbour: per axis α·x, ±1 and the clip at 0 (3), the product (1), the
#  sums (3): 10; the decode, 3 a source pixel (division, multiply,
#  subtract); K5's branch tests, 2 float64 comparisons a distance
LIN_OPS_PER_NEIGHBOUR = 10
LIN_OPS_PER_SOURCE = 3
K5_F64_BRANCH_OPS = 2
#  K5's validity mask, per output: per axis the NaN test and ceil((g -
#  0.5) - eps) (3), the grid and its clip shared with the window (the
#  index's clip and its two tests are integer work); and one byte written
K5_F64_MASK_OPS = 8
# H100 SXM float64 outside the tensor cores (NVIDIA data sheet)
F64_OPS_PER_S = 34e12
K5_ATOL = 1e-3          # float32 ops in one order; exp differs by a few ulp
WARP_OUT = (int(LR_H * SCALE), int(LR_W * SCALE))
#  the float modes (float32 feature and hyper maps, the IMDN form's): the
#  decode a source pixel, 2 rho - 1, sx * max, sy * max and 2 rho (5;
#  linear 2: a * 2 - 1), no divisions
K1_FLOAT_OPS_PER_SOURCE = 5
LIN_FLOAT_OPS_PER_SOURCE = 2
#  the bf16 instances (bf16 feature and maps): which of those operations
#  are bf16 (each a step of the twin's rounded to bf16, which the kernels
#  run as native bf16 pair instructions): the Gaussian's per neighbour all
#  but the exp (13; at K5's supports other than 2 the two sums are float32:
#  11), the antialias's product m w, the decode and the quotient; the
#  linear mode's per axis a x and its +-1 (4); the rest float32
K1_BF16_OPS_PER_NEIGHBOUR = 13
K5_BF16_OPS_PER_NEIGHBOUR_GENERIC = 11
LIN_BF16_OPS_PER_NEIGHBOUR = 4
# H100 SXM5 bf16 outside the tensor cores: 133.8 T/s, twice float32's
# (NVIDIA H100 Tensor Core GPU Architecture whitepaper, table "NVIDIA H100
# compared to A100", Peak BF16 non-Tensor); bf16x2 instructions issue on
# the same FMA pipes as float32's, so a bound adds the two times
BF16_NON_TENSOR_OPS_PER_S = 133.8e12
IMDN_NF = 12              # the reference LeRF-Net's width (5 modules a tower)
# the IMDN crop, card (cuDNN) against the CPU: the towers' float32 sums in
# another order (cuDNN's implicit GEMM), a few ulp of a value; the feature
# spans 0..254, the hyper maps 0..1 (the CPU tests' tolerances against
# lerf_tpu); a frame may round the other way at a .5 edge by one level
IMDN_FEAT_ATOL = 1e-3
IMDN_HYPER_ATOL = 1e-5
IMDN_U8_SHARE = 0.001
# the transfer, card against CPU: a head's float32 chain summed in another
# order flips round(clip(out) * 127) at a .5 edge, by 1 LSB
TRANSFER_EQUAL_SHARE = 0.999
# the trainer: the reference's LeRF-G run (scripts.sh:2-6): SRNetsSWF2,
# nf 64, modes sct, 2 stages, --twoStage, oC 3, x4, crop 48, batch 16, lr0
# 1e-3; depth cut to TRAIN_STEPS steps
TRAIN_CROP, TRAIN_BATCH, TRAIN_STEPS = 48, 16, 50
TRAIN_SAVE = 25                # a checkpoint there, resumed in phase 29
VAL_IMAGES = 5                 # the synthetic Set5: x2 / x3 / x4 each
# K6 against its twin: K6 sums each gradient term in a fixed order, the
# twin scatters with index_add (float atomics on the card): float32 sums
# of up to ~64 terms a pixel, relative to each gradient's largest value
GRAD_RTOL = 1e-4
# the training step on the card against the CPU's: the dense products sum
# in another order, so the loss and the gradient norm within 1e-4
# relative, and each leaf's gradient within TRAIN_RTOL of that leaf's
# largest value (Adam's first step moves a parameter by about lr0 sign(g),
# so the params alone would only hold the signs); after Adam the params
# within 1e-5 everywhere (the H100 gave 8.2e-7 at most: the step of a
# gradient near Adam's eps is the most sensitive to its last bits)
TRAIN_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5
# K6's operations, what the gradient needs with each weight counted once
# (K6's phase B works each weight out again, and its phase A the halo's
# outputs: that recompute is the design's cost, not the function's): per
# output and neighbour the weight and the sums W_o, out_o (K1's 14), the
# feature term (2), the coefficient P f - Q (2) and the three hyper terms
# (4 + 6 + 6): 34; linear the weight and sums (10), per axis dlin, the
# lin >= 0 test and the product with the other axis's clip (3 + 3) and
# their sum (1), the feature term (2), P f - Q (2) and the alpha term (2):
# 23; per output P, out, Q (3); per source pixel
# the decode and the chain rule (8)
K6_OPS_PER_NEIGHBOUR = 34
K6_LIN_OPS_PER_NEIGHBOUR = 23
K6_OPS_PER_OUTPUT = 3
K6_OPS_PER_SOURCE = 8
# phase 27's cases: (name, planes, LR size, scale, support); K6 and its
# first design (kept for timing, outside the library) are timed in
# K6_ROUNDS alternating rounds at the training shape and the frame
K6_CASES = (("train", TRAIN_BATCH, (TRAIN_CROP, TRAIN_CROP), 4.0, 2),
            ("x4-s4", TRAIN_BATCH, (TRAIN_CROP, TRAIN_CROP), 4.0, 4),
            ("x2.5", TRAIN_BATCH, (TRAIN_CROP, TRAIN_CROP), 2.5, 2),
            ("frame", 3, (LR_H, LR_W), SCALE, 2))
K6_TIMED = ("train", "frame")
K6_ROUNDS = 4
K6_FIRST = "lerf_torch/tools/steering_resize_bwd_first.cu"
# K3 bf16's first design (mma.sync on K3's float32 block), timed beside the
# kernel in K3_BF16_ROUNDS alternating rounds (phases 46 and 48)
K3_BF16_FIRST = "lerf_torch/tools/srnet_ensemble_bf16_first.cu"
K3_BF16_ROUNDS = 2
# K2 rows' first design (each member's slot read from global memory),
# timed beside the kernel by CUDA-graph replays in K2_ROWS_ROUNDS
# alternating rounds (phase 49)
K2_ROWS_FIRST = "lerf_torch/tools/lut_rows_first.cu"
K2_ROWS_ROUNDS = 2
# K5 rings' first design (the matrix instances' block with its windows
# loaded), timed beside the kernel by CUDA-graph replays in
# RINGS_ROUNDS alternating rounds (phase 51)
RINGS_FIRST = "lerf_torch/tools/steering_warp_rings_first.cu"
# phase 50, the IMDN form's bf16 compute type.  K1's and K5's bf16
# instances against their twins (the port's plain ops on bf16 tensors, on
# the card): the Gaussian's bf16 quotient within K_BF16_ULPS bf16 ulps
# (CUDA's expf may round a weight to the other bf16 neighbour near a tie;
# at supports other than 2 the warp twin's torch.sum may add its float32
# terms in another order), the linear mode's float32 quotient within
# K1_ATOL / K5_ATOL (its bf16 steps are a x and lin(a, x) alone)
K_BF16_ULPS = 2
# the exhaustive check of the native bf16 steps (built outside the
# library, beside it): each step against the twin's float-then-round over
# all 2^32 operand pairs, in the source's order; K1's and K5's bf16
# instances run the pair forms, both lanes (a pair add is HFMA2 a x 1 + b
# and a pair product HFMA2 a x b + (-0) where ptxas picks those), and need
# 0 mismatches there
BF16_STEPS = "lerf_torch/tools/bf16_steps_exhaustive.cu"
BF16_STEP_NAMES = ("hadd_rn", "hsub_rn", "hmul_rn", "hadd2_rn.lo",
                   "hadd2_rn.hi", "hsub2_rn.lo", "hsub2_rn.hi",
                   "hmul2_rn.lo", "hmul2_rn.hi", "hfma2(a,1,b).lo",
                   "hfma2(a,1,b).hi", "hfma2(a,b,-0).lo", "hfma2(a,b,-0).hi")
BF16_KERNEL_STEPS = BF16_STEP_NAMES[3:]
# the bf16 IMDN crop, card (cuDNN's bf16 convs) against the CPU: the
# CPU tests' gates, lerf_tpu's own bf16 "base" against its bf16 "s2d"
# (tests/test_torch_imdn_bf16.py): (max abs, share differing) of the
# feature and the hyper maps, and (max levels, share differing) of the
# uint8 frames, Gaussian and linear
# the design of K1's and K5's bf16 instances before their redesign, which
# the kernels line names beside each row; this script does not time it:
# the probe does, against the kernel (its times in PERF.md section 6)
BF16_PARENT = ("the earlier design, each bf16 step a float operation "
               "rounded to bf16; timed by lerf_torch/tools/"
               "probe_lut_kernels.py {} against that source, PERF.md "
               "section 6")
IMDN_BF16_FEAT_TOL = (2.0, 0.08)
IMDN_BF16_HYPER_TOL = (3 / 256, 0.38)
IMDN_BF16_U8_TOL = (33, 0.59)


def warp_matrix(seed=0):
    """The main path's homography: ``bench_lut_warp``'s ×4 zoom composed
    with the projective jitter of bench.py's dynamic-warp bench,
    ``I + randn(3, 3) · [[.05, .05, 4], [.05, .05, 4], [1e-4, 1e-4, 0]]``.
    Seed 0 maps output (0, 0) to row 3.95, column -3.67, and the top-right
    corner to row -60: the row axis gets ``pad0 = 0`` and still clips
    interior windows at row -1."""
    rng = np.random.RandomState(seed)
    jitter = np.eye(3) + rng.randn(3, 3) * np.array(
        [[.05, .05, 4.0], [.05, .05, 4.0], [1e-4, 1e-4, 0.0]])
    return np.diag([SCALE, SCALE, 1.0]) @ jitter


# name → (homography, output size) for K5 against its twin
WARP_CASES = {
    "main": (warp_matrix(), WARP_OUT),
    "zoom2.5": (np.diag([2.5, 2.5, 1.0]), (900, 1600)),
    # output (0, 0) maps to row -2.7, column -3.3 and the far corner past
    # the image: pad0 = 1 on both axes, distances of 2 on the far side
    "pad1": (np.array([[3.6, 0.1, 12.0], [0.05, 3.7, 10.0],
                       [1e-5, 2e-5, 1.0]]), WARP_OUT),
    # every block's footprint exceeds the shared-memory tile: the direct path
    "minify16": (np.diag([1 / 16, 1 / 16, 1.0]), (22, 40)),
}


CARD = None           # card_line(), set by main and put beside every time


def emit(obj):
    print(json.dumps(obj), flush=True)


def emit_timed(obj):
    """A row that holds times, with the card they were taken on."""
    emit({**obj, "card": CARD})


def ptxas_rows(log):
    """Registers, static shared memory and spills of each kernel from
    nvcc's ``-Xptxas -v`` output."""
    import re
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"phase": "ptxas", "function": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack_frame"], cur["spill_stores"], cur["spill_loads"] = \
                map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
    return rows


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def bench_bank(seed=0, stages=2, out_c=3):
    """The random bank of bench.py: shipped LeRF-G shapes (``out_c`` 3), or
    with ``out_c=1`` LeRF-L's (stage 2 gives α alone), seeded."""
    from lerf_torch.lut.io import LUTBank

    rng = np.random.RandomState(seed)
    feature = [{m: rng.randint(-127, 128, (L4, 1)).astype(np.int8)
                for m in MODES} for _ in range(stages - 1)]
    s2 = {f"{m}r{r}": rng.randint(-127, 128, (L4, out_c)).astype(np.int8)
          for m in MODES for r in (0, 1)}
    return LUTBank(stage1=feature[-1], stage2=s2, out_c=out_c,
                   inter=feature[:-1])


def check_ties(got_u8, want_u8, want_f32, what):
    """Count uint8 mismatches; each must be one step at a .5 tie of the
    plain float32 value."""
    mism = got_u8 != want_u8
    n = int(mism.sum())
    if n:
        step = np.abs(got_u8[mism].astype(int) - want_u8[mism].astype(int))
        v = want_f32[mism]
        tie = np.abs(v - np.floor(v) - 0.5)
        if step.max() > 1 or tie.max() > TIE_TOL:
            raise AssertionError(
                f"{what}: {n} uint8 mismatches, not all at .5 ties "
                f"(max step {step.max()}, max tie distance {tie.max()})")
    return n


def event_ms(fn, iters, warmup=3):
    """Mean device ms per call over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=50):
    """Device ms of one call of ``fn``, captured once in a CUDA graph and
    replayed back to back between two events: no host launch cost between
    the launches, so a kernel shorter than its wrapper's Python reads its
    own time (events around the wrapper read the host's rate, and the
    profiler drops rows in some windows)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return event_ms(graph.replay, iters)


def frame_ms(fn, frames=25, warmup=3):
    """Median device ms of one call, each call timed by its own events."""
    import torch
    times = []
    for i in range(warmup + frames):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_frames(call, frames=10, **label):
    """Where a whole call's time goes (``upscale`` or ``warp`` of one
    frame): torch.profiler device time per frame by kernel / copy, and the
    device's busy share of the host wall clock (one stream, so device
    activities do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(frames):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / frames
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / frames)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    return {"phase": "profile", **label, "frames": frames, "wall_ms": wall_ms,
            "device_busy_ms": busy, "busy_share": busy / wall_ms,
            "device_ms_by_name": [[k[:60], ms] for k, ms in rows[:10]]}


def device_rows(fn, frames=5, attempts=6):
    """torch.profiler's device activities of ``frames`` calls of ``fn``:
    [(name, calls a frame, device ms a frame)].  In some windows the
    profiler records no device activity at all (three such windows in a
    row have been seen on the H100); such a window is profiled again, up
    to ``attempts`` times, after a short pause."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(frames):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.count / frames,
                 e.self_device_time_total / 1e3 / frames)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        if rows:
            return rows
        time.sleep(0.2)
    return rows


def kernel_device_ms(fn, key, frames=20):
    """Device ms of one launch of the kernel whose name holds ``key`` (one
    a call of ``fn``), by torch.profiler: the kernel alone, whatever the
    host's launch overhead (CUDA events around back-to-back calls read the
    host's rate once a call's Python costs more than its kernel).  The
    mean over the launches the profiler recorded: in some windows it drops
    rows, so a sum over ``frames`` would read low.  Returns the row's
    fields: ``profiler_ms``, and ``profiler_launches`` (recorded) beside
    ``frames`` (made) with ``profiler_complete`` false when rows were
    dropped."""
    rows = [(n * frames, ms * frames) for name, n, ms
            in device_rows(fn, frames) if key in name]
    launches = round(sum(n for n, _ in rows))
    return {"profiler_ms": (sum(ms for _, ms in rows) / launches
                            if launches else 0.0),
            "profiler_launches": launches, "profiler_frames": frames,
            "profiler_complete": launches >= frames}


def device_part_only(fn, allowed, what):
    """torch.profiler's device rows of ``fn``: raise if a kernel is not one
    of ``allowed`` (names held in the kernel's symbol; copies allowed) or
    none of them shows.  (The launch counts prove each kernel ran; the
    profiler drops rows in some windows.)  Returns the rows."""
    rows = device_rows(fn)
    stray = [name for name, _, _ in rows
             if not (any(k in name for k in allowed)
                     or name.startswith(("Memcpy", "Memset")))]
    if stray or not any(k in n for k in allowed for n, _, _ in rows):
        raise AssertionError(f"{what}: kernels other than {allowed}: "
                             f"{stray}, or none of them")
    return rows


def host_call_ms(call, frames, warmup=2):
    """Median host ms of whole calls (copies and host work included)."""
    times = []
    for i in range(warmup + frames):
        t = time.perf_counter()
        call()
        if i >= warmup:
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def k3_bound(nbytes, macs):
    """The larger of bytes and operations, the operations on the faster of
    K3's two routes (float32 on the CUDA cores, or 3xTF32 on the tensor
    cores), with its name and all three times."""
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "f32_operations": 2 * macs / NON_TENSOR_OPS_PER_S * 1e3,
             "tf32x3_operations": TF32_PRODUCTS_PER_F32 * 2 * macs
             / TENSOR_TF32_OPS_PER_S * 1e3}
    ops = min(parts["f32_operations"], parts["tf32x3_operations"])
    if parts["bytes"] >= ops:
        return parts["bytes"], "bytes", parts
    return ops, "operations", parts


def bound(nbytes, ops, bf16_ops=0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / NON_TENSOR_OPS_PER_S
             + bf16_ops / BF16_NON_TENSOR_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(geom, c, linear=False, floats=False, value_bytes=4):
    """(bytes, float32 operations, bf16 operations) of one K1 call in uint8
    mode: the int32 feature and codes (3 a pixel, 1 in the linear mode;
    ``floats``: float32 feature and maps, as many bytes; ``value_bytes`` 2:
    bf16 ones, the bf16 instance) read once, the uint8 output written
    once, the device geometry (rows, distances and, linear, masks) read
    once; the decode once a source pixel, the weights and sums once an
    output and neighbour, the epilogue once an output.  The bf16
    operations are those of the bf16 instance (``K1_BF16_OPS_PER_NEIGHBOUR``
    ...), else 0."""
    (h, w), (oh, ow), s = geom.in_sz, geom.out_sz, geom.support
    codes = 1 if linear else 3
    nbytes = (c * h * w * value_bytes * (1 + codes) + c * oh * ow
              + (oh + ow) * s * (9 if linear else 8))
    per = (LIN_OPS_PER_NEIGHBOUR if linear else K1_OPS_PER_NEIGHBOUR) \
        + (1 if geom.antialias else 0)
    src = ((LIN_FLOAT_OPS_PER_SOURCE if linear else K1_FLOAT_OPS_PER_SOURCE)
           if floats else
           (LIN_OPS_PER_SOURCE if linear else K1_OPS_PER_SOURCE))
    ops = (c * h * w * src
           + c * oh * ow * (s * s * per + K1_OPS_PER_OUTPUT_U8))
    if value_bytes != 2:
        return nbytes, ops, 0
    per16 = LIN_BF16_OPS_PER_NEIGHBOUR if linear else \
        K1_BF16_OPS_PER_NEIGHBOUR + (1 if geom.antialias else 0)
    bf16 = c * h * w * src + c * oh * ow * (s * s * per16 + (not linear))
    return nbytes, ops - bf16, bf16


def k2_work(c, h, w, oc, n_tables, n_members):
    """(bytes, operations) of one K2 call: the image and the int8 [K, L⁴,
    oC] tables read once (the padded and cell-row copies K2 reads are the
    implementation's cost, not the function's), the int32 stage output
    written once."""
    nbytes = c * h * w * 4 + n_tables * L4 * oc + c * h * w * oc * 4
    return nbytes, c * h * w * n_members * oc * K2_OPS_PER_MEMBER_CHANNEL


def net_params(seed=0, out_c=3, nf=NF):
    """Micro-net params at the reference width (or ``nf``), from numpy:
    Kaiming-normal weights and small non-zero biases, on the CPU; stage 2
    with ``out_c`` outputs (1 for LeRF-L)."""
    from lerf_torch.convert import lerf_nets_from_arrays

    rng = np.random.RandomState(seed)

    def head(oc):
        fans = [4] + [k * nf for k in range(1, 5)] + [5 * nf]
        p = {}
        for k, (fan_in, out) in enumerate(zip(fans, [nf] * 5 + [oc]), 1):
            p[f"w{k}"] = (rng.randn(fan_in, out) * np.sqrt(2.0 / fan_in)) \
                .astype(np.float32)
            p[f"b{k}"] = (rng.randn(out) * 0.1).astype(np.float32)
        return p

    return lerf_nets_from_arrays(
        {"s1": {f"s1_{m}": head(1) for m in MODES},
         "s2": {f"{m}r{r}": head(out_c) for m in MODES for r in (0, 1)}})


def chain_macs(oc, nf=NF):
    """Multiply-adds of one SRUnit member at one pixel."""
    return 4 * nf + nf * (nf + 2 * nf + 3 * nf + 4 * nf) + 5 * nf * oc


def k3_work(n, oc, n_members, nf=NF, weight_bytes=4):
    """(bytes, multiply-adds) of one K3 call over ``n`` pixels: the float32
    image and the stacked member weights (``weight_bytes`` a weight: 2 for
    bf16; float32 biases) read once, the float32 [n, oC] sums written
    once."""
    weights = n_members * (chain_macs(oc, nf) * weight_bytes
                           + (5 * nf + oc) * 4)
    nbytes = n * 4 + weights + n * oc * 4
    return nbytes, chain_macs(oc, nf) * n_members * n


def k3_bf16_bound(nbytes, macs):
    """K3 bf16's bound: the larger of bytes and one bf16 tensor-core pass,
    with its name and both times."""
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "bf16_operations": 2 * macs / TENSOR_BF16_OPS_PER_S * 1e3}
    by = max(parts, key=parts.get)
    return parts[by], ("bytes" if by == "bytes" else "operations"), parts


def k4_work(n, oc, n_members, nf=NF):
    """(bytes, int8 operations, float32 operations) of one K4 call: int32
    codes, int8 weights and float32 scales / biases read once, the float32
    sums written once."""
    layer_outs = 5 * nf + oc
    weights = n_members * (chain_macs(oc, nf) + 2 * 4 * layer_outs)
    nbytes = n * 4 + weights + n * oc * 4
    f32 = n * n_members * (5 * nf * K4_F32_OPS_PER_HIDDEN
                           + oc * K4_F32_OPS_PER_HEAD)
    return nbytes, 2 * chain_macs(oc, nf) * n_members * n, f32


def k4_bound(nbytes, int8_ops, f32_ops):
    """The largest of the three times, with its name and all three."""
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "int8_operations": int8_ops / TENSOR_INT8_OPS_PER_S * 1e3,
             "f32_operations": f32_ops / NON_TENSOR_OPS_PER_S * 1e3}
    by = max(parts, key=parts.get)
    return parts[by], ("bytes" if by == "bytes" else "operations"), parts


def level_diff(got, want, tol, what):
    """Max |difference| and share of differing entries of two level
    tensors; raise unless within ``tol`` = (max, share)."""
    import torch
    d = (got.double() - want.double()).abs()
    err, share = float(d.max()), float((d > 0).double().mean())
    if not bool(torch.isfinite(got).all()) or err > tol[0] \
            or share >= tol[1]:
        raise AssertionError(f"{what}: max {err}, share {share} against "
                             f"the tolerance {tol}")
    return err, share


def net_kernel_phases(dev, params, qparams, rng):
    """Phase 6: K3 and K4 against their plain twins at the stage shapes,
    then each kernel's and twin's time beside its bound.  Returns the
    per-kernel summaries (errors, per-frame ms, work) for the kernels
    line."""
    import torch
    from lerf_torch.models import srnet
    from lerf_torch.ops.kernels import srnet_ensemble as k3
    from lerf_torch.ops.kernels import srnet_ensemble_int8 as k4

    members = srnet.stage_members(MODES)
    m = len(members)
    codes = torch.from_numpy(rng.randint(0, 256, (3, LR_H, LR_W))
                             .astype(np.int32)).to(dev)
    x = codes.to(torch.float32) / 255.0      # a deploy stage input: k/255
    n = codes.numel()
    out = {"srnet_ensemble": {"err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                              "bytes": 0, "macs": 0},
           "srnet_ensemble_int8": {"err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                   "bytes": 0, "int8_ops": 0, "f32_ops": 0}}
    for stage, oc in (("stage1", 1), ("stage2", 3)):
        heads = (srnet.stage1_heads(params, 0, MODES) if oc == 1
                 else srnet.stage2_heads(params, MODES))
        qheads = (srnet.stage1_heads(qparams, 0, MODES) if oc == 1
                  else srnet.stage2_heads(qparams, MODES))
        sh = k3.StackedHeads.create(heads, dev)
        qh = k4.QuantHeads.create(qheads, dev)

        def k3_fn():
            return k3.ensemble_sum(x, sh, members, half=127)

        def k3_plain():
            return k3.ensemble_sum_plain(x, sh, members, half=127)

        def k4_fn():
            return k4.ensemble_sum_int8(codes, qh, members, half=127)

        def k4_plain():
            return k4.ensemble_sum_int8_plain(codes, qh, members, half=127)

        for name, kern, plain, tol in (
                ("srnet_ensemble", k3_fn, k3_plain, K3_TOL),
                ("srnet_ensemble_int8", k4_fn, k4_plain, K4_TOL)):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if got.shape != (3, LR_H, LR_W, oc) or got.shape != want.shape:
                raise AssertionError(f"{name} {stage}: shape {got.shape}")
            err, share = level_diff(got, want, tol, f"{name} {stage}")
            del got, want
            ms = event_ms(kern, iters=10)
            plain_ms = event_ms(plain, iters=2, warmup=1)
            row = {"kernel": name, "stage": stage, "shape": [3, LR_H, LR_W],
                   "oc": oc, "nf": NF, "members": m, "max_abs_err": err,
                   "share_differing": share, "tolerance": list(tol),
                   "ms": ms, "launches_per_frame": 1, "plain_ms": plain_ms}
            acc = out[name]
            if name == "srnet_ensemble":
                nbytes, macs = k3_work(n, oc, m)
                row["bound_ms"], row["bound_by"], row["bound_parts_ms"] = \
                    k3_bound(nbytes, macs)
                row.update(bytes=nbytes, macs=macs)
                acc["macs"] += macs
            else:
                nbytes, i8, f32 = k4_work(n, oc, m)
                row["bound_ms"], row["bound_by"], row["bound_parts_ms"] = \
                    k4_bound(nbytes, i8, f32)
                row.update(bytes=nbytes, int8_ops=i8, f32_ops=f32)
                acc["int8_ops"] += i8
                acc["f32_ops"] += f32
            acc["bytes"] += nbytes
            acc["err"] = max(acc["err"], err)
            acc["ms"] += ms
            acc["plain_ms"] += plain_ms
            row["share_of_bound"] = row["bound_ms"] / ms
            emit_timed(row)
    return out


def net_form_phases(dev, params, frame, backend, label=None):
    """Phases 7 and 8 for one backend: the main path on the card with the
    launch counts, the crop against the CPU path, then timing.  Returns
    the main path's launch counts, the crop's differing shares of feat
    and hyper codes, and the device ms.  ``label`` names the run in the
    rows (the backend by default)."""
    label = label or backend
    import torch
    from lerf_torch.ops.geometry import ResizeGeometry
    from lerf_torch.ops.resample import steering_resize_codes_plain
    from lerf_torch.pipeline import NetPredictor, _quantize_device

    pred = NetPredictor.from_srnets(params, backend=backend)
    if pred.device.type != "cuda":
        raise AssertionError(f"default device is {pred.device}")
    (out, feat, hyper), launches = counted_run(
        lambda: pred.upscale(frame, SCALE, SCALE, return_aux=True),
        {"steering_resize": 1, **net_stage_launches(params, backend)},
        f"net form ({label})")
    oh, ow = int(LR_H * SCALE), int(LR_W * SCALE)
    if (out.shape != (oh, ow, 3) or out.dtype != np.uint8
            or feat.shape != (3, LR_H, LR_W)
            or hyper.shape != (3, LR_H, LR_W, 3)
            or not (np.isfinite(feat).all() and np.isfinite(hyper).all())
            or feat.min() < 0 or feat.max() > 255
            or hyper.min() < 0 or hyper.max() > 1):
        raise AssertionError(f"net form ({label}): output {out.shape} "
                             f"{out.dtype}, feat {feat.shape}, hyper "
                             f"{hyper.shape} out of shape or range")

    crop = np.ascontiguousarray(frame[:CROP_H, :CROP_W])
    got = pred.upscale(crop, SCALE, SCALE, return_aux=True)
    t_cpu = time.perf_counter()
    cpu = NetPredictor.from_srnets(params, backend=backend, device="cpu")
    ref = cpu.upscale(crop, SCALE, SCALE, return_aux=True)
    cpu_s = time.perf_counter() - t_cpu
    feat_err, feat_share = level_diff(
        torch.from_numpy(got[1]), torch.from_numpy(ref[1]), NET_STAGE_TOL,
        f"net form ({label}) feat")
    codes = np.round(got[2] * 255).astype(np.int32)
    hyper_err, hyper_share = level_diff(
        torch.from_numpy(codes), torch.from_numpy(np.round(ref[2] * 255)),
        NET_STAGE_TOL, f"net form ({label}) hyper codes")
    geom = ResizeGeometry.create((CROP_H, CROP_W), scale_factors=[SCALE] * 2)
    f32 = steering_resize_codes_plain(
        torch.from_numpy(got[1].astype(np.int32)), torch.from_numpy(codes), geom)
    n_tie = check_ties(
        got[0], _quantize_device(f32, 255).numpy().transpose(1, 2, 0),
        f32.numpy().transpose(1, 2, 0), f"net form ({label}) crop")
    emit({"phase": "net_end_to_end", "backend": label, "nf": NF,
          "in": [LR_H, LR_W], "out": [oh, ow], "scale": SCALE,
          "launches": launches, "crop": [CROP_H, CROP_W],
          "feat_max_diff": feat_err, "feat_share_differing": feat_share,
          "hyper_max_diff": hyper_err, "hyper_share_differing": hyper_share,
          "tolerance": list(NET_STAGE_TOL), "u8_mismatch_at_ties": n_tie,
          "cpu_reference_s": cpu_s})

    mp = oh * ow / 1e6
    upscale_ms = host_call_ms(lambda: pred.upscale(frame, SCALE, SCALE), 10)
    x = torch.from_numpy(np.ascontiguousarray(frame.transpose(2, 0, 1))
                      .astype(np.float32) / 255).to(dev)
    device_ms = frame_ms(lambda: pred.run_device(x, (SCALE, SCALE)),
                         frames=10, warmup=2)
    emit_timed({"phase": "net_timing", "backend": label, "frames": 10,
          "upscale_ms": upscale_ms, "upscale_mps": mp / upscale_ms * 1e3,
          "device_ms": device_ms, "device_mps": mp / device_ms * 1e3})
    emit_timed(profile_frames(lambda: pred.upscale(frame, SCALE, SCALE),
                              frames=5, form="net", backend=label))
    return launches, {"feat_share_differing": feat_share,
                      "hyper_share_differing": hyper_share}, device_ms


def k5_work(in_sz, out_sz, c, linear=False, support=2, mask=False,
            frames=1, floats=False, value_bytes=4):
    """(bytes, float32 operations, float64 operations, bf16 operations) of one
    K5 call in uint8 mode: the int32 feature and codes (3 a pixel, 1
    linear) and the 3×3 float64 inverse read once, the uint8 output written
    once; the decode once a source pixel, the weights and sums once an
    output, channel and neighbour (support²), the epilogue once an output
    and channel; the geometry once an output: the grid's three row-term
    adds and two divisions, per axis the clip (2), (g - S/2) - eps (2),
    ceil and + pad, and per distance its subtraction and cast (2, with the
    linear branch tests 4); per output row and column the grid's products
    and the column's adds.  ``mask``: the validity mask's byte and
    ``K5_F64_MASK_OPS`` an output; ``frames``: a batch of that many;
    ``floats``: float32 feature and maps (as many bytes, the float decode
    of ``k1_work``; ``value_bytes`` 2: bf16 ones, the bf16 instance, its
    bf16 operations split off as ``k1_work`` does, the sums float32 at
    supports other than 2; else 0 of them)."""
    (h, w), (oh, ow) = in_sz, out_sz
    codes = 1 if linear else 3
    nbytes = c * h * w * value_bytes * (1 + codes) + 9 * 8 + c * oh * ow
    per = LIN_OPS_PER_NEIGHBOUR if linear else K5_OPS_PER_NEIGHBOUR
    src = ((LIN_FLOAT_OPS_PER_SOURCE if linear else K1_FLOAT_OPS_PER_SOURCE)
           if floats else
           (LIN_OPS_PER_SOURCE if linear else K1_OPS_PER_SOURCE))
    ops = (c * h * w * src + c * oh * ow
           * (support * support * per + K5_OPS_PER_OUTPUT_U8))
    per_distance = 2 + (K5_F64_BRANCH_OPS if linear else 0)
    f64 = (oh * ow * (5 + 2 * (6 + support * per_distance))
           + oh * K5_F64_OPS_PER_ROW + ow * K5_F64_OPS_PER_COLUMN)
    if mask:
        nbytes += oh * ow
        f64 += oh * ow * K5_F64_MASK_OPS
    bf16 = 0
    if value_bytes == 2:
        per16 = (LIN_BF16_OPS_PER_NEIGHBOUR if linear else
                 K1_BF16_OPS_PER_NEIGHBOUR if support == 2 else
                 K5_BF16_OPS_PER_NEIGHBOUR_GENERIC)
        bf16 = c * h * w * src + c * oh * ow * (support * support * per16
                                                + (not linear))
    return (nbytes * frames, (ops - bf16) * frames, f64 * frames,
            bf16 * frames)


def k5_bound(nbytes, ops, f64, bf16_ops=0):
    """The largest of bytes, float32 and bf16 operations (one time: they
    share the FMA pipes) and float64 operations, with its name and all
    the times."""
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "f32_operations": ops / NON_TENSOR_OPS_PER_S * 1e3,
             "f64_operations": f64 / F64_OPS_PER_S * 1e3}
    if bf16_ops:
        parts["bf16_operations"] = bf16_ops / BF16_NON_TENSOR_OPS_PER_S * 1e3
    times = {"bytes": parts["bytes"],
             "f64_operations": parts["f64_operations"],
             "operations": parts["f32_operations"]
             + parts.get("bf16_operations", 0.0)}
    by = max(times, key=times.get)
    return times[by], ("bytes" if by == "bytes" else "operations"), parts


def net_stage_launches(params, backend):
    """The launches of a net form's two SR stages: K4's for
    ``pallas_int8``, else K3's, and for bf16 heads its bf16 kernel's."""
    import torch
    if backend == "pallas_int8":
        return {"srnet_ensemble_int8": 2}
    head = next(iter(next(iter(params.values())).values()))
    if head["w1"].dtype == torch.bfloat16:
        return {"srnet_ensemble": 2, "srnet_ensemble_bf16": 2}
    return {"srnet_ensemble": 2}


class _Bf16Count:
    """An instance's own count (``bf16_launches`` of K3's, K1's or K5's
    module, or ``attr``: K5's ``rings_launches``) as a module's
    ``launches``."""

    def __init__(self, k3, attr="bf16_launches"):
        self.k3, self.attr = k3, attr

    @property
    def launches(self):
        return getattr(self.k3, self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self.k3, self.attr, n)


def kernel_modules():
    """Every kernel wrapper module by its kernel's name (``srnet_ensemble``
    counts K3's launches of either type, ``srnet_ensemble_bf16`` those of
    its bf16 kernel; so K1's and K5's bf16 instances, and
    ``steering_warp_rings`` K5's rings instance; ``warp_rings_geometry``
    is the kernel that writes a homography's rings on the card)."""
    from lerf_torch.ops.kernels import lut_stage as k2
    from lerf_torch.ops.kernels import resize as k1
    from lerf_torch.ops.kernels import resize_bwd as k6
    from lerf_torch.ops.kernels import srnet_ensemble as k3
    from lerf_torch.ops.kernels import srnet_ensemble_int8 as k4
    from lerf_torch.ops.kernels import warp as k5
    return {"steering_resize": k1, "lut_stage": k2, "srnet_ensemble": k3,
            "srnet_ensemble_int8": k4, "steering_warp": k5,
            "steering_resize_bwd": k6,
            "srnet_ensemble_bf16": _Bf16Count(k3),
            "steering_resize_bf16": _Bf16Count(k1),
            "steering_warp_bf16": _Bf16Count(k5),
            "steering_warp_rings": _Bf16Count(k5, "rings_launches"),
            "warp_rings_geometry": _Bf16Count(k5, "rings_geometry_launches")}


def counted_run(call, want, what):
    """Run ``call`` with every launch count at 0 just before it; read the
    counts just after and raise unless they equal ``want`` (names left
    out must stay 0).  Returns the call's result and the counts."""
    import torch
    mods = kernel_modules()
    for mod in mods.values():
        mod.launches = 0
    result = call()
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in mods.items()}
    expect = {name: want.get(name, 0) for name in launches}
    if launches != expect:
        raise AssertionError(f"{what}: launches {launches}, want {expect}")
    return result, launches


def warp_kernel_phase(dev, rng):
    """Phase 9: K5 and the geometry it derives against their plain twins
    on the card at the stage shapes, for each of ``WARP_CASES``.  Returns
    K5's largest error."""
    import torch
    from lerf_torch.ops.geometry import WarpGeometry
    from lerf_torch.ops.kernels import warp as k5
    from lerf_torch.ops.resample import (quantize_device,
                                         steering_warp_codes_plain)

    shape = (3, LR_H, LR_W)
    feat = torch.from_numpy(rng.randint(0, 256, shape).astype(np.int32)).to(dev)
    codes = torch.from_numpy(
        rng.randint(0, 256, shape + (3,)).astype(np.int32)).to(dev)
    worst = 0.0
    for name, (matrix, out_sz) in WARP_CASES.items():
        t = time.perf_counter()
        params = k5.WarpParams.create((LR_H, LR_W), matrix, out_sz)
        params_s = time.perf_counter() - t
        geom = WarpGeometry.create((LR_H, LR_W), matrix, out_sz)
        host = k5.WarpOperands.create(geom, "cpu")
        card = k5.warp_geometry(params, dev)
        torch.cuda.synchronize()
        if not (card.pad == host.pad
                and torch.equal(card.corners.cpu(), host.corners)
                and torch.equal(card.dis.cpu(), host.dis)):
            raise AssertionError(f"K5 {name}: the card's geometry differs "
                                 "from the host's operands")
        direct = k5.footprint_entries(host, (LR_H, LR_W), out_sz, 3) \
            > k5.TILE_ENTRIES
        if name == "minify16" and not direct.all():
            raise AssertionError("K5 minify16: some blocks fit the tile; "
                                 "the case must take the direct path")
        got = k5.steering_warp(feat, codes, params)
        got_u8 = k5.steering_warp(feat, codes, params, out_dtype=torch.uint8)
        want = steering_warp_codes_plain(feat, codes, geom)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        n_nan = int(nan.sum())
        if not torch.equal(torch.isnan(got), nan):
            raise AssertionError(
                f"K5 {name}: NaN pattern differs from the twin's "
                f"({int(torch.isnan(got).sum())} against {n_nan})")
        err = float((got[~nan] - want[~nan]).abs().max()) if n_nan < \
            want.numel() else 0.0
        if not err <= K5_ATOL:
            raise AssertionError(f"K5 {name}: max-abs {err} > {K5_ATOL}")
        if got_u8.dtype != torch.uint8 or not torch.equal(
                got_u8, quantize_device(got, 255, nan_to_zero=True)):
            raise AssertionError(f"K5 {name}: the uint8 mode differs from "
                                 "the float mode with NaN → 0 quantized")
        n_tie = check_ties(
            got_u8.cpu().numpy(),
            quantize_device(want, 255, nan_to_zero=True).cpu().numpy(),
            torch.nan_to_num(want, nan=0.0).cpu().numpy(), f"K5 {name}")
        if name == "pad1" and not ((geom.pad_x[0], geom.pad_y[0]) == (1, 1)
                                   and n_nan > 0):
            raise AssertionError(f"K5 pad1: pads {geom.pad_x} {geom.pad_y}, "
                                 f"{n_nan} NaN windows; the case needs "
                                 "pad0 = 1 on both axes and NaN windows")
        worst = max(worst, err)
        emit({"phase": "k5_vs_plain", "matrix": name, "out": list(out_sz),
              "pad_x": list(geom.pad_x), "pad_y": list(geom.pad_y),
              "geometry_bit_equal": True, "direct_block_share":
              float(direct.mean()), "nan_windows": n_nan,
              "max_abs_err": err, "bit_equal": err == 0.0,
              "u8_equal_to_quantized_float": True, "u8_mismatch": n_tie,
              "params_s": params_s})
    return worst


def lut_warp_phases(dev, bank, frame, x):
    """Phase 10: the LUT form's warp on the card against the CPU path, the
    launch counts, the device part's kernels, the timing, and K5 alone.
    Returns K5's row for the kernels line (less its error)."""
    import torch
    from lerf_torch.ops.kernels import warp as k5
    from lerf_torch.ops.resample import (_warp_dis_flat, quantize_device,
                                         steering_warp_codes_plain)
    from lerf_torch.pipeline import LutPredictor

    matrix = WARP_CASES["main"][0]
    pred = LutPredictor(bank)
    t = time.perf_counter()
    pred.warp(frame, matrix, WARP_OUT)        # the key's mask and params
    first_s = time.perf_counter() - t
    (out, mask, feat, hyper), launches = counted_run(
        lambda: pred.warp(frame, matrix, WARP_OUT, return_aux=True),
        {"lut_stage": 2, "steering_warp": 1}, "LUT warp")
    if (out.shape != WARP_OUT + (3,) or out.dtype != np.uint8
            or mask.shape != WARP_OUT or mask.dtype != np.bool_
            or not mask.any()):
        raise AssertionError(f"LUT warp: output {out.shape} {out.dtype}, "
                             f"mask {mask.shape} {mask.dtype}")
    t_cpu = time.perf_counter()
    cpu = LutPredictor(bank, device="cpu")
    want_out, want_mask, want_feat, want_hyper = cpu.warp(
        frame, matrix, WARP_OUT, return_aux=True)
    cpu_s = time.perf_counter() - t_cpu
    if not (np.array_equal(feat, want_feat)
            and np.array_equal(hyper, want_hyper)):
        raise AssertionError("LUT warp: feat/hyper differ from the CPU path")
    if not np.array_equal(mask, want_mask):
        raise AssertionError("LUT warp: the mask differs from the CPU path")
    n_tie = 0
    geom = cpu._warp_cache[next(iter(cpu._warp_cache))][0]
    if not np.array_equal(out, want_out):
        f32 = torch.nan_to_num(steering_warp_codes_plain(
            torch.from_numpy(want_feat), torch.from_numpy(want_hyper), geom),
            nan=0.0).numpy().transpose(1, 2, 0)
        n_tie = check_ties(out, want_out, f32, "LUT warp")
    emit({"phase": "lut_warp_end_to_end", "in": [LR_H, LR_W],
          "out": list(WARP_OUT), "matrix": matrix.tolist(),
          "pad_x": list(geom.pad_x), "pad_y": list(geom.pad_y),
          "feat_hyper_bit_equal": True, "mask_equal": True,
          "mask_share": float(mask.mean()), "u8_mismatch_at_ties": n_tie,
          "launches": launches, "first_call_s": first_s,
          "cpu_reference_s": cpu_s, "cpu_reference": "full frame"})

    mp = WARP_OUT[0] * WARP_OUT[1] / 1e6
    warp_ms = host_call_ms(lambda: pred.warp(frame, matrix, WARP_OUT), 20,
                           warmup=3)
    device_ms = frame_ms(lambda: pred.run_warp_device(x, matrix, WARP_OUT))
    emit_timed({"phase": "lut_warp_timing", "frames": 20, "warp_ms": warp_ms,
                "warp_mps": mp / warp_ms * 1e3, "device_ms": device_ms,
                "device_mps": mp / device_ms * 1e3})
    emit_timed(profile_frames(lambda: pred.warp(frame, matrix, WARP_OUT),
                              form="lut_warp"))
    rows = device_part_only(
        lambda: pred.run_warp_device(x, matrix, WARP_OUT),
        ("steering_warp_kernel", "lut_stage_kernel"), "LUT run_warp_device")
    emit_timed({"phase": "device_part_kernels", "form": "lut_warp",
                "rows": [[k[:60], n, ms] for k, n, ms in rows]})

    # K5 alone, in the main path's uint8 mode, on the card's own stages
    feat_d, hyper_d = pred._stages(x)
    params, _ = pred._warp_cache[next(reversed(pred._warp_cache))]
    if not isinstance(params, k5.WarpParams):
        raise AssertionError("LUT warp on the card caches "
                             f"{type(params).__name__}, not WarpParams")
    geom = params.geometry()                  # the twin's host geometry

    def k5_u8():
        return k5.steering_warp(feat_d, hyper_d, params,
                                out_dtype=torch.uint8)

    ms = event_ms(k5_u8, iters=50)
    prof = kernel_device_ms(k5_u8, "steering_warp_kernel")
    float_ms = event_ms(lambda: k5.steering_warp(feat_d, hyper_d, params),
                        iters=50)
    plain_ms = event_ms(lambda: quantize_device(steering_warp_codes_plain(
        feat_d, hyper_d, geom), 255, nan_to_zero=True), iters=5, warmup=1)
    # the part of the twin's time that copies its host geometry to the card
    plain_copy_ms = event_ms(lambda: (
        torch.from_numpy(geom.lin_idx.reshape(2, 2, -1).astype(np.int64))
        .to(dev), _warp_dis_flat(geom, torch.float32, dev)),
        iters=5, warmup=1)
    nbytes, nops, f64, _ = k5_work((LR_H, LR_W), WARP_OUT, 3)
    b_ms, b_by, parts = k5_bound(nbytes, nops, f64)
    emit_timed({"kernel": "steering_warp", "out_dtype": "uint8", "ms": ms,
                **prof, "float_mode_ms": float_ms,
                "launches_per_frame": 1, "plain_ms": plain_ms,
                "plain_geometry_copy_ms": plain_copy_ms,
                "bound_ms": b_ms, "bound_by": b_by, "bound_parts_ms": parts,
                "bytes": nbytes, "ops": nops, "f64_ops": f64,
                "share_of_bound": b_ms / ms})
    return {"name": "steering_warp", "route": "cuda",
            "source": "lerf_torch/csrc/steering_warp.cu",
            "replaces": "lerf_tpu/ops/resample.py:438",
            "launches": launches["steering_warp"], "ms": ms, **prof,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_parts_ms": parts, "share_of_bound": b_ms / ms,
            "library_ms": None}


def net_warp_phases(dev, params, frame, backend, label=None):
    """Phase 11 for one backend: the net form's warp on the card with the
    launch counts, a crop against the CPU path, then timing.  Returns the
    launch counts and the device ms."""
    label = label or backend
    import torch
    from lerf_torch.ops.geometry import WarpGeometry
    from lerf_torch.ops.resample import (quantize_device,
                                         steering_warp_codes_plain)
    from lerf_torch.pipeline import NetPredictor

    matrix = WARP_CASES["main"][0]
    pred = NetPredictor.from_srnets(params, backend=backend)
    pred.warp(frame, matrix, WARP_OUT)        # the key's geometry, built once
    (out, mask, feat, hyper), launches = counted_run(
        lambda: pred.warp(frame, matrix, WARP_OUT, return_aux=True),
        {"steering_warp": 1, **net_stage_launches(params, backend)},
        f"net warp ({label})")
    if (out.shape != WARP_OUT + (3,) or out.dtype != np.uint8
            or mask.shape != WARP_OUT or feat.shape != (3, LR_H, LR_W)
            or hyper.shape != (3, LR_H, LR_W, 3)
            or feat.min() < 0 or feat.max() > 255
            or hyper.min() < 0 or hyper.max() > 1):
        raise AssertionError(f"net warp ({label}): output {out.shape}, "
                             f"feat {feat.shape}, hyper {hyper.shape} out "
                             "of shape or range")

    crop = np.ascontiguousarray(frame[:CROP_H, :CROP_W])
    crop_out = (int(CROP_H * SCALE), int(CROP_W * SCALE))
    got = pred.warp(crop, matrix, crop_out, return_aux=True)
    t_cpu = time.perf_counter()
    cpu = NetPredictor.from_srnets(params, backend=backend, device="cpu")
    ref = cpu.warp(crop, matrix, crop_out, return_aux=True)
    cpu_s = time.perf_counter() - t_cpu
    if not np.array_equal(got[1], ref[1]):
        raise AssertionError(f"net warp ({label}): the crop's mask differs")
    feat_err, feat_share = level_diff(
        torch.from_numpy(got[2]), torch.from_numpy(ref[2]), NET_STAGE_TOL,
        f"net warp ({label}) feat")
    codes = np.round(got[3] * 255).astype(np.int32)
    hyper_err, hyper_share = level_diff(
        torch.from_numpy(codes), torch.from_numpy(np.round(ref[3] * 255)),
        NET_STAGE_TOL, f"net warp ({label}) hyper codes")
    geom = WarpGeometry.create((CROP_H, CROP_W), matrix, crop_out)
    f32 = steering_warp_codes_plain(
        torch.from_numpy(got[2].astype(np.int32)), torch.from_numpy(codes),
        geom)
    n_tie = check_ties(
        got[0],
        quantize_device(f32, 255, nan_to_zero=True).numpy().transpose(1, 2, 0),
        torch.nan_to_num(f32, nan=0.0).numpy().transpose(1, 2, 0),
        f"net warp ({label}) crop")
    emit({"phase": "net_warp_end_to_end", "backend": label, "nf": NF,
          "in": [LR_H, LR_W], "out": list(WARP_OUT), "launches": launches,
          "crop": [CROP_H, CROP_W], "crop_out": list(crop_out),
          "mask_equal": True, "feat_max_diff": feat_err,
          "feat_share_differing": feat_share, "hyper_max_diff": hyper_err,
          "hyper_share_differing": hyper_share,
          "tolerance": list(NET_STAGE_TOL), "u8_mismatch_at_ties": n_tie,
          "cpu_reference_s": cpu_s})

    mp = WARP_OUT[0] * WARP_OUT[1] / 1e6
    warp_ms = host_call_ms(lambda: pred.warp(frame, matrix, WARP_OUT), 10)
    x = torch.from_numpy(np.ascontiguousarray(frame.transpose(2, 0, 1))
                      .astype(np.float32) / 255).to(dev)
    device_ms = frame_ms(lambda: pred.run_warp_device(x, matrix, WARP_OUT),
                         frames=10, warmup=2)
    emit_timed({"phase": "net_warp_timing", "backend": label,
                "frames": 10, "warp_ms": warp_ms,
                "warp_mps": mp / warp_ms * 1e3, "device_ms": device_ms,
                "device_mps": mp / device_ms * 1e3})
    emit_timed(profile_frames(lambda: pred.warp(frame, matrix, WARP_OUT),
                              frames=5, form="net_warp", backend=label))
    return launches, device_ms


def linear_kernel_phases(dev, rng):
    """Phases 12 and 13: K1's and K5's amplified-linear modes, and K5 at
    supports 3 and 4 in both modes, against their plain twins on the card
    at the stage shapes.  Returns the largest errors and K1's bit-equality
    by scale."""
    import torch
    from lerf_torch.ops.geometry import ResizeGeometry
    from lerf_torch.ops.kernels import resize as k1
    from lerf_torch.ops.kernels import warp as k5
    from lerf_torch.ops.resample import (linear_resize_codes_plain,
                                         linear_warp_codes_plain,
                                         quantize_device,
                                         steering_warp_codes_plain)

    shape = (3, LR_H, LR_W)
    feat = torch.from_numpy(rng.randint(0, 256, shape).astype(np.int32)).to(dev)
    alpha = torch.from_numpy(
        rng.randint(0, 256, shape + (1,)).astype(np.int32)).to(dev)
    codes = torch.from_numpy(
        rng.randint(0, 256, shape + (3,)).astype(np.int32)).to(dev)
    out = {"k1_linear": 0.0, "k5_linear": 0.0, "k5_support": 0.0,
           "k1_linear_bit_equal": {}}
    for scale in (4.0, 2.5, 3.55, 0.5):
        geom = ResizeGeometry.create((LR_H, LR_W), scale_factors=[scale] * 2)
        got = k1.steering_resize(feat, alpha, geom, linear=True)
        got_u8 = k1.steering_resize(feat, alpha, geom, linear=True,
                                    out_dtype=torch.uint8)
        want = linear_resize_codes_plain(feat, alpha, geom)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K1 linear x{scale}: non-finite output")
        err = float((got - want).abs().max())
        if err > K1_ATOL:
            raise AssertionError(f"K1 linear x{scale}: max-abs {err}")
        if not torch.equal(got_u8, quantize_device(got, 255,
                                                   nan_to_zero=True)):
            raise AssertionError(f"K1 linear x{scale}: the uint8 mode "
                                 "differs from the float mode quantized")
        n = check_ties(got_u8.cpu().numpy(),
                       quantize_device(want, 255).cpu().numpy(),
                       want.cpu().numpy(), f"K1 linear x{scale}")
        out["k1_linear"] = max(out["k1_linear"], err)
        out["k1_linear_bit_equal"][str(scale)] = err == 0.0
        emit({"phase": "k1_linear_vs_plain", "scale": scale,
              "out": list(geom.out_sz), "antialias": geom.antialias,
              "support": geom.support,
              "tile": list(k1.ResizeOperands.create(geom, dev,
                                                    linear=True).tile),
              "max_abs_err": err, "bit_equal": err == 0.0,
              "u8_equal_to_quantized_float": True, "u8_mismatch": n})

    # K5: the linear mode at the four matrices, then supports 3 and 4 in
    # both modes at the main matrix and the x2.5 zoom
    cases = [(name, 2, True) for name in WARP_CASES] + [
        (name, s, lin) for name in ("main", "zoom2.5") for s in (3, 4)
        for lin in (False, True)]
    geoms = out["geoms"] = {}      # (matrix, support) → (params, geometry)
    for name, support, linear in cases:
        matrix, out_sz = WARP_CASES[name]
        if (name, support) not in geoms:
            params = k5.WarpParams.create((LR_H, LR_W), matrix, out_sz,
                                          support=support)
            geom = params.geometry()
            host = k5.WarpOperands.create(geom, "cpu")
            card = k5.warp_geometry(params, dev)
            torch.cuda.synchronize()
            if not (card.pad == host.pad
                    and torch.equal(card.corners.cpu(), host.corners)
                    and torch.equal(card.dis.cpu(), host.dis)
                    and torch.equal(card.masks.cpu(), host.masks)):
                raise AssertionError(f"K5 {name} S={support}: the card's "
                                     "geometry differs from the host's")
            geoms[name, support] = (params, geom)
        params, geom = geoms[name, support]
        hyper = alpha if linear else codes
        got = k5.steering_warp(feat, hyper, params, linear=linear)
        got_u8 = k5.steering_warp(feat, hyper, params, linear=linear,
                                  out_dtype=torch.uint8)
        twin = linear_warp_codes_plain if linear \
            else steering_warp_codes_plain
        want = twin(feat, hyper, geom)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        n_nan = int(nan.sum())
        if not torch.equal(torch.isnan(got), nan):
            raise AssertionError(
                f"K5 {name} S={support} linear={linear}: NaN pattern "
                f"{int(torch.isnan(got).sum())} against {n_nan}")
        err = float((got[~nan] - want[~nan]).abs().max()) if n_nan < \
            want.numel() else 0.0
        if not err <= K5_ATOL:
            raise AssertionError(f"K5 {name} S={support} linear={linear}: "
                                 f"max-abs {err}")
        if not torch.equal(got_u8, quantize_device(got, 255,
                                                   nan_to_zero=True)):
            raise AssertionError(f"K5 {name} S={support}: the uint8 mode "
                                 "differs from the float mode quantized")
        n_tie = check_ties(
            got_u8.cpu().numpy(),
            quantize_device(want, 255, nan_to_zero=True).cpu().numpy(),
            torch.nan_to_num(want, nan=0.0).cpu().numpy(),
            f"K5 {name} S={support}")
        key = "k5_linear" if support == 2 else "k5_support"
        out[key] = max(out[key], err)
        emit({"phase": "k5_mode_vs_plain", "matrix": name,
              "support": support, "linear": linear, "out": list(out_sz),
              "pad_x": list(geom.pad_x), "pad_y": list(geom.pad_y),
              "geometry_bit_equal": True, "nan_windows": n_nan,
              "max_abs_err": err, "bit_equal": err == 0.0,
              "u8_equal_to_quantized_float": True, "u8_mismatch": n_tie})
    return out


def lerf_l_lut_phases(dev, bank, frame):
    """Phase 14: the LeRF-L LUT form end to end on the full frame (SR at
    x4 and the warp) against the CPU path, the launches, the device parts'
    kernels, and the timing of the calls and of K1's and K5's linear modes.
    Returns their kernel rows (the ``linear`` entries of the kernels line).
    """
    import torch
    from lerf_torch.ops.geometry import ResizeGeometry, WarpGeometry
    from lerf_torch.ops.kernels import resize as k1
    from lerf_torch.ops.kernels import warp as k5
    from lerf_torch.ops.resample import (linear_resize_codes_plain,
                                         linear_warp_codes_plain,
                                         quantize_device)
    from lerf_torch.pipeline import LutPredictor

    matrix = WARP_CASES["main"][0]
    pred = LutPredictor(bank, linear=True)
    cpu = LutPredictor(bank, linear=True, device="cpu")
    oh, ow = WARP_OUT
    (out, feat, hyper), sr_launches = counted_run(
        lambda: pred.upscale(frame, SCALE, SCALE, return_aux=True),
        {"lut_stage": 2, "steering_resize": 1}, "LeRF-L upscale")
    t_cpu = time.perf_counter()
    want = cpu.upscale(frame, SCALE, SCALE, return_aux=True)
    cpu_sr_s = time.perf_counter() - t_cpu
    if (out.shape != (oh, ow, 3) or hyper.shape != (3, LR_H, LR_W, 1)
            or not (np.array_equal(feat, want[1])
                    and np.array_equal(hyper, want[2]))):
        raise AssertionError("LeRF-L upscale: shape or stages differ from "
                             "the CPU path")
    geom = ResizeGeometry.create((LR_H, LR_W), scale_factors=[SCALE] * 2)
    f32 = linear_resize_codes_plain(torch.from_numpy(want[1]),
                                    torch.from_numpy(want[2]), geom)
    sr_ties = check_ties(out, want[0], f32.numpy().transpose(1, 2, 0),
                         "LeRF-L upscale")

    pred.warp(frame, matrix, WARP_OUT)          # the key's mask and params
    (wout, mask, wfeat, whyper), warp_launches = counted_run(
        lambda: pred.warp(frame, matrix, WARP_OUT, return_aux=True),
        {"lut_stage": 2, "steering_warp": 1}, "LeRF-L warp")
    t_cpu = time.perf_counter()
    wwant = cpu.warp(frame, matrix, WARP_OUT, return_aux=True)
    cpu_warp_s = time.perf_counter() - t_cpu
    if not (np.array_equal(wfeat, wwant[2]) and np.array_equal(whyper,
                                                               wwant[3])
            and np.array_equal(mask, wwant[1])):
        raise AssertionError("LeRF-L warp: stages or mask differ from the "
                             "CPU path")
    wgeom = WarpGeometry.create((LR_H, LR_W), matrix, WARP_OUT)
    wf32 = torch.nan_to_num(linear_warp_codes_plain(
        torch.from_numpy(wwant[2]), torch.from_numpy(wwant[3]), wgeom),
        nan=0.0).numpy().transpose(1, 2, 0)
    warp_ties = check_ties(wout, wwant[0], wf32, "LeRF-L warp")

    x = torch.from_numpy(np.ascontiguousarray(
        frame.transpose(2, 0, 1)).astype(np.int32)).to(dev)
    sr_rows = device_part_only(lambda: pred.run_device(x, (SCALE, SCALE)),
                               ("steering_resize_kernel", "lut_stage_kernel"),
                               "LeRF-L run_device")
    warp_rows = device_part_only(
        lambda: pred.run_warp_device(x, matrix, WARP_OUT),
        ("steering_warp_kernel", "lut_stage_kernel"),
        "LeRF-L run_warp_device")
    emit({"phase": "lerf_l_lut_end_to_end", "in": [LR_H, LR_W],
          "out": [oh, ow], "feat_hyper_bit_equal": True, "mask_equal": True,
          "sr_u8_mismatch_at_ties": sr_ties,
          "warp_u8_mismatch_at_ties": warp_ties,
          "sr_launches": sr_launches, "warp_launches": warp_launches,
          "cpu_reference_s": [cpu_sr_s, cpu_warp_s],
          "sr_device_rows": [[k[:60], n, ms] for k, n, ms in sr_rows],
          "warp_device_rows": [[k[:60], n, ms] for k, n, ms in warp_rows]})

    mp = oh * ow / 1e6
    upscale_ms = host_call_ms(lambda: pred.upscale(frame, SCALE, SCALE), 20)
    warp_ms = host_call_ms(lambda: pred.warp(frame, matrix, WARP_OUT), 20)
    sr_dev = frame_ms(lambda: pred.run_device(x, (SCALE, SCALE)), frames=15)
    warp_dev = frame_ms(lambda: pred.run_warp_device(x, matrix, WARP_OUT),
                        frames=15)
    emit_timed({"phase": "lerf_l_lut_timing", "frames": 20,
                "upscale_ms": upscale_ms, "upscale_mps": mp / upscale_ms * 1e3,
                "upscale_device_ms": sr_dev, "warp_ms": warp_ms,
                "warp_mps": mp / warp_ms * 1e3, "warp_device_ms": warp_dev})

    # K1 and K5 alone in their linear uint8 modes on the card's own stages
    feat_d, hyper_d = pred._stages(x)
    _, ops = pred._resize_fn((LR_H, LR_W), (SCALE, SCALE))
    params = k5.WarpParams.create((LR_H, LR_W), matrix, WARP_OUT)

    def k1_u8():
        return k1.steering_resize(feat_d, hyper_d, geom, operands=ops,
                                  linear=True, out_dtype=torch.uint8)

    def k5_u8():
        return k5.steering_warp(feat_d, hyper_d, params, linear=True,
                                out_dtype=torch.uint8)

    rows = {}
    for name, fn, plain, work, launches in (
            ("steering_resize", k1_u8,
             lambda: quantize_device(linear_resize_codes_plain(
                 feat_d, hyper_d, geom), 255, nan_to_zero=True),
             lambda: bound(*k1_work(geom, 3, linear=True)) + (None,),
             sr_launches["steering_resize"]),
            ("steering_warp", k5_u8,
             lambda: quantize_device(linear_warp_codes_plain(
                 feat_d, hyper_d, wgeom), 255, nan_to_zero=True),
             lambda: k5_bound(*k5_work((LR_H, LR_W), WARP_OUT, 3,
                                       linear=True)),
             warp_launches["steering_warp"])):
        ms = event_ms(fn, iters=50)
        prof = kernel_device_ms(fn, name + "_kernel")
        plain_ms = event_ms(plain, iters=3, warmup=1)
        b_ms, b_by, parts = work()
        row = {"kernel": name, "mode": "linear", "out_dtype": "uint8",
               "ms": ms, **prof,
               "launches": launches, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "share_of_bound": b_ms / ms}
        if parts is not None:
            row["bound_parts_ms"] = parts
        emit_timed(row)
        rows[name] = row
    return rows


def lerf_l_net_phases(dev, params, frame):
    """Phase 15: the LeRF-L micro-net form (nf 64, K3): the full frame's
    SR and warp with their launches, a 96×160 crop against the CPU path
    (phase 7's tolerances), and the warp's frame against the plain warp of
    the card's own stages."""
    import torch
    from lerf_torch.ops.geometry import ResizeGeometry, WarpGeometry
    from lerf_torch.ops.resample import (linear_resize_codes_plain,
                                         linear_warp_codes_plain,
                                         quantize_device)
    from lerf_torch.pipeline import NetPredictor

    matrix = WARP_CASES["main"][0]
    pred = NetPredictor.from_srnets(params, linear=True)
    out, sr_launches = counted_run(
        lambda: pred.upscale(frame, SCALE, SCALE),
        {"srnet_ensemble": 2, "steering_resize": 1}, "LeRF-L net upscale")
    pred.warp(frame, matrix, WARP_OUT)
    (wout, mask, feat, hyper), warp_launches = counted_run(
        lambda: pred.warp(frame, matrix, WARP_OUT, return_aux=True),
        {"srnet_ensemble": 2, "steering_warp": 1}, "LeRF-L net warp")
    if out.shape != WARP_OUT + (3,) or hyper.shape != (3, LR_H, LR_W, 1):
        raise AssertionError(f"LeRF-L net: output {out.shape}, hyper "
                             f"{hyper.shape}")
    codes = np.round(hyper * 255).astype(np.int32)
    f32 = torch.nan_to_num(linear_warp_codes_plain(
        torch.from_numpy(feat.astype(np.int32)).to(dev),
        torch.from_numpy(codes).to(dev),
        WarpGeometry.create((LR_H, LR_W), matrix, WARP_OUT)), nan=0.0)
    warp_ties = check_ties(
        wout, quantize_device(f32, 255).cpu().numpy().transpose(1, 2, 0),
        f32.cpu().numpy().transpose(1, 2, 0), "LeRF-L net warp")

    crop = np.ascontiguousarray(frame[:CROP_H, :CROP_W])
    got = pred.upscale(crop, SCALE, SCALE, return_aux=True)
    t_cpu = time.perf_counter()
    ref = NetPredictor.from_srnets(params, linear=True, device="cpu") \
        .upscale(crop, SCALE, SCALE, return_aux=True)
    cpu_s = time.perf_counter() - t_cpu
    feat_err, feat_share = level_diff(
        torch.from_numpy(got[1]), torch.from_numpy(ref[1]), NET_STAGE_TOL,
        "LeRF-L net feat")
    ccodes = np.round(got[2] * 255).astype(np.int32)
    hyper_err, hyper_share = level_diff(
        torch.from_numpy(ccodes), torch.from_numpy(np.round(ref[2] * 255)),
        NET_STAGE_TOL, "LeRF-L net hyper codes")
    cf32 = linear_resize_codes_plain(
        torch.from_numpy(got[1].astype(np.int32)), torch.from_numpy(ccodes),
        ResizeGeometry.create((CROP_H, CROP_W), scale_factors=[SCALE] * 2))
    crop_ties = check_ties(
        got[0], quantize_device(cf32, 255).numpy().transpose(1, 2, 0),
        cf32.numpy().transpose(1, 2, 0), "LeRF-L net crop")
    emit({"phase": "lerf_l_net_end_to_end", "backend": "auto", "nf": NF,
          "sr_launches": sr_launches, "warp_launches": warp_launches,
          "warp_u8_mismatch_at_ties": warp_ties, "crop": [CROP_H, CROP_W],
          "feat_max_diff": feat_err, "feat_share_differing": feat_share,
          "hyper_max_diff": hyper_err, "hyper_share_differing": hyper_share,
          "tolerance": list(NET_STAGE_TOL), "crop_u8_mismatch_at_ties":
          crop_ties, "cpu_reference_s": cpu_s})
    return {"srnet_ensemble": sr_launches["srnet_ensemble"]}


def k5_support4_phase(dev, bank, frame, x, params, geom):
    """Phase 16: the LUT warp at ``supp_size`` 4 on the full frame (K2
    twice, K5 once), then K5 alone at support 4 on its stages beside its
    twin and its bound.  ``params``, ``geom``: the main matrix's warp at
    support 4 (phase 13's).  Returns K5's row at support 4."""
    import torch
    from lerf_torch.ops.kernels import warp as k5
    from lerf_torch.ops.resample import (quantize_device,
                                         steering_warp_codes_plain)
    from lerf_torch.pipeline import LutPredictor

    matrix = WARP_CASES["main"][0]
    pred = LutPredictor(bank, supp_size=4)
    pred.warp(frame, matrix, WARP_OUT)
    _, launches = counted_run(lambda: pred.warp(frame, matrix, WARP_OUT),
                              {"lut_stage": 2, "steering_warp": 1},
                              "LUT warp at support 4")
    feat, hyper = pred._stages(x)

    def k5_u8():
        return k5.steering_warp(feat, hyper, params, out_dtype=torch.uint8)

    ms = event_ms(k5_u8, iters=30)
    prof = kernel_device_ms(k5_u8, "steering_warp_kernel")
    plain_ms = event_ms(lambda: quantize_device(steering_warp_codes_plain(
        feat, hyper, geom), 255, nan_to_zero=True), iters=2, warmup=1)
    b_ms, b_by, parts = k5_bound(*k5_work((LR_H, LR_W), WARP_OUT, 3,
                                          support=4))
    row = {"kernel": "steering_warp", "support": 4, "out_dtype": "uint8",
           "ms": ms, **prof,
           "launches": launches["steering_warp"], "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bound_parts_ms": parts,
           "share_of_bound": b_ms / ms}
    emit_timed(row)
    return row


def serving_phases(dev, banks, frame):
    """Phase 17: the SR serving forms on the card, LUT form, LeRF-G and
    LeRF-L: ``upscale_dynamic`` at x4, x2.5 (granularity 0 and 64) and x0.5
    (antialiased), ``upscale_bucketed(..., 64)`` at x4 on the 360×640 frame
    and ``upscale_batch`` of 4 frames at x4 — each bit-equal to ``upscale``
    on the card, frame by frame, and each call K2 twice and K1 once, the
    batch too.  Returns the launch counts of the forms' calls."""
    from lerf_torch.pipeline import LutPredictor

    rng = np.random.RandomState(5)
    frames = np.stack([frame] + [rng.randint(0, 256, frame.shape)
                                 .astype(np.uint8) for _ in range(3)])
    want_launches = {"lut_stage": 2, "steering_resize": 1}
    counts = {}
    for form, linear in (("lerf_g", False), ("lerf_l", True)):
        pred = LutPredictor(banks[form], linear=linear)
        static = {s: pred.upscale(frame, s, s) for s in (4.0, 2.5, 0.5)}
        calls = {f"dynamic x{s} g{g}": (s, (lambda s=s, g=g: pred.upscale_dynamic(
            frame, s, s, granularity=g))) for s in (4.0, 2.5) for g in (0, 64)}
        calls["dynamic x0.5 g0"] = (0.5, lambda: pred.upscale_dynamic(
            frame, 0.5, 0.5))
        calls["bucketed x4 g64"] = (4.0, lambda: pred.upscale_bucketed(
            frame, SCALE, SCALE, 64))
        for name, (s, call) in calls.items():
            got, launches = counted_run(call, want_launches,
                                        f"{form} {name}")
            if not np.array_equal(got, static[s]):
                raise AssertionError(f"{form} {name}: not bit-equal to "
                                     "upscale on the card")
            counts[f"{form} {name}"] = launches
        got, launches = counted_run(
            lambda: pred.upscale_batch(frames, SCALE, SCALE), want_launches,
            f"{form} batch of 4")
        for b in range(len(frames)):
            if not np.array_equal(got[b], pred.upscale(frames[b], SCALE,
                                                       SCALE)):
                raise AssertionError(f"{form} batch frame {b}: not "
                                     "bit-equal to upscale on the card")
        counts[f"{form} batch"] = launches
        batch_ms = host_call_ms(
            lambda: pred.upscale_batch(frames, SCALE, SCALE), 5)
        upscale_ms = host_call_ms(lambda: pred.upscale(frame, SCALE, SCALE),
                                  10)
        dynamic_ms = host_call_ms(lambda: pred.upscale_dynamic(
            frame, 2.5, 2.5, granularity=64), 10)
        emit_timed({"phase": "sr_serving", "form": form,
                    "bit_equal_to_upscale": sorted(calls) + ["batch"],
                    "launches": want_launches, "batch": len(frames),
                    "batch_ms_per_frame": batch_ms / len(frames),
                    "upscale_ms": upscale_ms,
                    "dynamic_x2.5_g64_ms": dynamic_ms})
    return counts


def mask_cases():
    """name → (homography, output size) for K5's validity mask: the main
    path's homography at seeds 0..3 (``warp_mask_phase``'s and the batch's
    four frames), the pad-1 matrix and the ×2.5 zoom."""
    cases = {f"warp_matrix({k})": (warp_matrix(k), WARP_OUT)
             for k in range(4)}
    cases["pad1"] = WARP_CASES["pad1"]
    cases["zoom2.5"] = WARP_CASES["zoom2.5"]
    return cases


def warp_mask_phase(dev, rng):
    """Phase 18: K5's validity mask on the card, alone (``warp_mask``) and
    written in K5's own launch (``mask_out``) at supports 2 and 4, and from
    the inverse alone (``nearest_warp_mask_on_device``), each equal to the
    host's float64 mask; the frame K5 writes beside the mask equal to the
    one it writes without it.  Returns the host masks by case."""
    import torch
    from lerf_torch.ops.kernels import warp as k5
    from lerf_torch.ops.resample import nearest_warp_mask_on_device

    shape = (3, LR_H, LR_W)
    feat = torch.from_numpy(rng.randint(0, 256, shape).astype(np.int32)).to(dev)
    codes = torch.from_numpy(
        rng.randint(0, 256, shape + (3,)).astype(np.int32)).to(dev)
    hosts = {}
    for name, (matrix, out_sz) in mask_cases().items():
        t = time.perf_counter()
        host = k5.WarpParams.create((LR_H, LR_W), matrix, out_sz).host_mask(4)
        host_s = time.perf_counter() - t
        hosts[name] = host
        want = torch.from_numpy(host)
        for support in (2, 4):
            params = k5.WarpParams.create((LR_H, LR_W), matrix, out_sz,
                                          support=support)
            alone = k5.warp_mask(params, dev)
            mask = torch.zeros(out_sz, dtype=torch.bool, device=dev)
            got = k5.steering_warp(feat, codes, params, mask_out=mask,
                                   out_dtype=torch.uint8)
            plain = k5.steering_warp(feat, codes, params,
                                     out_dtype=torch.uint8)
            torch.cuda.synchronize()
            if not (torch.equal(alone.cpu(), want)
                    and torch.equal(mask.cpu(), want)):
                raise AssertionError(f"K5 mask {name} S={support}: not equal "
                                     "to the host mask")
            if not torch.equal(got, plain):
                raise AssertionError(f"K5 mask {name} S={support}: the frame "
                                     "changes when the mask is asked for")
        inv = torch.tensor(np.linalg.inv(matrix), device=dev)
        if not torch.equal(nearest_warp_mask_on_device(
                inv, (LR_H, LR_W), out_sz, border=4).cpu(), want):
            raise AssertionError(f"nearest_warp_mask_on_device {name}: not "
                                 "equal to the host mask")
        emit({"phase": "k5_mask_vs_host", "matrix": name, "out": list(out_sz),
              "supports": [2, 4], "mask_equal": True,
              "mask_share": float(host.mean()),
              "frame_unchanged_by_mask": True, "host_mask_s": host_s})
    return hosts


def warp_batch_kernel_phase(dev, rng, hosts):
    """Phase 19: ``steering_warp_batch`` over 4 frames under
    ``warp_matrix(0..3)`` at the stage shapes, Gaussian and linear, uint8
    and float32: one launch, each frame bit-equal to its own K5 call, each
    mask to the host's (``hosts``), and each frame against its plain twin
    with phase 9's tolerance.  Returns the largest error and the frames'
    host geometries (the twins' input, for phase 22)."""
    import torch
    from lerf_torch.ops.kernels import warp as k5
    from lerf_torch.ops.resample import (linear_warp_codes_plain,
                                         quantize_device,
                                         steering_warp_codes_plain)

    n = 4
    shape = (n * 3, LR_H, LR_W)
    feat = torch.from_numpy(rng.randint(0, 256, shape).astype(np.int32)).to(dev)
    hypers = {lin: torch.from_numpy(rng.randint(
        0, 256, shape + (1 if lin else 3,)).astype(np.int32)).to(dev)
        for lin in (False, True)}
    warps = [k5.WarpParams.create((LR_H, LR_W), warp_matrix(k), WARP_OUT)
             for k in range(n)]
    geoms = [w.geometry() for w in warps]
    worst = 0.0
    for linear in (False, True):
        hyper = hypers[linear]
        twin = linear_warp_codes_plain if linear \
            else steering_warp_codes_plain
        wants = [twin(feat[3 * f:3 * f + 3], hyper[3 * f:3 * f + 3],
                      geoms[f]) for f in range(n)]
        for out_dtype in (torch.uint8, torch.float32):
            masks = torch.zeros((n,) + WARP_OUT, dtype=torch.bool, device=dev)
            what = f"K5 batch linear={linear} {out_dtype}"
            got, launches = counted_run(
                lambda: k5.steering_warp_batch(
                    feat, hyper, warps, linear=linear, out_dtype=out_dtype,
                    mask_out=masks), {"steering_warp": 1}, what)
            n_tie = 0
            for f in range(n):
                sl = slice(3 * f, 3 * f + 3)
                one = k5.steering_warp(feat[sl], hyper[sl], warps[f],
                                       linear=linear, out_dtype=out_dtype)
                if not torch.equal(torch.nan_to_num(got[sl], nan=-1.0),
                                   torch.nan_to_num(one, nan=-1.0)):
                    raise AssertionError(f"{what} frame {f}: not bit-equal "
                                         "to its own K5 call")
                if not np.array_equal(masks[f].cpu().numpy(),
                                      hosts[f"warp_matrix({f})"]):
                    raise AssertionError(f"{what} frame {f}: mask differs "
                                         "from the host's")
                want = wants[f]
                if out_dtype == torch.float32:
                    nan = torch.isnan(want)
                    if not torch.equal(torch.isnan(got[sl]), nan):
                        raise AssertionError(f"{what} frame {f}: NaN pattern")
                    err = float((got[sl][~nan] - want[~nan]).abs().max())
                    if not err <= K5_ATOL:
                        raise AssertionError(f"{what} frame {f}: max-abs "
                                             f"{err}")
                    worst = max(worst, err)
                else:
                    n_tie += check_ties(
                        got[sl].cpu().numpy(),
                        quantize_device(want, 255,
                                        nan_to_zero=True).cpu().numpy(),
                        torch.nan_to_num(want, nan=0.0).cpu().numpy(),
                        f"{what} frame {f}")
            emit({"phase": "k5_batch_vs_frames", "frames": n,
                  "linear": linear, "out_dtype": str(out_dtype),
                  "launches": launches, "bit_equal_to_single_frames": True,
                  "masks_equal_to_host": True, "max_abs_err_vs_plain": worst,
                  "u8_mismatch_at_ties": n_tie})
    return worst, geoms


def warp_serving_phase(dev, bank, frame):
    """Phase 20: ``warp_dynamic`` and ``warp_device`` (LUT form, LeRF-G)
    on the card for ``warp_matrix(0..3)``: each bit-equal to ``warp`` on
    the card (frame and mask), each call K2 twice and K5 once; then the
    first call on a homography not seen before, by each form.  Returns the
    launch counts."""
    from lerf_torch.pipeline import LutPredictor

    pred = LutPredictor(bank)
    mats = [warp_matrix(k) for k in range(4)]
    want = [pred.warp(frame, m, WARP_OUT) for m in mats]
    want_launches = {"lut_stage": 2, "steering_warp": 1}
    counts = {}
    for name in ("warp_dynamic", "warp_device"):
        for k, m in enumerate(mats):
            got, launches = counted_run(
                lambda: getattr(pred, name)(frame, m, WARP_OUT),
                want_launches, f"{name} warp_matrix({k})")
            if not (np.array_equal(got[0], want[k][0])
                    and np.array_equal(got[1], want[k][1])):
                raise AssertionError(f"{name} warp_matrix({k}): not "
                                     "bit-equal to warp on the card")
        counts[name] = launches
    first = {}
    for seed, name in ((20, "warp"), (21, "warp_dynamic"),
                       (22, "warp_device")):
        t = time.perf_counter()
        getattr(pred, name)(frame, warp_matrix(seed), WARP_OUT)
        first[name] = time.perf_counter() - t
    emit({"phase": "warp_serving", "forms": ["warp_dynamic", "warp_device"],
          "matrices": 4, "bit_equal_to_warp": True, "launches": want_launches,
          "first_call_s": first})
    return counts


def warp_batch_phase(dev, banks, params, frame):
    """Phase 21: ``warp_batch`` of 4 frames, per-frame matrices
    ``warp_matrix(0..3)`` and one shared matrix, in the LUT form (LeRF-G
    and LeRF-L) and the net form on K4 (``pallas_int8``, nf 64): each
    frame and mask bit-equal to that frame's ``warp`` on the card, each
    call K2 (or K4) twice and K5 once.  Returns the 4 frames and
    matrices."""
    from lerf_torch.pipeline import LutPredictor, NetPredictor

    rng = np.random.RandomState(6)
    frames = np.stack([frame] + [rng.randint(0, 256, frame.shape)
                                 .astype(np.uint8) for _ in range(3)])
    mats = np.stack([warp_matrix(k) for k in range(4)])
    forms = (("lerf_g", LutPredictor(banks["lerf_g"]), "lut_stage"),
             ("lerf_l", LutPredictor(banks["lerf_l"], linear=True),
              "lut_stage"),
             ("net_int8", NetPredictor.from_srnets(params,
                                                   backend="pallas_int8"),
              "srnet_ensemble_int8"))
    for form, pred, stage in forms:
        want_launches = {stage: 2, "steering_warp": 1}
        for label, ms in (("per-frame", mats), ("shared", mats[0])):
            (outs, masks), launches = counted_run(
                lambda: pred.warp_batch(frames, ms, WARP_OUT),
                want_launches, f"{form} warp_batch {label}")
            for b in range(len(frames)):
                out, mask = pred.warp(frames[b], ms[b] if ms.ndim == 3
                                      else ms, WARP_OUT)
                if not (np.array_equal(outs[b], out)
                        and np.array_equal(masks[b], mask)):
                    raise AssertionError(f"{form} warp_batch {label} frame "
                                         f"{b}: not bit-equal to warp")
        emit({"phase": "warp_batch", "form": form, "frames": len(frames),
              "matrices": ["per-frame", "shared"], "bit_equal_to_warp": True,
              "launches": launches})
    return frames, mats


def warp_serving_timing(dev, bank, frame, x, frames, mats, geoms):
    """Phase 22: whole calls (host clock, median) of ``warp``,
    ``warp_dynamic``, ``warp_device`` and ``warp_batch`` (4 frames, per
    frame) in one run, LUT LeRF-G, the main matrix; then K5 alone on the
    stage outputs, without the mask, with it, and batched over 4 frames
    (``warp_matrix(0..3)``), by events (alternating, two rounds) and by
    the profiler, beside their twins and bounds.  Returns the kernels
    line's rows for K5 with the mask and batched."""
    import torch
    from lerf_torch.ops.kernels import warp as k5
    from lerf_torch.ops.resample import (quantize_device,
                                         steering_warp_codes_plain)
    from lerf_torch.pipeline import LutPredictor

    pred = LutPredictor(bank)
    m = mats[0]
    mp = WARP_OUT[0] * WARP_OUT[1] / 1e6
    calls = {"warp": lambda: pred.warp(frame, m, WARP_OUT),
             "warp_dynamic": lambda: pred.warp_dynamic(frame, m, WARP_OUT),
             "warp_device": lambda: pred.warp_device(frame, m, WARP_OUT)}
    row = {"phase": "warp_serving_timing", "frames": 20}
    for name, call in calls.items():
        ms = host_call_ms(call, 20, warmup=3)
        row[f"{name}_ms"], row[f"{name}_mps"] = ms, mp / ms * 1e3
    batch_ms = host_call_ms(lambda: pred.warp_batch(frames, mats, WARP_OUT),
                            10) / len(frames)
    row["warp_batch_ms_per_frame"] = batch_ms
    row["warp_batch_mps"] = mp / batch_ms * 1e3
    emit_timed(row)

    feat, hyper = pred._stages(x)
    n = len(frames)
    warps = [k5.WarpParams.create((LR_H, LR_W), mm, WARP_OUT) for mm in mats]
    mask = torch.zeros(WARP_OUT, dtype=torch.bool, device=dev)
    masks = torch.zeros((n,) + WARP_OUT, dtype=torch.bool, device=dev)
    feat4, hyper4 = feat.repeat(n, 1, 1), hyper.repeat(n, 1, 1, 1)
    fns = {"no_mask": lambda: k5.steering_warp(feat, hyper, warps[0],
                                               out_dtype=torch.uint8),
           "mask": lambda: k5.steering_warp(feat, hyper, warps[0],
                                            out_dtype=torch.uint8,
                                            mask_out=mask),
           "batch4": lambda: k5.steering_warp_batch(
               feat4, hyper4, warps, out_dtype=torch.uint8, mask_out=masks)}
    ms = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            ms[name].append(event_ms(fn, iters=50))
    plain = {
        "mask": event_ms(lambda: (quantize_device(steering_warp_codes_plain(
            feat, hyper, geoms[0]), 255, nan_to_zero=True),
            warps[0].host_mask(4)), iters=2, warmup=1),
        "batch4": event_ms(lambda: [quantize_device(steering_warp_codes_plain(
            feat, hyper, g), 255, nan_to_zero=True) for g in geoms],
            iters=2, warmup=1)}
    rows = {}
    for name, fn in fns.items():
        prof = kernel_device_ms(fn, "steering_warp_kernel")
        frames_n = n if name == "batch4" else 1
        b_ms, b_by, parts = k5_bound(*k5_work(
            (LR_H, LR_W), WARP_OUT, 3, mask=name != "no_mask",
            frames=frames_n))
        mean = statistics.mean(ms[name])
        r = {"kernel": "steering_warp", "variant": name, "frames": frames_n,
             "out_dtype": "uint8", "ms": mean, "ms_rounds": ms[name], **prof,
             "launches": 1, "plain_ms": plain.get(name), "bound_ms": b_ms,
             "bound_by": b_by, "bound_parts_ms": parts,
             "share_of_bound": b_ms / mean}
        emit_timed(r)
        rows[name] = r
    return rows


def float_inputs(rng, shape, oc, dev):
    """A float feature in [0, 254] and hyper maps in [0, 1] on ``dev``, as
    the IMDN towers give them."""
    import torch
    return (torch.from_numpy((rng.rand(*shape) * 254).astype(np.float32))
            .to(dev),
            torch.from_numpy(rng.rand(*shape, oc).astype(np.float32)).to(dev))


def float_twin_resize(feat, hyper, geom, linear):
    """K1's float-mode twin: lerf_tpu's float resize ops."""
    from lerf_torch.ops.resample import (amplified_linear_resize,
                                         steering_gaussian_resize)
    if linear:
        return amplified_linear_resize(feat, hyper[..., 0], geom)
    return steering_gaussian_resize(feat, hyper[..., 0], hyper[..., 1],
                                    hyper[..., 2], geom)


def float_twin_warp(feat, hyper, geom, linear):
    """K5's float-mode twin: lerf_tpu's float-row warps."""
    from lerf_torch.ops.resample import (amplified_linear_warp,
                                         steering_gaussian_warp)
    if linear:
        return amplified_linear_warp(feat, hyper[..., 0], geom)
    return steering_gaussian_warp(feat, hyper[..., 0], hyper[..., 1],
                                  hyper[..., 2], geom)


def held_to_twin(got, got_u8, want, atol, what, nan_to_zero=True):
    """``got`` against its twin ``want``: the NaN pattern equal, finite
    values within ``atol``, the uint8 mode the float mode quantized and
    uint8 mismatches with the twin only at .5 ties.  Returns (max-abs
    error, NaN count, uint8 mismatches)."""
    import torch
    from lerf_torch.ops.resample import quantize_device

    nan = torch.isnan(want)
    n_nan = int(nan.sum())
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"{what}: NaN pattern "
                             f"{int(torch.isnan(got).sum())} against {n_nan}")
    err = float((got[~nan] - want[~nan]).abs().max()) \
        if n_nan < want.numel() else 0.0
    if not err <= atol:
        raise AssertionError(f"{what}: max-abs {err} > {atol}")
    if got_u8.dtype != torch.uint8 or not torch.equal(
            got_u8, quantize_device(got, 255, nan_to_zero=nan_to_zero)):
        raise AssertionError(f"{what}: the uint8 mode differs from the "
                             "float mode quantized")
    n_tie = check_ties(
        got_u8.cpu().numpy(),
        quantize_device(want, 255, nan_to_zero=True).cpu().numpy(),
        torch.nan_to_num(want, nan=0.0).cpu().numpy(), what)
    return err, n_nan, n_tie


def float_kernel_phases(dev, rng):
    """Phase 23: K1's and K5's float modes (float32 feature and hyper maps
    in [0, 1], the IMDN form's inputs) against their twins, lerf_tpu's
    float ops, on the card at the stage shapes: K1 at the phase 2 scales
    in both kernels; K5 at the phase 9 matrices with the validity mask
    (``torch.equal`` to the host's) in both kernels, at support 4 on the
    main matrix, and over a batch of 4 frames under ``warp_matrix(0..3)``
    (each frame bit-equal to its own call and within the tolerance of its
    twin).  Returns the largest errors."""
    import torch
    from lerf_torch.ops.geometry import ResizeGeometry
    from lerf_torch.ops.kernels import resize as k1
    from lerf_torch.ops.kernels import warp as k5

    shape = (3, LR_H, LR_W)
    out = {"k1_float": 0.0, "k5_float": 0.0}
    inputs = {lin: float_inputs(rng, shape, 1 if lin else 3, dev)
              for lin in (False, True)}
    for linear in (False, True):
        feat, hyper = inputs[linear]
        for scale in (4.0, 2.5, 3.55, 0.5):
            geom = ResizeGeometry.create((LR_H, LR_W),
                                         scale_factors=[scale] * 2)
            got = k1.steering_resize(feat, hyper, geom, linear=linear)
            got_u8 = k1.steering_resize(feat, hyper, geom, linear=linear,
                                        out_dtype=torch.uint8)
            want = float_twin_resize(feat, hyper, geom, linear)
            torch.cuda.synchronize()
            err, n_nan, n_tie = held_to_twin(
                got, got_u8, want, K1_ATOL,
                f"K1 float linear={linear} x{scale}", nan_to_zero=linear)
            out["k1_float"] = max(out["k1_float"], err)
            emit({"phase": "k1_float_vs_plain", "scale": scale,
                  "linear": linear, "out": list(geom.out_sz),
                  "antialias": geom.antialias, "support": geom.support,
                  "max_abs_err": err, "bit_equal": err == 0.0,
                  "nan_windows": n_nan, "u8_equal_to_quantized_float": True,
                  "u8_mismatch": n_tie})
    cases = [(name, 2) for name in WARP_CASES] + [("main", 4)]
    for linear in (False, True):
        feat, hyper = inputs[linear]
        for name, support in cases:
            matrix, out_sz = WARP_CASES[name]
            params = k5.WarpParams.create((LR_H, LR_W), matrix, out_sz,
                                          support=support)
            mask = torch.empty(out_sz, dtype=torch.bool, device=dev)
            got = k5.steering_warp(feat, hyper, params, linear=linear,
                                   mask_out=mask)
            got_u8 = k5.steering_warp(feat, hyper, params, linear=linear,
                                      out_dtype=torch.uint8)
            want = float_twin_warp(feat, hyper, params.geometry(), linear)
            torch.cuda.synchronize()
            what = f"K5 float {name} S={support} linear={linear}"
            err, n_nan, n_tie = held_to_twin(got, got_u8, want, K5_ATOL,
                                             what)
            if not np.array_equal(mask.cpu().numpy(), params.host_mask()):
                raise AssertionError(f"{what}: the mask differs from the "
                                     "host's")
            out["k5_float"] = max(out["k5_float"], err)
            emit({"phase": "k5_float_vs_plain", "matrix": name,
                  "support": support, "linear": linear, "out": list(out_sz),
                  "mask_equal": True, "max_abs_err": err,
                  "bit_equal": err == 0.0, "nan_windows": n_nan,
                  "u8_equal_to_quantized_float": True, "u8_mismatch": n_tie})
        warps = [k5.WarpParams.create((LR_H, LR_W), warp_matrix(s), WARP_OUT)
                 for s in range(4)]
        feats = torch.cat([feat, feat.flip(-1), feat.flip(-2), feat * 0.5])
        hypers = torch.cat([hyper, hyper.flip(-2), hyper.flip(-3),
                            1 - hyper])
        masks = torch.empty((4,) + WARP_OUT, dtype=torch.bool, device=dev)
        (got,), launches = counted_run(lambda: (k5.steering_warp_batch(
            feats, hypers, warps, linear=linear, out_dtype=torch.uint8,
            mask_out=masks),), {"steering_warp": 1}, "K5 float batch of 4")
        worst = 0.0
        for f, w in enumerate(warps):
            sl = slice(3 * f, 3 * f + 3)
            one = k5.steering_warp(feats[sl], hypers[sl], w, linear=linear)
            if not torch.equal(got[sl], quantize_u8(one)):
                raise AssertionError(f"K5 float batch frame {f}: not "
                                     "bit-equal to its own call")
            if not np.array_equal(masks[f].cpu().numpy(), w.host_mask()):
                raise AssertionError(f"K5 float batch frame {f}: the mask "
                                     "differs from the host's")
            want = float_twin_warp(feats[sl], hypers[sl], w.geometry(),
                                   linear)
            err, _, _ = held_to_twin(
                one, got[sl], want, K5_ATOL,
                f"K5 float batch frame {f} linear={linear}")
            worst = max(worst, err)
        out["k5_float"] = max(out["k5_float"], worst)
        emit({"phase": "k5_float_batch", "frames": 4, "linear": linear,
              "launches": launches, "bit_equal_to_frames": True,
              "masks_equal": True, "max_abs_err": worst})
    return out


def quantize_u8(x):
    from lerf_torch.ops.resample import quantize_device
    return quantize_device(x, 255, nan_to_zero=True)


def imdn_model():
    """IMDN2 at the reference's width (nf 12, 5 modules a tower), its
    weights drawn from a ``torch.Generator`` seeded 0."""
    import torch
    from lerf_torch.models.imdn import IMDN2, init_imdn
    return init_imdn(IMDN2(nf=IMDN_NF), torch.Generator().manual_seed(0))


def imdn_tower_work(model, h, w):
    """(bytes, multiply-adds, unfused bytes) of both IMDN towers on one
    [3, h, w] frame: the float32 image read once and the feature and
    hyper maps written once; a multiply-add per weight of every conv at
    every pixel (upscale 1, stride 1); and the activations every unfused
    conv reads and writes (its input and output, float32), which is what
    a conv-at-a-time execution moves at the least."""
    import torch
    px = h * w
    macs = unfused = 0
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            macs += m.weight.numel() * px
            unfused += (m.in_channels + m.out_channels) * px * 4
    nbytes = (3 + 3 + 3 * model.out_c) * px * 4
    return nbytes, macs, unfused


def imdn_phases(dev, frame, feat_lut, hyper_lut):
    """Phase 24: the IMDN (LeRF-Net) form at full width, ``IMDN2(nf=12)``,
    for the "base" and "s2d" backends: ``upscale`` 360×640 → ×4 and
    ``warp`` → 1440×2560 under ``warp_matrix()`` with the launch counts
    (SR one K1, warp one K5, no other kernel of the port); a 96×160 crop
    against the CPU path (feature within ``IMDN_FEAT_ATOL``, hyper within
    ``IMDN_HYPER_ATOL``, the frames within one level on at most
    ``IMDN_U8_SHARE``, the SR frame the twin resize of the card's own
    stages but for .5 ties, the warp's mask equal); the whole calls, the
    device parts, the towers' device time (the profiler's cuDNN and
    elementwise rows) beside their bound, and K1 / K5.  Then K1's and K5's
    float modes on the towers' own outputs beside their int32 modes on the
    LUT stages' (the main path's uint8 mode, alternating rounds, and the
    profiler).  Returns the float modes' kernel rows and the launches."""
    import torch
    from lerf_torch.models.imdn_s2d import resolve_backend
    from lerf_torch.ops.geometry import ResizeGeometry
    from lerf_torch.ops.kernels import resize as k1
    from lerf_torch.ops.kernels import warp as k5
    from lerf_torch.ops.resample import quantize_device
    from lerf_torch.pipeline import NetPredictor

    model = imdn_model()
    matrix = WARP_CASES["main"][0]
    oh, ow = int(LR_H * SCALE), int(LR_W * SCALE)
    x = torch.from_numpy(np.ascontiguousarray(frame.transpose(2, 0, 1))
                         .astype(np.float32) / 255).to(dev)
    crop = np.ascontiguousarray(frame[:CROP_H, :CROP_W])
    crop_out = (int(CROP_H * SCALE), int(CROP_W * SCALE))
    nbytes, macs, unfused = imdn_tower_work(model, LR_H, LR_W)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / NON_TENSOR_OPS_PER_S * 1e3
    t_unfused = unfused / HBM_BYTES_PER_S * 1e3
    tower_bound = max(t_bytes, t_ops)
    tower_by = "bytes" if t_bytes >= t_ops else "operations"
    result = {"launches": {}, "tower_ms": {}}
    for backend in ("base", "s2d"):
        pred = NetPredictor.from_imdn(model, backend=backend)
        if pred.device.type != "cuda":
            raise AssertionError(f"default device is {pred.device}")
        (out, feat, hyper), sr_launches = counted_run(
            lambda: pred.upscale(frame, SCALE, SCALE, return_aux=True),
            {"steering_resize": 1}, f"IMDN upscale ({backend})")
        if (out.shape != (oh, ow, 3) or out.dtype != np.uint8
                or feat.shape != (3, LR_H, LR_W) or feat.dtype != np.float32
                or hyper.shape != (3, LR_H, LR_W, 3)
                or not (np.isfinite(feat).all() and np.isfinite(hyper).all())
                or feat.min() < 0 or feat.max() > 254
                or hyper.min() < 0 or hyper.max() > 1):
            raise AssertionError(f"IMDN upscale ({backend}): output "
                                 f"{out.shape}, feat {feat.shape}, hyper "
                                 f"{hyper.shape} out of shape or range")
        (wout, wmask), warp_launches = counted_run(
            lambda: pred.warp(frame, matrix, WARP_OUT),
            {"steering_warp": 1}, f"IMDN warp ({backend})")
        if (wout.shape != WARP_OUT + (3,) or wout.dtype != np.uint8
                or wmask.shape != WARP_OUT or not wmask.any()):
            raise AssertionError(f"IMDN warp ({backend}): output "
                                 f"{wout.shape}, mask {wmask.shape}")
        result["launches"][backend] = {"upscale": sr_launches,
                                       "warp": warp_launches}

        got = pred.upscale(crop, SCALE, SCALE, return_aux=True)
        got_w = pred.warp(crop, matrix, crop_out)
        t_cpu = time.perf_counter()
        cpu = NetPredictor.from_imdn(model, backend=backend, device="cpu")
        ref = cpu.upscale(crop, SCALE, SCALE, return_aux=True)
        ref_w = cpu.warp(crop, matrix, crop_out)
        cpu_s = time.perf_counter() - t_cpu
        feat_err = float(np.abs(got[1] - ref[1]).max())
        hyper_err = float(np.abs(got[2] - ref[2]).max())
        if not (feat_err <= IMDN_FEAT_ATOL and hyper_err <= IMDN_HYPER_ATOL):
            raise AssertionError(f"IMDN crop ({backend}): feat {feat_err}, "
                                 f"hyper {hyper_err} against "
                                 f"{IMDN_FEAT_ATOL}, {IMDN_HYPER_ATOL}")
        shares = {}
        for what, a, b in (("upscale", got[0], ref[0]),
                           ("warp", got_w[0], ref_w[0])):
            d = np.abs(a.astype(int) - b.astype(int))
            shares[what] = float((d > 0).mean())
            if d.max() > 1 or shares[what] > IMDN_U8_SHARE:
                raise AssertionError(f"IMDN crop {what} ({backend}): max "
                                     f"{d.max()}, share {shares[what]}")
        if not np.array_equal(got_w[1], ref_w[1]):
            raise AssertionError(f"IMDN crop warp ({backend}): the mask "
                                 "differs from the CPU's")
        geom = ResizeGeometry.create((CROP_H, CROP_W),
                                     scale_factors=[SCALE] * 2)
        f32 = float_twin_resize(torch.from_numpy(got[1]),
                                torch.from_numpy(got[2]), geom, False)
        n_tie = check_ties(
            got[0], quantize_device(f32, 255).numpy().transpose(1, 2, 0),
            f32.numpy().transpose(1, 2, 0), f"IMDN crop ({backend})")
        emit({"phase": "imdn_end_to_end", "backend": backend,
              "resolved": resolve_backend(backend), "nf": IMDN_NF,
              "in": [LR_H, LR_W], "out": [oh, ow], "warp_out": list(WARP_OUT),
              "launches": result["launches"][backend],
              "crop": [CROP_H, CROP_W], "feat_max_abs_err": feat_err,
              "hyper_max_abs_err": hyper_err,
              "tolerance": [IMDN_FEAT_ATOL, IMDN_HYPER_ATOL, 1,
                            IMDN_U8_SHARE],
              "u8_share_differing": shares, "warp_mask_equal": True,
              "u8_mismatch_with_twin_at_ties": n_tie,
              "cpu_reference_s": cpu_s})

        mp = oh * ow / 1e6
        upscale_ms = host_call_ms(lambda: pred.upscale(frame, SCALE, SCALE),
                                  10)
        device_ms = frame_ms(lambda: pred.run_device(x, (SCALE, SCALE)),
                             frames=10, warmup=2)
        warp_ms = host_call_ms(lambda: pred.warp(frame, matrix, WARP_OUT), 10)
        warp_device_ms = frame_ms(
            lambda: pred.run_warp_device(x, matrix, WARP_OUT), frames=10,
            warmup=2)
        rows = device_rows(lambda: pred.run_device(x, (SCALE, SCALE)))
        port = [r for r in rows if "steering_resize_kernel" in r[0]]
        copies = [r for r in rows if r[0].startswith(("Memcpy", "Memset"))]
        towers = [r for r in rows if r not in port and r not in copies]
        tower_ms = sum(ms for _, _, ms in towers)
        conv_ms = sum(ms for name, _, ms in towers
                      if "xmma" in name or "conv" in name or "gemm" in name)
        result["tower_ms"][backend] = tower_ms
        emit_timed({"phase": "imdn_timing", "backend": backend,
                    "frames": 10, "upscale_ms": upscale_ms,
                    "upscale_mps": mp / upscale_ms * 1e3,
                    "device_ms": device_ms,
                    "device_mps": mp / device_ms * 1e3, "warp_ms": warp_ms,
                    "warp_device_ms": warp_device_ms,
                    "towers_profiler_ms": tower_ms,
                    "towers_conv_profiler_ms": conv_ms,
                    "towers_launches": sum(n for _, n, _ in towers),
                    "k1_profiler_ms": sum(ms for _, _, ms in port),
                    "towers_bound_ms": tower_bound,
                    "towers_bound_by": tower_by,
                    "towers_bound_parts_ms": {
                        "bytes": t_bytes, "f32_operations": t_ops,
                        "unfused_activation_bytes": t_unfused},
                    "towers_share_of_bound": tower_bound / tower_ms
                    if tower_ms else None,
                    "towers_macs": macs, "towers_bytes": nbytes,
                    "towers_unfused_bytes": unfused,
                    "device_rows": [[k[:60], n, ms] for k, n, ms in
                                    sorted(rows, key=lambda r: -r[2])[:12]]})
        emit_timed(profile_frames(lambda: pred.upscale(frame, SCALE, SCALE),
                                  frames=5, form="imdn", backend=backend))
    faster = min(result["tower_ms"], key=result["tower_ms"].get)
    emit({"phase": "imdn_backends", "towers_profiler_ms": result["tower_ms"],
          "faster": faster, "auto": resolve_backend("auto")})

    # K1 and K5 alone, float mode on the towers' outputs, int32 mode on the
    # LUT stages', the main path's uint8 mode, alternating rounds
    pred = NetPredictor.from_imdn(model)
    feat_f, hyper_f = pred._stages(x)
    hyper_f = hyper_f.contiguous()
    geom = ResizeGeometry.create((LR_H, LR_W), scale_factors=[SCALE] * 2)
    ops = k1.ResizeOperands.create(geom, dev)
    params = k5.WarpParams.create((LR_H, LR_W), matrix, WARP_OUT)
    u8 = torch.uint8
    fns = {
        ("steering_resize", "int32"): lambda: k1.steering_resize(
            feat_lut, hyper_lut, geom, operands=ops, out_dtype=u8),
        ("steering_resize", "float"): lambda: k1.steering_resize(
            feat_f, hyper_f, geom, operands=ops, out_dtype=u8),
        ("steering_warp", "int32"): lambda: k5.steering_warp(
            feat_lut, hyper_lut, params, out_dtype=u8),
        ("steering_warp", "float"): lambda: k5.steering_warp(
            feat_f, hyper_f, params, out_dtype=u8)}
    ms = {key: [] for key in fns}
    for _ in range(3):
        for key, fn in fns.items():
            ms[key].append(event_ms(fn, iters=50))
    warp_geom = params.geometry()
    plain = {"steering_resize": lambda: quantize_device(
                 float_twin_resize(feat_f, hyper_f, geom, False), 255),
             "steering_warp": lambda: quantize_u8(
                 float_twin_warp(feat_f, hyper_f, warp_geom, False))}
    rows = {}
    for (kernel, mode), fn in fns.items():
        prof = kernel_device_ms(fn, kernel + "_kernel")
        if kernel == "steering_resize":
            b_ms, b_by = bound(*k1_work(geom, 3, floats=mode == "float"))
        else:
            b_ms, b_by, _ = k5_bound(*k5_work((LR_H, LR_W), WARP_OUT, 3,
                                              floats=mode == "float"))
        mean = statistics.mean(ms[kernel, mode])
        r = {"kernel": kernel, "inputs": mode, "out_dtype": "uint8",
             "ms": mean, "ms_rounds": ms[kernel, mode], **prof,
             "bound_ms": b_ms, "bound_by": b_by,
             "share_of_bound": b_ms / mean}
        if mode == "float":
            r["plain_ms"] = event_ms(plain[kernel], iters=3, warmup=1)
        emit_timed(r)
        rows[kernel, mode] = r
    return rows, result["launches"]


def imdn_serving_phase(dev, frame):
    """Phase 25: the IMDN form's serving forms on the card (base backend):
    ``upscale_dynamic`` (×2.5), ``upscale_batch`` of 4 at ×4,
    ``warp_dynamic``, ``warp_device`` and ``warp_batch`` of 4 under
    ``warp_matrix(0..3)``, each bit-equal to ``upscale`` / ``warp`` on the
    card frame by frame (the batch runs the towers frame by frame, then one
    launch of K1 or K5), each call one K1 or K5 launch; their ms a call
    beside ``upscale``'s and ``warp``'s."""
    from lerf_torch.pipeline import NetPredictor

    pred = NetPredictor.from_imdn(imdn_model())
    rng = np.random.RandomState(7)
    frames = np.stack([frame] + [rng.randint(0, 256, frame.shape)
                                 .astype(np.uint8) for _ in range(3)])
    mats = np.stack([warp_matrix(k) for k in range(4)])
    sr = {"steering_resize": 1}
    wp = {"steering_warp": 1}
    want = [pred.upscale(f, SCALE, SCALE) for f in frames]
    got, _ = counted_run(lambda: pred.upscale_batch(frames, SCALE, SCALE),
                         sr, "IMDN upscale_batch")
    if not all(np.array_equal(got[b], want[b]) for b in range(4)):
        raise AssertionError("IMDN upscale_batch: not bit-equal per frame")
    got, _ = counted_run(lambda: pred.upscale_dynamic(frame, 2.5, 2.5), sr,
                         "IMDN upscale_dynamic")
    if not np.array_equal(got, pred.upscale(frame, 2.5, 2.5)):
        raise AssertionError("IMDN upscale_dynamic: not bit-equal")
    want = [pred.warp(f, m, WARP_OUT) for f, m in zip(frames, mats)]
    (outs, masks), _ = counted_run(
        lambda: pred.warp_batch(frames, mats, WARP_OUT), wp,
        "IMDN warp_batch")
    for b in range(4):
        if not (np.array_equal(outs[b], want[b][0])
                and np.array_equal(masks[b], want[b][1])):
            raise AssertionError(f"IMDN warp_batch frame {b}: not "
                                 "bit-equal to warp")
    for name in ("warp_dynamic", "warp_device"):
        (out, mask), _ = counted_run(
            lambda: getattr(pred, name)(frames[1], mats[1], WARP_OUT), wp,
            f"IMDN {name}")
        if not (np.array_equal(out, want[1][0])
                and np.array_equal(mask, want[1][1])):
            raise AssertionError(f"IMDN {name}: not bit-equal to warp")
    m = mats[0]
    times = {
        "upscale_ms": host_call_ms(lambda: pred.upscale(frame, SCALE, SCALE),
                                   10),
        "upscale_dynamic_x2.5_ms": host_call_ms(
            lambda: pred.upscale_dynamic(frame, 2.5, 2.5), 10),
        "upscale_batch_ms_per_frame": host_call_ms(
            lambda: pred.upscale_batch(frames, SCALE, SCALE), 5) / 4,
        "warp_ms": host_call_ms(lambda: pred.warp(frame, m, WARP_OUT), 10),
        "warp_dynamic_ms": host_call_ms(
            lambda: pred.warp_dynamic(frame, m, WARP_OUT), 10),
        "warp_device_ms": host_call_ms(
            lambda: pred.warp_device(frame, m, WARP_OUT), 10),
        "warp_batch_ms_per_frame": host_call_ms(
            lambda: pred.warp_batch(frames, mats, WARP_OUT), 5) / 4}
    emit_timed({"phase": "imdn_serving", "frames": 4,
                "bit_equal_to_frames": ["upscale_batch", "upscale_dynamic",
                                        "warp_batch", "warp_dynamic",
                                        "warp_device"],
                "launches_per_call": {"sr": sr, "warp": wp}, **times})


def transfer_phase(dev, params, frame):
    """Phase 26: ``transfer_to_lut`` of the nf 64 SRNet params on the card
    (the default device) against the CPU's: int8 tables equal but for 1-LSB
    rounding ties (at least ``TRANSFER_EQUAL_SHARE`` equal), with the
    seconds of each (the card's first and second call); then
    ``LutPredictor`` on the card's bank upscales the frame on the card (K2
    twice, K1 once)."""
    from lerf_torch.lut.transfer import transfer_to_lut
    from lerf_torch.pipeline import LutPredictor

    card_s = []
    for _ in range(2):
        t = time.perf_counter()
        bank = transfer_to_lut(params)
        card_s.append(time.perf_counter() - t)
    t = time.perf_counter()
    want = transfer_to_lut(params, device="cpu")
    cpu_s = time.perf_counter() - t
    n = same = worst = 0
    for a, b in ((want.stage1, bank.stage1), (want.stage2, bank.stage2)):
        for k in a:
            if a[k].shape != b[k].shape or b[k].dtype != np.int8:
                raise AssertionError(f"transfer {k}: {b[k].shape} "
                                     f"{b[k].dtype}")
            d = np.abs(a[k].astype(int) - b[k].astype(int))
            worst = max(worst, int(d.max()))
            n, same = n + d.size, same + int((d == 0).sum())
    if worst > 1 or same / n < TRANSFER_EQUAL_SHARE:
        raise AssertionError(f"transfer: card vs CPU max {worst} LSB, "
                             f"{same / n} equal")
    out, launches = counted_run(
        lambda: LutPredictor(bank).upscale(frame, SCALE, SCALE),
        {"lut_stage": 2, "steering_resize": 1}, "LUT form on the card's bank")
    if out.shape != (int(LR_H * SCALE), int(LR_W * SCALE), 3):
        raise AssertionError(f"LUT form on the card's bank: {out.shape}")
    emit_timed({"phase": "transfer", "nf": NF, "entries": L4,
                "table_columns": n // L4, "max_lsb": worst,
                "share_equal": same / n, "card_s": card_s, "cpu_s": cpu_s,
                "served_launches": launches})


# -- training (phases 27-31) -------------------------------------------------

def k6_work(c, h, w, oh, ow, s, linear):
    """(bytes, operations) of one K6 call: ∂L/∂out, the float32 feature
    and hyper maps read once, their two gradients written once, the
    geometry read once (P and Q are the design's, not the function's);
    the operations once an output and neighbour, an output and a source
    pixel."""
    hc = 1 if linear else 3
    nbytes = 4 * (c * oh * ow + 2 * c * h * w * (1 + hc)) + (oh + ow) * s * 8
    per = K6_LIN_OPS_PER_NEIGHBOUR if linear else K6_OPS_PER_NEIGHBOUR
    ops = c * oh * ow * (s * s * per + K6_OPS_PER_OUTPUT) \
        + c * h * w * K6_OPS_PER_SOURCE
    return nbytes, ops


def rel_err(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def start_first_build(source, name):
    """nvcc of a kernel's first design (``source``, relative to the repo,
    outside the library) into ``build/<name>/``, started beside the
    library's build so they compile together: (process, library path)."""
    from lerf_torch.ops.kernels import _build

    out_dir = os.path.join(_build.BUILD_ROOT, name)
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{name}_{os.getpid()}.so")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), source)
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                             src, "-o", lib], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib


def start_k6_first_build():
    """K6's first design (``K6_FIRST``, two passes)."""
    return start_first_build(K6_FIRST, "k6_first")


def bf16_frags(w, layer, nf):
    """Stacked ``[M, in, out]`` bfloat16 weights of ``layer`` → the B
    fragments K3 bf16's first design (``K3_BF16_FIRST``) reads for its
    ``mma.sync.m16n8k16``, bfloat16 ``[M, k-steps, n-tiles, 32, 4]``: lane
    ``4g + q`` of (k-step s, n-tile t) holds inputs ``16s + 2q``, ``16s +
    2q + 1``, ``16s + 2q + 8`` and ``16s + 2q + 9`` of output ``8t + g``;
    zero padding as ``srnet_ensemble.padded_layer``, to ``padded_nf``
    features."""
    from lerf_torch.ops.kernels import srnet_ensemble as k3

    dense = k3.padded_layer(w, layer, nf, k3.padded_nf(nf), 16)
    m, kp, np_ = dense.shape
    return dense.reshape(m, kp // 16, 2, 4, 2, np_ // 8, 8) \
        .permute(0, 1, 5, 6, 3, 2, 4).reshape(m, kp // 16, np_ // 8, 32, 4) \
        .contiguous()


def k3_bf16_first_design(build):
    """K3 bf16's first design, ``fn(img, heads, members, half)`` → the
    float32 sums, once its build (``start_first_build(K3_BF16_FIRST,
    ...)``) is done; each ``StackedHeads``' B fragments (``bf16_frags``)
    made at its first call.  ``fn.log`` is nvcc's output (ptxas rows)."""
    import ctypes

    import torch
    from lerf_torch.ops.kernels import _build
    from lerf_torch.ops.lut_pipeline import member_offsets

    proc, path = build
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"K3 bf16 first design: nvcc failed:\n{log}")
    entry = ctypes.CDLL(path).lerf_srnet_ensemble_bf16_first
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    entry.argtypes = [vp] * 15 + [i32] * 6 + [ctypes.c_float, vp]
    entry.restype = i32
    frags = {}

    def call(img, sh, members, half):
        if id(sh) not in frags:
            frags[id(sh)] = (sh, [bf16_frags(w, k, sh.nf)
                                  for k, w in enumerate(sh.w)])
        out = torch.empty(img.shape + (sh.oc,), dtype=torch.float32,
                          device=img.device)
        h, w = img.shape[-2:]
        offsets = member_offsets(members)
        err = entry(img.data_ptr(), out.data_ptr(),
                    *(t.data_ptr() for t in frags[id(sh)][1]),
                    *(t.data_ptr() for t in sh.b), offsets.ctypes.data,
                    len(members), img.numel() // (h * w), h, w, sh.nf,
                    sh.oc, float(half),
                    torch.cuda.current_stream().cuda_stream)
        _build.check(err, "K3 bf16 first design")
        return out

    call.log = log
    return call


def k2_rows_first_call(entry):
    """``fn(img, tables, modes, split_r, den, bias)`` → int32 [..., H, W,
    oC] through ``entry``, a library's ``lerf_lut_stage_rows_first`` (K2
    rows' first design, or a probe's variant of it), on the row mode's
    descriptors (``lut_stage.row_members``; the first design ignores
    whether a member's slots are copied)."""
    import torch
    from lerf_torch.ops.kernels import _build
    from lerf_torch.ops.kernels import lut_stage as k2

    entry.argtypes = _build.library().lerf_lut_stage_rows.argtypes
    entry.restype = _build.library().lerf_lut_stage_rows.restype

    def call(img, tables, modes, split_r, den, bias):
        plan = k2.row_members(tables, modes, split_r, img.device)
        out = torch.empty(img.shape + (plan.oc,), dtype=torch.int32,
                          device=img.device)
        _build.check(entry(*k2.rows_args(
            img, out, plan, interval=4, den=den, bias=bias, norm=255,
            stream=torch.cuda.current_stream().cuda_stream)),
            "K2 rows first design")
        return out

    return call


def k2_rows_first_design(build):
    """K2 rows' first design (``K2_ROWS_FIRST``) as ``k2_rows_first_call``
    gives it, once its build (``start_first_build(K2_ROWS_FIRST, ...)``)
    is done.  ``fn.log`` is nvcc's output."""
    import ctypes

    proc, path = build
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"K2 rows first design: nvcc failed:\n{log}")
    call = k2_rows_first_call(ctypes.CDLL(path).lerf_lut_stage_rows_first)
    call.log = log
    return call


def k3_bf16_l2_bytes(n, sh, tile):
    """The weight bytes the design implies one K3 bf16 launch over ``n``
    pixels reads from L2, if every block (``tile`` pixels) reads each
    member's weights from L2 once (the first design's fragments hold the
    same padded bytes).  Worked out, not measured: no counter of the card's
    L2 is read."""
    return -(-n // tile) * sum(f.numel() * 2 for f in sh.frags)


def bf16_against_first(kern, first, frames=5):
    """K3 bf16 as built against its first design on the same call:
    ``K3_BF16_ROUNDS`` rounds of (kernel, first, first, kernel) by events
    and by CUDA-graph replays (no host launch between launches), then by
    the profiler, both designs in each window (windows with a row of each,
    up to 8 tried): medians, each one's rounds, and the profiler's mean ms
    a recorded launch."""
    fns = {"kernel": kern, "first": first}
    keys = {"kernel": "srnet_bf16_wgmma", "first": "srnet_ensemble_bf16_k"}
    ms = {"kernel": [], "first": []}
    graph = {"kernel": [], "first": []}
    for _ in range(K3_BF16_ROUNDS):
        for which in ("kernel", "first", "first", "kernel"):
            ms[which].append(event_ms(fns[which], iters=5, warmup=1))
            graph[which].append(graph_ms(fns[which], iters=5))
    prof = {"kernel": [], "first": []}
    windows = 0
    for _ in range(8):
        windows += 1
        rows = device_rows(lambda: [f() for f in (kern, first, first, kern)],
                           frames=frames)
        got = {}
        for which, key in keys.items():
            mine = [(n, t) for name, n, t in rows if key in name]
            n = sum(r[0] for r in mine)
            if n:
                got[which] = sum(r[1] for r in mine) / n
        if len(got) == 2:
            for which, t in got.items():
                prof[which].append(t)
            if len(prof["kernel"]) >= K3_BF16_ROUNDS:
                break
    med = statistics.median
    return {"ms_rounds": ms["kernel"], "first_ms_rounds": ms["first"],
            "ms": med(ms["kernel"]), "first_ms": med(ms["first"]),
            "graph_ms": med(graph["kernel"]),
            "first_graph_ms": med(graph["first"]),
            "profiler_ms": med(prof["kernel"]) if prof["kernel"] else None,
            "first_profiler_ms": (med(prof["first"]) if prof["first"]
                                  else None),
            "profiler_windows": [len(prof["kernel"]), windows]}


def k6_first_design(build):
    """The first design's call, ``fn(feat, hyper, g, ops, linear)`` →
    (∂L/∂feat, ∂L/∂hyper), once its build (``start_k6_first_build``) is
    done: its own C entry, with P / Q scratch and the per-axis inverse
    lists of ``ops`` (a ``resize_bwd.GradOperands``), made at its first
    call."""
    import ctypes

    import torch
    from lerf_torch.ops.kernels import _build
    from lerf_torch.ops.kernels.resize_bwd import inverse_fov

    proc, path = build
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"K6 first design: nvcc failed:\n{log}")
    entry = ctypes.CDLL(path).lerf_steering_resize_bwd
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entry.argtypes = [vp] * 15 + [i32] * 12 + [f32, f32, vp]
    entry.restype = i32
    inverse = {}

    def call(feat, hyper, g, ops, linear, max_sigma=10.0):
        f = ops.fwd
        if id(ops) not in inverse:
            lists = [inverse_fov(t.cpu().numpy()) for t in (f.rows, f.cols)]
            inverse[id(ops)] = (ops, [(torch.from_numpy(a).to(feat.device),
                                       v) for a, v in lists])
        (inv_r, r_min), (inv_c, c_min) = inverse[id(ops)][1]
        scratch = [torch.empty_like(g) for _ in range(2)]
        grads = torch.empty_like(feat), torch.empty_like(hyper)
        dis = (f.lin_x, f.lin_y) if linear else (f.dis_x, f.dis_y)
        masks = ((f.mask_x.data_ptr(), f.mask_y.data_ptr()) if linear
                 else (None, None))
        err = entry(feat.data_ptr(), hyper.data_ptr(), g.data_ptr(),
                    *(t.data_ptr() for t in (*scratch, *grads, f.rows,
                                             f.cols, *dis)),
                    *masks, inv_r.data_ptr(), inv_c.data_ptr(), r_min,
                    inv_r.shape[0], c_min, inv_c.shape[0], feat.shape[0],
                    *f.in_sz, *f.out_sz, f.support, int(f.antialias),
                    int(linear), float(f.min_scale), float(max_sigma),
                    torch.cuda.current_stream().cuda_stream)
        _build.check(err, "K6 first design")
        return grads

    return call


def k6_profiler_ms(fn, frames=20):
    """torch.profiler's K6 time a call: each ``resize_bwd`` kernel's mean
    time a recorded launch, summed over the kernels of a call (the first
    design's two passes, the kernel's one launch; the profiler drops rows
    in some windows, so a total over the calls made would read low), with
    the launches it recorded a call."""
    rows = [(n, ms) for name, n, ms in device_rows(fn, frames)
            if "resize_bwd" in name]
    return sum(ms / n for n, ms in rows), sum(n for n, _ in rows)


def k6_inputs(dev, rng, planes, size, scale, support, linear):
    import torch
    from lerf_torch.ops.geometry import ResizeGeometry

    geom = ResizeGeometry.create(size, scale_factors=[scale] * 2,
                                 support=support, antialias=False)
    oc = 1 if linear else 3
    feat = torch.from_numpy((rng.rand(planes, *size) * 255)
                            .astype(np.float32)).to(dev)
    hyper = torch.from_numpy(rng.rand(planes, *size, oc)
                             .astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(planes, *geom.out_sz)
                         .astype(np.float32)).to(dev)
    return geom, feat, hyper, g


def k6_phase(dev, first):
    """Phase 27: K6 against its twin on the card at the LeRF training shape
    (16 planes of 48×48 → ×4, support 2), at support 4, at ×2.5 and at the
    frame (3 planes of 360×640 → ×4), both modes: each gradient within
    GRAD_RTOL of its largest value, a second launch bit-equal (no atomics),
    and the twin against autograd of the plain op on the card; the first
    design (``first``, ``k6_first_design``) against the twin at the
    training shape and the frame.  Then at both shapes and in both modes
    the kernel and its first design in K6_ROUNDS alternating rounds, each
    by events and by the profiler, with the bound and the share; the
    twin's time and K1's float-mode float32-out forward beside.  Returns
    the kernels line's rows (the training shape's)."""
    import torch
    from lerf_torch.ops.kernels import resize as k1
    from lerf_torch.ops.kernels import resize_bwd as k6
    from lerf_torch.ops.resample import (amplified_linear_resize,
                                         steering_gaussian_resize,
                                         steering_resize_grad_plain)

    rng = np.random.RandomState(7)
    worst = {False: 0.0, True: 0.0}
    inputs = {}
    for name, planes, size, scale, support in K6_CASES:
        for linear in (False, True):
            geom, feat, hyper, g = k6_inputs(dev, rng, planes, size, scale,
                                             support, linear)
            ops = k6.GradOperands.create(geom, dev, linear=linear)
            got = k6.steering_resize_grad(feat, hyper, g, geom,
                                          linear=linear, operands=ops)
            again = k6.steering_resize_grad(feat, hyper, g, geom,
                                            linear=linear, operands=ops)
            twin = steering_resize_grad_plain(feat, hyper, g, geom,
                                              linear=linear)
            f = feat.clone().requires_grad_()
            hy = hyper.clone().requires_grad_()
            out = (amplified_linear_resize(f, hy[..., 0], geom) if linear
                   else steering_gaussian_resize(f, hy[..., 0], hy[..., 1],
                                                 hy[..., 2], geom))
            out.backward(g)
            torch.cuda.synchronize()
            errs = {"feature": rel_err(got[0], twin[0]),
                    "hyper": rel_err(got[1], twin[1]),
                    "twin_vs_autograd_feature": rel_err(twin[0], f.grad),
                    "twin_vs_autograd_hyper": rel_err(twin[1], hy.grad)}
            if name in K6_TIMED:
                old = first(feat, hyper, g, ops, linear)
                errs["first_design_feature"] = rel_err(old[0], twin[0])
                errs["first_design_hyper"] = rel_err(old[1], twin[1])
                inputs[name, linear] = (geom, ops, feat, hyper, g)
            if max(errs.values()) > GRAD_RTOL:
                raise AssertionError(f"K6 {name} linear={linear}: {errs} > "
                                     f"{GRAD_RTOL}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K6 {name}: a second launch differs")
            err = max(float((a - b).abs().max()) for a, b in zip(got, twin))
            if name == "train":
                worst[linear] = err
            plan, _ = ops.launch_plan(planes)
            emit({"phase": "k6_vs_plain", "case": name, "linear": linear,
                  "planes": planes, "in": list(size),
                  "out": list(geom.out_sz), "support": support,
                  "tile": list(plan.tile), "lanes": plan.group,
                  "threads": plan.threads,
                  "blocks": planes * plan.n_ty * plan.n_tx,
                  "smem": plan.smem, "rel_err": errs, "max_abs_err": err,
                  "deterministic": True})

    rows = {}
    for name in K6_TIMED:
        for linear in (False, True):
            geom, ops, feat, hyper, g = inputs[name, linear]
            c, h, w = feat.shape
            calls = {
                "kernel": lambda: k6.steering_resize_grad(
                    feat, hyper, g, geom, linear=linear, operands=ops),
                "first_design": lambda: first(feat, hyper, g, ops, linear)}
            rounds = {k: [] for k in calls}
            for rnd in range(K6_ROUNDS):
                for which in (calls if rnd % 2 == 0 else reversed(calls)):
                    ms = event_ms(calls[which], iters=50)
                    prof_ms, prof_n = k6_profiler_ms(calls[which])
                    rounds[which].append((ms, prof_ms, prof_n))
            nbytes, nops = k6_work(c, h, w, *geom.out_sz, geom.support,
                                   linear)
            b_ms, b_by = bound(nbytes, nops)
            timed = {}
            for which, got in rounds.items():
                ms = statistics.median(r[0] for r in got)
                prof = statistics.median(r[1] for r in got)
                timed[which] = {
                    "ms": ms, "profiler_ms": prof,
                    "rounds_ms": [r[0] for r in got],
                    "rounds_profiler_ms": [r[1] for r in got],
                    "profiler_launches_a_call": [r[2] for r in got],
                    "share_of_bound": b_ms / ms,
                    "profiler_share_of_bound": (b_ms / prof if prof
                                                else None)}
            row = {"kernel": "steering_resize_bwd", "case": name,
                   "linear": linear, "planes": c, "in": [h, w],
                   "out": list(geom.out_sz), **timed["kernel"],
                   "first_design": timed["first_design"],
                   "speedup_events": (timed["first_design"]["ms"]
                                      / timed["kernel"]["ms"]),
                   "speedup_profiler": (
                       timed["first_design"]["profiler_ms"]
                       / timed["kernel"]["profiler_ms"]
                       if timed["kernel"]["profiler_ms"] else None),
                   "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                   "ops": nops}
            if name == "train":
                row["plain_ms"] = event_ms(lambda: steering_resize_grad_plain(
                    feat, hyper, g, geom, linear=linear), iters=5, warmup=1)
                row["k1_float32_out_ms"] = event_ms(lambda: k1.steering_resize(
                    feat, hyper, geom, operands=ops.fwd, linear=linear),
                    iters=50)
                row["max_abs_err"] = worst[linear]
                rows[linear] = row
            emit_timed(row)
    return rows


def write_div2k(root, n=16, size=480, seed=0, scale=4):
    """A synthetic DIV2K layout: ``n`` seeded uint8 HR images of size² and
    their ×``scale`` decimations (HR/{f}.png, LR/X4/{f}x4.png)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "HR"))
    os.makedirs(os.path.join(root, "LR", f"X{scale}"))
    for i in range(n):
        f = f"{i + 1:04d}"
        hr = rng.randint(0, 256, (size, size, 3), dtype=np.uint8)
        Image.fromarray(hr).save(os.path.join(root, "HR", f"{f}.png"))
        Image.fromarray(hr[::scale, ::scale]).save(
            os.path.join(root, "LR", f"X{scale}", f"{f}x{scale}.png"))


def write_set5(root, n=VAL_IMAGES, size=96, seed=1):
    """A synthetic Set5-layout SR benchmark: HR/{i}.png and its ×2, ×3, ×4
    decimations under LR_bicubic/rrLR_X{s}.00_{s}.00."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    hr_dir = os.path.join(root, "Set5", "HR")
    os.makedirs(hr_dir)
    for i in range(n):
        hr = rng.randint(0, 256, (size, size, 3), dtype=np.uint8)
        Image.fromarray(hr).save(os.path.join(hr_dir, f"{i}.png"))
        for s in (2, 3, 4):
            d = os.path.join(root, "Set5", "LR_bicubic",
                             f"rrLR_X{s}.00_{s}.00")
            os.makedirs(d, exist_ok=True)
            Image.fromarray(hr[::s, ::s]).save(os.path.join(d, f"{i}.png"))


def train_argv(root, exp, *flags):
    """``python -m lerf_torch.cli.train``'s arguments for the reference's
    LeRF-G run (scripts.sh:2-6: ``-e <exp> --twoStage --outC 3``; nf 64,
    modes sct, 2 stages, ×4, crop 48, batch 16 and lr0 1e-3 are the
    defaults, spelled out) on the synthetic data under ``root``, cut to
    TRAIN_STEPS steps, with no auto-reseed (so a run's launch counts are
    known); ``flags`` after them."""
    return ["-e", os.path.join(root, exp), "--twoStage", "--outC", "3",
            "--trainDir", os.path.join(root, "div2k"),
            "--valDir", os.path.join(root, "rr"),
            "--valWDir", os.path.join(root, "none"),
            "--cropSize", str(TRAIN_CROP), "--batchSize", str(TRAIN_BATCH),
            "--nf", str(NF), "--lr0", "1e-3", "--totalIter", str(TRAIN_STEPS),
            "--displayStep", "10", "--saveStep", str(TRAIN_SAVE),
            "--valStep", str(TRAIN_STEPS), "--auto_reseed", "0", *flags]


def train_cli(argv):
    """Run ``python -m lerf_torch.cli.train`` in this process."""
    from lerf_torch.cli.train import main
    return main(argv)


def config_of(argv):
    from lerf_torch.config import TrainConfig, parse_config
    return parse_config(TrainConfig, argv)


def read_scalars(exp_dir):
    out = {}
    with open(os.path.join(exp_dir, "scalars.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            out.setdefault(r["tag"], []).append((r["step"], r["value"]))
    return out


def params_diff(a, b):
    """Largest |a − b| over two params trees' leaves."""
    from lerf_torch.train.train_step import param_leaves

    pa, pb = param_leaves(a), param_leaves(b)
    return max(float((pa[k].detach().cpu() - pb[k].detach().cpu()).abs()
                     .max()) for k in pa)


def trainer_phase(dev, root):
    """Phase 28: ``train`` (the loop a user's ``python -m
    lerf_torch.cli.train`` runs) at full width on the card, TRAIN_STEPS
    steps from the host sampler and its pinned copies, validated on the
    synthetic Set5 at the last step (``NetPredictor.from_srnets``: K3 and
    K1); then the same run with ``--device_data``.  Returns the config, the
    final params and the main run's launch counts."""
    from lerf_torch.train.checkpoint import CheckpointManager

    n_val = 3 * VAL_IMAGES
    want = {"steering_resize": TRAIN_STEPS + n_val,
            "steering_resize_bwd": TRAIN_STEPS,
            "srnet_ensemble": 2 * n_val}
    runs = {}
    for name, flags in (("host", ()), ("device_data", ("--device_data",))):
        argv = train_argv(root, f"lerf-g-{name}", *flags)
        cfg = config_of(argv)
        t = time.perf_counter()
        final, launches = counted_run(lambda: train_cli(argv), want,
                                      f"trainer ({name})")
        wall_s = time.perf_counter() - t
        sc = read_scalars(cfg.exp_dir)
        loss = [v for _, v in sc["loss_Pixel"]]
        gnorm = [v for _, v in sc["grad_norm"]]
        val = {k: v[-1][1] for k, v in sc.items() if "Set5" in k}
        if not (np.all(np.isfinite(loss)) and loss[-1] < loss[0]
                and len(val) == 6 and all(np.isfinite(list(val.values())))):
            raise AssertionError(f"trainer ({name}): loss {loss}, "
                                 f"validation {val}")
        steps = CheckpointManager(cfg.exp_dir).all_steps()
        if steps != [TRAIN_SAVE, TRAIN_STEPS]:
            raise AssertionError(f"trainer ({name}): checkpoints {steps}")
        emit_timed({"phase": "trainer", "data": name, "steps": TRAIN_STEPS,
                    "launches": launches, "wall_s": wall_s,
                    "loss_every_10": loss, "grad_norm_every_10": gnorm,
                    "validation": val, "checkpoints": steps})
        runs[name] = (cfg, final, launches)
    return runs["host"]


def step_work(hp, nf=NF):
    """(bytes, float32 operations) of one training step: the dense chains
    forward (every member at every pixel of both stages) and backward
    (twice the forward: the gradients of the inputs and of the weights),
    2 operations a multiply-add; bytes the batch, the labels and the
    params with Adam's two moments read and written once."""
    px = hp.crop_size ** 2 * TRAIN_BATCH
    members = 4 * len(hp.modes)
    macs = 3 * px * members * (chain_macs(1, nf) + chain_macs(3, nf))
    n_params = members // 4 * (chain_macs(1, nf) + 2 * chain_macs(3, nf))
    nbytes = 4 * (px + px * int(hp.scale) ** 2) + n_params * 4 * 3 * 2
    return nbytes, 2 * macs


def kernel_rows(rows):
    """``device_rows`` without the profiler's user annotations (a
    ``record_function`` range such as ``Optimizer.step#Adam.step`` shows
    as a device row spanning the kernels it holds)."""
    return [r for r in rows if "#" not in r[0]
            and not r[0].startswith("ProfilerStep")]


def step_rows(rows):
    """The step's device time by kind of kernel."""
    kinds = {"K1 (steering_resize)": ("steering_resize_kernel",),
             "K6 (steering_resize_bwd)": ("resize_bwd",),
             "products and convolutions (cuBLAS, cuDNN)": (
                 "gemm", "xmma", "cutlass", "conv"),
             "Adam (multi-tensor)": ("multi_tensor",),
             "copies": ("Memcpy", "Memset", "CatArray", "copy")}
    out = {}
    for name, _, ms in rows:
        kind = next((k for k, keys in kinds.items()
                     if any(key in name for key in keys)), "elementwise and "
                                                           "reductions")
        out[kind] = out.get(kind, 0.0) + ms
    return out


def step_phase(dev, cfg):
    """Phase 28, the step: one step on the card against the CPU's from the
    same params and batch (loss, gradient norm, each leaf's gradient,
    params after Adam); the
    card's ms a step by events over TRAIN_STEPS steps on one batch and by
    the host clock with the sampler's batches, the profiler's split, the
    busy share, peak memory and the step's bound; and from the profiler's
    rows that the resize ran K1 + K6 and no gather (no ``index`` kernel:
    the plain resize would gather)."""
    import torch
    from lerf_torch.data.div2k import DIV2K, Provider
    from lerf_torch.train import loop
    from lerf_torch.train import train_step as ts
    from lerf_torch.train.checkpoint import host_params
    from lerf_torch.train.train_step import param_leaves

    hp = loop.hparams_from_config(cfg)
    geom = ts.train_geometry(hp)
    init = loop.srnets_adapter(cfg, hp, "cpu").init_params
    dataset = DIV2K(cfg.train_dir, cfg.scale_value, cfg.crop_size,
                    in_c=cfg.in_c, seed=3)
    im, lb = (torch.from_numpy(a) for a in dataset.batch(TRAIN_BATCH))

    results = []
    for where in ("cpu", dev):
        params = {sk: {n: {k: v.to(where) for k, v in head.items()}
                       for n, head in heads.items()}
                  for sk, heads in init(torch.Generator().manual_seed(0))
                  .items()}
        state = ts.TrainState.create(params, hp)
        step = ts.make_train_step(geom, hp, device=where)
        t = time.perf_counter()
        state, m = step(state, im.to(where), lb.to(where))
        # the step leaves this step's gradients on the leaves (Adam reads
        # them and leaves them as they are)
        grads = {k: p.grad.detach().cpu()
                 for k, p in param_leaves(state.params).items()}
        results.append(({k: float(v) for k, v in m.items()}, grads,
                        host_params(state.params), time.perf_counter() - t))
    (m_cpu, g_cpu, p_cpu, cpu_s), (m_card, g_card, p_card, _) = results
    worst = params_diff(p_card, p_cpu)
    # a leaf the loss does not reach has a zero gradient on both sides
    grad_err = {k: rel_err(g_card[k], g) if g.abs().max() > 0
                else float(g_card[k].abs().max()) for k, g in g_cpu.items()}
    leaf, grad_worst = max(grad_err.items(), key=lambda kv: kv[1])
    emit({"phase": "train_step_vs_cpu", "card": m_card, "cpu": m_cpu,
          "grad_leaves": len(grad_err), "grad_worst_leaf": leaf,
          "grad_worst_rel_err": grad_worst, "params_max_abs": worst,
          "tolerance": {"loss_grad_norm_rel": TRAIN_RTOL,
                        "grad_rel_leaf_max": TRAIN_RTOL,
                        "params_abs": TRAIN_PARAM_ATOL},
          "cpu_step_s": cpu_s})
    for k in ("loss", "grad_norm"):
        if abs(m_card[k] - m_cpu[k]) > TRAIN_RTOL * abs(m_cpu[k]):
            raise AssertionError(f"step card vs CPU {k}: {m_card[k]} vs "
                                 f"{m_cpu[k]}")
    if grad_worst > TRAIN_RTOL:
        raise AssertionError(f"step card vs CPU gradient of {leaf}: "
                             f"{grad_worst} of its largest value")
    if worst > TRAIN_PARAM_ATOL:
        raise AssertionError(f"step card vs CPU params: max {worst}")

    params = init(torch.Generator().manual_seed(0))
    state = ts.TrainState.create({sk: {n: {k: v.to(dev) for k, v in h.items()}
                                       for n, h in hs.items()}
                                  for sk, hs in params.items()}, hp)
    step = ts.make_train_step(geom, hp, device=dev)
    im_d, lb_d = im.to(dev), lb.to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ms = event_ms(lambda: step(state, im_d, lb_d), iters=TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    provider = Provider(dataset, TRAIN_BATCH,
                        pin_memory=torch.device(dev).type == "cuda")
    try:
        def fed_step():
            a, b = provider.next()
            step(state, loop.to_device(a, dev), loop.to_device(b, dev))

        for _ in range(3):
            fed_step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(20):
            fed_step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3 / 20
    finally:
        provider.close()
    rows = kernel_rows(device_rows(lambda: step(state, im_d, lb_d),
                                   frames=5))
    names = [n for n, _, _ in rows]
    device_ms = sum(r[2] for r in rows)
    k1_rows = [r for r in rows if "steering_resize_kernel" in r[0]]
    k6_rows = [r for r in rows if "resize_bwd" in r[0]]
    gathers = [n for n in names if "index" in n.lower()]
    if not k1_rows or len(k6_rows) != 1 or gathers:
        raise AssertionError(f"train step rows: K1 {k1_rows}, K6 {k6_rows}, "
                             f"gathers {gathers}")
    nbytes, nops = step_work(hp)
    b_ms, b_by = bound(nbytes, nops)
    emit_timed({"phase": "train_step", "batch": TRAIN_BATCH,
                "crop": TRAIN_CROP, "nf": NF, "ms": ms,
                "host_fed_ms": host_ms, "steps_per_s": 1e3 / ms,
                "peak_memory_gb": peak / 1e9, "bound_ms": b_ms,
                "bound_by": b_by, "share_of_bound": b_ms / ms,
                "device_ms": device_ms, "busy_share": device_ms / ms,
                "device_ms_by_kind": step_rows(rows),
                "k1_profiler_ms": sum(r[2] for r in k1_rows),
                "k6_profiler_ms": sum(r[2] for r in k6_rows),
                "top": [[n[:60], calls, dms] for n, calls, dms in sorted(
                    rows, key=lambda r: -r[2])[:10]]})


def resume_phase(dev, cfg, final):
    """Phase 29: the run of phase 28 resumed from its step-TRAIN_SAVE
    checkpoint to TRAIN_STEPS: the same params, Adam state, scheduler and
    sampler state, so the same final params as the uninterrupted run (the
    SRNet step's gradients are deterministic on the card: K6 has no
    atomics, the stages' edge pad sums its copies without them).  The
    validation at the last step runs again (K3 + K1)."""
    n_val = 3 * VAL_IMAGES
    argv = train_argv(os.path.dirname(cfg.exp_dir),
                      os.path.basename(cfg.exp_dir),
                      "--startIter", str(TRAIN_SAVE))
    resumed, launches = counted_run(
        lambda: train_cli(argv),
        {"steering_resize": TRAIN_STEPS - TRAIN_SAVE + n_val,
         "steering_resize_bwd": TRAIN_STEPS - TRAIN_SAVE,
         "srnet_ensemble": 2 * n_val}, "trainer resumed")
    worst = params_diff(resumed, final)
    emit({"phase": "resume", "from_step": TRAIN_SAVE, "to": TRAIN_STEPS,
          "launches": launches, "params_max_abs_vs_uninterrupted": worst,
          "bit_equal": worst == 0.0})
    if worst != 0.0:
        raise AssertionError(f"resumed run differs from the uninterrupted "
                             f"one by {worst}")


def lutft_phase(dev, cfg, final, frame):
    """Phase 30: the trained params transferred to a bank on the card
    (``LUT_*.npy``), ``--lutft`` for a few steps at 17⁴ tables (K1 + K6 a
    step; validation serves the requantized tables by ``LutPredictor``: K2
    twice and K1 a call), then ``LUTft_*.npy`` served on the frame by
    ``LutPredictor.from_config`` (K2 twice, K1 once)."""
    import torch
    from lerf_torch import config
    from lerf_torch.lut.io import load_lut_bank, save_lut_bank
    from lerf_torch.lut.transfer import transfer_to_lut
    from lerf_torch.pipeline import LutPredictor

    steps, n_val = 10, 3 * VAL_IMAGES
    bank = transfer_to_lut(final, device=dev)
    save_lut_bank(bank, cfg.exp_dir, lut_name="LUT", keep_trailing_dims=False)
    argv = train_argv(os.path.dirname(cfg.exp_dir),
                      os.path.basename(cfg.exp_dir), "--lutft", "--lr0",
                      "1e-4", "--totalIter", str(steps), "--valStep",
                      str(steps))
    t = time.perf_counter()
    _, launches = counted_run(
        lambda: train_cli(argv),
        {"steering_resize": steps + n_val, "steering_resize_bwd": steps,
         "lut_stage": 2 * n_val}, "LUT fine-tuning")
    ft_s = time.perf_counter() - t
    ft = load_lut_bank(cfg.exp_dir, lut_name="LUTft", out_c=3)
    if ft.stage2["sr0"].dtype != np.int8 or ft.stage2["sr0"].shape != (L4, 3):
        raise AssertionError(f"LUTft: {ft.stage2['sr0'].shape}")
    pred = LutPredictor.from_config(config.parse_config(
        config.TestConfig, ["-e", cfg.exp_dir, "--lutName", "LUTft",
                            "--platform", torch.device(dev).type]))
    out, served = counted_run(lambda: pred.upscale(frame, SCALE, SCALE),
                              {"lut_stage": 2, "steering_resize": 1},
                              "LUTft served")
    if out.shape != (int(frame.shape[0] * SCALE),
                     int(frame.shape[1] * SCALE), 3):
        raise AssertionError(f"LUTft served: {out.shape}")
    emit_timed({"phase": "lutft", "steps": steps, "launches": launches,
                "wall_s": ft_s, "validation": {
                    k: v[-1][1] for k, v in read_scalars(cfg.exp_dir).items()
                    if "Set5" in k},
                "served_launches": served})


def imdn_train_phase(dev, root):
    """Phase 31: IMDN2 (nf 12) trains a few steps through ``train`` (K1 +
    K6 a step), then its step alone: ms by events, and from the
    profiler's rows no TF32 kernel (cuDNN's or cuBLAS's) in the forward or
    the backward, with TF32 allowed by the caller outside the step."""
    import torch
    from lerf_torch.train import loop
    from lerf_torch.train import train_step as ts

    steps = 5
    argv = train_argv(root, "lerf-net", "--model", "IMDN2", "--inC", "3",
                      "--nf", str(IMDN_NF), "--totalIter", str(steps),
                      "--valStep", "1000", "--saveStep", str(steps))
    cfg = config_of(argv)
    _, launches = counted_run(lambda: train_cli(argv),
                              {"steering_resize": steps,
                               "steering_resize_bwd": steps}, "IMDN2 train")
    hp = loop.hparams_from_config(cfg)
    adapter = loop.imdn_adapter(cfg, hp, dev)
    state = ts.TrainState.create(
        adapter.init_params(torch.Generator().manual_seed(0)), hp)
    step = ts.make_train_step(ts.train_geometry(hp), hp,
                              stage1_fn=adapter.stage1_fn,
                              stage2_fn=adapter.stage2_fn, device=dev)
    rng = np.random.RandomState(2)
    im = torch.from_numpy(rng.rand(TRAIN_BATCH, 3, TRAIN_CROP, TRAIN_CROP)
                          .astype(np.float32)).to(dev)
    lb = torch.from_numpy(rng.rand(TRAIN_BATCH, 3, 4 * TRAIN_CROP,
                                   4 * TRAIN_CROP).astype(np.float32)).to(dev)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        ms = event_ms(lambda: step(state, im, lb), iters=10)
        rows = kernel_rows(device_rows(lambda: step(state, im, lb),
                                       frames=3))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    tf32 = [n for n, _, _ in rows if "tf32" in n.lower() or "1688" in n]
    convs = sorted({n[:70] for n, _, _ in rows
                    if any(k in n.lower() for k in ("conv", "implicit",
                                                    "wgrad", "dgrad"))})
    if tf32 or not convs:
        raise AssertionError(f"IMDN2 step: TF32 kernels {tf32}, convs "
                             f"{convs}")
    device_ms = sum(r[2] for r in rows)
    emit_timed({"phase": "imdn_train", "nf": IMDN_NF, "steps": steps,
                "launches": launches, "step_ms": ms, "device_ms": device_ms,
                "busy_share": device_ms / ms, "tf32_kernels": tf32,
                "conv_kernels": convs,
                "device_ms_by_kind": step_rows(rows)})


# -- the serving surface: async forms, streams, daemon, CLI, resize ----------

SERVE_FRAMES = 32             # phase 34's stream
SERVE_DEPTHS = (1, 2, 4)
SERVE_ROUNDS = 2
HTTP_CLIENTS, HTTP_REQUESTS = 4, 8
PINNED_GROWTH = 8             # phase 35: blocks kept results add to the pool
PINNED_MOST = 512             # ... keeping at most this many results
CLI_FILES = 4
# resize on the card against the CPU: the same float32 products of the
# same host float64 taps, summed in the same order on both devices; values
# in 0..255
RESIZE_ATOL = 1e-3


def host_staged_frame(pred, frame, scale=None, matrix=None):
    """A frame as the forms made it before the pinned staging: the host's
    layout and cast (``_input``: an int32 or float32 frame, 4 B a pixel,
    copied up from pageable memory), the device part on the current
    stream, the uint8 frame copied down into pageable memory."""
    x = pred._input(np.ascontiguousarray(frame.transpose(2, 0, 1)))
    if matrix is None:
        out = pred.run_device(x, scale)[0]
    else:
        out = pred.run_warp_device(x, matrix, WARP_OUT)[0]
    return np.moveaxis(out.cpu().numpy(), -3, -1)


def timed_future(call, n=10, warmup=2):
    """Median host ms of a request's dispatch (the async call) and of the
    whole request (dispatch and ``result()``)."""
    dispatch, whole = [], []
    for i in range(warmup + n):
        t0 = time.perf_counter()
        fut = call()
        t1 = time.perf_counter()
        fut.result()
        t2 = time.perf_counter()
        if i >= warmup:
            dispatch.append((t1 - t0) * 1e3)
            whole.append((t2 - t0) * 1e3)
    return statistics.median(dispatch), statistics.median(whole)


def serving_forms(banks, params):
    """Phase 32's forms on the card: name → (predictor, the launches of a
    frame's stages): the LUT form (LeRF-G, LeRF-L), the net form on K4 and
    the IMDN form ("base")."""
    from lerf_torch.pipeline import LutPredictor, NetPredictor
    return {
        "lut_g": (LutPredictor(banks["lerf_g"]), {"lut_stage": 2}),
        "lut_l": (LutPredictor(banks["lerf_l"], linear=True),
                  {"lut_stage": 2}),
        "net_k4": (NetPredictor.from_srnets(params, backend="pallas_int8"),
                   {"srnet_ensemble_int8": 2}),
        "imdn": (NetPredictor.from_imdn(imdn_model(), backend="base"), {}),
    }


def async_phase(forms, frame):
    """Phase 32: each form's async requests at 360×640 → ×4 and under
    ``warp_matrix(0..3)`` → 1440×2560: the future's frame (and mask) equal
    to the synchronous form's, to ``upscale`` / ``warp`` and to the
    host-staged path (the forms before the staging); the stage kernels and
    one K1 or K5 a request; the dispatch's host time and the whole
    request's."""
    mats = [warp_matrix(s) for s in range(4)]
    counts = {}
    for name, (pred, stages) in forms.items():
        sr_want = {**stages, "steering_resize": 1}
        warp_want = {**stages, "steering_warp": 1}
        wants = {"upscale_dynamic": pred.upscale_dynamic(frame, SCALE, SCALE),
                 "upscale": pred.upscale(frame, SCALE, SCALE),
                 "host-staged": host_staged_frame(pred, frame,
                                                  (SCALE, SCALE))}
        fut, counts[name, "sr"] = counted_run(
            lambda: pred.upscale_dynamic_async(frame, SCALE, SCALE), sr_want,
            f"{name} upscale_dynamic_async")
        got = fut.result()
        for what, want in wants.items():
            if not np.array_equal(got, want):
                raise AssertionError(f"{name} upscale_dynamic_async: not "
                                     f"bit-equal to {what}")
        for k, m in enumerate(mats):
            want = pred.warp(frame, m, WARP_OUT)
            staged = host_staged_frame(pred, frame, matrix=m)
            for method in ("warp_dynamic_async", "warp_device_async"):
                fut, counts[name, method] = counted_run(
                    lambda: getattr(pred, method)(frame, m, WARP_OUT),
                    warp_want, f"{name} {method} {k}")
                out, mask = fut.result()
                if not (np.array_equal(out, want[0])
                        and np.array_equal(mask, want[1])
                        and np.array_equal(out, staged)):
                    raise AssertionError(f"{name} {method} matrix {k}: not "
                                         "bit-equal to warp / the "
                                         "host-staged path")
        sr = timed_future(lambda: pred.upscale_dynamic_async(frame, SCALE,
                                                             SCALE))
        wp = timed_future(lambda: pred.warp_dynamic_async(frame, mats[0],
                                                          WARP_OUT))
        emit_timed({"phase": "async", "form": name,
                    "bit_equal": ["upscale_dynamic", "upscale",
                                  "host-staged", "warp_dynamic", "warp",
                                  "warp_device"],
                    "launches_sr": counts[name, "sr"],
                    "launches_warp": counts[name, "warp_dynamic_async"],
                    "sr_dispatch_ms": sr[0], "sr_whole_ms": sr[1],
                    "warp_dispatch_ms": wp[0], "warp_whole_ms": wp[1]})
    return counts


def pinned_reuse_phase(pred, rng):
    """Phase 33: 8 distinct frames dispatched before any ``result()``, then
    each checked (SR and warp); then the serving cache cut to 2 entries and
    8 requests at 8 new scales dispatched, evicting while the earlier are
    in flight, each checked again."""
    import torch

    from lerf_torch import pipeline

    frames = [rng.randint(0, 256, (LR_H, LR_W, 3)).astype(np.uint8)
              for _ in range(8)]
    want = [pred.upscale(f, SCALE, SCALE) for f in frames]
    futs = [pred.upscale_dynamic_async(f, SCALE, SCALE) for f in frames]
    got = [f.result() for f in futs]
    pinned = all(isinstance(g.base, torch.Tensor) and g.base.is_pinned()
                 for g in got)
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g, w):
            raise AssertionError(f"in flight: SR frame {i} differs")
    mats = [warp_matrix(i) for i in range(8)]
    want = [pred.warp(f, m, WARP_OUT) for f, m in zip(frames, mats)]
    futs = [pred.warp_dynamic_async(f, m, WARP_OUT)
            for f, m in zip(frames, mats)]
    for i, (f, w) in enumerate(zip(futs, want)):
        out, mask = f.result()
        if not (np.array_equal(out, w[0]) and np.array_equal(mask, w[1])):
            raise AssertionError(f"in flight: warp frame {i} differs")
    scales = [2.0 + 0.25 * i for i in range(8)]
    want = [pred.upscale(f, s, s) for f, s in zip(frames, scales)]
    size = pipeline.SERVING_CACHE_SIZE
    pipeline.SERVING_CACHE_SIZE = 2
    try:
        futs = [pred.upscale_dynamic_async(f, s, s)
                for f, s in zip(frames, scales)]
        kept = len(pred._serving_cache)
        for i, (f, w) in enumerate(zip(futs, want)):
            if not np.array_equal(f.result(), w):
                raise AssertionError(f"after eviction: frame {i} differs")
    finally:
        pipeline.SERVING_CACHE_SIZE = size
    if kept != 2:
        raise AssertionError(f"the serving cache kept {kept} entries, not 2")
    emit({"phase": "pinned_reuse", "in_flight": len(frames),
          "sr_and_warp_bit_equal": True, "evicted_in_flight": len(scales),
          "cache_entries": kept, "results_view_pinned_tensors": pinned})


def stream_phase(pred, rng):
    """Phase 34: ``stream_upscale`` and ``stream_warp`` over SERVE_FRAMES
    frames at each depth against the sequential loop, in alternating
    rounds: each result bit-equal to the sequential one; ms a frame, the
    device ms a frame (torch.profiler over the sequential loop: kernels
    and copies, the same work at every depth) and the busy share (device
    over wall)."""
    from lerf_torch.serve import stream_upscale, stream_warp

    frames = [rng.randint(0, 256, (LR_H, LR_W, 3)).astype(np.uint8)
              for _ in range(SERVE_FRAMES)]
    mats = [warp_matrix(i) for i in range(SERVE_FRAMES)]
    sr_reqs = [(f, SCALE, SCALE) for f in frames]
    warp_reqs = list(zip(frames, mats))
    runs = {("upscale", 0): lambda: [pred.upscale_dynamic(*r)
                                     for r in sr_reqs],
            ("warp", 0): lambda: [pred.warp_dynamic(f, m, WARP_OUT)
                                  for f, m in warp_reqs]}
    for d in SERVE_DEPTHS:
        runs["upscale", d] = lambda d=d: list(stream_upscale(
            pred, sr_reqs, depth=d))
        runs["warp", d] = lambda d=d: list(stream_warp(
            pred, warp_reqs, WARP_OUT, depth=d))
    ref = {kind: runs[kind, 0]() for kind in ("upscale", "warp")}

    def same(a, b):
        if isinstance(a, tuple):
            return all(np.array_equal(x, y) for x, y in zip(a, b))
        return np.array_equal(a, b)

    for run in runs.values():   # the pinned blocks a run's results hold
        run()
    order = (0,) + SERVE_DEPTHS
    times = {key: [] for key in runs}
    for r in range(SERVE_ROUNDS):
        for kind in ("upscale", "warp"):
            for d in (order if r % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                outs = runs[kind, d]()
                times[kind, d].append((time.perf_counter() - t0) * 1e3
                                      / SERVE_FRAMES)
                if len(outs) != SERVE_FRAMES or not all(
                        same(a, b) for a, b in zip(outs, ref[kind])):
                    raise AssertionError(f"stream {kind} depth {d}: not "
                                         "bit-equal to the sequential loop")
                del outs
    # the device's work a frame is the same at every depth: profiled once
    profs = {kind: profile_frames(runs[kind, 0], frames=1)
             for kind in ("upscale", "warp")}
    rows = {}
    for (kind, d), ts in times.items():
        prof = profs[kind]
        device = prof["device_busy_ms"] / SERVE_FRAMES
        ms = statistics.median(ts)
        rows[kind, d] = ms
        emit_timed({"phase": "stream", "form": kind,
                    "depth": d or "sequential", "frames": SERVE_FRAMES,
                    "ms_per_frame_rounds": ts, "ms_per_frame": ms,
                    "device_ms_per_frame": device,
                    "busy_share": device / ms,
                    "device_ms_by_name": [
                        [k, v / SERVE_FRAMES]
                        for k, v in prof["device_ms_by_name"][:6]]})
    return rows


def pinned_stats():
    """The caching host allocator's current counts, from
    ``torch.cuda.host_memory_stats``: the pinned blocks it owns (cached or
    in use) and their bytes, and the blocks in use."""
    import torch
    stats = torch.cuda.host_memory_stats()
    keys = ("allocated_bytes.current", "allocations.current",
            "active_requests.current")
    if not all(k in stats for k in keys):
        raise AssertionError(f"host_memory_stats lacks {keys}: {sorted(stats)}")
    return {k.split(".")[0]: stats[k] for k in keys}


def pinned_retention_phase(pred, frame):
    """Phase 35: the pinned memory that kept results hold.  ``upscale``
    results (360×640 → ×4, 11 MB each) kept, one after another, until the
    caching host allocator has added PINNED_GROWTH blocks to its pool (its
    free blocks, left by earlier phases, taken first; at most PINNED_MOST
    results), then dropped, then as many calls again, each result dropped
    before the next: the pool's blocks and bytes after each leg, and the
    bytes of a block a kept result added.  A kept result holds its block;
    a dropped one returns it to the pool, which later requests reuse (the
    second leg must not grow the pool) and which is not given back to the
    system (nor may it shrink)."""
    before = pinned_stats()
    kept = []
    while (pinned_stats()["allocations"] - before["allocations"]
           < PINNED_GROWTH and len(kept) < PINNED_MOST):
        kept.append(pred.upscale(frame ^ np.uint8(len(kept) % 255 + 1),
                                 SCALE, SCALE))
    held = pinned_stats()
    n, result_bytes = len(kept), kept[0].nbytes
    del kept
    for i in range(n):
        pred.upscale(frame ^ np.uint8(i % 255 + 1), SCALE, SCALE)
    again = pinned_stats()
    added = held["allocations"] - before["allocations"]
    if added < PINNED_GROWTH:
        raise AssertionError(f"{n} kept results added {added} pinned blocks,"
                             f" not {PINNED_GROWTH}: {before} → {held}")
    if again["allocated_bytes"] != held["allocated_bytes"]:
        raise AssertionError("the pinned pool changed on calls whose results"
                             f" were dropped: {held} → {again}")
    emit({"phase": "pinned_retention", "result_bytes": result_bytes,
          "kept": n, "before": before, "kept_results": held,
          "after_as_many_dropped_calls": again, "blocks_added": added,
          "bytes_a_block_added":
          (held["allocated_bytes"] - before["allocated_bytes"]) / added})


def _http(url, body=None, ctype="application/x-npy"):
    import urllib.request
    req = urllib.request.Request(url, data=body,
                                 method="POST" if body else "GET",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read(), dict(resp.headers)


def _npy(arr):
    import io
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _load(data):
    import io
    return np.load(io.BytesIO(data), allow_pickle=False)


def client_frames(client):
    """The frames phase 36's client ``client`` sends, its own."""
    rng = np.random.RandomState(1000 + client)
    return [rng.randint(0, 256, (LR_H, LR_W, 3)).astype(np.uint8)
            for _ in range(HTTP_REQUESTS)]


def digest(arr):
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def http_client(url, client, start_at):
    """``chip_smoke.py --http-client URL CLIENT START_AT``: one of phase
    36's client processes (numpy and the standard library, no torch).
    From the wall-clock time START_AT it sends its frames to
    ``/v1/upscale?scale=4`` one after another and prints, as one JSON
    line, each response's shape, SHA-256 and ms, and its start and end."""
    time.sleep(max(0.0, start_at - time.time()))
    t_start, rows = time.time(), []
    for f in client_frames(client):
        t0 = time.perf_counter()
        out = _load(_http(url + "/v1/upscale?scale=4", _npy(f))[0])
        rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                     "shape": list(out.shape), "sha256": digest(out)})
    print(json.dumps({"client": client, "start": t_start,
                      "end": time.time(), "requests": rows}), flush=True)
    return 0


def run_clients(base, clients):
    """``clients`` client processes against the daemon at ``base``, started
    together.  → (each client's JSON line, the wall s from the common
    start to the last response)."""
    start_at = time.time() + 3.0      # past the processes' start-up
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--http-client", base,
         str(c), repr(start_at)], stdout=subprocess.PIPE, text=True)
        for c in range(clients)]
    rows = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"daemon client exit {p.returncode}")
            rows.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rows, max(r["end"] for r in rows) - start_at


def daemon_phase(pred, net_pred, frame):
    """Phase 36: the HTTP daemon on 127.0.0.1:0 in a thread, LUT form, on
    the full frame: the upscale (npy), warp (npz), batch and ``--geometry
    device`` routes, each response equal to the in-process predictor and
    each request the form's launches; one client, then (on a fresh
    daemon) HTTP_CLIENTS concurrent clients, of HTTP_REQUESTS requests
    each, each client a process of its own on frames of its own; /healthz's
    percentiles of each request part for each; one request to a net-form
    (K4) daemon."""
    import threading

    from lerf_torch.serve import make_server

    servers = []

    def start(p, **kwargs):
        server = make_server(p, port=0, **kwargs)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        return f"http://127.0.0.1:{server.server_address[1]}"

    m = warp_matrix()
    mq = ",".join(repr(float(v)) for v in m.ravel())
    size = f"{WARP_OUT[0]}x{WARP_OUT[1]}"
    try:
        base = start(pred)
        (data, head), launches = counted_run(
            lambda: _http(base + "/v1/upscale?scale=4", _npy(frame)),
            {"lut_stage": 2, "steering_resize": 1}, "daemon upscale")
        if head["Content-Type"] != "application/x-npy" or not np.array_equal(
                _load(data), pred.upscale_dynamic(frame, SCALE, SCALE)):
            raise AssertionError("daemon upscale: not the in-process frame")
        (data, _), wl = counted_run(
            lambda: _http(f"{base}/v1/warp?matrix={mq}&outSize={size}"
                          "&format=npz", _npy(frame)),
            {"lut_stage": 2, "steering_warp": 1}, "daemon warp")
        pack, want = _load(data), pred.warp_dynamic(frame, m, WARP_OUT)
        if not (np.array_equal(pack["out"], want[0])
                and np.array_equal(pack["mask"], want[1])):
            raise AssertionError("daemon warp: not the in-process frame")
        data, head = _http(f"{base}/v1/warp?matrix={mq}&outSize={size}",
                           _npy(frame))
        if not np.array_equal(_load(data),
                              want[0] * want[1][..., None].astype(np.uint8)):
            raise AssertionError("daemon warp (npy): not the masked frame")
        coverage = float(head["X-Lerf-Mask-Coverage"])
        imgs = np.stack([frame, 255 - frame])
        data, _ = _http(base + "/v1/upscale_batch?scale=4", _npy(imgs))
        if not np.array_equal(_load(data),
                              pred.upscale_batch(imgs, SCALE, SCALE)):
            raise AssertionError("daemon upscale_batch differs")
        import io
        buf = io.BytesIO()
        mats = np.stack([m, warp_matrix(1)])
        np.savez(buf, imgs=imgs, matrices=mats)
        data, _ = _http(f"{base}/v1/warp_batch?outSize={size}",
                        buf.getvalue(), "application/x-npz")
        pack, want = _load(data), pred.warp_batch(imgs, mats, WARP_OUT)
        if not (np.array_equal(pack["out"], want[0])
                and np.array_equal(pack["mask"], want[1])):
            raise AssertionError("daemon warp_batch differs")
        # one client, then concurrent clients on a fresh daemon, each in a
        # process of its own (as remote clients are: their encoding and
        # decoding off the daemon's interpreter) and on frames of its own
        want = {c: [digest(pred.upscale_dynamic(f, SCALE, SCALE))
                    for f in client_frames(c)] for c in range(HTTP_CLIENTS)}
        legs = {}
        for leg, clients in (("single", 1), ("concurrent", HTTP_CLIENTS)):
            url = start(pred)
            rows, wall_s = run_clients(url, clients)
            for r in rows:
                if [q["sha256"] for q in r["requests"]] != want[r["client"]]:
                    raise AssertionError(f"{leg} client {r['client']}: not "
                                         "its own frames")
            health = json.loads(_http(url + "/healthz")[0])
            ms = [q["ms"] for r in rows for q in r["requests"]]
            legs[leg] = {"clients": clients, "wall_s": wall_s,
                         "ms_per_request": wall_s * 1e3 / len(ms),
                         "client_ms_p50": statistics.median(ms),
                         "client_ms_max": max(ms), "served": health["served"],
                         **{k: health[k] for k in ("decode", "dispatch",
                                                   "total", "encode")}}
        dev_base = start(pred, geometry="device")
        pack = _load(_http(f"{dev_base}/v1/warp?matrix={mq}&outSize={size}"
                           "&format=npz", _npy(frame))[0])
        want = pred.warp_device(frame, m, WARP_OUT)
        if not (np.array_equal(pack["out"], want[0])
                and np.array_equal(pack["mask"], want[1])):
            raise AssertionError("daemon --geometry device differs")
        net_base = start(net_pred)
        (data, _), nl = counted_run(
            lambda: _http(net_base + "/v1/upscale?scale=4", _npy(frame)),
            {"srnet_ensemble_int8": 2, "steering_resize": 1},
            "net daemon upscale")
        if not np.array_equal(_load(data),
                              net_pred.upscale_dynamic(frame, SCALE, SCALE)):
            raise AssertionError("net daemon upscale differs")
    finally:
        for server in servers:
            server.shutdown()
            server.server_close()
    emit_timed({"phase": "daemon", "routes_equal_in_process": [
        "upscale npy", "warp npz", "warp npy masked", "upscale_batch",
        "warp_batch", "warp --geometry device", "net K4 upscale"],
        "launches_upscale": launches, "launches_warp": wl,
        "launches_net": nl, "mask_coverage": coverage,
        "requests_each": HTTP_REQUESTS, **legs})


def cli_phase(bank, rng):
    """Phase 37: ``cli.upscale`` on a directory of CLI_FILES 360×640 PNGs,
    with ``--dynamicSR`` and with ``--matrix … --dynamicWarp``: each output
    equal to the one-file call's."""
    import tempfile

    from PIL import Image

    from lerf_torch.cli import upscale as up
    from lerf_torch.lut.io import save_lut_bank

    mq = ",".join(repr(float(v)) for v in warp_matrix().ravel())
    modes = {"dynamicSR": ["--scale", "4", "--dynamicSR"],
             "dynamicWarp": ["--matrix", mq, "--outSize",
                             f"{WARP_OUT[0]}x{WARP_OUT[1]}",
                             "--dynamicWarp"]}
    secs = {}
    with tempfile.TemporaryDirectory(prefix="lerf_cli_") as root:
        exp = os.path.join(root, "exp")
        save_lut_bank(bank, exp, lut_name="LUTft")
        src = os.path.join(root, "frames")
        os.makedirs(src)
        names = [f"f{i}.png" for i in range(CLI_FILES)]
        for name in names:
            Image.fromarray(rng.randint(0, 256, (LR_H, LR_W, 3))
                            .astype(np.uint8)).save(os.path.join(src, name))
        for mode, flags in modes.items():
            dst = os.path.join(root, mode)
            t0 = time.perf_counter()
            up.main(["-e", exp, "--input", src, "--output", dst] + flags)
            secs[mode] = time.perf_counter() - t0
            for name in names:
                one = up.main(["-e", exp, "--input", os.path.join(src, name),
                               "--output", os.path.join(root, "one.png")]
                              + flags)
                got = np.array(Image.open(os.path.join(dst, name))
                               .convert("RGB"))
                if not np.array_equal(got, one):
                    raise AssertionError(f"cli {mode} {name}: not the "
                                         "one-file call's output")
    emit_timed({"phase": "cli_several_inputs", "files": CLI_FILES,
                "modes_equal_one_file_calls": sorted(modes),
                "directory_s": secs})


def resize_phase(dev, rng):
    """Phase 38: ``ops.resize`` (antialiased cubic and lanczos3 downscales,
    by_convs, an N-D spec) and ``make_benchmark.downscale`` (×4, ×2.5) on a
    1440×2560 HR frame, on the card against the CPU: float32 within
    RESIZE_ATOL, uint8 equal but for .5 ties."""
    import torch

    from lerf_torch.cli.make_benchmark import downscale, modcrop_rational
    from lerf_torch.ops import resize

    hr = rng.randint(0, 256, WARP_OUT + (3,)).astype(np.uint8)
    x = torch.from_numpy(np.ascontiguousarray(hr.transpose(2, 0, 1),
                                              np.float32))
    cases = {"cubic x1/4": {"scale_factors": [0.25, 0.25]},
             "cubic x1/2.5": {"scale_factors": [0.4, 0.4]},
             "lanczos3 x1/3": {"scale_factors": [1 / 3, 1 / 3],
                               "interp_method": "lanczos3"},
             "cubic by_convs x1/2": {"scale_factors": 0.5, "by_convs": True},
             "linear N-D": {"scale_factors": [1.0, 0.5, 0.75],
                            "interp_method": "linear"}}
    rows = {}
    for name, kwargs in cases.items():
        want = resize(x, **kwargs)
        got = resize(x.to(dev), **kwargs)
        torch.cuda.synchronize()
        err = float((got.cpu() - want).abs().max())
        if got.shape != want.shape or not err <= RESIZE_ATOL:
            raise AssertionError(f"resize {name}: card vs CPU max-abs {err}")
        rows[name] = err
    ties = {}
    for s in (4.0, 2.5):
        got = downscale(hr, s, s, device=dev)
        crop = modcrop_rational(hr, s, s)
        f32 = resize(torch.from_numpy(np.ascontiguousarray(
            crop.transpose(2, 0, 1), np.float32)),
            scale_factors=[1 / s, 1 / s]).numpy().transpose(1, 2, 0)
        want = downscale(hr, s, s, device="cpu")
        ties[str(s)] = check_ties(got, want, f32, f"make_benchmark x{s}")
    emit({"phase": "resize_on_card", "hr": list(WARP_OUT),
          "max_abs_err": rows, "atol": RESIZE_ATOL,
          "make_benchmark_u8_mismatch_at_ties": ties})


# -- phases 39-45: the multi-device slice on one card ---------------------

MESH_SHARDS = (2, 4)          # meshes [cuda:0] x 2 and x 4
BIG_H, BIG_W = 1080, 1920     # the frame size sharding is for: x2 -> 4K
DP_STEPS = 5                  # data-parallel steps held to one device's
DP_RTOL = 1e-5                # loss and every parameter, relative
MESH_TIMED = 10               # calls a timing takes (median)


def one_card_mesh(n):
    from lerf_torch.parallel import make_mesh
    return make_mesh(devices=["cuda:0"] * n)


def window_rows(n_rows, n=4):
    from lerf_torch.parallel import row_ranges
    return row_ranges(n_rows, n)


def k5_window_phase(dev, rng):
    """Phase 39: K5 on 4 windows of output rows for ``warp_matrix(0..3)``
    at supports 2 and 4, Gaussian and linear, int32 and float inputs, the
    mask written in the same launch: each window ``torch.equal`` to the
    same rows of the whole launch (frame and mask) and the mask to the
    host's rows; for ``warp_matrix(0)`` each window also against its plain
    twin (the host geometry's rows) within phase 9's tolerance (the host
    geometry of every matrix would take the phase half a minute).
    Returns the largest error."""
    import torch
    from lerf_torch.ops.geometry import WarpGeometry
    from lerf_torch.ops.kernels import warp as k5

    shape = (3, LR_H, LR_W)
    ins = {"int32": (
        torch.from_numpy(rng.randint(0, 256, shape).astype(np.int32)).to(dev),
        torch.from_numpy(rng.randint(0, 256, shape + (3,)).astype(np.int32))
        .to(dev))}
    ins["float"] = (ins["int32"][0].float(),
                    ins["int32"][1].float() / 255.0)
    worst, rows_out = 0.0, []
    t0 = time.perf_counter()
    for seed in range(4):
        matrix = warp_matrix(seed)
        host_mask = None
        for support in (2, 4):
            params = k5.WarpParams.create((LR_H, LR_W), matrix, WARP_OUT,
                                          support=support)
            geom = (WarpGeometry.create((LR_H, LR_W), matrix, WARP_OUT,
                                        support=support) if seed == 0
                    else None)
            if host_mask is None:
                host_mask = torch.from_numpy(params.host_mask())
            for linear in (False, True):
                for kind, (feat, codes) in ins.items():
                    codes = codes[..., :1] if linear else codes
                    mask = torch.empty(WARP_OUT, dtype=torch.bool, device=dev)
                    whole = k5.steering_warp(feat, codes, params,
                                             linear=linear, mask_out=mask)
                    for r0, r1 in window_rows(WARP_OUT[0]):
                        m = torch.empty((r1 - r0, WARP_OUT[1]),
                                        dtype=torch.bool, device=dev)
                        got = k5.steering_warp(feat, codes, params,
                                               linear=linear, mask_out=m,
                                               rows=(r0, r1))
                        torch.cuda.synchronize()
                        what = (f"K5 window {seed} S{support} "
                                f"{'linear' if linear else 'gauss'} {kind} "
                                f"[{r0}, {r1})")
                        if not (torch.equal(got, whole[:, r0:r1])
                                and torch.equal(m, mask[r0:r1])):
                            raise AssertionError(f"{what}: not bit-equal to "
                                                 "the whole launch's rows")
                        if not torch.equal(m.cpu(), host_mask[r0:r1]):
                            raise AssertionError(f"{what}: mask differs from "
                                                 "the host's")
                        if geom is None:
                            continue
                        want = k5._plain(feat, codes, geom.rows(r0, r1),
                                         max_sigma=10.0, norm=255,
                                         linear=linear)
                        nan = torch.isnan(want)
                        if not torch.equal(torch.isnan(got), nan):
                            raise AssertionError(f"{what}: NaN pattern")
                        err = (float((got[~nan] - want[~nan]).abs().max())
                               if bool((~nan).any()) else 0.0)
                        if not err <= K5_ATOL:
                            raise AssertionError(f"{what}: max-abs {err}")
                        worst = max(worst, err)
                    rows_out.append([seed, support, linear, kind])
    emit({"phase": "k5_window", "windows": 4, "cases": len(rows_out),
          "bit_equal_to_whole": True, "mask_equal": True,
          "max_abs_err_vs_twin": worst, "tolerance": K5_ATOL,
          "seconds": time.perf_counter() - t0})
    return worst


def k1_window_phase(dev, rng):
    """Phase 40: K1 on 4 windows of :meth:`ResizeOperands.rows_window` at
    phase 2's scales, int32 codes and float maps: each window
    ``torch.equal`` to the same rows of the whole launch and to its plain
    twin (the geometry's rows) within phase 2's tolerance.  Returns the
    largest error."""
    import torch
    from lerf_torch.ops.geometry import ResizeGeometry
    from lerf_torch.ops.kernels import resize as k1

    shape = (3, LR_H, LR_W)
    feat = torch.from_numpy(rng.randint(0, 256, shape).astype(np.int32)).to(dev)
    codes = torch.from_numpy(
        rng.randint(0, 256, shape + (3,)).astype(np.int32)).to(dev)
    ins = {"int32": (feat, codes), "float": (feat.float(),
                                             codes.float() / 255.0)}
    worst = 0.0
    for scale in (4.0, 2.5, 3.55, 0.5):
        geom = ResizeGeometry.create((LR_H, LR_W), scale_factors=[scale] * 2)
        ops = k1.ResizeOperands.create(geom, dev)
        for kind, (f, c) in ins.items():
            whole = k1.steering_resize(f, c, geom, operands=ops)
            tiles = []
            for r0, r1 in window_rows(geom.out_sz[0]):
                win = ops.rows_window(r0, r1)
                got = k1.steering_resize(f, c, geom.rows(r0, r1),
                                         operands=win)
                want = k1._plain(f, c, geom.rows(r0, r1), max_sigma=10.0,
                                 norm=255, linear=False)
                torch.cuda.synchronize()
                what = f"K1 window x{scale} {kind} [{r0}, {r1})"
                if not torch.equal(got, whole[:, r0:r1]):
                    raise AssertionError(f"{what}: not bit-equal to the "
                                         "whole launch's rows")
                err = float((got - want).abs().max())
                if not err <= K1_ATOL:
                    raise AssertionError(f"{what}: max-abs {err}")
                worst = max(worst, err)
                tiles.append(list(win.tile))
        emit({"phase": "k1_window", "scale": scale, "windows": 4,
              "tiles": tiles, "whole_tile": list(ops.tile),
              "bit_equal_to_whole": True, "max_abs_err_vs_twin": worst})
    return worst


def mesh_counted(call, want, what, n_gathers=1, n_exchanges=0):
    """:func:`counted_run` with the mesh's collectives at 0 before the
    call: raise unless they are ``n_gathers`` all-gathers and
    ``n_exchanges`` halo exchanges.  Returns (result, launches, transfers,
    collectives)."""
    from lerf_torch.parallel import mesh as pm
    pm.transfers = 0
    pm.collectives.clear()
    result, launches = counted_run(call, want, what)
    got = dict(pm.collectives)
    expect = {k: v for k, v in (("all_gather_rows", n_gathers),
                                ("exchange_halos", n_exchanges)) if v}
    if got != expect:
        raise AssertionError(f"{what}: collectives {got}, want {expect}")
    return result, launches, pm.transfers, got


def sharded_lut_phase(dev, bank, frame):
    """Phase 41: the sharded LUT pipelines at full width (360x640 RGB x4,
    the LeRF-G deploy bank) on [cuda:0] x 2 and x 4: SR, warp (frame and
    mask), dynamic SR and warp and the device-geometry warp, each
    bit-equal to its single-device form on the card, with 2 K2 and one K1
    or K5 launch a shard and ONE all-gather a call; then SR at 1080x1920
    -> x2 (a 2160x3840 output), bit-equal to ``upscale``; and the times of
    the SR and warp calls at 1, 2 and 4 shards (on one card these measure
    what sharding costs; no scale-out is claimed).  Returns the timing
    rows."""
    import torch
    from lerf_torch.ops import geometry as geo
    from lerf_torch.ops.geometry import ResizeGeometry
    from lerf_torch.ops.kernels.warp import WarpParams
    from lerf_torch.ops.resample import quantize_device
    from lerf_torch.parallel import (sharded_devgeo_warp_pipeline,
                                     sharded_dynamic_sr_pipeline,
                                     sharded_dynamic_warp_pipeline,
                                     sharded_lut_sr_pipeline,
                                     sharded_lut_warp_pipeline)
    from lerf_torch.pipeline import LutPredictor

    pred = LutPredictor(bank, device=dev)
    t1, t2 = pred._s1, pred._s2
    x = torch.from_numpy(np.ascontiguousarray(
        frame.transpose(2, 0, 1)).astype(np.int32)).to(dev)
    geom = ResizeGeometry.create((LR_H, LR_W), scale_factors=[SCALE] * 2)
    matrix = warp_matrix()
    warp = WarpParams.create((LR_H, LR_W), matrix, WARP_OUT)
    ops25 = geo.ResizeOperands.create((LR_H, LR_W), scale_factors=[2.5, 2.5])
    want_sr = pred.upscale(frame, SCALE, SCALE)
    want_warp, want_mask = pred.warp(frame, matrix, WARP_OUT)
    want_dsr = pred.upscale_dynamic(frame, 2.5, 2.5)
    want_dwarp, want_dmask = pred.warp_dynamic(frame, matrix, WARP_OUT)
    want_dev, _ = pred.warp_device(frame, matrix, WARP_OUT)
    u8 = torch.uint8

    def hwc(shards):
        return shards.to_host().transpose(1, 2, 0)

    def flat_u8(shards, out_sz):
        return quantize_device(shards.cat(), 255, nan_to_zero=True) \
            .reshape(3, *out_sz).cpu().numpy().transpose(1, 2, 0)

    for n in MESH_SHARDS:
        mesh = one_card_mesh(n)
        k1n = {"lut_stage": 2 * n, "steering_resize": n}
        k5n = {"lut_stage": 2 * n, "steering_warp": n}
        cases = [
            ("sr", lambda: hwc(sharded_lut_sr_pipeline(
                x, t1, t2, MODES, geom, mesh, out_dtype=u8)), k1n, want_sr),
            ("warp", lambda: [hwc(s) if i == 0 else s.to_host()
                              for i, s in enumerate(sharded_lut_warp_pipeline(
                                  x, t1, t2, MODES, warp, mesh,
                                  out_dtype=u8, mask=True))],
             k5n, [want_warp, want_mask]),
            ("dynamic_sr", lambda: hwc(sharded_dynamic_sr_pipeline(
                x, t1, t2, MODES, ops25, mesh, out_dtype=u8)), k1n,
             want_dsr),
            ("dynamic_warp", lambda: flat_u8(sharded_dynamic_warp_pipeline(
                x, t1, t2, MODES, warp, mesh), WARP_OUT), k5n, want_dwarp),
            ("devgeo_warp", lambda: flat_u8(sharded_devgeo_warp_pipeline(
                x, t1, t2, MODES, np.linalg.inv(matrix), WARP_OUT, mesh),
                WARP_OUT), k5n, want_dev),
        ]
        for name, call, launches, want in cases:
            got, counts, transfers, coll = mesh_counted(
                call, launches, f"sharded LUT {name} x{n}")
            wants = want if isinstance(want, list) else [want]
            gots = got if isinstance(got, list) else [got]
            for g, w in zip(gots, wants):
                if g.shape != w.shape or not np.array_equal(g, w):
                    raise AssertionError(
                        f"sharded LUT {name} x{n}: not bit-equal to the "
                        f"single-device form ({int((g != w).sum())} of "
                        f"{w.size} differ)")
            if transfers != 1 + n * (n - 1):
                raise AssertionError(f"sharded LUT {name} x{n}: transfers "
                                     f"{transfers}")
            emit({"phase": "sharded_lut", "form": name, "shards": n,
                  "bit_equal": True, "launches": counts,
                  "launches_per_shard": {k: v / n for k, v in counts.items()
                                         if v},
                  "transfers": transfers, "collectives": coll})
    # the frame size sharding is for: 1080x1920 -> x2, a 2160x3840 output
    big = np.random.RandomState(5).randint(0, 256, (BIG_H, BIG_W, 3)) \
        .astype(np.uint8)
    xb = torch.from_numpy(np.ascontiguousarray(
        big.transpose(2, 0, 1)).astype(np.int32)).to(dev)
    geom2 = ResizeGeometry.create((BIG_H, BIG_W), scale_factors=[2.0, 2.0])
    want_big = pred.upscale(big, 2.0, 2.0)
    for n in MESH_SHARDS:
        mesh = one_card_mesh(n)
        got, counts, transfers, _ = mesh_counted(
            lambda: hwc(sharded_lut_sr_pipeline(xb, t1, t2, MODES, geom2,
                                                mesh, out_dtype=u8)),
            {"lut_stage": 2 * n, "steering_resize": n},
            f"sharded LUT sr 4K x{n}")
        if not np.array_equal(got, want_big):
            raise AssertionError(f"sharded LUT sr 4K x{n}: not bit-equal to "
                                 "upscale")
        emit({"phase": "sharded_lut", "form": "sr_4k", "shards": n,
              "in": [BIG_H, BIG_W], "out": list(want_big.shape[:2]),
              "bit_equal": True, "launches": counts,
              "transfers": transfers})

    # times: the whole call (to a host array) and its device part
    rows = []
    for label, size, xin, g in (("sr", (LR_H, LR_W), x, geom),
                                ("sr_4k", (BIG_H, BIG_W), xb, geom2),
                                ("warp", (LR_H, LR_W), x, warp)):
        for n in (1,) + MESH_SHARDS:
            mesh = one_card_mesh(n)
            if label == "warp":
                def part(mesh=mesh):
                    return sharded_lut_warp_pipeline(
                        xin, t1, t2, MODES, warp, mesh, out_dtype=u8)
            else:
                def part(mesh=mesh, xin=xin, g=g):
                    return sharded_lut_sr_pipeline(
                        xin, t1, t2, MODES, g, mesh, out_dtype=u8)
            call_ms = host_call_ms(lambda: part().to_host(), MESH_TIMED)
            dev_ms = frame_ms(part, frames=MESH_TIMED)
            row = {"phase": "sharded_lut_timing", "form": label,
                   "shards": n, "in": list(size), "call_ms": call_ms,
                   "device_ms": dev_ms,
                   "note": "one card: the cost of sharding, not scale-out"}
            emit_timed(row)
            rows.append(row)
    # the unsharded predictor's whole calls beside them
    for label, call in (("sr", lambda: pred.upscale(frame, SCALE, SCALE)),
                        ("sr_4k", lambda: pred.upscale(big, 2.0, 2.0)),
                        ("warp", lambda: pred.warp(frame, matrix, WARP_OUT))):
        emit_timed({"phase": "sharded_lut_timing", "form": label,
                    "predictor_call_ms": host_call_ms(call, MESH_TIMED)})
    return rows


def sharded_net_phase(dev, params, frame):
    """Phase 42: the sharded net form on [cuda:0] x 2 and x 4: K4
    ``sharded_net_sr_pipeline`` on the full frame and the K3 form on a
    96x160 crop, each against the single-device predictor on the card:
    feature and hyper codes within the net gates (1 level on < 0.5 %), the
    frame equal where the stages are; K3 or K4 twice and K1 once a shard,
    one all-gather a call."""
    import torch
    from lerf_torch.ops.geometry import ResizeGeometry
    from lerf_torch.parallel import sharded_net_sr_pipeline, srnet_stages_sharded
    from lerf_torch.pipeline import NetPredictor

    for backend, img, kern in (("pallas_int8", frame, "srnet_ensemble_int8"),
                               ("auto", frame[:CROP_H, :CROP_W],
                                "srnet_ensemble")):
        pred = NetPredictor.from_srnets(params, backend=backend, device=dev)
        h, w = img.shape[:2]
        want, feat_w, hyper_w = pred.upscale(img, SCALE, SCALE,
                                             return_aux=True)
        x = torch.from_numpy(np.ascontiguousarray(
            img.transpose(2, 0, 1)).astype(np.int32)).to(dev)
        geom = ResizeGeometry.create((h, w), scale_factors=[SCALE] * 2)
        for n in MESH_SHARDS:
            mesh = one_card_mesh(n)
            feat, hyper = srnet_stages_sharded(x, params, mesh,
                                               backend=backend)
            fd = level_diff(feat.cat().cpu(), torch.from_numpy(feat_w),
                            NET_STAGE_TOL, f"sharded net {backend} feat")
            hd = level_diff(torch.round(hyper.cat().cpu() * 255),
                            torch.round(torch.from_numpy(hyper_w) * 255),
                            NET_STAGE_TOL, f"sharded net {backend} hyper")
            got, counts, transfers, _ = mesh_counted(
                lambda: sharded_net_sr_pipeline(
                    x, params, geom, mesh, backend=backend,
                    out_dtype=torch.uint8).to_host().transpose(1, 2, 0),
                {kern: 2 * n, "steering_resize": n},
                f"sharded net {backend} x{n}")
            n_diff = int((got != want).sum())
            if fd[0] == 0 and hd[0] == 0 and n_diff:
                raise AssertionError(f"sharded net {backend} x{n}: stages "
                                     "equal, frames differ")
            emit({"phase": "sharded_net", "backend": backend, "shards": n,
                  "in": [h, w], "feat_level_diff": fd, "hyper_level_diff": hd,
                  "frame_mismatch": n_diff, "launches": counts,
                  "transfers": transfers})


def sharded_imdn_phase(dev, frame):
    """Phase 43: the IMDN form (nf 12), backends base and s2d, on [cuda:0]
    x 2 and x 4: the band form (replicated input, 44-row halos) and the
    exchange form (the input row-sharded, ONE halo exchange: 2 neighbour
    transfers across each interior boundary, no all-gather) against the
    single-device towers, feature within 1e-3 and hyper maps within 1e-5;
    the SR pipeline's frame within one level on <= 0.1 %."""
    import torch
    from lerf_torch.ops.geometry import ResizeGeometry
    from lerf_torch.models.imdn_s2d import tower_halo_rows
    from lerf_torch.parallel import (RowShards, imdn_stages_sharded,
                                     imdn_stages_sharded_exchange, row_ranges,
                                     sharded_imdn_sr_pipeline)
    from lerf_torch.pipeline import NetPredictor

    model = imdn_model()
    x = torch.from_numpy(np.ascontiguousarray(
        frame.transpose(2, 0, 1)).astype(np.float32)).to(dev)
    geom = ResizeGeometry.create((LR_H, LR_W), scale_factors=[SCALE] * 2)
    for backend in ("base", "s2d"):
        pred = NetPredictor.from_imdn(model, backend=backend, device=dev)
        want, feat_w, hyper_w = pred.upscale(frame, SCALE, SCALE,
                                             return_aux=True)
        feat_w, hyper_w = torch.from_numpy(feat_w), torch.from_numpy(hyper_w)
        for n in MESH_SHARDS:
            mesh = one_card_mesh(n)
            for form in ("band", "exchange"):
                if form == "band":
                    call = (lambda: imdn_stages_sharded(
                        x, model, mesh, backend=backend))
                    gathers, exchanges = 0, 0
                else:
                    ranges = row_ranges(LR_H, n)
                    slabs = RowShards([x[:, r0:r1] for r0, r1 in ranges],
                                      ranges, LR_H)
                    call = (lambda: imdn_stages_sharded_exchange(
                        slabs, model, mesh, backend=backend))
                    gathers, exchanges = 0, 1
                (feat, hyper), counts, transfers, coll = mesh_counted(
                    call, {}, f"sharded IMDN {backend} {form} x{n}",
                    n_gathers=gathers, n_exchanges=exchanges)
                fe = float((feat.cat().cpu() - feat_w).abs().max())
                he = float((hyper.cat().cpu() - hyper_w).abs().max())
                if not (fe <= IMDN_FEAT_ATOL and he <= IMDN_HYPER_ATOL):
                    raise AssertionError(
                        f"sharded IMDN {backend} {form} x{n}: feat {fe}, "
                        f"hyper {he}")
                if form == "exchange" and transfers != 1 + 2 * (n - 1):
                    raise AssertionError(f"sharded IMDN exchange x{n}: "
                                         f"transfers {transfers}")
                emit({"phase": "sharded_imdn", "backend": backend,
                      "form": form, "shards": n,
                      "halo_rows": 2 * tower_halo_rows(),
                      "feat_max_abs": fe, "hyper_max_abs": he,
                      "transfers": transfers, "collectives": coll})
            got, counts, transfers, _ = mesh_counted(
                lambda: sharded_imdn_sr_pipeline(
                    x, model, geom, mesh, backend=backend,
                    out_dtype=torch.uint8).to_host().transpose(1, 2, 0),
                {"steering_resize": n}, f"sharded IMDN SR {backend} x{n}")
            d = np.abs(got.astype(int) - want.astype(int))
            share = float((d > 0).mean())
            if d.max() > 1 or share > IMDN_U8_SHARE:
                raise AssertionError(f"sharded IMDN SR {backend} x{n}: max "
                                     f"{d.max()}, share {share}")
            emit({"phase": "sharded_imdn_sr", "backend": backend,
                  "shards": n, "frame_max_level": int(d.max()),
                  "frame_share": share, "launches": counts,
                  "transfers": transfers})


def mesh_batch_phase(dev, bank, params, frame):
    """Phase 44: ``upscale_batch`` of 4 frames on mesh predictors over
    [cuda:0] x 2 and x 4, the LUT form and the net form on K4: each frame
    bit-equal to ``upscale``, 2 K2 (K4) and 1 K1 launches a shard, no
    collective."""
    from lerf_torch.parallel import mesh as pm
    from lerf_torch.pipeline import LutPredictor, NetPredictor

    frames = np.stack([frame, frame[::-1], frame[:, ::-1],
                       frame[::-1, ::-1]])
    for form, stage in (("lut", "lut_stage"), ("net_k4",
                                               "srnet_ensemble_int8")):
        for n in MESH_SHARDS:
            mesh = one_card_mesh(n)
            pred = (LutPredictor(bank, mesh=mesh) if form == "lut" else
                    NetPredictor.from_srnets(params, backend="pallas_int8",
                                             mesh=mesh))
            pm.collectives.clear()
            got, counts = counted_run(
                lambda: pred.upscale_batch(frames, SCALE, SCALE),
                {stage: 2 * n, "steering_resize": n},
                f"mesh upscale_batch {form} x{n}")
            if pm.collectives:
                raise AssertionError(f"mesh upscale_batch {form}: "
                                     f"collectives {dict(pm.collectives)}")
            for b in range(len(frames)):
                if not np.array_equal(got[b], pred.upscale(frames[b], SCALE,
                                                           SCALE)):
                    raise AssertionError(f"mesh upscale_batch {form} x{n}: "
                                         f"frame {b} differs from upscale")
            ms = host_call_ms(lambda: pred.upscale_batch(frames, SCALE,
                                                         SCALE), 5)
            emit_timed({"phase": "mesh_upscale_batch", "form": form,
                        "shards": n, "frames": len(frames),
                        "bit_equal_per_frame": True, "launches": counts,
                        "call_ms": ms})


def dp_train_phase(dev, cfg):
    """Phase 45: data-parallel training, 5 LeRF-G steps (batch 16, crop
    48, nf 64) on [cuda:0] x 2 against the single-device step from the
    same state and batches: each step's loss within 1e-5 relative and
    every parameter within 1e-5 of the params' largest magnitude after the
    steps (the reduction's order differs; the largest errors printed,
    each leaf's against its own largest value beside), one K1 and one K6
    launch a shard a step.  Returns the launches."""
    import torch
    from lerf_torch.data.div2k import DIV2K
    from lerf_torch.train import loop
    from lerf_torch.train import train_step as ts
    from lerf_torch.train.train_step import param_leaves

    hp = loop.hparams_from_config(cfg)
    geom = ts.train_geometry(hp)
    init = loop.srnets_adapter(cfg, hp, dev).init_params
    dataset = DIV2K(cfg.train_dir, cfg.scale_value, cfg.crop_size,
                    in_c=cfg.in_c, seed=4)
    batches = [tuple(torch.from_numpy(a).to(dev)
                     for a in dataset.batch(TRAIN_BATCH))
               for _ in range(DP_STEPS)]
    n = 2
    runs = {}
    for name, mesh in (("one", None), ("dp", one_card_mesh(n))):
        state = ts.TrainState.create(init(torch.Generator().manual_seed(0)),
                                     hp)
        step = ts.make_train_step(geom, hp, device=dev, mesh=mesh)
        losses = []
        want = {} if mesh is None else {"steering_resize": n * DP_STEPS,
                                        "steering_resize_bwd": n * DP_STEPS}
        if mesh is None:
            want = {"steering_resize": DP_STEPS,
                    "steering_resize_bwd": DP_STEPS}

        def run():
            nonlocal state
            for im, lb in batches:
                state, m = step(state, im, lb)
                losses.append(float(m["loss"]))
            return state

        _, counts = counted_run(run, want, f"train step {name}")
        runs[name] = (losses, {k: p.detach().cpu() for k, p in
                               param_leaves(state.params).items()}, counts)
        ms = frame_ms(lambda: step(state, *batches[0]), frames=5, warmup=1)
        emit_timed({"phase": "dp_train_step_ms", "form": name,
                    "shards": 1 if mesh is None else n, "step_ms": ms})
    (l1, p1, _), (l2, p2, counts) = runs["one"], runs["dp"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l2, l1))
    scale = max(float(p.abs().max()) for p in p1.values())
    diffs = {k: float((p2[k] - p1[k]).abs().max()) for k in p1}
    param_err = max(diffs.values()) / scale
    # each leaf against its own largest value, for the record: a leaf of
    # small values (a bias Adam has moved ~lr a step from 0) reads the
    # step's sign-like updates of near-zero gradients, not the sums' order
    leaf, leaf_err = max(((k, diffs[k] / max(float(p1[k].abs().max()),
                                               1e-30)) for k in p1),
                         key=lambda kv: kv[1])
    if not (loss_err <= DP_RTOL and param_err <= DP_RTOL):
        raise AssertionError(f"data-parallel step: loss {loss_err}, params "
                             f"{param_err} relative > {DP_RTOL}")
    emit({"phase": "dp_train", "shards": n, "steps": DP_STEPS,
          "batch": TRAIN_BATCH, "crop": TRAIN_CROP, "nf": NF,
          "loss_rel_err": loss_err, "param_rel_err": param_err,
          "param_max_abs_err": max(diffs.values()), "param_scale": scale,
          "worst_leaf_own_rel": [leaf, leaf_err],
          "tolerance": DP_RTOL, "launches": counts,
          "launches_per_shard_step": {k: v / (n * DP_STEPS)
                                      for k, v in counts.items() if v}})
    return counts


def bf16_of(params):
    """The params' leaves rounded to bf16 (to nearest even): the heads
    whose compute type lerf_tpu's K3 takes as bf16."""
    import torch
    return {sk: {name: {k: v.to(torch.bfloat16) for k, v in head.items()}
                 for name, head in heads.items()}
            for sk, heads in params.items()}


def k3_bf16_phase(dev, params, rng, log, first):
    """Phase 46: K3's bf16 instance against its twin at the stage shapes
    (its first design's share beside), ptxas rows of both designs' every
    instance, the kernel and its first design in alternating rounds by
    events and by the profiler, the twin's time, the bound and share, and
    the weight bytes a frame each design implies it reads from L2
    (``k3_bf16_l2_bytes``).  Returns the summary for the kernels line."""
    import torch
    from lerf_torch.models import srnet
    from lerf_torch.ops.kernels import srnet_ensemble as k3

    for row in ptxas_rows(log) + ptxas_rows(first.log):
        if "bf16" in row["function"]:
            emit(row)
    members = srnet.stage_members(MODES)
    codes = torch.from_numpy(rng.randint(0, 256, (3, LR_H, LR_W))
                             .astype(np.int32)).to(dev)
    x = codes.to(torch.float32) / 255.0
    out = {"err": 0.0, "share": 0.0, "ms": 0.0, "profiler_ms": 0.0,
           "first_ms": 0.0, "first_profiler_ms": 0.0, "graph_ms": 0.0,
           "first_graph_ms": 0.0, "plain_ms": 0.0,
           "bytes": 0, "macs": 0, "bound_ms": 0.0,
           "implied_l2_weight_bytes": 0, "first_implied_l2_weight_bytes": 0}
    for stage, oc in (("stage1", 1), ("stage2", 3)):
        heads = (srnet.stage1_heads(params, 0, MODES) if oc == 1
                 else srnet.stage2_heads(params, MODES))
        sh = k3.StackedHeads.create(heads, dev)
        if sh.dtype != torch.bfloat16:
            raise AssertionError("bf16 heads stacked as " + str(sh.dtype))

        def kern():
            return k3.ensemble_sum(x, sh, members, half=127)

        def first_fn():
            return first(x, sh, members, 127)

        def plain():
            return k3.ensemble_sum_plain(x, sh, members, half=127)

        got, want, old = kern(), plain(), first_fn()
        torch.cuda.synchronize()
        err, share = level_diff(got, want, K3_BF16_TOL, f"K3 bf16 {stage}")
        first_err, first_share = level_diff(old, want, K3_BF16_TOL,
                                            f"K3 bf16 first design {stage}")
        del got, want, old
        timing = bf16_against_first(kern, first_fn)
        plain_ms = event_ms(plain, iters=2, warmup=1)
        nbytes, macs = k3_work(codes.numel(), oc, len(members),
                               weight_bytes=2)
        b_ms, b_by, parts = k3_bf16_bound(nbytes, macs)
        l2 = k3_bf16_l2_bytes(codes.numel(), sh,
                              k3.tile_pixels(NF, torch.bfloat16))
        l2_first = k3_bf16_l2_bytes(codes.numel(), sh, 128)
        emit_timed({"phase": "k3_bf16", "stage": stage,
                    "shape": [3, LR_H, LR_W], "oc": oc, "nf": NF,
                    "max_abs_err": err, "share_differing": share,
                    "first_max_abs_err": first_err,
                    "first_share_differing": first_share,
                    "tolerance": list(K3_BF16_TOL), **timing,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "bound_parts_ms": parts,
                    "share_of_bound": b_ms / timing["ms"],
                    "first_share_of_bound": b_ms / timing["first_ms"],
                    "tile_pixels": k3.tile_pixels(NF, torch.bfloat16),
                    "implied_l2_weight_bytes": l2,
                    "first_implied_l2_weight_bytes": l2_first})
        out["err"] = max(out["err"], err)
        out["share"] = max(out["share"], share)
        for k in ("ms", "first_ms", "graph_ms", "first_graph_ms",
                  "profiler_ms", "first_profiler_ms"):
            out[k] = (out[k] + timing[k] if out[k] is not None
                      and timing[k] is not None else None)
        out["plain_ms"] += plain_ms
        out["bytes"] += nbytes
        out["macs"] += macs
        out["implied_l2_weight_bytes"] += l2
        out["first_implied_l2_weight_bytes"] += l2_first
    out["bound_ms"], out["bound_by"], _ = k3_bf16_bound(out["bytes"],
                                                        out["macs"])
    emit_timed({"phase": "k3_bf16_frame", "nf": NF, "ms": out["ms"],
                "profiler_ms": out["profiler_ms"],
                "graph_ms": out["graph_ms"], "first_ms": out["first_ms"],
                "first_profiler_ms": out["first_profiler_ms"],
                "first_graph_ms": out["first_graph_ms"],
                "bound_ms": out["bound_ms"],
                "share_of_bound": out["bound_ms"] / out["ms"],
                "implied_l2_weight_bytes": out["implied_l2_weight_bytes"],
                "first_implied_l2_weight_bytes":
                    out["first_implied_l2_weight_bytes"]})
    return out


def bf16_net_phase(dev, params, frame, k3_row, k1_bound_ms, k5_bound_ms):
    """Phase 47: the bf16 net form, SR and warp, through phases 7, 8 and
    11 (the crop against the CPU's bf16 twin), and the device parts beside
    their bounds (the two bf16 stages' and K1's or K5's).  Returns the SR
    path's launch counts."""
    launches, crop, sr_ms = net_form_phases(dev, params, frame, "auto",
                                            label="bf16")
    _, warp_ms = net_warp_phases(dev, params, frame, "auto", label="bf16")
    for form, ms, b in (("upscale", sr_ms, k1_bound_ms),
                        ("warp", warp_ms, k5_bound_ms)):
        bound_ms = k3_row["bound_ms"] + b
        emit_timed({"phase": "bf16_net_bound", "form": form,
                    "device_ms": ms, "bound_ms": bound_ms,
                    "share_of_bound": bound_ms / ms, **crop})
    return launches


def wide_nf_phase(dev, rng, first):
    """Phase 48: K3 float32, K3 bf16 and K4 at nf 128 against their twins
    on a crop, their times at the stage shapes, and the launches of the nf
    128 net form on the crop; K3 bf16 as phase 46 has it (its first design
    on the crop against the twin, the two in alternating rounds by events
    and the profiler, the implied L2 weight bytes).  Returns a kernels-line
    row per instance."""
    import torch
    from lerf_torch.models import srnet
    from lerf_torch.ops.kernels import srnet_ensemble as k3
    from lerf_torch.ops.kernels import srnet_ensemble_int8 as k4
    from lerf_torch.pipeline import NetPredictor

    params = net_params(seed=2, nf=WIDE_NF)
    kinds = {"srnet_ensemble_nf128": ("auto", params),
             "srnet_ensemble_bf16_nf128": ("auto", bf16_of(params)),
             "srnet_ensemble_int8_nf128": ("pallas_int8", params)}
    qparams = srnet.quantize_lerf_params(params)
    members = srnet.stage_members(MODES)
    codes = torch.from_numpy(rng.randint(0, 256, (3, LR_H, LR_W))
                             .astype(np.int32)).to(dev)
    x = codes.to(torch.float32) / 255.0
    crop = (slice(None), slice(0, CROP_H), slice(0, CROP_W))
    rows = {}
    frame = np.ascontiguousarray(
        rng.randint(0, 256, (CROP_H, CROP_W, 3)).astype(np.uint8))
    for name, (backend, p) in kinds.items():
        pred = NetPredictor.from_srnets(p, backend=backend)
        _, launches = counted_run(
            lambda: pred.upscale(frame, SCALE, SCALE),
            {"steering_resize": 1, **net_stage_launches(p, backend)},
            f"{name} on the nf 128 crop")
        row = {"launches": launches[name.replace("_nf128", "")],
               "err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        parts = []
        for stage, oc in (("stage1", 1), ("stage2", 3)):
            if backend == "pallas_int8":
                heads = k4.QuantHeads.create(
                    srnet.stage1_heads(qparams, 0, MODES) if oc == 1
                    else srnet.stage2_heads(qparams, MODES), dev)
                full, tol = codes, K4_TOL

                def kern(inp, heads=heads):
                    return k4.ensemble_sum_int8(inp, heads, members,
                                                half=127)

                def plain(inp, heads=heads):
                    return k4.ensemble_sum_int8_plain(inp, heads, members,
                                                      half=127)
            else:
                heads = k3.StackedHeads.create(
                    srnet.stage1_heads(p, 0, MODES) if oc == 1
                    else srnet.stage2_heads(p, MODES), dev)
                full = x
                tol = K3_BF16_TOL if "bf16" in name else K3_TOL

                def kern(inp, heads=heads):
                    return k3.ensemble_sum(inp, heads, members, half=127)

                def plain(inp, heads=heads):
                    return k3.ensemble_sum_plain(inp, heads, members,
                                                 half=127)
            part = full[crop].contiguous()
            got, want = kern(part), plain(part)
            torch.cuda.synchronize()
            err, share = level_diff(got, want, tol, f"{name} {stage}")
            extra = {}
            if "bf16" in name:
                old = first(part, heads, members, 127)
                torch.cuda.synchronize()
                f_err, f_share = level_diff(old, want, tol,
                                            f"{name} first design {stage}")
                extra = bf16_against_first(
                    lambda: kern(full),
                    lambda: first(full, heads, members, 127), frames=3)
                extra.update(
                    first_max_abs_err=f_err, first_share_differing=f_share,
                    implied_l2_weight_bytes=k3_bf16_l2_bytes(
                        full.numel(), heads,
                        k3.tile_pixels(WIDE_NF, torch.bfloat16)),
                    first_implied_l2_weight_bytes=k3_bf16_l2_bytes(
                        full.numel(), heads, 128))
                ms = extra["ms"]
            else:
                ms = event_ms(lambda: kern(full), iters=3, warmup=1)
            plain_ms = event_ms(lambda: plain(full), iters=1, warmup=1)
            n = full.numel()
            if backend == "pallas_int8":
                b_ms, b_by, _ = k4_bound(*k4_work(n, oc, 12, nf=WIDE_NF))
            elif "bf16" in name:
                b_ms, b_by, _ = k3_bf16_bound(*k3_work(
                    n, oc, 12, nf=WIDE_NF, weight_bytes=2))
            else:
                b_ms, b_by, _ = k3_bound(*k3_work(n, oc, 12, nf=WIDE_NF))
            emit_timed({"phase": "nf128", "kernel": name, "stage": stage,
                        "nf": WIDE_NF, "oc": oc, "crop": [3, CROP_H, CROP_W],
                        "max_abs_err": err, "share_differing": share,
                        "tolerance": list(tol), "ms": ms,
                        "shape": [3, LR_H, LR_W], "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "share_of_bound": b_ms / ms,
                        "tile_pixels": (
                            k3.tile_pixels(WIDE_NF, torch.bfloat16)
                            if "bf16" in name else
                            k3.tile_pixels(WIDE_NF)
                            if name == "srnet_ensemble_nf128" else 128),
                        **extra})
            row["err"] = max(row["err"], err)
            for k in ("first_ms", "profiler_ms", "first_profiler_ms",
                      "graph_ms", "first_graph_ms"):
                if k in extra:
                    row[k] = (row.get(k, 0) + extra[k]
                              if row.get(k, 0) is not None
                              and extra[k] is not None else None)
            row["ms"] += ms
            row["plain_ms"] += plain_ms
            row["bound_ms"] += b_ms
            parts.append(b_by)
        row["bound_by"] = "operations" if "operations" in parts else "bytes"
        rows[name] = row
    return rows


def smooth_frame(seed=3):
    """A photo-like uint8 frame: a seeded uniform field, box-blurred three
    times over ``SMOOTH_BOX`` pixels on each axis and stretched to 0..255,
    so neighbouring pixels fall in the same lattice cells."""
    f = np.random.RandomState(seed).rand(LR_H, LR_W, 3)
    for _ in range(3):
        for axis in (0, 1):
            pad = [(0, 0)] * 3
            pad[axis] = (SMOOTH_BOX // 2, SMOOTH_BOX // 2)
            c = np.cumsum(np.pad(f, pad, mode="edge"), axis=axis)
            c = np.concatenate([np.zeros_like(c.take([0], axis=axis)), c],
                               axis=axis)
            n = f.shape[axis]
            f = (c.take(range(SMOOTH_BOX, SMOOTH_BOX + n), axis=axis)
                 - c.take(range(n), axis=axis)) / SMOOTH_BOX
    f = (f - f.min()) / (f.max() - f.min())
    return np.round(f * 255).astype(np.uint8)


def rows_touched(x, tables, modes, split_r):
    """Bytes of the table rows one stage reads on ``x`` (int32 [C, H, W]):
    per packed group its anchor cells, per cell-table key its members'
    cells, each distinct row once — what this frame needs of the layout."""
    import torch
    from lerf_torch.ops import lut_pipeline as lp

    xpad = lp._pad_all_sides(x)
    h, w = x.shape[-2:]
    q, B = 16, 16

    def cell_of(planes):
        iv = [p // q for p in planes]
        return ((iv[0] * B + iv[1]) * B + iv[2]) * B + iv[3]

    total = 0
    if isinstance(tables, lp.PackedTables):
        for mode in modes:
            for g in tables.groups[mode]:
                cells = []
                for delta, perm in zip(g.deltas, g.perms):
                    planes = [None] * 4
                    for k, (ci, cj) in enumerate(g.canon):
                        r0, c0 = lp.MAX_PAD + delta[0] + ci, \
                            lp.MAX_PAD + delta[1] + cj
                        planes[k] = xpad[..., r0:r0 + h, c0:c0 + w]
                    cells.append(cell_of(planes).reshape(-1))
                n = torch.unique(torch.cat(cells)).numel()
                total += n * g.table.shape[1] * g.table.element_size()
        return total
    oc = tables.table.shape[-1]
    by_key = {}
    for mode, r, key in lp.ensemble_members(modes, split_r):
        planes = lp._sample4(xpad, h, w, mode, r)
        by_key.setdefault(key, []).append(cell_of(planes).reshape(-1))
    for cells in by_key.values():
        total += torch.unique(torch.cat(cells)).numel() * 16 * oc * 4
    return total


def lut_layout_phase(dev, bank, frame, first):
    """Phase 49: K2's row mode on each table layout against flat K2, the
    twin and its first design (``first``: ``k2_rows_first_design``), the
    layouts' predictors against the flat one, then each layout's times on
    the random and the smooth frame, the row mode's beside its first
    design's by CUDA-graph replays in ``K2_ROWS_ROUNDS`` alternating
    rounds.  Returns a kernels-line row per row-mode layout."""
    import torch
    from lerf_torch.ops import lut_pipeline as lp
    from lerf_torch.ops.kernels import lut_stage as k2
    from lerf_torch.pipeline import LutPredictor

    frames = {"random": frame, "smooth": smooth_frame()}
    xs = {name: torch.from_numpy(np.ascontiguousarray(
        f.transpose(2, 0, 1)).astype(np.int32)).to(dev)
        for name, f in frames.items()}
    flat = LutPredictor(bank)
    matrix = WARP_CASES["main"][0]
    want = {name: (flat.upscale(f, SCALE, SCALE, return_aux=True),
                   flat.warp(f, matrix, WARP_OUT, return_aux=True))
            for name, f in frames.items()}
    f1 = lp.FlatTables.create(bank.stage1, dev)
    f2 = lp.FlatTables.create(bank.stage2, dev)
    flat_out = {}              # frame: flat K2's stage 1 and stage 2
    for name, x in xs.items():
        feat = lp.lut_stage1(x, f1, MODES)
        flat_out[name] = (feat, lp.lut_stage2(feat, f2, MODES))
    rows, times = {}, {}
    for layout in LAYOUTS:
        t1 = lp.stage_tables(bank.stage1, layout, MODES, split_r=False,
                             device=dev)
        t2 = lp.stage_tables(bank.stage2, layout, MODES, split_r=True,
                             device=dev)
        # both stages on both frames (stage 2 on flat stage 1's output):
        # the smooth frame's warps read their slots directly, the random
        # frame's copy them
        for name, x in xs.items() if layout != "flat" else ():
            feat, hyper = flat_out[name]
            got = {"the kernel": (lp.lut_stage1(x, t1, MODES),
                                  lp.lut_stage2(feat, t2, MODES)),
                   "the twin": (
                       lp.lut_stage_plain(x, t1, MODES, split_r=False, den=48,
                                          bias=0)[..., 0],
                       lp.lut_stage_plain(feat, t2, MODES, split_r=True,
                                          den=192, bias=127)),
                   "the first design": (
                       first(x, t1, MODES, False, 48, 0)[..., 0],
                       first(feat, t2, MODES, True, 192, 127))}
            torch.cuda.synchronize()
            for what, (g1, g2) in got.items():
                if not (torch.equal(g1, feat) and torch.equal(g2, hyper)):
                    raise AssertionError(
                        f"K2 rows ({layout}, {name} frame): {what} is not "
                        "bit-equal to flat K2")
            del got
        pred = LutPredictor(bank, table_layout=layout)
        for name, f in frames.items():
            got_sr, sr_counts = counted_run(
                lambda: pred.upscale(f, SCALE, SCALE, return_aux=True),
                {"lut_stage": 2, "steering_resize": 1},
                f"LutPredictor({layout}) upscale")
            got_w, _ = counted_run(
                lambda: pred.warp(f, matrix, WARP_OUT, return_aux=True),
                {"lut_stage": 2, "steering_warp": 1},
                f"LutPredictor({layout}) warp")
            for a, b in zip(want[name][0] + want[name][1], got_sr + got_w):
                if not np.array_equal(a, b):
                    raise AssertionError(f"LutPredictor({layout}) on the "
                                         f"{name} frame differs from flat")
        for name, xf in xs.items():
            ff = lp.lut_stage1(xf, t1, MODES)
            kernel = "lut_stage_kernel" if layout == "flat" \
                else "lut_rows_kernel"
            ms1 = event_ms(lambda: lp.lut_stage1(xf, t1, MODES), iters=50)
            ms2 = event_ms(lambda: lp.lut_stage2(ff, t2, MODES), iters=50)
            designs = {"kernel": (lambda: lp.lut_stage1(xf, t1, MODES),
                                  lambda: lp.lut_stage2(ff, t2, MODES))}
            if layout != "flat":
                designs["first"] = (
                    lambda: first(xf, t1, MODES, False, 48, 0),
                    lambda: first(ff, t2, MODES, True, 192, 127))
            graph = {d: [] for d in designs}
            for rnd in range(K2_ROWS_ROUNDS):
                for d in (list(designs) if rnd % 2 == 0
                          else list(designs)[::-1]):
                    graph[d].append(sum(graph_ms(f) for f in designs[d]))
            g_ms = statistics.mean(graph["kernel"])
            pr1 = kernel_device_ms(designs["kernel"][0], kernel, frames=10)
            pr2 = kernel_device_ms(designs["kernel"][1], kernel, frames=10)
            first_row = {}
            if layout != "flat":
                first_row = {
                    "first_graph_ms": statistics.mean(graph["first"]),
                    "first_graph_rounds": graph["first"]}
            if layout != "flat" and name == "random":
                # the profiler's window on the random frame only: the graph
                # replays hold the comparison on both
                fp = [kernel_device_ms(f, kernel, frames=10)
                      for f in designs["first"]]
                first_row.update({
                    "first_profiler_ms": (
                        fp[0]["profiler_ms"] + fp[1]["profiler_ms"]
                        if all(r["profiler_complete"] for r in fp) else None),
                    "first_profiler_launches": [r["profiler_launches"]
                                                for r in fp]})
            plain_ms = event_ms(lambda: lp.lut_stage_plain(
                xf, t1, MODES, split_r=False, den=48, bias=0), iters=1,
                warmup=1) + event_ms(lambda: lp.lut_stage_plain(
                    ff, t2, MODES, split_r=True, den=192, bias=127),
                    iters=1, warmup=1)
            if layout == "flat":
                nbytes = (k2_work(3, LR_H, LR_W, 1, 3, 12)[0]
                          + k2_work(3, LR_H, LR_W, 3, 6, 12)[0])
            else:
                nbytes = (rows_touched(xf, t1, MODES, False)
                          + rows_touched(ff, t2, MODES, True)
                          + 3 * LR_H * LR_W * 4 * (1 + 1 + 1 + 3))
            nops = (k2_work(3, LR_H, LR_W, 1, 3, 12)[1]
                    + k2_work(3, LR_H, LR_W, 3, 6, 12)[1])
            b_ms, b_by = bound(nbytes, nops)
            up_ms = host_call_ms(lambda: pred.upscale(frames[name], SCALE,
                                                      SCALE), 5)
            dev_ms = frame_ms(lambda: pred.run_device(
                xf, (SCALE, SCALE)), frames=5, warmup=2)
            complete = pr1["profiler_complete"] and pr2["profiler_complete"]
            row = {"phase": "lut_layout", "layout": layout, "frame": name,
                   "k2_ms": ms1 + ms2, "k2_stage_ms": [ms1, ms2],
                   "k2_graph_ms": g_ms, "k2_graph_rounds": graph["kernel"],
                   **first_row,
                   "profiler_ms": (pr1["profiler_ms"] + pr2["profiler_ms"]
                                   if complete else None),
                   "profiler_launches": [pr1["profiler_launches"],
                                         pr2["profiler_launches"]],
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "bytes": nbytes, "share_of_bound": b_ms / (ms1 + ms2),
                   "upscale_ms": up_ms, "device_ms": dev_ms,
                   "launches": sr_counts}
            emit_timed(row)
            times[layout, name] = row
        if layout != "flat":
            r = times[layout, "random"]
            rows[layout] = {"launches": r["launches"]["lut_stage"],
                            "ms": r["k2_ms"], "plain_ms": r["plain_ms"],
                            "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"],
                            "profiler_ms": r["profiler_ms"],
                            "graph_ms": r["k2_graph_ms"],
                            "smooth_graph_ms":
                                times[layout, "smooth"]["k2_graph_ms"],
                            "first_graph_ms": r["first_graph_ms"],
                            "first_profiler_ms": r["first_profiler_ms"],
                            "first_smooth_graph_ms":
                                times[layout, "smooth"]["first_graph_ms"]}
    # every layout timed the same way in this call, by graph replays (the
    # profiler drops rows in some windows, and events around the wrapper
    # read the host's rate at these kernel times)
    faster = {name: min(LAYOUTS,
                        key=lambda lay: times[lay, name]["k2_graph_ms"])
              for name in frames}
    emit_timed({"phase": "lut_layout_choice", "by": "graph replays",
                "fastest_k2": faster,
                "packed8_faster_on_both": all(
                    v == "packed8" for v in faster.values()),
                "default": "flat"})
    return rows


# -- phase 50: the IMDN form's bf16 compute type -----------------------------

def bf16_bits(t):
    """A bf16-valued tensor's bit patterns as int32 (nonnegative values:
    their order is the values')."""
    import torch
    return t.to(torch.bfloat16).view(torch.int16).to(torch.int32)


def held_bf16(got, got_u8, want, linear, atol, what, nan_to_zero=True):
    """A bf16 instance's float32 output ``got`` against its twin's ``want``
    (both on the card): the NaN pattern equal; the Gaussian's bf16 quotient
    within ``K_BF16_ULPS`` bf16 ulps, the linear mode's float32 one within
    ``atol``; the uint8 mode the float mode quantized.  Returns (max-abs
    error, max bf16 ulps (Gaussian; else None), values that differ, NaN
    count)."""
    import torch
    from lerf_torch.ops.resample import quantize_device

    want = want.to(torch.float32)
    nan = torch.isnan(want)
    n_nan = int(nan.sum())
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"{what}: NaN pattern "
                             f"{int(torch.isnan(got).sum())} against {n_nan}")
    g, w = got[~nan], want[~nan]
    err = float((g - w).abs().max()) if g.numel() else 0.0
    n_diff = int((g != w).sum())
    ulps = None
    if not linear:
        if not torch.equal(g, g.to(torch.bfloat16).to(torch.float32)):
            raise AssertionError(f"{what}: the quotient is not a bf16 value")
        ulps = int((bf16_bits(g) - bf16_bits(w)).abs().max()) \
            if g.numel() else 0
        if ulps > K_BF16_ULPS:
            raise AssertionError(f"{what}: {ulps} bf16 ulps > "
                                 f"{K_BF16_ULPS}")
    elif not err <= atol:
        raise AssertionError(f"{what}: max-abs {err} > {atol}")
    if got_u8.dtype != torch.uint8 or not torch.equal(
            got_u8, quantize_device(got, 255, nan_to_zero=nan_to_zero)):
        raise AssertionError(f"{what}: the uint8 mode differs from the "
                             "float mode quantized")
    return err, ulps, n_diff, n_nan


def bf16_steps_check(build):
    """The exhaustive check of the native bf16 steps, once its build
    (``start_first_build(BF16_STEPS, ...)``) is done: {step: {"mismatches":
    n, "first": [[a, b, got, want] bit patterns as hex, ...]}} over
    ``BF16_STEP_NAMES``, and the seconds the check took on the card."""
    import ctypes

    import torch

    proc, path = build
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"bf16 steps check: nvcc failed:\n{log}")
    fn = ctypes.CDLL(path).lerf_bf16_steps_exhaustive
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    n = len(BF16_STEP_NAMES)
    dev = torch.device("cuda")
    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    firsts = torch.zeros(n, 8, 4, dtype=torch.int32, device=dev)
    nfirst = torch.zeros(n, dtype=torch.int32, device=dev)
    t = time.perf_counter()
    err = fn(counts.data_ptr(), firsts.data_ptr(), nfirst.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    if err:
        raise RuntimeError(f"bf16 steps check: CUDA error {err}")
    counts, firsts, nfirst = (t.cpu().tolist()
                              for t in (counts, firsts, nfirst))
    return {name: {"mismatches": counts[s],
                   "first": [[f"{v:04x}" for v in row]
                             for row in firsts[s][:min(nfirst[s], 8)]]}
            for s, name in enumerate(BF16_STEP_NAMES)}, seconds


def bf16_kernel_phase(dev, rng):
    """Phase 50, the kernels: K1's and K5's bf16 instances (bf16 feature in
    [0, 254] and bf16 hyper maps in [0, 1], the bf16 towers' outputs)
    against their twins on the card, the port's plain resize and warp on
    the same bf16 tensors: K1 at phase 2's scales, K5 at phase 9's
    matrices with the mask (``torch.equal`` to the host's), at support 4
    on the main matrix and over 4 frames under ``warp_matrix(0..3)`` (each
    frame bit-equal to its own call, and held to its twin), both weights.
    Returns the worst errors {kernel: (max-abs, max bf16 ulps)}."""
    import torch
    from lerf_torch.ops.geometry import ResizeGeometry
    from lerf_torch.ops.kernels import resize as k1
    from lerf_torch.ops.kernels import warp as k5

    bf = torch.bfloat16
    shape = (3, LR_H, LR_W)
    inputs = {lin: tuple(t.to(bf) for t in
                         float_inputs(rng, shape, 1 if lin else 3, dev))
              for lin in (False, True)}
    worst = {"steering_resize_bf16": [0.0, 0],
             "steering_warp_bf16": [0.0, 0]}

    def note(kernel, err, ulps):
        worst[kernel][0] = max(worst[kernel][0], err)
        worst[kernel][1] = max(worst[kernel][1], ulps or 0)

    for linear in (False, True):
        feat, hyper = inputs[linear]
        for scale in (4.0, 2.5, 3.55, 0.5):
            geom = ResizeGeometry.create((LR_H, LR_W),
                                         scale_factors=[scale] * 2)
            (got, got_u8), launches = counted_run(lambda: (
                k1.steering_resize(feat, hyper, geom, linear=linear),
                k1.steering_resize(feat, hyper, geom, linear=linear,
                                   out_dtype=torch.uint8)),
                {"steering_resize": 2, "steering_resize_bf16": 2},
                f"K1 bf16 x{scale}")
            want = float_twin_resize(feat, hyper, geom, linear)
            torch.cuda.synchronize()
            err, ulps, n_diff, n_nan = held_bf16(
                got, got_u8, want, linear, K1_ATOL,
                f"K1 bf16 linear={linear} x{scale}", nan_to_zero=linear)
            note("steering_resize_bf16", err, ulps)
            emit({"phase": "k1_bf16_vs_plain", "scale": scale,
                  "linear": linear, "out": list(geom.out_sz),
                  "antialias": geom.antialias, "support": geom.support,
                  "max_abs_err": err, "max_bf16_ulps": ulps,
                  "values_differing": n_diff, "bit_equal": n_diff == 0,
                  "nan_windows": n_nan, "twin_dtype": str(want.dtype),
                  "u8_equal_to_quantized_float": True})
    # each matrix's host geometry and mask made once, for both weights
    # (the batch's first matrix is the main one)
    warps = [k5.WarpParams.create((LR_H, LR_W), warp_matrix(s), WARP_OUT)
             for s in range(4)]
    hosts = [(w.geometry(), w.host_mask()) for w in warps]
    for name, support in [(name, 2) for name in WARP_CASES] + [("main", 4)]:
        matrix, out_sz = WARP_CASES[name]
        params = k5.WarpParams.create((LR_H, LR_W), matrix, out_sz,
                                      support=support)
        geom, host_mask = (hosts[0] if params == warps[0] else
                           (params.geometry(), params.host_mask()))
        for linear in (False, True):
            feat, hyper = inputs[linear]
            mask = torch.empty(out_sz, dtype=torch.bool, device=dev)
            got = k5.steering_warp(feat, hyper, params, linear=linear,
                                   mask_out=mask)
            got_u8 = k5.steering_warp(feat, hyper, params, linear=linear,
                                      out_dtype=torch.uint8)
            want = float_twin_warp(feat, hyper, geom, linear)
            torch.cuda.synchronize()
            what = f"K5 bf16 {name} S={support} linear={linear}"
            err, ulps, n_diff, n_nan = held_bf16(got, got_u8, want, linear,
                                                 K5_ATOL, what)
            if not np.array_equal(mask.cpu().numpy(), host_mask):
                raise AssertionError(f"{what}: the mask differs from the "
                                     "host's")
            note("steering_warp_bf16", err, ulps)
            emit({"phase": "k5_bf16_vs_plain", "matrix": name,
                  "support": support, "linear": linear, "out": list(out_sz),
                  "mask_equal": True, "max_abs_err": err,
                  "max_bf16_ulps": ulps, "values_differing": n_diff,
                  "bit_equal": n_diff == 0, "nan_windows": n_nan,
                  "u8_equal_to_quantized_float": True})
    for linear in (False, True):
        feat, hyper = inputs[linear]
        feats = torch.cat([feat, feat.flip(-1), feat.flip(-2), feat * 0.5])
        hypers = torch.cat([hyper, hyper.flip(-2), hyper.flip(-3),
                            1 - hyper])
        masks = torch.empty((4,) + WARP_OUT, dtype=torch.bool, device=dev)
        (got,), launches = counted_run(lambda: (k5.steering_warp_batch(
            feats, hypers, warps, linear=linear, out_dtype=torch.uint8,
            mask_out=masks),), {"steering_warp": 1, "steering_warp_bf16": 1},
            "K5 bf16 batch of 4")
        for f, w in enumerate(warps):
            sl = slice(3 * f, 3 * f + 3)
            one = k5.steering_warp(feats[sl], hypers[sl], w, linear=linear)
            if not torch.equal(got[sl], quantize_u8(one)):
                raise AssertionError(f"K5 bf16 batch frame {f}: not "
                                     "bit-equal to its own call")
            if not np.array_equal(masks[f].cpu().numpy(), hosts[f][1]):
                raise AssertionError(f"K5 bf16 batch frame {f}: the mask "
                                     "differs from the host's")
            want = float_twin_warp(feats[sl], hypers[sl], hosts[f][0],
                                   linear)
            err, ulps, _, _ = held_bf16(
                one, got[sl], want, linear, K5_ATOL,
                f"K5 bf16 batch frame {f} linear={linear}")
            note("steering_warp_bf16", err, ulps)
        emit({"phase": "k5_bf16_batch", "frames": 4, "linear": linear,
              "launches": launches, "bit_equal_to_frames": True,
              "masks_equal": True})
    # a float32 feature with bf16 maps (the one-stage bf16 form): the maps
    # decoded in bf16, the rest float32, within the float modes' gates
    geom = ResizeGeometry.create((LR_H, LR_W), scale_factors=[SCALE] * 2)
    warp_geom = hosts[0][0]
    feat = inputs[False][0].to(torch.float32).round()
    for linear in (False, True):
        hyper = inputs[linear][1]
        for kernel, got, want, atol in (
                ("K1", k1.steering_resize(feat, hyper, geom, linear=linear),
                 float_twin_resize(feat, hyper, geom, linear), K1_ATOL),
                ("K5", k5.steering_warp(feat, hyper, warps[0],
                                        linear=linear),
                 float_twin_warp(feat, hyper, warp_geom, linear), K5_ATOL)):
            torch.cuda.synchronize()
            nan = torch.isnan(want)
            if want.dtype != torch.float32 or not torch.equal(
                    torch.isnan(got), nan):
                raise AssertionError(f"{kernel} float32 feature, bf16 maps "
                                     f"linear={linear}: type or NaNs")
            err = float((got[~nan] - want[~nan]).abs().max())
            if not err <= atol:
                raise AssertionError(f"{kernel} float32 feature, bf16 maps "
                                     f"linear={linear}: {err} > {atol}")
            emit({"phase": "bf16_maps_float_feature", "kernel": kernel,
                  "linear": linear, "max_abs_err": err})
    return worst


def imdn_bf16_model():
    """Phase 24's IMDN2 (the seed-0 ``torch.Generator`` weights) computing
    in bf16."""
    import torch
    from lerf_torch.models.imdn import IMDN2
    model = IMDN2(nf=IMDN_NF, dtype=torch.bfloat16)
    model.load_state_dict(imdn_model().state_dict())
    return model


def gate(d, tol, what):
    """``d`` (absolute differences, numpy) within ``tol`` = (max, share
    differing); returns (max, share)."""
    top, share = float(d.max()), float((d > 0).mean())
    if top > tol[0] or share > tol[1]:
        raise AssertionError(f"{what}: max {top}, share {share} against "
                             f"{tol}")
    return top, share


def towers_ms(pred, x):
    """The towers' profiler device ms a frame of ``pred.run_device(x)``
    (every device row but K1's and copies), their cuDNN convolutions'
    alone, and the towers' launches."""
    rows = device_rows(lambda: pred.run_device(x, (SCALE, SCALE)))
    towers = [r for r in rows if "steering_resize_kernel" not in r[0]
              and not r[0].startswith(("Memcpy", "Memset"))]
    conv = sum(ms for name, _, ms in towers
               if "xmma" in name or "conv" in name or "gemm" in name)
    return (sum(ms for _, _, ms in towers), conv,
            sum(n for _, n, _ in towers))


def imdn_bf16_phases(dev, frame):
    """Phase 50, the form: ``NetPredictor.from_imdn`` on the bf16 model,
    backends base and s2d, ``upscale`` ×4 and ``warp`` under
    ``warp_matrix()``: one K1 (K5) launch a call, the bf16 instance; a
    96×160 crop against the CPU path (the ``IMDN_BF16_*_TOL`` gates, the
    mask equal, the SR frame within a level of the twin resize of the
    card's own bf16 stages); the whole calls, the device parts and the
    towers' profiler time in bf16 beside the float32 towers' in the same
    call.  Then K1 and K5 bf16 alone on the towers' outputs (events,
    profiler, twin, bound).  Returns ({kernel: row}, launches of base)."""
    import torch
    from lerf_torch.models.imdn_s2d import resolve_backend
    from lerf_torch.ops.geometry import ResizeGeometry
    from lerf_torch.ops.kernels import resize as k1
    from lerf_torch.ops.kernels import warp as k5
    from lerf_torch.ops.resample import quantize_device
    from lerf_torch.pipeline import NetPredictor

    model, model32 = imdn_bf16_model(), imdn_model()
    matrix = WARP_CASES["main"][0]
    oh, ow = int(LR_H * SCALE), int(LR_W * SCALE)
    x = torch.from_numpy(np.ascontiguousarray(frame.transpose(2, 0, 1))
                         .astype(np.float32) / 255).to(dev)
    crop = np.ascontiguousarray(frame[:CROP_H, :CROP_W])
    crop_out = (int(CROP_H * SCALE), int(CROP_W * SCALE))
    # the bf16 towers' bound: the float32 image read and the bf16 feature
    # and hyper maps written once; a multiply-add a weight and pixel on
    # the tensor cores at bf16's peak
    _, macs, _ = imdn_tower_work(model32, LR_H, LR_W)
    t_bytes = (3 * 4 + (3 + 3 * model.out_c) * 2) * LR_H * LR_W \
        / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / TENSOR_BF16_OPS_PER_S * 1e3
    tower_bound = max(t_bytes, t_ops)
    sr_want = {"steering_resize": 1, "steering_resize_bf16": 1}
    warp_want = {"steering_warp": 1, "steering_warp_bf16": 1}
    launches = {}
    for backend in ("base", "s2d"):
        pred = NetPredictor.from_imdn(model, backend=backend)
        (out, feat, hyper), sr = counted_run(
            lambda: pred.upscale(frame, SCALE, SCALE, return_aux=True),
            sr_want, f"IMDN bf16 upscale ({backend})")
        if (out.shape != (oh, ow, 3) or out.dtype != np.uint8
                or feat.dtype != torch.bfloat16
                or hyper.dtype != torch.bfloat16
                or tuple(feat.shape) != (3, LR_H, LR_W)
                or tuple(hyper.shape) != (3, LR_H, LR_W, 3)
                or not (bool(torch.isfinite(feat).all())
                        and bool(torch.isfinite(hyper).all()))
                or float(feat.min()) < 0 or float(feat.max()) > 254
                or float(hyper.min()) < 0 or float(hyper.max()) > 1):
            raise AssertionError(f"IMDN bf16 upscale ({backend}): output "
                                 f"{out.shape}, feat {feat.dtype} "
                                 f"{tuple(feat.shape)}, hyper {hyper.dtype} "
                                 "out of type, shape or range")
        (wout, wmask), wl = counted_run(
            lambda: pred.warp(frame, matrix, WARP_OUT), warp_want,
            f"IMDN bf16 warp ({backend})")
        if (wout.shape != WARP_OUT + (3,) or wout.dtype != np.uint8
                or wmask.shape != WARP_OUT or not wmask.any()):
            raise AssertionError(f"IMDN bf16 warp ({backend}): output "
                                 f"{wout.shape}, mask {wmask.shape}")
        launches[backend] = {"upscale": sr, "warp": wl}

        got = pred.upscale(crop, SCALE, SCALE, return_aux=True)
        got_w = pred.warp(crop, matrix, crop_out)
        t_cpu = time.perf_counter()
        cpu = NetPredictor.from_imdn(model, backend=backend, device="cpu")
        ref = cpu.upscale(crop, SCALE, SCALE, return_aux=True)
        ref_w = cpu.warp(crop, matrix, crop_out)
        cpu_s = time.perf_counter() - t_cpu
        what = f"IMDN bf16 crop ({backend})"
        fe = gate(np.abs(got[1].float().numpy() - ref[1].float().numpy()),
                  IMDN_BF16_FEAT_TOL, what + " feat")
        he = gate(np.abs(got[2].float().numpy() - ref[2].float().numpy()),
                  IMDN_BF16_HYPER_TOL, what + " hyper")
        ue = gate(np.abs(got[0].astype(int) - ref[0].astype(int)),
                  IMDN_BF16_U8_TOL, what + " upscale")
        we = gate(np.abs(got_w[0].astype(int) - ref_w[0].astype(int)),
                  IMDN_BF16_U8_TOL, what + " warp")
        if not np.array_equal(got_w[1], ref_w[1]):
            raise AssertionError(f"{what}: the warp's mask differs")
        geom = ResizeGeometry.create((CROP_H, CROP_W),
                                     scale_factors=[SCALE] * 2)
        twin = quantize_device(float_twin_resize(got[1], got[2], geom,
                                                 False), 255)
        d = np.abs(got[0].astype(int)
                   - twin.numpy().transpose(1, 2, 0).astype(int))
        if d.max() > 1:
            raise AssertionError(f"{what}: the SR frame {d.max()} levels "
                                 "off the twin resize of its own stages")
        emit({"phase": "imdn_bf16_end_to_end", "backend": backend,
              "resolved": resolve_backend(backend), "nf": IMDN_NF,
              "dtype": "bfloat16", "in": [LR_H, LR_W], "out": [oh, ow],
              "warp_out": list(WARP_OUT), "launches": launches[backend],
              "aux_dtype": str(feat.dtype), "crop": [CROP_H, CROP_W],
              "feat_max_share": fe, "hyper_max_share": he,
              "upscale_u8_max_share": ue, "warp_u8_max_share": we,
              "tolerance": {"feat": IMDN_BF16_FEAT_TOL,
                            "hyper": IMDN_BF16_HYPER_TOL,
                            "u8": IMDN_BF16_U8_TOL},
              "warp_mask_equal": True,
              "sr_u8_pixels_off_own_twin": int((d > 0).sum()),
              "cpu_reference_s": cpu_s})

        pred32 = NetPredictor.from_imdn(model32, backend=backend)
        mp = oh * ow / 1e6
        upscale_ms = host_call_ms(lambda: pred.upscale(frame, SCALE, SCALE),
                                  10)
        device_ms = frame_ms(lambda: pred.run_device(x, (SCALE, SCALE)),
                             frames=10, warmup=2)
        warp_ms = host_call_ms(lambda: pred.warp(frame, matrix, WARP_OUT), 10)
        warp_device_ms = frame_ms(
            lambda: pred.run_warp_device(x, matrix, WARP_OUT), frames=10,
            warmup=2)
        device32_ms = frame_ms(lambda: pred32.run_device(x, (SCALE, SCALE)),
                               frames=10, warmup=2)
        t16, c16, n16 = towers_ms(pred, x)
        t32, c32, n32 = towers_ms(pred32, x)
        emit_timed({"phase": "imdn_bf16_timing", "backend": backend,
                    "frames": 10, "upscale_ms": upscale_ms,
                    "upscale_mps": mp / upscale_ms * 1e3,
                    "device_ms": device_ms, "warp_ms": warp_ms,
                    "warp_device_ms": warp_device_ms,
                    "float32_device_ms_same_call": device32_ms,
                    "towers_profiler_ms": {"bf16": t16, "float32": t32},
                    "towers_conv_profiler_ms": {"bf16": c16,
                                                "float32": c32},
                    "towers_launches": {"bf16": n16, "float32": n32},
                    "towers_bf16_bound_ms": tower_bound,
                    "towers_bf16_bound_by": ("bytes" if t_bytes >= t_ops
                                             else "operations"),
                    "towers_bf16_share_of_bound": tower_bound / t16
                    if t16 else None})
        if backend == "base":
            emit_timed(profile_frames(
                lambda: pred.upscale(frame, SCALE, SCALE), frames=5,
                form="imdn_bf16", backend=backend))

    # K1 and K5 bf16 alone on the bf16 towers' outputs, uint8 mode
    pred = NetPredictor.from_imdn(model)
    feat, hyper = pred._stages(x)
    hyper = hyper.contiguous()
    geom = ResizeGeometry.create((LR_H, LR_W), scale_factors=[SCALE] * 2)
    ops = k1.ResizeOperands.create(geom, dev)
    params = k5.WarpParams.create((LR_H, LR_W), matrix, WARP_OUT)
    warp_geom = params.geometry()
    u8 = torch.uint8
    fns = {"steering_resize_bf16": (
               lambda: k1.steering_resize(feat, hyper, geom, operands=ops,
                                          out_dtype=u8),
               lambda: quantize_device(float_twin_resize(feat, hyper, geom,
                                                         False), 255),
               "steering_resize_kernel",
               bound(*k1_work(geom, 3, floats=True, value_bytes=2))),
           "steering_warp_bf16": (
               lambda: k5.steering_warp(feat, hyper, params, out_dtype=u8),
               lambda: quantize_u8(float_twin_warp(feat, hyper, warp_geom,
                                                   False)),
               "steering_warp_kernel",
               k5_bound(*k5_work((LR_H, LR_W), WARP_OUT, 3, floats=True,
                                 value_bytes=2))[:2])}
    rows = {}
    for name, (fn, plain, key, (b_ms, b_by)) in fns.items():
        ms = event_ms(fn, iters=50)
        r = {"kernel": name, "inputs": "bf16", "out_dtype": "uint8",
             "ms": ms, **kernel_device_ms(fn, key),
             "plain_ms": event_ms(plain, iters=3, warmup=1),
             "bound_ms": b_ms, "bound_by": b_by,
             "share_of_bound": b_ms / ms}
        emit_timed(r)
        rows[name] = r
    return rows, launches["base"]


# -- 51. the warp's geometry as data: K5's rings instance --------------------

RINGS_ROUNDS = 4            # alternating graph-replay rounds, rings / matrix
RINGS_NUMPY_CALLS = 2       # the numpy host precompute is slow: 2 calls
RINGS_NATIVE_CALLS = 5


def distortion_grid(in_sz, out_sz, shuffled=False):
    """A smooth barrel distortion of the ×(out / in) zoom, [oH, oW] row and
    column coordinates clipped to [0, in] (``WarpOperands.from_grid``'s
    input: a map no homography gives); ``shuffled``: its output rows in a
    seeded random order, so that many blocks' footprints exceed the tile
    (the direct path)."""
    (h, w), (oh, ow) = in_sz, out_sz
    ys, xs = np.meshgrid(np.arange(oh, dtype=np.float64),
                         np.arange(ow, dtype=np.float64), indexing="ij")
    u, v = (ys - (oh - 1) / 2) / oh, (xs - (ow - 1) / 2) / ow
    k = 1.0 + 0.35 * (u * u + v * v)
    gx = ((oh - 1) / 2 + (ys - (oh - 1) / 2) * k) * h / oh
    gy = ((ow - 1) / 2 + (xs - (ow - 1) / 2) * k) * w / ow
    gx, gy = gx.clip(0, h), gy.clip(0, w)
    if shuffled:
        order = np.random.RandomState(4).permutation(oh)
        gx, gy = gx[order], gy[order]
    return gx, gy


def rings_work(in_sz, out_sz, c, linear=False, value_bytes=4, floats=False):
    """(bytes, float32 operations, bf16 operations) of one rings-instance
    call in uint8 mode: ``k5_work``'s feature, codes and output bytes and
    its float32 (and bf16) operations, no float64 geometry, and per output
    the rings' int32 corner and four float32 distances (20 bytes; the
    linear mode's branch byte one more), the ring maps once."""
    (h, w), (oh, ow) = in_sz, out_sz
    nbytes, ops, _, bf16 = k5_work(in_sz, out_sz, c, linear=linear,
                                   value_bytes=value_bytes, floats=floats)
    nbytes += oh * ow * (20 + int(linear)) + (h + w + 8) * 4 - 9 * 8
    return nbytes, ops, bf16


def rings_geometry_work(in_sz, out_sz):
    """(bytes, float64 operations) of one rings-geometry launch: the 3×3
    float64 inverse read once, per output the int32 corner and four
    float32 distances written (20 bytes; the ring maps are the host's),
    and ``k5_work``'s float64 geometry at support 2 (the corner's ring
    positions are integer adds)."""
    (oh, ow) = out_sz
    _, _, f64, _ = k5_work(in_sz, out_sz, 1)
    return 9 * 8 + oh * ow * 20, f64


def same_bits(a, b):
    import torch
    return torch.equal(torch.nan_to_num(a.float(), nan=-1.0),
                       torch.nan_to_num(b.float(), nan=-1.0))


def rings_first_design(build):
    """K5 rings' first design (``RINGS_FIRST``) once its build is done:
    ``fn(feat, codes, rings, out_sz, linear, out_dtype)`` → its output, the
    wrapper's launch through the first design's ``lerf_steering_warp_rings``
    (the same arguments; uncounted).  ``fn.log`` is nvcc's output."""
    import ctypes

    import torch
    from lerf_torch.ops.kernels import _build
    from lerf_torch.ops.kernels import warp as k5

    proc, path = build
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"K5 rings first design: nvcc failed:\n{log}")
    entry = ctypes.CDLL(path).lerf_steering_warp_rings
    entry.argtypes = _build.library().lerf_steering_warp_rings.argtypes
    entry.restype = ctypes.c_int

    def call(feat, codes, rings, out_sz, linear=False,
             out_dtype=torch.uint8):
        C, H, W = feat.shape
        oh, ow = out_sz
        out = torch.empty((C, oh, ow), dtype=out_dtype, device=feat.device)
        _build.check(entry(
            feat.data_ptr(), codes.data_ptr(), out.data_ptr(),
            rings.ring_x.data_ptr(), rings.ring_x.numel(),
            rings.ring_y.data_ptr(), rings.ring_y.numel(),
            rings.corner.data_ptr(), rings.dis_x.data_ptr(),
            rings.dis_y.data_ptr(),
            0 if rings.bits is None else rings.bits.data_ptr(), C, H, W, oh,
            ow, int(linear), 10.0, 255.0, int(out_dtype == torch.uint8),
            torch.cuda.current_stream().cuda_stream,
            k5.rings_in_type(feat, codes, rings.dtype)),
            "K5 rings first design")
        return out

    call.log = log
    return call


def rings_phase(dev, banks, frame, first, log):
    """Phase 51: K5's rings instance at full width, the LeRF-G bench bank's
    LUT stages on the 360×640 frame warped to 1440×2560 at
    ``warp_matrix()``: the rings from ``warp_serving_host_fused`` (the C
    library; held to numpy's) and ``warp_rings_on_device`` (the rings
    geometry kernel, held to the host's and to its twin on the card); the
    two main paths counted, each making its rings inside the run (the
    host's, or the card's: 1 geometry launch), then
    ``steering_gaussian_warp_rings``; the rings instance ``torch.equal``
    to the matrix instance in uint8 (the LUT form, both modes) and in
    float32 (the IMDN form's float32 and bf16 maps, both modes; bf16 maps
    under float32 rings against the float32-feature instance on the
    feature widened, under bf16 rings against the bf16 instance); on a
    radial distortion and its row-shuffled form (``WarpOperands.from_grid``)
    ``torch.equal`` to its twin; its time and the geometry kernel's by
    CUDA-graph replays (the rings instance beside its first design,
    ``first`` from ``rings_first_design``, and the matrix instance in
    alternating rounds on the main frame, beside its first design on both
    grids); its persistent grid and ptxas's registers (from the library's
    build ``log``); the host precompute and the upload.  Returns the
    kernels line's two rows."""
    import torch
    from lerf_torch.native import native_threads
    from lerf_torch.ops.geometry import (WarpOperands,
                                         warp_rings_operands_plain)
    from lerf_torch.ops.kernels import warp as k5
    from lerf_torch.ops.lut_pipeline import divide_exact
    from lerf_torch.ops.resample import (steering_gaussian_warp_rings,
                                         warp_rings, warp_rings_on_device,
                                         warp_serving_host_fused)
    from lerf_torch.pipeline import LutPredictor, NetPredictor

    t0 = time.perf_counter()
    in_sz, matrix = (LR_H, LR_W), WARP_CASES["main"][0]
    n_out = WARP_OUT[0] * WARP_OUT[1]

    # the host precompute: numpy, the C library at 1 thread and at
    # native_threads(), bit-equal
    def fused(native, linear=False):
        return warp_serving_host_fused(in_sz, matrix, WARP_OUT,
                                       linear=linear, native=native)

    def flat(r):
        return [np.asarray(a) for a in r[:5]] + [
            np.asarray(m) for ms in (r.masks_x, r.masks_y) if ms for m in ms]

    host_ms = {}
    want_rings, want_mask = fused(False, linear=True)
    host_ms["numpy"] = host_call_ms(lambda: fused(False), RINGS_NUMPY_CALLS,
                                    warmup=0)
    threads = native_threads()
    saved = os.environ.get("LERF_NATIVE_THREADS")
    try:
        for t in (1, threads):
            os.environ["LERF_NATIVE_THREADS"] = str(t)
            rings_l, mask = fused(True, linear=True)
            if not (np.array_equal(mask, want_mask) and all(
                    np.array_equal(a, b) for a, b in
                    zip(flat(rings_l), flat(want_rings)))):
                raise AssertionError(f"rings: the C library at {t} threads "
                                     "differs from numpy")
            host_ms[f"native_{t}_threads"] = host_call_ms(
                lambda: fused(True), RINGS_NATIVE_CALLS, warmup=1)
    finally:
        if saved is None:
            os.environ.pop("LERF_NATIVE_THREADS", None)
        else:
            os.environ["LERF_NATIVE_THREADS"] = saved
    rings, _ = fused(True)
    k5.upload_rings(rings, dev)                     # warm the pinned pool
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        dev_rings = k5.upload_rings(rings, dev)
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t) * 1e3 / 5
    upload_bytes = sum(np.asarray(a).nbytes for a in rings[:5])

    # the rings on the card from the inverse, equal to the host's and to
    # the plain twin run on the card
    inv64 = np.linalg.inv(matrix)
    inv = torch.from_numpy(inv64).to(dev)
    dev_made = warp_rings_on_device(inv, in_sz, WARP_OUT)
    twin_made = warp_rings_operands_plain(inv64, in_sz, WARP_OUT, dev)
    torch.cuda.synchronize()
    host_rings = warp_rings(WarpOperands.create(in_sz, matrix, WARP_OUT))
    if not all(torch.equal(a.cpu(), torch.from_numpy(np.asarray(b)))
               and torch.equal(a, c) for a, b, c in
               zip(dev_made[:5], host_rings[:5], twin_made)):
        raise AssertionError("warp_rings_on_device differs from the host's "
                             "rings or from its twin on the card")
    if not all(np.array_equal(a, b) for a, b in zip(rings[:5],
                                                    host_rings[:5])):
        raise AssertionError("warp_serving_host_fused's rings differ from "
                             "warp_rings(WarpOperands.create(...))")
    geo_call_ms = event_ms(
        lambda: warp_rings_on_device(inv, in_sz, WARP_OUT), iters=20)
    geo_params = k5.WarpParams.from_inverse(in_sz, inv64, WARP_OUT)
    geo_out = (torch.empty(n_out, dtype=torch.int32, device=dev),
               torch.empty((n_out, 2), dtype=torch.float32, device=dev),
               torch.empty((n_out, 2), dtype=torch.float32, device=dev))
    geo_ms = statistics.median(
        graph_ms(lambda: k5.launch_rings_geometry(geo_params, *geo_out))
        for _ in range(RINGS_ROUNDS))
    geo_plain_ms = event_ms(lambda: warp_rings_operands_plain(
        inv64, in_sz, WARP_OUT, dev), iters=5, warmup=1)
    geo_bytes, geo_f64 = rings_geometry_work(in_sz, WARP_OUT)
    geo_b_ms, geo_b_by, geo_parts = k5_bound(geo_bytes, 0, geo_f64)

    # the main paths, counted: the LUT stages, then the rings a frame (the
    # host's fused precompute and upload, or the card's geometry kernel,
    # as lerf_tpu's warp_dynamic and warp_device make them), then the
    # rings warp
    pred = LutPredictor(banks["lerf_g"])
    x = torch.from_numpy(np.ascontiguousarray(
        frame.transpose(2, 0, 1)).astype(np.int32)).to(dev)

    def main_path(make_rings):
        feat, hyper = pred._stages(x)
        return steering_gaussian_warp_rings(
            feat, hyper[..., 0], hyper[..., 1], hyper[..., 2], make_rings(),
            out_sz=WARP_OUT, u8_inputs=True)

    outs, counts = {}, {}
    want_counts = {"lut_stage": 2, "steering_warp": 1,
                   "steering_warp_rings": 1}
    for name, make, extra in (
            ("host_rings", lambda: fused(True)[0], {}),
            ("device_rings",
             lambda: warp_rings_on_device(inv, in_sz, WARP_OUT),
             {"warp_rings_geometry": 1})):
        outs[name], counts[name] = counted_run(
            lambda make=make: main_path(make), {**want_counts, **extra},
            f"rings warp ({name})")
    launches = counts["device_rings"]
    feat_d, hyper_d = pred._stages(x)
    params = k5.WarpParams.create(in_sz, matrix, WARP_OUT)
    want = k5.steering_warp(feat_d, hyper_d, params)
    if not (same_bits(outs["host_rings"], want)
            and same_bits(outs["device_rings"], want)):
        raise AssertionError("rings warp: the main path differs from K5's "
                             "matrix instance")

    # the rings instance against the matrix instance, uint8 (LUT, both
    # modes) and float32 (IMDN float32 and bf16 maps, both modes)
    pred_l = LutPredictor(banks["lerf_l"], linear=True)
    feat_l, hyper_l = pred_l._stages(x)
    rings_lin, _ = fused(True, linear=True)
    rings16 = {False: warp_serving_host_fused(in_sz, matrix, WARP_OUT,
                                              dtype=torch.bfloat16)[0],
               True: warp_serving_host_fused(in_sz, matrix, WARP_OUT,
                                             linear=True,
                                             dtype=torch.bfloat16)[0]}
    xf = divide_exact(x.to(torch.float32), 255)
    imdn = {"float32": NetPredictor.from_imdn(imdn_model(), device=dev),
            "bf16": NetPredictor.from_imdn(imdn_bf16_model(), device=dev)}
    # (name, linear, feature, maps, output type, bf16 rings, the matrix
    # instance's feature): bf16 maps under float32 rings are weighted in
    # float32 (lerf_tpu's promotion), the matrix instance's float32
    # feature with bf16 maps on the feature widened; under bf16 rings its
    # bf16 instance
    cases = [("lut", False, feat_d, hyper_d, torch.uint8, False, feat_d),
             ("lut", True, feat_l, hyper_l, torch.uint8, False, feat_l)]
    for dt, p in imdn.items():
        f, h = p._stages(xf)
        for linear in (False, True):
            hh = h[..., :1].contiguous() if linear else h
            if dt == "float32":
                cases.append((f"imdn_{dt}", linear, f, hh, torch.float32,
                              False, f))
            else:
                cases += [(f"imdn_{dt}", linear, f, hh, torch.float32,
                           False, f.float()),
                          (f"imdn_{dt}", linear, f, hh, torch.float32,
                           True, f)]
    checked = []
    for name, linear, f, h, out_dt, bf16_rings, mf in cases:
        r = rings16[linear] if bf16_rings else (rings_lin if linear
                                                else rings)
        got = k5.steering_warp_rings(f, h, r, out_sz=WARP_OUT,
                                     linear=linear, out_dtype=out_dt)
        want = k5.steering_warp(mf, h, params, linear=linear,
                                out_dtype=out_dt)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            mode = "linear" if linear else "gauss"
            raise AssertionError(f"rings {name} {mode} (rings "
                                 f"{'bf16' if bf16_rings else 'float32'}): "
                                 "not torch.equal to K5's matrix instance")
        checked.append([name, "linear" if linear else "gauss",
                        str(f.dtype).replace("torch.", ""),
                        str(h.dtype).replace("torch.", ""),
                        "bfloat16" if bf16_rings else "float32",
                        str(mf.dtype).replace("torch.", ""),
                        str(out_dt).replace("torch.", "")])

    # two maps no homography gives: the kernel against its twin
    grids = {}
    for gname in ("radial", "shuffled"):
        gx, gy = distortion_grid(in_sz, WARP_OUT, gname == "shuffled")
        ops = WarpOperands.from_grid(gx, gy, in_sz, WARP_OUT)
        for linear in (False, True):
            r = warp_rings(ops, linear=linear)
            h = hyper_l if linear else hyper_d
            f = feat_l if linear else feat_d
            got = k5.steering_warp_rings(f, h, r, out_sz=WARP_OUT,
                                         linear=linear)
            twin = k5.steering_warp_rings_plain(f, h, r, linear=linear)
            torch.cuda.synchronize()
            if not same_bits(got, twin.reshape(got.shape)):
                raise AssertionError(f"rings {gname}: not torch.equal to "
                                     "the twin")
        grids[gname] = float((k5.rings_footprint_entries(
            r, in_sz, WARP_OUT, 3) > k5.TILE_ENTRIES).mean())
    if not (grids["radial"] == 0.0 and grids["shuffled"] > 0.0):
        raise AssertionError(f"rings grids: direct-path shares {grids}; "
                             "the radial grid must tile, the shuffled one "
                             "must take the direct path")

    # the persistent grid and ptxas's registers of the rings instances
    # (from this build's log, else from the library as built)
    regs = {r["function"]: r.get("registers") for r in ptxas_rows(log)
            if "steering_warp_rings_kernel" in r["function"]}
    if not regs:
        from lerf_torch.ops.kernels import _build
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        usage = subprocess.run([tool, "-res-usage", _build.build()[0]],
                               capture_output=True, text=True).stdout
        regs = dict((f, int(n)) for f, n in re.findall(
            r"Function (\S*steering_warp_rings_kernel\S*):\s*REG:(\d+)",
            usage))
    first_regs = [r.get("registers") for r in ptxas_rows(first.log)
                  if "steering_warp_rings_kernel" in r["function"]]
    grid = k5.rings_grid(WARP_OUT, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    emit({"phase": "rings_build", "persistent_grid": grid, "sms": sms,
          "blocks_per_sm": grid / sms,
          "tiles": -(-WARP_OUT[0] // 16) * -(-WARP_OUT[1] // 32),
          "registers": regs,
          "first_design_registers": sorted(set(first_regs)),
          "registers_from": "ptxas" if log else "cuobjdump"})

    # times: graph replays, uint8 LUT form, rings / first design / matrix
    # alternating on the main frame, rings / first design on both grids
    def rings_u8(r=dev_rings, linear=False):
        h = hyper_l if linear else hyper_d
        f = feat_l if linear else feat_d
        return k5.steering_warp_rings(f, h, r, out_sz=WARP_OUT,
                                      linear=linear, out_dtype=torch.uint8)

    def first_u8(r=dev_rings, linear=False):
        h = hyper_l if linear else hyper_d
        f = feat_l if linear else feat_d
        return first(f, h, r, WARP_OUT, linear)

    def matrix_u8():
        return k5.steering_warp(feat_d, hyper_d, params,
                                out_dtype=torch.uint8)

    timed = {"main": (dev_rings, False)}
    for gname in ("radial", "shuffled"):
        gx, gy = distortion_grid(in_sz, WARP_OUT, gname == "shuffled")
        timed[gname] = (k5.upload_rings(warp_rings(WarpOperands.from_grid(
            gx, gy, in_sz, WARP_OUT)), dev), False)
    timed["main_linear"] = (k5.upload_rings(rings_lin, dev, linear=True),
                            True)
    rounds = {"rings": [], "first_design": [], "matrix": []}
    grid_rounds = {g: {"rings": [], "first_design": []} for g in timed
                   if g != "main"}
    for _ in range(RINGS_ROUNDS):
        for g, (r, linear) in timed.items():
            new_fn = (lambda r=r, linear=linear: rings_u8(r, linear))
            old_fn = (lambda r=r, linear=linear: first_u8(r, linear))
            if not torch.equal(new_fn(), old_fn()):
                raise AssertionError(f"rings {g}: the first design's "
                                     "output differs from the kernel's")
            into = rounds if g == "main" else grid_rounds[g]
            into["rings"].append(graph_ms(new_fn))
            into["first_design"].append(graph_ms(old_fn))
            if g == "main":
                rounds["matrix"].append(graph_ms(matrix_u8))
    ms = statistics.median(rounds["rings"])
    first_ms = statistics.median(rounds["first_design"])
    ev_ms = event_ms(rings_u8, iters=50)
    prof = kernel_device_ms(rings_u8, "steering_warp_rings_kernel")
    plain_ms = event_ms(lambda: k5.steering_warp_rings_plain(
        feat_d, hyper_d, dev_rings), iters=3, warmup=1)
    nbytes, nops, _ = rings_work(in_sz, WARP_OUT, 3)
    b_ms, b_by, parts = k5_bound(nbytes, nops, 0)
    # the other instances' bounds: linear, float32 maps, the bf16 instance
    other_bounds = {}
    for name, kw in (("linear_u8", {"linear": True}),
                     ("float32_maps", {"floats": True}),
                     ("bf16_rings", {"floats": True, "value_bytes": 2})):
        nb, no, n16 = rings_work(in_sz, WARP_OUT, 3, **kw)
        bm, bb, _ = k5_bound(nb, no, 0, n16)
        other_bounds[name] = {"bound_ms": bm, "bound_by": bb, "bytes": nb}
    grid_ms = {g: {k: statistics.median(v) for k, v in t.items()}
               for g, t in grid_rounds.items()}
    seconds = time.perf_counter() - t0
    emit_timed({"phase": "rings", "in": list(in_sz), "out": list(WARP_OUT),
                "launches": launches, "bit_equal_to_matrix_instance": checked,
                "device_rings_equal_to_host": True,
                "native_equal_to_numpy": True,
                "grids_direct_block_share": grids,
                "grids_equal_to_twin": True,
                "host_precompute_ms": host_ms, "native_threads": threads,
                "upload_ms": upload_ms, "upload_bytes": upload_bytes,
                "upload_bytes_per_output": upload_bytes / n_out,
                "device_rings_call_ms": geo_call_ms,
                "graph_ms_rounds": rounds, "grid_graph_ms_rounds": grid_rounds,
                "grid_graph_ms": grid_ms,
                "grid_share_of_bound": {g: b_ms / t["rings"]
                                        for g, t in grid_ms.items()},
                "first_design_equal_every_round": True,
                "other_bounds": other_bounds, "seconds": seconds})
    row = {"kernel": "steering_warp_rings", "out_dtype": "uint8", "ms": ms,
           "events_ms": ev_ms, **prof,
           "first_design_ms": first_ms,
           "matrix_instance_graph_ms": statistics.median(rounds["matrix"]),
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "bound_parts_ms": parts, "bytes": nbytes, "ops": nops,
           "share_of_bound": b_ms / ms,
           "first_design_share_of_bound": b_ms / first_ms}
    emit_timed(row)
    geo_row = {"kernel": "warp_rings_geometry", "ms": geo_ms,
               "timed_by": "CUDA-graph replays of the launch alone",
               "call_events_ms": geo_call_ms, "plain_ms": geo_plain_ms,
               "plain_on": "the card (torch float64)",
               "bound_ms": geo_b_ms, "bound_by": geo_b_by,
               "bound_parts_ms": geo_parts, "bytes": geo_bytes,
               "f64_ops": geo_f64, "share_of_bound": geo_b_ms / geo_ms}
    emit_timed(geo_row)
    return [{"name": "steering_warp_rings", "route": "cuda",
             "source": "lerf_torch/csrc/steering_warp.cu",
             "replaces": "lerf_tpu/ops/resample.py:786",
             "launches": launches["steering_warp_rings"], "max_abs_err": 0.0,
             "ms": ms, "timed_by": "CUDA-graph replays", "events_ms": ev_ms,
             "first_design_ms": first_ms, "first_design": RINGS_FIRST,
             "matrix_instance_graph_ms": row["matrix_instance_graph_ms"],
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "share_of_bound": b_ms / ms, "library_ms": None},
            {"name": "warp_rings_geometry", "route": "cuda",
             "source": "lerf_torch/csrc/steering_warp.cu",
             "replaces": "lerf_tpu/ops/resample.py:1082",
             "launches": launches["warp_rings_geometry"], "max_abs_err": 0.0,
             "ms": geo_ms, "timed_by": geo_row["timed_by"],
             "plain_ms": geo_plain_ms, "bound_ms": geo_b_ms,
             "bound_by": geo_b_by, "share_of_bound": geo_b_ms / geo_ms,
             "library_ms": None}]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lerf_torch.ops import lut_pipeline as lp
    from lerf_torch.ops.geometry import ResizeGeometry
    from lerf_torch.ops.kernels import _build
    from lerf_torch.ops.kernels import lut_stage as k2
    from lerf_torch.ops.kernels import resize as k1
    from lerf_torch.ops.kernels import srnet_ensemble as k3
    from lerf_torch.ops.kernels import srnet_ensemble_int8 as k4
    from lerf_torch.ops.kernels import warp as k5
    from lerf_torch.models import srnet
    from lerf_torch.ops.resample import steering_resize_codes_plain
    from lerf_torch.pipeline import LutPredictor, _quantize_device

    global CARD
    dev = torch.device("cuda")
    card = CARD = card_line()

    # -- 1. card, torch, build ---------------------------------------------
    print(card, flush=True)
    t0 = time.perf_counter()
    first_builds = [start_k6_first_build(),
                    start_first_build(K3_BF16_FIRST, "k3_bf16_first"),
                    start_first_build(K2_ROWS_FIRST, "k2_rows_first"),
                    start_first_build(BF16_STEPS, "bf16_steps"),
                    start_first_build(RINGS_FIRST, "k5_rings_first")]
    try:
        _, log = _build.build()
        _build.library()
    except BaseException:
        for proc, _ in first_builds:
            proc.kill()
            proc.wait()
        raise
    k6_first = k6_first_design(first_builds[0])
    k3_bf16_first = k3_bf16_first_design(first_builds[1])
    k2_rows_first = k2_rows_first_design(first_builds[2])
    rings_first = rings_first_design(first_builds[4])
    emit({"phase": "build", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0})
    for line in log.splitlines():
        if ("srnet_ensemble" in line or "registers" in line
                or "stack frame" in line):
            print("ptxas:", line.strip(), flush=True)
    for row in ptxas_rows(log):
        emit(row)

    rng = np.random.RandomState(1)
    shape = (3, LR_H, LR_W)

    # -- 2. K1 vs its plain twin -------------------------------------------
    feat = torch.from_numpy(rng.randint(0, 256, shape).astype(np.int32)).to(dev)
    codes = torch.from_numpy(
        rng.randint(0, 256, shape + (3,)).astype(np.int32)).to(dev)
    k1_err = 0.0
    k1_bit_equal = {}
    for scale in (4.0, 2.5, 3.55, 0.5):
        geom = ResizeGeometry.create((LR_H, LR_W), scale_factors=[scale] * 2)
        got = k1.steering_resize(feat, codes, geom)
        got_u8 = k1.steering_resize(feat, codes, geom, out_dtype=torch.uint8)
        want = steering_resize_codes_plain(feat, codes, geom)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K1 x{scale}: non-finite output")
        err = float((got - want).abs().max())
        if err > K1_ATOL:
            raise AssertionError(f"K1 x{scale}: max-abs {err} > {K1_ATOL}")
        if got_u8.dtype != torch.uint8 or not torch.equal(
                got_u8, _quantize_device(got, 255)):
            raise AssertionError(f"K1 x{scale}: the uint8 mode differs from "
                                 "the float mode quantized")
        n = check_ties(got_u8.cpu().numpy(),
                       _quantize_device(want, 255).cpu().numpy(),
                       want.cpu().numpy(),
                       f"K1 x{scale}")
        k1_err = max(k1_err, err)
        k1_bit_equal[scale] = err == 0.0
        emit({"phase": "k1_vs_plain", "scale": scale,
              "out": list(geom.out_sz), "antialias": geom.antialias,
              "support": geom.support,
              "tile": list(k1.ResizeOperands.create(geom, dev).tile),
              "max_abs_err": err, "bit_equal": err == 0.0,
              "u8_equal_to_quantized_float": True, "u8_mismatch": n})

    # -- 3. K2 vs its plain twin -------------------------------------------
    bank = bench_bank()
    bank3 = bench_bank(seed=1, stages=3)
    s1 = lp.FlatTables.create(bank.stage1, dev)
    s2 = lp.FlatTables.create(bank.stage2, dev)
    inter = lp.FlatTables.create(bank3.inter[0], dev)
    img = torch.from_numpy(rng.randint(0, 256, shape).astype(np.int32)).to(dev)
    q = 16
    checks = [
        ("stage1", lambda x: lp.lut_stage1(x, s1, MODES),
         lambda x: lp.lut_stage_plain(x, s1, MODES, split_r=False,
                                      den=3 * q, bias=0)[..., 0]),
        ("intermediate", lambda x: lp.lut_stage1_intermediate(x, inter, MODES),
         lambda x: lp.lut_stage_plain(x, inter, MODES, split_r=False,
                                      den=12 * q, bias=127)[..., 0]),
        ("stage2", lambda x: lp.lut_stage2(x, s2, MODES),
         lambda x: lp.lut_stage_plain(x, s2, MODES, split_r=True,
                                      den=12 * q, bias=127)),
    ]
    stage_in = {"stage1": img, "intermediate": img}
    stage_out = {}
    for name, kern, plain in checks:
        x = stage_in.get(name, stage_out.get("stage1"))
        got, want = kern(x), plain(x)
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or not torch.equal(got, want):
            raise AssertionError(f"K2 {name}: not bit-equal to the plain twin")
        stage_out[name] = got
        emit({"phase": "k2_vs_plain", "stage": name,
              "shape": list(got.shape), "bit_equal": True,
              "max_abs_err": int((got - want).abs().max())})

    # -- 4. end to end on the card vs the CPU ------------------------------
    frame = np.random.RandomState(0).randint(0, 256, (LR_H, LR_W, 3)) \
        .astype(np.uint8)
    pred = LutPredictor(bank)                # the default device: the card
    if pred.device.type != "cuda":
        raise AssertionError(f"default device is {pred.device}")
    lut_mods = {"steering_resize": k1, "lut_stage": k2,
                "srnet_ensemble": k3, "srnet_ensemble_int8": k4,
                "steering_warp": k5}
    for mod in lut_mods.values():
        mod.launches = 0
    out, feat_o, hyper_o = pred.upscale(frame, SCALE, SCALE, return_aux=True)
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in lut_mods.items()}
    if launches != {"steering_resize": 1, "lut_stage": 2,
                    "srnet_ensemble": 0, "srnet_ensemble_int8": 0,
                    "steering_warp": 0}:
        raise AssertionError(f"main path launches {launches}, want K1 1, "
                             "K2 2 and no other")
    oh, ow = int(LR_H * SCALE), int(LR_W * SCALE)
    if out.shape != (oh, ow, 3) or out.dtype != np.uint8:
        raise AssertionError(f"output {out.shape} {out.dtype}")
    t_cpu = time.perf_counter()
    cpu = LutPredictor(bank, device="cpu")
    want_out, want_feat, want_hyper = cpu.upscale(frame, SCALE, SCALE,
                                                  return_aux=True)
    cpu_s = time.perf_counter() - t_cpu
    if not (np.array_equal(feat_o, want_feat)
            and np.array_equal(hyper_o, want_hyper)):
        raise AssertionError("end to end: feat/hyper differ from the CPU path")
    n_tie = 0
    if not np.array_equal(out, want_out):
        geom = ResizeGeometry.create((LR_H, LR_W), scale_factors=[SCALE] * 2)
        f32 = steering_resize_codes_plain(
            torch.from_numpy(want_feat), torch.from_numpy(want_hyper),
            geom).numpy().transpose(1, 2, 0)
        n_tie = check_ties(out, want_out, f32, "end to end")
    emit({"phase": "end_to_end", "in": [LR_H, LR_W], "out": [oh, ow],
          "scale": SCALE, "feat_hyper_bit_equal": True,
          "u8_mismatch_at_ties": n_tie, "launches": launches,
          "cpu_reference_s": cpu_s})

    # -- 5. timing ----------------------------------------------------------
    mp = oh * ow / 1e6
    upscale_ms = host_call_ms(lambda: pred.upscale(frame, SCALE, SCALE), 20,
                              warmup=3)
    x = torch.from_numpy(np.ascontiguousarray(
        frame.transpose(2, 0, 1)).astype(np.int32)).to(dev)
    device_ms = frame_ms(lambda: pred.run_device(x, (SCALE, SCALE)))
    emit_timed({"phase": "timing", "frames": 20, "upscale_ms": upscale_ms,
          "upscale_mps": mp / upscale_ms * 1e3, "device_ms": device_ms,
          "device_mps": mp / device_ms * 1e3})
    emit_timed(profile_frames(lambda: pred.upscale(frame, SCALE, SCALE),
                              form="lut"))
    # the device part launches K1 and K2 and nothing else: no elementwise
    # quantization after K1 (copies would be allowed; there are none)
    rows = device_part_only(lambda: pred.run_device(x, (SCALE, SCALE)),
                            ("steering_resize_kernel", "lut_stage_kernel"),
                            "LUT run_device")
    emit_timed({"phase": "device_part_kernels", "form": "lut",
                "rows": [[k[:60], n, ms] for k, n, ms in rows]})

    feat_d = lp.lut_stage1(x, s1, MODES)
    hyper_d = lp.lut_stage2(feat_d, s2, MODES)
    geom = ResizeGeometry.create((LR_H, LR_W), scale_factors=[SCALE] * 2)
    ops = k1.ResizeOperands.create(geom, dev)
    k2_rows = []
    for name, tables, inp, split_r, oc in (
            ("stage1", s1, x, False, 1), ("stage2", s2, feat_d, True, 3)):
        fn = lp.lut_stage1 if name == "stage1" else lp.lut_stage2
        den, bias = (3 * q, 0) if name == "stage1" else (12 * q, 127)
        ms = event_ms(lambda: fn(inp, tables, MODES), iters=50)
        prof = kernel_device_ms(lambda: fn(inp, tables, MODES),
                                "lut_stage_kernel")
        plain_ms = event_ms(lambda: lp.lut_stage_plain(
            inp, tables, MODES, split_r=split_r, den=den, bias=bias),
            iters=5, warmup=1)
        nbytes, nops = k2_work(3, LR_H, LR_W, oc, len(tables.keys), 12)
        b_ms, b_by = bound(nbytes, nops)
        row = {"kernel": "lut_stage", "stage": name, "ms": ms,
               **prof, "launches_per_frame": 1,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "ops": nops, "share_of_bound": b_ms / ms}
        emit_timed(row)
        k2_rows.append(row)
    # K1's row is the main path's uint8 mode; the float mode beside it
    def k1_u8():
        return k1.steering_resize(feat_d, hyper_d, geom, operands=ops,
                                  out_dtype=torch.uint8)

    k1_ms = event_ms(k1_u8, iters=50)
    k1_prof = kernel_device_ms(k1_u8, "steering_resize_kernel")
    k1_float_ms = event_ms(lambda: k1.steering_resize(
        feat_d, hyper_d, geom, operands=ops), iters=50)
    k1_plain_ms = event_ms(lambda: _quantize_device(
        steering_resize_codes_plain(feat_d, hyper_d, geom), 255),
        iters=5, warmup=1)
    k1_bytes, k1_ops, _ = k1_work(geom, 3)
    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    emit_timed({"kernel": "steering_resize", "out_dtype": "uint8",
                "tile": list(ops.tile), "ms": k1_ms,
                **k1_prof, "float_mode_ms": k1_float_ms,
                "launches_per_frame": 1,
                "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
                "bound_by": k1_by, "bytes": k1_bytes, "ops": k1_ops,
                "share_of_bound": k1_bound / k1_ms})

    k2_bytes = sum(r["bytes"] for r in k2_rows)
    k2_ops = sum(r["ops"] for r in k2_rows)
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    kernels = [
        {"name": "steering_resize", "route": "cuda",
         "source": "lerf_torch/csrc/steering_resize.cu",
         "replaces": "lerf_tpu/ops/pallas/resize_kernel.py:118",
         "launches": launches["steering_resize"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "share_of_bound": k1_bound / k1_ms,
         "library_ms": None},
        {"name": "lut_stage", "route": "cuda",
         "source": "lerf_torch/csrc/lut_stage.cu",
         "replaces": "lerf_tpu/ops/lut_pipeline.py:255",
         "launches": launches["lut_stage"], "max_abs_err": 0,
         "ms": sum(r["ms"] for r in k2_rows),
         "plain_ms": sum(r["plain_ms"] for r in k2_rows),
         "bound_ms": k2_bound, "bound_by": k2_by,
         "share_of_bound": k2_bound / sum(r["ms"] for r in k2_rows),
         "library_ms": None},
    ]

    # -- 6. K3 / K4 vs their plain twins -----------------------------------
    params = net_params()
    qparams = srnet.quantize_lerf_params(params)
    net = net_kernel_phases(dev, params, qparams, rng)

    # -- 7, 8. the net form end to end and its timing, per backend ---------
    net_runs = {backend: net_form_phases(dev, params, frame, backend)
                for backend in ("auto", "pallas_int8")}
    net_launches = {b: run[0] for b, run in net_runs.items()}

    k3s, k4s = net["srnet_ensemble"], net["srnet_ensemble_int8"]
    k3_b, k3_by, k3_parts = k3_bound(k3s["bytes"], k3s["macs"])
    k4_b, k4_by, _ = k4_bound(k4s["bytes"], k4s["int8_ops"], k4s["f32_ops"])
    kernels += [
        {"name": "srnet_ensemble", "route": "cuda",
         "source": "lerf_torch/csrc/srnet_ensemble.cu",
         "replaces": "lerf_tpu/ops/pallas/srnet_kernel.py:78",
         "launches": net_launches["auto"]["srnet_ensemble"],
         "max_abs_err": k3s["err"], "ms": k3s["ms"],
         "plain_ms": k3s["plain_ms"], "bound_ms": k3_b,
         "bound_by": k3_by, "bound_parts_ms": k3_parts,
         "share_of_bound": k3_b / k3s["ms"], "library_ms": None},
        {"name": "srnet_ensemble_int8", "route": "cuda",
         "source": "lerf_torch/csrc/srnet_ensemble_int8.cu",
         "replaces": "lerf_tpu/ops/pallas/srnet_kernel_int8.py:175",
         "launches": net_launches["pallas_int8"]["srnet_ensemble_int8"],
         "max_abs_err": k4s["err"], "ms": k4s["ms"],
         "plain_ms": k4s["plain_ms"], "bound_ms": k4_b, "bound_by": k4_by,
         "share_of_bound": k4_b / k4s["ms"], "library_ms": None},
    ]

    # -- 9. K5 vs its plain twin ---------------------------------------------
    k5_err = warp_kernel_phase(dev, rng)

    # -- 10. the LUT warp end to end, its timing, K5 alone ------------------
    k5_row = lut_warp_phases(dev, bank, frame, x)
    kernels.append({**k5_row, "max_abs_err": k5_err})

    # -- 11. the net warp per backend ----------------------------------------
    for backend in ("auto", "pallas_int8"):
        net_warp_phases(dev, params, frame, backend)

    # -- 12, 13. K1's and K5's linear modes, K5 at supports 3 and 4 --------
    lin = linear_kernel_phases(dev, rng)

    # -- 14. LeRF-L, LUT form, end to end, and its kernels' timing ---------
    bank_l = bench_bank(out_c=1)
    lin_rows = lerf_l_lut_phases(dev, bank_l, frame)

    # -- 15. LeRF-L, net form ------------------------------------------------
    lerf_l_net_phases(dev, net_params(out_c=1), frame)

    # -- 16. K5 at support 4 on the LUT warp --------------------------------
    s4_row = k5_support4_phase(dev, bank, frame, x,
                               *lin.pop("geoms")["main", 4])

    # -- 17. the SR serving forms on the card --------------------------------
    serving_phases(dev, {"lerf_g": bank, "lerf_l": bank_l}, frame)

    # -- 18. K5's validity mask on the card -----------------------------------
    hosts = warp_mask_phase(dev, rng)

    # -- 19. K5 over a batch of homographies ---------------------------------
    batch_err, batch_geoms = warp_batch_kernel_phase(dev, rng, hosts)

    # -- 20. warp_dynamic and warp_device ---------------------------------------
    warp_serving_phase(dev, bank, frame)

    # -- 21. warp_batch in both forms -------------------------------------------
    frames4, mats4 = warp_batch_phase(
        dev, {"lerf_g": bank, "lerf_l": bank_l}, params, frame)

    # -- 22. the warp serving forms' times, K5 with the mask and batched ------
    k5_rows = warp_serving_timing(dev, bank, frame, x, frames4, mats4,
                                  batch_geoms)

    # the kernels line: K1's and K5's linear modes and K5 at support 4
    # beside their main-path rows
    keys = ("launches", "ms", "profiler_ms", "profiler_launches",
            "plain_ms", "bound_ms", "bound_by", "share_of_bound")
    kernels[0]["linear"] = {"max_abs_err": lin["k1_linear"],
                            **{k: lin_rows["steering_resize"][k]
                               for k in keys}}
    kernels[-1]["linear"] = {"max_abs_err": lin["k5_linear"],
                             **{k: lin_rows["steering_warp"][k]
                                for k in keys}}
    kernels[-1]["support4"] = {"max_abs_err": lin["k5_support"],
                               **{k: s4_row[k] for k in keys}}
    # K5 writing the mask (a homography's first call, every serving call)
    # and over a batch of 4 beside the main path's repeated call
    kernels[-1]["mask"] = {"max_abs_err": kernels[-1]["max_abs_err"],
                           **{k: k5_rows["mask"][k] for k in keys}}
    kernels[-1]["batch4"] = {"max_abs_err": batch_err,
                             **{k: k5_rows["batch4"][k] for k in keys}}

    # -- 23. K1's and K5's float modes against their twins ------------------
    float_err = float_kernel_phases(dev, rng)

    # -- 24. the IMDN form at full width, both backends ----------------------
    float_rows, imdn_launches = imdn_phases(dev, frame, feat_d, hyper_d)

    # -- 25. the IMDN serving forms ------------------------------------------
    imdn_serving_phase(dev, frame)

    # -- 26. the transfer on the card, and its bank served --------------------
    transfer_phase(dev, params, frame)

    # the kernels line: K1's and K5's float modes (the IMDN path's, launched
    # on every IMDN call) beside their main-path rows
    float_keys = ("ms", "profiler_ms", "profiler_launches", "plain_ms",
                  "bound_ms", "bound_by", "share_of_bound")
    auto = imdn_launches["base"]
    kernels[0]["float"] = {
        "max_abs_err": float_err["k1_float"],
        "launches": auto["upscale"]["steering_resize"],
        "int32_ms_same_call": float_rows["steering_resize", "int32"]["ms"],
        **{k: float_rows["steering_resize", "float"][k] for k in float_keys}}
    kernels[-1]["float"] = {
        "max_abs_err": float_err["k5_float"],
        "launches": auto["warp"]["steering_warp"],
        "int32_ms_same_call": float_rows["steering_warp", "int32"]["ms"],
        **{k: float_rows["steering_warp", "float"][k] for k in float_keys}}

    # -- 27. K6 against its twin, its time -----------------------------------
    k6_rows = k6_phase(dev, k6_first)

    # -- 28-31. training: the trainer, its step, resume, LUT fine-tuning,
    # IMDN2 -------------------------------------------------------------------
    import tempfile
    with tempfile.TemporaryDirectory(prefix="lerf_train_") as root:
        write_div2k(os.path.join(root, "div2k"))
        write_set5(os.path.join(root, "rr"))
        train_cfg, final, train_launches = trainer_phase(dev, root)
        step_phase(dev, train_cfg)
        resume_phase(dev, train_cfg, final)
        lutft_phase(dev, train_cfg, final, frame)
        imdn_train_phase(dev, root)
        # -- 45. data-parallel training on [cuda:0] x 2 -------------------
        dp_train_phase(dev, train_cfg)
    # -- 32-38. the serving surface: async forms, pinned reuse, streams,
    # the pinned memory results hold, the daemon, several-input CLI, resize
    forms = serving_forms({"lerf_g": bank, "lerf_l": bank_l}, params)
    async_phase(forms, frame)
    srng = np.random.RandomState(12)
    lut_pred = forms["lut_g"][0]
    pinned_reuse_phase(lut_pred, srng)
    stream_phase(lut_pred, srng)
    pinned_retention_phase(lut_pred, frame)
    daemon_phase(lut_pred, forms["net_k4"][0], frame)
    cli_phase(bank, srng)
    resize_phase(dev, srng)
    del forms, lut_pred

    # -- 39-44. the multi-device slice on one card: K5's and K1's row
    # windows, the sharded LUT, net and IMDN forms, mesh predictors --------
    mrng = np.random.RandomState(13)
    k5_window_err = k5_window_phase(dev, mrng)
    k1_window_err = k1_window_phase(dev, mrng)
    sharded_lut_phase(dev, bank, frame)
    sharded_net_phase(dev, params, frame)
    sharded_imdn_phase(dev, frame)
    mesh_batch_phase(dev, bank, params, frame)
    kernels[0]["window"] = {"max_abs_err": k1_window_err,
                            "bit_equal_to_whole": True}
    kernels[-1]["window"] = {"max_abs_err": k5_window_err,
                             "bit_equal_to_whole": True}

    # -- 46-49. K3 in bf16, nf 128, the LUT table layouts ------------------
    t46 = time.perf_counter()
    k3b = k3_bf16_phase(dev, bf16_of(params), rng, log, k3_bf16_first)
    bf16_launches = bf16_net_phase(dev, bf16_of(params), frame, k3b,
                                   kernels[0]["bound_ms"],
                                   kernels[4]["bound_ms"])
    t48 = time.perf_counter()
    wide = wide_nf_phase(dev, np.random.RandomState(14), k3_bf16_first)
    t49 = time.perf_counter()
    layout_rows = lut_layout_phase(dev, bank, frame, k2_rows_first)
    emit({"phase": "phase_seconds", "k3_bf16_and_net_form": t48 - t46,
          "nf128": t49 - t48, "lut_layouts": time.perf_counter() - t49,
          "script_so_far": time.perf_counter() - t0})

    g_row = k6_rows[False]
    kernels.append({
        "name": "steering_resize_bwd", "route": "cuda",
        "source": "lerf_torch/csrc/steering_resize_bwd.cu",
        "replaces": "lerf_tpu/train/train_step.py:163",
        "launches": train_launches["steering_resize_bwd"],
        "max_abs_err": g_row["max_abs_err"], "ms": g_row["ms"],
        "profiler_ms": g_row["profiler_ms"], "plain_ms": g_row["plain_ms"],
        "bound_ms": g_row["bound_ms"], "bound_by": g_row["bound_by"],
        "share_of_bound": g_row["share_of_bound"], "library_ms": None,
        "linear": {k: k6_rows[True][k] for k in (
            "max_abs_err", "ms", "profiler_ms", "plain_ms", "bound_ms",
            "bound_by", "share_of_bound")}})

    kernels.append({
        "name": "srnet_ensemble_bf16", "route": "cuda",
        "source": "lerf_torch/csrc/srnet_ensemble_bf16.cu",
        "replaces": "lerf_tpu/ops/pallas/srnet_kernel.py:78",
        "launches": bf16_launches["srnet_ensemble_bf16"],
        "max_abs_err": k3b["err"], "share_differing": k3b["share"],
        "ms": k3b["ms"], "profiler_ms": k3b["profiler_ms"],
        "graph_ms": k3b["graph_ms"],
        "first_design_ms": k3b["first_ms"],
        "first_design_profiler_ms": k3b["first_profiler_ms"],
        "first_design_graph_ms": k3b["first_graph_ms"],
        "plain_ms": k3b["plain_ms"], "bound_ms": k3b["bound_ms"],
        "bound_by": k3b["bound_by"],
        "share_of_bound": k3b["bound_ms"] / k3b["ms"], "library_ms": None})
    for name, row in wide.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("lerf_torch/csrc/srnet_ensemble_int8.cu"
                       if "int8" in name else
                       "lerf_torch/csrc/srnet_ensemble_bf16.cu"
                       if "bf16" in name else
                       "lerf_torch/csrc/srnet_ensemble.cu"),
            "replaces": ("lerf_tpu/ops/pallas/srnet_kernel_int8.py:175"
                         if "int8" in name else
                         "lerf_tpu/ops/pallas/srnet_kernel.py:78"),
            "launches": row["launches"], "max_abs_err": row["err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "share_of_bound": row["bound_ms"] / row["ms"],
            "library_ms": None,
            **{k.replace("first_", "first_design_"): row[k]
               for k in ("profiler_ms", "graph_ms", "first_ms",
                         "first_profiler_ms", "first_graph_ms")
               if k in row}})
    for layout, row in layout_rows.items():
        kernels.append({
            "name": f"lut_stage_rows_{layout}", "route": "cuda",
            "source": "lerf_torch/csrc/lut_stage.cu",
            "replaces": "lerf_tpu/ops/lut_pipeline.py:255",
            "launches": row["launches"], "max_abs_err": 0,
            "ms": row["ms"], "profiler_ms": row["profiler_ms"],
            "graph_ms": row["graph_ms"],
            "smooth_frame_graph_ms": row["smooth_graph_ms"],
            "first_design_graph_ms": row["first_graph_ms"],
            "first_design_profiler_ms": row["first_profiler_ms"],
            "first_design_smooth_frame_graph_ms":
                row["first_smooth_graph_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "share_of_bound": row["bound_ms"] / row["ms"],
            "library_ms": None})

    # -- 50. the IMDN form's bf16 compute type: K1 and K5 bf16 ---------------
    t50 = time.perf_counter()
    steps, steps_s = bf16_steps_check(first_builds[3])
    emit({"phase": "bf16_steps_exhaustive", "pairs_a_step": 2 ** 32,
          "mismatches": {k: v["mismatches"] for k, v in steps.items()},
          "first": {k: v["first"] for k, v in steps.items() if v["first"]},
          "kernel_steps": list(BF16_KERNEL_STEPS), "seconds": steps_s})
    bad = [k for k in BF16_KERNEL_STEPS if steps[k]["mismatches"]]
    if bad:
        raise AssertionError(f"bf16 steps the kernels run mismatch the "
                             f"twin's: {bad}")
    bf16_err = bf16_kernel_phase(dev, np.random.RandomState(15))
    t50b = time.perf_counter()
    bf16_rows, bf16_form_launches = imdn_bf16_phases(dev, frame)
    emit({"phase": "phase_seconds", "bf16_kernels": t50b - t50,
          "bf16_imdn_form": time.perf_counter() - t50b,
          "script_so_far": time.perf_counter() - t0})
    for name, src, rep, parent in (
            ("steering_resize_bf16", "lerf_torch/csrc/steering_resize.cu",
             "lerf_tpu/ops/pallas/resize_kernel.py:118",
             BF16_PARENT.format("--k1")),
            ("steering_warp_bf16", "lerf_torch/csrc/steering_warp.cu",
             "lerf_tpu/ops/resample.py:563", BF16_PARENT.format("--k5"))):
        row = bf16_rows[name]
        form = "upscale" if "resize" in name else "warp"
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": bf16_form_launches[form][name],
            "max_abs_err": bf16_err[name][0],
            "max_bf16_ulps": bf16_err[name][1], "ms": row["ms"],
            "profiler_ms": row["profiler_ms"],
            "profiler_launches": row["profiler_launches"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "share_of_bound": row["share_of_bound"], "library_ms": None,
            "redesigned": 18, "parent": parent})

    # -- 51. the warp's geometry as data: K5's rings instance ---------------
    kernels += rings_phase(dev, {"lerf_g": bank, "lerf_l": bank_l}, frame,
                           rings_first, log)

    # -- 52. result ----------------------------------------------------------
    emit({"phase": "exact_division",
          "k1_bit_equal_to_twin": {str(k): v for k, v in k1_bit_equal.items()},
          "k1_max_abs_err": k1_err,
          "k1_linear_bit_equal_to_twin": lin["k1_linear_bit_equal"],
          "net_crop": {b: run[1] for b, run in net_runs.items()},
          "crop": [CROP_H, CROP_W]})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--http-client"]:
        sys.exit(http_client(sys.argv[2], int(sys.argv[3]),
                             float(sys.argv[4])))
    sys.exit(main())
