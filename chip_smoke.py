#!/usr/bin/env python3
"""On-card smoke test of the lerf_torch port: one CUDA card, no arguments.

    python3 chip_smoke.py

Drives the port's main path — ``LutPredictor(bank).upscale`` of a 360×640
RGB frame at ×4 (1440×2560 out) with the seed-0 random bank of the shipped
LeRF-G shapes (modes s,c,t, 2 stages, 17⁴-entry int8 tables, oC 3) — and
holds each hand-written kernel against its plain PyTorch twin on the card:

1. the card (``nvidia-smi`` name and power limit), torch, the kernel build;
2. K1 (steering resize) vs its plain twin at 360×640, ×4 / ×2.5 / ×3.55 /
   ×0.5: float32 max-abs ≤ 1e-3; uint8 mismatches must be .5 ties;
3. K2 (LUT stage) vs its plain twin, bit-equal: stage 1, stage 2 and a
   3-stage bank's intermediate stage;
4. end to end on the card vs ``device="cpu"``: feat and hyper bit-equal,
   uint8 equal but for .5 ties; K1 launched once and K2 twice;
5. CUDA-event timing: the whole ``upscale`` call, its device part, each
   kernel and its plain twin, with each kernel's bound;
6. the kernels line, the card line and, last, the result line.

Any failure exits non-zero; without a CUDA card it exits 1 and prints no
result.  Imports neither JAX nor lerf_tpu.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

LR_H, LR_W, SCALE = 360, 640, 4.0
MODES = ("s", "c", "t")
L4 = 17 ** 4
K1_ATOL = 1e-3        # float32 ops in one order; exp differs by a few ulp
TIE_TOL = 1e-3        # a uint8 mismatch needs a value this close to k + .5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; float32 outside the
# tensor cores, which also bounds int32 issue from above
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12
# operations counted per unit of work for the bound:
#  K1, per output pixel and neighbour: decode 7 (3 div, 3 mul, 1 sub),
#  weight 13 (exp counted as 1), accumulate 3; antialias adds 3
K1_OPS_PER_NEIGHBOUR = 23
#  K2, per pixel, member and output channel: the 5 multiply-adds of the blend
K2_OPS_PER_MEMBER_CHANNEL = 10


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def bench_bank(seed=0, stages=2):
    """The random bank of bench.py: shipped LeRF-G shapes, seeded."""
    from lerf_torch.lut.io import LUTBank

    rng = np.random.RandomState(seed)
    feature = [{m: rng.randint(-127, 128, (L4, 1)).astype(np.int8)
                for m in MODES} for _ in range(stages - 1)]
    s2 = {f"{m}r{r}": rng.randint(-127, 128, (L4, 3)).astype(np.int8)
          for m in MODES for r in (0, 1)}
    return LUTBank(stage1=feature[-1], stage2=s2, out_c=3,
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


def profile_upscale(pred, frame, frames=10):
    """Where a whole ``upscale`` call's time goes: torch.profiler device
    time per frame by kernel / copy, and the device's busy share of the
    host wall clock (one stream, so device activities do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(frames):
            pred.upscale(frame, SCALE, SCALE)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / frames
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / frames)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    return {"phase": "profile", "frames": frames, "wall_ms": wall_ms,
            "device_busy_ms": busy, "busy_share": busy / wall_ms,
            "device_ms_by_name": [[k[:60], ms] for k, ms in rows[:10]]}


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NON_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(geom, c):
    """(bytes, operations) of one K1 call: feature and codes read once,
    the float32 output and the device geometry written/read once."""
    (h, w), (oh, ow), s = geom.in_sz, geom.out_sz, geom.support
    nbytes = c * h * w * 4 * 4 + c * oh * ow * 4 + (oh + ow) * s * 8
    per = K1_OPS_PER_NEIGHBOUR + (3 if geom.antialias else 0)
    return nbytes, c * oh * ow * (s * s * per + 1)


def k2_work(c, h, w, oc, n_tables, n_members):
    """(bytes, operations) of one K2 call: image and tables read once,
    the int32 stage output written once."""
    nbytes = c * h * w * 4 + n_tables * L4 * oc + c * h * w * oc * 4
    return nbytes, c * h * w * n_members * oc * K2_OPS_PER_MEMBER_CHANNEL


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
    from lerf_torch.ops.resample import steering_resize_codes_plain
    from lerf_torch.pipeline import LutPredictor, _quantize_device

    dev = torch.device("cuda")
    card = card_line()

    # -- 1. card, torch, build ---------------------------------------------
    print(card, flush=True)
    t0 = time.perf_counter()
    _, log = _build.build()
    _build.library()
    emit({"phase": "build", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0})
    for line in log.splitlines():
        if "registers" in line or "stack frame" in line:
            print("ptxas:", line.strip(), flush=True)

    rng = np.random.RandomState(1)
    shape = (3, LR_H, LR_W)

    # -- 2. K1 vs its plain twin -------------------------------------------
    feat = torch.from_numpy(rng.randint(0, 256, shape).astype(np.int32)).to(dev)
    codes = torch.from_numpy(
        rng.randint(0, 256, shape + (3,)).astype(np.int32)).to(dev)
    k1_err = 0.0
    for scale in (4.0, 2.5, 3.55, 0.5):
        geom = ResizeGeometry.create((LR_H, LR_W), scale_factors=[scale] * 2)
        got = k1.steering_resize(feat, codes, geom)
        want = steering_resize_codes_plain(feat, codes, geom)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K1 x{scale}: non-finite output")
        err = float((got - want).abs().max())
        if err > K1_ATOL:
            raise AssertionError(f"K1 x{scale}: max-abs {err} > {K1_ATOL}")
        n = check_ties(_quantize_device(got, 255).cpu().numpy(),
                       _quantize_device(want, 255).cpu().numpy(),
                       want.cpu().numpy(),
                       f"K1 x{scale}")
        k1_err = max(k1_err, err)
        emit({"phase": "k1_vs_plain", "scale": scale,
              "out": list(geom.out_sz), "antialias": geom.antialias,
              "support": geom.support, "max_abs_err": err,
              "u8_mismatch": n})

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
    k1.launches = 0
    k2.launches = 0
    out, feat_o, hyper_o = pred.upscale(frame, SCALE, SCALE, return_aux=True)
    torch.cuda.synchronize()
    launches = {"steering_resize": k1.launches, "lut_stage": k2.launches}
    if launches != {"steering_resize": 1, "lut_stage": 2}:
        raise AssertionError(f"main path launches {launches}, want K1 1, K2 2")
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
    host = []
    for i in range(3 + 20):
        t = time.perf_counter()
        pred.upscale(frame, SCALE, SCALE)
        if i >= 3:
            host.append((time.perf_counter() - t) * 1e3)
    upscale_ms = statistics.median(host)
    x = torch.from_numpy(np.ascontiguousarray(
        frame.transpose(2, 0, 1)).astype(np.int32)).to(dev)
    device_ms = frame_ms(lambda: pred.run_device(x, (SCALE, SCALE)))
    emit({"phase": "timing", "frames": 20, "upscale_ms": upscale_ms,
          "upscale_mps": mp / upscale_ms * 1e3, "device_ms": device_ms,
          "device_mps": mp / device_ms * 1e3})
    emit(profile_upscale(pred, frame))

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
        plain_ms = event_ms(lambda: lp.lut_stage_plain(
            inp, tables, MODES, split_r=split_r, den=den, bias=bias),
            iters=5, warmup=1)
        nbytes, nops = k2_work(3, LR_H, LR_W, oc, len(tables.keys), 12)
        b_ms, b_by = bound(nbytes, nops)
        row = {"kernel": "lut_stage", "stage": name, "ms": ms,
               "launches_per_frame": 1, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "ops": nops}
        emit(row)
        k2_rows.append(row)
    k1_ms = event_ms(lambda: k1.steering_resize(feat_d, hyper_d, geom,
                                                operands=ops), iters=50)
    k1_plain_ms = event_ms(lambda: steering_resize_codes_plain(
        feat_d, hyper_d, geom), iters=5, warmup=1)
    k1_bytes, k1_ops = k1_work(geom, 3)
    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    emit({"kernel": "steering_resize", "ms": k1_ms, "launches_per_frame": 1,
          "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
          "bytes": k1_bytes, "ops": k1_ops})

    k2_bytes = sum(r["bytes"] for r in k2_rows)
    k2_ops = sum(r["ops"] for r in k2_rows)
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    kernels = [
        {"name": "steering_resize", "route": "cuda",
         "source": "lerf_torch/csrc/steering_resize.cu",
         "replaces": "lerf_tpu/ops/pallas/resize_kernel.py:118",
         "launches": launches["steering_resize"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "lut_stage", "route": "cuda",
         "source": "lerf_torch/csrc/lut_stage.cu",
         "replaces": "lerf_tpu/ops/lut_pipeline.py:255",
         "launches": launches["lut_stage"], "max_abs_err": 0,
         "ms": sum(r["ms"] for r in k2_rows),
         "plain_ms": sum(r["plain_ms"] for r in k2_rows),
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
    ]

    # -- 6. result ----------------------------------------------------------
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
