#!/usr/bin/env python3
"""What bounds K3 and K4 on the card: time variants of each kernel with one
part taken out.

    python3 lerf_torch/tools/probe_srnet_kernels.py [--against DIR --rounds N]

Each variant is the kernel's source with one text substitution (no tensor
core products; K3 with one TF32 product instead of three, no activation
split, no group barriers, or its weights read as float32 and split on
chip; K4 with no requantization arithmetic; either with no wait for the
weight copies or no weight copies), built on its own with the package's
nvcc flags and timed with CUDA events on one 3×360×640 stage (nf 64, 12
members, oC 1), beside the kernel as built. Only the unchanged kernel
computes the right numbers; the others are timings. With ``--against
DIR`` it times another revision's two sources (DIR/srnet_ensemble.cu,
DIR/srnet_ensemble_int8.cu, e.g. the parent commit's) beside these, in
alternating rounds, instead. Prints one JSON line per timing and the card
line (name, power limit).
"""
from __future__ import annotations

import ctypes
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

# kernel source → {variant: [(old text, new text), ...]}
VARIANTS = {
    "srnet_ensemble": {
        "no tensor-core products": [(
            'asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "\n'
            '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"\n'
            '      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])\n'
            '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), '
            '"r"(__float_as_uint(b0)),\n'
            '        "r"(__float_as_uint(b1)));',
            "c[0] += __uint_as_float(a[0] ^ a[3]) + b0; c[1] += b1;")],
        "one TF32 product": [("for (int term = 0; term < 3; ++term)",
                              "for (int term = 2; term < 3; ++term)")],
        "no wait for weights": [(
            "mbar_wait(&full[buf], (c / kStages) & 1);", "")],
        "no weight copies": [("cp_async16(buf + 4 * i, src + 4 * i);", ";")],
        "no activation split": [
            ("    hi[e] = (__float_as_uint(a[e]) + 0x1000u) & 0xffffe000u;\n"
             "    lo[e] = __float_as_uint(a[e] - __uint_as_float(hi[e]));",
             "    hi[e] = lo[e] = __float_as_uint(a[e]);")],
        "no group barriers": [(
            'asm volatile("bar.sync %0, 64;\\n" ::"r"(group + 1) : "memory");',
            "")],
        "B read as 8 bytes a lane and split on chip": [(
            "for (int j = 0; j < NJ; ++j) "
            "b[s][j] = wf[32 * (s * nt + J0 + j)];",
            "for (int j = 0; j < NJ; ++j) {\n"
            "  const int ln = threadIdx.x & 31;\n"
            "  const float2 w2 = reinterpret_cast<const float2*>(wf - ln)"
            "[64 * (s * nt + J0 + j) + ln];\n"
            "  const uint32_t h0 = (__float_as_uint(w2.x) + 0x1000u)"
            " & 0xffffe000u;\n"
            "  const uint32_t h1 = (__float_as_uint(w2.y) + 0x1000u)"
            " & 0xffffe000u;\n"
            "  b[s][j] = make_float4(__uint_as_float(h0), __uint_as_float(h1),"
            " w2.x - __uint_as_float(h0), w2.y - __uint_as_float(h1));\n}")],
    },
    "srnet_ensemble_int8": {
        "no tensor-core products": [(
            'asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "\n'
            '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"\n'
            '      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])\n'
            '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), '
            '"r"(b.y));',
            "c[0] += a[0] ^ a[3] ^ b.x; c[1] += b.y;")],
        "no requantization": [(
            "  const float a = WIDE ? (float)acc\n"
            "                       : __fsub_rn(__int_as_float(kMagicBits + "
            "acc), kMagic);",
            "  return (unsigned)acc & 0x7fu;\n  const float a = 0.0f;")],
        "no wait for weights": [(
            'asm volatile("cp.async.wait_group %0;\\n" ::"n"(kStages - 2) '
            ': "memory");', "")],
        "no weight copies": [("cp_async16(buf + 4 * i, src + 4 * i);", ";")],
    },
}


def build_variants(tmp, against=None):
    """Every variant's shared library, built in parallel: {(kernel,
    variant): path}; with ``against`` (a directory holding another
    revision's ``srnet_ensemble.cu`` and ``srnet_ensemble_int8.cu``, e.g.
    the parent commit's ``lerf_torch/csrc`` unpacked under the gitignored
    ``_archive/``) that revision's kernels too, as the variant
    ``"against"``."""
    from lerf_torch.ops.kernels import _build

    jobs = {}
    for kernel, variants in VARIANTS.items():
        with open(os.path.join(_build.CSRC, kernel + ".cu")) as f:
            src = f.read()
        named = {"as built": [], **variants}
        if against:
            named = {"as built": [], "against": None}
        for name, subs in named.items():
            if subs is None:
                with open(os.path.join(against, kernel + ".cu")) as f:
                    text = f.read()
            else:
                text = src
                for old, new in subs:
                    if text.count(old) != 1:
                        raise RuntimeError(
                            f"{kernel} / {name}: substitution not found "
                            f"once: {old[:60]!r}")
                    text = text.replace(old, new)
            stem = os.path.join(tmp, f"{kernel}_{len(jobs)}")
            with open(stem + ".cu", "w") as f:
                f.write(text)
            jobs[(kernel, name)] = stem
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                      stem + ".cu", "-o", stem + ".so"]
                     for stem in jobs.values()])
    return {key: stem + ".so" for key, stem in jobs.items()}


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--against", help="a directory with another "
                    "revision's srnet_ensemble{,_int8}.cu: time its kernels "
                    "beside these, alternating, instead of the variants")
    ap.add_argument("--rounds", type=int, default=1,
                    help="alternating rounds (as built, other, other, as "
                    "built) with --against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_srnet_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lerf_torch.models import srnet
    from lerf_torch.ops.kernels import srnet_ensemble as k3
    from lerf_torch.ops.kernels import srnet_ensemble_int8 as k4
    from lerf_torch.ops.lut_pipeline import member_offsets

    card = cs.card_line()
    dev = torch.device("cuda")
    params = cs.net_params()
    members = srnet.stage_members(cs.MODES)
    offsets = member_offsets(members)
    heads = srnet.stage1_heads(params, 0, cs.MODES)
    sh = k3.StackedHeads.create(heads, dev)
    qh = k4.QuantHeads.create(
        srnet.stage1_heads(srnet.quantize_lerf_params(params), 0, cs.MODES),
        dev)
    codes = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (3, cs.LR_H, cs.LR_W)).astype(np.int32)).to(dev)
    img = codes.to(torch.float32) / 255.0
    out = torch.empty(3, cs.LR_H, cs.LR_W, 1, device=dev)
    args_of = {"srnet_ensemble": (img, [*sh.frags, *sh.b]),
               "srnet_ensemble_int8": (codes, [*qh.frags, *qh.c, *qh.b])}
    want = {"srnet_ensemble": k3.ensemble_sum(img, sh, members, half=127),
            "srnet_ensemble_int8": k4.ensemble_sum_int8(codes, qh, members,
                                                        half=127)}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, args.against)
        runs = {}
        for (kernel, name), path in libs.items():
            fn = getattr(ctypes.CDLL(path), "lerf_" + kernel)
            fn.restype = ctypes.c_int
            x, ops = args_of[kernel]
            with open(path[:-3] + ".cu") as f:
                typed = "int bf16, void* stream" in f.read()
            cargs = [ctypes.c_void_p(x.data_ptr()),
                     ctypes.c_void_p(out.data_ptr()),
                     *(ctypes.c_void_p(t.data_ptr()) for t in ops),
                     ctypes.c_void_p(offsets.ctypes.data),
                     *map(ctypes.c_int, (len(members), 3, cs.LR_H, cs.LR_W,
                                         cs.NF, 1)),
                     ctypes.c_float(127.0),
                     *([ctypes.c_int(0)] if typed else []),
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)]

            def run(fn=fn, cargs=cargs, kernel=kernel, name=name):
                err = fn(*cargs)
                if err:
                    raise RuntimeError(f"{kernel} / {name}: CUDA error {err}")

            runs[kernel, name] = run
        order = [(k, n) for k, n in runs]
        if args.against:
            order = [(k, n) for _ in range(args.rounds) for k in VARIANTS
                     for n in ("as built", "against", "against", "as built")]
        for kernel, name in order:
            ms = cs.event_ms(runs[kernel, name], iters=5, warmup=1)
            print(json.dumps({"kernel": kernel, "variant": name, "ms": ms,
                              "equals_kernel": bool(torch.equal(
                                  out, want[kernel])), "card": card}),
                  flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
