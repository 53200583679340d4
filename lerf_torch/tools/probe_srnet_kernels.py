#!/usr/bin/env python3
"""What bounds K3 and K4 on the card: time variants of each kernel with one
part taken out.

    python3 lerf_torch/tools/probe_srnet_kernels.py [--against DIR --rounds N]
    python3 lerf_torch/tools/probe_srnet_kernels.py --bf16 [--rounds N]

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
alternating rounds, instead.

``--bf16`` probes K3's bf16 kernel (``csrc/srnet_ensemble_bf16.cu``)
instead, again by substitutions (``BF16_VARIANTS``): no ``wgmma`` products,
no weight copies, no epilogue fence and barrier, no epilogue stores, and
the choices the kernel makes by padded nf changed (the other sum order,
one pass above nf 64); each timed at nf 64 and 128 on one 3×360×640 stage
(12 members, oC 1). Then a frame (both stages) of the kernel as built, in
alternating rounds, against its first design
(``tools/srnet_ensemble_bf16_first.cu``) and against each variant that
computes its function. Those variants are held to the twin at the stage
shapes (oC 1 and 3, nf 64 and 128) and at every ``NET_CASES`` entry of
``tests/test_torch_kernels.py``: the share of sums that differ and the
largest difference. Prints one JSON line per timing and the card line
(name, power limit).
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


# K3 bf16: variant → substitutions of its code lines (the parts taken out)
# or of its choices by padded nf (the other sum orders and passes)
BF16_VARIANTS = {
    "no wgmma": [(
        "  if constexpr (P == 128)\n"
        "    wgmma_n128(part, a, b, scale_d);\n"
        "  else if constexpr (P == 64)\n"
        "    wgmma_n64(part, a, b, scale_d);\n"
        "  else if constexpr (P == 32)\n"
        "    wgmma_n32(part, a, b, scale_d);\n"
        "  else if constexpr (P == 16)\n"
        "    wgmma_n16(part, a, b, scale_d);\n"
        "  else\n"
        "    wgmma_n8(part, a, b, scale_d);\n",
        "  part[0] += __uint_as_float((uint32_t)(a ^ b) & 0x3fffu) +"
        " (float)scale_d;\n")],
    "no weight copies": [
        ("mbar_expect_tx(full(slot), n * pb);", "mbar_arrive(full(slot));"),
        ("for (int k = 0; k < (whole ? 1 : n); ++k)",
         "for (int k = 0; k < 0; ++k)")],
    "no epilogue fence and barrier": [(
        "        proxy_fence();                  // generic stores -> the "
        "tensor core\n        wg_sync();\n", "")],
    "no epilogue stores": [(
        "              if (jj + 1 < kNp / 8)\n"
        "                stmatrix_x4(addr, packed(tt, jj, 0), "
        "packed(tt, jj, 1),\n"
        "                            packed(tt, jj + 1, 0), "
        "packed(tt, jj + 1, 1));\n"
        "              else\n"
        "                stmatrix_x2(addr, packed(tt, jj, 0), "
        "packed(tt, jj, 1));\n",
        "              sum[0][0] += __uint_as_float(\n"
        "                  addr ^ packed(tt, jj, 0) ^ packed(tt, jj, 1) ^\n"
        "                  (jj + 1 < kNp / 8 ? packed(tt, jj + 1, 0) ^\n"
        "                   packed(tt, jj + 1, 1) : 0u));\n")],
    "whole fan-in sums above nf 64": [
        ("constexpr bool kChunkSumsWide = true;",
         "constexpr bool kChunkSumsWide = false;")],
    "one pass above nf 64, whole fan-in sums": [
        ("constexpr int kPassesWide = 2;", "constexpr int kPassesWide = 1;"),
        ("constexpr bool kChunkSumsWide = true;",
         "constexpr bool kChunkSumsWide = false;")],
    "chunk sums up to nf 64": [
        ("constexpr bool kChunkSumsNarrow = false;",
         "constexpr bool kChunkSumsNarrow = true;")],
}
# the variants that compute the kernel's function (the others only time)
BF16_EXACT = ("as built", "whole fan-in sums above nf 64",
              "one pass above nf 64, whole fan-in sums",
              "chunk sums up to nf 64")
# those whose choice the kernel makes at nf <= 64 (False) and above (True)
BF16_ROUNDS = {
    False: ("chunk sums up to nf 64",),
    True: ("whole fan-in sums above nf 64",
           "one pass above nf 64, whole fan-in sums")}


def substituted(text, subs, what):
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{what}: substitution not found once: "
                               f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


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
                text = substituted(src, subs, f"{kernel} / {name}")
            stem = os.path.join(tmp, f"{kernel}_{len(jobs)}")
            with open(stem + ".cu", "w") as f:
                f.write(text)
            jobs[(kernel, name)] = stem
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                      stem + ".cu", "-o", stem + ".so"]
                     for stem in jobs.values()])
    return {key: stem + ".so" for key, stem in jobs.items()}


def build_bf16_variants(tmp):
    """K3 bf16's variants and its first design, built in parallel:
    {variant: path}."""
    from lerf_torch.ops.kernels import _build

    with open(os.path.join(_build.CSRC, "srnet_ensemble_bf16.cu")) as f:
        src = f.read()
    texts = {name: substituted(src, subs, f"srnet_ensemble_bf16 / {name}")
             for name, subs in {"as built": [], **BF16_VARIANTS}.items()}
    with open(os.path.join(ROOT, "lerf_torch", "tools",
                           "srnet_ensemble_bf16_first.cu")) as f:
        texts["first design"] = f.read()
    stems = {}
    for i, (name, text) in enumerate(texts.items()):
        stems[name] = os.path.join(tmp, f"srnet_ensemble_bf16_{i}")
        with open(stems[name] + ".cu", "w") as f:
            f.write(text)
    log = _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                            stem + ".cu", "-o", stem + ".so"]
                           for stem in stems.values()])
    return {name: stem + ".so" for name, stem in stems.items()}, log


def bf16_main(args, torch) -> int:
    """``--bf16``: K3 bf16's parts, sum orders and first design."""
    import chip_smoke as cs
    from lerf_torch.models import srnet
    from lerf_torch.ops.kernels import srnet_ensemble as k3
    from lerf_torch.ops.lut_pipeline import member_offsets

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_kernels as tk

    card = cs.card_line()
    dev = torch.device("cuda")
    members = srnet.stage_members(cs.MODES)
    codes = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (3, cs.LR_H, cs.LR_W)).astype(np.int32)).to(dev)
    x = codes.to(torch.float32) / 255.0
    stage_heads = {}                     # (nf, oc) → StackedHeads
    for nf, seed in ((cs.NF, 0), (cs.WIDE_NF, 2)):
        params = cs.bf16_of(cs.net_params(seed=seed, nf=nf))
        for oc in (1, 3):
            stage_heads[nf, oc] = k3.StackedHeads.create(
                srnet.stage1_heads(params, 0, cs.MODES) if oc == 1
                else srnet.stage2_heads(params, cs.MODES), dev)
    with tempfile.TemporaryDirectory() as tmp:
        libs, log = build_bf16_variants(tmp)
        for row in cs.ptxas_rows(log):
            print(json.dumps(row), flush=True)
        for note in sorted({line.split(" in function")[0].strip()
                            for line in log.splitlines()
                            if "(C7" in line and "C7519" not in line}):
            print(json.dumps({"ptxas_note": note}), flush=True)

        def runner(name, img, sh, mem):
            first = name == "first design"
            fn = getattr(ctypes.CDLL(libs[name]), "lerf_srnet_ensemble_bf16"
                         + ("_first" if first else ""))
            fn.restype = ctypes.c_int
            ops = ([cs.bf16_frags(w, k, sh.nf) for k, w in enumerate(sh.w)]
                   if first else list(sh.frags))
            out = torch.empty(img.shape + (sh.oc,), device=dev)
            offsets = member_offsets(mem)
            h, w = img.shape[-2:]
            cargs = [ctypes.c_void_p(img.data_ptr()),
                     ctypes.c_void_p(out.data_ptr()),
                     *(ctypes.c_void_p(t.data_ptr()) for t in ops + [*sh.b]),
                     ctypes.c_void_p(offsets.ctypes.data),
                     *map(ctypes.c_int, (len(mem), img.numel() // (h * w), h,
                                         w, sh.nf, sh.oc)),
                     ctypes.c_float(127.0),
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)]

            def run():
                err = fn(*cargs)
                if err:
                    raise RuntimeError(f"K3 bf16 / {name}: CUDA error {err}")
                return out

            run.keep = (ops, offsets)
            return run

        # what bounds it: each part taken out, nf 64 and 128, stage 1
        for nf in (cs.NF, cs.WIDE_NF):
            sh = stage_heads[nf, 1]
            want = k3.ensemble_sum(x, sh, members, half=127).clone()
            for name in libs:
                run = runner(name, x, sh, members)
                ms = cs.event_ms(run, iters=5, warmup=1)
                print(json.dumps({"kernel": "srnet_ensemble_bf16", "nf": nf,
                                  "variant": name, "ms": ms,
                                  "equals_kernel": bool(torch.equal(
                                      run(), want)), "card": card}),
                      flush=True)
            # a frame (both stages) of the kernel as built against its
            # first design and against each other variant that computes its
            # function, in alternating rounds: medians and each round
            frame = {}
            for name in ("as built", "first design",
                         *BF16_ROUNDS[nf > 64]):
                stages = [runner(name, x, stage_heads[nf, oc], members)
                          for oc in (1, 3)]
                frame[name] = lambda stages=stages: [r() for r in stages]
            times = {name: [] for name in frame}
            for other in list(frame)[1:]:
                for _ in range(args.rounds):
                    for name in ("as built", other, other, "as built"):
                        times[name].append(cs.event_ms(frame[name], iters=10,
                                                       warmup=1))
            for name, ms in times.items():
                print(json.dumps({
                    "kernel": "srnet_ensemble_bf16", "nf": nf,
                    "round_variant": name, "frame_ms": float(np.median(ms)),
                    "min_ms": min(ms), "max_ms": max(ms), "rounds": ms,
                    "card": card}), flush=True)
        # the sum orders against the twin
        cases = {f"stage nf{nf} oc{oc}": (sh, x, members)
                 for (nf, oc), sh in stage_heads.items()}
        for case, (nf, oc, shape, n_members) in sorted(tk.NET_CASES.items()):
            heads, mem = tk.member_case(nf, oc, n_members)
            sh = k3.StackedHeads.create(
                [{k: torch.from_numpy(v).to(torch.bfloat16)
                  for k, v in h.items()} for h in heads], dev)
            img = torch.from_numpy(np.random.RandomState(5).rand(*shape)
                                   .astype(np.float32)).to(dev)
            cases[case] = (sh, img, mem)
        for case, (sh, img, mem) in cases.items():
            want = k3.ensemble_sum_plain(img, sh, mem, half=127)
            for name in BF16_EXACT:
                got = runner(name, img, sh, mem)()
                d = (got.double() - want.double()).abs()
                print(json.dumps({
                    "kernel": "srnet_ensemble_bf16", "case": case,
                    "variant": name, "max_abs_err": float(d.max()),
                    "share_differing": float((d > 0).double().mean()),
                    "tolerance": list(cs.K3_BF16_TOL)}), flush=True)
    print(card)
    return 0


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--against", help="a directory with another "
                    "revision's srnet_ensemble{,_int8}.cu: time its kernels "
                    "beside these, alternating, instead of the variants")
    ap.add_argument("--rounds", type=int, default=1,
                    help="alternating rounds (as built, other, other, as "
                    "built) with --against or --bf16")
    ap.add_argument("--bf16", action="store_true",
                    help="probe K3's bf16 kernel instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_srnet_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    if args.bf16:
        return bf16_main(args, torch)
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
