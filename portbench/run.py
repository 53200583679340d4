"""The benchmark of ``lerf_torch`` on an H100: one run of one cell.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The last line of standard output is the
result's JSON object; the numbers the reference comparison decided
``correct`` on are the last lines of standard error.  Exits 2 without a
card (or with fewer than the cell asks for) and 3 if a module of JAX or
of the JAX package was loaded, printing no result either way.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one host thread for torch's and numpy's pools: the host shares its cores
os.environ.setdefault("OMP_NUM_THREADS", "1")
FORBIDDEN = ("jax", "jaxlib", "flax", "lerf_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch
    t_torch = time.perf_counter()
    torch.set_num_threads(1)
    import lerf_torch.pipeline  # noqa: F401
    import lerf_torch.serve.engine  # noqa: F401
    from portbench import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = harness.cell_spec(json.load(f), args.workload)
    chips = spec.cell["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    phases = harness.Phases(T0)
    phases.times["import_torch"] = t_torch - T0
    phases.mark("import_rest")
    phases.times["import_rest"] -= phases.times["import_torch"]
    result, record = harness.run(spec, args.seed, args.seconds,
                                 bool(args.trace), "cuda:0", phases)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or its package loaded: {bad}",
              file=sys.stderr)
        return 3
    record["forbidden_modules"] = bad
    path = harness.write_record(args.workload, args.seed, bool(args.trace),
                                record)
    print("setup phases (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in record["phases"].items())
        + f"; setup_s {record['setup_s']:.4f}; record {path}",
        file=sys.stderr)
    print("no module of jax, jaxlib, flax or lerf_tpu was loaded",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def keep_bytecode():
    """Keep the bytecode Python compiles from the imported sources (torch's
    thousands of modules among them) in a fixed directory of the
    checkout, so that only a checkout's first run compiles it: where the
    sources' own cache directories are not written, every run compiled
    them again, seconds of the set-up on one core."""
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")


if __name__ == "__main__":
    keep_bytecode()
    sys.exit(main())
