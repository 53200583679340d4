"""The readings the limits of ``correct`` are set from, at a cell's own
size: the control (the plain reference in the nearest precision below
the configuration's, ``control`` in its file) against the reference, on
the frames and homographies a run of that seed sends first.

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,3

prints one JSON line a seed with the control's numbers.  The program's
own readings are those its runs print; the benchmark's runs never run
this.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(spec, seed: int, device) -> dict:
    """The control's numbers on ``sample_frames`` requests of ``seed``."""
    import numpy as np
    from portbench import generate, harness, reference

    cfg, t = spec.cfg, spec.traffic
    weights = reference.make_weights(cfg, generate.seed64(seed), device)
    pool = generate.frame_pool(t, seed, device)
    stream = generate.Stream(t, pool,
                             np.random.default_rng(generate.seed64(seed)))
    control = reference.Reference(cfg, weights, device, cfg["control"])
    samples = []
    for _ in range(t["sample_frames"]):
        i, matrix = stream.next()
        value = (control.warp(pool[i], matrix, tuple(t["out_hw"]))
                 if t["kind"] == "warp" else control.upscale(pool[i],
                                                             t["scale"]))
        samples.append(((i, matrix), value))
    return harness.compare(spec, weights, pool, samples, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench import harness
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = harness.cell_spec(json.load(f), args.workload)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control_numbers(spec, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": spec.cfg["control"], **numbers}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
