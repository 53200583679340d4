#!/usr/bin/env python3
"""Whole-call times of the LUT form on the card: ``upscale`` (360×640 →
×4) and ``warp`` (→ 1440×2560 under chip_smoke's ``warp_matrix()``, a
repeated homography), host clock, uint8 in → uint8 out, of the
``lerf_torch`` in ``--tree`` (default: this checkout).

To compare two commits on one card, unpack one under a git-ignored
directory (``git archive <commit> | tar -x -C _archive/parent``) and run
both on the same card, alternating (parent, change, change, parent):

    python3 lerf_torch/tools/time_whole_calls.py --tree _archive/parent
    python3 lerf_torch/tools/time_whole_calls.py

Prints one JSON line: the tree, the card (name, power limit), and for
each call the median ms of each round of ``--frames`` calls.  Imports
neither JAX nor lerf_tpu.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=REPO,
                   help="the checkout whose lerf_torch is timed")
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    sys.path.insert(1, REPO)
    import torch

    if not torch.cuda.is_available():
        print("time_whole_calls: needs a CUDA card", file=sys.stderr)
        return 1
    import lerf_torch
    from chip_smoke import (LR_H, LR_W, SCALE, WARP_OUT, bench_bank,
                            card_line, warp_matrix)
    from lerf_torch.pipeline import LutPredictor

    if not os.path.abspath(lerf_torch.__file__).startswith(tree):
        raise RuntimeError(f"lerf_torch imported from {lerf_torch.__file__}"
                           f", not from {tree}")
    pred = LutPredictor(bench_bank())
    frame = np.random.RandomState(0).randint(0, 256, (LR_H, LR_W, 3)) \
        .astype(np.uint8)
    m = warp_matrix()
    calls = {"upscale": lambda: pred.upscale(frame, SCALE, SCALE),
             "warp": lambda: pred.warp(frame, m, WARP_OUT)}
    for call in calls.values():
        for _ in range(3):
            call()
    rounds = {name: [] for name in calls}
    for _ in range(args.rounds):
        for name, call in calls.items():
            times = []
            for _ in range(args.frames):
                t = time.perf_counter()
                call()
                times.append((time.perf_counter() - t) * 1e3)
            rounds[name].append(statistics.median(times))
    print(json.dumps({"tree": os.path.relpath(tree, REPO),
                      "card": card_line(), "frames": args.frames,
                      **{f"{name}_ms": ms for name, ms in rounds.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
