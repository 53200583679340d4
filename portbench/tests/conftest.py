"""Shared pieces of the benchmark's CPU tests: the cells at a tiny size
(24×32 frames, two in the pool) and a card check made inside a fixture."""
import copy
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

TINY_HW = [24, 32]


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workloads():
    return [w["name"] for w in bench()["workloads"]]


# The LUT cells whose configuration, traffic and limits portbench/ holds
# but BENCHMARK.json does not (their rate is paced by the host: PERF.md,
# Open questions): each with the kernels its roofline readers read.
LUT_CELLS = {"lerf-g.video-1080p-x2": ("video-1080p-x2",
                                       ["k1_roofline", "k2_roofline"]),
             "lerf-g.warp-1080p-4k": ("warp-1080p-4k",
                                      ["k2_roofline", "k5_roofline"])}
SHARED = ["frame_p95_ms", "dispatch_ms", "result_gap_max_ms", "copy_ms",
          "launches_per_frame", "idle_pct", "mfu_pct"]


def bench_all() -> dict:
    """BENCHMARK.json with the LUT cells added as entries alone, as a
    later change would add them; a metric it does not list yet is
    described from its reader."""
    b = bench()
    metrics = {m["name"]: m for m in b["end_to_end"] + b["per_layer"]}
    for name, (traffic, kernels) in LUT_CELLS.items():
        b["workloads"].append({"name": name, "config": "lerf-g",
                               "traffic": traffic, "chips": 1,
                               "why": "a LUT cell"})
        for metric in SHARED + kernels:
            if metric not in metrics:
                r = harness.load_reader([harness.HERE], metric)
                metrics[metric] = {"name": metric, "unit": r.UNIT,
                                   "better": r.BETTER, "source": r.SOURCE,
                                   "layer": r.LAYER, "moves": r.MOVES,
                                   "workloads": []}
                b["per_layer"].append(metrics[metric])
            metrics[metric]["workloads"].append(name)
    return b


def all_workloads():
    return [w["name"] for w in bench_all()["workloads"]]


def tiny(spec):
    """The cell at a size a CPU test holds: the same traffic file but
    24×32 frames (the warp's canvas its zoom times that), two in the
    pool, two warm-up frames."""
    spec = copy.copy(spec)
    spec.traffic = dict(spec.traffic, frame_hw=TINY_HW, pool=2,
                        warmup_frames=2)
    if "out_hw" in spec.traffic:
        spec.traffic["out_hw"] = [int(spec.traffic["zoom"] * v)
                                  for v in TINY_HW]
    return spec


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda:0")
