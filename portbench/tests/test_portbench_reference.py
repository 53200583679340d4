"""The plain reference against the program's CPU path at a tiny size,
and the control (its lower precision) against the reference."""
import numpy as np
import pytest
import torch

from conftest import all_workloads, bench_all, tiny
from portbench import calibrate, generate, harness, reference, system

SEEDS = (3, 2**31 + 11)


def _program_frames(spec, seed):
    cfg, t = spec.cfg, spec.traffic
    weights = reference.make_weights(cfg, seed, "cpu")
    pool = generate.frame_pool(t, seed, "cpu")
    stream = generate.Stream(t, pool, np.random.default_rng(seed))
    p = system.build(cfg, weights, "cpu")
    out = []
    for _ in range(3):
        i, m = stream.next()
        value = (p.warp_dynamic(pool[i], m, tuple(t["out_hw"]))
                 if t["kind"] == "warp"
                 else p.upscale_dynamic(pool[i], t["scale"], t["scale"]))
        out.append(((i, m), value))
    return weights, pool, out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", all_workloads())
def test_reference_equals_the_programs_cpu_path(workload, seed, one_thread):
    spec = tiny(harness.cell_spec(bench_all(), workload))
    weights, pool, samples = _program_frames(spec, seed)
    numbers = harness.compare(spec, weights, pool, samples, "cpu")
    assert numbers["frames"] == 3
    assert numbers["diff_share"] == 0.0 and numbers["max_diff"] == 0
    assert numbers.get("mask_diff", 0) == 0


def test_lut_stages_equal_the_programs(one_thread):
    from lerf_torch.ops.lut_pipeline import (FlatTables, lut_stage1,
                                             lut_stage2)
    from portbench.reference import lut
    spec = tiny(harness.cell_spec(bench_all(), "lerf-g.video-1080p-x2"))
    cfg = spec.cfg
    bank = lut.make_weights(cfg, 5, "cpu")
    img = torch.from_numpy(generate.frame_pool(spec.traffic, 5, "cpu")[0]) \
        .permute(2, 0, 1).to(torch.int32)
    t1 = FlatTables.create({k: v.numpy() for k, v in bank["stage1"].items()})
    t2 = FlatTables.create({k: v.numpy() for k, v in bank["stage2"].items()})
    feat = lut_stage1(img, t1, cfg["modes"])
    hyper = lut_stage2(feat, t2, cfg["modes2"])
    ref_feat = lut.stage(img, bank["stage1"], cfg["modes"], split_r=False,
                         den=48, bias=0, interval=4)[..., 0]
    assert torch.equal(ref_feat, feat)
    assert torch.equal(lut.stage(feat, bank["stage2"], cfg["modes2"],
                                 split_r=True, den=192, bias=127,
                                 interval=4), hyper)
    # the seeded bank's feature follows the frame
    assert (feat - img).abs().float().mean() < 8


@pytest.mark.parametrize("workload", ["lerf-g.video-1080p-x2",
                                      "lerf-g.warp-1080p-4k"])
def test_control_fails_the_limits(workload, one_thread):
    """The LUT cells' control, the resampler in bf16, is not correct."""
    spec = tiny(harness.cell_spec(bench_all(), workload))
    numbers = calibrate.control_numbers(spec, 9, "cpu")
    found = harness.checks(numbers, spec.limits)
    assert not harness.is_correct(found, numbers["frames"], 3)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", all_workloads())
def test_control_fails_the_limits_on_the_card(workload, card):
    """Every cell's control (TF32 towers for the IMDN form) at a size a
    test holds, 216×384 frames, on the card."""
    spec = tiny(harness.cell_spec(bench_all(), workload))
    spec.traffic["frame_hw"] = [216, 384]
    if "out_hw" in spec.traffic:
        spec.traffic["out_hw"] = [int(spec.traffic["zoom"] * v)
                                  for v in (216, 384)]
    numbers = calibrate.control_numbers(spec, 9, card)
    found = harness.checks(numbers, spec.limits)
    assert not harness.is_correct(found, numbers["frames"], 3)
