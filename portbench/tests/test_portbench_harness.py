"""The harness end to end on the CPU at 24×32, its result line, its
refusal without a card, and ``correct`` coming out false when the timed
path is broken underneath."""
import json
import time

import numpy as np
import pytest

from conftest import all_workloads, bench_all, tiny, workloads
from portbench import harness, run, system, trace


def _run(spec, traced=False, seconds=0.5, seed=2**31 + 5):
    phases = harness.Phases(time.perf_counter())
    return harness.run(spec, seed, seconds, traced, "cpu", phases)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", all_workloads())
def test_run_prints_a_well_formed_line(workload, traced, one_thread):
    spec = tiny(harness.cell_spec(bench_all(), workload))
    result, record = _run(spec, traced)
    line = json.loads(json.dumps(result))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= record["frames_done"] > 0
    want = spec.per_layer if traced else spec.end_to_end
    got = line["metrics"]
    if traced:   # no device on the CPU: only the host's metrics read
        assert {"dispatch_ms", "mfu_pct"} <= set(got)
        assert line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(got) == {m["name"] for m, _ in want}
        assert got["setup_s"]["value"] == pytest.approx(record["setup_s"])
    for m in got.values():
        assert np.isfinite(m["value"]) and m["value"] >= 0
    assert set(record["phases"]) == {"weights", "inputs", "predictor",
                                     "first_frame", "warmup"}
    assert set(line["checks"]) == set(spec.limits)


def test_run_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rc = run.main(["--workload", workloads()[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "CUDA" in out.err


def test_forbidden_modules_compared_by_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "lerf_tpu_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax"]


class _Faulty:
    """The predictor with a fault planted where its answers are made."""

    def __init__(self, p, fault):
        self.p, self.fault, self.first = p, fault, None

    def _wrap(self, fut):
        outer = self

        class F:
            def result(self):
                v = fut.result()
                frame = v[0] if isinstance(v, tuple) else v
                if outer.fault == "altered":
                    frame = np.minimum(frame, 254) + 1
                elif outer.fault == "stale":
                    outer.first = outer.first if outer.first is not None \
                        else frame
                    frame = outer.first
                return (frame,) + v[1:] if isinstance(v, tuple) else frame
        return F()

    def upscale_dynamic_async(self, *a, **k):
        return self._wrap(self.p.upscale_dynamic_async(*a, **k))

    def warp_dynamic_async(self, *a, **k):
        return self._wrap(self.p.warp_dynamic_async(*a, **k))


@pytest.mark.parametrize("fault", ["altered", "stale"])
@pytest.mark.parametrize("workload", all_workloads())
def test_a_broken_path_is_not_correct(workload, fault, monkeypatch,
                                      one_thread):
    """An answer altered where it is made (every value one level up), or
    the state never moving on (every request answered with the first
    result), reads false."""
    build = system.build
    monkeypatch.setattr(system, "build",
                        lambda *a: _Faulty(build(*a), fault))
    spec = tiny(harness.cell_spec(bench_all(), workload))
    spec.traffic["sample_frames"] = 8
    result, _ = _run(spec, seconds=1.0)
    assert result["correct"] is False


def test_trace_busy_time_and_breakdown():
    t = trace.Trace(kernels=[("k<a>", 0, 10), ("k<a>", 5, 10),
                             ("other", 100, 5)],
                    copies=[("Memcpy DtoH", 40, 20)],
                    spans=[("pb.wait", 20, 95), ("pb.dispatch", 70, 80)],
                    window_s=1e-6)
    assert t.busy_s() == pytest.approx(40e-9)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k_a_", 20e-9]
    assert b["idle_gaps"] == [["pb.wait", 40e-9], ["pb.host", 25e-9]]
    assert t.seconds(lambda n: n.startswith("k")) == (2, 20e-9)


@pytest.mark.parametrize("workload", ["lerf-g.video-1080p-x2",
                                      "lerf-g.warp-1080p-4k"])
def test_several_streams_run_concurrently(workload, one_thread):
    """A traffic file's ``streams`` runs that many closed loops, each on
    a host thread of its own; every frame of each is counted and
    checked, and the set-up serves each stream its warm-up frames."""
    spec = tiny(harness.cell_spec(bench_all(), workload))
    spec.traffic.update(streams=2, sample_frames=8)
    result, record = _run(spec)
    assert result["correct"] is True
    assert result["attempted"] >= record["frames_done"] >= 2
    assert record["numbers"]["frames"] == 8
