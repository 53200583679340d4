"""One run of one cell: set-up by timed phases, the measured window, the
trace, the metric readers and the comparison with the plain reference.

Everything a cell is comes from files found by name: the workload in
``BENCHMARK.json``; its configuration (``configs/<config>.json``), traffic
(``traffic/<traffic>.json``) and limits (``limits/<workload>.json``); one
reader a metric (``metrics/<metric>.py``).  The system under test is
built by ``system/<form>.py`` from weights the benchmark makes
(``reference/<form>.py``), and driven through
``lerf_torch.serve.engine``'s streams, closed loop at the traffic's depth.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import threading
import time
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import torch

from . import generate, reference, system, trace as tracing
from .work import frame as frame_work

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RUNS = os.path.join(ROOT, "portbench_runs")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find(dirs, kind: str, name: str) -> str:
    """The file ``<kind>/<name>`` in the first of ``dirs`` that has it."""
    for d in dirs:
        path = os.path.join(d, kind, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {kind}/{name} in {list(dirs)}")


def load_reader(dirs, name: str):
    """The metric reader ``metrics/<name>.py`` as a module."""
    path = find(dirs, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_spec(bench: dict, workload: str, dirs=(HERE,)) -> SimpleNamespace:
    """The workload's cell: its entry, configuration, traffic, limits and
    the metrics it reports, each with its reader."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return SimpleNamespace(
        cell=cell,
        cfg=load_json(find(dirs, "configs", cell["config"] + ".json")),
        traffic=load_json(find(dirs, "traffic", cell["traffic"] + ".json")),
        limits=load_json(find(dirs, "limits", workload + ".json")),
        end_to_end=[(m, load_reader(dirs, m["name"])) for m in e2e],
        per_layer=[(m, load_reader(dirs, m["name"])) for m in per_layer])


class Phases:
    """Set-up timed by phase on the host clock, from ``t0``."""

    def __init__(self, t0: float):
        self.t0 = self.last = t0
        self.times = {}

    def mark(self, name: str, device=None):
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        self.times[name] = now - self.last
        self.last = now

    def total(self) -> float:
        return self.last - self.t0


class _Log:
    """One stream's record: each request's pool index and matrix, call
    time, dispatch seconds and result time."""

    def __init__(self):
        self.requests, self.t_call, self.t_disp, self.t_done = [], [], [], []


class _Timed:
    """The predictor as the engine sees it, with the benchmark's spans
    around each call into it and each wait for a result."""

    def __init__(self, predictor, log: _Log, sampler, span):
        self.p, self.log = predictor, log
        self.sampler, self.span = sampler, span

    def _call(self, fn, *args, **kwargs):
        t = time.perf_counter()
        with self.span("pb.dispatch"):
            fut = fn(*args, **kwargs)
        self.log.t_call.append(t)
        self.log.t_disp.append(time.perf_counter() - t)
        return _Future(self, fut, len(self.log.t_call) - 1)

    def upscale_dynamic_async(self, *args, **kwargs):
        return self._call(self.p.upscale_dynamic_async, *args, **kwargs)

    def warp_dynamic_async(self, *args, **kwargs):
        return self._call(self.p.warp_dynamic_async, *args, **kwargs)


class _Future:
    __slots__ = ("owner", "fut", "k")

    def __init__(self, owner: _Timed, fut, k: int):
        self.owner, self.fut, self.k = owner, fut, k

    def result(self):
        with self.owner.span("pb.wait"):
            value = self.fut.result()
        t = time.perf_counter()
        self.owner.log.t_done.append(t)
        self.owner.sampler.offer(self.owner.log, self.k, value, t)
        return value


class Sampler:
    """A seeded reservoir of ``k`` results completed before ``t_end``:
    the frames the reference checks.  It holds the results' own arrays
    (pinned host memory), so keeping one copies nothing."""

    def __init__(self, k: int, rng):
        self.k, self.rng = k, rng
        self.lock = threading.Lock()
        self.reset(float("inf"))

    def reset(self, t_end: float):
        self.t_end, self.seen, self.kept = t_end, 0, []

    def offer(self, log: _Log, k: int, value, t: float):
        if t > self.t_end:
            return
        item = (log.requests[k], value)
        with self.lock:
            self.seen += 1
            if len(self.kept) < self.k:
                self.kept.append(item)
            else:
                j = int(self.rng.integers(self.seen))
                if j < self.k:
                    self.kept[j] = item


class Driver:
    """The traffic's streams over the predictor through
    ``lerf_torch.serve.engine``: one stream on this thread, several each
    on a host thread of its own, as concurrent clients."""

    def __init__(self, predictor, traffic: dict, pool, rng, traced: bool):
        from lerf_torch.serve import engine
        self.engine = engine
        self.p, self.traffic, self.pool = predictor, traffic, pool
        self.span = torch.profiler.record_function if traced else (
            lambda name: nullcontext())
        # the first stream draws from ``rng`` itself, as calibrate.py's
        # requests do; each other stream, and the sampler, from a
        # generator of their own, so no draw depends on the threads' order
        self.streams = [generate.Stream(traffic, pool, rng if k == 0 else
                                        generate.child_rng(rng))
                        for k in range(traffic["streams"])]
        self.sampler = Sampler(traffic["sample_frames"],
                               generate.child_rng(rng))

    def _requests(self, stream, log, more):
        t = self.traffic
        while more():
            i, matrix = stream.next()
            log.requests.append((i, matrix))
            if t["kind"] == "warp":
                yield self.pool[i], matrix
            else:
                yield self.pool[i], t["scale"], t["scale"]

    def _serve(self, make_more):
        """Run every stream to its end; ``make_more()`` gives each stream
        its own test, asked before each request."""
        t = self.traffic
        logs = [_Log() for _ in self.streams]
        gens = []
        for stream, log in zip(self.streams, logs):
            p = _Timed(self.p, log, self.sampler, self.span)
            reqs = self._requests(stream, log, make_more())
            gens.append(self.engine.stream_warp(p, reqs, tuple(t["out_hw"]),
                                                depth=t["depth"])
                        if t["kind"] == "warp" else
                        self.engine.stream_upscale(p, reqs, depth=t["depth"]))
        errors = []

        def drain(g):
            try:
                for _ in g:
                    pass
            except BaseException as e:  # raised again on this thread
                errors.append(e)

        threads = [threading.Thread(target=drain, args=(g,))
                   for g in gens[1:]]
        for th in threads:
            th.start()
        drain(gens[0])
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        return logs

    def frames(self, n: int):
        """Serve ``n`` frames a stream, the results kept as a window
        keeps them (so the pinned pool grows to the window's size)."""
        def make_more():
            left = iter(range(n))
            return lambda: next(left, None) is not None
        self._serve(make_more)

    def window(self, seconds: float):
        """Serve until ``seconds`` have passed, then drain.  Returns
        (t_start, t_end, logs)."""
        t_start = time.perf_counter()
        t_end = t_start + seconds
        self.sampler.reset(t_end)
        logs = self._serve(lambda: lambda: time.perf_counter() < t_end)
        return t_start, t_end, logs


def out_px(traffic: dict) -> int:
    h, w = frame_work.out_hw(traffic)
    return h * w


def window_context(spec, seconds, t_end, logs, setup_s, trace):
    """What the metric readers read."""
    done = [(c, d, disp) for log in logs
            for c, d, disp in zip(log.t_call, log.t_done, log.t_disp)
            if d <= t_end]
    return SimpleNamespace(
        cfg=spec.cfg, traffic=spec.traffic, cell=spec.cell, seconds=seconds,
        setup_s=setup_s, frames_done=len(done),
        frames_sent=sum(len(log.t_call) for log in logs),
        latency_s=[d - c for c, d, _ in done],
        done_times=[d for _, d, _ in done],
        dispatch_s=[x for log in logs for x in log.t_disp],
        out_px=out_px(spec.traffic), trace=trace,
        least=frame_work.kernel_least_s(spec.cfg, spec.traffic),
        frame_least_s=frame_work.frame_least_s(spec.cfg, spec.traffic))


def compare(spec, weights, pool, samples, device, precision=None) -> dict:
    """The numbers ``correct`` is decided on, for the sampled results
    against the plain reference (in ``precision``: the control's)."""
    ref = reference.Reference(spec.cfg, weights, device, precision)
    t = spec.traffic
    warp = t["kind"] == "warp"
    differ = total = worst = mask_differ = 0
    for (i, matrix), value in samples:
        if warp:
            want, want_mask = ref.warp(pool[i], matrix, tuple(t["out_hw"]))
            got, got_mask = value
            mask_differ += int(np.count_nonzero(np.asarray(got_mask)
                                                != want_mask))
        else:
            want, got = ref.upscale(pool[i], t["scale"]), value
        d = np.abs(np.asarray(got, np.int16) - want.astype(np.int16))
        differ += int(np.count_nonzero(d))
        total += d.size
        worst = max(worst, int(d.max()))
    numbers = {"frames": len(samples),
               "diff_share": differ / total if total else 1.0,
               "max_diff": worst}
    if warp:
        numbers["mask_diff"] = mask_differ
    return numbers


def checks(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of every number that has a limit."""
    return {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}


def is_correct(found: dict, sampled: int, want: int) -> bool:
    return sampled == want and all(c["value"] <= c["limit"]
                                   for c in found.values())


def run(spec, seed: int, seconds: float, traced: bool, device,
        phases: Phases):
    """One run of the cell after the imports: set-up, window, readers,
    comparison.  Returns (the result line's object, the run's record).
    A request whose device work fails raises in the window, so a result
    line always reports ``failed`` 0."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg, traffic = spec.cfg, spec.traffic
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
        phases.mark("cuda_context", device)
        from lerf_torch.ops.kernels import _build
        _build.library()
        phases.mark("kernel_library", device)
    weights = reference.make_weights(cfg, generate.seed64(seed), device)
    phases.mark("weights", device)
    pool = generate.frame_pool(traffic, seed, device)
    rng = np.random.default_rng(generate.seed64(seed))
    phases.mark("inputs", device)
    predictor = system.build(cfg, weights, device)
    phases.mark("predictor", device)
    driver = Driver(predictor, traffic, pool, rng, traced)
    driver.frames(1)
    phases.mark("first_frame", device)
    driver.frames(traffic["warmup_frames"])
    phases.mark("warmup", device)
    setup_s = phases.total()

    prof = tracing.start(cuda) if traced else None
    t_start, t_end, logs = driver.window(seconds)
    if cuda:
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t_start
    trace = tracing.read(prof, window_s) if traced else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx = window_context(spec, seconds, t_end, logs, setup_s, trace)
    readers = spec.per_layer if traced else spec.end_to_end
    metrics = {}
    for m, reader in readers:
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    samples = driver.sampler.kept
    del driver, predictor
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = compare(spec, weights, pool, samples, device)
    found = checks(numbers, spec.limits)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak),
           "power_limit": power_limit(device)}
    result = {"correct": is_correct(found, len(samples),
                                    min(traffic["sample_frames"],
                                        ctx.frames_done)),
              "attempted": ctx.frames_sent, "failed": 0,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["checks"] = found
    record = {"phases": phases.times, "setup_s": setup_s,
              "numbers": numbers, "frames_done": ctx.frames_done,
              "frames_each_second": np.histogram(
                  ctx.done_times, bins=math.ceil(seconds),
                  range=(t_start, t_start + math.ceil(seconds)))[0].tolist()}
    return result, record


def power_limit(device) -> str:
    """The card's power limit as ``nvidia-smi`` reads it (a share of a
    peak holds at the limit it was measured under), or "" without it.
    Read after the window, never inside the set-up."""
    if device.type != "cuda":
        return ""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip()


def write_record(workload: str, seed: int, traced: bool, record: dict):
    """The run's record (set-up phases, compared numbers) beside the
    checkout's other run outputs."""
    os.makedirs(RUNS, exist_ok=True)
    path = os.path.join(RUNS, f"{workload}-{seed}-trace{int(traced)}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return path
