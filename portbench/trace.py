"""The device trace of a traced run: ``torch.profiler`` over the window,
read back as plain lists for the metric readers.

Kernels and copies are the profiler's device activities (CUPTI); the
benchmark's own host spans (``pb.dispatch`` around each call into the
program, ``pb.wait`` around each wait for a result) are its annotations,
on the same clock (the profiler also copies each annotation onto the
device's track, which is not device work and is left out).  ``busy_s``
is the union of the device activities'
intervals; an idle gap is named by the host span it began in.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Tuple

SPAN_PREFIX = "pb."
COPY_PREFIXES = ("Memcpy", "Memset")
TOP = 10


@dataclass
class Trace:
    """Device activities and host spans of the traced window, in
    nanoseconds of the profiler's clock."""
    kernels: List[Tuple[str, int, int]] = field(default_factory=list)
    copies: List[Tuple[str, int, int]] = field(default_factory=list)
    spans: List[Tuple[str, int, int]] = field(default_factory=list)
    window_s: float = 0.0

    def device(self):
        return self.kernels + self.copies

    def busy_s(self) -> float:
        """Seconds in which a kernel or a copy ran."""
        return sum(b - a for a, b in _merged(self.device())) / 1e9

    def seconds(self, match) -> Tuple[int, float]:
        """(count, seconds) of the kernels whose name ``match`` accepts."""
        hits = [d for name, _, d in self.kernels if match(name)]
        return len(hits), sum(hits) / 1e9

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by the host span they began in."""
        total = {}
        for name, _, d in self.device():
            key = clean(name)
            total[key] = total.get(key, 0) + d
        ops = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        busy = _merged(self.device())
        gaps = sorted(((b0 - a1, a1) for (_, a1), (b0, _)
                       in zip(busy, busy[1:]) if b0 > a1), reverse=True)[:TOP]
        return {"device_ops": [[k, v / 1e9] for k, v in ops],
                "idle_gaps": [[self.span_at(t), g / 1e9] for g, t in gaps]}

    def span_at(self, t: int) -> str:
        inside = [(e - s, name) for name, s, e in self.spans if s <= t <= e]
        return min(inside)[1] if inside else SPAN_PREFIX + "host"


def clean(name: str) -> str:
    """A kernel's name as the breakdown gives it: 64 characters of
    letters, digits and ``_.-``."""
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", name)[:64]


def _merged(events):
    out = []
    for _, s, d in sorted(events, key=lambda e: e[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return out


def start(cuda: bool):
    """A started profiler of host and (on a card) device activities."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def read(prof, window_s: float) -> Trace:
    """Stop ``prof`` and read its raw events (no event tree is built)."""
    from torch.autograd import DeviceType
    prof.stop()
    trace = Trace(window_s=window_s)
    for e in prof.profiler.kineto_results.events():
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and not name.startswith(SPAN_PREFIX):
            (trace.copies if name.startswith(COPY_PREFIXES)
             else trace.kernels).append((name, start, dur))
        elif not on_device and name.startswith(SPAN_PREFIX):
            trace.spans.append((name, start, start + dur))
    return trace
