"""Chained steady-state timing (the port of ``lerf_tpu/utils/timing.py``).

A loop that times the same call on the same input can read less than the
work takes: nothing forces one call to finish its work before the next is
timed, and a card runs the calls asynchronously.  ``chain_time`` makes
every iteration's work unavoidable: iteration k's input is iteration
k-1's output, and the clock stops only after the last output is ready
(``torch.cuda.synchronize`` on each card the output lies on; nothing to
wait for on the CPU).
"""
from __future__ import annotations

import time

import torch


def _leaves(x):
    """The leaves of a nest of tuples, lists and dicts, in order."""
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    return [x]


def _spec(x):
    """Each leaf's (shape, dtype): a tensor's or an array's, else None."""
    return [(tuple(getattr(a, "shape", ())) if hasattr(a, "shape") else None,
             getattr(a, "dtype", None)) for a in _leaves(x)]


def _sync(x):
    """Wait for the cards the tensors of ``x`` lie on."""
    for dev in dict.fromkeys(a.device for a in _leaves(x)
                             if isinstance(a, torch.Tensor)
                             and a.device.type == "cuda"):
        torch.cuda.synchronize(dev)


def chain_time(step, x0, warmup=3, iters=20):
    """Steady-state seconds/iter on a serial dependency chain.

    Asserts the chain is SHAPE-STABLE: ``step`` must return the input
    spec (every leaf's shape and dtype), or each iteration does other work
    than the last and the "steady state" times no one call (lerf_tpu's
    round-4 shrinking-downscale artifact: downscale chains must tile their
    smaller output back up to the input shape)."""
    want = _spec(x0)
    x = x0
    for _ in range(warmup):
        x = step(x)
        got = _spec(x)
        if got != want:
            raise AssertionError(
                f"chain not shape-stable: step({want}) -> {got}; a shrinking/"
                f"growing chain re-traces every iteration (see BASELINE.md "
                f"timing-methodology note)")
    _sync(x)
    t0 = time.perf_counter()
    for _ in range(iters):
        x = step(x)
    _sync(x)
    return (time.perf_counter() - t0) / iters
