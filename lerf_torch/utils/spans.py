"""Named host spans of the serving path, on the profiler's clock.

``span(name)`` records ``name`` as a host range while a ``torch.profiler``
runs on the calling thread (the benchmark's traced run, the train loop's
``profile_steps`` window or an operator's own profiler) and is one shared
no-op context otherwise, so a span costs one flag check when nothing
traces.  PyTorch's profiler is thread-local: it records the thread that
started it (and the tasks PyTorch itself hands to other threads), so a
request sent from another thread is not traced.  The ranges land in the
profiler's own event stream, on the clock its device activities (CUPTI)
share, so an idle gap on the card lines up with the host span it began
in.

A span is recorded at the profiler's function scope, as an operator is,
not as a user annotation (``torch.profiler.record_function``): the
profiler copies a user annotation onto the device's track, over the
kernels launched inside it, where a reader of device activities would
count it as device work.  A span here is host time alone.

The serving path's spans (``lerf.`` names, no numbers, so a breakdown
groups them; each nests in the span that encloses it on its thread):

``lerf.request``   ``_Predictor._request``, its whole body
``lerf.lock``      the wait for the predictor's lock on a request's path
``lerf.upload``    the frame into pinned memory, its copy up and cast
``lerf.stages``    enqueueing a form's stages (``_stages``)
``lerf.resample``  enqueueing K1 or K5, with their operand checks
``lerf.copy_down`` the output's pinned blocks, the copies down, the event
``lerf.result``    the ``result()`` call that finishes a request: the
                   wait and finishing the value on the host
``lerf.wait``      blocking on the request's CUDA event

A thread's k-th ``lerf.request`` and k-th ``lerf.result`` are one request
where its results are awaited in order, as the serving engine does.
"""
from __future__ import annotations

import contextlib
import functools

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context recording ``name`` while a profiler runs, else the
    shared no-op."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def spanned(name: str):
    """A decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
