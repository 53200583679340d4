"""The serving path's spans (``lerf_torch.utils.spans``) under PyTorch's
profiler, on the CPU.

Each request made through ``_Predictor._request`` is one ``lerf.request``
holding its ``lerf.lock``, ``lerf.upload`` and ``lerf.stages``, and its
future's first ``result()`` one ``lerf.result``; on the CPU no request
copies down or waits on an event, and K1 and K5 are their plain twins, so
``lerf.copy_down``, ``lerf.wait`` and ``lerf.resample`` are the card's
(``test_torch_kernels.py::test_serving_spans_on_the_card``).  Every span
is a host range at the profiler's function scope, never a user annotation
(those the profiler copies onto the device's track).  The profiler is
thread-local, so only the thread that runs it is traced.  This file
imports neither JAX nor lerf_tpu.
"""
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_kernels import serving_predictor

from lerf_torch.pipeline import ServingFuture
from lerf_torch.serve import engine
from lerf_torch.utils import spans

IN_SZ = (12, 16)
MAT = np.array([[1.9, 0.05, -1.0], [0.02, 1.8, 0.5], [1e-4, 0.0, 1.0]])
OUT_SZ = (22, 30)
CPU_SPANS = {"lerf.request", "lerf.lock", "lerf.upload", "lerf.stages",
             "lerf.result"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["lut", "imdn"])
def form(request):
    return request.param, serving_predictor(request.param, "cpu")


def image(seed):
    return np.random.RandomState(seed).randint(
        0, 256, IN_SZ + (3,)).astype(np.uint8)


def lerf_spans(prof):
    """[(name, start, end, thread)] of the ``lerf.`` events, by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("lerf."):
            assert not e.is_user_annotation(), e.name()
            out.append((e.name(), e.start_ns(), e.end_ns(),
                        e.start_thread_id()))
    return sorted(out, key=lambda s: (s[1], -s[2]))


def parents(found):
    """Each span's parent: the innermost other span of its thread that
    holds it, or None."""
    out = []
    for i, (name, s, e, tid) in enumerate(found):
        holders = [(pe - ps, pn) for j, (pn, ps, pe, pt) in enumerate(found)
                   if j != i and pt == tid and ps <= s and e <= pe]
        out.append(min(holders)[1] if holders else None)
    return out


def assert_paired(found):
    """Requests one after another on one thread, the k-th ``lerf.result``
    after the k-th ``lerf.request`` has ended."""
    reqs = [s for s in found if s[0] == "lerf.request"]
    results = [s for s in found if s[0] == "lerf.result"]
    assert len(reqs) == len(results)
    for a, b in zip(reqs, reqs[1:]):
        assert a[2] <= b[1]
    for req, res in zip(reqs, results):
        assert req[2] <= res[1]


CALLS = {
    "upscale_dynamic_async": lambda p, img: p.upscale_dynamic_async(
        img, 2.0, 2.0),
    "warp_dynamic_async": lambda p, img: p.warp_dynamic_async(
        img, MAT, OUT_SZ),
    "upscale": lambda p, img: ServingFuture.resolved(p.upscale(img, 2, 2)),
}


@pytest.mark.parametrize("call", list(CALLS))
def test_each_request_nests_its_spans(form, call):
    """Three requests sent before any result is awaited (the sync form:
    one after another): one ``lerf.request`` a request with its lock,
    upload and stages inside, one ``lerf.result`` after it; the dynamic
    SR form's serving-geometry lookup takes the lock once more, outside
    the request."""
    _, pred = form
    imgs = [image(k) for k in range(3)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        futs = [CALLS[call](pred, img) for img in imgs]
        values = [f.result() for f in futs]
    found = lerf_spans(prof)
    assert {s[0] for s in found} == CPU_SPANS
    assert len({s[3] for s in found}) == 1
    names = [s[0] for s in found]
    lookups = 3 if call == "upscale_dynamic_async" else 0
    assert names.count("lerf.lock") == 3 + lookups
    for name in CPU_SPANS - {"lerf.lock"}:
        assert names.count(name) == 3, name
    want = {"lerf.request": None, "lerf.result": None,
            "lerf.upload": "lerf.request", "lerf.stages": "lerf.request"}
    locks = []
    for (name, *_), parent in zip(found, parents(found)):
        if name == "lerf.lock":
            locks.append(parent)
        else:
            assert parent == want[name], name
    assert locks.count("lerf.request") == 3
    assert locks.count(None) == lookups
    assert_paired(found)
    if call == "warp_dynamic_async":
        np.testing.assert_array_equal(values[0][0],
                                      pred.warp_dynamic(imgs[0], MAT,
                                                        OUT_SZ)[0])
    else:
        np.testing.assert_array_equal(values[0],
                                      pred.upscale_dynamic(imgs[0], 2, 2))


@pytest.mark.parametrize("stream", ["upscale", "warp"])
def test_two_streams_on_two_threads(stream):
    """Two streams of one predictor at depth 2, one on the profiling
    thread and one on a thread of its own, contending for the lock: the
    profiling thread's requests pair with its results in order and every
    span is its own; the other thread's requests leave none (the profiler
    is thread-local) and both get their own frames."""
    pred = serving_predictor("lut", "cpu")
    imgs = [image(k) for k in range(4)]
    if stream == "upscale":
        reqs = [(img, 2.0, 2.0) for img in imgs]

        def run(rs):
            return [v for v in engine.stream_upscale(pred, rs, depth=2)]
    else:
        reqs = [(img, MAT) for img in imgs]

        def run(rs):
            return [v[0] for v in engine.stream_warp(pred, rs, OUT_SZ,
                                                     depth=2)]
    got, errors = {}, []

    def other():
        try:
            got["other"] = run(reqs[::-1])
        except Exception as e:      # raised again on the main thread
            errors.append(e)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        th = threading.Thread(target=other)
        th.start()
        got["main"] = run(reqs)
        th.join(timeout=120)
    assert not th.is_alive() and not errors, errors
    found = lerf_spans(prof)
    assert len({s[3] for s in found}) == 1
    assert [s[0] for s in found].count("lerf.request") == len(reqs)
    assert_paired(found)
    want = run(reqs)
    for got_main, got_other, w in zip(got["main"], got["other"][::-1],
                                      want):
        np.testing.assert_array_equal(got_main, w)
        np.testing.assert_array_equal(got_other, w)


@pytest.mark.parametrize("scale", [(2.0, 2.0), (1.0, 1.0)],
                         ids=["served", "resolved"])
def test_result_twice_gives_one_result_span(form, scale):
    """``result()`` called twice finishes once: one ``lerf.result``.  At
    scale 1 the dynamic form resolves now through ``upscale``, whose own
    request is awaited inside (the IMDN form skips its nets there, and
    sends none); the resolved future adds no span."""
    _, pred = form
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fut = pred.upscale_dynamic_async(image(5), *scale)
        first = fut.result()
        assert fut.result() is first
    names = [s[0] for s in lerf_spans(prof)]
    sent = 0 if pred._skips(*scale) else 1
    assert names.count("lerf.request") == names.count("lerf.result") == sent


@pytest.mark.parametrize("where", ["no_profiler", "other_thread",
                                   "after_stop"])
def test_no_span_without_a_profiler_on_the_thread(where):
    """Without a profiler on the calling thread ``span`` is the shared
    no-op: with none running, on a thread other than the profiling one,
    and for a future awaited after the profiler stopped, whose
    ``lerf.result`` is then not recorded."""
    pred = serving_predictor("lut", "cpu")
    names = ("lerf.request", "lerf.result", "anything")
    if where == "no_profiler":
        assert all(spans.span(n) is spans._OFF for n in names)
        return
    seen = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.span("lerf.request") is not spans._OFF
        if where == "other_thread":
            th = threading.Thread(target=lambda: seen.extend(
                spans.span(n) is spans._OFF for n in names))
            th.start()
            th.join(timeout=60)
        else:
            fut = pred.upscale_dynamic_async(image(6), 2.0, 2.0)
    if where == "other_thread":
        assert seen == [True] * len(names)
        return
    fut.result()
    found = [s[0] for s in lerf_spans(prof)]
    assert found.count("lerf.request") == 1
    assert "lerf.result" not in found


def test_only_the_span_helper_records_ranges():
    """No module of the package but ``utils/spans.py`` opens a profiler
    range, so every span of the serving path comes through ``span``."""
    root = os.path.dirname(os.path.dirname(spans.__file__))
    helper = os.path.abspath(spans.__file__)
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.abspath(os.path.join(d, f))
            if not f.endswith(".py") or path == helper:
                continue
            with open(path) as fh:
                text = fh.read()
            for word in ("record_function", "_RecordFunctionFast"):
                assert word not in text, (path, word)
