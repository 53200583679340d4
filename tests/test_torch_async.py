"""The async serving forms and ``ServingFuture``, the port against
lerf_tpu on the CPU.

``upscale_dynamic_async``, ``warp_dynamic_async`` and
``warp_device_async`` on both predictors, in the LUT form (LeRF-G and
LeRF-L), the SRNet form and the IMDN form.  On the CPU a request computes
at dispatch and its future is resolved; the synchronous forms are
``async(...).result()``.

Tolerances: every async result against the port's synchronous form and
its ``upscale`` / ``warp`` exactly (one path); against lerf_tpu's async
form (its ``warp_dynamic_async`` for both warp forms: lerf_tpu's
``warp_device`` runs float32 geometry, ``test_torch_warp_serving.py``
holds that one) the LUT stages and the mask exactly and the LUT frame but
for .5 rounding ties of the port's float32 twin; the SRNet frame within
one step on < 1 % of pixels; the IMDN frame within one step on ≤ 0.1 %
(``test_torch_imdn.py``).  The lerf_tpu LUT references run the flat table
layout; torch runs on one thread (``one_torch_thread``).
"""
import numpy as np
import pytest
import torch

from test_torch_imdn import assert_u8_close
from test_torch_imdn import image as imdn_image
from test_torch_imdn import predictors as imdn_pair
from test_torch_warp import count_ties
from test_torch_warp_serving import (IN_SZ, MATS, OUT_SZ,
                                     assert_net_frames_close,
                                     assert_same_warp, image, lut_pair,
                                     net_pair, plain_frame)

from lerf_torch.ops import geometry as tgeo
from lerf_torch.ops import resample as trs
from lerf_torch.pipeline import ServingFuture

SCALES = [(2.0, 2.0), (1.5, 2.5)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU twins run many small torch ops; with one intra-op
    thread a core they stall whenever the test workers share the cores,
    so this module runs torch on one thread and gives the count back
    after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sr_twin(feat, hyper, scale, linear):
    """The float32 twin frame [oH, oW, C] of the port's stage outputs,
    for telling .5 ties from errors."""
    geom = tgeo.ResizeGeometry.create(feat.shape[-2:],
                                      scale_factors=list(scale))
    if linear:
        f32 = trs.linear_resize_codes_plain(
            torch.from_numpy(feat),
            torch.from_numpy(np.ascontiguousarray(hyper[..., :1])), geom)
    else:
        f32 = trs.steering_resize_codes_plain(
            torch.from_numpy(feat), torch.from_numpy(hyper), geom)
    return f32.numpy().transpose(1, 2, 0)


def resolved(fut):
    assert isinstance(fut, ServingFuture)
    value = fut.result()
    assert fut.result() is value
    return value


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_lut_upscale_dynamic_async(linear):
    jax_pred, port = lut_pair(linear)
    img = image(40)
    for scale in SCALES:
        got = resolved(port.upscale_dynamic_async(img, *scale))
        np.testing.assert_array_equal(got, port.upscale_dynamic(img, *scale))
        out, feat, hyper = port.upscale(img, *scale, return_aux=True)
        np.testing.assert_array_equal(got, out)
        theirs = jax_pred.upscale_dynamic_async(img, *scale).result()
        count_ties(got, np.asarray(theirs),
                   sr_twin(feat, hyper, scale, linear))


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_lut_warp_async(linear):
    jax_pred, port = lut_pair(linear)
    img = image(41)
    for m in MATS[:2]:
        want = port.warp(img, m, OUT_SZ, return_aux=True)
        theirs = jax_pred.warp_dynamic_async(img, m, OUT_SZ,
                                             return_aux=True).result()
        got = resolved(port.warp_dynamic_async(img, m, OUT_SZ,
                                               return_aux=True))
        assert_same_warp(want, got)
        assert_same_warp(want[:2], port.warp_dynamic(img, m, OUT_SZ))
        for a, b in zip(theirs[1:], got[1:]):        # mask, feat, hyper
            np.testing.assert_array_equal(b, np.asarray(a))
        count_ties(got[0], np.asarray(theirs[0]),
                   plain_frame(want[2], want[3], m, linear))
        dev = resolved(port.warp_device_async(img, m, OUT_SZ))
        assert_same_warp(want[:2], dev)
        assert_same_warp(want[:2], port.warp_device(img, m, OUT_SZ))


def test_net_async_forms():
    jax_pred, port = net_pair()
    img = image(42)
    got = resolved(port.upscale_dynamic_async(img, 2.0, 2.0))
    np.testing.assert_array_equal(got, port.upscale_dynamic(img, 2.0, 2.0))
    np.testing.assert_array_equal(got, port.upscale(img, 2.0, 2.0))
    assert_net_frames_close(
        jax_pred.upscale_dynamic_async(img, 2.0, 2.0).result(), got)
    want = port.warp(img, MATS[1], OUT_SZ)
    theirs = jax_pred.warp_dynamic_async(img, MATS[1], OUT_SZ).result()
    for name in ("warp_dynamic_async", "warp_device_async"):
        got = resolved(getattr(port, name)(img, MATS[1], OUT_SZ))
        assert_same_warp(want, got)
        np.testing.assert_array_equal(got[1], np.asarray(theirs[1]))
        assert_net_frames_close(theirs[0], got[0])


def test_imdn_async_forms():
    jax_pred, port = imdn_pair()
    img = imdn_image(seed=3)
    got = resolved(port.upscale_dynamic_async(img, 2.0, 2.0))
    np.testing.assert_array_equal(got, port.upscale(img, 2.0, 2.0))
    assert_u8_close(jax_pred.upscale_dynamic_async(img, 2.0, 2.0).result(),
                    got)
    m = np.array([[2.0, 0.1, 1.0], [0.05, 1.9, -1.0], [1e-3, 2e-3, 1.0]])
    want = port.warp(img, m, (30, 36))
    theirs = jax_pred.warp_dynamic_async(img, m, (30, 36)).result()
    for name in ("warp_dynamic_async", "warp_device_async"):
        got = resolved(getattr(port, name)(img, m, (30, 36)))
        assert_same_warp(want, got)
        np.testing.assert_array_equal(got[1], np.asarray(theirs[1]))
        assert_u8_close(np.asarray(theirs[0]), got[0])


def test_serving_future_semantics():
    """``result()`` runs the finish once and hands back the same object;
    ``resolved`` holds its value; a finish that raises raises again on the
    next ``result()`` (nothing is swallowed)."""
    calls = []
    fut = ServingFuture(lambda: calls.append(1) or ["value"])
    first = fut.result()
    assert fut.result() is first and first == ["value"] and calls == [1]
    marker = object()
    assert ServingFuture.resolved(marker).result() is marker

    def boom():
        raise RuntimeError("device fault")

    failing = ServingFuture(boom)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="device fault"):
            failing.result()


def test_upscale_dynamic_async_outside_the_envelope(monkeypatch):
    """Scale 1 and a downscale beyond the 1/32 cap resolve now through
    ``upscale``, as lerf_tpu's async form does."""
    _, port = lut_pair()
    calls = []
    monkeypatch.setattr(port, "upscale",
                        lambda img, sh, sw, return_aux=False:
                        calls.append((sh, sw)) or "out")
    img = np.zeros((80, 80, 3), np.uint8)
    for scale in ((1.0, 1.0), (1 / 40, 1 / 40)):
        fut = port.upscale_dynamic_async(img, *scale)
        assert isinstance(fut, ServingFuture) and calls[-1] == scale
        assert fut.result() == "out"


def test_inputs_gray_and_float():
    """A gray [H, W] frame serves as three channels; a float frame takes
    the host path with its range check (uint8 needs none)."""
    _, port = lut_pair()
    img = image(43)
    gray = img[..., 0]
    np.testing.assert_array_equal(
        resolved(port.upscale_dynamic_async(gray, 2.0, 2.0)),
        port.upscale(np.stack([gray] * 3, -1), 2.0, 2.0))
    np.testing.assert_array_equal(
        port.warp_dynamic_async(img.astype(np.float32), MATS[0],
                                OUT_SZ).result()[0],
        port.warp(img, MATS[0], OUT_SZ)[0])
    with pytest.raises(ValueError, match="0..255"):
        port.upscale_dynamic_async(img.astype(np.float32) + 300, 2.0, 2.0)
    assert IN_SZ == img.shape[:2]


def test_concurrent_dispatch_stress():
    """More threads than cores sending requests to one predictor, the
    interpreter switching threads as often as it can: every result is the
    sequential call's (dispatch holds the predictor's lock; a lost cache
    update or a mixed-up request would show)."""
    import sys
    import threading

    _, port = lut_pair()
    rng = np.random.RandomState(44)
    imgs = [rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
            for _ in range(16)]
    scales = [(2.0, 2.0), (1.5, 2.5), (2.5, 1.5), (3.0, 3.0)]
    want = [port.upscale(f, *scales[i % 4]) for i, f in enumerate(imgs)]
    got, errors = {}, []

    def worker(k):
        try:
            for i in range(k, len(imgs), 8):
                got[i] = port.upscale_dynamic_async(
                    imgs[i], *scales[i % 4]).result()
        except Exception as e:      # raised below, in the test's thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[i], w)
