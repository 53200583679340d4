"""Pipelined serving loops over the async predictor forms (the port of
``lerf_tpu/serve/engine.py``).

A request splits into (a) host work: decode, staging the uint8 frame into
pinned memory, the serving geometry; (b) device work, enqueued on the
predictor's side stream: the copy up, the stages, K1 or K5, the copy down
into pinned memory; and (c) ``result()``: the wait for the request's CUDA
event.  A bounded queue of in-flight
:class:`~lerf_torch.pipeline.ServingFuture` objects overlaps (a) of frame
k+1 with (b) of frame k, so a stream's rate approaches ``1 / max(host,
device)`` instead of ``1 / (host + device)``.  On the CPU a request
computes at dispatch and the queue changes only the order of waiting.

Results yield in request order, each the same value as the synchronous
``warp_dynamic`` / ``upscale_dynamic`` call: the overlap is scheduling,
never arithmetic.
"""
from collections import deque

__all__ = ["stream_warp", "stream_upscale"]


def _drain(q, depth):
    while len(q) > depth:
        yield q.popleft().result()


def stream_warp(predictor, requests, out_hw, *, granularity: int = 0,
                depth: int = 2, geometry: str = "host"):
    """Pipelined homographic-warp serving.

    Args:
      predictor: a ``LutPredictor`` or ``NetPredictor``.
      requests: iterable of ``(img_hwc, matrix)``, e.g. a video stream with
        a homography a frame.
      out_hw: the output size the stream shares.
      depth: the most frames in flight (bounds device and pinned memory).
      geometry: "device" streams through ``warp_device_async`` (the same
        K5 launch in the port; lerf_tpu's in-program geometry).

    Yields ``(out_u8, mask)`` a request, in order.
    """
    if geometry not in ("host", "device"):
        raise ValueError(f"geometry={geometry!r}: must be 'host' or 'device'")
    warp = (predictor.warp_device_async if geometry == "device"
            else predictor.warp_dynamic_async)
    q = deque()
    for img, matrix in requests:
        q.append(warp(img, matrix, out_hw, granularity=granularity))
        yield from _drain(q, depth)
    yield from _drain(q, 0)


def stream_upscale(predictor, requests, *, granularity: int = 0,
                   depth: int = 2):
    """Pipelined arbitrary-scale SR serving.

    Args:
      requests: iterable of ``(img_hwc, scale_h, scale_w)``, any scale a
        frame.
      depth: the most frames in flight.

    Yields the uint8 HR frame a request, in order.
    """
    q = deque()
    for img, scale_h, scale_w in requests:
        q.append(predictor.upscale_dynamic_async(img, scale_h, scale_w,
                                                 granularity=granularity))
        yield from _drain(q, depth)
    yield from _drain(q, 0)
