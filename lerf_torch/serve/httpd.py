"""HTTP serving daemon over the predictors' async forms (the port of
``lerf_tpu/serve/httpd.py``: the same routes, bodies, headers and error
codes).  One long-lived process holds a predictor, its kernels built and
its geometry caches warm, and serves it over HTTP.

stdlib-only: ``http.server`` for transport, PIL for image codecs, raw
``.npy``/``.npz`` for bit-exact clients.

Endpoints
  GET  /healthz
      → ``{"ok": true, "backend": "cuda", "form": "...", "served": N,
        "decode": {...}, "dispatch": {...}, "total": {...},
        "encode": {...}}`` (latency percentiles of a request's parts)
  POST /v1/upscale?scale=4 | scale=1.5x2.0
      body: png/jpeg (any PIL format) or application/x-npy uint8 HWC
      → image/png, or application/x-npy when the request body was npy
        (npy in → npy out equals ``upscale_dynamic``)
  POST /v1/warp?matrix=a,b,c,d,e,f,g,h,i&outSize=HxW[&format=npz]
      → image/png of the masked output (out-of-view pixels black, the
        evaluation script's convention, eval_lut_warp.py:197-233) with header
        ``X-Lerf-Mask-Coverage``; ``format=npz`` returns the raw
        ``{out, mask}`` pair instead.
  POST /v1/upscale_batch?scale=S
      body: application/x-npy uint8 [B, H, W, 3]
      → application/x-npy uint8 [B, oH, oW, 3], equal to ``upscale_batch``
  POST /v1/warp_batch?outSize=HxW
      body: application/x-npz with ``imgs`` uint8 [B, H, W, 3] and
      ``matrices`` float64 [B, 3, 3] (or one [3, 3] broadcast to all)
      → application/x-npz ``{out, mask}`` from ``warp_batch``.

Concurrency: requests decode and encode in their own threads
(``ThreadingHTTPServer``); device work goes through the predictor's async
forms, whose dispatch the predictor's own lock serializes (it covers only
the host staging and the enqueueing), so frame k+1's decode and staging
overlap frame k's device work and copy down, as in the streaming engine
(`engine.py`).  A request enters the predictor's side stream in its own
handler thread (PyTorch's current stream is per thread: the predictor's
forms enter it themselves) and waits for its own CUDA event outside the
lock.
"""
from __future__ import annotations

import io
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

__all__ = ["make_server"]


class _TooLarge(Exception):
    """Request body exceeds the configured cap (→ HTTP 413)."""


def _parse_scale(s: str):
    if "x" in s:
        sh, sw = (float(v) for v in s.split("x"))
        return sh, sw
    return float(s), float(s)


def _parse_matrix(s: str) -> np.ndarray:
    vals = [float(v) for v in s.split(",")]
    if len(vals) != 9:
        raise ValueError("matrix needs 9 comma-separated floats")
    return np.asarray(vals, np.float64).reshape(3, 3)


def _decode_image(body: bytes, ctype: str):
    """→ (uint8 HWC image, came_as_npy)."""
    if "npy" in ctype:
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(
                f"npy body must be uint8 [H, W, 3], got {arr.dtype} "
                f"{arr.shape}")
        return arr, True
    from PIL import Image

    try:
        return np.array(Image.open(io.BytesIO(body)).convert("RGB")), False
    except OSError as e:
        # PIL's UnidentifiedImageError (an OSError) on malformed image
        # bodies is a CLIENT error; convert here so do_POST doesn't have
        # to catch OSError broadly (which would mislabel server-side I/O
        # faults as 400s)
        raise ValueError(f"undecodable image body: {e}")


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _png_bytes(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


class _State:
    def __init__(self, pred, granularity: int, max_inflight: int,
                 max_body_bytes: int, geometry: str = "host"):
        self.pred = pred
        self.granularity = granularity
        # "device" routes /v1/warp through warp_device_async (lerf_tpu's
        # in-program geometry; the same K5 launch in the port)
        if geometry not in ("host", "device"):
            raise ValueError(
                f"geometry={geometry!r}: must be 'host' or 'device'")
        self.geometry = geometry
        self.max_body_bytes = max_body_bytes
        # bounds dispatched-not-yet-fetched frames (each holds its device
        # and pinned output buffers until its event fires) — the daemon
        # analog of the streaming engine's queue depth
        self.inflight = threading.Semaphore(max_inflight)
        # guards the stats below: request threads append/increment
        # concurrently, and /healthz iterates the deques — an unlocked
        # deque mutated mid-iteration raises RuntimeError
        self.stats_lock = threading.Lock()
        self.served = 0
        # sliding latency windows (seconds) of a request's parts: decode =
        # reading and decoding the body; dispatch = host staging +
        # enqueueing the device work; total = dispatch + the device work
        # and the copy down; encode = encoding and writing the response
        self.lat = {k: deque(maxlen=256)
                    for k in ("decode", "dispatch", "total", "encode")}

    def record(self, served=False, **seconds):
        with self.stats_lock:
            for k, s in seconds.items():
                self.lat[k].append(s)
            if served:
                self.served += 1

    def percentiles(self, key):
        with self.stats_lock:
            samples = list(self.lat[key])
        if not samples:
            return {}
        ms = sorted(1e3 * s for s in samples)
        return {"p50_ms": round(ms[len(ms) // 2], 2),
                "p99_ms": round(ms[min(len(ms) - 1,
                                       int(len(ms) * 0.99))], 2),
                "n": len(ms)}


def _build_handler(state: _State):
    class Handler(BaseHTTPRequestHandler):
        # one daemon serves many short requests; keep-alive default
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet access log
            pass

        def _send(self, code: int, payload: bytes, ctype: str,
                  extra=()):
            self._response_started = True
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._send_json(200, {
                    "ok": True,
                    "backend": str(getattr(state.pred, "device", "")),
                    "form": type(state.pred).__name__,
                    "granularity": state.granularity,
                    "served": state.served,
                    **{k: state.percentiles(k) for k in state.lat},
                })
            elif path == "/":
                self._send(200, __doc__.encode(), "text/plain")
            else:
                self._send_json(404, {"error": f"no route {path}"})

        def _read_body(self):
            n = int(self.headers.get("Content-Length", "0"))
            if n <= 0:
                raise ValueError("empty request body")
            if n > state.max_body_bytes:
                raise _TooLarge(
                    f"body of {n} bytes exceeds the "
                    f"{state.max_body_bytes}-byte limit")
            return self.rfile.read(n)

        def do_POST(self):
            # per-request: the handler instance lives for the whole
            # keep-alive connection
            self._response_started = False
            url = urlparse(self.path)
            q = {k: v[-1] for k, v in parse_qs(url.query).items()}
            self._t0 = time.perf_counter()
            try:
                if url.path == "/v1/upscale_batch":
                    self._upscale_batch(self._read_body(), q)
                elif url.path == "/v1/warp_batch":
                    self._warp_batch(self._read_body(), q)
                elif url.path in ("/v1/upscale", "/v1/warp"):
                    img, as_npy = _decode_image(
                        self._read_body(),
                        self.headers.get("Content-Type", ""))
                    state.record(decode=time.perf_counter() - self._t0)
                    if url.path == "/v1/upscale":
                        self._upscale(img, as_npy, q)
                    else:
                        self._warp(img, as_npy, q)
                else:
                    self._send_json(404, {"error": f"no route {url.path}"})
                    return
                state.record(served=True)
            except _TooLarge as e:
                # the oversized body was never read — close the connection
                # (reading N hundred MB just to keep keep-alive alive would
                # be the DoS we're avoiding; Connection: close makes the
                # client resync instead of the server desyncing on reuse)
                self.close_connection = True
                self._send_json(413, {"error": str(e)})
            except (ValueError, KeyError) as e:
                # malformed-image OSErrors are converted to ValueError at
                # the decode site; a bare OSError here is a server-side
                # I/O fault (or a mid-response disconnect) and belongs to
                # the 500 path below
                self._send_json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — keep-alive must survive
                # an unexpected failure must produce an HTTP response (and
                # keep the long-lived daemon's connection usable), never a
                # dead thread and a dropped connection.  But if the fault
                # struck MID-response (status/partial body already on the
                # wire — e.g. a client disconnect during a large PNG
                # write), injecting a second response would corrupt the
                # stream: close instead.
                if getattr(self, "_response_started", False):
                    # leave a trace: a dropped connection with no log line
                    # would make real server-side faults undiagnosable
                    try:
                        self.log_error("mid-response fault: %s: %s",
                                       type(e).__name__, e)
                    except Exception:   # noqa: BLE001 — logging must not raise
                        pass
                    self.close_connection = True
                    return
                try:
                    self._send_json(500, {
                        "error": f"{type(e).__name__}: {e}"})
                except OSError:
                    pass  # client already gone; nothing to report to

        def _respond(self, payload_fn, ctype, extra=()):
            """Encode and send the response, timed as ``encode``."""
            t0 = time.perf_counter()
            self._send(200, payload_fn(), ctype, extra)
            state.record(encode=time.perf_counter() - t0)

        def _upscale(self, img, as_npy, q):
            sh, sw = _parse_scale(q.get("scale", "4"))
            t0 = time.perf_counter()
            with state.inflight:
                fut = state.pred.upscale_dynamic_async(
                    img, sh, sw, granularity=state.granularity)
                state.record(dispatch=time.perf_counter() - t0)
                out = fut.result()         # device compute + D2H
            state.record(total=time.perf_counter() - t0)
            if as_npy:
                self._respond(lambda: _npy_bytes(out), "application/x-npy")
            else:
                self._respond(lambda: _png_bytes(out), "image/png")

        def _warp(self, img, as_npy, q):
            matrix = _parse_matrix(q["matrix"])
            try:
                oh, ow = (int(v) for v in q["outSize"].split("x"))
            except ValueError:
                raise ValueError("outSize must be HxW, e.g. 512x512")
            t0 = time.perf_counter()
            warp = (state.pred.warp_device_async if state.geometry == "device"
                    else state.pred.warp_dynamic_async)
            with state.inflight:
                fut = warp(img, matrix, (oh, ow),
                           granularity=state.granularity)
                state.record(dispatch=time.perf_counter() - t0)
                out, mask = fut.result()
            state.record(total=time.perf_counter() - t0)
            if q.get("format") == "npz":
                self._respond(lambda: _npz_bytes(out=out, mask=mask),
                              "application/x-npz")
                return
            cov = float(mask.mean())
            masked = out * mask.astype(out.dtype)[..., None]
            self._respond(
                lambda: _npy_bytes(masked) if as_npy else _png_bytes(masked),
                "application/x-npy" if as_npy else "image/png",
                extra=(("X-Lerf-Mask-Coverage", f"{cov:.6f}"),))

        def _upscale_batch(self, body, q):
            imgs = np.load(io.BytesIO(body), allow_pickle=False)
            if isinstance(imgs, np.lib.npyio.NpzFile):
                # np.load returns an NpzFile for .npz bodies; without this
                # branch the .dtype access below AttributeErrors into a 500
                imgs.close()
                raise ValueError(
                    "body must be a single .npy array (uint8 [B, H, W, 3]); "
                    "for .npz batched warp use /v1/warp_batch")
            if imgs.dtype != np.uint8 or imgs.ndim != 4 \
                    or imgs.shape[-1] != 3:
                raise ValueError(
                    f"npy body must be uint8 [B, H, W, 3], got "
                    f"{imgs.dtype} {imgs.shape}")
            sh, sw = _parse_scale(q.get("scale", "4"))
            state.record(decode=time.perf_counter() - self._t0)
            t0 = time.perf_counter()
            # upscale_batch is synchronous (one launch of each kernel for
            # the whole batch): the batch is the amortization
            with state.inflight:
                out = state.pred.upscale_batch(imgs, sh, sw)
            state.record(total=time.perf_counter() - t0)
            self._respond(lambda: _npy_bytes(out), "application/x-npy")

        def _warp_batch(self, body, q):
            z = np.load(io.BytesIO(body), allow_pickle=False)
            if not isinstance(z, np.lib.npyio.NpzFile):
                # a plain .npy body yields an ndarray, which is not a
                # context manager — map to 400, not a TypeError 500
                raise ValueError(
                    "body must be an .npz archive with 'imgs' uint8 "
                    "[B, H, W, 3] and 'matrices' float [B, 3, 3] (or "
                    "[3, 3]); a plain .npy array is not accepted here")
            with z:
                if "imgs" not in z or "matrices" not in z:
                    raise ValueError(
                        "npz body must contain 'imgs' uint8 [B, H, W, 3] "
                        "and 'matrices' float [B, 3, 3] (or [3, 3])")
                imgs, matrices = z["imgs"], z["matrices"]
            if imgs.dtype != np.uint8 or imgs.ndim != 4 \
                    or imgs.shape[-1] != 3:
                raise ValueError(
                    f"'imgs' must be uint8 [B, H, W, 3], got "
                    f"{imgs.dtype} {imgs.shape}")
            if matrices.shape not in ((3, 3), (imgs.shape[0], 3, 3)):
                # a mismatched batch would otherwise IndexError (500) or
                # silently truncate to the first B matrices
                raise ValueError(
                    f"'matrices' must be [3, 3] or [{imgs.shape[0]}, 3, 3] "
                    f"to match imgs, got {matrices.shape}")
            try:
                oh, ow = (int(v) for v in q["outSize"].split("x"))
            except ValueError:
                raise ValueError("outSize must be HxW, e.g. 512x512")
            state.record(decode=time.perf_counter() - self._t0)
            t0 = time.perf_counter()
            with state.inflight:
                out, mask = state.pred.warp_batch(imgs, matrices, (oh, ow))
            state.record(total=time.perf_counter() - t0)
            self._respond(lambda: _npz_bytes(out=out, mask=mask),
                          "application/x-npz")

    return Handler


def make_server(pred, *, host: str = "127.0.0.1", port: int = 0,
                granularity: int = 0, max_inflight: int = 8,
                max_body_bytes: int = 256 << 20,
                geometry: str = "host") -> ThreadingHTTPServer:
    """Build (but do not start) the daemon; ``port=0`` picks a free port
    (``server.server_address[1]`` reports it).  ``granularity`` is passed
    to the dynamic forms (lerf_tpu's shape buckets; it changes nothing in
    the port, which compiles nothing per shape) and reported by /healthz.
    ``max_inflight`` caps dispatched-not-yet-fetched frames so a burst of
    concurrent clients cannot queue unbounded output buffers on the card;
    ``max_body_bytes`` (default 256 MB — an 8K uint8 RGB frame is ~100 MB)
    rejects larger uploads with 413 before buffering them.
    ``geometry="device"`` serves /v1/warp through ``warp_device_async``
    (in the port the same K5 launch as ``warp_dynamic_async``)."""
    state = _State(pred, granularity, max_inflight, max_body_bytes,
                   geometry=geometry)
    server = ThreadingHTTPServer((host, port), _build_handler(state))
    server.lerf_state = state
    return server
