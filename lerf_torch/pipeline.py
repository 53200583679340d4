"""LeRF deploy pipelines: stages → hyper codes → steerable resize or warp.

The port of ``lerf_tpu.pipeline``'s two predictors, SR (static, bucketed,
dynamic-scale and batched) and the warp (static, dynamic, device-geometry
and batched), in both kernels: the
steerable Gaussian (LeRF-G, three hyper codes a pixel) and, with
``linear=True``, the amplified-linear kernel (LeRF-L, one code):

* :class:`LutPredictor` (``pipeline.py:114-191,855-1278``), the LUT form:
  on a CUDA device a frame runs as two K2 launches (stage 1, stage 2) and
  one K1 launch (every SR form) or one K5 launch (every warp form), which
  writes the uint8 frame itself (and the warp's validity mask).
* :class:`NetPredictor` (``pipeline.py:194-601``), the micro-net (SRNet)
  form: two K3 launches (or K4 with ``backend="pallas_int8"``), the stage
  epilogues and one K1 or K5 launch; and with
  :meth:`NetPredictor.from_imdn` the IMDN (LeRF-Net) form: its two conv
  towers (cuDNN, in the model's compute type: full float32, or bf16),
  whose float32 or bf16 feature and hyper maps K1 or K5 take in their
  float32 or bf16 instance, one launch.

With ``mesh=`` (a :class:`~lerf_torch.parallel.Mesh`) a predictor scales
out over the mesh's shards as lerf_tpu's does: its tables or params are
replicated once per distinct device, ``upscale_batch`` splits the batch
across the shards, each running its frames through its own stages and K1
on its device and stream (no collective), and every other form runs on
the mesh's first device.

On the CPU the same calls run the kernels' plain twins.  PyTorch runs
eagerly, so there is no per-shape program cache: a predictor keeps one
device copy of each shape's resize geometry and of the last dynamic
requests' serving geometry, and for a few homographies the warp's
parameters (on a card) or host geometry (on the CPU) and its validity
mask.  PyTorch compiles nothing per shape, so lerf_tpu's shape buckets
are not needed: ``upscale_bucketed`` is ``upscale``, and
``upscale_dynamic`` serves on the image's own frame through the serving
geometry, bit-equal to ``upscale``; the batch forms run the stages on
the batch ``[B, C, H, W]`` and fold it into the channel axis after them,
so a batch is one launch of each kernel.  The warp serving forms keep
nothing per matrix: on a card K5 derives each frame's geometry and mask
from its matrix in float64 (bit-equal to ``warp``, where lerf_tpu's
float32 device geometry is not); on the CPU its plain twin does, from a
host geometry made for the call.
"""
from __future__ import annotations

import contextlib
import copy
import threading
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from .device import concrete_device, resolve_device
from .lut.io import LUTBank
from .models import srnet
from .ops import geometry as geo
from .ops.kernels import resize as k1
from .ops.kernels.warp import WarpParams, steering_warp, steering_warp_batch
from .ops.lut_pipeline import (TABLE_LAYOUTS, divide_exact, lut_stage1,
                               lut_stage1_intermediate, lut_stage2,
                               stage_tables)
from .ops.resample import nearest_warp_mask_host
# the uint8 cast K1 fuses, kept under its old name for callers
from .ops.resample import quantize_device as _quantize_device  # noqa: F401
from .utils.spans import span, spanned

# Warps a predictor keeps.  An entry holds the validity mask (3.7 MB at
# 1440×2560 outputs) and on the CPU ~240 MB of float64 / int32 host
# geometry for the plain twin (on a card K5 takes the matrix and derives
# the rest), so only the most recently used few stay.
WARP_CACHE_SIZE = 4
# The border of the validity mask's white frame (eval_lut_warp.py:197-204)
MASK_BORDER = 4
# Dynamic-scale requests' serving geometries a predictor keeps (a few KB
# each): a server sees few distinct (size, scale) pairs at a time.
SERVING_CACHE_SIZE = 64


def _out_dtype(norm: int):
    """K1 writes uint8 itself when the range allows it; otherwise float32,
    which ``_quantize_host`` finishes."""
    return torch.uint8 if norm <= 255 else torch.float32


def _quantize_host(arr, norm):
    """Finish quantization for outputs the device couldn't cast (norm>255)."""
    a = np.asarray(arr)
    if a.dtype == np.uint8:
        return a
    return np.clip(np.round(a), 0, norm).astype(np.uint8)


def _rgb_hwc(img_hwc) -> np.ndarray:
    """An [H,W,C] image, a gray [H,W] one as three channels."""
    img = np.asarray(img_hwc)
    return np.stack([img] * 3, axis=-1) if img.ndim == 2 else img


def _rgb_chw(img_hwc) -> np.ndarray:
    """An [H,W,C] image (or a gray [H,W] one, as three channels) →
    contiguous [C,H,W]."""
    return np.ascontiguousarray(_rgb_hwc(img_hwc).transpose(2, 0, 1))


def _dyn_resize_host(in_sz, scale_h, scale_w, supp_size):
    """Host prep of ``upscale_dynamic`` (``lerf_tpu.pipeline.
    _dyn_resize_host``): the serving geometry
    (:class:`~lerf_torch.ops.geometry.ResizeOperands`) of an ``in_sz``
    image at the scale, or ``None`` outside the dynamic envelope (support ≠ 2, a
    downscale beyond the 1/32 support cap, the scale-1 skip), where the
    caller takes ``upscale``.  Downscale (or mixed) requests serve through
    the antialiased support-bucket operands (``ResizeOperands.create_any``).
    """
    sh, sw = float(scale_h), float(scale_w)
    if supp_size != 2 or (sh == 1.0 and sw == 1.0):
        return None
    try:
        if sh >= 1.0 and sw >= 1.0:
            return geo.ResizeOperands.create(in_sz, scale_factors=[sh, sw])
        return geo.ResizeOperands.create_any(in_sz, scale_factors=[sh, sw])
    except ValueError:
        return None


def _lru(cache: OrderedDict, key, make, size: int):
    """``cache[key]``, made by ``make()`` when missing; at most ``size``
    entries, the least recently used dropped first."""
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    cache[key] = make()
    while len(cache) > size:
        cache.popitem(last=False)
    return cache[key]


def _warp_entry(cache: OrderedDict, in_sz, matrix, out_sz, support: int,
                device):
    """[the warp K5 or its twin takes, host validity mask] for one (in_sz,
    homography, out_sz), kept in ``cache`` (at most
    :data:`WARP_CACHE_SIZE` entries) under the key JAX gives its warp
    programs (``pipeline.py:1221,1272``).  On a card: :class:`WarpParams`
    (the matrix: K5 derives the geometry itself) and ``None`` until the
    first call, whose K5 launch writes the mask on the card
    (:meth:`_Predictor.run_warp_device` keeps its host copy here); on the
    CPU: the host :class:`~lerf_torch.ops.geometry.WarpGeometry` its plain
    twin reads and the host mask (``nearest_warp_mask_host``), both at
    ``support``."""
    matrix = np.asarray(matrix, dtype=np.float64)

    def make():
        if device.type == "cuda":
            return [WarpParams.create(in_sz, matrix, out_sz,
                                      support=support), None]
        return [geo.WarpGeometry.create(in_sz, matrix, out_sz,
                                        support=support),
                nearest_warp_mask_host(tuple(in_sz), matrix, tuple(out_sz),
                                       border=MASK_BORDER)]
    return _lru(cache, (tuple(in_sz), matrix.tobytes(), tuple(out_sz)),
                make, WARP_CACHE_SIZE)


def _host(e):
    """A request's extra on the host: a tensor as its numpy view, but a
    bf16 one (numpy has no bf16) as the host tensor itself."""
    if not isinstance(e, torch.Tensor) or e.dtype == torch.bfloat16:
        return e
    return e.numpy()


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` (on the card) into a pinned host tensor of PyTorch's caching
    host allocator, without blocking, on the current stream; the allocator
    keeps the block from reuse until the copy is done and the tensor is
    freed."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class ServingFuture:
    """An in-flight request (``lerf_tpu.pipeline.ServingFuture``): its host
    work done and its device work dispatched, its device→host copy not yet
    awaited.  ``result()`` waits for the copy (on a card the request's CUDA
    event; an error of the device work surfaces there), finishes the host
    part and is idempotent.  On the CPU a request computes at dispatch and
    ``result()`` only finishes the host part.

    Serving loops hold a bounded queue of these (:mod:`lerf_torch.serve`),
    so that the host work of frame k+1 overlaps the device work and copies
    of frame k."""
    __slots__ = ("_finish", "_value")

    def __init__(self, finish):
        self._finish = finish

    @classmethod
    def resolved(cls, value):
        """A future that already holds its value."""
        fut = cls(None)
        fut._value = value
        return fut

    def result(self):
        if self._finish is not None:
            self._value = self._finish()
            self._finish = None
        return self._value


class _Predictor:
    """What the deploy forms share: the resize and warp after the stages,
    and the serving forms.  A form supplies ``_input`` (its device input
    from [..., C, H, W] uint8 / float pixels on the host), ``_cast`` (the
    same from a uint8 [..., C, H, W] view on the card), ``_stages`` (→ feat
    [..., H, W] and hyper [..., H, W, oC]: int32 codes in the LUT and SRNet
    forms, float32 maps in [0, 1] in the IMDN form; K1 and K5 take either)
    and ``_aux`` (the types ``return_aux`` gives).  The kernel is the
    steerable Gaussian, or with ``linear`` the amplified-linear one on the
    first hyper channel.

    Every request form (SR and warp, static, dynamic, device and batched,
    and the ``*_async`` forms, whose synchronous forms are ``async(...)
    .result()``) goes through :meth:`_request`: on a card its device work
    runs on the predictor's side stream, its frame is staged up through
    pinned memory as uint8 and comes back through pinned memory.

    So on a card every result (frame, mask, aux) is a numpy view of a
    pinned tensor of PyTorch's caching host allocator.  Its block returns
    to the allocator's pool when the last view of it is freed, and later
    requests reuse it; the pool never gives blocks back to the system.  A
    caller that keeps N results keeps N results' pinned blocks (each
    rounded up by the allocator), and the pool stays at its largest for
    the life of the process; ``.copy()`` a result that is kept for long
    to hold it in pageable memory instead."""

    def _init_serving(self, *, linear, supp_size, max_sigma, norm, device,
                      mesh=None):
        if mesh is not None:
            _check_mesh(mesh)
            if device is not None and resolve_device(device) not in (
                    mesh.devices[0], torch.device(mesh.devices[0].type)):
                raise ValueError(f"device={device} but the mesh's first "
                                 f"device is {mesh.devices[0]}")
            device = mesh.devices[0]
        self.mesh = mesh
        self.device = concrete_device(device)
        self.linear = linear
        self.supp_size = supp_size
        self.max_sigma = max_sigma
        self.norm = norm
        self._resize_cache: Dict = {}
        self._serving_cache: OrderedDict = OrderedDict()
        self._warp_cache: OrderedDict = OrderedDict()
        # a request's device work runs on the side stream; one request
        # dispatches at a time, from any thread
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._lock = threading.RLock()

    def _skips(self, scale_h: float, scale_w: float) -> bool:
        """Whether a scale skips the stages (the net form at scale 1)."""
        return False

    def _codes(self, hyper: torch.Tensor) -> torch.Tensor:
        """The codes (or maps) the kernel reads: α, the first, in the
        linear mode (lerf_tpu's ``hyper[..., 0]``), else (ρ, σx, σy)."""
        return hyper[..., :1] if self.linear else hyper

    @staticmethod
    def _fold(feat: torch.Tensor, hyper: torch.Tensor):
        """Stage outputs of a batch, feat [B, C, H, W] and hyper [B, C, H,
        W, oC], with the batch folded into the channel axis ([B·C, H, W],
        the frames one after another), as K1 and K5 take them; a single
        frame's unchanged.  Folding after the stages keeps each frame's
        channels together for a stage that mixes them (the IMDN towers'
        convs)."""
        h, w = feat.shape[-2:]
        return (feat.reshape(-1, h, w),
                hyper.reshape(-1, h, w, hyper.shape[-1]))

    # -- requests: staging, the side stream, the future ----------------------

    @contextlib.contextmanager
    def _locked(self):
        """The predictor's lock, the wait for it a span of its own."""
        with span("lerf.lock"):
            self._lock.acquire()
        try:
            yield
        finally:
            self._lock.release()

    @spanned("lerf.upload")
    def _upload(self, imgs) -> torch.Tensor:
        """Host image(s) [..., H, W, C] → the form's input [..., C, H, W] on
        the device.  On a card a uint8 frame is copied into a pinned tensor
        of PyTorch's caching host allocator (which keeps the block from
        reuse until the copy out of it is done) and up without blocking, on
        the current stream (a request's side stream); the layout change
        and the form's cast (:meth:`_cast`) run on the card.  The CPU, and
        any other type, take the form's host :meth:`_input`."""
        img = np.asarray(imgs)
        if self._stream is None or img.dtype != np.uint8:
            return self._input(np.ascontiguousarray(np.moveaxis(img, -1, -3)))
        pinned = torch.empty(img.shape, dtype=torch.uint8, pin_memory=True)
        np.copyto(pinned.numpy(), img)
        return self._cast(pinned.to(self.device, non_blocking=True)
                          .movedim(-1, -3))

    def _request(self, dispatch, then=None) -> ServingFuture:
        """One request.  ``dispatch()`` enqueues its device work and returns
        (frame [..., C, oH, oW], extras: device tensors or host arrays to
        return beside it); the value is the uint8 frame [..., oH, oW, C], or
        (frame, *extras) as host arrays, and ``then(value)`` runs on it
        once.  Dispatch holds the predictor's lock.

        On a card it all runs on the predictor's side stream, which first
        waits for the caller's current stream (where the tables and the
        static operands may have been made); the frame is laid out [...,
        oH, oW, C] on the card, and it and the extras are copied into
        pinned tensors without blocking; an event marks the end.
        ``result()`` waits for the event and returns the pinned tensors'
        ``.numpy()`` views, which keep the tensors (and so their blocks)
        alive.  Every serving-cache entry is made and read on this stream,
        so an entry evicted while a kernel still reads it returns its
        blocks to this stream's pool, where only work queued after that
        kernel can take them.  On the CPU it computes now, and ``result()``
        finishes the value.  The request and its parts are spans
        (:mod:`lerf_torch.utils.spans`): ``lerf.request`` here,
        ``lerf.result`` in the ``result()`` call that finishes it."""
        with span("lerf.request"), self._locked():
            if self._stream is None:
                frame, extras = dispatch()
                host, done = [frame.movedim(-3, -1)] + list(extras), None
            else:
                caller = torch.cuda.current_stream(self.device)
                with torch.cuda.stream(self._stream):
                    self._stream.wait_stream(caller)
                    frame, extras = dispatch()
                    with span("lerf.copy_down"):
                        host = [_pinned_copy(frame.movedim(-3, -1))] + [
                            _pinned_copy(e) if isinstance(e, torch.Tensor)
                            else e for e in extras]
                        done = torch.cuda.Event()
                        done.record()

        def finish():
            with span("lerf.result"):
                if done is not None:
                    with span("lerf.wait"):
                        done.synchronize()
                return self._value(host[0].numpy(),
                                   [_host(e) for e in host[1:]], then)

        return ServingFuture(finish)

    def _value(self, frame: np.ndarray, extras, then):
        value = (_quantize_host(frame, self.norm), *extras)
        value = value if extras else value[0]
        if then is not None:
            then(value)
        return value

    # -- SR -----------------------------------------------------------------

    def _resize_fn(self, in_sz: Tuple[int, int], scale: Tuple[float, float],
                   device=None):
        """(geometry, its K1 operands on ``device``, default the
        predictor's) for one (in_sz, scale), cached."""
        device = self.device if device is None else device
        key = (tuple(in_sz), scale, device)
        if key not in self._resize_cache:
            geom = geo.ResizeGeometry.create(in_sz, scale_factors=list(scale),
                                             support=self.supp_size)
            self._resize_cache[key] = (geom, k1.ResizeOperands.create(
                geom, device, linear=self.linear))
        return self._resize_cache[key]

    def _resize(self, feat, hyper, geom, operands):
        return k1.steering_resize(feat, self._codes(hyper), geom,
                                  max_sigma=self.max_sigma, norm=self.norm,
                                  linear=self.linear, operands=operands,
                                  out_dtype=_out_dtype(self.norm))

    def run_device(self, x: torch.Tensor, scale: Tuple[float, float]):
        """The device part of a frame: the input [C, H, W] (or a batch [B,
        C, H, W]) on ``self.device`` (``_input``; with a mesh, on any of its
        devices) → (uint8 [C, oH, oW], or [B·C, oH, oW] for a batch, feat,
        hyper), all on the input's device, on the current stream."""
        geom, operands = self._resize_fn(tuple(x.shape[-2:]), scale,
                                         x.device)
        feat, hyper = self._stages(x)
        return (self._resize(*self._fold(feat, hyper), geom, operands),
                feat, hyper)

    def upscale(self, img_hwc: np.ndarray, scale_h: float, scale_w: float,
                return_aux: bool = False):
        """uint8/float [H,W,C] → uint8 [outH,outW,C]; with ``return_aux``
        also feat and hyper in the types ``lerf_tpu`` returns.
        On a card the result views pinned memory (see :class:`_Predictor`)."""
        sh, sw = float(scale_h), float(scale_w)
        img = _rgb_hwc(img_hwc)
        if self._skips(sh, sw):
            return self._skip(_rgb_chw(img)).transpose(1, 2, 0)

        def dispatch():
            out, feat, hyper = self.run_device(self._upload(img), (sh, sw))
            return out, self._aux(feat, hyper) if return_aux else ()

        return self._request(dispatch).result()

    def upscale_bucketed(self, img_hwc: np.ndarray, scale_h: float,
                         scale_w: float, granularity: int = 64):
        """SR for callers written against ``lerf_tpu``'s shape buckets:
        :meth:`upscale` itself.  lerf_tpu pads to a ``granularity``
        multiple so that XLA compiles one program a bucket; PyTorch runs
        eagerly and compiles nothing per shape, so a bucket would only add
        stage work on the pad.  Equal to lerf_tpu's ``upscale_bucketed``
        wherever that equals its own ``upscale`` (everywhere for the
        Gaussian; its LeRF-L bucket grid can sit an ulp off the image's,
        where the amplified-linear kernel jumps at |d| = 1)."""
        return self.upscale(img_hwc, scale_h, scale_w)

    def _serving_fn(self, in_sz: Tuple[int, int], scale: Tuple[float, float]):
        """(serving geometry, its K1 operands on a card, else ``None``) for
        one (in_sz, scale), or ``None`` outside the dynamic envelope; the
        last :data:`SERVING_CACHE_SIZE` kept.  The operands are made on
        the side stream, where the requests read them (see
        :meth:`_request`)."""
        def make():
            ops = _dyn_resize_host(in_sz, *scale, self.supp_size)
            if ops is None:
                return None
            if self._stream is None:
                return ops, None
            with torch.cuda.stream(self._stream):
                return ops, k1.ResizeOperands.from_serving(
                    ops, self.device, linear=self.linear)
        return _lru(self._serving_cache, (tuple(in_sz), scale), make,
                    SERVING_CACHE_SIZE)

    def upscale_dynamic_async(self, img_hwc: np.ndarray, scale_h: float,
                              scale_w: float,
                              granularity: int = 0) -> ServingFuture:
        """Non-blocking :meth:`upscale_dynamic` (``lerf_tpu``'s
        ``upscale_dynamic_async``): the frame staged and the stages and K1
        enqueued now; ``result()`` waits for the copy down.  A request
        outside the dynamic envelope resolves now through :meth:`upscale`,
        as lerf_tpu's does."""
        img = _rgb_hwc(img_hwc)
        scale = (float(scale_h), float(scale_w))
        with self._locked():
            entry = self._serving_fn(img.shape[:2], scale)
        if entry is None:
            return ServingFuture.resolved(self.upscale(img, *scale))
        ops, operands = entry

        def dispatch():
            feat, hyper = self._stages(self._upload(img))
            return k1.steering_resize_serving(
                feat, self._codes(hyper), ops, operands=operands,
                max_sigma=self.max_sigma, norm=self.norm, linear=self.linear,
                out_dtype=_out_dtype(self.norm)), ()

        return self._request(dispatch)

    def upscale_dynamic(self, img_hwc: np.ndarray, scale_h: float,
                        scale_w: float, granularity: int = 0):
        """Arbitrary-scale SR through the serving geometry (``lerf_tpu``'s
        ``upscale_dynamic``): per axis the left neighbour in a
        fixed-pad frame and the float64 distances
        (:class:`~lerf_torch.ops.geometry.ResizeOperands`).  Antialiased
        downscales serve down to scale 1/32; scale 1, support ≠ 2 and
        smaller scales take :meth:`upscale`.  ``granularity``
        (lerf_tpu's bucket frame, one compiled program a bucket) changes
        nothing here: PyTorch compiles nothing per shape.  Bit-equal to
        :meth:`upscale`: on the CPU the rings resize, on a card K1 on the
        serving geometry's true support
        (``kernels.resize.steering_resize_serving``).
        On a card the result views pinned memory (see :class:`_Predictor`)."""
        return self.upscale_dynamic_async(img_hwc, scale_h, scale_w,
                                          granularity).result()

    def upscale_batch(self, imgs_bhwc: np.ndarray, scale_h: float,
                      scale_w: float) -> np.ndarray:
        """uint8 [B,H,W,C] → uint8 [B,outH,outW,C] (``lerf_tpu``'s
        ``upscale_batch``): the stages on the batch [B, C, H, W], their
        outputs folded into the channel axis for the resize, so the whole
        batch is one launch of each kernel.  With a mesh the batch splits
        across its shards (:meth:`_upscale_batch_sharded`).
        On a card the result views pinned memory (see :class:`_Predictor`)."""
        imgs = np.asarray(imgs_bhwc)
        b, c = imgs.shape[0], imgs.shape[-1]
        sh, sw = float(scale_h), float(scale_w)
        if self._skips(sh, sw):
            return self._skip(np.ascontiguousarray(
                imgs.transpose(0, 3, 1, 2))).transpose(0, 2, 3, 1)
        if self.mesh is not None:
            with self._lock:
                return self._upscale_batch_sharded(imgs, (sh, sw))

        def dispatch():
            out, _, _ = self.run_device(self._upload(imgs), (sh, sw))
            return out.reshape(b, c, *out.shape[-2:]), ()

        return self._request(dispatch).result()

    def _upscale_batch_sharded(self, imgs: np.ndarray, scale):
        """``upscale_batch`` over the mesh, lerf_tpu's data-parallel
        scale-out: the batch split evenly across the shards
        (:func:`~lerf_torch.parallel.shard_batch`, which raises when it does
        not divide; a uint8 batch through one pinned staging tensor), each
        shard's frames through its own stages and K1 (:meth:`run_device`)
        on its device and stream, each copied down into its rows of one
        pinned host batch.  No collective."""
        from .parallel import shard_batch

        mesh, cuda = self.mesh, self.device.type == "cuda"
        b, c = imgs.shape[0], imgs.shape[-1]
        if imgs.dtype == np.uint8:
            staged = torch.empty(imgs.shape, dtype=torch.uint8,
                                 pin_memory=cuda)
            np.copyto(staged.numpy(), imgs)
        else:
            staged = self._input(np.ascontiguousarray(
                np.moveaxis(imgs, -1, -3)))
        chunks = shard_batch(staged, mesh)
        geom, _ = self._resize_fn(imgs.shape[1:3], scale)
        host = torch.empty((b,) + tuple(geom.out_sz) + (c,),
                           dtype=_out_dtype(self.norm), pin_memory=cuda)
        step = b // mesh.size

        def run(i, x):
            if x.dtype == torch.uint8:
                x = self._cast(x.movedim(-1, -3))
            out, _, _ = self.run_device(x, scale)
            out = out.reshape(x.shape[0], c, *out.shape[-2:]).movedim(-3, -1)
            host[i * step:(i + 1) * step].copy_(out, non_blocking=cuda)

        mesh.map(run, chunks)
        if cuda:
            for dev in mesh.distinct:
                torch.cuda.current_stream(dev).synchronize()
        return _quantize_host(host.numpy(), self.norm)

    # -- warp ---------------------------------------------------------------

    def _warp_out(self, feat, hyper, warp, mask_out=None):
        """K5 (or its twin) on the stage outputs, in uint8 where the range
        allows it, NaN windows → 0; ``mask_out`` receives the mask.
        ``warp``: one warp, or a list of one :class:`WarpParams` a frame
        for frames stacked along the channel axis (one launch)."""
        warp_fn = steering_warp_batch if isinstance(warp, list) \
            else steering_warp
        out = warp_fn(feat, self._codes(hyper), warp,
                      max_sigma=self.max_sigma, norm=self.norm,
                      linear=self.linear, out_dtype=_out_dtype(self.norm),
                      mask_out=mask_out, border=MASK_BORDER)
        return out if out.dtype == torch.uint8 \
            else torch.nan_to_num(out, nan=0.0)

    def _warp_static(self, x: torch.Tensor, matrix, out_sz):
        """The stages and K5 of a warp kept per (in_sz, matrix, out_sz) →
        (out, the mask K5 wrote on the card or ``None``, the cache entry,
        feat, hyper): on the key's first call on a card K5 writes the mask
        in the same launch, and the caller keeps its host copy in the
        entry; afterwards (and on the CPU) the entry holds it."""
        entry = _warp_entry(self._warp_cache, tuple(x.shape[-2:]), matrix,
                            tuple(out_sz), self.supp_size, self.device)
        feat, hyper = self._stages(x)
        if entry[1] is not None:
            return self._warp_out(feat, hyper, entry[0]), None, entry, \
                feat, hyper
        mask = torch.empty(tuple(out_sz), dtype=torch.bool,
                           device=self.device)
        return self._warp_out(feat, hyper, entry[0], mask), mask, entry, \
            feat, hyper

    def run_warp_device(self, x: torch.Tensor, matrix: np.ndarray,
                        out_sz: Tuple[int, int]):
        """The device part of a warped frame: the input [C, H, W] on
        ``self.device`` → (uint8 [C, oH, oW], feat, hyper), all on the
        device, on the current stream: the stages, then K5 in uint8 mode
        (NaN windows → 0).  On a homography's first call on a card K5 also
        writes the validity mask in the same launch, and its host copy is
        kept with the warp.  Integer stage codes K5 takes as the JAX
        path's u8 rows do, float maps as its float rows."""
        out, mask, entry, feat, hyper = self._warp_static(x, matrix, out_sz)
        if mask is not None:
            entry[1] = mask.cpu().numpy()
        return out, feat, hyper

    def warp(self, img_hwc: np.ndarray, matrix: np.ndarray,
             out_hw: Tuple[int, int], return_aux: bool = False):
        """Homographic warp: uint8/float [H,W,C] → (uint8 [oH,oW,C], bool
        mask [oH,oW]), plus feat and hyper with ``return_aux``.

        Fully out-of-view support windows (NaN) are zeroed before
        quantization, matching the torch eval path (eval_model.py:261);
        the mask excludes them from mPSNR.  The warp's parameters (or on
        the CPU its host geometry) and the mask are cached per (image
        size, matrix, out size), for the last :data:`WARP_CACHE_SIZE`
        keys: a homography seen before runs K5 without the mask.
        On a card the result views pinned memory (see :class:`_Predictor`)."""
        img = _rgb_hwc(img_hwc)
        out_sz = tuple(int(v) for v in out_hw)
        first = []

        def dispatch():
            out, mask, entry, feat, hyper = self._warp_static(
                self._upload(img), matrix, out_sz)
            if mask is None:
                mask = entry[1].copy()
            else:
                first.append(entry)
            return out, (mask,) + (self._aux(feat, hyper) if return_aux
                                   else ())

        def then(value):
            for entry in first:          # keep the mask K5 wrote
                entry[1] = value[1].copy()

        return self._request(dispatch, then).result()

    # -- warp serving ---------------------------------------------------------

    def _serve_warps(self, imgs_bhwc: np.ndarray, matrices, out_sz):
        """The warp serving forms' one path: B frames [B, H, W, C] and one
        matrix each → (uint8 [B, C, oH, oW] and bool masks [B, oH, oW] on
        the device, feat, hyper): the stages on the batch [B, C, H, W], their
        outputs folded into the channel axis, then K5 over every frame under
        its own fresh
        :class:`WarpParams`, the masks written in the same launch; nothing
        is cached per matrix.  On a card one launch, with no host geometry
        and no per-pixel upload; on the CPU the plain twin frame by frame,
        from the host geometry and mask of each frame's matrix."""
        b, h, w, c = imgs_bhwc.shape
        feat, hyper = self._stages(self._upload(imgs_bhwc))
        warps = [WarpParams.create((h, w), m, out_sz, support=self.supp_size)
                 for m in matrices]
        masks = torch.empty((b,) + out_sz, dtype=torch.bool,
                            device=self.device)
        out = self._warp_out(*self._fold(feat, hyper), warps, masks)
        return out.reshape(b, c, *out_sz), masks, feat, hyper

    def warp_dynamic_async(self, img_hwc: np.ndarray, matrix: np.ndarray,
                           out_hw: Tuple[int, int], return_aux: bool = False,
                           granularity: int = 0) -> ServingFuture:
        """Non-blocking :meth:`warp_dynamic` (``lerf_tpu``'s
        ``warp_dynamic_async``): the frame staged and the stages and K5
        enqueued now; ``result()`` waits for the copies down."""
        img = _rgb_hwc(img_hwc)[None]
        matrix = np.asarray(matrix, np.float64)
        out_sz = tuple(int(v) for v in out_hw)

        def dispatch():
            out, mask, feat, hyper = self._serve_warps(img, [matrix], out_sz)
            return out[0], (mask[0],) + (self._aux(feat[0], hyper[0])
                                         if return_aux else ())

        return self._request(dispatch)

    def warp_dynamic(self, img_hwc: np.ndarray, matrix: np.ndarray,
                     out_hw: Tuple[int, int], return_aux: bool = False,
                     granularity: int = 0):
        """Homographic warp as a serving form, any matrix a request
        (``lerf_tpu``'s ``warp_dynamic``): on a card the stages and one K5
        launch from a fresh :class:`WarpParams`, the mask written by K5 (no
        host geometry, nothing kept per matrix); on the CPU K5's plain
        twin.  ``granularity`` (lerf_tpu's bucket frame, one compiled
        program a bucket) changes nothing here: PyTorch compiles nothing
        per shape.  Bit-equal to :meth:`warp`.
        On a card the result views pinned memory (see :class:`_Predictor`)."""
        return self.warp_dynamic_async(img_hwc, matrix, out_hw, return_aux,
                                       granularity).result()

    def warp_device_async(self, img_hwc: np.ndarray, matrix: np.ndarray,
                          out_hw: Tuple[int, int],
                          granularity: int = 0) -> ServingFuture:
        """Non-blocking :meth:`warp_device`: :meth:`warp_dynamic_async`."""
        return self.warp_dynamic_async(img_hwc, matrix, out_hw,
                                       granularity=granularity)

    def warp_device(self, img_hwc: np.ndarray, matrix: np.ndarray,
                    out_hw: Tuple[int, int], granularity: int = 0):
        """Device-geometry warp serving (``lerf_tpu``'s ``warp_device``):
        the per-frame operand is the matrix alone, the geometry and the
        mask derived on the card.  K5 does that for every form of the
        port, in float64, so this is :meth:`warp_dynamic`: bit-equal to
        :meth:`warp` and to lerf_tpu's ``warp``, where lerf_tpu's own
        float32 device geometry is not.  Returns (uint8 [oH,oW,C], bool
        mask [oH,oW]).
        On a card the result views pinned memory (see :class:`_Predictor`)."""
        return self.warp_device_async(img_hwc, matrix, out_hw,
                                      granularity).result()

    def warp_batch(self, imgs_bhwc: np.ndarray, matrices: np.ndarray,
                   out_hw: Tuple[int, int], geometry: str = "host"):
        """Batched warp serving (``lerf_tpu``'s ``warp_batch``): uint8
        [B,H,W,C] and one homography a frame [B,3,3] (or one shared [3,3])
        → (uint8 [B,oH,oW,C], bool mask [B,oH,oW]).  On a card one launch
        of each stage kernel (the batch folded into the channel axis) and
        one K5 launch for the batch (each frame's own matrix, its mask
        written in the same launch).  ``geometry`` ("host" or "device",
        lerf_tpu's choice of where its geometry is made) gives the same
        call here: K5 derives it on the card in float64.  Each frame
        bit-equal to its :meth:`warp`.
        On a card the result views pinned memory (see :class:`_Predictor`)."""
        if geometry not in ("host", "device"):
            raise ValueError(
                f"geometry={geometry!r}: must be 'host' or 'device'")
        imgs = np.asarray(imgs_bhwc)
        matrices = np.asarray(matrices, dtype=np.float64)
        if matrices.ndim == 2:
            matrices = np.broadcast_to(matrices, (imgs.shape[0], 3, 3))
        out_sz = tuple(int(v) for v in out_hw)

        def dispatch():
            out, mask, _, _ = self._serve_warps(imgs, list(matrices), out_sz)
            return out, (mask,)

        return self._request(dispatch).result()


class LutPredictor(_Predictor):
    """Two-stage LUT inference: feature LUTs → hyper LUTs → steerable
    resample, with bit-exact stage arithmetic (eval_lut_sr.py semantics).

    ``linear``: the LeRF-L form, whose bank's stage 2 has one output
    channel (α); the LeRF-G form's has three.  ``device``: ``None`` →
    ``cuda`` (raises without a card), or ``"cpu"``.  The bank's tables
    live on that device in ``table_layout`` (lerf_tpu's four: ``"flat"``,
    the port's default, :class:`FlatTables`; ``"packed8"`` /
    ``"packed32"``, rotation-group rows of int8 / int32; ``"cells"``, int32
    cell rows; see :mod:`lerf_torch.ops.lut_pipeline`), every layout
    bit-equal; with ``mesh``, on each of the mesh's distinct devices (see
    the module doc).
    """

    @classmethod
    def from_config(cls, cfg, **kwargs):
        """Load the LUT bank named by a TestConfig and build the predictor
        on ``cfg.device`` (reference: eval_lut_sr.py:750-775)."""
        from .lut.io import load_lut_bank

        out_c = 1 if cfg.linear else 3
        bank = load_lut_bank(cfg.exp_dir, lut_name=cfg.lut_name,
                             modes=tuple(cfg.modes), modes2=tuple(cfg.modes2),
                             out_c=out_c, interval=cfg.interval,
                             stages=cfg.stages)
        kwargs.setdefault("device", cfg.device)
        return cls(bank, linear=cfg.linear, modes=tuple(cfg.modes),
                   modes2=tuple(cfg.modes2),
                   supp_size=cfg.supp_size, max_sigma=cfg.max_sigma,
                   stages=cfg.stages, norm=cfg.norm, **kwargs)

    def __init__(self, bank: LUTBank, *, linear: bool = False,
                 modes=("s", "c", "t"), modes2=("s", "c", "t"),
                 supp_size: int = 2, max_sigma: float = 10.0,
                 stages: int = 2, norm: int = 255,
                 table_layout: str = "flat", mesh=None, device=None):
        if table_layout not in TABLE_LAYOUTS:
            raise ValueError(f"unknown table_layout {table_layout!r}")
        if stages != bank.stages:
            raise ValueError(
                f"stages={stages} but the LUT bank holds {bank.stages} "
                f"stages ({len(bank.inter)} intermediate feature table sets "
                "+ final feature + hyper) — load_lut_bank(stages=...) must "
                "match (eval_lut_sr.py:747-775 loads one table set per "
                "stage)")
        if bank.out_c != (1 if linear else 3):
            raise ValueError(
                "the amplified-linear (LeRF-L) form needs out_c == 1"
                if linear else "the Gaussian (LeRF-G) form needs out_c == 3")
        self._init_serving(linear=linear, supp_size=supp_size,
                           max_sigma=max_sigma, norm=norm, device=device,
                           mesh=mesh)
        self.bank = bank
        self.modes = tuple(modes)
        self.modes2 = tuple(modes2)
        self.stages = stages
        self.table_layout = table_layout

        def tables(luts, modes, split_r, dev):
            return stage_tables(luts, table_layout, modes, split_r=split_r,
                                interval=bank.interval, device=dev)

        # (intermediate, stage 1, stage 2) tables on each device
        self._tables = {
            dev: ([tables(t, self.modes, False, dev) for t in bank.inter],
                  tables(bank.stage1, self.modes, False, dev),
                  tables(bank.stage2, self.modes2, True, dev))
            for dev in (mesh.distinct if mesh is not None
                        else (self.device,))}
        self._inter, self._s1, self._s2 = self._tables[self.device]

    def _input(self, chw: np.ndarray) -> torch.Tensor:
        """The LUT form's int32 [..., C, H, W] input on the device; the
        stages index the LUT lattice with the raw 8-bit values, so they
        must lie in 0..255."""
        x = np.asarray(chw).astype(np.int32)
        if x.size and (x.min() < 0 or x.max() > 255):
            raise ValueError("image values must lie in 0..255")
        return torch.from_numpy(x).to(self.device)

    @staticmethod
    def _cast(u8: torch.Tensor) -> torch.Tensor:
        """uint8 [..., C, H, W] (any strides, on the card) → the int32
        input, contiguous; uint8 values lie in 0..255."""
        return u8.to(torch.int32, memory_format=torch.contiguous_format)

    @spanned("lerf.stages")
    def _stages(self, img_i32: torch.Tensor):
        """img [..., H, W] int32 → (feat int32 [..., H, W], hyper int32
        [..., H, W, oC]).

        Stage loop parity: eval_lut_sr.py:541-577 — each feature stage uses
        its OWN table set; intermediate stages average over modes·4 with a
        +norm//2 bias, the final feature stage over modes with no bias.
        """
        interval = self.bank.interval
        inter, s1, s2 = self._tables[img_i32.device]
        feat = img_i32
        for tables in inter:
            feat = lut_stage1_intermediate(feat, tables, self.modes,
                                           interval=interval, norm=self.norm)
        feat = lut_stage1(feat, s1, self.modes, interval=interval,
                          norm=self.norm)
        hyper = lut_stage2(feat, s2, self.modes2, interval=interval,
                           norm=self.norm)
        return feat, hyper

    def _aux(self, feat, hyper):
        return feat, hyper


def _check_mesh(mesh):
    from .parallel import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh={mesh!r}: a lerf_torch.parallel.Mesh "
                        "(make_mesh)")


def _devices(mesh, device):
    """The devices a form's weights go to: the mesh's distinct devices
    (its first is the predictor's), or the one ``device``."""
    if mesh is None:
        return (concrete_device(device),)
    _check_mesh(mesh)
    return mesh.distinct


class NetPredictor(_Predictor):
    """Two-stage *network* inference: feature net → hyper net → resample.

    Mirrors ``lerf_tpu.pipeline.NetPredictor`` (the SRNet form,
    :meth:`from_srnets`, and the IMDN form, :meth:`from_imdn`) with the
    same public API as :class:`LutPredictor`.  ``stage1_fn(x)`` maps
    [..., H, W] float32 in [0,1] → feature in [0,255] (float);
    ``stage2_fn(x)`` maps [..., H, W] in [0,1] → int32 hyper codes
    [..., H, W, oC] in 0..norm (``lerf_tpu``'s hyper is ``codes / norm``),
    or float32 hyper maps in [0, 1] (the IMDN form, lerf_tpu's
    ``hyper_u8=False``), and then the feature stays float (not rounded).
    With ``linear`` the resample reads the first hyper channel as α.

    ``device``: ``None`` → ``cuda`` (raises without a card), or ``"cpu"``.
    With ``mesh``, the stage functions must run on each of its devices
    (:meth:`from_srnets` and :meth:`from_imdn` make theirs so: one copy of
    the weights a distinct device, picked by the input's device).
    """

    def __init__(self, stage1_fn, stage2_fn, *, linear: bool = False,
                 two_stage: bool = True, supp_size: int = 2,
                 max_sigma: float = 10.0, norm: int = 255, mesh=None,
                 device=None):
        self._init_serving(linear=linear, supp_size=supp_size,
                           max_sigma=max_sigma, norm=norm, device=device,
                           mesh=mesh)
        self.stage1_fn = stage1_fn
        self.stage2_fn = stage2_fn
        self.two_stage = two_stage

    @classmethod
    def from_srnets(cls, params, *, modes=("s", "c", "t"),
                    modes2=("s", "c", "t"), stages: int = 2,
                    linear: bool = False, two_stage: bool = True,
                    supp_size: int = 2, max_sigma: float = 10.0,
                    norm: int = 255, backend: str = "auto", mesh=None,
                    device=None):
        """LeRF-L/G trainable form (SRNetsSWF2 pixel-MLP ensemble).

        ``params``: :func:`lerf_torch.models.srnet.init_lerf_nets` layout
        (float32 or bfloat16 tensors on any device); LeRF-L's stage-2
        heads have one output (``out_c=1``).  ``backend``: "auto" /
        "pallas" run K3 (the kernel on a card, its plain twin on the CPU)
        in the heads' compute type: bf16 heads run K3's bf16 instance, as
        lerf_tpu's kernel computes in bf16 for them; "xla" the plain
        batched chain in float32; "pallas_int8" (opt-in) K4 on heads
        post-training-quantized here, once, against the 17⁴ deploy
        lattice.  The member heads are stacked on the device once, here.
        Inference only."""
        backend = srnet.resolve_backend(backend)
        devs = _devices(mesh, device)
        if backend == "pallas_int8":
            params = srnet.quantize_lerf_params(params)
        heads = {dev: ([srnet.prepare_heads(
            srnet.stage1_heads(params, s, modes), backend, dev)
            for s in range(stages - 1)],
            srnet.prepare_heads(srnet.stage2_heads(params, modes2), backend,
                                dev)) for dev in devs}

        def s1(x):
            return srnet.stage1_from_heads(heads[x.device][0], x,
                                           modes=modes, norm=norm,
                                           backend=backend)

        def s2(x):
            return srnet.stage2_levels(heads[x.device][1], x, modes2=modes2,
                                       norm=norm,
                                       backend=backend).to(torch.int32)

        return cls(s1, s2, linear=linear, two_stage=two_stage,
                   supp_size=supp_size, max_sigma=max_sigma, norm=norm,
                   mesh=mesh, device=devs[0])

    @classmethod
    def from_imdn(cls, model, variables=None, *, out_c: int = 3,
                  linear: bool = False, two_stage: bool = True,
                  supp_size: int = 2, max_sigma: float = 10.0,
                  norm: int = 255, backend: str = "auto", s2d_block: int = 2,
                  mesh=None, device=None):
        """LeRF-Net / LeRF-Net++ (the port's :class:`~lerf_torch.models.
        imdn.IMDN2`, inC 3; ``lerf_tpu/pipeline.py:280-315``).

        ``variables``: ``None`` (the model's own weights) or a state dict
        of its layout (:func:`lerf_torch.convert.imdn_from_arrays` of
        lerf_tpu's variables, :func:`lerf_torch.models.convert.
        imdn_from_torch_checkpoint` of a reference checkpoint), loaded into
        a copy; the caller's model is left as it is.  ``two_stage=False``
        skips the feature tower as the reference does (feat =
        round(img·norm), the hyper net sees the image).  The stages give
        float feature and hyper maps in [0, 1] (stage 2's ``[ρ·C, σx·C,
        σy·C]`` channels to the trailing axis) in the model's compute type
        (``model.dtype``, as lerf_tpu passes ``dtype=model.dtype``):
        float32, which K1 and K5 take in their float mode, or bf16, which
        they take as bf16 in their bf16 instance (the feature divided by
        ``norm`` in bf16 for stage 2, nothing widened; ``return_aux``
        gives bf16 tensors).  ``backend``: "base", "s2d" (the space-to-depth
        re-embedding at ``s2d_block``) or "auto"
        (:func:`lerf_torch.models.imdn_s2d.resolve_backend`).  On a card the
        float32 base towers run on their own kernel (``imdn_conv``, one
        launch a conv); every other conv runs under the scoped
        full-float32 cuDNN flags
        (:func:`~lerf_torch.models.imdn_s2d.cudnn_fp32`).  Inference
        only."""
        from .models.imdn_s2d import make_chw_stage_fns

        devs = _devices(mesh, device)
        model = copy.deepcopy(model)
        if variables is not None:
            model.load_state_dict(variables)
        fns = {dev: make_chw_stage_fns(model, backend=backend,
                                       block=s2d_block, norm=norm,
                                       out_c=out_c, device=dev)
               for dev in devs}
        return cls(lambda x: fns[x.device][0](x),
                   lambda x: fns[x.device][1](x), linear=linear,
                   two_stage=two_stage, supp_size=supp_size,
                   max_sigma=max_sigma, norm=norm, mesh=mesh, device=devs[0])

    def _skips(self, scale_h: float, scale_w: float) -> bool:
        """Scale 1 on both axes skips the nets (eval_model.py:153-154)."""
        return scale_h == 1.0 and scale_w == 1.0

    def _skip(self, chw: np.ndarray) -> np.ndarray:
        out = np.round(chw.astype(np.float32) / self.norm * self.norm)
        return np.clip(out, 0, self.norm).astype(np.uint8)

    def _input(self, chw: np.ndarray) -> torch.Tensor:
        """float32 [..., C, H, W] in [0,1] on the device."""
        return torch.from_numpy(np.asarray(chw).astype(np.float32)
                                / self.norm).to(self.device)

    def _cast(self, u8: torch.Tensor) -> torch.Tensor:
        """uint8 [..., C, H, W] (any strides, on the card) → float32 in
        [0, 1], contiguous: the IEEE division numpy does on the host
        (:func:`~lerf_torch.ops.lut_pipeline.divide_exact`)."""
        return divide_exact(u8.to(torch.float32,
                                  memory_format=torch.contiguous_format),
                            self.norm)

    @spanned("lerf.stages")
    def _stages(self, img_f: torch.Tensor):
        """img [..., H, W] float32 in [0,1] → (feat [..., H, W], hyper
        [..., H, W, oC]): int32 feature and codes, or float32 feature and
        maps where ``stage2_fn`` gives float maps.  ``two_stage=False`` skips the feature
        net like the reference (eval_model.py:124-129): feat =
        round(img·norm), the hyper net sees the image."""
        if self.two_stage:
            feat = self.stage1_fn(img_f)
            hyper_in = divide_exact(feat, self.norm)
        else:
            feat = torch.round(img_f * self.norm)
            hyper_in = img_f
        hyper = self.stage2_fn(hyper_in)
        if torch.is_floating_point(hyper):
            return feat, hyper
        return feat.to(torch.int32), hyper

    def _aux(self, feat, hyper):
        """feat (0..255) and hyper in [0,1], float32, or for bf16 towers
        bf16: the types ``lerf_tpu`` returns."""
        if torch.is_floating_point(hyper):
            return feat, hyper
        return (feat.to(torch.float32),
                divide_exact(hyper.to(torch.float32), self.norm))
