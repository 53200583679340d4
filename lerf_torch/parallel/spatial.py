"""Spatial (row) sharding of the deploy paths over a :class:`~.mesh.Mesh`.

The port of ``lerf_tpu/parallel/spatial.py``, each public function under
its own name and arguments.  Every shard computes a window of output rows:

* the resize and the warp (K1 and K5): from the source replicated on every
  distinct device, each shard launches its kernel on its window of output
  rows — K1 on :meth:`~lerf_torch.ops.kernels.resize.ResizeOperands.
  rows_window`, K5 with ``rows=(r0, r1)``, each row bit-equal to the
  whole launch's;
* the stages (K2 for the LUT form, K3 / K4 for the SRNet form, the cuDNN
  towers for the IMDN form): each shard runs them on its band of input
  rows plus a halo — ``2·MAX_PAD`` = 6 rows for two chained 3-row-local
  ensembles, ``stages × tower_halo_rows()`` = 44 for the IMDN towers —
  clipped at the image edges, and crops the halo off;
* the pipelines join the two with ONE collective: the stage slabs cast to
  float32 once, stacked (feat, ρ, σx, σy) and passed through one
  :func:`~.mesh.all_gather_rows` (lerf_tpu's ``_replicate_once``), whose
  whole the resize or warp reads in its float mode (the float mode decodes
  a hyper map ``h`` as the int32 mode decodes ``code / norm``: the same
  bits).

PyTorch compiles nothing per shape, so bands may differ in height
(:func:`~.mesh.row_ranges`): lerf_tpu's pad to a multiple of the mesh
with duplicated geometry rows, its replicate-``feat(h-1)`` fix-up past the
true bottom and its traced per-conv row masks are not needed.  An edge
shard's band ends at the image edge, where the stages' own replicate
padding (LUT, SRNet) or the convs' own zero padding (IMDN) is the whole
image's.

The outputs are :class:`~.mesh.RowShards`: they stay on their shards
(``to_host()`` / ``cat()`` gather them).  The resize and the SR pipelines
give ``[..., oH, oW]``, the static warps too, the stages (feat ``[..., H,
W]``, hyper ``[..., H, W, oC]``), and the dynamic and device-geometry
warps lerf_tpu's flat ``[C, N]`` (``N = oH·oW``, the rows' pixels on the
last axis).  lerf_tpu's geometry objects become the port's: a static
:class:`~lerf_torch.ops.geometry.ResizeGeometry`, the serving geometry
:class:`~lerf_torch.ops.geometry.ResizeOperands` (for lerf_tpu's
``ResizeRings``), :class:`~lerf_torch.ops.kernels.warp.WarpParams` (for
its ``WarpGeometry`` and ``WarpRings``: K5 takes the matrix), and the
float64 inverse (its traced ``inv``).
"""
from __future__ import annotations

import collections
from typing import Optional

import torch

from ..models.imdn_s2d import resolve_backend as imdn_backend
from ..models.imdn_s2d import tower_halo_rows
from ..ops import geometry as geo
from ..ops.kernels import resize as k1
from ..ops.kernels.warp import (WarpParams, steering_warp,
                                steering_warp_rings)
from ..ops.resample import WarpRings, rings_out_dtype
from ..ops.lut_pipeline import (MAX_PAD, divide_exact, lut_stage1,
                                lut_stage2)
from .mesh import (DATA_AXIS, Mesh, RowShards, all_gather_rows,
                   exchange_halos, replicate, row_ranges)

# the per-device objects a sharded call derives from its arguments (K1's
# operands of a geometry, the SRNet heads, the IMDN stage functions), kept
# for the last few arguments; each entry holds the argument, so its id()
# stays its own while the entry lives
_CACHE_SIZE = 16
_cache: "collections.OrderedDict" = collections.OrderedDict()


def _cached(obj, tag, make):
    key = (id(obj), tag)
    hit = _cache.get(key)
    if hit is not None and hit[0] is obj:
        _cache.move_to_end(key)
        return hit[1]
    value = make()
    _cache[key] = (obj, value)
    while len(_cache) > _CACHE_SIZE:
        _cache.popitem(last=False)
    return value


def _band(r0: int, r1: int, halo: int, h: int, align: int = 1):
    """The input rows ``[lo, hi)`` output rows ``[r0, r1)`` read: ``halo``
    rows each side, clipped at the image edges, ``lo`` down to a multiple
    of ``align``."""
    lo = max(r0 - halo, 0)
    return lo - lo % align, min(r1 + halo, h)


# ---------------------------------------------------------------------------
# the resize and the warp, each shard on its window of output rows
# ---------------------------------------------------------------------------


def _k1_windows(geom, mesh: Mesh, linear: bool):
    """{device: [K1's operands of each shard's window]} for the card
    devices of ``mesh`` (the static or the serving geometry)."""
    ranges = row_ranges(geom.out_sz[0], mesh.size)

    def make(dev):
        if isinstance(geom, geo.ResizeOperands):
            ops = k1.ResizeOperands.from_serving(geom, dev, linear=linear)
        else:
            ops = k1.ResizeOperands.create(geom, dev, linear=linear)
        return [ops.rows_window(r0, r1) if r1 > r0 else None
                for r0, r1 in ranges]

    return {d: _cached(geom, ("k1", d, linear, mesh.size), lambda: make(d))
            for d in mesh.distinct if d.type == "cuda"}


def _resize_rows(sources, geom, mesh: Mesh, *, max_sigma: float,
                 norm: int = 255, linear: bool = False,
                 out_dtype=torch.float32, lead=None,
                 result=None) -> RowShards:
    """K1 (float mode, or int32 codes) on each shard's window of the
    output rows of ``geom`` (a static :class:`ResizeGeometry` or the
    serving geometry), from ``sources[i]`` = (feat [C, H, W], hyper [C, H,
    W, oC]) on shard i's device; the slabs [C, rows, oW], or shaped
    ``lead + (rows, oW)``; ``result``: the slabs' type, where it is not
    K1's ``out_dtype`` (bf16: K1's float32 output holds bf16 values)."""
    oh, ow = geom.out_sz
    ranges = row_ranges(oh, mesh.size)
    windows = _k1_windows(geom, mesh, linear)
    serving = isinstance(geom, geo.ResizeOperands)

    def run(i, src):
        feat, codes = src
        r0, r1 = ranges[i]
        if r1 == r0:
            out = torch.empty((feat.shape[0], 0, ow), dtype=out_dtype,
                              device=feat.device)
        else:
            dev = mesh.devices[i]
            ops = windows[dev][i] if dev in windows else None
            if serving:
                out = k1.steering_resize_serving(
                    feat, codes, geom.rows(r0, r1), operands=ops,
                    max_sigma=max_sigma, norm=norm, linear=linear,
                    out_dtype=out_dtype)
            else:
                out = k1.steering_resize(
                    feat, codes, geom.rows(r0, r1), operands=ops,
                    max_sigma=max_sigma, norm=norm, linear=linear,
                    out_dtype=out_dtype)
        if result is not None:
            out = out.to(result)
        return out if lead is None else out.reshape(
            tuple(lead) + tuple(out.shape[-2:]))

    return RowShards(mesh.map(run, sources), ranges, oh, axis=-2)


def _warp_rows(sources, warp: WarpParams, mesh: Mesh, *, max_sigma: float,
               norm: int = 255, linear: bool = False,
               out_dtype=torch.float32, lead=None, mask: bool = False,
               flat: bool = False, border: int = 4, result=None):
    """K5 on each shard's window of ``warp``'s output rows (see
    :func:`_resize_rows`, ``result`` too); with ``mask`` also the validity
    mask's rows, written in the same launch; ``flat``: lerf_tpu's [C, N]
    layout."""
    oh, ow = warp.out_sz
    ranges = row_ranges(oh, mesh.size)

    def run(i, src):
        feat, codes = src
        r0, r1 = ranges[i]
        m = (torch.empty((r1 - r0, ow), dtype=torch.bool, device=feat.device)
             if mask else None)
        out = steering_warp(feat, codes, warp, max_sigma=max_sigma,
                            norm=norm, linear=linear, out_dtype=out_dtype,
                            mask_out=m, border=border, rows=(r0, r1))
        if result is not None:
            out = out.to(result)
        if flat:
            out = out.reshape(out.shape[0], -1)
        elif lead is not None:
            out = out.reshape(tuple(lead) + tuple(out.shape[-2:]))
        return out, m

    outs = mesh.map(run, sources)
    if flat:
        frame = RowShards([o for o, _ in outs],
                          [(r0 * ow, r1 * ow) for r0, r1 in ranges],
                          oh * ow, axis=-1)
    else:
        frame = RowShards([o for o, _ in outs], ranges, oh, axis=-2)
    if not mask:
        return frame
    return frame, RowShards([m for _, m in outs], ranges, oh, axis=-2)


def _float_type(*ts) -> torch.dtype:
    """bf16 where every tensor of ``ts`` is bf16, else float32."""
    return torch.bfloat16 if all(t.dtype == torch.bfloat16 for t in ts) \
        else torch.float32


def _float_sources(img, rho, sigma_x, sigma_y, mesh: Mesh):
    """(feat [C', H, W], hyper [C', H, W, 3]) of a leading-dims source in
    the types given, as lerf_tpu's ops keep them (a bf16 feature or bf16
    maps stay bf16, anything else becomes float32), replicated once per
    distinct device; the leading dims; and lerf_tpu's result type, bf16
    where the feature and the maps both are, else float32.  K1 and K5 take
    each pair under its own code (``k1.IN_TYPES``), reading the bf16
    values as they are."""
    h, w = img.shape[-2:]
    lead = tuple(img.shape[:-2])
    maps = [torch.as_tensor(p).to(img.device)
            for p in (rho, sigma_x, sigma_y)]
    feat = img.to(_float_type(img)).reshape(-1, h, w)
    hyper = torch.stack([m.to(_float_type(*maps)) for m in maps], -1)
    return (replicate((feat.contiguous(), hyper.reshape(-1, h, w, 3)), mesh),
            lead, _float_type(feat, hyper))


def _check_pad(pad_mode: str):
    if pad_mode != "constant":
        raise ValueError(f"pad_mode={pad_mode!r}: K1 and K5 pad the feature "
                         "with zeros ('constant') only")


def steering_gaussian_resize_sharded(img, rho, sigma_x, sigma_y,
                                     geom: geo.ResizeGeometry, mesh: Mesh, *,
                                     max_sigma: float = 10.0,
                                     axis: str = DATA_AXIS,
                                     pad_mode: str = "constant"):
    """Row-sharded steerable resize: ``img`` [..., C, H, W] float and the
    hyper maps in [0, 1] replicated; each shard runs K1 (its instance for
    the pair of types: float32, bf16 or one of each; on the CPU its plain
    twin) on its window of ``geom``'s output rows.  Returns
    :class:`RowShards` of [..., oH, oW], bf16 for a bf16 feature and bf16
    maps, else float32 (lerf_tpu's promotion)."""
    _check_pad(pad_mode)
    sources, lead, result = _float_sources(img, rho, sigma_x, sigma_y, mesh)
    return _resize_rows(sources, geom, mesh, max_sigma=max_sigma, lead=lead,
                        result=result)


def steering_gaussian_warp_sharded(img, rho, sigma_x, sigma_y,
                                   geom: WarpParams, mesh: Mesh, *,
                                   max_sigma: float = 10.0,
                                   axis: str = DATA_AXIS,
                                   pad_mode: str = "constant"):
    """Output-row-sharded homographic warp: the source replicated, each
    shard K5 (its instance for the pair of types) on its window of the
    output rows of ``geom`` (:class:`WarpParams`, the matrix).  Returns
    :class:`RowShards` of [..., oH, oW] (NaN where a window's weights all
    vanish), bf16 for a bf16 feature and bf16 maps, else float32."""
    _check_pad(pad_mode)
    sources, lead, result = _float_sources(img, rho, sigma_x, sigma_y, mesh)
    return _warp_rows(sources, geom, mesh, max_sigma=max_sigma, lead=lead,
                      result=result)


# ---------------------------------------------------------------------------
# the stages, each shard on its band of input rows
# ---------------------------------------------------------------------------


def _stages_rows(img, mesh: Mesh, halo: int, run, *, align: int = 1):
    """``run(i, band) -> (feat, hyper)`` on each shard's band of ``img``
    [..., H, W] (replicated) with ``halo`` rows each side, cropped to the
    shard's rows: (feat [..., rows, W], hyper [..., rows, W, oC]) as
    :class:`RowShards`."""
    h = img.shape[-2]
    ranges = row_ranges(h, mesh.size)
    sources = replicate(img, mesh)

    def shard(i, src):
        r0, r1 = ranges[i]
        lo, hi = _band(r0, r1, halo, h, align)
        feat, hyper = run(i, src[..., lo:hi, :])
        return (feat.narrow(-2, r0 - lo, r1 - r0),
                hyper.narrow(-3, r0 - lo, r1 - r0))

    outs = mesh.map(shard, sources)
    return (RowShards([f for f, _ in outs], ranges, h, axis=-2),
            RowShards([y for _, y in outs], ranges, h, axis=-3))


def lut_stages_sharded(img, tables1, tables2, modes, mesh: Mesh, *,
                       modes2=None, axis: str = DATA_AXIS,
                       interval: int = 4, norm: int = 255):
    """Input-row-sharded LUT stages: ``img`` int32 [..., H, W] in 0..255
    replicated, each shard K2 twice (stage 1, stage 2; the plain twin on
    the CPU) on its band of rows plus ``2·MAX_PAD`` rows each side, the
    halo cropped.  ``tables1`` / ``tables2``: the stages'
    :class:`~lerf_torch.ops.lut_pipeline.FlatTables` (replicated once per
    distinct device); ``modes2`` defaults to ``modes``.  int32 bit-equal to
    the unsharded stages.  Returns (feat, hyper) :class:`RowShards`."""
    if modes2 is None:
        modes2 = modes
    t1, t2 = replicate(tables1, mesh), replicate(tables2, mesh)

    def run(i, band):
        feat = lut_stage1(band, t1[i], modes, interval=interval, norm=norm)
        return feat, lut_stage2(feat, t2[i], modes2, interval=interval,
                                norm=norm)

    return _stages_rows(img.to(torch.int32), mesh, 2 * MAX_PAD, run)


def _replicate_once(mesh: Mesh, feat: RowShards, hyper: RowShards,
                    norm: Optional[int]):
    """The stage slabs to every shard with ONE all-gather: per shard feat
    and the three hyper planes cast to float32 (int32 codes divided by
    ``norm``, exactly; float maps as they are; bf16 planes, the bf16 IMDN
    towers', stay bf16; bf16 maps beside a float32 feature travel as
    float32 and are cast back, exactly) and stacked, gathered, and split
    once per distinct device into (feat [C, H, W], hyper [C, H, W, 3]) —
    what K1 and K5 take in their float32 or bf16 instances."""
    dt = torch.bfloat16 if feat.dtype == torch.bfloat16 else torch.float32
    maps_dt = torch.bfloat16 if hyper.dtype == torch.bfloat16 else dt

    def stack(f, y):
        y = y.to(dt)
        if norm is not None:
            y = divide_exact(y, norm)
        return torch.stack([f.to(dt), y[..., 0], y[..., 1], y[..., 2]])

    stacks = mesh.map(lambda i, f, y: stack(f, y), feat.slabs, hyper.slabs)

    def split(whole):
        h, w = whole.shape[-2:]
        return (whole[0].reshape(-1, h, w).contiguous(),
                torch.stack([whole[1], whole[2], whole[3]], -1)
                .reshape(-1, h, w, 3).to(maps_dt))

    return all_gather_rows(stacks, mesh, axis=-2, then=split)


def sharded_lut_sr_pipeline(img, tables1, tables2, modes,
                            geom: geo.ResizeGeometry, mesh: Mesh, *,
                            modes2=None, max_sigma: float = 10.0,
                            norm: int = 255, interval: int = 4,
                            axis: str = DATA_AXIS,
                            out_dtype=torch.float32):
    """Multi-device LeRF-G SR: row-sharded LUT stages → one all-gather of
    the stacked planes → each shard K1 on its window of output rows.
    ``img`` int32 [C, H, W].  Returns :class:`RowShards` of [C, oH, oW]
    (float32, or with ``out_dtype=torch.uint8`` the frame K1 writes as the
    predictor's does): bit-equal to ``LutPredictor.upscale``'s."""
    feat, hyper = lut_stages_sharded(img, tables1, tables2, modes, mesh,
                                     modes2=modes2, interval=interval,
                                     norm=norm)
    sources = _replicate_once(mesh, feat, hyper, norm)
    return _resize_rows(sources, geom, mesh, max_sigma=max_sigma, norm=norm,
                        out_dtype=out_dtype)


def sharded_lut_warp_pipeline(img, tables1, tables2, modes,
                              geom: WarpParams, mesh: Mesh, *, modes2=None,
                              max_sigma: float = 10.0,
                              norm: int = 255, interval: int = 4,
                              axis: str = DATA_AXIS,
                              out_dtype=torch.float32, mask: bool = False):
    """Multi-device homographic warp: row-sharded LUT stages → one
    all-gather → each shard K5 on its window of ``geom``'s output rows
    (:class:`WarpParams`).  Returns :class:`RowShards` [C, oH, oW] (with
    ``mask``, also the validity mask's, written by K5 in the same
    launches): bit-equal to ``LutPredictor.warp``'s frame."""
    feat, hyper = lut_stages_sharded(img, tables1, tables2, modes, mesh,
                                     modes2=modes2, interval=interval,
                                     norm=norm)
    sources = _replicate_once(mesh, feat, hyper, norm)
    return _warp_rows(sources, geom, mesh, max_sigma=max_sigma, norm=norm,
                      out_dtype=out_dtype, mask=mask)


# ---------------------------------------------------------------------------
# the dynamic forms: the serving geometry, the matrix, the inverse
# ---------------------------------------------------------------------------


def steering_gaussian_warp_rings_sharded(img, rho, sigma_x, sigma_y,
                                         rings, mesh: Mesh, *,
                                         max_sigma: float = 10.0,
                                         u8_inputs: bool = True,
                                         axis: str = DATA_AXIS,
                                         pad_mode: str = "constant",
                                         out_sz=None):
    """Multi-device dynamic-homography warp: ``rings`` a
    :class:`~lerf_torch.ops.resample.WarpRings`, as lerf_tpu's takes (or
    :class:`WarpParams`, the matrix, from which K5 derives each window on
    the card).  The source is replicated; each shard warps its window of
    the outputs through its slice of the rings' corners and distances
    (``out_sz`` (oH, oW) given: output rows ``[r0, r1)``, entries ``r0·oW
    … r1·oW``; else the N entries split evenly), K5's rings instance on a
    card, its twin on the CPU.  ``u8_inputs``: the feature rounded and the
    hyper maps encoded as codes ``round(h·255)``, decoded ``code / 255``
    (lerf_tpu's u8 row gather); otherwise K5's instance for the pair of
    types.  Returns :class:`RowShards` of the flat [C, N], bit-equal to
    ``steering_gaussian_warp_rings`` unsharded, in its type (float32; bf16
    where the feature, the maps and the rings' distances all are, under
    the matrix where the feature and the maps are)."""
    _check_pad(pad_mode)
    if u8_inputs:
        h, w = img.shape[-2:]
        feat = torch.round(img.to(torch.float32)).to(torch.int32)
        codes = torch.stack([torch.round(torch.as_tensor(p).to(
            img.device, torch.float32) * 255.0).to(torch.int32)
            for p in (rho, sigma_x, sigma_y)], -1)
        sources = replicate((feat.reshape(-1, h, w).contiguous(),
                             codes.reshape(-1, h, w, 3)), mesh)
        result = None
    else:
        sources, _, result = _float_sources(img, rho, sigma_x, sigma_y, mesh)
    if isinstance(rings, WarpParams):
        return _warp_rows(sources, rings, mesh, max_sigma=max_sigma,
                          norm=255, flat=True, result=result)
    if result is not None:
        feat, codes = sources[0]
        result = rings_out_dtype(feat, [codes], rings, linear=False,
                                 u8_inputs=False)
    n = len(rings.corner)
    if out_sz is None:
        ranges, ow = row_ranges(n, mesh.size), 1
    else:
        ranges, ow = row_ranges(int(out_sz[0]), mesh.size), int(out_sz[1])
        if int(out_sz[0]) * ow != n:
            raise ValueError(f"out_sz {tuple(out_sz)} for {n} corners")

    def run(i, src):
        feat, codes = src
        a, b = (r * ow for r in ranges[i])
        part = WarpRings(rings.ring_x, rings.ring_y, rings.corner[a:b],
                         rings.dis_x[a:b], rings.dis_y[a:b])
        shape = None if out_sz is None else (ranges[i][1] - ranges[i][0],
                                             ow)
        out = steering_warp_rings(feat, codes, part, out_sz=shape,
                                  max_sigma=max_sigma, norm=255)
        if result is not None:
            out = out.to(result)
        return out.reshape(out.shape[0], -1)

    return RowShards(mesh.map(run, sources),
                     [(r0 * ow, r1 * ow) for r0, r1 in ranges], n, axis=-1)


def sharded_dynamic_warp_pipeline(img, tables1, tables2, modes,
                                  rings: WarpParams, mesh: Mesh, *,
                                  modes2=None, max_sigma: float = 10.0,
                                  norm: int = 255, interval: int = 4,
                                  axis: str = DATA_AXIS):
    """Multi-device dynamic-homography LUT warp (the distributed
    ``warp_dynamic``): row-sharded stages → one all-gather → each shard
    K5 on its window under ``rings`` (:class:`WarpParams`, any matrix a
    call).  Returns :class:`RowShards` of the flat [C, N] float32."""
    feat, hyper = lut_stages_sharded(img, tables1, tables2, modes, mesh,
                                     modes2=modes2, interval=interval,
                                     norm=norm)
    sources = _replicate_once(mesh, feat, hyper, norm)
    return _warp_rows(sources, rings, mesh, max_sigma=max_sigma, norm=norm,
                      flat=True)


def sharded_devgeo_warp_pipeline(img, tables1, tables2, modes, inv,
                                 out_sz, mesh: Mesh, *, modes2=None,
                                 max_sigma: float = 10.0, norm: int = 255,
                                 interval: int = 4, axis: str = DATA_AXIS):
    """Multi-device device-geometry warp (the distributed ``warp_device``):
    the per-frame operand is the float64 3×3 inverse alone, from which K5
    derives each shard's window of the geometry on the card
    (:meth:`WarpParams.from_inverse`).  Returns :class:`RowShards` of the
    flat [C, N] float32; bit-equal to ``warp_device`` of the matrix whose
    ``np.linalg.inv`` is ``inv``."""
    h, w = img.shape[-2:]
    warp = WarpParams.from_inverse((h, w), inv, out_sz)
    return sharded_dynamic_warp_pipeline(
        img, tables1, tables2, modes, warp, mesh, modes2=modes2,
        max_sigma=max_sigma, norm=norm, interval=interval)


def steering_gaussian_resize_rings_sharded(img, rho, sigma_x, sigma_y,
                                           rings: geo.ResizeOperands,
                                           mesh: Mesh, *,
                                           max_sigma: float = 10.0,
                                           axis: str = DATA_AXIS,
                                           pad_mode: str = "constant"):
    """Multi-device dynamic-scale resize (lerf_tpu's takes its rings; the
    port's the serving geometry they are made from,
    :class:`~lerf_torch.ops.geometry.ResizeOperands`): each shard K1 on its
    window of :meth:`~lerf_torch.ops.kernels.resize.ResizeOperands.
    from_serving` (the plain rings resize on the CPU), its instance for the
    pair of types.  Returns :class:`RowShards` of [C, oH, oW], bf16 for a
    bf16 feature and bf16 maps, else float32."""
    _check_pad(pad_mode)
    sources, lead, result = _float_sources(img, rho, sigma_x, sigma_y, mesh)
    return _resize_rows(sources, rings, mesh, max_sigma=max_sigma, lead=lead,
                        result=result)


def sharded_dynamic_sr_pipeline(img, tables1, tables2, modes,
                                rings: geo.ResizeOperands, mesh: Mesh, *,
                                modes2=None, max_sigma: float = 10.0,
                                norm: int = 255, interval: int = 4,
                                axis: str = DATA_AXIS,
                                out_dtype=torch.float32):
    """Multi-device dynamic-scale LUT SR (the distributed
    ``upscale_dynamic``): row-sharded stages → one all-gather → each shard
    K1 on its window of the serving geometry ``rings``.  Returns
    :class:`RowShards` of [C, oH, oW]."""
    feat, hyper = lut_stages_sharded(img, tables1, tables2, modes, mesh,
                                     modes2=modes2, interval=interval,
                                     norm=norm)
    sources = _replicate_once(mesh, feat, hyper, norm)
    return _resize_rows(sources, rings, mesh, max_sigma=max_sigma, norm=norm,
                        out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# the micro-net (SRNet) form
# ---------------------------------------------------------------------------


def _srnet_heads(params, backend, modes, modes2, dev):
    """(stage-1 heads, stage-2 heads) of ``params`` prepared for
    ``backend`` on ``dev`` (int8-quantized once for K4), cached."""
    from ..models import srnet

    def make():
        p = params
        if backend == "pallas_int8":
            p = _cached(params, "int8", lambda: srnet.quantize_lerf_params(
                params))
        return ([srnet.prepare_heads(srnet.stage1_heads(p, 0, modes),
                                     backend, dev)],
                srnet.prepare_heads(srnet.stage2_heads(p, modes2), backend,
                                    dev))

    return _cached(params, ("heads", backend, tuple(modes), tuple(modes2),
                            dev), make)


def srnet_stages_sharded(img, params, mesh: Mesh, *, modes=("s", "c", "t"),
                         modes2=None, norm: int = 255,
                         backend: str = "xla", axis: str = DATA_AXIS):
    """Input-row-sharded micro-net stages (the two-stage deploy form): the
    pixel-MLP ensembles sample through the LUT stages' ``MAX_PAD``
    replicate padding, so the same 6-row halo applies.  ``backend``:
    "xla" the plain chain, "auto" / "pallas" K3, "pallas_int8" K4 (the
    heads int8-quantized once).  ``img`` [..., H, W] integer or float in
    0..255.  Returns (feat in [0, 255], hyper [..., oC] in [0, 1]) float32
    :class:`RowShards`."""
    from ..models import srnet

    backend = srnet.resolve_backend(backend)
    if modes2 is None:
        modes2 = modes
    heads = {d: _srnet_heads(params, backend, modes, modes2, d)
             for d in mesh.distinct}

    def run(i, band):
        h1, h2 = heads[mesh.devices[i]]
        x = divide_exact(band.to(torch.float32), norm)
        feat = srnet.stage1_from_heads(h1, x, modes=modes, norm=norm,
                                       backend=backend)
        levels = srnet.stage2_levels(h2, divide_exact(feat, norm),
                                     modes2=modes2, norm=norm,
                                     backend=backend)
        return feat, divide_exact(levels, norm)

    return _stages_rows(img, mesh, 2 * MAX_PAD, run)


def sharded_net_sr_pipeline(img, params, geom: geo.ResizeGeometry,
                            mesh: Mesh, *, modes=("s", "c", "t"),
                            modes2=None, norm: int = 255,
                            max_sigma: float = 10.0, backend: str = "xla",
                            axis: str = DATA_AXIS, out_dtype=torch.float32):
    """Multi-device micro-net SR: row-sharded K3 / K4 stages → one
    all-gather → each shard K1 on its window.  Returns :class:`RowShards`
    of [C, oH, oW]."""
    feat, hyper = srnet_stages_sharded(img, params, mesh, modes=modes,
                                       modes2=modes2, norm=norm,
                                       backend=backend)
    sources = _replicate_once(mesh, feat, hyper, None)
    return _resize_rows(sources, geom, mesh, max_sigma=max_sigma, norm=norm,
                        out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# the IMDN (LeRF-Net) form
# ---------------------------------------------------------------------------


def _imdn_model(variables, nf: int, out_c: int, in_c: int):
    """The port's IMDN2 of ``variables``: the module itself, or a state
    dict of its layout loaded into IMDN2(in_c, out_c, nf) (cached)."""
    from ..models.imdn import IMDN2

    if isinstance(variables, torch.nn.Module):
        return variables

    def make():
        model = IMDN2(in_c=in_c, out_c=out_c, nf=nf)
        model.load_state_dict(variables)
        return model

    return _cached(variables, ("imdn", nf, out_c, in_c), make)


def _imdn_fns(variables, mesh: Mesh, *, backend, block, nf, norm, out_c,
              in_c, dtype):
    """{device: (s1, s2)}: the form's stage functions in ``dtype`` on each
    distinct device (``make_chw_stage_fns``), cached."""
    from ..models.imdn_s2d import make_chw_stage_fns

    model = _imdn_model(variables, nf, out_c, in_c)
    return {d: _cached(model, ("fns", backend, block, norm, out_c, dtype, d),
                       lambda d=d: make_chw_stage_fns(
                           model, backend=backend, block=block, norm=norm,
                           out_c=out_c, device=d, dtype=dtype))
            for d in mesh.distinct}


def _imdn_band(fns, band, *, norm, two_stage):
    """The IMDN stages on a band [..., C, rows, W] (0..255) → (feat, hyper
    [..., oC]), as ``NetPredictor._stages`` runs them."""
    s1, s2 = fns
    x = divide_exact(band.to(torch.float32), norm)
    if two_stage:
        feat = s1(x)
        hyper_in = divide_exact(feat, norm)
    else:
        feat = torch.round(x * norm)
        hyper_in = x
    return feat, s2(hyper_in)


def _imdn_dtype(dtype):
    """The towers' compute type: ``None`` is float32, as lerf_tpu's
    sharded stages take it (``parallel/spatial.py:604-605``), whatever the
    model's own."""
    return torch.float32 if dtype is None else dtype


def imdn_stages_sharded(img, variables, mesh: Mesh, *, backend: str = "base",
                        block: int = 2, nf: int = 12, norm: int = 255,
                        out_c: int = 3, two_stage: bool = True,
                        dtype=None, axis: str = DATA_AXIS):
    """Input-row-sharded IMDN2 towers (cuDNN, in ``dtype``: ``None`` or
    float32 full float32, or bf16, lerf_tpu's bf16 compute type): ``img``
    [..., C, H, W] (0..255) replicated, each shard runs the towers on its
    band of rows plus ``stages × tower_halo_rows()`` rows each side (44
    two-stage: band-edge garbage reaches 22 rows a tower), clipped at the
    image edges, where the convs' own zero padding is the whole image's;
    for "s2d" the band starts on a block row.  ``variables``: the port's
    :class:`~lerf_torch.models.imdn.IMDN2` (or a state dict of its layout,
    loaded into IMDN2(nf=nf)).  Returns (feat [..., C, H, W], hyper [...,
    C, H, W, out_c]) :class:`RowShards` of ``dtype``, within the IMDN
    form's gates of the unsharded towers (cuDNN may sum another shape in
    another order)."""
    backend = imdn_backend(backend)
    fns = _imdn_fns(variables, mesh, backend=backend, block=block, nf=nf,
                    norm=norm, out_c=out_c, in_c=img.shape[-3],
                    dtype=_imdn_dtype(dtype))
    halo = (2 if two_stage else 1) * tower_halo_rows()
    align = block if backend == "s2d" else 1
    return _stages_rows(img, mesh, halo, lambda i, band: _imdn_band(
        fns[mesh.devices[i]], band, norm=norm, two_stage=two_stage),
        align=align)


def imdn_stages_sharded_exchange(img_sharded, variables, mesh: Mesh, *,
                                 backend: str = "base", block: int = 2,
                                 nf: int = 12, norm: int = 255,
                                 out_c: int = 3, two_stage: bool = True,
                                 true_h=None, dtype=None,
                                 axis: str = DATA_AXIS):
    """Row-sharded IMDN towers with a halo exchange: the input arrives
    ROW-SHARDED (:class:`RowShards`, or one slab [..., C, rows_i, W] a
    shard on its device, in row order) and each shard receives its
    neighbours' edge rows by ONE :func:`~.mesh.exchange_halos` (one copy a
    direction across each boundary, no all-gather); shards at the image
    edges take no halo on that side.  Every slab must hold at least the
    halo (``stages × tower_halo_rows()`` rows), or it raises; the slabs
    need not be equal.  ``true_h``: rows from there on lie beyond the
    image (zero padding for the towers; their outputs are zeros).
    ``dtype`` as :func:`imdn_stages_sharded` takes it.  Returns (feat,
    hyper) :class:`RowShards` on the input's rows."""
    dtype = _imdn_dtype(dtype)
    if isinstance(img_sharded, RowShards):
        slabs, ranges = list(img_sharded.slabs), list(img_sharded.ranges)
    else:
        slabs = list(img_sharded)
        bounds = [0]
        for s in slabs:
            bounds.append(bounds[-1] + s.shape[-2])
        ranges = list(zip(bounds[:-1], bounds[1:]))
    h = ranges[-1][1]
    th = h if true_h is None else int(true_h)
    backend = imdn_backend(backend)
    fns = _imdn_fns(variables, mesh, backend=backend, block=block, nf=nf,
                    norm=norm, out_c=out_c, in_c=slabs[0].shape[-3],
                    dtype=dtype)
    halo = (2 if two_stage else 1) * tower_halo_rows()
    halos = exchange_halos(slabs, halo, mesh)

    def run(i, slab, edges):
        above, below = edges
        r0, r1 = ranges[i]
        band = torch.cat([t for t in (above, slab, below) if t is not None],
                         dim=-2)
        lo = r0 - (0 if above is None else halo)
        keep = max(min(th - lo, band.shape[-2]), 0)   # rows inside the image
        if keep == 0:
            # the one-stage feature is round(img * norm): float32
            feat = torch.zeros(band.shape, device=band.device,
                               dtype=dtype if two_stage else torch.float32)
            hyper = torch.zeros(band.shape + (out_c,), dtype=dtype,
                                device=band.device)
        else:
            feat, hyper = _imdn_band(fns[mesh.devices[i]],
                                     band.narrow(-2, 0, keep), norm=norm,
                                     two_stage=two_stage)
        if 0 < keep < band.shape[-2]:                  # beyond true_h: zeros
            pad = band.shape[-2] - keep
            feat = torch.nn.functional.pad(feat, (0, 0, 0, pad))
            hyper = torch.nn.functional.pad(hyper, (0, 0, 0, 0, 0, pad))
        return (feat.narrow(-2, r0 - lo, r1 - r0),
                hyper.narrow(-3, r0 - lo, r1 - r0))

    outs = mesh.map(run, slabs, halos)
    return (RowShards([f for f, _ in outs], ranges, h, axis=-2),
            RowShards([y for _, y in outs], ranges, h, axis=-3))


def sharded_imdn_sr_pipeline(img, variables, geom: geo.ResizeGeometry,
                             mesh: Mesh, *, backend: str = "base",
                             block: int = 2, nf: int = 12, norm: int = 255,
                             out_c: int = 3, two_stage: bool = True,
                             max_sigma: float = 10.0, axis: str = DATA_AXIS,
                             out_dtype=torch.float32, dtype=None):
    """Multi-device IMDN (LeRF-Net) SR: row-sharded towers in ``dtype``
    (:func:`imdn_stages_sharded`) → one all-gather of the stacked float32
    (or bf16) planes → each shard K1 (its float32 or bf16 instance) on its
    window.  Returns :class:`RowShards` of [C, oH, oW]."""
    feat, hyper = imdn_stages_sharded(img, variables, mesh, backend=backend,
                                      block=block, nf=nf, norm=norm,
                                      out_c=out_c, two_stage=two_stage,
                                      dtype=dtype)
    sources = _replicate_once(mesh, feat, hyper, None)
    return _resize_rows(sources, geom, mesh, max_sigma=max_sigma, norm=norm,
                        out_dtype=out_dtype)


def sharded_imdn_warp_pipeline(img, variables, geom: WarpParams,
                               mesh: Mesh, *, backend: str = "base",
                               block: int = 2, nf: int = 12, norm: int = 255,
                               out_c: int = 3, two_stage: bool = True,
                               max_sigma: float = 10.0,
                               axis: str = DATA_AXIS,
                               out_dtype=torch.float32, mask: bool = False,
                               dtype=None):
    """Multi-device IMDN homographic warp: row-sharded towers in ``dtype``
    → one all-gather → each shard K5 (its float32 or bf16 instance) on its
    window of ``geom``'s output rows.  Returns :class:`RowShards` of [C,
    oH, oW] (and the mask's with ``mask``)."""
    feat, hyper = imdn_stages_sharded(img, variables, mesh, backend=backend,
                                      block=block, nf=nf, norm=norm,
                                      out_c=out_c, two_stage=two_stage,
                                      dtype=dtype)
    sources = _replicate_once(mesh, feat, hyper, None)
    return _warp_rows(sources, geom, mesh, max_sigma=max_sigma, norm=norm,
                      out_dtype=out_dtype, mask=mask)
