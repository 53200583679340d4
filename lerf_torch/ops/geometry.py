"""Host-side resize and warp geometry precompute (numpy float64).

A copy of the resize, serving-resize and static-warp parts of
``lerf_tpu/ops/geometry.py``: the projected grid, field of view, pads and
neighbour distances of the reference precompute
(``resize_right/resize_right2d_numpy.py:18-104`` for resize, ``:306-407``
for warp), computed once per (in_shape, scale) or (in_shape, homography,
out_shape) on the host in float64.  The resize field of view is separable
and stored per axis as ``[out, support]`` arrays (:class:`ResizeGeometry`,
or :class:`ResizeOperands` over a fixed pad for dynamic-scale serving);
the warp's is per output pixel, ``[outH, outW, support]``.  K1 receives
its arrays cast to int32 / float32, exactly as the JAX path casts them.
K5 derives the warp's on the card from the inverse matrix;
:func:`warp_pads` and :func:`warp_operands_plain` are that derivation's
plain twin, the same float64 operations in torch, and
:func:`warp_mask_plain` that of the validity mask K5 writes.
:class:`WarpOperands` is the warp's geometry as data (lerf_tpu's
dynamic-homography serving operands: ring maps, a corner and distances
per output, from a homography or any projection grid), which the rings
warps and K5's rings instance take.
"""
from __future__ import annotations

import dataclasses
from math import ceil
from typing import Sequence

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def _check_rows(r0: int, r1: int, n: int):
    if not 0 <= r0 <= r1 <= n:
        raise ValueError(f"rows [{r0}, {r1}) outside the output's {n}")


def resolve_scale_and_out_sz(in_sz, scale_factors=None, out_sz=None):
    """Resolve (scale_h, scale_w), (outH, outW) from either spec.

    Parity: reference ``set_scale_and_out_sz`` (resize_right2d_numpy.py:25-49).
    ``in_sz``/``out_sz`` are spatial-only ``(H, W)`` pairs.
    """
    if out_sz is not None:
        out_sz = tuple(int(s) for s in out_sz)
        if scale_factors is None:
            scale_factors = [o / i for o, i in zip(out_sz, in_sz)]
    if scale_factors is not None:
        if not isinstance(scale_factors, (list, tuple)):
            scale_factors = [scale_factors, scale_factors]
        scale_factors = [float(s) for s in scale_factors]
        if out_sz is None:
            out_sz = tuple(ceil(s * i) for s, i in zip(scale_factors, in_sz))
    if scale_factors is None or out_sz is None:
        raise ValueError("need scale_factors and/or out_sz")
    return tuple(scale_factors), tuple(out_sz)


def _resize_axis(in_sz: int, out_sz: int, scale: float, support: int):
    """Per-axis projected grid / field-of-view / pad / distances.

    Parity: resize_right2d_numpy.py:57-104.  Projection formula
    ``g(o) = o/s + (in-1)/2 - (out-1)/(2s)`` computed in float64.  Pad may
    be negative (crop) — the resize path does NOT clamp it (numpy ref
    line 101).
    """
    grid = (np.arange(out_sz, dtype=np.float64) / scale
            + (in_sz - 1) / 2.0 - (out_sz - 1) / (2.0 * scale))
    left = np.ceil(grid - support / 2.0 - _EPS).astype(np.int64)
    fov = left[:, None] + np.arange(support, dtype=np.int64)[None, :]
    pad0 = int(-fov[0, 0])
    pad1 = int(fov[-1, -1] - in_sz + 1)
    fov = fov + pad0
    dis = (grid[:, None] + pad0) - fov
    return fov.astype(np.int32), dis, (pad0, pad1)


@dataclasses.dataclass(frozen=True)
class ResizeGeometry:
    """Static geometry for one (in_shape, scale/out_shape) resize config."""
    in_sz: tuple          # (H, W)
    out_sz: tuple         # (outH, outW)
    scale: tuple          # (scale_h, scale_w)
    support: int          # effective support size (after anti-alias inflate)
    base_support: int
    antialias: bool
    min_scale: float
    fov_x: np.ndarray     # [outH, S] int32 — row indices into padded image
    fov_y: np.ndarray     # [outW, S] int32
    dis_x: np.ndarray     # [outH, S] float64
    dis_y: np.ndarray     # [outW, S] float64
    pad_x: tuple          # (top, bottom), may be negative (crop)
    pad_y: tuple          # (left, right)

    @classmethod
    def create(cls, in_sz: Sequence[int], scale_factors=None, out_sz=None,
               support: int = 2, antialias: bool = True):
        """Build geometry.

        ``antialias=True`` reproduces the numpy deploy path: on downscale the
        support inflates by 1/min_scale and weights are evaluated at scaled
        distances (resize_right2d_numpy.py:51-55,186-193).
        """
        in_sz = tuple(int(s) for s in in_sz)
        scale, out = resolve_scale_and_out_sz(in_sz, scale_factors, out_sz)
        base_support = support
        aa = False
        min_scale = 1.0
        if antialias and (scale[0] < 1.0 or scale[1] < 1.0):
            aa = True
            min_scale = min(scale)
            support = ceil(support / min_scale)
        fov_x, dis_x, pad_x = _resize_axis(in_sz[0], out[0], scale[0], support)
        fov_y, dis_y, pad_y = _resize_axis(in_sz[1], out[1], scale[1], support)
        return cls(in_sz=in_sz, out_sz=out, scale=scale, support=support,
                   base_support=base_support, antialias=aa,
                   min_scale=min_scale, fov_x=fov_x, fov_y=fov_y,
                   dis_x=dis_x, dis_y=dis_y, pad_x=pad_x, pad_y=pad_y)

    def rows(self, r0: int, r1: int) -> "ResizeGeometry":
        """Output rows ``[r0, r1)`` alone: the same geometry with its
        row axis sliced (the pads stay the whole image's, which the field
        of view indexes), the window a shard of a row-sharded resize
        computes."""
        _check_rows(r0, r1, self.out_sz[0])
        return dataclasses.replace(
            self, out_sz=(r1 - r0, self.out_sz[1]), fov_x=self.fov_x[r0:r1],
            dis_x=self.dis_x[r0:r1])


def _resize_serving_axis(in_sz: int, out_sz: int, scale: float,
                         support: int):
    """Per-axis operands for dynamic-scale serving
    (``lerf_tpu.ops.geometry._resize_serving_axis``): the exact
    :func:`_resize_axis` grid / left / distance lines, re-expressed over a
    FIXED ±1 pad.  For an upscale at support 2 the reference's per-scale
    pads lie in {0, 1} per side, so padded index ``j`` of the
    ``pad0``-padded plane is index ``j - pad0 + 1`` of a plane padded by
    one row / column on each side, for both pad modes.

    Returns ``(idx, dis)``: the left neighbour ``[out]`` in the ±1-padded
    plane (neighbour ``s`` at ``idx + s``) and the float64 distances
    ``[out, S]``, the values of ``ResizeGeometry.dis_*``."""
    grid = (np.arange(out_sz, dtype=np.float64) / scale
            + (in_sz - 1) / 2.0 - (out_sz - 1) / (2.0 * scale))
    left = np.ceil(grid - support / 2.0 - _EPS).astype(np.int64)
    idx = left + 1
    if idx[0] != 0 or idx.min() < 0 or idx.max() + support - 1 > in_sz + 1:
        raise ValueError(
            "scale outside the ±1-frame serving envelope (upscaling only)")
    # the static path shifts grid and fov by pad0 (== 1 here) BEFORE it
    # subtracts; ``grid - fov`` directly differs by an ulp at grids that are
    # not representable (e.g. 1/3)
    dis = ((grid + 1.0)[:, None]
           - (idx[:, None] + np.arange(support, dtype=np.int64)[None, :]))
    return idx.astype(np.int32), dis


# the distance of an inactive (support-bucket pad) neighbour slot: far
# enough that the float64 linear branch masks are zero and the float32
# Gaussian exponent underflows, small enough that its square stays finite
_FAR = 1.0e8


def _resize_serving_axis_aa(in_sz: int, out_sz: int, scale: float,
                            sup_true: int, sup_bucket: int, pad: int):
    """Per-axis operands of the any-scale serving envelope
    (``lerf_tpu.ops.geometry._resize_serving_axis_aa``): the
    :func:`_resize_axis` lines at the true (antialias-inflated) support,
    over a FIXED ±``pad`` frame, distances in the static path's float64
    order (grid and fov both shifted by the true ``pad0`` first).  Slots
    ``s >= sup_true`` (the support bucket's padding) get distance
    :data:`_FAR` and weight mask 0.

    Returns ``(idx [out] int32, dis [out, sup_bucket] float64,
    wmask [out, sup_bucket] float32)``."""
    grid = (np.arange(out_sz, dtype=np.float64) / scale
            + (in_sz - 1) / 2.0 - (out_sz - 1) / (2.0 * scale))
    left = np.ceil(grid - sup_true / 2.0 - _EPS).astype(np.int64)
    pad0 = int(-left[0])          # the static path's pad (may be negative)
    idx = left + pad
    if idx.min() < 0 or idx.max() + sup_true - 1 > in_sz + 2 * pad - 1:
        raise ValueError("scale outside the ±pad serving frame "
                         f"(support {sup_true}, pad {pad})")
    offs = np.arange(sup_true, dtype=np.int64)[None, :]
    dis = np.full((out_sz, sup_bucket), _FAR, np.float64)
    dis[:, :sup_true] = (grid + pad0)[:, None] - (left[:, None] + offs + pad0)
    wmask = np.zeros((out_sz, sup_bucket), np.float32)
    wmask[:, :sup_true] = 1.0
    return idx.astype(np.int32), dis, wmask


def support_bucket(sup_true: int, floor: int = 2, cap: int = 64) -> int:
    """Smallest power of two ≥ ``sup_true`` (≥ ``floor``); raises beyond
    ``cap`` (cap 64: antialiased downscales to scale 1/32 serve
    dynamically; smaller scales keep the per-shape path)."""
    b = floor
    while b < sup_true:
        b *= 2
    if b > cap:
        raise ValueError(f"support {sup_true} beyond the serving cap {cap}")
    return b


@dataclasses.dataclass(frozen=True)
class ResizeOperands:
    """The scale-dependent geometry of dynamic-scale SR serving
    (``upscale_dynamic``) as data: per axis the left neighbour in a frame
    padded by a fixed ``pad`` and the float64 distances, two O(out) host
    passes a request; field for field ``lerf_tpu.ops.geometry.
    ResizeOperands``, whose program serves any scale at a shape pair.

    :meth:`create` is the upscale form (support 2, ±1 frame).
    :meth:`create_any` also serves antialiased downscales: the inflated
    support ``ceil(2 / min_scale)`` rounds up to a power-of-two bucket
    whose extra slots carry zero weight, the frame pad is ``bucket/2 + 1``
    and ``aa_scale`` is the kernel scale.  On the CPU the rings resize
    (``ops.resample.resize_rings``) reads these; on a card K1 takes the
    true support's rows, columns and distances from them
    (``kernels.resize.ResizeOperands.from_serving``)."""
    in_sz: tuple
    out_sz: tuple
    support: int         # serving support bucket (2 = upscale deploy form)
    idx_x: np.ndarray    # [outH] int32 left-neighbour row into ±pad plane
    idx_y: np.ndarray    # [outW] int32
    dis_x: np.ndarray    # [outH, S] float64
    dis_y: np.ndarray    # [outW, S] float64
    pad: int = 1         # fixed frame pad per side
    aa_scale: float = 1.0          # min(scale) when antialiasing, else 1
    wmask_x: np.ndarray = None     # [outH, S] float32 0/1 — AA only
    wmask_y: np.ndarray = None     # [outW, S]

    def rows(self, r0: int, r1: int) -> "ResizeOperands":
        """Output rows ``[r0, r1)`` alone (see :meth:`ResizeGeometry.rows`):
        the row axis's neighbours, distances and weight masks sliced."""
        _check_rows(r0, r1, self.out_sz[0])
        return dataclasses.replace(
            self, out_sz=(r1 - r0, self.out_sz[1]), idx_x=self.idx_x[r0:r1],
            dis_x=self.dis_x[r0:r1],
            wmask_x=None if self.wmask_x is None else self.wmask_x[r0:r1])

    @property
    def true_support(self) -> int:
        """The support the weights use: the bucket's active slots."""
        if self.wmask_x is None:
            return self.support
        return int(self.wmask_x[0].sum())

    @classmethod
    def create(cls, in_sz: Sequence[int], scale_factors=None, out_sz=None,
               support: int = 2):
        in_sz = tuple(int(s) for s in in_sz)
        scale, out = resolve_scale_and_out_sz(in_sz, scale_factors, out_sz)
        if support != 2:
            raise ValueError("dynamic resize serving is support-2 only")
        if scale[0] < 1.0 or scale[1] < 1.0:
            raise ValueError("dynamic resize serving is upscale-only "
                             "(anti-aliased downscale inflates support; "
                             "use create_any)")
        idx_x, dis_x = _resize_serving_axis(in_sz[0], out[0], scale[0],
                                            support)
        idx_y, dis_y = _resize_serving_axis(in_sz[1], out[1], scale[1],
                                            support)
        return cls(in_sz=in_sz, out_sz=out, support=support,
                   idx_x=idx_x, idx_y=idx_y, dis_x=dis_x, dis_y=dis_y)

    @classmethod
    def create_any(cls, in_sz: Sequence[int], scale_factors=None,
                   out_sz=None, support: int = 2, sup_cap: int = 64):
        """Any-scale operands: upscales through :meth:`create`; a downscale
        (or mixed) request through the antialiased support-bucket frame,
        the support inflated globally by the smaller axis scale
        (resize_right2d_numpy.py:52-55,186-193)."""
        in_sz = tuple(int(s) for s in in_sz)
        scale, out = resolve_scale_and_out_sz(in_sz, scale_factors, out_sz)
        if support != 2:
            raise ValueError("dynamic resize serving is support-2 only")
        if scale[0] >= 1.0 and scale[1] >= 1.0:
            # the resolved scale, not out / in: out is a ceil
            return cls.create(in_sz, scale_factors=list(scale), out_sz=out,
                              support=support)
        m = min(scale)
        sup_true = ceil(support / m)
        bucket = support_bucket(sup_true, floor=2 * support, cap=sup_cap)
        pad = bucket // 2 + 1
        idx_x, dis_x, wm_x = _resize_serving_axis_aa(
            in_sz[0], out[0], scale[0], sup_true, bucket, pad)
        idx_y, dis_y, wm_y = _resize_serving_axis_aa(
            in_sz[1], out[1], scale[1], sup_true, bucket, pad)
        return cls(in_sz=in_sz, out_sz=out, support=bucket,
                   idx_x=idx_x, idx_y=idx_y, dis_x=dis_x, dis_y=dis_y,
                   pad=pad, aa_scale=m, wmask_x=wm_x, wmask_y=wm_y)


def _warp_grid(matrix: np.ndarray, in_sz, out_sz):
    """Inverse-homography projected grid, float64.

    Parity: resize_right2d_numpy.py:306-342 — output pixel coords, flipped
    (h,w)->(x,y), multiplied by inv(matrix) with the homogeneous divide,
    flipped back and clipped to ``[0, in_sz]`` (inclusive upper bound
    ``in_sz``, not ``in_sz-1`` — reference line 338).  Each source
    coordinate is rank-1 in (column, row), so it is evaluated as 1-D outer
    sums.  Returns grid_x (row coordinate), grid_y (column coordinate),
    each [outH, outW].
    """
    oh, ow = out_sz
    inv = np.linalg.inv(np.asarray(matrix, dtype=np.float64))
    xs = np.arange(ow, dtype=np.float64)           # width coord, per column
    ys = np.arange(oh, dtype=np.float64)[:, None]  # height coord, per row
    den = (inv[2, 0] * xs + inv[2, 2]) + inv[2, 1] * ys
    src_x = ((inv[0, 0] * xs + inv[0, 2]) + inv[0, 1] * ys) / den
    src_y = ((inv[1, 0] * xs + inv[1, 2]) + inv[1, 1] * ys) / den
    grid_x = src_y.clip(0, in_sz[0])  # row coordinate
    grid_y = src_x.clip(0, in_sz[1])  # col coordinate
    return grid_x, grid_y


def _warp_axis(grid: np.ndarray, in_sz: int, support: int):
    """Field of view / pad / clipped indices / distances for one warp axis.

    Parity: resize_right2d_numpy.py:344-407, reproduced as-is.  The pads
    come from the CORNER entries ``fov[0,0,0]`` and ``fov[-1,-1,-1]`` and
    are clamped non-negative; the field of view is shifted by ``pad0`` and
    then clipped to the *unpadded* bounds ``[0, in_sz-1]``, so padded index
    0 is the pad row when ``pad0 = 1``, the last real row is then out of
    reach, and ``pad1`` is never read.  Out-of-view gathers land on in-range
    pixels and are suppressed by near-zero weights or the validity mask.
    """
    left = np.ceil(grid - support / 2.0 - _EPS).astype(np.int64)
    fov = left[..., None] + np.arange(support, dtype=np.int64)
    pad0 = int(max(-fov[0, 0, 0], 0))
    pad1 = int(max(fov[-1, -1, -1] - in_sz + 1, 0))
    fov = fov + pad0
    fov_clipped = fov.clip(0, in_sz - 1)
    dis = (grid[..., None] + pad0) - fov_clipped
    return fov_clipped.astype(np.int32), dis, (pad0, pad1)


def _inv_entries(inv):
    """The 3×3 inverse as nine Python floats (row-major lists): scalars a
    float64 tensor multiplies exactly, where a numpy scalar would not
    stay a tensor operand."""
    return [[float(v) for v in row]
            for row in np.asarray(inv, dtype=np.float64).reshape(3, 3)]


def _warp_grid_at(inv, ys: torch.Tensor, xs: torch.Tensor, in_sz):
    """:func:`_warp_grid`'s operation sequence at float64 output rows
    ``ys`` and columns ``xs`` (broadcast against each other), one IEEE
    float64 operation a step: the same values as the host grid there."""
    m = _inv_entries(inv)
    den = (m[2][0] * xs + m[2][2]) + m[2][1] * ys
    src_x = ((m[0][0] * xs + m[0][2]) + m[0][1] * ys) / den
    src_y = ((m[1][0] * xs + m[1][2]) + m[1][1] * ys) / den
    return src_y.clamp(0, in_sz[0]), src_x.clamp(0, in_sz[1])


def _warp_left(grid: torch.Tensor, support: int) -> torch.Tensor:
    """``_warp_axis``'s unpadded window start, int64."""
    return torch.ceil((grid - support / 2.0) - _EPS).to(torch.int64)


def warp_pads(inv, in_sz, out_sz, support: int = 2):
    """``(pad_x, pad_y)`` of :class:`WarpGeometry` from the inverse
    homography ``inv`` (``np.linalg.inv`` of the matrix, as
    :func:`_warp_grid` makes it) alone: ``_warp_axis`` reads its pads from
    the field of view at the two corner outputs, so the grid is evaluated
    there only, in the same operations."""
    oh, ow = (int(s) for s in out_sz)
    ys = torch.tensor([0.0, oh - 1.0], dtype=torch.float64)
    xs = torch.tensor([0.0, ow - 1.0], dtype=torch.float64)
    pads = []
    for grid, n in zip(_warp_grid_at(inv, ys, xs, in_sz), in_sz):
        first, last = (int(v) for v in _warp_left(grid, support))
        pads.append((max(-first, 0), max(last + support - int(n), 0)))
    return tuple(pads)


def window_corner(fov):
    """The window corner of a clipped field of view ``[..., S]`` (K5's
    per-axis left index in padded coordinates): from it, ``clip(corner +
    s, 0, in - 1)`` gives back the S clipped indices.  The first index
    where it is above 0, else the last one less ``S - 1`` (-1 for a
    support-2 pair clipped to (0, 0)).  Works on numpy arrays and
    tensors."""
    S = fov.shape[-1]
    return fov[..., 0] + (fov[..., 0] == 0) * (fov[..., -1] - (S - 1))


def warp_operands_plain(inv, in_sz, out_sz, support: int = 2):
    """The warp geometry K5 derives on the card, from the inverse
    homography alone, in torch float64 on the CPU: ``(corners, dis, masks,
    pad)`` laid out as ``kernels.warp.WarpOperands`` (int32 [oH·oW, 2]
    window corners (row, col) in padded coordinates (:func:`window_corner`),
    float32 [oH·oW, 2S] distances (dx_0..dx_S-1, dy_0..dy_S-1), uint8
    [oH·oW, 2S] linear branch bits of the float64 distances, the leading
    pads), equal to ``WarpOperands.create`` of the host
    :class:`WarpGeometry`.  Each step is the host's: the grid of
    :func:`_warp_grid`, then per axis ``ceil((g - S/2) - eps)``, ``+
    pad0``, the clip to ``[0, in - 1]``, ``(g + pad0) - fov``, cast to
    float32 once; the masks on the float64 distances."""
    oh, ow = (int(s) for s in out_sz)
    ys = torch.arange(oh, dtype=torch.float64)[:, None]
    xs = torch.arange(ow, dtype=torch.float64)
    grids = _warp_grid_at(inv, ys, xs, in_sz)
    pad = tuple(p0 for p0, _ in warp_pads(inv, in_sz, out_sz, support))
    corners, dis = [], []
    for grid, n, p0 in zip(grids, in_sz, pad):
        left = _warp_left(grid, support) + p0
        fov = torch.stack([(left + s).clamp(0, int(n) - 1)
                           for s in range(support)], -1)
        corners.append(window_corner(fov))
        dis.append((grid + p0)[..., None] - fov)
    dis64 = torch.cat(dis, -1).reshape(-1, 2 * support)
    neg = ((-1.0 <= dis64) & (dis64 < 0.0)).to(torch.uint8)
    pos = ((0.0 <= dis64) & (dis64 <= 1.0)).to(torch.uint8)
    return (torch.stack(corners, -1).reshape(-1, 2).to(torch.int32),
            dis64.to(torch.float32), neg | (pos << 1), pad)


def warp_mask_plain(inv, in_sz, out_sz, border: int = 4):
    """The validity mask K5 writes, from the inverse homography alone, in
    torch float64 on the CPU: bool [oH, oW], equal to
    ``resample.nearest_warp_mask_host`` (the support-1 box warp of the
    white frame whose ``border`` is zeroed).  On the grid of
    :func:`_warp_grid`, clipped to ``[0, in]``, ``ceil((g - 0.5) - eps)``
    is never negative, so the support-1 geometry's leading pads are 0, and
    the distance to the clipped index ``f = min(ceil((g - 0.5) - eps), in -
    1)`` lies in [-1, 1], where the box is 1.  So an output is inside where
    ``f`` lands on a white row and a white column, ``[border, in - 1 -
    border]``; a NaN coordinate (0/0 on the horizon) is outside."""
    oh, ow = (int(s) for s in out_sz)
    ys = torch.arange(oh, dtype=torch.float64)[:, None]
    xs = torch.arange(ow, dtype=torch.float64)
    mask = torch.ones((oh, ow), dtype=torch.bool)
    for grid, n in zip(_warp_grid_at(inv, ys, xs, in_sz), in_sz):
        f = _warp_left(grid, 1).clamp(max=int(n) - 1)
        mask &= ~torch.isnan(grid) & (f >= border) & (f <= int(n) - 1 - border)
    return mask


@dataclasses.dataclass(frozen=True)
class WarpGeometry:
    """Static geometry for one (in_shape, homography, out_shape) config;
    field for field ``lerf_tpu.ops.geometry.WarpGeometry``."""
    in_sz: tuple
    out_sz: tuple
    support: int
    fov_x: np.ndarray    # [outH, outW, S] int32 row candidates (clipped)
    fov_y: np.ndarray    # [outH, outW, S] int32 col candidates (clipped)
    lin_idx: np.ndarray  # [S, S, outH, outW] int32 flat indices into the
                         # padded image, support axes leading
    dis_x: np.ndarray    # [outH, outW, S] float64
    dis_y: np.ndarray    # [outH, outW, S] float64
    pad_x: tuple         # (top, bottom) >= 0
    pad_y: tuple         # (left, right) >= 0

    @property
    def padded_sz(self):
        return (self.in_sz[0] + self.pad_x[0] + self.pad_x[1],
                self.in_sz[1] + self.pad_y[0] + self.pad_y[1])

    @classmethod
    def create(cls, in_sz: Sequence[int], matrix, out_sz: Sequence[int],
               support: int = 2):
        in_sz = tuple(int(s) for s in in_sz)
        out_sz = tuple(int(s) for s in out_sz)
        grid_x, grid_y = _warp_grid(matrix, in_sz, out_sz)
        fov_x, dis_x, pad_x = _warp_axis(grid_x, in_sz[0], support)
        fov_y, dis_y, pad_y = _warp_axis(grid_y, in_sz[1], support)
        wp = in_sz[1] + pad_y[0] + pad_y[1]
        lin = (fov_x[:, :, :, None].astype(np.int64) * wp
               + fov_y[:, :, None, :].astype(np.int64))   # [oh, ow, S, S]
        lin = lin.transpose(2, 3, 0, 1)                    # [S, S, oh, ow]
        return cls(in_sz=in_sz, out_sz=out_sz, support=support,
                   fov_x=fov_x, fov_y=fov_y,
                   lin_idx=np.ascontiguousarray(lin).astype(np.int32),
                   dis_x=dis_x, dis_y=dis_y, pad_x=pad_x, pad_y=pad_y)

    def rows(self, r0: int, r1: int) -> "WarpGeometry":
        """Output rows ``[r0, r1)`` alone (see :meth:`ResizeGeometry.rows`):
        the per-pixel arrays' row axis sliced, the pads the whole
        output's."""
        _check_rows(r0, r1, self.out_sz[0])
        return dataclasses.replace(
            self, out_sz=(r1 - r0, self.out_sz[1]),
            fov_x=self.fov_x[r0:r1], fov_y=self.fov_y[r0:r1],
            lin_idx=np.ascontiguousarray(self.lin_idx[:, :, r0:r1]),
            dis_x=self.dis_x[r0:r1], dis_y=self.dis_y[r0:r1])



def _serving_axis(grid: np.ndarray, in_sz: int, support: int):
    """Per-axis operands for dynamic-homography serving
    (``lerf_tpu.ops.geometry._serving_axis``).

    Runs the exact ``_warp_axis`` math (same left/pad/clip/distance lines),
    then re-expresses the clipped gather over a FIXED ±1 pad: the reference
    gathers ``padded[clip(j, 0, in-1)]`` at ring position ``j`` of a plane
    padded by the matrix-dependent ``pad0`` (≤1 at support 2, since the
    projected grid is pre-clipped to ``[0, in]``); over a plane padded by
    exactly one row/col on each side the same value sits at index
    ``clip(j, 0, in-1) - pad0 + 1`` — for BOTH pad modes, because index 0
    is the zero row (constant pad / image) or the replicated first row
    (edge pad / hyper maps), exactly what ``pad0``-padding exposes.

    Returns ``(corner, ring, dis)``: the per-output-pixel corner ring
    position ``[oh, ow]``, the ring map ``[in+4]`` into the ±1-padded
    plane, and the float64 distances ``[oh, ow, S]`` (identical values to
    ``WarpGeometry.dis_*``).
    """
    # ``left`` stays float64: ceil output is integral, and the per-neighbor
    # offset/pad/clip arithmetic on small integers is exact in float64, so
    # the distances match the int64-materialized form bit-for-bit while
    # skipping the [oh, ow, S] int64 intermediates (host serving cost).
    left = np.ceil(grid - support / 2.0 - _EPS)
    pad0 = int(max(-int(left.flat[0]), 0))
    shifted = grid + pad0
    dis = np.empty(grid.shape + (support,), np.float64)
    tmp = np.empty_like(grid)
    for j in range(support):
        np.add(left, j + pad0, out=tmp)
        np.clip(tmp, 0, in_sz - 1, out=tmp)
        np.subtract(shifted, tmp, out=dis[..., j])
    corner = (left + (pad0 + 1)).astype(np.int64)  # ring pos of neighbor 0
    return corner, ring_map(in_sz, pad0), dis


@dataclasses.dataclass(frozen=True)
class WarpOperands:
    """The warp's geometry as data, for dynamic-homography serving
    (``lerf_tpu.ops.geometry.WarpOperands``): every matrix-dependent array
    has a shape fixed by ``(in_sz, out_sz)`` alone, from the host float64
    precompute of :class:`WarpGeometry` (the same lines; bit-equal
    distances).  A ring maps the ±1-padded planes' rows (columns): output
    n's neighbour (s, t) is row ``ring_x[corner[n] // (inW+3) + s]``,
    column ``ring_y[corner[n] % (inW+3) + t]`` there.  The rings warps
    (``ops.resample.warp_rings``, ``steering_gaussian_warp_rings``) and, on
    a card, K5's rings instance take them.

    Not ``ops.kernels.warp.WarpOperands``, K5's per-pixel check form of a
    :class:`WarpGeometry` (window corners in the geometry's padded
    coordinates, distances and branch bits, written by the card for the
    checks).  Support 2 only, as lerf_tpu's."""
    in_sz: tuple
    out_sz: tuple
    support: int         # always 2 — the deploy configuration
    ring_x: np.ndarray   # [inH+4] int32 row map into the ±1-padded planes
    ring_y: np.ndarray   # [inW+4] int32 col map
    corner: np.ndarray   # [N] int32 flat corner index, N = outH·outW
    dis_x: np.ndarray    # [N, S] float64 neighbor distances
    dis_y: np.ndarray    # [N, S] float64

    @classmethod
    def create(cls, in_sz: Sequence[int], matrix, out_sz: Sequence[int],
               support: int = 2):
        in_sz = tuple(int(s) for s in in_sz)
        out_sz = tuple(int(s) for s in out_sz)
        grid_x, grid_y = _warp_grid(matrix, in_sz, out_sz)
        return cls.from_grid(grid_x, grid_y, in_sz, out_sz, support)

    @classmethod
    def from_grid(cls, grid_x, grid_y, in_sz, out_sz, support: int = 2):
        """Build from a precomputed projection grid (``[oH, oW]`` row and
        column coordinates, any map, not only a homography's): the grid is
        the dominant host cost at large outputs, so serving callers compute
        it once and share it with the validity mask
        (``ops.resample.warp_serving_host``)."""
        if support != 2:
            raise ValueError("dynamic warp serving is support-2 only")
        cx, ring_x, dis_x = _serving_axis(grid_x, in_sz[0], support)
        cy, ring_y, dis_y = _serving_axis(grid_y, in_sz[1], support)
        n = out_sz[0] * out_sz[1]
        # packed-operand spatial shape is (inH+3, inW+3) — ring length - 1
        corner = cx.astype(np.int64) * (in_sz[1] + 3) + cy
        return cls(in_sz=tuple(in_sz), out_sz=tuple(out_sz), support=support,
                   ring_x=ring_x, ring_y=ring_y,
                   corner=corner.reshape(n).astype(np.int32),
                   dis_x=dis_x.reshape(n, support),
                   dis_y=dis_y.reshape(n, support))


def ring_map(in_n: int, pad0: int) -> np.ndarray:
    """:func:`_serving_axis`' ring map of an axis of ``in_n`` pixels whose
    support-2 leading pad is ``pad0``: [in_n + 4] int32 rows (columns) of
    the ±1-padded planes."""
    q = np.arange(in_n + 4, dtype=np.int64)
    return (np.clip(q - 1, 0, in_n - 1) - pad0 + 1).astype(np.int32)


def warp_rings_operands_plain(inv, in_sz, out_sz, device="cpu"):
    """The rings of the homography whose float64 inverse is ``inv``, from
    the inverse alone, in torch float64 on ``device``: ``(ring_x, ring_y,
    corner, dis_x, dis_y)`` laid out as :class:`WarpOperands` lays them
    out, the distances cast to float32 once (``ops.resample.warp_rings``),
    equal to ``WarpOperands.create``'s.  The plain twin of K5's
    ``lerf_warp_rings_geometry``.  Each step is :func:`_serving_axis`' on
    the grid of :func:`_warp_grid`: per axis ``left = ceil((g - 1) -
    eps)``, the leading pad ``pad0`` (:func:`warp_pads`), the corner's
    ring position ``left + pad0 + 1`` and the distances ``(g + pad0) -
    clip(left + pad0 + s, 0, in - 1)``."""
    oh, ow = (int(s) for s in out_sz)
    device = torch.device(device)
    ys = torch.arange(oh, dtype=torch.float64, device=device)[:, None]
    xs = torch.arange(ow, dtype=torch.float64, device=device)
    pads = [p0 for p0, _ in warp_pads(inv, in_sz, out_sz)]
    rings, pos, dis = [], [], []
    for grid, n, p0 in zip(_warp_grid_at(inv, ys, xs, in_sz), in_sz, pads):
        n = int(n)
        left = _warp_left(grid, 2) + p0
        rings.append(torch.from_numpy(ring_map(n, p0)).to(device))
        pos.append(left + 1)
        dis.append(torch.stack([(grid + p0) - (left + s).clamp(0, n - 1)
                                for s in (0, 1)], -1)
                   .reshape(-1, 2).to(torch.float32))
    corner = (pos[0] * (int(in_sz[1]) + 3) + pos[1]).reshape(-1) \
        .to(torch.int32)
    return rings[0], rings[1], corner, dis[0], dis[1]
