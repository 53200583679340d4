"""Host-side resize and warp geometry precompute (numpy float64).

A copy of the resize and static-warp parts of ``lerf_tpu/ops/geometry.py``:
the projected grid, field of view, pads and neighbour distances of the
reference precompute (``resize_right/resize_right2d_numpy.py:18-104`` for
resize, ``:306-407`` for warp), computed once per (in_shape, scale) or
(in_shape, homography, out_shape) on the host in float64.  The resize
field of view is separable and stored per axis as ``[out, support]``
arrays; the warp's is per output pixel, ``[outH, outW, support]``.  K1
receives its arrays cast to int32 / float32, exactly as the JAX path
casts them.  K5 derives the warp's on the card from the inverse matrix;
:func:`warp_pads` and :func:`warp_operands_plain` are that derivation's
plain twin, the same float64 operations in torch.
"""
from __future__ import annotations

import dataclasses
from math import ceil
from typing import Sequence

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


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


def warp_operands_plain(inv, in_sz, out_sz):
    """The support-2 warp geometry K5 derives on the card, from the inverse
    homography alone, in torch float64 on the CPU: ``(corners, dis, pad)``
    laid out as ``kernels.warp.WarpOperands`` (int32 [oH·oW, 2] unclipped
    window corners (row, col) in padded coordinates, float32 [oH·oW, 4]
    distances (dx0, dx1, dy0, dy1), the leading pads), and equal to
    ``WarpOperands.create`` of the host :class:`WarpGeometry`.  Each step is
    the host's: the grid of :func:`_warp_grid`, then per axis ``ceil((g -
    1) - eps)``, ``+ pad0``, the clip to ``[0, in - 1]``, ``(g + pad0) -
    fov``, cast to float32 once."""
    oh, ow = (int(s) for s in out_sz)
    ys = torch.arange(oh, dtype=torch.float64)[:, None]
    xs = torch.arange(ow, dtype=torch.float64)
    grids = _warp_grid_at(inv, ys, xs, in_sz)
    pad = tuple(p0 for p0, _ in warp_pads(inv, in_sz, out_sz))
    corners, dis = [], []
    for grid, n, p0 in zip(grids, in_sz, pad):
        left = _warp_left(grid, 2) + p0
        fov = [(left + s).clamp(0, int(n) - 1) for s in (0, 1)]
        corners.append(torch.where(fov[1] == 0, -1, fov[0]))
        shifted = grid + p0
        dis += [shifted - f for f in fov]
    return (torch.stack(corners, -1).reshape(-1, 2).to(torch.int32),
            torch.stack(dis, -1).reshape(-1, 4).to(torch.float32), pad)


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
