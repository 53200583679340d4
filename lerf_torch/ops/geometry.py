"""Host-side resize geometry precompute (numpy float64).

A copy of the resize part of ``lerf_tpu/ops/geometry.py``: the projected
grid, field of view, pads and neighbour distances of the reference
precompute (``resize_right/resize_right2d_numpy.py:18-104``), computed
once per (in_shape, scale) on the host in float64 and stored per axis as
``[out, support]`` arrays (the resize field of view is separable).  The
device kernels receive these arrays cast to int32 / float32, exactly as
the JAX path casts them.
"""
from __future__ import annotations

import dataclasses
from math import ceil
from typing import Sequence

import numpy as np

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
