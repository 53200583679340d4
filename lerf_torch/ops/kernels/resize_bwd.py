"""K6 wrapper: the steerable resize's backward, the training step's.

``steering_resize_grad`` gives ∂L/∂feature and ∂L/∂hyper of K1's float
mode from ∂L/∂out.  It runs the plain twin
(:func:`lerf_torch.ops.resample.steering_resize_grad_plain`, the gradient
written out) for CPU tensors and launches ``csrc/steering_resize_bwd.cu``
for CUDA tensors; it never falls back from the card to the plain version.
``launches`` counts its calls on the card, each one launch of the kernel's
two passes (a thread an output, then a thread a source pixel).

:class:`GradOperands` carries K1's operands of the geometry and, for the
second pass, the per-axis inverse field of view (:func:`inverse_fov`),
built on the host once per geometry.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import geometry as geo
from ..resample import steering_resize_grad_plain
from . import _build
from .resize import ResizeOperands

launches = 0


def inverse_fov(rows: np.ndarray):
    """The inverse of a monotone field of view ``rows [O, S]`` (``rows[i,
    s] = rows[i, 0] + s``, ``rows[:, 0]`` non-decreasing): for every
    virtual source row r from ``rows.min()`` to ``rows.max()``, the range
    ``[lo, hi)`` of outputs i whose window holds r, as int32 ``[n, 2]``,
    and ``rows.min()``."""
    left, S = rows[:, 0], rows.shape[1]
    r = np.arange(rows.min(), rows.max() + 1)
    lo = np.searchsorted(left, r - S + 1, side="left")
    hi = np.searchsorted(left, r, side="right")
    return np.stack([lo, hi], -1).astype(np.int32), int(rows.min())


class GradOperands(NamedTuple):
    """One training geometry on the device, in one mode: K1's operands
    (``fwd``: rows, cols, distances, masks, tile) and the inverse lists of
    rows and columns (:func:`inverse_fov`) with their first virtual row
    and column."""
    fwd: ResizeOperands
    inv_rows: torch.Tensor     # [n_r, 2] int32
    inv_cols: torch.Tensor     # [n_c, 2] int32
    r_min: int
    c_min: int

    @classmethod
    def create(cls, geom: geo.ResizeGeometry, device, linear: bool = False):
        fwd = ResizeOperands.create(geom, device, linear=linear)
        inv_r, r_min = inverse_fov(fwd.rows.cpu().numpy())
        inv_c, c_min = inverse_fov(fwd.cols.cpu().numpy())
        return cls(fwd=fwd, inv_rows=torch.from_numpy(inv_r).to(device),
                   inv_cols=torch.from_numpy(inv_c).to(device),
                   r_min=r_min, c_min=c_min)


def _check(feat, hyper, grad_out, linear):
    C, H, W = feat.shape
    oc = 1 if linear else 3
    if (feat.dtype != torch.float32 or hyper.dtype != torch.float32
            or grad_out.dtype != torch.float32
            or hyper.shape != (C, H, W, oc) or grad_out.ndim != 3
            or grad_out.shape[0] != C
            or not feat.device == hyper.device == grad_out.device):
        raise ValueError(
            f"steering_resize_grad: float32 feat [C,H,W], hyper [C,H,W,{oc}] "
            f"({'linear' if linear else 'Gaussian'} mode) and grad_out "
            "[C,OH,OW] on one device")


def steering_resize_grad(feat: torch.Tensor, hyper: torch.Tensor,
                         grad_out: torch.Tensor,
                         geom: Optional[geo.ResizeGeometry] = None, *,
                         max_sigma: float = 10.0, linear: bool = False,
                         operands: Optional[GradOperands] = None):
    """∂L/∂feat [C, H, W] and ∂L/∂hyper [C, H, W, 3] (or [C, H, W, 1],
    ``linear``) of K1's float-mode resize of ``feat`` with ``hyper`` (maps
    in [0, 1]) on ``geom``, from ``grad_out`` [C, OH, OW].  ``operands``:
    the geometry already on the card (:meth:`GradOperands.create`), made
    from ``geom`` when not given."""
    _check(feat, hyper, grad_out, linear)
    if feat.device.type == "cpu":
        return steering_resize_grad_plain(feat, hyper, grad_out, geom,
                                          max_sigma=max_sigma, linear=linear)
    if feat.device.type != "cuda":
        raise ValueError("steering_resize_grad: unsupported device "
                         f"{feat.device}")
    if operands is None:
        operands = GradOperands.create(geom, feat.device, linear=linear)
    return _launch(feat, hyper, grad_out, operands, max_sigma=max_sigma,
                   linear=linear)


def _launch(feat, hyper, grad_out, operands: GradOperands, *, max_sigma,
            linear):
    global launches
    ops = operands.fwd
    C, H, W = feat.shape
    OH, OW = ops.out_sz
    if ops.in_sz != (H, W) or tuple(grad_out.shape[1:]) != (OH, OW):
        raise ValueError(f"geometry is for {ops.in_sz} -> {ops.out_sz}, "
                         f"tensors are {(H, W)} -> "
                         f"{tuple(grad_out.shape[1:])}")
    if ops.rows.device != feat.device or ops.linear != linear:
        raise ValueError("steering_resize_grad: operands made for another "
                         "device or the other mode")
    feat, hyper = feat.contiguous(), hyper.contiguous()
    grad_out = grad_out.contiguous()
    p_buf = torch.empty_like(grad_out)
    q_buf = torch.empty_like(grad_out)
    g_feat = torch.empty_like(feat)
    g_hyper = torch.empty_like(hyper)
    dis = (ops.lin_x, ops.lin_y) if linear else (ops.dis_x, ops.dis_y)
    masks = ((ops.mask_x.data_ptr(), ops.mask_y.data_ptr()) if linear
             else (None, None))
    lib = _build.library()
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lerf_steering_resize_bwd(
            feat.data_ptr(), hyper.data_ptr(), grad_out.data_ptr(),
            p_buf.data_ptr(), q_buf.data_ptr(), g_feat.data_ptr(),
            g_hyper.data_ptr(), ops.rows.data_ptr(), ops.cols.data_ptr(),
            dis[0].data_ptr(), dis[1].data_ptr(), *masks,
            operands.inv_rows.data_ptr(), operands.inv_cols.data_ptr(),
            operands.r_min, operands.inv_rows.shape[0], operands.c_min,
            operands.inv_cols.shape[0], C, H, W, OH, OW, ops.support,
            int(ops.antialias), int(linear), float(ops.min_scale),
            float(max_sigma), stream)
    _build.check(err, "steering_resize_grad launch")
    launches += 1
    return g_feat, g_hyper
