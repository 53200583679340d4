"""Resize and warp geometry of the plain reference, in float64.

Written from the LeRF reference resampler (``resize_right2d_numpy.py``:
the resize's projected grid, field of view and pads at lines 57-104, the
warp's at lines 306-407) and its validity mask (``eval_lut_warp.py``:
the nearest warp of a white frame whose 4-pixel border is black).  It
imports nothing of the program: the benchmark derives every index and
distance again from the scale or the homography alone: the resize's per
axis in numpy, the warp's per output pixel in torch on the device (each
step one IEEE float64 operation, so the same values on any device).
"""
from __future__ import annotations

from math import ceil

import numpy as np
import torch

EPS = float(np.finfo(np.float32).eps)


def resize_axis(in_n: int, scale: float, support: int = 2):
    """One axis of an upscale: ``(fov [out, S] int64 into the padded
    axis, dis [out, S] float64, (pad0, pad1))``."""
    out_n = ceil(scale * in_n)
    grid = (np.arange(out_n, dtype=np.float64) / scale
            + (in_n - 1) / 2.0 - (out_n - 1) / (2.0 * scale))
    left = np.ceil(grid - support / 2.0 - EPS).astype(np.int64)
    fov = left[:, None] + np.arange(support, dtype=np.int64)[None, :]
    pad0 = int(-fov[0, 0])
    pad1 = int(fov[-1, -1] - in_n + 1)
    fov = fov + pad0
    dis = (grid[:, None] + pad0) - fov
    return fov, dis, (pad0, pad1)


def warp_grid(matrix, in_hw, out_hw, device):
    """The inverse homography's source coordinates of every output pixel,
    clipped to ``[0, in]``: ``(rows, cols)``, float64 ``[oH, oW]`` on
    ``device`` (one IEEE operation a step, as the host's numpy)."""
    oh, ow = out_hw
    m = [[float(v) for v in row] for row in
         np.linalg.inv(np.asarray(matrix, dtype=np.float64))]
    xs = torch.arange(ow, dtype=torch.float64, device=device)
    ys = torch.arange(oh, dtype=torch.float64, device=device)[:, None]
    den = (m[2][0] * xs + m[2][2]) + m[2][1] * ys
    src_x = ((m[0][0] * xs + m[0][2]) + m[0][1] * ys) / den
    src_y = ((m[1][0] * xs + m[1][2]) + m[1][1] * ys) / den
    return src_y.clamp(0, in_hw[0]), src_x.clamp(0, in_hw[1])


def warp_axis(grid, in_n: int, support: int = 2):
    """One warp axis: ``(fov [oH, oW, S] int64, clipped to the unpadded
    axis, dis float64, (pad0, pad1))``; the pads come from the corner
    outputs, as the reference reads them."""
    left = torch.ceil(grid - support / 2.0 - EPS)
    fov = left[..., None] + torch.arange(support, dtype=grid.dtype,
                                         device=grid.device)
    pad0 = int(max(-fov[0, 0, 0].item(), 0))
    pad1 = int(max(fov[-1, -1, -1].item() - in_n + 1, 0))
    fov = (fov + pad0).clamp(0, in_n - 1)
    dis = (grid[..., None] + pad0) - fov
    return fov.to(torch.int64), dis, (pad0, pad1)


def warp_mask(matrix, in_hw, out_hw, border: int = 4, device="cpu"):
    """The validity mask: the nearest (support-1 box) warp of an all-255
    frame whose ``border`` is 0, kept where it reads 255.  bool [oH, oW]
    on ``device``."""
    keep = None
    for grid, n in zip(warp_grid(matrix, in_hw, out_hw, device), in_hw):
        fov, dis, _ = warp_axis(grid, n, 1)
        f, d = fov[..., 0], dis[..., 0]
        inside = ((-1.0 <= d) & (d <= 1.0) & (f >= border)
                  & (f <= n - 1 - border))
        keep = inside if keep is None else keep & inside
    return keep
