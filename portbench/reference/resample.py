"""The steerable-Gaussian resize and warp of the plain reference.

LeRF-G's resampler (``resize_right2d_numpy.py``: ``sk_weight`` at lines
150-160, the resize at 162-231, the warp at 496-577): every output pixel
is the normalised sum, over its S×S source window, of the source value
times ``exp(-1/2 ((σx dx)² - 2ρ (σx dx)(σy dy) + (σy dy)²))``, with the
hyper parameters of the *source* pixel (ρ = 2u - 1, σ = u · max_sigma from
maps ``u`` in [0, 1]) and the float64 distances cast to the weights' type.
The frame pads with zeros, the maps repeat their edge.  The blocks sum
s-major, t-minor; the warp flushes weights below float32's smallest
normal (a window whose weights all vanish is 0/0, then 0).  The uint8
frame is the sum rounded half to even and clipped to 0..255.

``dtype`` is the weights' and sums' type: float32, as the configurations
state, or bfloat16 for the control.
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import resize_axis, warp_axis, warp_grid

F32_TINY = float(np.finfo(np.float32).tiny)


def divide(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` as an IEEE division on any device (a CUDA division by a
    Python number multiplies by its reciprocal)."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def decode(maps, max_sigma: float, dtype):
    """Maps ``(ρ, σx, σy)`` in [0, 1] → ρ in [-1, 1] and σ in [0,
    max_sigma], in ``dtype``."""
    ms = float(torch.tensor(float(max_sigma), dtype=torch.float64).to(dtype))
    rho, sx, sy = (m.to(dtype) for m in maps)
    return rho * 2.0 - 1.0, sx * ms, sy * ms


def weight(rho, sx, sy, dx, dy):
    xn = (sx * dx) ** 2
    yn = (sy * dy) ** 2
    xy = sx * dx * sy * dy
    return torch.exp(-0.5 * (xn - 2.0 * rho * xy + yn))


def _edge(n: int, p0: int, p1: int, device):
    return torch.arange(-p0, n + p1, device=device).clamp_(0, n - 1)


def _pad(x, px, py, edge: bool):
    """Pad the last two axes by ``px`` (rows) and ``py`` (columns)."""
    h, w = x.shape[-2:]
    if edge:
        return (x.index_select(-2, _edge(h, *px, x.device))
                .index_select(-1, _edge(w, *py, x.device)))
    return torch.nn.functional.pad(x, (py[0], py[1], px[0], px[1]))


def to_u8(out: torch.Tensor, nan_to_zero: bool = False) -> torch.Tensor:
    if nan_to_zero:
        out = torch.nan_to_num(out, nan=0.0)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def resize(feat, maps, scale: float, *, max_sigma: float = 10.0,
           support: int = 2, dtype=torch.float32) -> torch.Tensor:
    """Feature [C, H, W] and maps (ρ, σx, σy) [C, H, W] → uint8 [C, oH,
    oW] at ``scale`` (an upscale) on both axes."""
    dev = feat.device
    (fx, dx, px), (fy, dy, py) = (resize_axis(n, scale, support)
                                  for n in feat.shape[-2:])
    if min(px + py) < 0:
        raise ValueError("the reference resize takes upscales only")
    xp = _pad(feat.to(dtype), px, py, edge=False)
    hyp = [_pad(m, px, py, edge=True) for m in decode(maps, max_sigma, dtype)]
    fov_x, fov_y = (torch.from_numpy(f).to(dev) for f in (fx, fy))
    dis_x, dis_y = (torch.from_numpy(d).to(dev, dtype) for d in (dx, dy))
    wn = ws = None
    for s in range(support):
        for t in range(support):
            def at(a):
                return (a.index_select(-2, fov_x[:, s])
                        .index_select(-1, fov_y[:, t]))
            w = weight(*(at(h) for h in hyp), dis_x[:, s, None],
                       dis_y[None, :, t])
            n = at(xp)
            wn = w * n if wn is None else wn + w * n
            ws = w if ws is None else ws + w
    return to_u8(wn / ws)


def warp(feat, maps, matrix, out_hw, *, max_sigma: float = 10.0,
         support: int = 2, dtype=torch.float32) -> torch.Tensor:
    """Feature [C, H, W] and maps (ρ, σx, σy) [C, H, W] warped by the
    homography ``matrix`` (input → output pixel coordinates, x the
    column) → uint8 [C, oH, oW]."""
    dev = feat.device
    c, h, w = feat.shape
    oh, ow = out_hw
    gx, gy = warp_grid(matrix, (h, w), out_hw, dev)
    fx, dx, px = warp_axis(gx, h, support)
    fy, dy, py = warp_axis(gy, w, support)
    wp = w + py[0] + py[1]
    xp = _pad(feat.to(dtype), px, py, edge=False).reshape(c, -1)
    hyp = [_pad(m, px, py, edge=True).reshape(c, -1)
           for m in decode(maps, max_sigma, dtype)]
    wn = ws = None
    for s in range(support):
        for t in range(support):
            idx = (fx[..., s] * wp + fy[..., t]).reshape(-1)
            dxs = dx[..., s].reshape(-1).to(dtype)
            dys = dy[..., t].reshape(-1).to(dtype)
            wt = weight(*(m.index_select(1, idx) for m in hyp), dxs, dys)
            wt = torch.where(wt < F32_TINY, torch.zeros_like(wt), wt)
            n = xp.index_select(1, idx)
            wn = wt * n if wn is None else wn + wt * n
            ws = wt if ws is None else ws + wt
    return to_u8((wn / ws).reshape(c, oh, ow), nan_to_zero=True)
