"""Steerable-Gaussian resize, plain twin of kernel K1.

The port of the Gaussian resize of ``lerf_tpu/ops/resample.py``
(reference: ``SteeringGaussianResize2dNumpy.resize``,
``resize_right/resize_right2d_numpy.py:162-223``).  Images are
``[..., C, H, W]`` float tensors; the hyper maps share the image's spatial
shape and live on *source* pixels (they are gathered per neighbour).

The plain form gathers the S×S neighbours through the host field of view
(``ResizeGeometry.fov_x`` / ``fov_y``) one (s, t) support block at a time
and sums s-major, t-minor — the order of the JAX path's
``_per_block_reduce`` / ``_block_sums`` and of the K1 kernel.  Works on
any device; the K1 wrapper (:mod:`lerf_torch.ops.kernels.resize`) uses it
for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import ResizeGeometry
from .lut_pipeline import edge_index, split_gaussian_hyper


def pad2d(x: torch.Tensor, pad_x, pad_y, mode: str = "constant"):
    """Pad the trailing two dims; negative pads crop (reference resize pads
    may be negative for downscaling — resize_right2d_numpy.py:101)."""
    (t, b), (l, r) = pad_x, pad_y
    ct, cb = max(-t, 0), max(-b, 0)
    cl, cr = max(-l, 0), max(-r, 0)
    if ct or cb or cl or cr:
        H, W = x.shape[-2], x.shape[-1]
        x = x[..., ct:H - cb, cl:W - cr]
    t, b, l, r = max(t, 0), max(b, 0), max(l, 0), max(r, 0)
    if not (t or b or l or r):
        return x
    if mode in ("edge", "replicate"):
        rows = edge_index(x.shape[-2], t, b, x.device)
        cols = edge_index(x.shape[-1], l, r, x.device)
        return x.index_select(-2, rows).index_select(-1, cols)
    return F.pad(x, (l, r, t, b))


def steering_gaussian_weight(rho, sigma_x, sigma_y, dx, dy):
    """exp(-1/2 ((σx dx)² - 2ρ(σx dx)(σy dy) + (σy dy)²)).

    Parity: ``sk_weight`` (resize_right2d_numpy.py:150-160).  Hyper inputs
    here are already decoded (ρ∈[-1,1], σ∈[0,max_sigma]).
    """
    xn = (sigma_x * dx) ** 2
    yn = (sigma_y * dy) ** 2
    xy = sigma_x * dx * sigma_y * dy
    return torch.exp(-0.5 * (xn - 2.0 * rho * xy + yn))


def decode_gaussian_hyper(rho, sigma_x, sigma_y, max_sigma: float):
    """Map network outputs in [0,1] to ρ∈[-1,1], σ∈[0,max_sigma]
    (resize_right2d_numpy.py:168-170)."""
    return rho * 2.0 - 1.0, sigma_x * max_sigma, sigma_y * max_sigma


def steering_gaussian_resize(img, rho, sigma_x, sigma_y,
                             geom: ResizeGeometry, *, max_sigma: float = 10.0,
                             pad_mode: str = "constant"):
    """LeRF core op: spatially-varying anisotropic-Gaussian resize.

    img: [..., C, H, W] float; rho/sigma_x/sigma_y: [..., C, H, W] in [0,1].
    Returns [..., C, outH, outW].  The image pads with ``pad_mode``, the
    hyper maps with edge replication (resample.py:319-321 of the JAX path).
    """
    rho, sigma_x, sigma_y = decode_gaussian_hyper(rho, sigma_x, sigma_y,
                                                  max_sigma)
    dev, dt = img.device, img.dtype
    xp = pad2d(img, geom.pad_x, geom.pad_y, pad_mode)
    hyp = [pad2d(h, geom.pad_x, geom.pad_y, "edge")
           for h in (rho, sigma_x, sigma_y)]
    fov_x = torch.from_numpy(geom.fov_x.astype(np.int64)).to(dev)
    fov_y = torch.from_numpy(geom.fov_y.astype(np.int64)).to(dev)
    # float64 host distances cast to the image dtype, as the JAX path does
    dis_x = torch.from_numpy(geom.dis_x).to(dev, dt)
    dis_y = torch.from_numpy(geom.dis_y).to(dev, dt)
    m = float(np.float32(geom.min_scale))
    wn = ws = None
    for s in range(geom.support):
        for t in range(geom.support):
            def at(a):
                return (a.index_select(-2, fov_x[:, s])
                        .index_select(-1, fov_y[:, t]))

            dx = dis_x[:, s, None]
            dy = dis_y[None, :, t]
            hy = [at(h) for h in hyp]
            if geom.antialias:
                w = m * steering_gaussian_weight(*hy, m * dx, m * dy)
            else:
                w = steering_gaussian_weight(*hy, dx, dy)
            n = at(xp)
            wn = w * n if wn is None else wn + w * n
            ws = w if ws is None else ws + w
    return wn / ws


def steering_resize_codes_plain(feat: torch.Tensor, codes: torch.Tensor,
                                geom: ResizeGeometry, *,
                                max_sigma: float = 10.0, norm: int = 255):
    """The main path's resize from the stage outputs: int32 feature
    [C, H, W] and int32 hyper codes [C, H, W, 3] → float32 [C, oH, oW].
    The plain twin K1 is held to."""
    rho, sx, sy = split_gaussian_hyper(codes, norm)
    return steering_gaussian_resize(feat.to(torch.float32), rho, sx, sy,
                                    geom, max_sigma=max_sigma)


def quantize_device(out: torch.Tensor, norm: int):
    """Round (half to even, as ``jnp.round``) / clip / cast to uint8 on the
    tensor's device when the range allows it: the plain form of K1's uint8
    epilogue."""
    if norm <= 255:
        return torch.clamp(torch.round(out), 0, norm).to(torch.uint8)
    return out
