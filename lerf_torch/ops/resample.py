"""Steerable-Gaussian resize and warp, plain twins of kernels K1 and K5.

The port of the Gaussian resize and static warp of
``lerf_tpu/ops/resample.py`` (reference:
``SteeringGaussianResize2dNumpy.resize`` and
``SteeringGaussianWarp2dNumpy.warp``,
``resize_right/resize_right2d_numpy.py:162-223,496-577``), the
fixed-kernel warp and the warp's validity mask.  Images are
``[..., C, H, W]`` float tensors; the hyper maps share the image's spatial
shape and live on *source* pixels (they are gathered per neighbour).

The resize gathers the S×S neighbours through the host field of view
(``ResizeGeometry.fov_x`` / ``fov_y``) one (s, t) support block at a time
and sums s-major, t-minor — the order of the JAX path's
``_per_block_reduce`` / ``_block_sums`` and of the K1 kernel.  The warp
gathers through ``WarpGeometry.lin_idx`` in the same order, as the JAX
row-packed path and the K5 kernel do.  Works on any device; the K1 and K5
wrappers (:mod:`lerf_torch.ops.kernels.resize`, ``.warp``) use them for
CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import interp_kernels
from .geometry import ResizeGeometry, WarpGeometry, _warp_axis, _warp_grid
from .lut_pipeline import divide_exact, edge_index, split_gaussian_hyper


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


def quantize_device(out: torch.Tensor, norm: int, nan_to_zero: bool = False):
    """Round (half to even, as ``jnp.round``) / clip / cast to uint8 on the
    tensor's device when the range allows it: the plain form of K1's and
    K5's uint8 epilogues.  ``nan_to_zero`` (the warp's) first maps NaN to 0
    and ±inf to the largest finite floats, as ``jnp.nan_to_num``."""
    if nan_to_zero:
        out = torch.nan_to_num(out, nan=0.0)
    if norm <= 255:
        return torch.clamp(torch.round(out), 0, norm).to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# warping
# ---------------------------------------------------------------------------

_F32_TINY = float(np.finfo(np.float32).tiny)


def flush_subnormal(w: torch.Tensor) -> torch.Tensor:
    """Warp weights below float32's smallest normal become 0.

    The TPU has no subnormal floats (and XLA's CPU ``exp`` mostly returns
    0 below ``2^-126``), so a window whose four weights all fall below
    ``2^-126`` sums to 0/0 = NaN there (and to 0 after ``nan_to_zero``).
    PyTorch and CUDA keep subnormals; flushing the
    weight, the only subnormal the warp can make (a weight ≥ 2^-126 times
    a value of 1..255 stays normal), gives the same NaN pattern."""
    return torch.where(w < _F32_TINY, torch.zeros_like(w), w)


def _unclipped_corner(fov: np.ndarray) -> np.ndarray:
    """The unclipped top/left index of a stored clipped support-2 pair
    (the field of view is clipped into [0, in-1]; a pair is clipped iff its
    entries are equal: (0,0) ⇒ left was -1, (m,m) ⇒ left was m)."""
    f0 = fov[..., 0].astype(np.int64)
    f1 = fov[..., 1].astype(np.int64)
    return np.where(f1 == 0, -1, f0)


def _gather_warp(x: torch.Tensor, geom: WarpGeometry, mode: str):
    """Flat neighbour gather through ``geom.lin_idx`` → [..., S, S, outH,
    outW] (support leading), from ``x`` padded with ``mode``."""
    xp = pad2d(x, geom.pad_x, geom.pad_y, mode)
    lead = xp.shape[:-2]
    idx = torch.from_numpy(geom.lin_idx.reshape(-1).astype(np.int64)) \
        .to(x.device)
    out = xp.reshape(-1, xp.shape[-2] * xp.shape[-1]).index_select(1, idx)
    return out.reshape(lead + (geom.support, geom.support) + geom.out_sz)


def _reduce_support_warp(weights, neighbors, normalize: bool = True):
    """weights/neighbors: [..., S, S, outH, outW].  Zero-sum windows (fully
    out of view) produce NaN exactly like the reference; callers mask or
    zero them (eval_model.py:261)."""
    acc = torch.sum(weights * neighbors, dim=(-4, -3))
    if normalize:
        acc = acc / torch.sum(weights, dim=(-4, -3))
    return acc


def _warp_dis(geom: WarpGeometry, dtype, device):
    """dis [oh,ow,S] float64 → broadcastable [S,1,oh,ow] / [1,S,oh,ow]."""
    dx = torch.from_numpy(geom.dis_x.transpose(2, 0, 1).copy()) \
        .to(device, dtype)[:, None]
    dy = torch.from_numpy(geom.dis_y.transpose(2, 0, 1).copy()) \
        .to(device, dtype)[None, :]
    return dx, dy


def _warp_dis_flat(geom: WarpGeometry, dtype, device):
    """dis [oh,ow,S] float64 → per-support flat [N] columns, cast once."""
    dx = [torch.from_numpy(np.ascontiguousarray(geom.dis_x[..., s]).reshape(-1))
          .to(device, dtype) for s in range(geom.support)]
    dy = [torch.from_numpy(np.ascontiguousarray(geom.dis_y[..., t]).reshape(-1))
          .to(device, dtype) for t in range(geom.support)]
    return dx, dy


def _encode_u8(u: torch.Tensor) -> torch.Tensor:
    """[0,1] map whose values are exact multiples of 1/255 → uint8 codes
    (the ×255 product lands within 1 ulp of the code, so round() recovers
    it); integer inputs are taken as the codes themselves."""
    if not torch.is_floating_point(u):
        return u.to(torch.uint8)
    return torch.round(u * 255.0).to(torch.uint8)


def _u8_to_unit(p: torch.Tensor) -> torch.Tensor:
    """u8-exact hyper input → [0,1] float: integer codes divide by 255,
    floats are already unit-scaled (the inverse of :func:`_encode_u8`)."""
    if not torch.is_floating_point(p):
        return p.to(torch.float32) / 255.0
    return p


def steering_gaussian_warp(img, rho, sigma_x, sigma_y, geom: WarpGeometry, *,
                           max_sigma: float = 10.0,
                           pad_mode: str = "constant",
                           u8_inputs: bool = False):
    """Steerable-Gaussian homographic warp
    (``SteeringGaussianWarp2dNumpy.warp``, resize_right2d_numpy.py:496-577;
    ``lerf_tpu.ops.resample.steering_gaussian_warp``).

    Support-2 [C,H,W] inputs (the deploy configuration) sum the four
    neighbour blocks in the order (0,0), (0,1), (1,0), (1,1), one division
    at the end, as the JAX row-packed path does; batched [B,C,H,W] inputs
    run it per frame (one shared homography).  Other supports take the
    generic element gather.  ``u8_inputs=True``: ``img`` holds integers
    0..255 and the hyper maps are exact multiples of 1/255 (or integer
    codes); they are gathered as uint8 and decoded after the gather —
    the same values, since decode and padding commute with the gather.
    Weights are flushed below 2^-126 (:func:`flush_subnormal`).
    """
    if geom.support == 2 and img.ndim == 4:
        return torch.stack([
            steering_gaussian_warp(i, r, sx, sy, geom, max_sigma=max_sigma,
                                   pad_mode=pad_mode, u8_inputs=u8_inputs)
            for i, r, sx, sy in zip(img, rho, sigma_x, sigma_y)])
    if geom.support == 2 and img.ndim == 3:
        if u8_inputs:
            img_u8 = img if not torch.is_floating_point(img) \
                else torch.round(img)
            planes = [pad2d(img_u8.to(torch.uint8), geom.pad_x, geom.pad_y,
                            pad_mode)] + [
                pad2d(_encode_u8(p), geom.pad_x, geom.pad_y, "edge")
                for p in (rho, sigma_x, sigma_y)]
        else:
            r, sx, sy = decode_gaussian_hyper(rho, sigma_x, sigma_y,
                                              max_sigma)
            planes = [pad2d(img, geom.pad_x, geom.pad_y, pad_mode)] + [
                pad2d(p, geom.pad_x, geom.pad_y, "edge") for p in (r, sx, sy)]
        dev = img.device
        C = img.shape[0]
        flat = [p.reshape(C, -1) for p in planes]
        lin = torch.from_numpy(geom.lin_idx.reshape(2, 2, -1)
                               .astype(np.int64)).to(dev)
        dx, dy = _warp_dis_flat(
            geom, torch.float32 if u8_inputs else img.dtype, dev)
        wn = ws = None
        for s, t in ((0, 0), (0, 1), (1, 0), (1, 1)):
            x, r_, sx_, sy_ = (p.index_select(1, lin[s, t]) for p in flat)
            if u8_inputs:
                x = x.to(torch.float32)
                r_, sx_, sy_ = decode_gaussian_hyper(
                    r_.to(torch.float32) / 255.0,
                    sx_.to(torch.float32) / 255.0,
                    sy_.to(torch.float32) / 255.0, max_sigma)
            w = flush_subnormal(
                steering_gaussian_weight(r_, sx_, sy_, dx[s], dy[t]))
            wn = w * x if wn is None else wn + w * x
            ws = w if ws is None else ws + w
        return (wn / ws).reshape(C, *geom.out_sz)
    if u8_inputs:
        # generic path: hypers may be integer codes 0..255 (normalized
        # here) or already u8-exact [0,1] floats (left as they are)
        img = img.to(torch.float32)
        rho, sigma_x, sigma_y = (_u8_to_unit(p)
                                 for p in (rho, sigma_x, sigma_y))
    rho, sigma_x, sigma_y = decode_gaussian_hyper(rho, sigma_x, sigma_y,
                                                  max_sigma)
    f_rho = _gather_warp(rho, geom, "edge")
    f_sx = _gather_warp(sigma_x, geom, "edge")
    f_sy = _gather_warp(sigma_y, geom, "edge")
    dx, dy = _warp_dis(geom, img.dtype, img.device)
    weights = flush_subnormal(
        steering_gaussian_weight(f_rho, f_sx, f_sy, dx, dy))
    neighbors = _gather_warp(img, geom, pad_mode)
    return _reduce_support_warp(weights, neighbors)


def steering_warp_codes_plain(feat: torch.Tensor, codes: torch.Tensor,
                              geom: WarpGeometry, *, max_sigma: float = 10.0,
                              norm: int = 255):
    """The main path's warp from the stage outputs: int32 feature [C, H, W]
    and int32 hyper codes [C, H, W, 3] → float32 [C, oH, oW], support 2.
    The plain twin K5 is held to: the u8-input order of
    :func:`steering_gaussian_warp` (gather the integers, then decode
    ``code / norm``), for any ``norm``.

    The division is :func:`~lerf_torch.ops.lut_pipeline.divide_exact`'s
    IEEE division on every device, as in the kernel: far from the image an
    ulp of a decoded σ moves a tiny weight enough to show."""
    if geom.support != 2:
        raise ValueError("steering_warp_codes_plain: support 2 only")
    C = feat.shape[0]
    dev = feat.device
    xp = pad2d(feat, geom.pad_x, geom.pad_y, "constant").reshape(C, -1)
    cp = pad2d(codes.permute(0, 3, 1, 2), geom.pad_x, geom.pad_y, "edge") \
        .reshape(C, 3, -1)
    lin = torch.from_numpy(geom.lin_idx.reshape(2, 2, -1)
                           .astype(np.int64)).to(dev)
    dx, dy = _warp_dis_flat(geom, torch.float32, dev)
    wn = ws = None
    for s, t in ((0, 0), (0, 1), (1, 0), (1, 1)):
        x = xp.index_select(1, lin[s, t]).to(torch.float32)
        u = divide_exact(cp.index_select(2, lin[s, t]).to(torch.float32),
                           norm)
        r, sx, sy = decode_gaussian_hyper(u[:, 0], u[:, 1], u[:, 2],
                                          max_sigma)
        w = flush_subnormal(steering_gaussian_weight(r, sx, sy, dx[s], dy[t]))
        wn = w * x if wn is None else wn + w * x
        ws = w if ws is None else ws + w
    return (wn / ws).reshape(C, *geom.out_sz)


def fixed_kernel_warp(img, geom: WarpGeometry, kernel: str = "cubic", *,
                      pad_mode: str = "constant"):
    """Fixed-kernel warp (nearest/bilinear/bicubic/lanczos) with host
    float64 weights.  ``support == 1`` (nearest/box) skips normalization —
    the reference's generic ``warp`` (resize_right2d_numpy.py:409-449),
    which makes the 0/1 validity mask for mPSNR."""
    kern1d = interp_kernels.NP_KERNELS_1D[kernel]
    wx = kern1d(geom.dis_x.transpose(2, 0, 1))[:, None]   # host float64
    wy = kern1d(geom.dis_y.transpose(2, 0, 1))[None, :]
    weights = torch.from_numpy(np.ascontiguousarray(wx * wy)) \
        .to(img.device, img.dtype)                         # [S,S,oh,ow]
    neighbors = _gather_warp(img, geom, pad_mode)
    return _reduce_support_warp(weights, neighbors,
                                normalize=geom.support != 1)


def nearest_warp_mask(in_sz, geom: WarpGeometry, border: int = 4,
                      dtype=torch.float32):
    """Validity mask for warp mPSNR: nearest-warp (``geom`` of support 1)
    an all-255 image whose ``border``-px frame is zeroed, threshold at 255
    (eval_lut_warp.py:197-204).  Returns [outH, outW] 0/1 of ``dtype``."""
    h, w = in_sz
    white = np.zeros((1, h, w), dtype=np.float32)
    white[:, border:h - border, border:w - border] = 255.0
    warped = fixed_kernel_warp(torch.from_numpy(white), geom, "box")
    return (warped[0] == 255.0).to(dtype)


def _mask_from_grid(grid_x, grid_y, in_sz, border: int = 4):
    """Validity mask from a precomputed projection grid: the support-1 box
    warp of a border-zeroed all-255 image (``_warp_axis`` geometry, the
    lines of ``WarpGeometry.create``), float64 throughout — bit-equal to
    :func:`nearest_warp_mask` because every product is exact on {0, 255}."""
    h, w = in_sz
    fx, dx, px = _warp_axis(grid_x, h, 1)
    fy, dy, py = _warp_axis(grid_y, w, 1)
    white = np.zeros((h, w), dtype=np.float64)
    white[border:h - border, border:w - border] = 255.0
    wp = np.pad(white, (px, py))
    kern1d = interp_kernels.NP_KERNELS_1D["box"]
    weight = kern1d(dx[..., 0]) * kern1d(dy[..., 0])
    neigh = wp[fx[..., 0], fy[..., 0]]
    return (weight * neigh) == 255.0


def nearest_warp_mask_host(in_sz, matrix, out_sz, border: int = 4):
    """Host-numpy :func:`nearest_warp_mask`: [outH, outW] bool."""
    grid_x, grid_y = _warp_grid(matrix, in_sz, out_sz)
    return _mask_from_grid(grid_x, grid_y, in_sz, border)
