"""Steerable resize and warp, plain twins of kernels K1 and K5.

The port of the resize and static warp of ``lerf_tpu/ops/resample.py``
(reference: ``SteeringGaussianResize2dNumpy.resize``,
``AmplifiedLinearResize2dNumpy.resize`` and their warps,
``resize_right/resize_right2d_numpy.py:162-282,496-635``): the
steerable-Gaussian (LeRF-G) and amplified-linear (LeRF-L) weights, the
fixed-kernel resize and warp, the warp's validity mask (on the host, or
from the inverse alone: K5's on a card) and the dynamic-scale serving
("rings") resize.  Images are ``[..., C, H, W]`` float tensors; the hyper
maps share the image's spatial shape and live on *source* pixels (they are
gathered per neighbour).

The resize gathers the S×S neighbours through the host field of view
(``ResizeGeometry.fov_x`` / ``fov_y``) one (s, t) support block at a time
and sums s-major, t-minor — the order of the JAX path's
``_per_block_reduce`` / ``_block_sums`` and of the K1 kernel.  The warp
gathers through ``WarpGeometry.lin_idx`` in the same order, as the JAX
row-packed path and the K5 kernel do.  Works on any device; the K1 and K5
wrappers (:mod:`lerf_torch.ops.kernels.resize`, ``.warp``) use them for
CPU tensors.  :func:`steering_resize_grad_plain`, the resize's gradient
written out, is the twin of K6 (``kernels.resize_bwd``), the training
backward.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import interp_kernels
from .geometry import (ResizeGeometry, WarpGeometry, _warp_axis, _warp_grid,
                       warp_mask_plain)
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


def decode_linear_hyper(alpha, max_alpha: float = 1.0):
    """α = max_alpha·(2u-1)  (resize_right2d_numpy.py:249-250)."""
    return max_alpha * (alpha * 2.0 - 1.0)


def _branch_masks(dis64: np.ndarray, dtype=np.float32):
    """Host float64 branch masks of the piecewise-linear kernel: ``(-1 <= x)
    & (x < 0)`` and ``(0 <= x) & (x <= 1)``.

    The reference evaluates them in float64, and projected grids land
    within 1e-16 of the branch edges at integer scales, so they must be
    resolved on the float64 distances: casting to float32 first flips
    branches (``lerf_tpu/ops/resample.py:75-87``)."""
    neg = ((-1.0 <= dis64) & (dis64 < 0.0)).astype(dtype)
    pos = ((0.0 <= dis64) & (dis64 <= 1.0)).astype(dtype)
    return neg, pos


def branch_bits(dis64: np.ndarray) -> np.ndarray:
    """:func:`_branch_masks` packed as the kernels take them: uint8, bit 0
    the negative branch, bit 1 the positive one (at most one is set)."""
    neg, pos = _branch_masks(dis64, np.uint8)
    return neg | (pos << 1)


def _masks_on(dis64: np.ndarray, device):
    """:func:`_branch_masks` of ``dis64`` as float32 tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device)
                 for m in _branch_masks(dis64))


def amplified_linear_weight(alpha, dx, dy, masks_x, masks_y):
    """Slope-modulated triangle kernel, negative lobes clipped:
    ``max(lin(α, dx), 0) · max(lin(α, dy), 0)`` with ``lin(α, x) = (α·x +
    1)·neg + (1 − α·x)·pos`` on the host float64 branch masks.

    Parity: ``linear_alpha`` / ``linear_weight``
    (resize_right2d_numpy.py:233-241)."""
    def lin(a, x, masks):
        neg, pos = masks
        return (a * x + 1) * neg + (1 - a * x) * pos
    return (torch.clamp(lin(alpha, dx, masks_x), min=0)
            * torch.clamp(lin(alpha, dy, masks_y), min=0))


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
    hyp = [pad2d(h, geom.pad_x, geom.pad_y, "edge")
           for h in (rho, sigma_x, sigma_y)]
    # float64 host distances cast to the image dtype, as the JAX path does
    dis_x = torch.from_numpy(geom.dis_x).to(dev, dt)
    dis_y = torch.from_numpy(geom.dis_y).to(dev, dt)
    m = float(np.float32(geom.min_scale))

    def weight(s, t, at):
        dx = dis_x[:, s, None]
        dy = dis_y[None, :, t]
        hy = [at(h) for h in hyp]
        if geom.antialias:
            return m * steering_gaussian_weight(*hy, m * dx, m * dy)
        return steering_gaussian_weight(*hy, dx, dy)

    return _resize_sums(pad2d(img, geom.pad_x, geom.pad_y, pad_mode), geom,
                        weight)


def _resize_sums(xp: torch.Tensor, geom: ResizeGeometry, weight_fn,
                 normalize: bool = True):
    """Σ w·n / Σ w over the S×S support blocks of the padded image ``xp``,
    s-major, t-minor (the order of the JAX path's ``_per_block_reduce`` /
    ``_block_sums`` and of K1).  ``weight_fn(s, t, at)`` gives block (s,
    t)'s weights, ``at(a)`` gathering a padded plane at the block."""
    fov_x = torch.from_numpy(geom.fov_x.astype(np.int64)).to(xp.device)
    fov_y = torch.from_numpy(geom.fov_y.astype(np.int64)).to(xp.device)
    wn = ws = None
    for s in range(geom.support):
        for t in range(geom.support):
            def at(a):
                return (a.index_select(-2, fov_x[:, s])
                        .index_select(-1, fov_y[:, t]))

            w = weight_fn(s, t, at)
            n = at(xp)
            wn = w * n if wn is None else wn + w * n
            ws = w if ws is None else ws + w
    return wn / ws if normalize else wn


def steering_resize_codes_plain(feat: torch.Tensor, codes: torch.Tensor,
                                geom: ResizeGeometry, *,
                                max_sigma: float = 10.0, norm: int = 255):
    """The main path's resize from the stage outputs: int32 feature
    [C, H, W] and int32 hyper codes [C, H, W, 3] → float32 [C, oH, oW].
    The plain twin K1 is held to."""
    rho, sx, sy = split_gaussian_hyper(codes, norm)
    return steering_gaussian_resize(feat.to(torch.float32), rho, sx, sy,
                                    geom, max_sigma=max_sigma)


def amplified_linear_resize(img, alpha, geom: ResizeGeometry, *,
                            max_alpha: float = 1.0,
                            pad_mode: str = "constant"):
    """LeRF-L op: amplified-linear resize
    (``AmplifiedLinearResize2dNumpy.resize``, resize_right2d_numpy.py:243-282;
    ``lerf_tpu.ops.resample.amplified_linear_resize``).

    img: [..., C, H, W] float; alpha: [..., C, H, W] in [0,1].  On an
    antialiased downscale the distances scale by ``min_scale`` in float64
    on the host — the branch masks are taken from those — and the weight by
    ``float32(min_scale)`` after the product."""
    alpha = decode_linear_hyper(alpha, max_alpha)
    dev, dt = img.device, img.dtype
    m64 = geom.min_scale if geom.antialias else 1.0
    ap = pad2d(alpha, geom.pad_x, geom.pad_y, "edge")
    dx64, dy64 = m64 * geom.dis_x, m64 * geom.dis_y
    dx = torch.from_numpy(dx64).to(dev, dt)
    dy = torch.from_numpy(dy64).to(dev, dt)
    (nx, px), (ny, py) = _masks_on(dx64, dev), _masks_on(dy64, dev)
    m = float(np.float32(geom.min_scale))

    def weight(s, t, at):
        w = amplified_linear_weight(
            at(ap), dx[:, s, None], dy[None, :, t],
            (nx[:, s, None], px[:, s, None]), (ny[None, :, t], py[None, :, t]))
        return m * w if geom.antialias else w

    return _resize_sums(pad2d(img, geom.pad_x, geom.pad_y, pad_mode), geom,
                        weight)


def linear_resize_codes_plain(feat: torch.Tensor, codes: torch.Tensor,
                              geom: ResizeGeometry, *, norm: int = 255):
    """The LeRF-L resize from the stage outputs: int32 feature [C, H, W]
    and int32 codes [C, H, W, 1] → float32 [C, oH, oW], α decoded from
    ``code / norm`` (exact division, as K1 divides) at the deploy forms'
    ``max_alpha`` 1.  The plain twin of K1's linear mode."""
    alpha = divide_exact(codes[..., 0].to(torch.float32), norm)
    return amplified_linear_resize(feat.to(torch.float32), alpha, geom)


def pad2d_adjoint(g: torch.Tensor, pad_x, pad_y, in_hw,
                  mode: str = "constant"):
    """The adjoint of :func:`pad2d`: the gradient of a padded plane ``g``
    carried back to the plane of size ``in_hw`` it was padded from.  A
    constant pad sends nothing back from the pad; an edge pad adds each
    padded position into the border pixel it copies; a crop (negative pad)
    gets zeros."""
    (t, b), (l, r) = pad_x, pad_y
    H, W = in_hw
    ct, cb, cl, cr = max(-t, 0), max(-b, 0), max(-l, 0), max(-r, 0)
    h, w = H - ct - cb, W - cl - cr
    t, b, l, r = max(t, 0), max(b, 0), max(l, 0), max(r, 0)
    if mode in ("edge", "replicate"):
        rows = edge_index(h, t, b, g.device)
        cols = edge_index(w, l, r, g.device)
        g = g.new_zeros(g.shape[:-1] + (w,)).index_add_(-1, cols, g)
        g = g.new_zeros(g.shape[:-2] + (h, w)).index_add_(-2, rows, g)
    else:
        g = g[..., t:t + h, l:l + w]
    return F.pad(g, (cl, cr, ct, cb)) if ct or cb or cl or cr else g


def _gaussian_weight_grads(rho, sx, sy, dx, dy, m: Optional[float]):
    """The Gaussian weight of one support block and its partials in the
    decoded (ρ, σx, σy): with a = σx·dx, b = σy·dy, ∂w/∂ρ = w·a·b, ∂w/∂σx =
    w·dx·(ρb − a), ∂w/∂σy = w·dy·(ρa − b).  ``m``: the antialias scale
    (distances and weight times m), else None."""
    if m is not None:
        dx, dy = m * dx, m * dy
    w = steering_gaussian_weight(rho, sx, sy, dx, dy)
    if m is not None:
        w = m * w
    a, b = sx * dx, sy * dy
    return w, (w * a * b, w * dx * (rho * b - a), w * dy * (rho * a - b))


def _linear_weight_grads(alpha, dx, dy, masks_x, masks_y, m: Optional[float]):
    """The amplified-linear weight of one block and its partial in the
    decoded α: ``max(lin_x, 0)·max(lin_y, 0)`` with ∂lin/∂α = x on the
    negative branch, −x on the positive one; ``torch.clamp``'s convention,
    the gradient passing at lin = 0 (``jnp.clip`` would halve it there)."""
    def lin(x, masks):
        neg, pos = masks
        return (alpha * x + 1) * neg + (1 - alpha * x) * pos, x * neg - x * pos

    lx, gx = lin(dx, masks_x)
    ly, gy = lin(dy, masks_y)
    cx, cy = torch.clamp(lx, min=0), torch.clamp(ly, min=0)
    w = cx * cy
    dw = gx * (lx >= 0) * cy + cx * gy * (ly >= 0)
    if m is not None:
        w, dw = m * w, m * dw
    return w, (dw,)


def steering_resize_grad_plain(feat, hyper, grad_out, geom: ResizeGeometry, *,
                               max_sigma: float = 10.0, linear: bool = False):
    """The gradient of :func:`steering_gaussian_resize` (or, ``linear``,
    :func:`amplified_linear_resize`) written out: the twin K6 is held to.

    ``feat`` [..., C, H, W] float, ``hyper`` [..., C, H, W, 3] (ρ, σx, σy)
    or [..., C, H, W, 1] (α), maps in [0, 1]; ``grad_out`` ∂L/∂out
    [..., C, OH, OW].  Returns (∂L/∂feat, ∂L/∂hyper) in those shapes.

    With out_o = Σ_k w_ok f_k / W_o, W_o = Σ_k w_ok, a first pass gives
    P_o = g_o / W_o and Q_o = P_o·out_o; then ∂L/∂f_k = Σ_o P_o w_ok and
    ∂L/∂θ_k = Σ_o (P_o f_k − Q_o)·∂w_ok/∂θ_k, scattered back through the
    field of view block by block and through the pads' adjoints (the image
    pads with zeros: a padded position sends no feature gradient; the hyper
    maps pad with edge copies: a padded position's hyper gradient goes to
    its border pixel), then through the decode (×2 for ρ and α, ×max_sigma
    for σ)."""
    dev, dt = feat.device, feat.dtype
    in_hw = tuple(feat.shape[-2:])
    fov_x = torch.from_numpy(geom.fov_x.astype(np.int64)).to(dev)
    fov_y = torch.from_numpy(geom.fov_y.astype(np.int64)).to(dev)
    m = float(np.float32(geom.min_scale)) if geom.antialias else None
    fp = pad2d(feat, geom.pad_x, geom.pad_y)
    if linear:
        planes = [decode_linear_hyper(hyper[..., 0])]
        m64 = geom.min_scale if geom.antialias else 1.0
        dx64, dy64 = m64 * geom.dis_x, m64 * geom.dis_y
        dis = (torch.from_numpy(dx64).to(dev, dt),
               torch.from_numpy(dy64).to(dev, dt))
        (nx, px), (ny, py) = _masks_on(dx64, dev), _masks_on(dy64, dev)

        def weight(s, t, hp):
            return _linear_weight_grads(
                hp[0], dis[0][:, s, None], dis[1][None, :, t],
                (nx[:, s, None], px[:, s, None]),
                (ny[None, :, t], py[None, :, t]), m)
        chain = (2.0,)
    else:
        planes = list(decode_gaussian_hyper(hyper[..., 0], hyper[..., 1],
                                            hyper[..., 2], max_sigma))
        dis = (torch.from_numpy(geom.dis_x).to(dev, dt),
               torch.from_numpy(geom.dis_y).to(dev, dt))

        def weight(s, t, hp):
            return _gaussian_weight_grads(*hp, dis[0][:, s, None],
                                          dis[1][None, :, t], m)
        chain = (2.0, float(max_sigma), float(max_sigma))
    hps = [pad2d(h, geom.pad_x, geom.pad_y, "edge") for h in planes]
    blocks = [(s, t) for s in range(geom.support)
              for t in range(geom.support)]

    def at(a, s, t):
        return a.index_select(-2, fov_x[:, s]).index_select(-1, fov_y[:, t])

    def scatter(acc, v, s, t):
        rows = v.new_zeros(v.shape[:-1] + (acc.shape[-1],)) \
            .index_add_(-1, fov_y[:, t], v)
        acc.index_add_(-2, fov_x[:, s], rows)

    wn = ws = 0
    for s, t in blocks:
        w, _ = weight(s, t, [at(h, s, t) for h in hps])
        wn = wn + w * at(fp, s, t)
        ws = ws + w
    p = grad_out / ws
    q = p * (wn / ws)
    g_fp = torch.zeros_like(fp)
    g_hps = [torch.zeros_like(h) for h in hps]
    for s, t in blocks:
        w, dws = weight(s, t, [at(h, s, t) for h in hps])
        scatter(g_fp, p * w, s, t)
        coef = p * at(fp, s, t) - q
        for g_h, dw in zip(g_hps, dws):
            scatter(g_h, coef * dw, s, t)
    g_feat = pad2d_adjoint(g_fp, geom.pad_x, geom.pad_y, in_hw)
    g_hyper = torch.stack(
        [c * pad2d_adjoint(g, geom.pad_x, geom.pad_y, in_hw, "edge")
         for c, g in zip(chain, g_hps)], -1)
    return g_feat, g_hyper


def fixed_kernel_resize(img, geom: ResizeGeometry, kernel: str = "cubic", *,
                        pad_mode: str = "constant", normalize: bool = True):
    """Fixed-kernel resize (bicubic / linear / box / lanczos2/3) with host
    float64 weights (``lerf_tpu.ops.resample.fixed_kernel_resize``; the
    reference's generic ``Resize2dNumpy.resize``).  Build the geometry with
    the kernel's ``support_sz`` (4 for cubic).  On an antialiased
    downscale the kernel is evaluated at ``min_scale``-scaled distances and
    the row weights scaled by ``min_scale``, as the reference does."""
    kern1d = interp_kernels.NP_KERNELS_1D[kernel]
    m64 = geom.min_scale if geom.antialias else 1.0
    wx = kern1d(m64 * geom.dis_x)                      # host float64
    wy = kern1d(m64 * geom.dis_y)
    if geom.antialias:
        wx = m64 * wx
    wx = torch.from_numpy(np.ascontiguousarray(wx)).to(img.device, img.dtype)
    wy = torch.from_numpy(np.ascontiguousarray(wy)).to(img.device, img.dtype)
    return _resize_sums(
        pad2d(img, geom.pad_x, geom.pad_y, pad_mode), geom,
        lambda s, t, at: wx[:, s, None] * wy[None, :, t],
        normalize=normalize and geom.support != 1)


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


def amplified_linear_warp(img, alpha, geom: WarpGeometry, *,
                          max_alpha: float = 1.0,
                          pad_mode: str = "constant",
                          u8_inputs: bool = False):
    """Amplified-linear homographic warp
    (``AmplifiedLinearWarp2dNumpy.warp``, resize_right2d_numpy.py:579-635;
    ``lerf_tpu.ops.resample.amplified_linear_warp``).

    Support-2 [C,H,W] inputs sum the four neighbour blocks in the order
    (0,0), (0,1), (1,0), (1,1) with the host float64 branch masks of each
    block's distances, as the JAX row-packed path does (batched [B,C,H,W]
    inputs run it per frame); other supports take the generic element
    gather.  ``u8_inputs`` as in :func:`steering_gaussian_warp`.  A window
    whose weights all clip to 0 is 0/0 = NaN."""
    if geom.support == 2 and img.ndim == 4:
        return torch.stack([
            amplified_linear_warp(i, a, geom, max_alpha=max_alpha,
                                  pad_mode=pad_mode, u8_inputs=u8_inputs)
            for i, a in zip(img, alpha)])
    if geom.support == 2 and img.ndim == 3:
        if u8_inputs:
            img_u8 = img if not torch.is_floating_point(img) \
                else torch.round(img)
            planes = [pad2d(img_u8.to(torch.uint8), geom.pad_x, geom.pad_y,
                            pad_mode),
                      pad2d(_encode_u8(alpha), geom.pad_x, geom.pad_y,
                            "edge")]
        else:
            planes = [pad2d(img, geom.pad_x, geom.pad_y, pad_mode),
                      pad2d(decode_linear_hyper(alpha, max_alpha),
                            geom.pad_x, geom.pad_y, "edge")]
        dev = img.device
        C = img.shape[0]
        flat = [p.reshape(C, -1) for p in planes]
        lin = torch.from_numpy(geom.lin_idx.reshape(2, 2, -1)
                               .astype(np.int64)).to(dev)
        dx, dy = _warp_dis_flat(
            geom, torch.float32 if u8_inputs else img.dtype, dev)
        wn = ws = None
        for s, t in ((0, 0), (0, 1), (1, 0), (1, 1)):
            x, a = (p.index_select(1, lin[s, t]) for p in flat)
            if u8_inputs:
                x = x.to(torch.float32)
                a = decode_linear_hyper(
                    divide_exact(a.to(torch.float32), 255), max_alpha)
            mx = _masks_on(geom.dis_x[..., s].reshape(-1), dev)
            my = _masks_on(geom.dis_y[..., t].reshape(-1), dev)
            w = amplified_linear_weight(a, dx[s], dy[t], mx, my)
            wn = w * x if wn is None else wn + w * x
            ws = w if ws is None else ws + w
        return (wn / ws).reshape(C, *geom.out_sz)
    if u8_inputs:
        # generic path: integer codes 0..255 → [0,1] before the decode
        img = img.to(torch.float32)
        alpha = _u8_to_unit(alpha)
    alpha = decode_linear_hyper(alpha, max_alpha)
    f_alpha = _gather_warp(alpha, geom, "edge")
    dx64 = geom.dis_x.transpose(2, 0, 1)[:, None]      # [S,1,oh,ow]
    dy64 = geom.dis_y.transpose(2, 0, 1)[None, :]      # [1,S,oh,ow]
    dx = torch.from_numpy(np.ascontiguousarray(dx64)).to(img.device, img.dtype)
    dy = torch.from_numpy(np.ascontiguousarray(dy64)).to(img.device, img.dtype)
    weights = amplified_linear_weight(f_alpha, dx, dy,
                                      _masks_on(dx64, img.device),
                                      _masks_on(dy64, img.device))
    neighbors = _gather_warp(img, geom, pad_mode)
    return _reduce_support_warp(weights, neighbors)


def _warp_codes(feat, codes, geom: WarpGeometry, weight_fn):
    """Σ w·x / Σ w of the warp from the stage outputs, any support: the
    S×S neighbour blocks gathered through ``geom.lin_idx`` in s-major,
    t-minor order (for support 2 the JAX row-packed path's (0,0), (0,1),
    (1,0), (1,1)), the feature constant-padded and the codes edge-padded.
    ``weight_fn(s, t, c)`` gives block (s, t)'s weights from its gathered
    int32 codes ``c`` [C, oC, N]."""
    C = feat.shape[0]
    S = geom.support
    xp = pad2d(feat, geom.pad_x, geom.pad_y, "constant").reshape(C, -1)
    cp = pad2d(codes.permute(0, 3, 1, 2), geom.pad_x, geom.pad_y, "edge") \
        .reshape(C, codes.shape[-1], -1)
    lin = torch.from_numpy(geom.lin_idx.reshape(S, S, -1)
                           .astype(np.int64)).to(feat.device)
    wn = ws = None
    for s in range(S):
        for t in range(S):
            x = xp.index_select(1, lin[s, t]).to(torch.float32)
            w = weight_fn(s, t, cp.index_select(2, lin[s, t]))
            wn = w * x if wn is None else wn + w * x
            ws = w if ws is None else ws + w
    return (wn / ws).reshape(C, *geom.out_sz)


def steering_warp_codes_plain(feat: torch.Tensor, codes: torch.Tensor,
                              geom: WarpGeometry, *, max_sigma: float = 10.0,
                              norm: int = 255):
    """The main path's warp from the stage outputs: int32 feature [C, H, W]
    and int32 hyper codes [C, H, W, 3] → float32 [C, oH, oW], any support.
    The plain twin K5 is held to: the u8-input order of
    :func:`steering_gaussian_warp` (gather the integers, then decode
    ``code / norm``), for any ``norm``, and weights flushed below 2^-126.

    The division is :func:`~lerf_torch.ops.lut_pipeline.divide_exact`'s
    IEEE division on every device, as in the kernel: far from the image an
    ulp of a decoded σ moves a tiny weight enough to show."""
    dx, dy = _warp_dis_flat(geom, torch.float32, feat.device)

    def weight(s, t, c):
        u = divide_exact(c.to(torch.float32), norm)
        r, sx, sy = decode_gaussian_hyper(u[:, 0], u[:, 1], u[:, 2],
                                          max_sigma)
        return flush_subnormal(steering_gaussian_weight(r, sx, sy, dx[s],
                                                        dy[t]))

    return _warp_codes(feat, codes, geom, weight)


def linear_warp_codes_plain(feat: torch.Tensor, codes: torch.Tensor,
                            geom: WarpGeometry, *, norm: int = 255):
    """The LeRF-L warp from the stage outputs: int32 feature [C, H, W] and
    int32 codes [C, H, W, 1] → float32 [C, oH, oW], any support, α decoded
    from ``code / norm`` after the gather (``max_alpha`` 1), the branch
    masks from the host float64 distances.  The plain twin of K5's linear
    mode."""
    dev = feat.device
    dx, dy = _warp_dis_flat(geom, torch.float32, dev)
    mx = [_masks_on(geom.dis_x[..., s].reshape(-1), dev)
          for s in range(geom.support)]
    my = [_masks_on(geom.dis_y[..., t].reshape(-1), dev)
          for t in range(geom.support)]

    def weight(s, t, c):
        a = decode_linear_hyper(divide_exact(c[:, 0].to(torch.float32), norm))
        return amplified_linear_weight(a, dx[s], dy[t], mx[s], my[t])

    return _warp_codes(feat, codes, geom, weight)


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


def nearest_warp_mask_on_device(inv, in_sz, out_sz, border: int = 4):
    """The validity mask from the inverse homography ``inv`` (float64
    [3, 3], a tensor or an array) alone, where it lies
    (``lerf_tpu.ops.resample.nearest_warp_mask_on_device``): for a CUDA
    tensor K5's mask, computed on the card from the float64 grid
    (``kernels.warp.warp_mask``); otherwise its plain twin
    (:func:`~lerf_torch.ops.geometry.warp_mask_plain`).  Both equal
    :func:`nearest_warp_mask_host`: lerf_tpu's in-program mask is float32
    and does not.  Returns bool [outH, outW] on ``inv``'s device."""
    in_sz = tuple(int(v) for v in in_sz)
    out_sz = tuple(int(v) for v in out_sz)
    device = inv.device if isinstance(inv, torch.Tensor) \
        else torch.device("cpu")
    inv64 = np.asarray(inv.cpu() if isinstance(inv, torch.Tensor) else inv,
                       dtype=np.float64).reshape(3, 3)
    if device.type == "cuda":
        from .kernels.warp import WarpParams, warp_mask

        # support 1: the geometry's pads are 0 (warp_mask_plain says why)
        params = WarpParams(
            matrix=tuple(map(float, np.linalg.inv(inv64).ravel())),
            inv=tuple(map(float, inv64.ravel())), pad=(0, 0), in_sz=in_sz,
            out_sz=out_sz, support=1)
        return warp_mask(params, device, border)
    return warp_mask_plain(inv64, in_sz, out_sz, border)


# ---------------------------------------------------------------------------
# dynamic-scale serving: the resize geometry as data ("rings")
# ---------------------------------------------------------------------------


class ResizeRings(NamedTuple):
    """The serving geometry (:class:`~lerf_torch.ops.geometry.ResizeOperands`)
    as the plain rings resize takes it, with the linear kernel's host
    float64 branch masks (``lerf_tpu.ops.resample.ResizeRings``).  Numpy
    leaves; per axis O(out) values, so one set serves any scale."""
    idx_x: np.ndarray            # [outH] int32 — left row into the ±pad plane
    idx_y: np.ndarray            # [outW] int32
    dis_x: np.ndarray            # [outH, S] weight dtype
    dis_y: np.ndarray            # [outW, S]
    masks_x: Optional[tuple] = None   # (neg, pos) [outH, S] — linear only
    masks_y: Optional[tuple] = None
    # anti-aliased (downscale) envelope only (ResizeOperands.create_any):
    aa: Optional[np.ndarray] = None        # 0-d weight-dtype min(scale)
    wmask_x: Optional[np.ndarray] = None   # [outH, S] 0/1 — Gaussian form
    wmask_y: Optional[np.ndarray] = None


def resize_rings(operands, *, linear: bool = False, dtype=np.float32):
    """``ResizeOperands`` → :class:`ResizeRings`, everything float64-
    sensitive resolved on the host as the static path resolves it
    (``lerf_tpu.ops.resample.resize_rings``): the distances cast once; the
    LINEAR form's anti-aliased distances scaled by ``min_scale`` in float64
    first and its branch masks taken from those; the GAUSSIAN form's
    unscaled, the ``min_scale`` multiply left to the weight dtype, with the
    support bucket's weight masks."""
    aa = operands.aa_scale < 1.0
    dis_x, dis_y = operands.dis_x, operands.dis_y
    if linear and aa:
        dis_x = operands.aa_scale * dis_x       # float64, like the static m64
        dis_y = operands.aa_scale * dis_y
    return ResizeRings(
        operands.idx_x, operands.idx_y, dis_x.astype(dtype),
        dis_y.astype(dtype),
        _branch_masks(dis_x) if linear else None,
        _branch_masks(dis_y) if linear else None,
        aa=np.asarray(operands.aa_scale, dtype) if aa else None,
        wmask_x=None if (linear or not aa) else operands.wmask_x,
        wmask_y=None if (linear or not aa) else operands.wmask_y)


def _rings_sums(xp: torch.Tensor, rings: ResizeRings, weight_fn):
    """Σ w·n / Σ w over the support slots of ``rings`` on the plane ``xp``
    padded by the operands' fixed frame, s-major, t-minor: block (s, t)
    gathers rows ``idx_x + s`` and columns ``idx_y + t``, as
    :func:`_resize_sums` gathers the static field of view, so the two do
    the same operations on the same values.  Indices clip into the plane,
    as lerf_tpu's ``jnp.take(mode="clip")``: an AA support bucket's
    inactive slots (zero weight) may point past it, and adding their zeros
    changes no sum.  ``weight_fn(s, t, at)`` as for :func:`_resize_sums`."""
    S = rings.dis_x.shape[1]

    def index(idx, s, n):
        return torch.from_numpy(np.clip(idx.astype(np.int64) + s, 0, n - 1)) \
            .to(xp.device)

    rows = [index(rings.idx_x, s, xp.shape[-2]) for s in range(S)]
    cols = [index(rings.idx_y, t, xp.shape[-1]) for t in range(S)]
    wn = ws = None
    for s in range(S):
        for t in range(S):
            def at(a):
                return a.index_select(-2, rows[s]).index_select(-1, cols[t])

            w = weight_fn(s, t, at)
            n = at(xp)
            wn = w * n if wn is None else wn + w * n
            ws = w if ws is None else ws + w
    return wn / ws


def _frame(a, pad: int, mode: str):
    return pad2d(a, (pad, pad), (pad, pad), mode)


def steering_gaussian_resize_rings(img, rho, sigma_x, sigma_y,
                                   rings: ResizeRings, *,
                                   max_sigma: float = 10.0,
                                   pad_mode: str = "constant", pad: int = 1):
    """Dynamic-scale steering resize, bit-equal to
    :func:`steering_gaussian_resize` at the same scale
    (``lerf_tpu.ops.resample.steering_gaussian_resize_rings``): the image
    padded by the operands' fixed frame ``pad`` on each side, the geometry
    from ``rings``.  On the anti-aliased form ``rings.aa`` is the kernel
    scale and ``rings.wmask_*`` zero the support bucket's inactive slots
    (1.0 on the true ones: exact)."""
    dev, dt = img.device, img.dtype
    hyp = [_frame(h, pad, "edge") for h in decode_gaussian_hyper(
        rho, sigma_x, sigma_y, max_sigma)]
    dx = torch.from_numpy(rings.dis_x).to(dev, dt)
    dy = torch.from_numpy(rings.dis_y).to(dev, dt)
    if rings.aa is not None:
        m = float(rings.aa)
        wx = torch.from_numpy(rings.wmask_x).to(dev, dt)
        wy = torch.from_numpy(rings.wmask_y).to(dev, dt)

    def weight(s, t, at):
        hy = [at(h) for h in hyp]
        if rings.aa is None:
            return steering_gaussian_weight(*hy, dx[:, s, None],
                                            dy[None, :, t])
        return m * (steering_gaussian_weight(*hy, m * dx[:, s, None],
                                             m * dy[None, :, t])
                    * wx[:, s, None] * wy[None, :, t])

    return _rings_sums(_frame(img, pad, pad_mode), rings, weight)


def amplified_linear_resize_rings(img, alpha, rings: ResizeRings, *,
                                  max_alpha: float = 1.0,
                                  pad_mode: str = "constant", pad: int = 1):
    """Dynamic-scale amplified-linear resize, bit-equal to
    :func:`amplified_linear_resize` at the same scale
    (``lerf_tpu.ops.resample.amplified_linear_resize_rings``): ``rings``
    built with ``linear=True`` (the masks ride along; on the anti-aliased
    form the distances arrive scaled and the masks zero the bucket's
    inactive slots, so only the outer ``min_scale`` multiply remains)."""
    dev, dt = img.device, img.dtype
    ap = _frame(decode_linear_hyper(alpha, max_alpha), pad, "edge")
    dx = torch.from_numpy(rings.dis_x).to(dev, dt)
    dy = torch.from_numpy(rings.dis_y).to(dev, dt)
    nx, px = (torch.from_numpy(m).to(dev) for m in rings.masks_x)
    ny, py = (torch.from_numpy(m).to(dev) for m in rings.masks_y)

    def weight(s, t, at):
        w = amplified_linear_weight(
            at(ap), dx[:, s, None], dy[None, :, t],
            (nx[:, s, None], px[:, s, None]), (ny[None, :, t], py[None, :, t]))
        return w if rings.aa is None else float(rings.aa) * w

    return _rings_sums(_frame(img, pad, pad_mode), rings, weight)


def resize_codes_rings_plain(feat: torch.Tensor, codes: torch.Tensor,
                             rings: ResizeRings, *, linear: bool = False,
                             max_sigma: float = 10.0, norm: int = 255,
                             pad: int = 1):
    """The serving resize from the stage outputs (int32 feature [C, H, W],
    int32 codes [C, H, W, oC]) through ``rings``: the plain form of
    ``LutPredictor.upscale_dynamic``'s resize, codes decoded as
    ``code / norm`` (exact division)."""
    featf = feat.to(torch.float32)
    if linear:
        alpha = divide_exact(codes[..., 0].to(torch.float32), norm)
        return amplified_linear_resize_rings(featf, alpha, rings, pad=pad)
    rho, sx, sy = split_gaussian_hyper(codes, norm)
    return steering_gaussian_resize_rings(featf, rho, sx, sy, rings,
                                          max_sigma=max_sigma, pad=pad)
