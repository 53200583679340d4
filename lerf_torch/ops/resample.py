"""Steerable resize and warp, plain twins of kernels K1 and K5.

The port of the resize and static warp of ``lerf_tpu/ops/resample.py``
(reference: ``SteeringGaussianResize2dNumpy.resize``,
``AmplifiedLinearResize2dNumpy.resize`` and their warps,
``resize_right/resize_right2d_numpy.py:162-282,496-635``): the
steerable-Gaussian (LeRF-G) and amplified-linear (LeRF-L) weights, the
fixed-kernel resize and warp, the warp's validity mask (on the host, or
from the inverse alone: K5's on a card), the dynamic-scale serving
("rings") resize and the dynamic-homography rings warp (the warp's
geometry as data: :class:`WarpRings`, their host precompute in numpy or
in C, :mod:`lerf_torch.native`, and K5's rings instance on a card).  Images are ``[..., C, H, W]`` float tensors; the hyper
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
from .geometry import (ResizeGeometry, WarpGeometry, WarpOperands,
                       _warp_axis, _warp_grid,
                       resolve_scale_and_out_sz, ring_map, warp_mask_plain,
                       warp_rings_operands_plain)
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


def in_type(v: float, dt) -> float:
    """``v`` rounded to the weights' type ``dt`` (through float32, as
    ``lerf_tpu``'s ``jnp.asarray(v, dtype)`` rounds it), as a Python
    number: PyTorch multiplies a bf16 tensor by a Python number without
    rounding the number to bf16 first, lerf_tpu by its bf16 value."""
    return float(torch.tensor(float(v), dtype=torch.float64).to(dt))


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
    (resize_right2d_numpy.py:168-170), ``max_sigma`` in the maps' type."""
    ms = in_type(max_sigma, sigma_x.dtype)
    return rho * 2.0 - 1.0, sigma_x * ms, sigma_y * ms


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
    m = in_type(geom.min_scale, dt)

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
    m = in_type(geom.min_scale, dt)

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
# dynamic-homography serving: the warp geometry as data ("rings")
# ---------------------------------------------------------------------------

# lerf_tpu's cap on the rational period of a resize's field of view, for
# its periodic-slab gather (``lerf_tpu/ops/resample.py:119``); K1 reads any
# field of view from its shared-memory window, so nothing here takes it
MAX_FOV_PERIOD = 32


class WarpRings(NamedTuple):
    """The warp's geometry as data (``lerf_tpu.ops.resample.WarpRings``):
    :class:`~lerf_torch.ops.geometry.WarpOperands`' rings, corner and
    distances (cast once to the weights' type), plus the linear kernel's
    host float64 branch masks.  Every shape is fixed by ``(in_sz,
    out_sz)``, so one warp serves every homography or grid at a shape
    pair.  Leaves are numpy arrays (the host's) or tensors
    (:func:`warp_rings_on_device`'s)."""
    ring_x: object               # [inH+4] int32
    ring_y: object               # [inW+4] int32
    corner: object               # [N] int32, N = outH·outW
    dis_x: object                # [N, S] weight dtype
    dis_y: object                # [N, S]
    masks_x: Optional[tuple] = None   # (neg [N,S], pos [N,S]) — linear only
    masks_y: Optional[tuple] = None


def warp_rings(operands: WarpOperands, *, linear: bool = False,
               dtype=np.float32) -> WarpRings:
    """``WarpOperands`` → :class:`WarpRings` with numpy leaves
    (``lerf_tpu.ops.resample.warp_rings``): the distances cast once to
    ``dtype`` as the static path casts them, and the amplified-linear
    branch masks, which must be evaluated in float64
    (:func:`_branch_masks`), taken from the float64 distances.  numpy has
    no bf16: ``dtype=torch.bfloat16`` gives the distances as bf16 tensors
    (rounded through float32, as lerf_tpu's ``astype(bfloat16)`` and the
    matrix warp's cast round them)."""
    mx = _branch_masks(operands.dis_x) if linear else None
    my = _branch_masks(operands.dis_y) if linear else None
    if isinstance(dtype, torch.dtype):
        dis = [torch.from_numpy(d).to(dtype)
               for d in (operands.dis_x, operands.dis_y)]
    else:
        dis = [d.astype(dtype) for d in (operands.dis_x, operands.dis_y)]
    return WarpRings(operands.ring_x, operands.ring_y, operands.corner,
                     *dis, mx, my)


def rings_dtype(rings) -> torch.dtype:
    """The type of the rings' distances, float32 or bf16: the rings warps
    compute their weights in it, as lerf_tpu's promote the maps against
    it (bf16 maps under float32 rings: float32 weights, sums and output)."""
    dt = getattr(rings, "dtype", None)       # DeviceRings keep theirs
    if dt is None:
        dt = torch.as_tensor(rings.dis_x[:0]).dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rings' distances of {dt}: float32 or bf16 only")
    return dt


def _leaf(a, device, dtype=None) -> torch.Tensor:
    """A rings leaf (numpy or tensor) as a tensor on ``device``."""
    return torch.as_tensor(a).to(device, dtype)


def pack_rings_operand(planes, rings: WarpRings) -> torch.Tensor:
    """Corner-indexed packed operand of the ring gather
    (``lerf_tpu.ops.resample.pack_rings_operand``): ``planes`` are the
    fixed ±1-padded ``[C, H+2, W+2]`` planes; the ring maps re-index them
    so that row m of the result holds all (s, t, plane, channel) values an
    output whose corner is m needs.  Returns ``[M, k]``, M = (inH+3)·(inW+3),
    k = 4·n_planes·C.  A ring value outside the planes clamps into them,
    as K5's rings instance clamps it."""
    h2, w2 = planes[0].shape[-2:]
    dev = planes[0].device
    rx = _leaf(rings.ring_x, dev, torch.int64).clamp(0, h2 - 1)
    ry = _leaf(rings.ring_y, dev, torch.int64).clamp(0, w2 - 1)
    remapped = [p.index_select(-2, rx).index_select(-1, ry) for p in planes]
    rh, rw = rx.shape[0], ry.shape[0]
    blocks = [p[..., s:s + rh - 1, t:t + rw - 1]
              for s in (0, 1) for t in (0, 1) for p in remapped]
    packed = torch.cat(blocks, 0)                     # [k, rh-1, rw-1]
    return packed.permute(1, 2, 0).reshape(-1, packed.shape[0])


def split_rings_rows(rows, n_planes: int, channels: int):
    """Gathered ``[N, k]`` rows → list over (s, t) of lists over planes of
    ``[N, C]`` views (``lerf_tpu.ops.resample.split_rings_rows``)."""
    out = []
    for b in range(4):                                # (s, t) blocks
        vals = []
        for v in range(n_planes):
            lane0 = (b * n_planes + v) * channels
            vals.append(rows[:, lane0:lane0 + channels])
        out.append(vals)
    return out


def _rowpack_warp_gather_rings(planes, rings: WarpRings):
    """The ring gather: the packed operand's row at each output's corner
    (clamped into the operand, as K5's rings instance clamps it), split
    into (s, t) blocks of planes."""
    packed = pack_rings_operand(planes, rings)
    corner = _leaf(rings.corner, packed.device, torch.int64) \
        .clamp(0, packed.shape[0] - 1)
    rows = packed.index_select(0, corner)             # [N, k]
    return split_rings_rows(rows, len(planes), planes[0].shape[0])


def gauss_rings_planes(img, rho, sigma_x, sigma_y, *, max_sigma: float,
                       u8_inputs: bool, pad_mode: str = "constant"):
    """The 4 fixed ±1-padded gather planes of the steering ring warp
    (image: ``pad_mode``; hyper maps: edge;
    ``lerf_tpu.ops.resample.gauss_rings_planes``): uint8 codes with
    ``u8_inputs``, else the decoded maps."""
    if u8_inputs:
        img_u8 = img if not torch.is_floating_point(img) else torch.round(img)
        return [pad2d(img_u8.to(torch.uint8), (1, 1), (1, 1), pad_mode)] + [
            pad2d(_encode_u8(p), (1, 1), (1, 1), "edge")
            for p in (rho, sigma_x, sigma_y)]
    r, sx, sy = decode_gaussian_hyper(rho, sigma_x, sigma_y, max_sigma)
    return [pad2d(img, (1, 1), (1, 1), pad_mode)] + [
        pad2d(p, (1, 1), (1, 1), "edge") for p in (r, sx, sy)]


def _rings_dis(rings: WarpRings, device):
    """The rings' distances on ``device`` in their own type
    (:func:`rings_dtype`): the weights follow it, as in lerf_tpu, where a
    bf16 map times float32 distances is a float32 product."""
    rings_dtype(rings)
    return _leaf(rings.dis_x, device), _leaf(rings.dis_y, device)


def gauss_rings_accumulate(gathered, dis_x, dis_y, *, max_sigma: float,
                           u8_inputs: bool, norm: int = 255):
    """Σ w·x / Σ w over the four (s, t) blocks of a rings gather
    (``lerf_tpu.ops.resample.gauss_rings_accumulate``; ``dis_*``: [N, S]
    tensors in the weights' type).  With ``u8_inputs`` the gathered codes
    decode as ``code / norm`` (IEEE division); weights flush below 2^-126
    (:func:`flush_subnormal`), as the matrix warp's.  Returns [N, C]."""
    wn = ws = None
    for b, (s, t) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        x, r_, sx_, sy_ = gathered[b]
        if u8_inputs:
            x = x.to(torch.float32)
            r_, sx_, sy_ = decode_gaussian_hyper(
                *(divide_exact(p.to(torch.float32), norm)
                  for p in (r_, sx_, sy_)), max_sigma)
        w = flush_subnormal(steering_gaussian_weight(
            r_, sx_, sy_, dis_x[:, s:s + 1], dis_y[:, t:t + 1]))
        wn = w * x if wn is None else wn + w * x
        ws = w if ws is None else ws + w
    return wn / ws


def _linear_rings_accumulate(gathered, rings: WarpRings, dx, dy, *,
                             max_alpha: float, u8_inputs: bool,
                             norm: int = 255):
    """The amplified-linear counterpart of :func:`gauss_rings_accumulate`,
    on the rings' float64 branch masks.  Returns [N, C]."""
    dev = dx.device
    mx = [_leaf(m, dev, torch.float32) for m in rings.masks_x]
    my = [_leaf(m, dev, torch.float32) for m in rings.masks_y]
    wn = ws = None
    for b, (s, t) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        x, a_ = gathered[b]
        if u8_inputs:
            x = x.to(torch.float32)
            a_ = decode_linear_hyper(divide_exact(a_.to(torch.float32), norm),
                                     max_alpha)
        w = amplified_linear_weight(
            a_, dx[:, s:s + 1], dy[:, t:t + 1],
            (mx[0][:, s:s + 1], mx[1][:, s:s + 1]),
            (my[0][:, t:t + 1], my[1][:, t:t + 1]))
        wn = w * x if wn is None else wn + w * x
        ws = w if ws is None else ws + w
    return wn / ws


def warp_rings_plain(planes, rings: WarpRings, *, linear: bool,
                     max_sigma: float = 10.0, max_alpha: float = 1.0,
                     u8_inputs: bool = False, norm: int = 255):
    """The rings warp on ±1-padded ``planes`` (feature and decoded maps, or
    with ``u8_inputs`` integer codes decoded ``code / norm`` after the
    gather) on any device: the twin of K5's rings instance.  The weights,
    sums and output take the type lerf_tpu's promotion gives: float32
    for codes or under float32 rings (a bf16 feature widening exactly into
    the float32 products), bf16 for bf16 maps under bf16 rings.  Returns
    float [C, N]."""
    if linear and rings.masks_x is None:
        raise ValueError("the linear warp needs rings built with "
                         "linear=True (their branch masks)")
    gathered = _rowpack_warp_gather_rings(planes, rings)
    dx, dy = _rings_dis(rings, planes[0].device)
    if linear:
        out = _linear_rings_accumulate(gathered, rings, dx, dy,
                                       max_alpha=max_alpha,
                                       u8_inputs=u8_inputs, norm=norm)
    else:
        out = gauss_rings_accumulate(gathered, dx, dy, max_sigma=max_sigma,
                                     u8_inputs=u8_inputs, norm=norm)
    return out.T


def rings_out_dtype(img, maps, rings, *, linear: bool,
                    u8_inputs: bool) -> torch.dtype:
    """The type of the rings warps' output, lerf_tpu's promotion of its
    operands: float32 for codes (``u8_inputs``) and in the linear mode
    (its float32 branch masks), else the feature's, the maps' and the
    rings' types promoted (bf16 only when all three are)."""
    if u8_inputs or linear:
        return torch.float32
    out = rings_dtype(rings)
    for t in [img] + list(maps):
        out = torch.promote_types(out, t.dtype)
    return out


def _rings_on_card(img, maps, rings, out_sz, *, linear, max_sigma,
                   pad_mode, u8_inputs, max_alpha=1.0):
    """The rings warp on CUDA tensors: K5's rings instance
    (``kernels.warp.steering_warp_rings``), never the plain form.  Integer
    inputs go in as int32 codes (the LUT and SRNet forms'), float ones as
    the maps in [0, 1]; the result in the plain form's type
    (:func:`rings_out_dtype`)."""
    from .kernels.warp import steering_warp_rings

    if pad_mode != "constant":
        raise ValueError(f"pad_mode={pad_mode!r}: K5 pads the feature with "
                         "zeros ('constant') only")
    if max_alpha != 1.0:
        raise ValueError(f"max_alpha={max_alpha}: K5 decodes alpha with "
                         "max_alpha 1 only")
    if u8_inputs:
        feat = (torch.round(img) if torch.is_floating_point(img) else img) \
            .to(torch.int32)
        codes = torch.stack([_encode_u8(m).to(torch.int32) for m in maps],
                            -1)
    else:
        feat, codes = img, torch.stack(list(maps), -1)
    out = steering_warp_rings(feat, codes, rings, out_sz=out_sz,
                              max_sigma=max_sigma, norm=255, linear=linear)
    return out.to(rings_out_dtype(img, maps, rings, linear=linear,
                                  u8_inputs=u8_inputs))


def steering_gaussian_warp_rings(img, rho, sigma_x, sigma_y,
                                 rings: WarpRings, *, out_sz=None,
                                 max_sigma: float = 10.0,
                                 pad_mode: str = "constant",
                                 u8_inputs: bool = False):
    """Dynamic-homography steering warp
    (``lerf_tpu.ops.resample.steering_gaussian_warp_rings``): bit-equal to
    :func:`steering_gaussian_warp` ([C, H, W], support 2) of the same
    homography, with the geometry taken from ``rings`` (host:
    ``WarpOperands.create`` + :func:`warp_rings`, or
    :func:`warp_serving_host_fused`; or :func:`warp_rings_on_device`) —
    also the rings of any other map (``WarpOperands.from_grid``).

    ``out_sz=None`` returns the flat ``[C, N]`` output.  The rings' type
    sets the weights' (:func:`rings_dtype`): float32 rings warp bf16 maps
    into a float32 output, as lerf_tpu's do; bf16 rings
    (``warp_rings(..., dtype=torch.bfloat16)``) keep bf16 maps in bf16.
    On CPU tensors the plain form (:func:`warp_rings_plain`); on CUDA
    tensors K5's rings instance, which takes ``pad_mode`` "constant"
    only."""
    if img.device.type == "cuda":
        return _rings_on_card(img, (rho, sigma_x, sigma_y), rings, out_sz,
                              linear=False, max_sigma=max_sigma,
                              pad_mode=pad_mode, u8_inputs=u8_inputs)
    planes = gauss_rings_planes(img, rho, sigma_x, sigma_y,
                                max_sigma=max_sigma, u8_inputs=u8_inputs,
                                pad_mode=pad_mode)
    out = warp_rings_plain(planes, rings, linear=False, max_sigma=max_sigma,
                           u8_inputs=u8_inputs)
    return out if out_sz is None else out.reshape(img.shape[0], *out_sz)


def linear_rings_planes(img, alpha, *, max_alpha: float, u8_inputs: bool,
                        pad_mode: str = "constant"):
    """The 2 fixed ±1-padded gather planes of the amplified-linear ring
    warp (image: ``pad_mode``; α map: edge), as :func:`gauss_rings_planes`
    makes the steering warp's."""
    if u8_inputs:
        img_u8 = img if not torch.is_floating_point(img) else torch.round(img)
        return [pad2d(img_u8.to(torch.uint8), (1, 1), (1, 1), pad_mode),
                pad2d(_encode_u8(alpha), (1, 1), (1, 1), "edge")]
    return [pad2d(img, (1, 1), (1, 1), pad_mode),
            pad2d(decode_linear_hyper(alpha, max_alpha), (1, 1), (1, 1),
                  "edge")]


def amplified_linear_warp_rings(img, alpha, rings: WarpRings, *,
                                out_sz=None, max_alpha: float = 1.0,
                                pad_mode: str = "constant",
                                u8_inputs: bool = False):
    """Dynamic-homography amplified-linear warp
    (``lerf_tpu.ops.resample.amplified_linear_warp_rings``), the rings
    counterpart of :func:`amplified_linear_warp`: ``rings`` built with
    ``linear=True`` so the float64 branch masks ride along; ``out_sz=None``
    → flat [C, N].  CUDA tensors run K5's rings instance (``max_alpha`` 1,
    ``pad_mode`` "constant")."""
    if img.device.type == "cuda":
        return _rings_on_card(img, (alpha,), rings, out_sz, linear=True,
                              max_sigma=10.0, pad_mode=pad_mode,
                              u8_inputs=u8_inputs, max_alpha=max_alpha)
    planes = linear_rings_planes(img, alpha, max_alpha=max_alpha,
                                  u8_inputs=u8_inputs, pad_mode=pad_mode)
    out = warp_rings_plain(planes, rings, linear=True, max_alpha=max_alpha,
                           u8_inputs=u8_inputs)
    return out if out_sz is None else out.reshape(img.shape[0], *out_sz)


def warp_rings_on_device(inv, in_sz, out_sz, *, in_frame=None) -> WarpRings:
    """The rings of the homography whose float64 inverse is ``inv`` (a
    [3, 3] array or tensor), made where ``inv`` lies
    (``lerf_tpu.ops.resample.warp_rings_on_device``; Gaussian: no branch
    masks).  For a CUDA tensor on the card, from the float64 derivation
    K5's instances make (``kernels.warp.warp_rings_geometry``); otherwise
    its plain twin on the CPU
    (:func:`~lerf_torch.ops.geometry.warp_rings_operands_plain`), the
    same operations.  Both equal the host's
    ``warp_rings(WarpOperands.create(in_sz, matrix, out_sz))`` when ``inv``
    is ``np.linalg.inv(matrix)``; lerf_tpu's are float32 and do not.
    Returns a :class:`WarpRings` of tensors on ``inv``'s device.

    ``in_frame`` (lerf_tpu: rings in a shape bucket's frame) is refused:
    the port keeps no shape buckets, since nothing in PyTorch compiles per
    shape."""
    if in_frame is not None:
        raise ValueError("in_frame: the port keeps no shape buckets "
                         "(nothing in PyTorch compiles per shape)")
    in_sz = tuple(int(v) for v in in_sz)
    out_sz = tuple(int(v) for v in out_sz)
    device = inv.device if isinstance(inv, torch.Tensor) \
        else torch.device("cpu")
    inv64 = np.asarray(inv.cpu() if isinstance(inv, torch.Tensor) else inv,
                       dtype=np.float64).reshape(3, 3)
    if device.type == "cuda":
        from .kernels.warp import warp_rings_geometry

        return warp_rings_geometry(inv64, in_sz, out_sz, device)
    return WarpRings(*warp_rings_operands_plain(inv64, in_sz, out_sz))


def warp_serving_host(in_sz, matrix, out_sz, *, border: int = 4):
    """The host precompute of dynamic-warp serving
    (``lerf_tpu.ops.resample.warp_serving_host``): ``(WarpOperands,
    validity mask)`` sharing ONE float64 projection grid."""
    in_sz = tuple(int(v) for v in in_sz)
    out_sz = tuple(int(v) for v in out_sz)
    grid_x, grid_y = _warp_grid(matrix, in_sz, out_sz)
    ops = WarpOperands.from_grid(grid_x, grid_y, in_sz, out_sz)
    mask = _mask_from_grid(grid_x, grid_y, in_sz, border)
    return ops, mask


def warp_serving_host_fused(in_sz, matrix, out_sz, *, border: int = 4,
                            linear: bool = False, dtype=np.float32,
                            block_rows: int = 64, native: bool = True):
    """``(WarpRings, validity mask)`` of one homography in one sweep
    (``lerf_tpu.ops.resample.warp_serving_host_fused``), bit-equal to
    ``warp_rings(WarpOperands.create(...))`` and
    :func:`nearest_warp_mask_host`.

    ``native=True`` with float32 distances: the C library
    (:mod:`lerf_torch.native`, built at first use; it raises if it cannot
    be built), on :func:`~lerf_torch.native.native_threads` threads.
    Otherwise numpy, ``block_rows`` output rows at a time, every
    intermediate cache-resident and only the outputs streamed to memory
    (the int32 corner, the float32 distances, the mask); the mask's gather
    replaced by arithmetic (``box(d)·neigh == 255`` ⇔ both box factors
    are 1 AND the clipped support-1 index lands in the white region),
    exact on the {0, 255} lattice.  Every float64 expression is
    ``_warp_grid`` / ``_serving_axis`` / ``_mask_from_grid``'s term for
    term, and the single cast to ``dtype`` is :func:`warp_rings`'
    (``torch.bfloat16``: float32 rounded to bf16 tensors).  Support 2
    only."""
    if dtype is torch.bfloat16:   # numpy has no bf16: rounded through f32
        rings, mask = warp_serving_host_fused(
            in_sz, matrix, out_sz, border=border, linear=linear,
            block_rows=block_rows, native=native)
        return rings._replace(**{k: torch.from_numpy(getattr(rings, k))
                                 .to(dtype) for k in ("dis_x", "dis_y")}), \
            mask
    in_h, in_w = (int(v) for v in in_sz)
    oh, ow = (int(v) for v in out_sz)
    inv = np.linalg.inv(np.asarray(matrix, dtype=np.float64))
    eps = float(np.finfo(np.float32).eps)
    xs = np.arange(ow, dtype=np.float64)

    def scalar_grid(y, x):
        den = (inv[2, 0] * x + inv[2, 2]) + inv[2, 1] * y
        sx = ((inv[0, 0] * x + inv[0, 2]) + inv[0, 1] * y) / den
        sy = ((inv[1, 0] * x + inv[1, 2]) + inv[1, 1] * y) / den
        return min(max(sy, 0.0), float(in_h)), min(max(sx, 0.0), float(in_w))

    # pads are set by the FIRST output pixel alone (the reference's
    # ``pad0 = max(-fov[0,0,0], 0)`` quirk, resize_right2d_numpy.py:365)
    g00x, g00y = scalar_grid(0.0, 0.0)
    pad0 = (int(max(-int(np.ceil(g00x - 1.0 - eps)), 0)),
            int(max(-int(np.ceil(g00y - 1.0 - eps)), 0)))
    pad0m = (int(max(-int(np.ceil(g00x - 0.5 - eps)), 0)),
             int(max(-int(np.ceil(g00y - 0.5 - eps)), 0)))

    if native and dtype == np.float32:
        from ..native import get_warp_lib, native_threads

        lib = get_warp_lib()
        n = oh * ow
        corner = np.empty(n, np.int32)
        dis_x = np.empty((n, 2), np.float32)
        dis_y = np.empty((n, 2), np.float32)
        mask_u8 = np.empty(n, np.uint8)
        mk = [np.empty((n, 2), np.float32)
              for _ in range(4)] if linear else [None] * 4
        ptr = [m.ctypes.data if m is not None else None for m in mk]
        lib.warp_operands_fused(
            np.ascontiguousarray(inv), in_h, in_w, oh, ow,
            pad0[0], pad0[1], pad0m[0], pad0m[1], border, int(linear),
            native_threads(), corner, dis_x, dis_y, mask_u8,
            ptr[0], ptr[1], ptr[2], ptr[3])
        rings = WarpRings(
            ring_map(in_h, pad0[0]), ring_map(in_w, pad0[1]), corner,
            dis_x, dis_y,
            (mk[0], mk[1]) if linear else None,
            (mk[2], mk[3]) if linear else None)
        return rings, mask_u8.astype(bool).reshape(oh, ow)

    corner = np.empty((oh, ow), np.int32)
    dis = [np.empty((oh, ow, 2), dtype) for _ in range(2)]
    mask = np.empty((oh, ow), bool)
    msk = [[np.empty((oh, ow, 2), dtype) for _ in range(2)]
           for _ in range(2)] if linear else None

    for r0 in range(0, oh, block_rows):
        r1 = min(r0 + block_rows, oh)
        sl = slice(r0, r1)
        ysb = np.arange(r0, r1, dtype=np.float64)[:, None]
        den = (inv[2, 0] * xs + inv[2, 2]) + inv[2, 1] * ysb
        sx = ((inv[0, 0] * xs + inv[0, 2]) + inv[0, 1] * ysb) / den
        sy = ((inv[1, 0] * xs + inv[1, 2]) + inv[1, 1] * ysb) / den
        cxy = []
        okb = None
        for ax, (g, in_n) in enumerate(((sy.clip(0, in_h), in_h),
                                        (sx.clip(0, in_w), in_w))):
            left = np.ceil(g - 1.0 - eps)
            shifted = g + pad0[ax]
            for j in (0, 1):
                t = np.clip(left + (j + pad0[ax]), 0, in_n - 1)
                d = shifted - t
                dis[ax][sl, :, j] = d
                if linear:
                    neg, pos = _branch_masks(d, dtype)
                    msk[ax][0][sl, :, j] = neg
                    msk[ax][1][sl, :, j] = pos
            cxy.append(left + (pad0[ax] + 1))
            # support-1 mask axis: box(dm) == 1 AND the clipped index lands
            # on a white (inside-border) source row
            lm = np.ceil(g - 0.5 - eps)
            fm = np.clip(lm + pad0m[ax], 0, in_n - 1)
            dm = (g + pad0m[ax]) - fm
            ok = ((-1.0 <= dm) & (dm <= 1.0)
                  & (fm >= pad0m[ax] + border)
                  & (fm <= pad0m[ax] + in_n - 1 - border))
            okb = ok if okb is None else (okb & ok)
        corner[sl] = (cxy[0] * (in_w + 3) + cxy[1]).astype(np.int32)
        mask[sl] = okb

    n = oh * ow
    rings = WarpRings(
        ring_map(in_h, pad0[0]), ring_map(in_w, pad0[1]), corner.reshape(n),
        dis[0].reshape(n, 2), dis[1].reshape(n, 2),
        tuple(m.reshape(n, 2) for m in msk[0]) if linear else None,
        tuple(m.reshape(n, 2) for m in msk[1]) if linear else None)
    return rings, mask


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
        m = in_type(rings.aa, dt)
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
        return w if rings.aa is None else in_type(rings.aa, dt) * w

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


# ---------------------------------------------------------------------------
# the ResizeRight-style resize API (benchmark data preparation)
# ---------------------------------------------------------------------------

_KERNEL_SUPPORT = {"cubic": 4, "linear": 2, "box": 1, "lanczos2": 4,
                   "lanczos3": 6}


def _axis_phase_weights(in_sz: int, out_sz: int, frac, kernel: str,
                        antialias: bool):
    """Host float64 taps of each phase for an exact-rational scale p/q
    (the reference's by_convs weights, resize_right.py:130-155,210-218):
    only the first p outputs are evaluated; phase k's filter applies at
    input offset ``left[k] + m·q`` for output ``m·p + k``.  Returns (p, q,
    lefts [p], weights [p, T] float64)."""
    import math

    p, q = frac.numerator, frac.denominator
    sf = float(frac)
    kern1d = interp_kernels.NP_KERNELS_1D[kernel]
    support = float(_KERNEL_SUPPORT[kernel])
    scale_w = 1.0
    if antialias and sf < 1.0:
        support = support / sf
        scale_w = sf
    eps = np.finfo(np.float32).eps
    grid = (np.arange(p, dtype=np.float64) / sf
            + (in_sz - 1) / 2 - (out_sz - 1) / (2 * sf))
    left = np.ceil(grid - support / 2 - eps).astype(np.int64)
    taps = np.arange(math.ceil(support - eps), dtype=np.float64)
    w = kern1d(scale_w * (grid[:, None] - (left[:, None] + taps[None, :])))
    if scale_w != 1.0:
        w = scale_w * w
    s = w.sum(1, keepdims=True)
    s[s == 0] = 1.0
    return p, q, left, w / s


def _axis_resize_by_convs(x: torch.Tensor, out_sz: int, frac, kernel: str,
                          antialias: bool, pad_mode: str, axis: int):
    """One axis of the by_convs path: p phases, each T strided slices
    summed with its float32 taps, then the phases interleaved (lerf_tpu's
    form of the reference's strided correlations,
    resize_right.py:255-281)."""
    in_sz = x.shape[axis]
    p, q, left, w64 = _axis_phase_weights(in_sz, out_sz, frac, kernel,
                                          antialias)
    t_taps = w64.shape[1]
    pad0 = int(max(0, -left.min()))
    # every phase's tap slices span (n_max-1)*q whatever the count of its
    # outputs that survive the final trim, so the pad covers n_max
    n_max = (out_sz - 1) // p + 1
    need = int(left.max()) + pad0 + (n_max - 1) * q + t_taps
    pad1 = int(max(0, need - (in_sz + pad0)))
    pad_cfg = ((pad0, pad1), (0, 0)) if axis in (-2, x.ndim - 2) \
        else ((0, 0), (pad0, pad1))
    xp = pad2d(x, pad_cfg[0], pad_cfg[1], pad_mode)

    pos = axis if axis >= 0 else x.ndim + axis
    phases = []
    for k in range(p):
        start = int(left[k]) + pad0
        acc = None
        for t in range(t_taps):
            idx = [slice(None)] * x.ndim
            idx[pos] = slice(start + t, start + t + (n_max - 1) * q + 1, q)
            # the tap in x's type, as lerf_tpu multiplies it
            term = float(np.asarray(w64[k, t], np.float32)) * xp[tuple(idx)]
            acc = term if acc is None else acc + term
        phases.append(acc)
    stacked = torch.stack(phases, dim=pos + 1)      # [.., n_max, p, ..]
    shape = list(stacked.shape)
    shape[pos:pos + 2] = [n_max * p]
    out = stacked.reshape(shape)
    idx = [slice(None)] * x.ndim
    idx[pos] = slice(0, out_sz)
    return out[tuple(idx)]


def _pad1d_last(x: torch.Tensor, pad0: int, pad1: int, pad_mode: str):
    """Pad (or crop, for negative pads) the LAST axis."""
    if pad0 < 0:
        x = x[..., -pad0:]
        pad0 = 0
    if pad1 < 0:
        x = x[..., :x.shape[-1] + pad1]
        pad1 = 0
    if pad0 == 0 and pad1 == 0:
        return x
    if pad_mode in ("edge", "replicate"):
        return x.index_select(-1, edge_index(x.shape[-1], pad0, pad1,
                                             x.device))
    if pad_mode != "constant":
        raise KeyError(pad_mode)
    return F.pad(x, (pad0, pad1))


def _axis_resize_generic(x: torch.Tensor, out_n: int, sf: float, kernel: str,
                         antialiasing: bool, pad_mode: str, axis: int):
    """1-D separable resize along ``axis``, the vendored resize_right's
    per-dim step (resize_right.py:76-127): per-dim antialias scale (not
    the 2-D path's min-scale), per-dim weight normalization
    (resize_right.py:208-218), float64 host weights."""
    from .geometry import _resize_axis

    in_n = x.shape[axis]
    base = _KERNEL_SUPPORT[kernel]
    m = float(sf) if (antialiasing and sf < 1.0) else 1.0
    support = int(np.ceil(base / m))
    fov, dis, (pad0, pad1) = _resize_axis(in_n, out_n, sf, support)
    kern1d = interp_kernels.NP_KERNELS_1D[kernel]
    w = kern1d(m * dis)                       # [out, S] float64
    w = w / w.sum(-1, keepdims=True)          # per-dim normalize
    x = torch.movedim(x, axis, -1)
    xp = _pad1d_last(x, pad0, pad1, pad_mode)
    g = xp[..., torch.from_numpy(fov.astype(np.int64)).to(x.device)]
    wt = torch.from_numpy(w.astype(np.float32)).to(x.device, x.dtype)
    out = torch.sum(g * wt, dim=-1)           # [..., out]
    return torch.movedim(out, -1, axis)


def _resolve_nd_spec(in_shape, scale_factors, out_shape):
    """Full-length (per-dim) scale and out lists from partial specs, the
    trailing-dims convention (the vendored reference's torch convention,
    resize_right.py:292-318: arrays are [..., C, H, W]-style, so defaulting
    the leading dims would resize channels)."""
    from math import ceil as _ceil

    nd = len(in_shape)
    if scale_factors is None and out_shape is None:
        raise ValueError("need scale_factors and/or out_shape")
    if out_shape is not None:
        if len(out_shape) > nd:
            raise ValueError(
                f"out_shape has {len(out_shape)} entries for a "
                f"{nd}-d array (the vendored resize_right errors here too)")
        out_shape = list(in_shape[:nd - len(out_shape)]) \
            + [int(v) for v in out_shape]
        if scale_factors is None:
            scale_factors = [o / i for o, i in zip(out_shape, in_shape)]
    if scale_factors is not None:
        if not isinstance(scale_factors, (list, tuple)):
            scale_factors = [scale_factors, scale_factors]
        if len(scale_factors) > nd:
            raise ValueError(
                f"scale_factors has {len(scale_factors)} entries for a "
                f"{nd}-d array")
        scale_factors = [1.0] * (nd - len(scale_factors)) \
            + [float(s) for s in scale_factors]
        if out_shape is None:
            out_shape = [_ceil(s * i)
                         for s, i in zip(scale_factors, in_shape)]
    return scale_factors, out_shape


def _snapped(sf: float, max_numerator: int):
    """The scale snapped to an exact fraction p/q as the reference does
    (``Fraction(1/sf).limit_denominator(max_numerator)`` inverted,
    resize_right.py:327-342)."""
    from fractions import Fraction

    frac = Fraction(1.0 / sf).limit_denominator(max_numerator)
    return Fraction(frac.denominator, frac.numerator)


def resize(img: torch.Tensor, scale_factors=None, out_shape=None, *,
           interp_method: str = "cubic", antialiasing: bool = True,
           pad_mode: str = "constant", by_convs: bool = False,
           max_numerator: int = 10, scale_tolerance=None):
    """ResizeRight-style resize (``lerf_tpu.ops.resample.resize``; the
    vendored ``resize_right.py:36-127`` of the reference, used there to
    prepare benchmark LR data), on a float tensor of any device.

    img: [..., H, W] with a spatial spec (≤ 2 entries) takes the 2-D
    path: a :class:`ResizeGeometry` with the kernel's support and
    antialiased downscaling through :func:`fixed_kernel_resize`.  A spec
    LONGER than 2 entries resizes any dims like the vendored N-D original
    (trailing-dims convention): each scaled dim on its own, in ascending
    order of scale, with per-dim antialiasing and weight normalization.

    ``by_convs=True`` mirrors the reference's strided-conv path for
    rational scales (resize_right.py:221-281): scales snapped to exact
    fractions p/q, each axis resized on its own (ascending by scale) by p
    strided phases; a dim whose scale is not within ``scale_tolerance`` of
    a fraction takes the generic path, as in the reference.
    """
    spec_len = max(
        len(scale_factors) if isinstance(scale_factors, (list, tuple)) else 1,
        len(out_shape) if out_shape is not None else 1)
    if spec_len > 2:
        return _resize_nd(img, scale_factors, out_shape,
                          interp_method=interp_method,
                          antialiasing=antialiasing, pad_mode=pad_mode,
                          by_convs=by_convs, max_numerator=max_numerator,
                          scale_tolerance=scale_tolerance)

    support = _KERNEL_SUPPORT[interp_method]
    in_hw = tuple(img.shape[-2:])
    scale_factors, out_shape = resolve_scale_and_out_sz(
        in_hw, scale_factors, out_shape)

    if not by_convs:
        geom = ResizeGeometry.create(
            in_hw, scale_factors=list(scale_factors),
            out_sz=tuple(out_shape), support=support, antialias=antialiasing)
        return fixed_kernel_resize(img, geom, interp_method,
                                   pad_mode=pad_mode)

    tol = np.finfo(np.float32).eps if scale_tolerance is None \
        else scale_tolerance
    out = img
    # dims sorted ascending by scale, scale-1 dims skipped
    # (resize_right.py:60-64)
    for d in sorted((0, 1), key=lambda d: scale_factors[d]):
        sf = scale_factors[d]
        if sf == 1.0 and out_shape[d] == out.shape[-2 + d]:
            continue
        frac = _snapped(sf, max_numerator)
        if abs(float(frac) - sf) < tol:
            out = _axis_resize_by_convs(out, out_shape[d], frac,
                                        interp_method, antialiasing,
                                        pad_mode, -2 + d)
        else:
            # this dim on the generic path, like the reference's mixed
            # by_convs
            sz = list(out.shape[-2:])
            sz[d] = out_shape[d]
            geom = ResizeGeometry.create(
                tuple(out.shape[-2:]),
                scale_factors=[sf if i == d else 1.0 for i in (0, 1)],
                out_sz=tuple(sz), support=support, antialias=antialiasing)
            out = fixed_kernel_resize(out, geom, interp_method,
                                      pad_mode=pad_mode)
    return out


def _resize_nd(img: torch.Tensor, scale_factors, out_shape, *,
               interp_method: str, antialiasing: bool, pad_mode: str,
               by_convs: bool, max_numerator: int, scale_tolerance):
    """The N-D resize, the vendored ``resize_right.py:36-127`` dim loop:
    full-length specs, scaled dims in ascending order of scale, each on
    its own (strided phases where ``by_convs`` snaps its scale to an exact
    fraction, else the separable 1-D gather)."""
    scale_factors, out_shape = _resolve_nd_spec(tuple(img.shape),
                                                scale_factors, out_shape)
    tol = np.finfo(np.float32).eps if scale_tolerance is None \
        else scale_tolerance
    out = img
    for d in sorted(range(img.ndim), key=lambda d: scale_factors[d]):
        sf = scale_factors[d]
        if sf == 1.0 and out_shape[d] == out.shape[d]:
            continue
        frac = _snapped(sf, max_numerator) if by_convs else None
        if frac is not None and abs(float(frac) - sf) < tol:
            moved = _axis_resize_by_convs(torch.movedim(out, d, -1),
                                          out_shape[d], frac, interp_method,
                                          antialiasing, pad_mode, -1)
            out = torch.movedim(moved, -1, d)
        else:
            out = _axis_resize_generic(out, out_shape[d], sf, interp_method,
                                       antialiasing, pad_mode, d)
    return out
