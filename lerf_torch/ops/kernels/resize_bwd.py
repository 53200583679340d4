"""K6 wrapper: the steerable resize's backward, the training step's.

``steering_resize_grad`` gives ∂L/∂feature and ∂L/∂hyper of K1's float
mode from ∂L/∂out.  It runs the plain twin
(:func:`lerf_torch.ops.resample.steering_resize_grad_plain`, the gradient
written out) for CPU tensors and launches ``csrc/steering_resize_bwd.cu``
for CUDA tensors; it never falls back from the card to the plain version.
``launches`` counts its calls on the card, one kernel launch each.

The kernel takes one tile of source pixels of one plane a block.
:func:`plan_tiles` plans the tiles of a geometry on the host: per band of
tile rows (and of tile columns) the outputs whose windows touch the band,
the source window they read and the band's geometry packed as the block
stages it, from the per-axis inverse field of view (:func:`inverse_fov`).
:class:`GradOperands` holds K1's operands and every candidate tile's plan
on the device, and picks a tile for each plane count (:func:`pick_plan`)
at its first call, with the launch's constant arguments
(:class:`LaunchPlan`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import geometry as geo
from ..resample import steering_resize_grad_plain
from . import _build
from .resize import BLOCK_SMEM_MAX, SM_SMEM, SM_THREADS, ResizeOperands

launches = 0

# Source tiles (rows, columns) a block may take.  The host plans each that
# fits in shared memory and picks one per plane count (pick_plan).
TILES = ((8, 32), (8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (1, 4), (1, 1))
THREADS = 256              # a block, unless its tile has fewer lanes
MAX_THREADS = 512          # the kernel's __launch_bounds__
WARPS_PER_SM = 32          # resident warps the pick aims for on every SM
#                            (16 × 48² → ×4 ran 4–16 % faster at 32 than
#                            at 16 on the H100: probe_lut_kernels --k6)
REGISTERS = 64             # a thread's, as ptxas builds the kernel (sm_90a)
SM_REGISTERS = 65536
BLOCK_RESERVED_SMEM = 1024  # the H100 keeps 1 KB of an SM's shared memory
#                            a resident block for itself


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


def tile_bands(fov: np.ndarray, n_src: int, tile: int, inv: np.ndarray,
               v_min: int) -> np.ndarray:
    """The bands of ``tile`` source rows over ``n_src`` rows of one axis:
    int32 ``[n_bands, 12]``, each ``lo, hi, o_lo, o_hi, w_lo, w_n, v_lo,
    n_v``, three words :func:`band_geometry` fills and one unused.  The
    band owns source rows ``[lo, hi)`` and, on the first and last band,
    the pad rows that copy its border row; its virtual rows ``[v_lo, v_lo
    + n_v)`` are those of the inverse list ``inv`` of ``fov`` (from
    ``v_min``, :func:`inverse_fov`); the outputs ``[o_lo, o_hi)`` read one
    of them; those outputs' windows span source rows ``[w_lo, w_lo +
    w_n)``.  A band no output reads has empty ranges."""
    S = fov.shape[1]
    v_max = v_min + len(inv) - 1
    lo = np.arange(0, n_src, tile)
    hi = np.minimum(lo + tile, n_src)
    first = np.maximum(np.where(lo > 0, lo, min(v_min, 0)), v_min)
    last = np.minimum(np.where(hi < n_src, hi - 1, max(v_max, n_src - 1)),
                      v_max)
    read = first <= last
    o_lo = np.where(read, inv[np.clip(first - v_min, 0, len(inv) - 1), 0], 0)
    o_hi = np.where(read, inv[np.clip(last - v_min, 0, len(inv) - 1), 1], 0)
    some = o_hi > o_lo
    w_lo = np.where(some, fov[np.minimum(o_lo, len(fov) - 1), 0], 0)
    w_n = np.where(some, fov[np.maximum(o_hi - 1, 0), 0] + S - w_lo, 0)
    zero = np.zeros_like(lo)
    return np.stack([lo, hi, np.where(some, o_lo, 0),
                     np.where(some, o_hi, 0), w_lo, w_n,
                     np.where(some, first, 0),
                     np.where(some, last - first + 1, 0),
                     zero, zero, zero, zero], -1).astype(np.int32)


def band_geometry(bands: np.ndarray, fov: np.ndarray, dis: np.ndarray,
                  masks: Optional[np.ndarray], inv: np.ndarray, v_min: int,
                  f_base: int = 0, i_base: int = 0):
    """Each band's geometry as the kernel stages it, packed: float32 the
    touching outputs' distances ``dis[o_lo:o_hi]`` ([n, S], the mode's as
    K1 takes them); int32 each output's window offset ``fov[o, 0] - w_lo``,
    each virtual row's output range ``[lo, hi)`` (from ``inv``) and, with
    ``masks``, the outputs' branch bits [n, S].  Fills ``bands``' words 8–10
    (float offset, int offset, int count; from ``f_base`` / ``i_base``).
    Returns (floats, ints)."""
    floats, ints = [], []
    f_at, i_at = f_base, i_base
    for b in bands:
        o_lo, o_hi, w_lo, v_lo, n_v = (int(b[k]) for k in (2, 3, 4, 6, 7))
        words = [fov[o_lo:o_hi, 0] - w_lo,
                 inv[v_lo - v_min:v_lo - v_min + n_v].reshape(-1)]
        if masks is not None:
            words.append(masks[o_lo:o_hi].reshape(-1))
        words = np.concatenate(words).astype(np.int32)
        b[8:11] = f_at, i_at, len(words)
        floats.append(dis[o_lo:o_hi].reshape(-1))
        ints.append(words)
        f_at += (o_hi - o_lo) * dis.shape[1]
        i_at += len(words)
    return (np.concatenate(floats).astype(np.float32),
            np.concatenate(ints).astype(np.int32))


def smem_bytes(ni: int, nj: int, nwr: int, nwc: int, support: int,
               linear: bool, ints: int) -> int:
    """A block's shared memory, in the kernel's order: the ``nwr × nwc``
    window (float4, linear float2), P and Q of its ``ni × nj`` outputs
    (float2, rows padded to an odd length), the distances (float [ni + nj,
    S]) and both bands' ``ints`` geometry words (:func:`band_geometry`)."""
    entry = 8 if linear else 16
    return (nwr * nwc * entry + 8 * ni * (nj | 1) + 4 * support * (ni + nj)
            + 4 * ints)


class TilePlan(NamedTuple):
    """One candidate tile of a geometry: ``group`` lanes a source pixel
    (a power of two ≥ the most output rows that read one source row, ≤
    32), ``threads`` a block, the row bands then the column bands
    (:func:`tile_bands`) and their geometry (:func:`band_geometry`), the
    largest block's shared memory and the outputs phase A works out in one
    plane (the halo's recompute included)."""
    tile: tuple
    group: int
    threads: int
    bands: np.ndarray      # int32 [n_ty + n_tx, 12]
    geo_f: np.ndarray      # float32
    geo_i: np.ndarray      # int32
    n_ty: int
    n_tx: int
    smem: int
    phase_a: int


def plan_tiles(ops: ResizeOperands, *, tiles=TILES,
               threads: Optional[int] = None):
    """Every tile of ``tiles`` whose blocks fit in shared memory, planned
    for the geometry ``ops`` (K1's operands, on any device; its monotone
    field of view in unpadded source coordinates): a tuple of
    :class:`TilePlan`.  ``threads``: a block's threads instead of the
    default (a multiple of 32).  Raises when no tile fits."""
    H, W = ops.in_sz
    rows, cols = ops.rows.cpu().numpy(), ops.cols.cpu().numpy()
    dis = [d.cpu().numpy() for d in ((ops.lin_x, ops.lin_y) if ops.linear
                                     else (ops.dis_x, ops.dis_y))]
    masks = ([m.cpu().numpy() for m in (ops.mask_x, ops.mask_y)]
             if ops.linear else [None, None])
    S = rows.shape[1]
    inv_r, r_min = inverse_fov(rows)
    inv_c, c_min = inverse_fov(cols)
    most = max(int((inv_r[:, 1] - inv_r[:, 0]).max()), 1)
    group = min(32, 1 << (most - 1).bit_length())
    if threads is not None and (threads % 32 or not 32 <= threads
                                <= MAX_THREADS):
        raise ValueError(f"K6: {threads} threads a block is not a multiple "
                         f"of 32 in [32, {MAX_THREADS}]")
    plans = []
    for th, tw in tiles:
        br = tile_bands(rows, H, th, inv_r, r_min)
        bc = tile_bands(cols, W, tw, inv_c, c_min)
        fr, ir = band_geometry(br, rows, dis[0], masks[0], inv_r, r_min)
        fc, ic = band_geometry(bc, cols, dis[1], masks[1], inv_c, c_min,
                               len(fr), len(ir))
        ni, nj = (int((b[:, 3] - b[:, 2]).max()) for b in (br, bc))
        smem = smem_bytes(ni, nj, int(br[:, 5].max()), int(bc[:, 5].max()),
                          S, ops.linear,
                          int(br[:, 10].max()) + int(bc[:, 10].max()))
        if smem > BLOCK_SMEM_MAX:
            continue
        nt = threads or min(THREADS, -(-th * tw * group // 32) * 32)
        phase_a = int((br[:, 3] - br[:, 2]).sum()
                      * (bc[:, 3] - bc[:, 2]).sum())
        plans.append(TilePlan(
            tile=(th, tw), group=group, threads=nt,
            bands=np.concatenate([br, bc]), geo_f=np.concatenate([fr, fc]),
            geo_i=np.concatenate([ir, ic]), n_ty=len(br), n_tx=len(bc),
            smem=smem, phase_a=phase_a))
    if not plans:
        raise ValueError(
            f"K6: the geometry {(H, W)} -> {(len(rows), len(cols))} at "
            f"support {S} does not fit one block's shared memory "
            f"({BLOCK_SMEM_MAX} bytes) even at a {tiles[-1]} tile")
    return tuple(plans)


def resident_warps(plan: TilePlan, planes: int, sm_count: int) -> float:
    """The warps an SM holds at once, on average, when ``planes`` planes
    run on ``plan``: the blocks over the SMs, capped by what one SM holds
    (threads, registers, 32 blocks, shared memory)."""
    blocks = planes * plan.n_ty * plan.n_tx
    per_sm = min(SM_THREADS // plan.threads, 32,
                 SM_REGISTERS // (REGISTERS * plan.threads),
                 SM_SMEM // (plan.smem + BLOCK_RESERVED_SMEM))
    return min(blocks / sm_count, per_sm) * plan.threads / 32


def pick_plan(plans, planes: int, sm_count: int) -> TilePlan:
    """Of the planned tiles, one that keeps WARPS_PER_SM warps on every
    SM with the least phase-A work (the largest such tile); where none
    does, the one that keeps the most."""
    return max(plans, key=lambda pl: (
        min(resident_warps(pl, planes, sm_count), WARPS_PER_SM),
        -pl.phase_a))


class LaunchPlan(ctypes.Structure):
    """The kernel's ``Plan`` (``csrc/steering_resize_bwd.cu``): the
    launch's constant arguments, passed by address."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("bands", "geo_f", "geo_i")]
                + [(n, ctypes.c_int) for n in (
                    "H", "W", "OH", "OW", "S", "antialias", "linear",
                    "tile_h", "tile_w", "group", "threads", "n_ty", "n_tx",
                    "smem")]
                + [("min_scale", ctypes.c_float)])


class GradOperands(NamedTuple):
    """One training geometry on the device, in one mode: K1's operands
    (``fwd``: rows, cols, distances, masks, tile), the candidate tiles
    (:func:`plan_tiles`) with their bands and geometry on the device one
    candidate after another (``bands``, ``geo_f``, ``geo_i``; candidate
    k's from ``at[k]``), the card's SM count, and ``launch``: plane count
    → (the picked :class:`TilePlan`, its :class:`LaunchPlan`), filled at a
    plane count's first call."""
    fwd: ResizeOperands
    plans: tuple
    bands: torch.Tensor        # int32 [sum of n_ty + n_tx, 12]
    geo_f: torch.Tensor        # float32
    geo_i: torch.Tensor        # int32
    at: tuple                  # (band, float, int) offsets a candidate
    sm_count: int
    launch: dict

    @classmethod
    def create(cls, geom: geo.ResizeGeometry, device, linear: bool = False,
               *, tiles=TILES, threads: Optional[int] = None):
        """``tiles`` / ``threads``: the candidates instead of the default
        (one tile forces it; the probe and the tests time or check a
        chosen tile)."""
        dev = torch.device(device)
        fwd = ResizeOperands.create(geom, dev, linear=linear)
        plans = plan_tiles(fwd, tiles=tiles, threads=threads)
        at = np.cumsum([[0, 0, 0]] + [[len(p.bands), len(p.geo_f),
                                       len(p.geo_i)] for p in plans], 0)
        sm_count = (torch.cuda.get_device_properties(dev).multi_processor_count
                    if dev.type == "cuda" else 0)

        def up(parts):
            return torch.from_numpy(np.ascontiguousarray(
                np.concatenate(parts))).to(dev)

        return cls(fwd=fwd, plans=plans, bands=up([p.bands for p in plans]),
                   geo_f=up([p.geo_f for p in plans]),
                   geo_i=up([p.geo_i for p in plans]),
                   at=tuple(tuple(int(v) for v in row) for row in at[:-1]),
                   sm_count=sm_count, launch={})

    def launch_plan(self, planes: int):
        """The picked tile and the kernel's arguments for ``planes``
        planes, made at the first call with that count."""
        got = self.launch.get(planes)
        if got is None:
            plan = pick_plan(self.plans, planes, self.sm_count)
            b_at, f_at, i_at = self.at[self.plans.index(plan)]
            ops = self.fwd
            args = LaunchPlan(
                self.bands.data_ptr() + 4 * self.bands.shape[1] * b_at,
                self.geo_f.data_ptr() + 4 * f_at,
                self.geo_i.data_ptr() + 4 * i_at, *ops.in_sz, *ops.out_sz,
                ops.support, int(ops.antialias), int(ops.linear), *plan.tile,
                plan.group, plan.threads, plan.n_ty, plan.n_tx, plan.smem,
                float(ops.min_scale))
            got = self.launch[planes] = (plan, args)
        return got


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
    if ops.in_sz != (H, W) or tuple(grad_out.shape[1:]) != ops.out_sz:
        raise ValueError(f"geometry is for {ops.in_sz} -> {ops.out_sz}, "
                         f"tensors are {(H, W)} -> "
                         f"{tuple(grad_out.shape[1:])}")
    if ops.rows.device != feat.device or ops.linear != linear:
        raise ValueError("steering_resize_grad: operands made for another "
                         "device or the other mode")
    feat, hyper = feat.contiguous(), hyper.contiguous()
    grad_out = grad_out.contiguous()
    g_feat = torch.empty_like(feat)
    g_hyper = torch.empty_like(hyper)
    _, args = operands.launch_plan(C)
    lib = _build.library()
    with torch.cuda.device(feat.device):
        err = lib.lerf_steering_resize_bwd(
            feat.data_ptr(), hyper.data_ptr(), grad_out.data_ptr(),
            g_feat.data_ptr(), g_hyper.data_ptr(), C, float(max_sigma),
            ctypes.addressof(args), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "steering_resize_grad launch")
    launches += 1
    return g_feat, g_hyper
