"""K5 wrapper: steerable homographic warp from the stage outputs.

``steering_warp`` runs the plain twin
(:func:`lerf_torch.ops.resample.steering_warp_codes_plain`, or in the
amplified-linear mode :func:`~lerf_torch.ops.resample.linear_warp_codes_plain`,
then :func:`~lerf_torch.ops.resample.quantize_device` with ``nan_to_zero``
for uint8) for CPU tensors and launches ``csrc/steering_warp.cu`` for CUDA
tensors; it never falls back from the card to the plain version.
``launches`` counts kernel launches of any instance, ``bf16_launches``
those of the instances that take bf16 maps, ``bf16_feature_launches``
those of the instances that take a bf16 feature beside float32 maps,
``rings_launches`` those of the rings instance;
``rings_geometry_launches`` counts the rings geometry kernel's
(:func:`launch_rings_geometry`).

On the card K5 takes the homography itself, as :class:`WarpParams` (the
float64 inverse matrix, the two leading pads, the support and the sizes),
and derives each output's window on the card in float64, bit-equal to the
host geometry, the linear mode's branch masks included.  Asked for
(``mask_out``), it writes the validity mask in the same launch, from the
same float64 grid, equal to ``nearest_warp_mask_host``.  One kernel and
one C entry serve a batch of frames, each under its own homography
(:func:`steering_warp_batch`), and a single frame as a batch of one
(:func:`steering_warp`).  Both take a window of output rows, ``rows=(r0,
r1)``: the launch computes those rows of the whole output alone, each
bit-equal to the same row of the whole launch (a shard's slab of a
row-sharded warp, :mod:`lerf_torch.parallel.spatial`); the plain twin runs
the host geometry's rows ``[r0, r1)``.  :class:`WarpOperands` is the geometry in the
host's per-pixel form
(:func:`lerf_torch.ops.geometry.warp_operands_plain` computes the same);
:func:`warp_geometry` writes it from the card's derivation, for the checks,
and :func:`warp_mask` the mask alone.

The stage outputs come in the pairs of types K1 takes
(:data:`~lerf_torch.ops.kernels.resize.IN_TYPES`): int32 feature and
int32 codes (the LUT and SRNet forms, decoded as ``code / norm`` after the
gather), float32 or bf16 feature and hyper maps in [0, 1] (the IMDN
form, in its towers' compute type), or one float32 and the other bf16;
the float types' twins are lerf_tpu's float-row warps,
:func:`~lerf_torch.ops.resample.steering_gaussian_warp` and
:func:`~lerf_torch.ops.resample.amplified_linear_warp` with
``u8_inputs=False``, run on the inputs as they are (bf16: each operation
rounded to bf16; the geometry stays float64 and only the distances are
cast, to bf16 wherever the feature is bf16).  A float32 output of bf16
inputs is the twin's result widened.

The warp's geometry as data (:func:`steering_warp_rings`): K5's rings
instance takes a :class:`~lerf_torch.ops.resample.WarpRings` (each
output's corner and distances, the ring maps, and in the linear mode the
host's float64 branch masks) in place of the matrix, read from memory
where the matrix instances derive them.  It is a persistent kernel
(:func:`rings_grid` blocks, the SM count asked once a device): each
thread copies its outputs' rings into shared memory two tiles ahead
while the block sums the tile before, with the matrix instances' decode,
weights and epilogue.  The rings' distance type sets the weights' type,
as lerf_tpu's promotion does (:func:`rings_in_type`): every input pair
under either rings type.  Its plain twin is
:func:`steering_warp_rings_plain`; :func:`warp_rings_geometry` makes a
homography's rings on the card from K5's float64 derivation.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry import WarpGeometry, ring_map, warp_pads, window_corner
from ..resample import (WarpRings, amplified_linear_warp, branch_bits,
                        gauss_rings_planes, linear_rings_planes,
                        linear_warp_codes_plain,
                        nearest_warp_mask_host, pad2d, quantize_device,
                        rings_dtype, steering_gaussian_warp,
                        steering_warp_codes_plain, warp_rings_plain)
from . import _build
from .resize import BF16_FEATURE, IN_TYPES, TYPES_TAKEN

launches = 0
bf16_launches = 0
bf16_feature_launches = 0
rings_launches = 0
rings_geometry_launches = 0

# Frames one batch launch takes (kMaxFrames of csrc/steering_warp.cu):
# their parameters travel by value; a longer batch takes one launch a chunk.
MAX_FRAMES = 16

# K5's blocks: TILE output rows × columns, and the tile entries (footprint
# rows × columns × C) a block decodes into shared memory; a block whose
# footprint needs more takes the kernel's direct path.  Kept equal to
# kTileH, kTileW and kTileEntries of csrc/steering_warp.cu.
TILE = (16, 32)
TILE_ENTRIES = 2048


class WarpParams(NamedTuple):
    """One warp as K5 takes it: the homography ``matrix`` and its float64
    inverse ``inv`` (``np.linalg.inv``, as the host geometry makes it), the
    leading pads ``(pad_x[0], pad_y[0])`` of the host geometry
    (:func:`~lerf_torch.ops.geometry.warp_pads`), the sizes and the
    support.  The validity mask needs no pads of its own: at support 1 the
    geometry's are always 0."""
    matrix: Tuple[float, ...]   # 9, row-major
    inv: Tuple[float, ...]      # 9, row-major
    pad: Tuple[int, int]
    in_sz: Tuple[int, int]
    out_sz: Tuple[int, int]
    support: int = 2

    @classmethod
    def create(cls, in_sz, matrix, out_sz, support: int = 2):
        in_sz = tuple(int(s) for s in in_sz)
        out_sz = tuple(int(s) for s in out_sz)
        matrix = np.asarray(matrix, dtype=np.float64).reshape(3, 3)
        inv = np.linalg.inv(matrix)
        (px, _), (py, _) = warp_pads(inv, in_sz, out_sz, support)
        return cls(matrix=tuple(map(float, matrix.ravel())),
                   inv=tuple(map(float, inv.ravel())), pad=(px, py),
                   in_sz=in_sz, out_sz=out_sz, support=int(support))

    @classmethod
    def from_inverse(cls, in_sz, inv, out_sz, support: int = 2):
        """From the float64 inverse homography itself (the device-geometry
        forms' operand): K5 reads ``inv`` as given; ``matrix`` is its
        inverse, for the host geometry and mask of the plain twin."""
        in_sz = tuple(int(s) for s in in_sz)
        out_sz = tuple(int(s) for s in out_sz)
        inv = np.asarray(inv, dtype=np.float64).reshape(3, 3)
        (px, _), (py, _) = warp_pads(inv, in_sz, out_sz, support)
        return cls(matrix=tuple(map(float, np.linalg.inv(inv).ravel())),
                   inv=tuple(map(float, inv.ravel())), pad=(px, py),
                   in_sz=in_sz, out_sz=out_sz, support=int(support))

    def geometry(self) -> WarpGeometry:
        """The host geometry of the same warp (the plain twin's input)."""
        return WarpGeometry.create(self.in_sz,
                                   np.asarray(self.matrix).reshape(3, 3),
                                   self.out_sz, support=self.support)

    def host_mask(self, border: int = 4) -> np.ndarray:
        """The validity mask on the host (the plain twin of K5's), bool
        [oH, oW]."""
        return nearest_warp_mask_host(self.in_sz,
                                      np.asarray(self.matrix).reshape(3, 3),
                                      self.out_sz, border=border)


class WarpOperands(NamedTuple):
    """One warp geometry in the host's per-pixel form, per output pixel n
    (row-major over [oH, oW]): the corner of its S×S window in padded
    coordinates (:func:`~lerf_torch.ops.geometry.window_corner`), from
    which the S rows and the S columns clip into [0, in-1] as the geometry
    does, the 2S distances cast float64 → float32 once, and the linear
    kernel's branch bits of the float64 distances (bit 0 negative, bit 1
    positive)."""
    corners: torch.Tensor  # [N, 2] int32 (row, col), padded coordinates
    dis: torch.Tensor      # [N, 2S] float32 (dx_0..dx_S-1, dy_0..dy_S-1)
    masks: torch.Tensor    # [N, 2S] uint8, the same order
    pad: tuple             # (pad_x[0], pad_y[0]): padded → source index

    @classmethod
    def create(cls, geom: WarpGeometry, device):
        corners = np.stack([window_corner(geom.fov_x.astype(np.int64)),
                            window_corner(geom.fov_y.astype(np.int64))], -1)
        dis = np.concatenate([geom.dis_x, geom.dis_y], -1)
        n = 2 * geom.support

        def up(a, dt):
            return torch.from_numpy(np.ascontiguousarray(
                a.reshape(-1, a.shape[-1]), dt)).to(device)

        return cls(corners=up(corners, np.int32),
                   dis=up(dis.reshape(-1, n), np.float32),
                   masks=up(branch_bits(dis).reshape(-1, n), np.uint8),
                   pad=(int(geom.pad_x[0]), int(geom.pad_y[0])))


def footprint_entries(operands: WarpOperands, in_sz, out_sz,
                      channels: int) -> np.ndarray:
    """[blocks_y, blocks_x] int64: the shared-memory tile entries each K5
    block's footprint needs (the rectangle of padded rows × columns its
    outputs' windows read, × ``channels``), from the per-pixel operands;
    a block above :data:`TILE_ENTRIES` takes the kernel's direct path."""
    oh, ow = out_sz
    support = operands.dis.shape[1] // 2
    corners = operands.corners.cpu().numpy().astype(np.int64)
    corners = corners.reshape(oh, ow, 2)
    th, tw = TILE
    by, bx = -(-oh // th), -(-ow // tw)
    # ragged blocks: the cells past the output stay neutral
    lo = np.full((by * th, bx * tw, 2), np.iinfo(np.int64).max)
    hi = np.full((by * th, bx * tw, 2), np.iinfo(np.int64).min)
    for k, n in enumerate(in_sz):
        lo[:oh, :ow, k] = np.clip(corners[..., k], 0, n - 1)
        hi[:oh, :ow, k] = np.clip(corners[..., k] + support - 1, 0, n - 1)
    lo = lo.reshape(by, th, bx, tw, 2).min(axis=(1, 3))
    hi = hi.reshape(by, th, bx, tw, 2).max(axis=(1, 3))
    span = hi - lo + 1
    return span[..., 0] * span[..., 1] * channels


def rings_footprint_entries(rings, in_sz, out_sz,
                            channels: int) -> np.ndarray:
    """:func:`footprint_entries` of K5's rings instance: [tiles_y,
    tiles_x] tile entries each 16×32 output tile's footprint needs under
    ``rings`` (the rows × columns of the ±1-padded planes its outputs'
    windows read, × ``channels``); a tile above :data:`TILE_ENTRIES` takes
    the direct path."""
    oh, ow = out_sz
    corner = np.asarray(rings.corner).astype(np.int64).reshape(oh, ow)
    cx, cy = np.divmod(corner, int(in_sz[1]) + 3)
    th, tw = TILE
    by, bx = -(-oh // th), -(-ow // tw)
    spans = []
    for ring, at in ((np.asarray(rings.ring_x), cx),
                     (np.asarray(rings.ring_y), cy)):
        v = np.stack([ring[at], ring[at + 1]])
        # ragged blocks: the cells past the output stay neutral
        lo = np.full((by * th, bx * tw), np.iinfo(np.int64).max)
        hi = np.full((by * th, bx * tw), np.iinfo(np.int64).min)
        lo[:oh, :ow], hi[:oh, :ow] = v.min(0), v.max(0)
        spans.append(hi.reshape(by, th, bx, tw).max(axis=(1, 3))
                     - lo.reshape(by, th, bx, tw).min(axis=(1, 3)) + 1)
    return spans[0] * spans[1] * channels


def _inv_array(params: WarpParams):
    return (ctypes.c_double * 9)(*params.inv)


def _window(rows, out_sz) -> Tuple[int, int]:
    """``rows`` (``None``: the whole output) checked against ``out_sz``."""
    r0, r1 = (0, int(out_sz[0])) if rows is None else map(int, rows)
    if not 0 <= r0 <= r1 <= out_sz[0]:
        raise ValueError(f"rows [{r0}, {r1}) outside the output's "
                         f"{out_sz[0]}")
    return r0, r1


def _geometry_launch(params: WarpParams, device, ptrs, border: int):
    """``lerf_warp_geometry`` into ``ptrs`` (corners, dis, masks, valid;
    0 for a part not asked for), for the whole output."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"warp_geometry: the card's geometry needs a CUDA "
                         f"device, not {device}")
    (H, W), (OH, OW) = params.in_sz, params.out_sz
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lerf_warp_geometry(
            *ptrs, _inv_array(params), H, W, OH, OW, *params.pad,
            params.support, int(border), stream, 0, OH)
    _build.check(err, "warp_geometry launch")


def warp_geometry(params: WarpParams, device) -> WarpOperands:
    """The geometry K5 derives on the card, written out as
    :class:`WarpOperands` (``lerf_warp_geometry``): for the checks against
    the host's ``WarpOperands.create``.  Not on the main path."""
    (OH, OW), n = params.out_sz, 2 * params.support
    corners = torch.empty((OH * OW, 2), dtype=torch.int32, device=device)
    dis = torch.empty((OH * OW, n), dtype=torch.float32, device=device)
    masks = torch.empty((OH * OW, n), dtype=torch.uint8, device=device)
    _geometry_launch(params, device, (corners.data_ptr(), dis.data_ptr(),
                                      masks.data_ptr(), 0), border=0)
    return WarpOperands(corners=corners, dis=dis, masks=masks,
                        pad=tuple(params.pad))


def warp_mask(params: WarpParams, device, border: int = 4) -> torch.Tensor:
    """The validity mask K5 writes, alone (``lerf_warp_geometry`` with the
    geometry left out): bool [oH, oW] on the card, equal to
    ``nearest_warp_mask_host``.  For the checks; K5 writes the same in its
    own launch (``mask_out``)."""
    mask = torch.empty(params.out_sz, dtype=torch.bool, device=device)
    _geometry_launch(params, device, (0, 0, 0, mask.data_ptr()), border)
    return mask


def _check_args(feat, codes, linear, out_dtype, norm, what):
    if out_dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"{what}: out_dtype {out_dtype} is not float32 or "
                         "uint8")
    if out_dtype == torch.uint8 and not norm <= 255:
        raise ValueError(f"{what}: uint8 output needs norm <= 255, not "
                         f"{norm}")
    _, H, W = feat.shape
    oc = 1 if linear else 3
    if ((feat.dtype, codes.dtype) not in IN_TYPES
            or codes.shape != (feat.shape[0], H, W, oc)
            or codes.device != feat.device):
        raise ValueError(f"{what}: feat [C,H,W] and codes [C,H,W,{oc}] "
                         f"({'linear' if linear else 'Gaussian'} mode) of one "
                         f"type, {TYPES_TAKEN}, on one device")
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {feat.device}")


def _plain(feat, codes, geom, *, max_sigma, norm, linear):
    """The twin of K5 on a host geometry (or its rows), for either input
    type."""
    if feat.dtype == torch.int32:
        if linear:
            return linear_warp_codes_plain(feat, codes, geom, norm=norm)
        return steering_warp_codes_plain(feat, codes, geom,
                                         max_sigma=max_sigma, norm=norm)
    if linear:
        return amplified_linear_warp(feat, codes[..., 0], geom)
    return steering_gaussian_warp(feat, codes[..., 0], codes[..., 1],
                                  codes[..., 2], geom, max_sigma=max_sigma)


def _check_mask(mask_out, shape, device, what):
    if mask_out is not None and (
            mask_out.dtype not in (torch.bool, torch.uint8)
            or tuple(mask_out.shape) != tuple(shape)
            or mask_out.device != device or not mask_out.is_contiguous()):
        raise ValueError(f"{what}: mask_out must be a contiguous bool or "
                         f"uint8 {list(shape)} tensor on {device}")


def _launch(feat, codes, out, mask, warps, *, max_sigma, norm, linear,
            border, rows):
    """One ``lerf_steering_warp_batch`` launch over ``warps`` (at most
    :data:`MAX_FRAMES`) for output rows ``rows`` = (r0, r1): feat / codes /
    out hold their frames one after another along the channel axis, out
    [frames·C, r1 - r0, oW], ``mask`` [frames, r1 - r0, oW] or None."""
    global launches, bf16_launches, bf16_feature_launches
    first = warps[0]
    (H, W), (OH, OW) = first.in_sz, first.out_sz
    r0, r1 = rows
    invs = (ctypes.c_double * (9 * len(warps)))(
        *(v for w in warps for v in w.inv))
    pads = (ctypes.c_int * (2 * len(warps)))(
        *(p for w in warps for p in w.pad))
    lib = _build.library()
    with torch.cuda.device(feat.device):    # launch on the tensors' card
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lerf_steering_warp_batch(
            feat.data_ptr(), codes.data_ptr(), out.data_ptr(),
            0 if mask is None else mask.data_ptr(), invs, pads, len(warps),
            feat.shape[0] // len(warps), H, W, OH, OW, first.support,
            int(linear), float(max_sigma), float(norm),
            int(out.dtype == torch.uint8), int(border), stream,
            IN_TYPES[feat.dtype, codes.dtype], r0, r1 - r0)
    _build.check(err, "steering_warp_batch launch")
    _count(feat, codes)


def _count(feat, codes, rings: bool = False):
    """One launch of K5 on this pair of types into the counts."""
    global launches, bf16_launches, bf16_feature_launches, rings_launches
    launches += 1
    rings_launches += int(rings)
    bf16_launches += int(codes.dtype == torch.bfloat16)
    bf16_feature_launches += int(
        IN_TYPES[feat.dtype, codes.dtype] == BF16_FEATURE)


def steering_warp(feat: torch.Tensor, codes: torch.Tensor, warp, *,
                  max_sigma: float = 10.0, norm: int = 255,
                  linear: bool = False,
                  out_dtype: torch.dtype = torch.float32,
                  mask_out: Optional[torch.Tensor] = None, border: int = 4,
                  rows: Optional[Tuple[int, int]] = None):
    """Feature [C, H, W] + hyper codes [C, H, W, 3] (Gaussian) or [C, H,
    W, 1] (``linear``), both int32 (codes 0..norm), both float32 or both
    bf16 (hyper maps in [0, 1]), or one float32 and the other bf16
    → [C, oH, oW]: float32 (NaN where a
    window's weights all vanish), or with ``out_dtype=torch.uint8``
    (``norm`` ≤ 255) the frame with NaN → 0, rounded half to even, clipped
    to 0..norm and cast, as :func:`~lerf_torch.ops.resample.quantize_device`
    with ``nan_to_zero`` does.  ``warp``: :class:`WarpParams` (the card
    takes nothing else; the CPU twin makes its host geometry from it), or
    for CPU tensors a :class:`~lerf_torch.ops.geometry.WarpGeometry`.

    ``mask_out``: a bool (or uint8) [oH, oW] tensor on the same device that
    receives the validity mask of ``border`` (K5 writes it in the same
    launch; on the CPU the host mask, ``WarpParams.host_mask``).

    ``rows``: ``(r0, r1)``, output rows ``[r0, r1)`` of ``warp``'s output
    alone → [C, r1 - r0, oW] (and ``mask_out`` [r1 - r0, oW]), each row
    bit-equal to the same row of the whole call's on the card; ``None``:
    the whole output."""
    C, H, W = feat.shape
    _check_args(feat, codes, linear, out_dtype, norm, "steering_warp")
    if tuple(warp.in_sz) != (H, W):
        raise ValueError(f"geometry is for {warp.in_sz}, image is {(H, W)}")
    r0, r1 = _window(rows, warp.out_sz)
    out_sz = (r1 - r0, warp.out_sz[1])
    _check_mask(mask_out, out_sz, feat.device, "steering_warp")
    if mask_out is not None and not isinstance(warp, WarpParams):
        raise ValueError("steering_warp: the mask needs WarpParams (the "
                         "matrix), not a host geometry")
    if feat.device.type == "cpu":
        if mask_out is not None:
            mask_out.copy_(torch.from_numpy(warp.host_mask(border)[r0:r1]))
        geom = warp.geometry() if isinstance(warp, WarpParams) else warp
        if rows is not None:
            geom = geom.rows(r0, r1)
        out = _plain(feat, codes, geom, max_sigma=max_sigma, norm=norm,
                     linear=linear)
        return quantize_device(out, norm, nan_to_zero=True) \
            if out_dtype == torch.uint8 else out.to(torch.float32)
    if not isinstance(warp, WarpParams):
        raise ValueError("steering_warp: on a card K5 takes WarpParams (the "
                         "matrix), not a host geometry")
    feat, codes = feat.contiguous(), codes.contiguous()
    out = torch.empty((C, *out_sz), dtype=out_dtype, device=feat.device)
    _launch(feat, codes, out, mask_out, [warp], max_sigma=max_sigma,
            norm=norm, linear=linear, border=border, rows=(r0, r1))
    return out


def steering_warp_batch(feat: torch.Tensor, codes: torch.Tensor,
                        warps: Sequence[WarpParams], *,
                        max_sigma: float = 10.0, norm: int = 255,
                        linear: bool = False,
                        out_dtype: torch.dtype = torch.float32,
                        mask_out: Optional[torch.Tensor] = None,
                        border: int = 4,
                        rows: Optional[Tuple[int, int]] = None):
    """A batch of B frames, each under its own homography (the port of
    lerf_tpu's ``jax.vmap`` of its warp over per-frame operands): int32
    feature [B·C, H, W] and codes [B·C, H, W, 3 or 1], the frames one after
    another along the channel axis, and one :class:`WarpParams` a frame, all
    at one input and output size and support (or float32 feature and hyper
    maps, as :func:`steering_warp` takes them) → [B·C, oH, oW] as
    :func:`steering_warp` gives each frame; ``mask_out`` [B, oH, oW]
    receives the frames' validity masks.  On the card one launch for up to
    :data:`MAX_FRAMES` frames; on the CPU the plain twin frame by frame.
    ``rows``: a window of output rows, as :func:`steering_warp` takes it
    (out [B·C, r1 - r0, oW], ``mask_out`` [B, r1 - r0, oW])."""
    warps = list(warps)
    n = len(warps)
    if n == 0 or feat.shape[0] % n:
        raise ValueError(f"steering_warp_batch: {feat.shape[0]} channels do "
                         f"not split into {n} frames")
    C, H, W = feat.shape[0] // n, feat.shape[1], feat.shape[2]
    _check_args(feat, codes, linear, out_dtype, norm, "steering_warp_batch")
    first = warps[0]
    for w in warps:
        if not isinstance(w, WarpParams):
            raise ValueError("steering_warp_batch: one WarpParams a frame")
        if (tuple(w.in_sz), tuple(w.out_sz), w.support) != (
                (H, W), tuple(first.out_sz), first.support):
            raise ValueError("steering_warp_batch: every frame needs the "
                             f"image size {(H, W)}, one output size and one "
                             "support")
    r0, r1 = _window(rows, first.out_sz)
    OH, OW = r1 - r0, first.out_sz[1]
    _check_mask(mask_out, (n, OH, OW), feat.device, "steering_warp_batch")
    if feat.device.type == "cpu":
        return torch.cat([steering_warp(
            feat[f * C:(f + 1) * C], codes[f * C:(f + 1) * C], w,
            max_sigma=max_sigma, norm=norm, linear=linear,
            out_dtype=out_dtype,
            mask_out=None if mask_out is None else mask_out[f],
            border=border, rows=rows) for f, w in enumerate(warps)])
    feat, codes = feat.contiguous(), codes.contiguous()
    out = torch.empty((n * C, OH, OW), dtype=out_dtype, device=feat.device)
    for f0 in range(0, n, MAX_FRAMES):
        f1 = min(f0 + MAX_FRAMES, n)
        _launch(feat[f0 * C:f1 * C], codes[f0 * C:f1 * C],
                out[f0 * C:f1 * C],
                None if mask_out is None else mask_out[f0:f1], warps[f0:f1],
                max_sigma=max_sigma, norm=norm, linear=linear, border=border,
                rows=(r0, r1))
    return out


# -- the warp's geometry as data: K5's rings instance -----------------------


class DeviceRings(NamedTuple):
    """A :class:`~lerf_torch.ops.resample.WarpRings` on the card, as the
    rings instance reads it: the ring maps, the corner and the distances
    as float32 (bf16 ones widened exactly), their own type in ``dtype``,
    and in the linear mode each output's branch bits packed in one byte
    (bits 2s, 2s + 1 the row distance s's negative and positive branch,
    bits 4 + 2t, 5 + 2t the column distance t's)."""
    ring_x: torch.Tensor            # [H+4] int32
    ring_y: torch.Tensor            # [W+4] int32
    corner: torch.Tensor            # [N] int32
    dis_x: torch.Tensor             # [N, 2] float32
    dis_y: torch.Tensor             # [N, 2] float32
    bits: Optional[torch.Tensor]    # [N] uint8, linear only
    dtype: torch.dtype = torch.float32   # the rings' distance type


def _host(a) -> np.ndarray:
    """A leaf as a numpy array on the host (a tensor's float copy)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def _branch_byte(masks_x, masks_y) -> np.ndarray:
    """The (neg, pos) [N, 2] masks of both axes packed on the host as
    :class:`DeviceRings` lays its bits out: uint8 [N]."""
    def pair(neg, pos):
        return ((_host(neg) != 0).astype(np.uint8)
                | ((_host(pos) != 0).astype(np.uint8) << 1))

    bx, by = pair(*masks_x), pair(*masks_y)
    return np.ascontiguousarray(
        (bx[:, 0] | (bx[:, 1] << 2) | (by[:, 0] << 4) | (by[:, 1] << 6))
        .astype(np.uint8))


def upload_rings(rings, device, *, linear: bool = False) -> DeviceRings:
    """``rings`` on the card ``device``, once: each host leaf (numpy or a
    CPU tensor) through pinned memory, copied without blocking on the
    device's current stream; a leaf already on the card is used as it is
    (cast where its type differs).  ``linear``: the branch masks packed
    on the host into one byte an output (:func:`_branch_byte`; masks on
    the card come to the host for it), then uploaded as the rest."""
    if isinstance(rings, DeviceRings):
        return rings
    device = torch.device(device)
    dtype = rings_dtype(rings)

    def up(a, dt):
        t = torch.as_tensor(a)
        if t.device.type == "cuda":
            return t.to(device, dt).contiguous()
        t = t.to(dt).contiguous().pin_memory()
        with torch.cuda.device(device):
            return t.to(device, non_blocking=True)

    bits = None
    if linear:
        if rings.masks_x is None:
            raise ValueError("the linear warp needs rings built with "
                             "linear=True (their branch masks)")
        bits = up(_branch_byte(rings.masks_x, rings.masks_y), torch.uint8)
    return DeviceRings(up(rings.ring_x, torch.int32),
                       up(rings.ring_y, torch.int32),
                       up(rings.corner, torch.int32),
                       up(rings.dis_x, torch.float32),
                       up(rings.dis_y, torch.float32), bits, dtype)


# The rings instance's type code for a bf16 feature and bf16 maps under
# float32 rings (lerf_torch/csrc/steering_warp.cu::lerf_steering_warp_rings):
# the maps decoded in bf16, then the weights, the sums and the output in
# float32, as lerf_tpu promotes bf16 maps against float32 distances.
RINGS_BF16_WIDE = 4


def rings_in_type(feat: torch.Tensor, codes: torch.Tensor,
                  dtype: torch.dtype):
    """The rings instance's ``in_type`` for the input pair and the rings'
    distance type ``dtype``: the pair's :data:`IN_TYPES` code, or
    :data:`RINGS_BF16_WIDE` for bf16 maps beside a bf16 feature under
    float32 rings.  The weights take the type lerf_tpu's promotion gives
    them: bf16 only where the feature, the maps and the rings all are;
    under bf16 rings every other pair takes its float32 instance (the
    distances widen exactly at their first product with a float32 value,
    as in lerf_tpu, whose packed operand is float32 wherever one plane
    is)."""
    pair = IN_TYPES[feat.dtype, codes.dtype]
    if dtype == torch.float32 and pair == IN_TYPES[torch.bfloat16,
                                                   torch.bfloat16]:
        return RINGS_BF16_WIDE
    return pair


def _check_rings(rings, H, W, out_sz, linear, what) -> Tuple[int, int]:
    """The rings' shapes against the image and ``out_sz``; returns the
    output's (rows, columns): ``out_sz``, or (1, N) for the flat form."""
    n = len(rings.corner)
    if (tuple(rings.ring_x.shape) != (H + 4,)
            or tuple(rings.ring_y.shape) != (W + 4,)):
        raise ValueError(f"{what}: ring_x / ring_y of {tuple(rings.ring_x.shape)}"
                         f" / {tuple(rings.ring_y.shape)} entries, the "
                         f"{H}x{W} image needs ({H + 4},) / ({W + 4},)")
    if (tuple(rings.dis_x.shape) != (n, 2)
            or tuple(rings.dis_y.shape) != (n, 2)):
        raise ValueError(f"{what}: support-2 distances [N, 2] for N = {n} "
                         "corners")
    rings_dtype(rings)
    if linear and isinstance(rings, DeviceRings):
        if rings.bits is None:
            raise ValueError(f"{what}: linear DeviceRings need their bits")
    elif linear and rings.masks_x is None:
        raise ValueError(f"{what}: the linear warp needs rings built with "
                         "linear=True (their branch masks)")
    if out_sz is None:
        return 1, n
    oh, ow = (int(v) for v in out_sz)
    if oh * ow != n:
        raise ValueError(f"{what}: out_sz {oh}x{ow} for {n} corners")
    return oh, ow


def steering_warp_rings_plain(feat: torch.Tensor, codes: torch.Tensor,
                              rings: WarpRings, *, max_sigma: float = 10.0,
                              norm: int = 255, linear: bool = False):
    """The twin of K5's rings instance, on any device: the feature
    constant-padded and the codes or maps edge-padded by one, gathered
    through ``rings`` (:func:`~lerf_torch.ops.resample.warp_rings_plain`);
    int32 codes decoded ``code / norm`` after the gather, float maps
    decoded before it.  Returns float [C, N]."""
    if feat.dtype == torch.int32:
        planes = [pad2d(feat, (1, 1), (1, 1))] + [
            pad2d(codes[..., k], (1, 1), (1, 1), "edge")
            for k in range(codes.shape[-1])]
        return warp_rings_plain(planes, rings, linear=linear,
                                max_sigma=max_sigma, u8_inputs=True,
                                norm=norm)
    if linear:
        planes = linear_rings_planes(feat, codes[..., 0], max_alpha=1.0,
                                     u8_inputs=False)
    else:
        planes = gauss_rings_planes(feat, codes[..., 0], codes[..., 1],
                                    codes[..., 2], max_sigma=max_sigma,
                                    u8_inputs=False)
    return warp_rings_plain(planes, rings, linear=linear,
                            max_sigma=max_sigma)


def steering_warp_rings(feat: torch.Tensor, codes: torch.Tensor, rings, *,
                        out_sz=None, max_sigma: float = 10.0,
                        norm: int = 255, linear: bool = False,
                        out_dtype: torch.dtype = torch.float32):
    """K5's rings instance: the warp of feature [C, H, W] and codes [C, H,
    W, 3] (Gaussian) or [C, H, W, 1] (``linear``), in the pairs of types
    :func:`steering_warp` takes, through ``rings`` (a
    :class:`~lerf_torch.ops.resample.WarpRings` of the H×W image, support 2;
    ``linear`` needs its branch masks) → [C, N] (``out_sz`` None) or [C,
    oH, oW]: float32, or uint8 with ``out_dtype=torch.uint8`` as
    :func:`steering_warp` writes it.  The rings' type sets the weights'
    (:func:`rings_in_type`): bf16 maps under float32 rings are decoded in
    bf16 and weighted, summed and divided in float32; beside a bf16
    feature under bf16 rings they take the bf16 instance; every other pair
    is weighted in float32 under either rings type.  On CPU tensors the
    plain twin (:func:`steering_warp_rings_plain`); on CUDA tensors one
    launch, the rings' host leaves uploaded first (:func:`upload_rings`),
    never the twin.  For the card's layout give ``out_sz``: without it the
    outputs are one row, each block 32 of them."""
    C, H, W = feat.shape
    _check_args(feat, codes, linear, out_dtype, norm, "steering_warp_rings")
    oh, ow = _check_rings(rings, H, W, out_sz, linear, "steering_warp_rings")
    shape = (C, oh * ow) if out_sz is None else (C, oh, ow)
    in_type = rings_in_type(feat, codes, rings_dtype(rings))
    if feat.device.type == "cpu":
        if isinstance(rings, DeviceRings):
            raise ValueError("steering_warp_rings: DeviceRings on the CPU")
        out = steering_warp_rings_plain(feat, codes, rings,
                                        max_sigma=max_sigma, norm=norm,
                                        linear=linear).reshape(shape)
        return quantize_device(out, norm, nan_to_zero=True) \
            if out_dtype == torch.uint8 else out.to(torch.float32)
    dr = upload_rings(rings, feat.device, linear=linear)
    feat, codes = feat.contiguous(), codes.contiguous()
    out = torch.empty(shape, dtype=out_dtype, device=feat.device)
    lib = _build.library()
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lerf_steering_warp_rings(
            feat.data_ptr(), codes.data_ptr(), out.data_ptr(),
            dr.ring_x.data_ptr(), dr.ring_x.numel(), dr.ring_y.data_ptr(),
            dr.ring_y.numel(), dr.corner.data_ptr(), dr.dis_x.data_ptr(),
            dr.dis_y.data_ptr(), 0 if dr.bits is None else dr.bits.data_ptr(),
            C, H, W, oh, ow, int(linear), float(max_sigma), float(norm),
            int(out_dtype == torch.uint8), stream, in_type)
    _build.check(err, "steering_warp_rings launch")
    _count(feat, codes, rings=True)
    return out


def rings_blocks_per_sm() -> int:
    """The rings instance's persistent blocks an SM, as the kernel
    library was built with them (``kRingsBlocks`` of
    ``csrc/steering_warp.cu``, read through its C entry)."""
    return int(_build.library().lerf_rings_blocks_per_sm())


def rings_grid(out_sz, device=None) -> int:
    """The blocks K5's rings instance launches for an ``out_sz`` output on
    the card ``device`` (default: the current one): its persistent grid,
    min(16×32 tiles, SMs × :func:`rings_blocks_per_sm`)."""
    oh, ow = out_sz
    tiles = -(-int(oh) // TILE[0]) * -(-int(ow) // TILE[1])
    sms = torch.cuda.get_device_properties(
        device or torch.cuda.current_device()).multi_processor_count
    return min(tiles, sms * rings_blocks_per_sm())


def launch_rings_geometry(params: WarpParams, corner: torch.Tensor,
                          dis_x: torch.Tensor, dis_y: torch.Tensor) -> None:
    """One launch of K5's rings geometry (``lerf_warp_rings_geometry``) on
    the current stream of the card the outputs lie on: each output's
    corner (int32 [N]) and float32 distances ([N, 2] each) of the
    homography ``params`` holds, written into the tensors given.  Counts
    ``rings_geometry_launches``."""
    global rings_geometry_launches
    (H, W), (OH, OW) = params.in_sz, params.out_sz
    n = OH * OW
    if (params.support != 2 or corner.shape != (n,)
            or dis_x.shape != (n, 2) or dis_y.shape != (n, 2)
            or corner.dtype != torch.int32
            or dis_x.dtype != torch.float32 or dis_y.dtype != torch.float32
            or corner.device.type != "cuda"):
        raise ValueError("launch_rings_geometry: support 2, int32 corner "
                         f"[{n}] and float32 distances [{n}, 2] on a card")
    lib = _build.library()
    with torch.cuda.device(corner.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lerf_warp_rings_geometry(
            corner.data_ptr(), dis_x.data_ptr(), dis_y.data_ptr(),
            _inv_array(params), H, W, OH, OW, *params.pad, stream)
    _build.check(err, "warp_rings_geometry launch")
    rings_geometry_launches += 1


def warp_rings_geometry(inv, in_sz, out_sz, device) -> WarpRings:
    """The rings of the homography whose float64 inverse is ``inv``, made
    on the card ``device`` from K5's float64 derivation: the corner and
    distances per output by one launch (:func:`launch_rings_geometry`),
    the ring maps from the support-2 geometry's leading pads on the host
    (H + 4 and W + 4 values, copied up); a
    :class:`~lerf_torch.ops.resample.WarpRings` of CUDA tensors equal to
    the host's ``warp_rings(WarpOperands.create(...))``.  Its plain twin
    is :func:`~lerf_torch.ops.geometry.warp_rings_operands_plain`."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"warp_rings_geometry: needs a CUDA device, not "
                         f"{device}")
    params = WarpParams.from_inverse(in_sz, inv, out_sz)
    (H, W), (OH, OW) = params.in_sz, params.out_sz
    n = OH * OW
    corner = torch.empty(n, dtype=torch.int32, device=device)
    dis_x = torch.empty((n, 2), dtype=torch.float32, device=device)
    dis_y = torch.empty((n, 2), dtype=torch.float32, device=device)
    launch_rings_geometry(params, corner, dis_x, dis_y)
    ring_x, ring_y = (torch.from_numpy(ring_map(n_in, p0)).to(device)
                      for n_in, p0 in zip((H, W), params.pad))
    return WarpRings(ring_x, ring_y, corner, dis_x, dis_y)
