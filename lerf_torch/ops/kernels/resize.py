"""K1 wrapper: steerable resize from the stage outputs.

``steering_resize`` runs the plain twin
(:func:`lerf_torch.ops.resample.steering_resize_codes_plain`, or in the
amplified-linear mode :func:`~lerf_torch.ops.resample.linear_resize_codes_plain`,
then :func:`~lerf_torch.ops.resample.quantize_device` for uint8) for CPU
tensors and launches ``csrc/steering_resize.cu`` for CUDA tensors; it never
falls back from the card to the plain version.  ``steering_resize_serving``
is the same kernel on the dynamic-scale serving geometry
(:class:`lerf_torch.ops.geometry.ResizeOperands`), whose plain form is the
rings resize.  ``launches`` counts kernel launches of any instance,
``bf16_launches`` those of the instances that take bf16 maps,
``bf16_feature_launches`` those of the instance that takes a bf16 feature
beside float32 maps.

The mode follows the hyper codes: the steerable Gaussian (LeRF-G) takes
three codes a pixel (ρ, σx, σy), the amplified-linear kernel (LeRF-L,
``linear=True``) one (α).  The stage outputs come in one of five pairs of
types (:data:`IN_TYPES`): int32 feature and int32 codes (the LUT and SRNet
forms, decoded as ``code / norm``), float32 or bf16 feature and hyper maps
in [0, 1] (the IMDN form, in its towers' compute type), a float32 feature
with bf16 maps (the bf16 IMDN form without its feature tower), or a bf16
feature with float32 maps.  The float types' twins are lerf_tpu's float
ops, :func:`~lerf_torch.ops.resample.steering_gaussian_resize` /
:func:`~lerf_torch.ops.resample.amplified_linear_resize` and their rings
forms, run on the inputs as they are (bf16: each operation rounded to
bf16, as lerf_tpu runs its resize in ``img.dtype``; bf16 maps beside a
float32 feature: decoded in bf16, the rest promoted to float32; a bf16
feature beside float32 maps: the distances and ``min_scale`` in bf16, the
feature widened, the rest float32).  A float32 output of bf16 inputs is
the twin's result widened (the Gaussian's bf16 quotient; the linear
mode's weights are float32 already).

``steering_resize_train`` is the training step's resize, differentiable in
the feature and the hyper maps: on a card a ``torch.autograd.Function``
whose forward is K1's float mode (float32 out) and whose backward is K6
(:mod:`lerf_torch.ops.kernels.resize_bwd`); on the CPU the plain float op,
whose autograd is the CPU path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import geometry as geo
from ..resample import (amplified_linear_resize,
                        amplified_linear_resize_rings, branch_bits,
                        linear_resize_codes_plain, quantize_device,
                        resize_codes_rings_plain, resize_rings,
                        steering_gaussian_resize,
                        steering_gaussian_resize_rings,
                        steering_resize_codes_plain)
from . import _build

launches = 0
bf16_launches = 0
bf16_feature_launches = 0

# Output tiles (rows, columns) a block may take, a thread taking 4 adjacent
# columns of one row.  The host picks one per geometry so the tile's source
# window fits in shared memory (or, failing that, one row of it).  16 x 32 (128 threads) is the largest: at
# x4 it beat 16 x 64, 32 x 32 and 8 x 64 on the H100 (probe_lut_kernels).
TILES = ((16, 32), (8, 32), (4, 32), (4, 16), (2, 16), (2, 8), (1, 8),
         (1, 4), (1, 1))
WINDOW_BYTES = 16                  # float4 {feature, 2 rho, sx, sy}
LINEAR_WINDOW_BYTES = 8            # float2 {feature, alpha}
# (bf16 inputs take half of each: a tile picked for the float entries fits)
BLOCK_SMEM_MAX = 232448            # H100: the opt-in limit of one block
SM_SMEM = 233472                   # H100: shared memory of one SM
SM_THREADS = 2048


def _window_span(fov: np.ndarray, tile: int) -> int:
    """The largest source span (in pixels) that ``tile`` consecutive
    outputs of a monotone field of view ``[O, S]`` read."""
    starts = np.arange(0, fov.shape[0], tile)
    ends = np.minimum(starts + tile, fov.shape[0]) - 1
    return int((fov[ends, -1] - fov[starts, 0]).max()) + 1


def pick_tile(rows: np.ndarray, cols: np.ndarray,
              entry_bytes: int = WINDOW_BYTES):
    """(tile_h, tile_w, window rows, window cols) for K1.  Of the tiles
    whose whole source window fits one block's shared memory, the one that
    keeps the most threads resident on an SM, then the largest.  Where none
    fits (S ≥ 122: even one output's S × S window is too large), the
    largest tile one of whose window rows fits, holding as many rows as
    fit: the kernel walks the window in strips of that many rows."""
    for fov in (rows, cols):
        if (np.any(np.diff(fov[:, 0]) < 0)
                or np.any(fov != fov[:, :1] + np.arange(fov.shape[1]))):
            raise ValueError("K1 needs a monotone field of view")
    best = strips = None
    for th, tw in TILES:
        wr, wc = _window_span(rows, th), _window_span(cols, tw)
        row_bytes = wc * entry_bytes
        if wr * row_bytes > BLOCK_SMEM_MAX:
            if strips is None and row_bytes <= BLOCK_SMEM_MAX:
                strips = (th, tw, BLOCK_SMEM_MAX // row_bytes, wc)
            continue
        threads = th * -(-tw // 4)
        per_sm = min(SM_THREADS // threads, 32,
                     SM_SMEM // (wr * row_bytes + 1024))
        key = (per_sm * threads, threads)
        if best is None or key > best[0]:
            best = (key, (th, tw, wr, wc))
    if best is not None:
        return best[1]
    if strips is None:
        raise ValueError("K1: one row of the source window exceeds shared "
                         "memory (support too large)")
    return strips


class ResizeOperands(NamedTuple):
    """One geometry's field of view on the device, in one mode: source
    rows / cols in unpadded coordinates (int32, may fall outside the image
    — the kernel maps the pads), and on a card K1's tile with its source
    window (:func:`pick_tile`).  The Gaussian mode takes the distances
    cast float64 → float32 (``dis_*``; K1 scales them by ``min_scale``
    itself on an antialiased downscale, as the JAX path does); the linear
    mode takes ``lin_*`` = float32(``min_scale``·dis) scaled in float64,
    with the branch masks of those float64 values (``mask_*``, bit 0
    negative, bit 1 positive, :func:`~lerf_torch.ops.resample.branch_bits`).
    ``in_sz``, ``out_sz``, ``support``, ``antialias`` and ``min_scale``
    are the geometry's."""
    rows: torch.Tensor     # [OH, S]
    cols: torch.Tensor     # [OW, S]
    dis_x: Optional[torch.Tensor]    # [OH, S] Gaussian mode
    dis_y: Optional[torch.Tensor]    # [OW, S]
    lin_x: Optional[torch.Tensor]    # [OH, S] linear mode
    lin_y: Optional[torch.Tensor]    # [OW, S]
    mask_x: Optional[torch.Tensor]   # [OH, S] uint8, linear mode
    mask_y: Optional[torch.Tensor]   # [OW, S]
    tile: Optional[tuple]  # (tile_h, tile_w, window rows, window cols)
    in_sz: tuple
    out_sz: tuple
    support: int
    antialias: bool
    min_scale: float
    linear: bool

    @classmethod
    def create(cls, geom: geo.ResizeGeometry, device, linear: bool = False):
        """From a static :class:`~lerf_torch.ops.geometry.ResizeGeometry`."""
        return cls._from_axes(
            geom.fov_x.astype(np.int64) - geom.pad_x[0],
            geom.fov_y.astype(np.int64) - geom.pad_y[0], geom.dis_x,
            geom.dis_y, in_sz=tuple(geom.in_sz), out_sz=tuple(geom.out_sz),
            antialias=geom.antialias, min_scale=geom.min_scale,
            linear=linear, device=device)

    @classmethod
    def from_serving(cls, ops: geo.ResizeOperands, device,
                     linear: bool = False):
        """From the serving geometry: its true support only (a support
        bucket's extra slots carry zero weight, and adding zeros changes no
        sum), rows and columns moved from the ±pad frame to unpadded
        coordinates — the static geometry's own operands."""
        s = ops.true_support
        offs = np.arange(s, dtype=np.int64)[None, :]
        return cls._from_axes(
            ops.idx_x.astype(np.int64)[:, None] + offs - ops.pad,
            ops.idx_y.astype(np.int64)[:, None] + offs - ops.pad,
            ops.dis_x[:, :s], ops.dis_y[:, :s],
            in_sz=tuple(ops.in_sz), out_sz=tuple(ops.out_sz),
            antialias=ops.aa_scale < 1.0, min_scale=ops.aa_scale,
            linear=linear, device=device)

    @classmethod
    def _from_axes(cls, rows, cols, dis_x, dis_y, *, in_sz, out_sz,
                   antialias, min_scale, linear, device):
        def up(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

        gauss = lin = (None, None, None, None)
        if linear:
            m64 = min_scale if antialias else 1.0
            lx, ly = m64 * dis_x, m64 * dis_y          # float64
            lin = (up(lx, np.float32), up(ly, np.float32),
                   up(branch_bits(lx), np.uint8), up(branch_bits(ly), np.uint8))
        else:
            gauss = (up(dis_x, np.float32), up(dis_y, np.float32))
        tile = (pick_tile(rows, cols, LINEAR_WINDOW_BYTES if linear
                          else WINDOW_BYTES)
                if torch.device(device).type == "cuda" else None)
        return cls(rows=up(rows, np.int32), cols=up(cols, np.int32),
                   dis_x=gauss[0], dis_y=gauss[1], lin_x=lin[0],
                   lin_y=lin[1], mask_x=lin[2], mask_y=lin[3], tile=tile,
                   in_sz=tuple(in_sz), out_sz=tuple(out_sz),
                   support=int(rows.shape[1]), antialias=bool(antialias),
                   min_scale=float(min_scale), linear=bool(linear))

    def rows_window(self, r0: int, r1: int) -> "ResizeOperands":
        """Output rows ``[r0, r1)`` alone: the row axis's operands sliced
        (views, nothing copied), ``out_sz`` the window's and the tile
        picked again for it (from the rows and columns read back once: a
        sharded path makes its windows once a geometry).  K1 indexes its
        operands by output row, so
        the window's launch computes those rows of the whole resize, each
        bit-equal to the whole launch's; the plain twin of a window is the
        plain resize on the geometry's rows (``ResizeGeometry.rows``, or
        the serving geometry's ``ResizeOperands.rows``)."""
        if not 0 <= r0 < r1 <= self.out_sz[0]:
            raise ValueError(f"rows [{r0}, {r1}): not a window of the "
                             f"output's {self.out_sz[0]}")

        def cut(t):
            return None if t is None else t[r0:r1]

        tile = None if self.tile is None else pick_tile(
            self.rows[r0:r1].cpu().numpy(), self.cols.cpu().numpy(),
            LINEAR_WINDOW_BYTES if self.linear else WINDOW_BYTES)
        return self._replace(
            rows=cut(self.rows), dis_x=cut(self.dis_x), lin_x=cut(self.lin_x),
            mask_x=cut(self.mask_x), tile=tile,
            out_sz=(r1 - r0, self.out_sz[1]))


# The (feature, hyper) types K1 and K5 take, by the code their C entries
# take (in_type; 4 is the rings instance's own, bf16 maps under float32
# rings: kernels/warp.py::rings_in_type)
IN_TYPES = {(torch.int32, torch.int32): 0,
            (torch.float32, torch.float32): 1,
            (torch.bfloat16, torch.bfloat16): 2,
            (torch.float32, torch.bfloat16): 3,
            (torch.bfloat16, torch.float32): 5}
TYPES_TAKEN = ("int32 (codes 0..norm), float32 or bf16 (hyper maps in "
               "[0, 1]), or one float32 and the other bf16")
BF16_FEATURE = IN_TYPES[torch.bfloat16, torch.float32]


def _check(feat, codes, norm, linear, out_dtype, what):
    if out_dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"{what}: out_dtype {out_dtype} is not float32 or "
                         "uint8")
    if out_dtype == torch.uint8 and not norm <= 255:
        raise ValueError(f"{what}: uint8 output needs norm <= 255, not "
                         f"{norm}")
    C, H, W = feat.shape
    oc = 1 if linear else 3
    if ((feat.dtype, codes.dtype) not in IN_TYPES
            or codes.shape != (C, H, W, oc) or codes.device != feat.device):
        raise ValueError(f"{what}: feat [C,H,W] and codes [C,H,W,{oc}] "
                         f"({'linear' if linear else 'Gaussian'} mode) of one "
                         f"type, {TYPES_TAKEN}, on one device")


def _plain(feat, codes, geom, *, max_sigma, norm, linear):
    """The twin of K1 on the static geometry, for either input type."""
    if feat.dtype == torch.int32:
        return (linear_resize_codes_plain(feat, codes, geom, norm=norm)
                if linear else steering_resize_codes_plain(
                    feat, codes, geom, max_sigma=max_sigma, norm=norm))
    if linear:
        return amplified_linear_resize(feat, codes[..., 0], geom)
    return steering_gaussian_resize(feat, codes[..., 0], codes[..., 1],
                                    codes[..., 2], geom, max_sigma=max_sigma)


def _plain_serving(feat, codes, ops, *, max_sigma, norm, linear):
    """The twin of K1 on the serving geometry (the rings resize)."""
    rings = resize_rings(ops, linear=linear)
    if feat.dtype == torch.int32:
        return resize_codes_rings_plain(feat, codes, rings, linear=linear,
                                        max_sigma=max_sigma, norm=norm,
                                        pad=ops.pad)
    if linear:
        return amplified_linear_resize_rings(feat, codes[..., 0], rings,
                                             pad=ops.pad)
    return steering_gaussian_resize_rings(
        feat, codes[..., 0], codes[..., 1], codes[..., 2], rings,
        max_sigma=max_sigma, pad=ops.pad)


def _finish(out, norm, linear, out_dtype):
    """The plain form of K1's epilogue: the linear mode maps a 0/0 window
    (NaN) to 0 before the cast, as the kernel does; a bf16 result widens
    to float32."""
    return quantize_device(out, norm, nan_to_zero=linear) \
        if out_dtype == torch.uint8 else out.to(torch.float32)


def steering_resize(feat: torch.Tensor, codes: torch.Tensor,
                    geom: Optional[geo.ResizeGeometry] = None, *,
                    max_sigma: float = 10.0, norm: int = 255,
                    linear: bool = False,
                    operands: ResizeOperands = None,
                    out_dtype: torch.dtype = torch.float32):
    """Feature [C, H, W] + hyper codes [C, H, W, 3] (Gaussian) or [C, H,
    W, 1] (``linear``), both int32 (codes 0..norm), both float32 or both
    bf16 (hyper maps in [0, 1]), or one float32 and the other bf16
    (:data:`IN_TYPES`) → [C, OH, OW]: float32, or with
    ``out_dtype=torch.uint8`` (``norm`` ≤ 255) the frame rounded half to
    even, clipped to 0..norm and cast, as
    :func:`~lerf_torch.ops.resample.quantize_device` does.  ``geom``: the
    static geometry (the CPU twin's input); ``operands``: the geometry
    already on the card (a predictor keeps one per shape), made from
    ``geom`` when not given."""
    _check(feat, codes, norm, linear, out_dtype, "steering_resize")
    if feat.device.type == "cpu":
        out = _plain(feat, codes, geom, max_sigma=max_sigma, norm=norm,
                     linear=linear)
        return _finish(out, norm, linear, out_dtype)
    if feat.device.type != "cuda":
        raise ValueError(f"steering_resize: unsupported device {feat.device}")
    if operands is None:
        operands = ResizeOperands.create(geom, feat.device, linear=linear)
    return _launch(feat, codes, operands, max_sigma=max_sigma, norm=norm,
                   linear=linear, out_dtype=out_dtype)


def steering_resize_serving(feat: torch.Tensor, codes: torch.Tensor,
                            ops: geo.ResizeOperands, *,
                            max_sigma: float = 10.0, norm: int = 255,
                            linear: bool = False,
                            operands: ResizeOperands = None,
                            out_dtype: torch.dtype = torch.float32):
    """The resize of ``upscale_dynamic``: the stage outputs ``[C, H, W]``
    of the image (either type, as :func:`steering_resize` takes them)
    resized through the serving geometry ``ops`` → [C, OH, OW].  CPU tensors take the plain rings resize; CUDA tensors K1 on
    ``operands``, :meth:`ResizeOperands.from_serving` of ``ops`` (a
    predictor keeps them), made here when not given."""
    _check(feat, codes, norm, linear, out_dtype, "steering_resize_serving")
    if tuple(feat.shape[1:]) != tuple(ops.in_sz):
        raise ValueError(f"serving geometry is for {tuple(ops.in_sz)}, "
                         f"image is {tuple(feat.shape[1:])}")
    if feat.device.type == "cpu":
        out = _plain_serving(feat, codes, ops, max_sigma=max_sigma,
                             norm=norm, linear=linear)
        return _finish(out, norm, linear, out_dtype)
    if feat.device.type != "cuda":
        raise ValueError("steering_resize_serving: unsupported device "
                         f"{feat.device}")
    if operands is None:
        operands = ResizeOperands.from_serving(ops, feat.device,
                                               linear=linear)
    return _launch(feat, codes, operands, max_sigma=max_sigma, norm=norm,
                   linear=linear, out_dtype=out_dtype)


def _launch(feat, codes, operands: ResizeOperands, *, max_sigma, norm,
            linear, out_dtype):
    global launches, bf16_launches, bf16_feature_launches
    C, H, W = feat.shape
    if operands.in_sz != (H, W):
        raise ValueError(f"geometry is for {operands.in_sz}, image is "
                         f"{(H, W)}")
    if operands.tile is None or operands.rows.device != feat.device:
        raise ValueError("steering_resize: operands made for another device")
    if operands.linear != linear:
        raise ValueError("steering_resize: operands made for the other mode")
    feat, codes = feat.contiguous(), codes.contiguous()
    OH, OW = operands.out_sz
    out = torch.empty((C, OH, OW), dtype=out_dtype, device=feat.device)
    dis = ((operands.lin_x, operands.lin_y) if linear
           else (operands.dis_x, operands.dis_y))
    masks = ((operands.mask_x.data_ptr(), operands.mask_y.data_ptr())
             if linear else (None, None))
    lib = _build.library()
    with torch.cuda.device(feat.device):    # launch on the tensors' card
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lerf_steering_resize(
            feat.data_ptr(), codes.data_ptr(), out.data_ptr(),
            operands.rows.data_ptr(), operands.cols.data_ptr(),
            dis[0].data_ptr(), dis[1].data_ptr(), *masks,
            C, H, W, OH, OW, operands.support, int(operands.antialias),
            int(linear), float(operands.min_scale), float(max_sigma),
            float(norm), *operands.tile,
            int(out_dtype == torch.uint8), stream,
            IN_TYPES[feat.dtype, codes.dtype])
    _build.check(err, "steering_resize launch")
    launches += 1
    bf16_launches += int(codes.dtype == torch.bfloat16)
    bf16_feature_launches += int(
        IN_TYPES[feat.dtype, codes.dtype] == BF16_FEATURE)
    return out


class _TrainResize(torch.autograd.Function):
    """K1's float mode forward, K6 backward."""

    @staticmethod
    def forward(ctx, feat, hyper, operands, max_sigma, linear):
        ctx.save_for_backward(feat, hyper)
        ctx.operands, ctx.max_sigma, ctx.linear = operands, max_sigma, linear
        return _launch(feat, hyper, operands.fwd, max_sigma=max_sigma,
                       norm=255, linear=linear, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad_out):
        from . import resize_bwd

        feat, hyper = ctx.saved_tensors
        g_feat, g_hyper = resize_bwd.steering_resize_grad(
            feat, hyper, grad_out, max_sigma=ctx.max_sigma,
            linear=ctx.linear, operands=ctx.operands)
        return g_feat, g_hyper, None, None, None


def steering_resize_train(feat: torch.Tensor, hyper: torch.Tensor,
                          geom: Optional[geo.ResizeGeometry] = None, *,
                          max_sigma: float = 10.0, linear: bool = False,
                          operands=None):
    """The training forward's resize: float32 feature [C, H, W] and hyper
    maps [C, H, W, 3] (ρ, σx, σy) or [C, H, W, 1] (α, ``linear``) in [0, 1]
    → float32 [C, OH, OW], differentiable in both.  On the CPU the plain
    op (:func:`~lerf_torch.ops.resample.steering_gaussian_resize` /
    :func:`~lerf_torch.ops.resample.amplified_linear_resize`) and its
    autograd; on a card K1 forward and K6 backward, on ``operands``
    (:class:`~lerf_torch.ops.kernels.resize_bwd.GradOperands` of ``geom``,
    made here when not given)."""
    _check(feat, hyper, 255, linear, torch.float32, "steering_resize_train")
    if feat.dtype != torch.float32 or hyper.dtype != torch.float32:
        raise ValueError("steering_resize_train: float32 feature and maps")
    if feat.device.type == "cpu":
        return _plain(feat, hyper, geom, max_sigma=max_sigma, norm=255,
                      linear=linear)
    if feat.device.type != "cuda":
        raise ValueError("steering_resize_train: unsupported device "
                         f"{feat.device}")
    if operands is None:
        from .resize_bwd import GradOperands
        operands = GradOperands.create(geom, feat.device, linear=linear)
    return _TrainResize.apply(feat, hyper, operands, float(max_sigma),
                              bool(linear))
