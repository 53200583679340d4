"""K1 wrapper: steerable-Gaussian resize from the stage outputs.

``steering_resize`` runs the plain twin
(:func:`lerf_torch.ops.resample.steering_resize_codes_plain`, then
:func:`~lerf_torch.ops.resample.quantize_device` for uint8) for CPU tensors
and launches ``csrc/steering_resize.cu`` for CUDA tensors; it never falls
back from the card to the plain version.  ``launches`` counts kernel
launches.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry import ResizeGeometry
from ..resample import quantize_device, steering_resize_codes_plain
from . import _build

launches = 0

# Output tiles (rows, columns) a block may take, a thread taking 4 adjacent
# columns of one row.  The host picks one per geometry so the tile's source
# window fits in shared memory (or, failing that, one row of it).  16 x 32 (128 threads) is the largest: at
# x4 it beat 16 x 64, 32 x 32 and 8 x 64 on the H100 (probe_lut_kernels).
TILES = ((16, 32), (8, 32), (4, 32), (4, 16), (2, 16), (2, 8), (1, 8),
         (1, 4), (1, 1))
WINDOW_BYTES = 16                  # float4 {feature, 2 rho, sx, sy}
BLOCK_SMEM_MAX = 232448            # H100: the opt-in limit of one block
SM_SMEM = 233472                   # H100: shared memory of one SM
SM_THREADS = 2048


def _window_span(fov: np.ndarray, tile: int) -> int:
    """The largest source span (in pixels) that ``tile`` consecutive
    outputs of a monotone field of view ``[O, S]`` read."""
    starts = np.arange(0, fov.shape[0], tile)
    ends = np.minimum(starts + tile, fov.shape[0]) - 1
    return int((fov[ends, -1] - fov[starts, 0]).max()) + 1


def pick_tile(rows: np.ndarray, cols: np.ndarray):
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
        row_bytes = wc * WINDOW_BYTES
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
    """One geometry's field of view on the device: source rows/cols in
    unpadded coordinates (int32, may fall outside the image — the kernel
    maps the pads), the distances cast float64 → float32, and on a card
    K1's tile with its source window (:func:`pick_tile`)."""
    rows: torch.Tensor     # [OH, S]
    cols: torch.Tensor     # [OW, S]
    dis_x: torch.Tensor    # [OH, S]
    dis_y: torch.Tensor    # [OW, S]
    tile: Optional[tuple]  # (tile_h, tile_w, window rows, window cols)

    @classmethod
    def create(cls, geom: ResizeGeometry, device):
        def up(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

        rows = geom.fov_x.astype(np.int64) - geom.pad_x[0]
        cols = geom.fov_y.astype(np.int64) - geom.pad_y[0]
        tile = (pick_tile(rows, cols) if torch.device(device).type == "cuda"
                else None)
        return cls(rows=up(rows, np.int32), cols=up(cols, np.int32),
                   dis_x=up(geom.dis_x, np.float32),
                   dis_y=up(geom.dis_y, np.float32), tile=tile)


def steering_resize(feat: torch.Tensor, codes: torch.Tensor,
                    geom: ResizeGeometry, *, max_sigma: float = 10.0,
                    norm: int = 255, operands: ResizeOperands = None,
                    out_dtype: torch.dtype = torch.float32):
    """int32 feature [C, H, W] + int32 hyper codes [C, H, W, 3] → [C, OH,
    OW]: float32, or with ``out_dtype=torch.uint8`` (``norm`` ≤ 255) the
    frame rounded half to even, clipped to 0..norm and cast, as
    :func:`~lerf_torch.ops.resample.quantize_device` does.  ``operands``:
    the geometry already on the device (the predictor keeps one per shape);
    made here when not given."""
    if out_dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"steering_resize: out_dtype {out_dtype} is not "
                         "float32 or uint8")
    if out_dtype == torch.uint8 and not norm <= 255:
        raise ValueError(f"steering_resize: uint8 output needs norm <= 255, "
                         f"not {norm}")
    if feat.device.type == "cpu":
        out = steering_resize_codes_plain(feat, codes, geom,
                                          max_sigma=max_sigma, norm=norm)
        return quantize_device(out, norm) if out_dtype == torch.uint8 \
            else out
    global launches
    if feat.device.type != "cuda":
        raise ValueError(f"steering_resize: unsupported device {feat.device}")
    C, H, W = feat.shape
    if (feat.dtype != torch.int32 or codes.dtype != torch.int32
            or codes.shape != (C, H, W, 3) or codes.device != feat.device):
        raise ValueError("steering_resize: feat int32 [C,H,W] and codes "
                         "int32 [C,H,W,3] on one device")
    if tuple(geom.in_sz) != (H, W):
        raise ValueError(f"geometry is for {geom.in_sz}, image is {(H, W)}")
    if operands is None:
        operands = ResizeOperands.create(geom, feat.device)
    if operands.tile is None or operands.rows.device != feat.device:
        raise ValueError("steering_resize: operands made for another device")
    feat, codes = feat.contiguous(), codes.contiguous()
    OH, OW = geom.out_sz
    out = torch.empty((C, OH, OW), dtype=out_dtype, device=feat.device)
    lib = _build.library()
    with torch.cuda.device(feat.device):    # launch on the tensors' card
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lerf_steering_resize(
            feat.data_ptr(), codes.data_ptr(), out.data_ptr(),
            operands.rows.data_ptr(), operands.cols.data_ptr(),
            operands.dis_x.data_ptr(), operands.dis_y.data_ptr(),
            C, H, W, OH, OW, geom.support, int(geom.antialias),
            float(geom.min_scale), float(max_sigma), float(norm),
            *operands.tile, int(out_dtype == torch.uint8), stream)
    _build.check(err, "steering_resize launch")
    launches += 1
    return out
