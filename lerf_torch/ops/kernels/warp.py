"""K5 wrapper: steerable-Gaussian homographic warp from the stage outputs.

``steering_warp`` runs the plain twin
(:func:`lerf_torch.ops.resample.steering_warp_codes_plain`, then
:func:`~lerf_torch.ops.resample.quantize_device` with ``nan_to_zero`` for
uint8) for CPU tensors and launches ``csrc/steering_warp.cu`` for CUDA
tensors; it never falls back from the card to the plain version.
``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import WarpGeometry
from ..resample import (_unclipped_corner, quantize_device,
                        steering_warp_codes_plain)
from . import _build

launches = 0


class WarpOperands(NamedTuple):
    """One support-2 warp geometry on the device, per output pixel n
    (row-major over [oH, oW]): the unclipped top-left corner of its 2×2
    window in padded coordinates, from which the kernel clips the two rows
    and the two columns into [0, in-1] as the geometry does, and the four
    distances cast float64 → float32 once.  24 bytes a pixel."""
    corners: torch.Tensor  # [N, 2] int32 (row, col), padded coordinates
    dis: torch.Tensor      # [N, 4] float32 (dx0, dx1, dy0, dy1)
    pad: tuple             # (pad_x[0], pad_y[0]): padded → source index

    @classmethod
    def create(cls, geom: WarpGeometry, device):
        if geom.support != 2:
            raise ValueError("K5 takes support-2 warp geometries")
        corners = np.stack([_unclipped_corner(geom.fov_x),
                            _unclipped_corner(geom.fov_y)], -1)
        dis = np.concatenate([geom.dis_x, geom.dis_y], -1)
        return cls(
            corners=torch.from_numpy(np.ascontiguousarray(
                corners.reshape(-1, 2), np.int32)).to(device),
            dis=torch.from_numpy(np.ascontiguousarray(
                dis.reshape(-1, 4), np.float32)).to(device),
            pad=(int(geom.pad_x[0]), int(geom.pad_y[0])))


def steering_warp(feat: torch.Tensor, codes: torch.Tensor,
                  geom: WarpGeometry, *, max_sigma: float = 10.0,
                  norm: int = 255, operands: WarpOperands = None,
                  out_dtype: torch.dtype = torch.float32):
    """int32 feature [C, H, W] + int32 hyper codes [C, H, W, 3] → [C, oH,
    oW]: float32 (NaN where a window's weights all vanish), or with
    ``out_dtype=torch.uint8`` (``norm`` ≤ 255) the frame with NaN → 0,
    rounded half to even, clipped to 0..norm and cast, as
    :func:`~lerf_torch.ops.resample.quantize_device` with ``nan_to_zero``
    does.  ``operands``: the geometry already on the device (the
    predictors keep one per key); made here when not given."""
    if out_dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"steering_warp: out_dtype {out_dtype} is not "
                         "float32 or uint8")
    if out_dtype == torch.uint8 and not norm <= 255:
        raise ValueError(f"steering_warp: uint8 output needs norm <= 255, "
                         f"not {norm}")
    C, H, W = feat.shape
    if (feat.dtype != torch.int32 or codes.dtype != torch.int32
            or codes.shape != (C, H, W, 3) or codes.device != feat.device):
        raise ValueError("steering_warp: feat int32 [C,H,W] and codes "
                         "int32 [C,H,W,3] on one device")
    if tuple(geom.in_sz) != (H, W):
        raise ValueError(f"geometry is for {geom.in_sz}, image is {(H, W)}")
    if feat.device.type == "cpu":
        out = steering_warp_codes_plain(feat, codes, geom,
                                        max_sigma=max_sigma, norm=norm)
        return quantize_device(out, norm, nan_to_zero=True) \
            if out_dtype == torch.uint8 else out
    global launches
    if feat.device.type != "cuda":
        raise ValueError(f"steering_warp: unsupported device {feat.device}")
    if operands is None:
        operands = WarpOperands.create(geom, feat.device)
    OH, OW = geom.out_sz
    if (operands.corners.device != feat.device
            or operands.corners.shape != (OH * OW, 2)):
        raise ValueError("steering_warp: operands made for another device "
                         "or geometry")
    feat, codes = feat.contiguous(), codes.contiguous()
    out = torch.empty((C, OH, OW), dtype=out_dtype, device=feat.device)
    lib = _build.library()
    with torch.cuda.device(feat.device):    # launch on the tensors' card
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lerf_steering_warp(
            feat.data_ptr(), codes.data_ptr(), out.data_ptr(),
            operands.corners.data_ptr(), operands.dis.data_ptr(),
            C, H, W, OH * OW, *operands.pad, float(max_sigma), float(norm),
            int(out_dtype == torch.uint8), stream)
    _build.check(err, "steering_warp launch")
    launches += 1
    return out
