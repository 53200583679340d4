"""K1 wrapper: steerable-Gaussian resize from the stage outputs.

``steering_resize`` runs the plain twin
(:func:`lerf_torch.ops.resample.steering_resize_codes_plain`) for CPU
tensors and launches ``csrc/steering_resize.cu`` for CUDA tensors; it never
falls back from the card to the plain version.  ``launches`` counts kernel
launches.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import ResizeGeometry
from ..resample import steering_resize_codes_plain
from . import _build

launches = 0


class ResizeOperands(NamedTuple):
    """One geometry's field of view on the device: source rows/cols in
    unpadded coordinates (int32, may fall outside the image — the kernel
    maps the pads) and the distances cast float64 → float32."""
    rows: torch.Tensor     # [OH, S]
    cols: torch.Tensor     # [OW, S]
    dis_x: torch.Tensor    # [OH, S]
    dis_y: torch.Tensor    # [OW, S]

    @classmethod
    def create(cls, geom: ResizeGeometry, device):
        def up(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

        return cls(rows=up(geom.fov_x.astype(np.int64) - geom.pad_x[0],
                           np.int32),
                   cols=up(geom.fov_y.astype(np.int64) - geom.pad_y[0],
                           np.int32),
                   dis_x=up(geom.dis_x, np.float32),
                   dis_y=up(geom.dis_y, np.float32))


def steering_resize(feat: torch.Tensor, codes: torch.Tensor,
                    geom: ResizeGeometry, *, max_sigma: float = 10.0,
                    norm: int = 255, operands: ResizeOperands = None):
    """int32 feature [C, H, W] + int32 hyper codes [C, H, W, 3] → float32
    [C, OH, OW].  ``operands``: the geometry already on the device (the
    predictor keeps one per shape); made here when not given."""
    if feat.device.type == "cpu":
        return steering_resize_codes_plain(feat, codes, geom,
                                           max_sigma=max_sigma, norm=norm)
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
    feat, codes = feat.contiguous(), codes.contiguous()
    OH, OW = geom.out_sz
    out = torch.empty((C, OH, OW), dtype=torch.float32, device=feat.device)
    lib = _build.library()
    with torch.cuda.device(feat.device):    # launch on the tensors' card
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lerf_steering_resize(
            feat.data_ptr(), codes.data_ptr(), out.data_ptr(),
            operands.rows.data_ptr(), operands.cols.data_ptr(),
            operands.dis_x.data_ptr(), operands.dis_y.data_ptr(),
            C, H, W, OH, OW, geom.support, int(geom.antialias),
            float(geom.min_scale), float(max_sigma), float(norm), stream)
    _build.check(err, "steering_resize launch")
    launches += 1
    return out
