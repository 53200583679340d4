"""The plain reference the benchmark holds the program to.

Plain PyTorch and numpy, importing nothing of the program: each form's
stages (``<form>.py``: ``Stages`` and ``make_weights``, which makes the
seeded weights that both sides are given) and the steerable resampler
(``resample.py``) on geometry derived again here (``geometry.py``).  The
form's module is found by the configuration's ``form``.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from . import resample
from .geometry import warp_mask


def form_module(cfg: dict):
    return importlib.import_module(f"{__name__}.{cfg['form']}")


def make_weights(cfg: dict, seed: int, device):
    """The configuration's seeded weights (or bank) on ``device``."""
    return form_module(cfg).make_weights(cfg, seed, device)


class Reference:
    """The whole frame in plain form: stages, then the resize or warp and
    the uint8 epilogue.  ``precision`` overrides the configuration's
    (the control's lower precision)."""

    def __init__(self, cfg: dict, weights, device, precision=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.precision = {**cfg["precision"], **(precision or {})}
        self.stages = form_module(cfg).Stages(cfg, weights, self.precision)
        self.dtype = getattr(torch, self.precision["resample"])

    def _stages(self, frame: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)
        return self.stages(x.permute(2, 0, 1))

    def upscale(self, frame: np.ndarray, scale: float) -> np.ndarray:
        """uint8 [H, W, C] → uint8 [oH, oW, C]."""
        feat, maps = self._stages(frame)
        out = resample.resize(feat, maps, scale,
                              max_sigma=self.cfg["max_sigma"],
                              support=self.cfg["support"], dtype=self.dtype)
        return out.permute(1, 2, 0).cpu().numpy()

    def warp(self, frame: np.ndarray, matrix, out_hw):
        """uint8 [H, W, C] → (uint8 [oH, oW, C], bool mask [oH, oW])."""
        feat, maps = self._stages(frame)
        out = resample.warp(feat, maps, matrix, out_hw,
                            max_sigma=self.cfg["max_sigma"],
                            support=self.cfg["support"], dtype=self.dtype)
        return (out.permute(1, 2, 0).cpu().numpy(),
                warp_mask(matrix, frame.shape[:2], out_hw,
                          self.cfg["mask_border"], self.device).cpu().numpy())
