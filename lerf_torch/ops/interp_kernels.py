"""Fixed interpolation kernels: the five 1-D kernels of the reference
(``resize_right/interp_methods.py:35-95``), each with its support size,
and their separable 2-D products.

A copy of ``lerf_tpu/ops/interp_kernels.py`` (whose module imports
``jax.numpy``): the torch functions for device tensors and the numpy
float64 functions (:data:`NP_KERNELS_1D`) with which fixed-kernel weights
are computed on the host, so that a distance at a branch edge is resolved
in float64 as the reference resolves it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)
_PI = math.pi


def _support(sz):
    def wrapper(f):
        f.support_sz = sz
        return f
    return wrapper


@_support(4)
def cubic(x):
    absx = torch.abs(x)
    absx2 = absx ** 2
    absx3 = absx ** 3
    return ((1.5 * absx3 - 2.5 * absx2 + 1.0) * (absx <= 1.0)
            + (-0.5 * absx3 + 2.5 * absx2 - 4.0 * absx + 2.0)
            * ((1.0 < absx) & (absx <= 2.0)))


@_support(4)
def lanczos2(x):
    return (((torch.sin(_PI * x) * torch.sin(_PI * x / 2) + _EPS)
             / ((_PI ** 2 * x ** 2 / 2) + _EPS)) * (torch.abs(x) < 2))


@_support(6)
def lanczos3(x):
    return (((torch.sin(_PI * x) * torch.sin(_PI * x / 3) + _EPS)
             / ((_PI ** 2 * x ** 2 / 3) + _EPS)) * (torch.abs(x) < 3))


@_support(2)
def linear(x):
    return ((x + 1) * ((-1 <= x) & (x < 0)) + (1 - x) * ((0 <= x) & (x <= 1)))


@_support(1)
def box(x):
    # support [-1, 1], closed above: interp_methods.py:68-70
    one = torch.ones_like(x)
    return one * ((-1 <= x) & (x < 0)) + one * ((0 <= x) & (x <= 1))


@_support(4)
def cubic2d(x, y):
    return cubic(x) * cubic(y)


@_support(2)
def linear2d(x, y):
    return linear(x) * linear(y)


@_support(1)
def box2d(x, y):
    return box(x) * box(y)


@_support(4)
def lanczos2d(x, y):
    return lanczos2(x) * lanczos2(y)


@_support(6)
def lanczos3d(x, y):
    return lanczos3(x) * lanczos3(y)


def np_cubic(x):
    absx = np.abs(x)
    absx2 = absx ** 2
    absx3 = absx ** 3
    return ((1.5 * absx3 - 2.5 * absx2 + 1.0) * (absx <= 1.0)
            + (-0.5 * absx3 + 2.5 * absx2 - 4.0 * absx + 2.0)
            * ((1.0 < absx) & (absx <= 2.0)))


def np_lanczos2(x):
    return (((np.sin(_PI * x) * np.sin(_PI * x / 2) + _EPS)
             / ((_PI ** 2 * x ** 2 / 2) + _EPS)) * (np.abs(x) < 2))


def np_lanczos3(x):
    return (((np.sin(_PI * x) * np.sin(_PI * x / 3) + _EPS)
             / ((_PI ** 2 * x ** 2 / 3) + _EPS)) * (np.abs(x) < 3))


def np_linear(x):
    return (x + 1) * ((-1 <= x) & (x < 0)) + (1 - x) * ((0 <= x) & (x <= 1))


def np_box(x):
    return (((-1 <= x) & (x < 0)) | ((0 <= x) & (x <= 1))).astype(x.dtype)


# host float64 1-D kernels, for fixed-kernel weights computed on the host
NP_KERNELS_1D = {
    "cubic": np_cubic,
    "linear": np_linear,
    "box": np_box,
    "lanczos2": np_lanczos2,
    "lanczos3": np_lanczos3,
}

KERNELS_1D = {
    "cubic": cubic,
    "linear": linear,
    "box": box,
    "lanczos2": lanczos2,
    "lanczos3": lanczos3,
}

KERNELS_2D = {
    "cubic": cubic2d,
    "linear": linear2d,
    "box": box2d,
    "lanczos2": lanczos2d,
    "lanczos3": lanczos3d,
}


def get_kernel2d(name: str):
    try:
        return KERNELS_2D[name]
    except KeyError:
        raise ValueError(f"unknown interpolation kernel {name!r}; "
                         f"available: {sorted(KERNELS_2D)}") from None
