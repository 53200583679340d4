"""Color-space conversions (numpy, eval-side parity).

Parity targets: ``common/utils.py:46-101`` — the ITU-R BT.601 studio-swing
RGB→YCbCr used for Y-channel PSNR/SSIM, plus the MATLAB-parity variant.
"""
from __future__ import annotations

import numpy as np

_T = np.array([[0.256788235294118, 0.504129411764706, 0.097905882352941],
               [-0.148223529411765, -0.290992156862745, 0.439215686274510],
               [0.439215686274510, -0.367788235294118, -0.071427450980392]])
_O = np.array([16.0, 128.0, 128.0])


def rgb_to_ycbcr(img: np.ndarray, max_val: float = 255.0) -> np.ndarray:
    """[H, W, 3] RGB (0-255) → YCbCr.  Parity: ``_rgb2ycbcr`` (utils.py:46-76)."""
    offset = _O / 255.0 if max_val == 1 else _O
    t = img.reshape(-1, img.shape[2]) @ _T.T
    t = t + offset
    return t.reshape(img.shape)


def rgb_to_y(img: np.ndarray) -> np.ndarray:
    """Y channel only, the SR-eval convention (eval_lut_sr.py:741)."""
    return rgb_to_ycbcr(img)[:, :, 0]


def rgb_to_ycbcr_matlab(img: np.ndarray, only_y: bool = True):
    """MATLAB-parity rgb2ycbcr (utils.py:80-101)."""
    in_type = img.dtype
    x = img.astype(np.float32)
    if in_type != np.uint8:
        x = x * 255.0
    if only_y:
        out = x @ np.array([65.481, 128.553, 24.966]) / 255.0 + 16.0
    else:
        out = x @ np.array([[65.481, -37.797, 112.0],
                            [128.553, -74.203, -93.786],
                            [24.966, 112.0, -18.214]]) / 255.0 \
            + np.array([16, 128, 128])
    if in_type == np.uint8:
        out = out.round()
    else:
        out = out / 255.0
    return out.astype(in_type)


def modcrop(image: np.ndarray, modulo: int) -> np.ndarray:
    """Crop to a multiple of ``modulo`` (utils.py:31-42)."""
    if image.ndim == 2:
        sz = np.array(image.shape[:2])
        sz = sz - sz % modulo
        return image[:sz[0], :sz[1]]
    if image.shape[2] == 3:
        sz = np.array(image.shape[:2])
        sz = sz - sz % modulo
        return image[:sz[0], :sz[1], :]
    raise NotImplementedError(image.shape)
