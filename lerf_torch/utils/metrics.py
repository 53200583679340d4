"""Quality metrics: PSNR / cPSNR / masked mPSNR / SSIM.

Parity targets: ``common/utils.py:138-203``.  SR eval convention: Y-channel
PSNR with border shave = max(int(scale)) and SSIM on Y
(eval_lut_sr.py:741-743).  Warp eval: RGB-averaged masked mPSNR with a
nearest-warp validity mask, 4-px shaved borders (eval_lut_warp.py:197-233).

Numpy (host) implementations used by the eval drivers — a copy of the
numpy part of ``lerf_tpu/utils/metrics.py``.
"""
from __future__ import annotations

import numpy as np
from scipy import signal



def psnr(y_true: np.ndarray, y_pred: np.ndarray, shave_border: int = 4):
    """0-255 2-D inputs (utils.py:138-151)."""
    t = np.asarray(y_true, dtype=np.float32)
    r = np.asarray(y_pred, dtype=np.float32)
    diff = r - t
    if shave_border > 0:
        diff = diff[shave_border:-shave_border, shave_border:-shave_border]
    rmse = np.sqrt(np.mean(diff ** 2))
    return 20 * np.log10(255.0 / rmse)


def cpsnr(y_true: np.ndarray, y_pred: np.ndarray, shave_border: int = 0):
    """3-channel PSNR (utils.py:153-166)."""
    t = np.asarray(y_true, dtype=np.float32)
    r = np.asarray(y_pred, dtype=np.float32)
    diff = r - t
    if shave_border > 0:
        diff = diff[shave_border:-shave_border, shave_border:-shave_border, :]
    rmse = np.sqrt(np.mean(diff ** 2))
    return 20 * np.log10(255.0 / rmse)


def mpsnr(sr, hr, mask, rgb_range: float = 255.0):
    """Masked PSNR with gain = mask.size/mask.sum() (utils.py:168-175).

    The mask may be boolean or 0/1 float; broadcasting follows the
    reference (mask applied per channel).
    """
    sr = np.asarray(sr, dtype=np.float64)
    hr = np.asarray(hr, dtype=np.float64)
    mask = np.asarray(mask, dtype=np.float64)
    mask_b = np.broadcast_to(mask, sr.shape)
    diff = mask_b * (sr - hr) / rgb_range
    gain = mask_b.size / mask_b.sum()
    mse = gain * np.mean(diff ** 2)
    return -10 * np.log10(mse)


def _gaussian_kernel_11():
    """cv2.getGaussianKernel(11, 1.5) — the exact formula cv2 uses for
    sigma>0: k[i] ∝ exp(-(i-5)²/(2·1.5²)), normalized to sum 1."""
    i = np.arange(11, dtype=np.float64)
    k = np.exp(-((i - 5.0) ** 2) / (2.0 * 1.5 ** 2))
    return (k / k.sum())[:, None]


def ssim(img1: np.ndarray, img2: np.ndarray):
    """11×11 σ=1.5 Gaussian-window SSIM, 0-255 2-D inputs (utils.py:177-203)."""
    K = [0.01, 0.03]
    L = 255
    kx = _gaussian_kernel_11()
    window = kx @ kx.T
    C1 = (K[0] * L) ** 2
    C2 = (K[1] * L) ** 2
    a = np.float64(img1)
    b = np.float64(img2)
    mu1 = signal.convolve2d(a, window, "valid")
    mu2 = signal.convolve2d(b, window, "valid")
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = signal.convolve2d(a * a, window, "valid") - mu1_sq
    s2 = signal.convolve2d(b * b, window, "valid") - mu2_sq
    s12 = signal.convolve2d(a * b, window, "valid") - mu1_mu2
    num = (2 * mu1_mu2 + C1) * (2 * s12 + C2)
    den = (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)
    return np.mean(num / den)
