"""Benchmark dataset readers — reference directory-layout compatible.

A copy of ``lerf_tpu/data/benchmarks.py``.  Layouts (README.md:63-87 of
the reference):

    rrBenchmark/<set>/HR/*.png
    rrBenchmark/<set>/LR_bicubic/rrLR_X{h:.2f}_{w:.2f}/*.png
    WarpBenchmark/<set>/{HR, isc, osc}/*.png + per-image 3×3 homography
        stored as a sibling torch .pth (float64) — .npy also accepted here.
"""
from __future__ import annotations

import os
import zlib
from typing import List, Optional

import numpy as np
from PIL import Image


def list_pngs(folder: str) -> List[str]:
    files = [f for f in os.listdir(folder) if "png" in f]
    files.sort()
    return files


def load_image(path: str) -> np.ndarray:
    """PNG → float32 [H,W,3]; grayscale promoted to 3 channels
    (eval_lut_sr.py:514-538)."""
    img = np.array(Image.open(path)).astype(np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[2] > 3:
        img = img[:, :, :3]
    return img


def save_image(path: str, img_u8: np.ndarray):
    Image.fromarray(img_u8).save(path)


def load_matrix(path_no_ext: str) -> np.ndarray:
    """Load a 3×3 float64 homography stored as .npy or .pth (torch)."""
    if os.path.exists(path_no_ext + ".npy"):
        return np.load(path_no_ext + ".npy").astype(np.float64)
    pth = path_no_ext + ".pth"
    if os.path.exists(pth):
        import torch
        return np.asarray(torch.load(pth, weights_only=False),
                          dtype=np.float64)
    raise FileNotFoundError(f"no homography at {path_no_ext}.(npy|pth)")


class SRBenchmark:
    """Arbitrary-scale SR benchmark: HR + rrLR_X{h}_{w} pairs.

    ``nsigma`` > 0 adds deterministic Gaussian noise of that σ (0-255
    pixel scale) to the LR input for denoising-mode evaluation, with a
    per-image seed so evaluation is reproducible (the JAX package's
    convention; the reference accepts nsigma but never applies it).
    """

    def __init__(self, root: str, dataset: str, nsigma: float = -1.0):
        self.root = root
        self.dataset = dataset
        self.nsigma = float(nsigma)
        self.hr_dir = os.path.join(root, dataset, "HR")
        self.files = list_pngs(self.hr_dir)

    def lr_dir(self, scale_h: float, scale_w: float) -> str:
        return os.path.join(self.root, self.dataset, "LR_bicubic",
                            f"rrLR_X{scale_h:.2f}_{scale_w:.2f}")

    def __len__(self):
        return len(self.files)

    def pair(self, i: int, scale_h: float, scale_w: float):
        lr = load_image(os.path.join(self.lr_dir(scale_h, scale_w),
                                     self.files[i]))
        hr = load_image(os.path.join(self.hr_dir, self.files[i]))
        if self.nsigma > 0:
            # zlib.crc32 is process-stable (Python's str hash is salted)
            seed = zlib.crc32(f"{self.dataset}/{i}".encode()) % (1 << 31)
            rng = np.random.RandomState(seed)
            lr = np.clip(np.round(lr + rng.normal(0.0, self.nsigma,
                                                  lr.shape)), 0, 255) \
                .astype(np.float32)
        return lr, hr, self.files[i]


class WarpBenchmark:
    """Homographic-warp benchmark: HR + warped-LR ('isc'/'osc') + matrices.

    ``hr_root`` may differ from ``root`` when the HR images live elsewhere
    (a warp tree that ships only isc/osc: point hr_root at rrBenchmark).
    """

    def __init__(self, root: str, dataset: str,
                 hr_root: Optional[str] = None):
        self.root = root
        self.dataset = dataset
        self.hr_dir = os.path.join(hr_root or root, dataset, "HR")
        self.files = list_pngs(self.hr_dir)

    def __len__(self):
        return len(self.files)

    def sample(self, i: int, scale_p: str):
        name = self.files[i]
        lr = load_image(os.path.join(self.root, self.dataset, scale_p, name))
        hr = load_image(os.path.join(self.hr_dir, name))
        matrix = load_matrix(os.path.join(self.root, self.dataset, scale_p,
                                          name[:-4]))
        return lr, hr, matrix, name
