"""SR evaluation harness reproducing the reference eval driver's metrics and
report format (eval_lut_sr.py) — the SR part of ``lerf_tpu/evaluate.py``,
static ``upscale`` path only."""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .data.benchmarks import SRBenchmark, save_image
from .utils.color import rgb_to_y
from .utils.metrics import psnr, ssim


def eval_sr_image(out_u8: np.ndarray, hr: np.ndarray,
                  scale_h: float, scale_w: float) -> Tuple[float, float]:
    """Y-channel PSNR (shave = max int scale) + SSIM, with the reference's
    shape-mismatch cropping (eval_lut_sr.py:735-744)."""
    gt = hr
    if gt.shape != out_u8.shape:
        ph, pw, _ = out_u8.shape
        gt = gt[:ph, :pw, :]
        gh, gw, _ = gt.shape
        out_u8 = out_u8[:gh, :gw, :]
    y_gt = rgb_to_y(gt)
    y_out = rgb_to_y(out_u8)
    shave = max(int(scale_h), int(scale_w))
    return psnr(y_gt, y_out, shave), ssim(y_gt, y_out)


def run_sr_benchmark(predictor, root: str, dataset: str,
                     scales: Sequence[Tuple[float, float]],
                     result_root: Optional[str] = None,
                     exp_name: str = "lerf", lut_name: str = "LUTft",
                     post: int = 1, nsigma: float = -1.0) -> Dict:
    """Evaluate arbitrary-scale SR on one dataset.

    ``post`` divides the resampling scale for pre-upsampled inputs
    (LeRF-Net++ convention, eval_lut_sr.py:630-646); ``nsigma`` > 0 enables
    noisy (denoising-mode) evaluation.  Returns {scale: (avg_psnr, avg_ssim)}.
    """
    bench = SRBenchmark(root, dataset, nsigma=nsigma)
    results = {}
    for (sh, sw) in scales:
        vals: List[Tuple[float, float]] = []
        out_dir = None
        if result_root is not None:
            out_dir = os.path.join(result_root, exp_name,
                                   f"X{sh:.2f}_{sw:.2f}", dataset)
            os.makedirs(out_dir, exist_ok=True)
        for i in range(len(bench)):
            lr, hr, name = bench.pair(i, sh, sw)
            out = predictor.upscale(lr, sh / post, sw / post)
            vals.append(eval_sr_image(out, hr, sh, sw))
            if out_dir is not None:
                save_image(os.path.join(out_dir, f"{name[:-4]}_{lut_name}.png"),
                           out)
        arr = np.asarray(vals)
        results[(sh, sw)] = (float(arr[:, 0].mean()), float(arr[:, 1].mean()))
    return results


def format_sr_header(scales) -> str:
    head = ["Scale".ljust(15, " ")]
    for (sh, sw) in scales:
        head.append(f"{sh:.1f}x{sw:.1f}\t")
    return "\t".join(head)


def format_sr_row(ds: str, res: Dict, scales) -> str:
    row = [ds.ljust(15, " ")]
    for s in scales:
        p, s_ = res[tuple(s)]
        row.append(f"{p:.2f}/{s_:.4f}")
    return "\t".join(row)
