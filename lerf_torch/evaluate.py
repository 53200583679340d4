"""Evaluation harnesses reproducing the reference eval scripts' metrics and
report format (eval_lut_sr.py / eval_lut_warp.py) — ``lerf_tpu/evaluate.py``:
SR through ``upscale``, ``upscale_bucketed`` or ``upscale_dynamic``, the
warp through the static ``warp``."""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .data.benchmarks import SRBenchmark, WarpBenchmark, save_image
from .utils.color import rgb_to_y
from .utils.metrics import mpsnr, psnr, ssim


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
                     post: int = 1, nsigma: float = -1.0,
                     bucket: int = 0, dynamic: bool = False) -> Dict:
    """Evaluate arbitrary-scale SR on one dataset.

    ``post`` divides the resampling scale for pre-upsampled inputs
    (LeRF-Net++ convention, eval_lut_sr.py:630-646); ``nsigma`` > 0 enables
    noisy (denoising-mode) evaluation.  ``dynamic`` serves through
    ``upscale_dynamic`` (with ``bucket`` > 0 as its granularity),
    ``bucket`` > 0 alone through ``upscale_bucketed``; both are bit-equal
    to ``upscale``.  Returns {scale: (avg_psnr, avg_ssim)}.
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
            if dynamic:
                out = predictor.upscale_dynamic(lr, sh / post, sw / post,
                                                granularity=bucket)
            elif bucket > 0:
                out = predictor.upscale_bucketed(lr, sh / post, sw / post,
                                                 granularity=bucket)
            else:
                out = predictor.upscale(lr, sh / post, sw / post)
            vals.append(eval_sr_image(out, hr, sh, sw))
            if out_dir is not None:
                save_image(os.path.join(out_dir, f"{name[:-4]}_{lut_name}.png"),
                           out)
        arr = np.asarray(vals)
        results[(sh, sw)] = (float(arr[:, 0].mean()), float(arr[:, 1].mean()))
    return results


def run_warp_benchmark(predictor, root: str, dataset: str,
                       scale_ps: Sequence[str] = ("isc", "osc"),
                       hr_root: Optional[str] = None,
                       result_root: Optional[str] = None,
                       exp_name: str = "lerf",
                       pre_upsample: bool = False,
                       dynamic: bool = False,
                       bucket: int = 0) -> Dict[str, float]:
    """Evaluate homographic warping; returns {scale_p: avg mPSNR}.

    ``pre_upsample`` right-multiplies the homography by the ×2 pre-upsample
    correction (eval_model.py:220-226 / train_model.py:214-220).
    ``dynamic`` or ``bucket`` > 0 serves through ``warp_dynamic`` with the
    bucket as its granularity, as lerf_tpu's does (bit-equal to ``warp``).
    """
    bench = WarpBenchmark(root, dataset, hr_root=hr_root)
    dynamic = (dynamic or bucket > 0) and hasattr(predictor, "warp_dynamic")
    post = np.array([[0.5, 0.0, -0.25],
                     [0.0, 0.5, -0.25],
                     [0.0, 0.0, 1.0]], dtype=np.float64)
    results = {}
    for scale_p in scale_ps:
        vals: List[float] = []
        out_dir = None
        if result_root is not None:
            out_dir = os.path.join(result_root, exp_name, dataset, scale_p)
            os.makedirs(out_dir, exist_ok=True)
        for i in range(len(bench)):
            lr, hr, matrix, name = bench.sample(i, scale_p)
            if pre_upsample:
                matrix = matrix @ post
            if dynamic:
                out, mask = predictor.warp_dynamic(lr, matrix, hr.shape[:2],
                                                   granularity=bucket)
            else:
                out, mask = predictor.warp(lr, matrix, hr.shape[:2])
            mask3 = mask[:, :, None]
            vals.append(mpsnr(out.astype(np.float64), hr, mask3))
            if out_dir is not None:
                white = np.full_like(hr, 255.0)
                vis = (out * mask3 + (~mask3) * white).astype(np.uint8)
                save_image(os.path.join(out_dir, f"{name[:-4]}_out.png"), vis)
        results[scale_p] = float(np.mean(vals))
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


def format_sr_table(dataset_results: Dict[str, Dict], scales) -> str:
    """Reference-format report table (eval_lut_sr.py:793-811).  Long runs
    should print the header and each dataset's row as they come instead
    (:func:`format_sr_header` / :func:`format_sr_row`)."""
    lines = [format_sr_header(scales)]
    for ds, res in dataset_results.items():
        lines.append(format_sr_row(ds, res, scales))
    return "\n".join(lines)


def format_warp_header(scale_ps=("isc", "osc")) -> str:
    head = ["Scale".ljust(15, " ")]
    for p in scale_ps:
        head.append(f"{p}\t")
    return "\t".join(head)


def format_warp_row(ds: str, res: Dict[str, float],
                    scale_ps=("isc", "osc")) -> str:
    row = [ds.ljust(15, " ")]
    for p in scale_ps:
        row.append(f"{res[p]:.2f}")
    return "\t".join(row)


def format_warp_table(dataset_results: Dict[str, Dict[str, float]],
                      scale_ps=("isc", "osc")) -> str:
    lines = [format_warp_header(scale_ps)]
    for ds, res in dataset_results.items():
        lines.append(format_warp_row(ds, res, scale_ps))
    return "\n".join(lines)
