"""Generate rrBenchmark LR data from HR images (arbitrary scale pairs).

The port of ``lerf_tpu/cli/make_benchmark.py``.  The reference makes the
arbitrary-scale benchmark's LR inputs by ResizeRight bicubic downscaling
with anti-aliasing into ``LR_bicubic/rrLR_X{h:.2f}_{w:.2f}/`` (reference
README.md:63-71); here :func:`lerf_torch.ops.resize` does it, on the card
unless ``--platform cpu`` asks for the CPU.

    python -m lerf_torch.cli.make_benchmark --hrDir data/rrBenchmark/Set5/HR \\
        --scales 2,3,4,1.5,2.5 [--platform cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..data.benchmarks import list_pngs, load_image, save_image
from ..device import resolve_device
from ..ops import resize
from ..ops.resample import _KERNEL_SUPPORT as KERNEL_SUPPORT


def modcrop_rational(hr: np.ndarray, scale_h: float, scale_w: float):
    """Crop HR so LR·scale round-trips to an integer-aligned grid.

    Without this, fractional scales produce ceil-sized LR whose coordinate
    frame is sub-pixel shifted against the HR, which costs several dB at
    evaluation (the reference's benchmark data is aligned the same way).
    """
    from fractions import Fraction

    out = []
    for dim, s in ((hr.shape[0], scale_h), (hr.shape[1], scale_w)):
        p = Fraction(s).limit_denominator(1000).numerator
        out.append((dim // p) * p)
    return hr[:out[0], :out[1]]


def downscale(hr: np.ndarray, scale_h: float, scale_w: float,
              kernel: str = "cubic", device=None) -> np.ndarray:
    """HR [H, W, 3] (uint8 or float) → the uint8 LR image: modcrop, the
    float32 resize by 1/scale on ``device`` (default the card; ``"cpu"``
    asks for the CPU), rounded half to even and clipped."""
    hr = modcrop_rational(hr, scale_h, scale_w)
    chw = torch.from_numpy(np.ascontiguousarray(
        hr.transpose(2, 0, 1), np.float32)).to(resolve_device(device))
    out = resize(chw, scale_factors=[1.0 / scale_h, 1.0 / scale_w],
                 interp_method=kernel)
    out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out.cpu().numpy().transpose(1, 2, 0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--hrDir", required=True)
    p.add_argument("--outDir", default="",
                   help="default: <hrDir>/../LR_bicubic")
    p.add_argument("--scales", default="2,3,4",
                   help="comma list; 'HxW' pairs allowed (e.g. 1.5x2.0)")
    p.add_argument("--kernel", default="cubic",
                   choices=sorted(KERNEL_SUPPORT))
    p.add_argument("--platform", default="",
                   help="cpu, or the CUDA card (default)")
    args = p.parse_args(argv)
    device = "cpu" if args.platform == "cpu" else None

    out_root = args.outDir or os.path.join(
        os.path.dirname(args.hrDir.rstrip("/")), "LR_bicubic")
    scales = []
    for s in args.scales.split(","):
        if "x" in s:
            h, w = s.split("x")
            scales.append((float(h), float(w)))
        else:
            scales.append((float(s), float(s)))

    files = list_pngs(args.hrDir)
    for (sh, sw) in scales:
        out_dir = os.path.join(out_root, f"rrLR_X{sh:.2f}_{sw:.2f}")
        os.makedirs(out_dir, exist_ok=True)
        for f in files:
            hr = load_image(os.path.join(args.hrDir, f))
            save_image(os.path.join(out_dir, f),
                       downscale(hr, sh, sw, args.kernel, device))
        print(f"wrote {len(files)} images to {out_dir}")


if __name__ == "__main__":
    main(sys.argv[1:])
