"""End-user upscaling command: one image in, one image out (LUT form).

    python -m lerf_torch.cli.upscale -e models/lerf-g --input in.png \
        --output out.png --scale 4            # on the CUDA card
    ... --platform cpu                        # on the CPU

Non-integer and anisotropic scales work (``--scale 2.5``, ``--scale
1.5x2.0``).  The port serves the LUT form, one image, through the static
``LutPredictor.upscale`` path; ``--form net``, ``--dynamicSR``,
``--bucket``, ``--matrix`` (warp) and several inputs are not ported yet and
exit with a message saying so.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

from ..config import TestConfig, parse_config
from ..pipeline import LutPredictor


@dataclasses.dataclass
class UpscaleConfig(TestConfig):
    input: str = ""
    output: str = ""
    form: str = "lut"            # lut (net / auto: not ported yet)
    matrix: str = ""             # homography warp mode (not ported yet)
    out_size: str = ""           # HxW for warp mode


def _parse_scale(s):
    if "x" in s:
        sh, sw = (float(v) for v in s.split("x"))
        return sh, sw
    return float(s), float(s)


def _unported(cfg: UpscaleConfig):
    """The message for a flag whose path the port does not have yet."""
    if cfg.form != "lut":
        return f"--form {cfg.form} (ROADMAP Queue A items 7-8)"
    if cfg.matrix:
        return "--matrix warp mode (ROADMAP Queue A item 5)"
    if cfg.dynamic_sr or cfg.dynamic_warp or cfg.bucket > 0:
        return "--dynamicSR / --dynamicWarp / --bucket (ROADMAP Queue A item 6)"
    if (os.path.isdir(cfg.input)
            or any(ch in cfg.input for ch in "*?[")):
        return "several inputs (ROADMAP Queue A item 11)"
    return None


def main(argv=None):
    from PIL import Image

    cfg = parse_config(UpscaleConfig, argv)
    if not cfg.input or not cfg.output:
        raise SystemExit("--input and --output are required")
    missing = _unported(cfg)
    if missing:
        raise SystemExit(f"upscale: {missing} is not ported to lerf_torch "
                         "yet; use lerf_tpu.cli.upscale")
    pred = LutPredictor.from_config(cfg)
    img = np.array(Image.open(cfg.input).convert("RGB"))
    sh, sw = _parse_scale(cfg.scale)   # "4", "2.5", or "1.5x2.0"
    out = pred.upscale(img, sh, sw)

    os.makedirs(os.path.dirname(os.path.abspath(cfg.output)), exist_ok=True)
    Image.fromarray(out).save(cfg.output)
    print(f"{cfg.input} {img.shape[1]}x{img.shape[0]} -> "
          f"{cfg.output} {out.shape[1]}x{out.shape[0]}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
