"""End-user upscaling command: one image in, one image out.

    # LUT form — -e points at a LUT bank directory; on the CUDA card
    python -m lerf_torch.cli.upscale -e models/lerf-g --input in.png \
        --output out.png --scale 4
    # micro-net form (K3 on the card; --backend pallas_int8 runs K4)
    python -m lerf_torch.cli.upscale -e models/lerf-g --form net \
        --twoStage --outC 3 --input in.png --output out.png --scale 2.5
    # IMDN (LeRF-Net) form: the towers, then K1 in its float mode
    python -m lerf_torch.cli.upscale -e models/lerf-net --form net \
        --model IMDN2 --inC 3 --twoStage --input in.png --output out.png
    # homographic warp with the same hyper maps (K5 on the card)
    python -m lerf_torch.cli.upscale -e models/lerf-g --input in.png \
        --output out.png --matrix 4,0,0,0,4,0,0,0,1 --outSize 1440x2560
    ... --platform cpu                        # on the CPU

``--form auto`` serves the net form when ``-e`` holds a network checkpoint
(``Model_{loadIter:06d}.pth`` or a ``ckpt/`` directory), else the LUT bank,
and falls back to the bank when the checkpoint is missing or cannot be
loaded.  Non-integer and anisotropic scales work (``--scale 2.5``,
``--scale 1.5x2.0``); ``--dynamicSR`` serves through ``upscale_dynamic``
(``--bucket g`` its granularity), ``--bucket g`` alone through
``upscale_bucketed`` (bit-equal to the static path), ``--linear`` reads a
LeRF-L bank or checkpoint and ``--suppSize`` sets the resample's support.
``--matrix a,b,c,...,i --outSize HxW`` switches to the homographic warp
(out-of-view pixels written black), ``--dynamicWarp`` to its serving form
``warp_dynamic`` (bit-equal; ``--bucket`` does not change the warp, as in
lerf_tpu).

``--input`` also takes a directory or a glob; with several inputs
``--output`` names a directory and, under ``--dynamicSR`` /
``--dynamicWarp``, the frames run through the pipelined streaming engine
(:mod:`lerf_torch.serve`): frame k+1's decode and staging overlap frame
k's device work.  Each output equals the one-image call's.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import sys

import numpy as np

from ..config import TestConfig, parse_config
from ..pipeline import LutPredictor


@dataclasses.dataclass
class UpscaleConfig(TestConfig):
    input: str = ""
    output: str = ""
    form: str = "lut"            # lut | net | auto
    matrix: str = ""             # 9 comma floats → homography warp mode
    out_size: str = ""           # HxW for warp mode


def _expand_inputs(path):
    import glob

    if os.path.isdir(path):
        exts = (".png", ".jpg", ".jpeg", ".bmp")
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.lower().endswith(exts))
    elif any(ch in path for ch in "*?["):
        files = sorted(glob.glob(path))
    else:
        files = [path]
    if not files:
        raise SystemExit(f"no inputs match {path}")
    return files


def _parse_scale(s):
    if "x" in s:
        sh, sw = (float(v) for v in s.split("x"))
        return sh, sw
    return float(s), float(s)


def _parse_matrix(cfg):
    vals = [float(v) for v in cfg.matrix.split(",")]
    if len(vals) != 9:
        raise SystemExit("--matrix needs 9 comma-separated floats")
    mat = np.asarray(vals, np.float64).reshape(3, 3)
    try:
        oh, ow = (int(v) for v in cfg.out_size.split("x"))
    except ValueError:
        raise SystemExit("--matrix warp mode needs --outSize HxW "
                         "(e.g. --outSize 512x512)")
    return mat, (oh, ow)


# what reading a checkpoint on the host can raise: missing or unreadable
# file, a corrupt or foreign pickle, a whole-module pickle whose reference
# package is not importable, missing state-dict keys, an orbax directory
CHECKPOINT_ERRORS = (OSError, EOFError, pickle.UnpicklingError, ImportError,
                     KeyError, RuntimeError, ValueError, NotImplementedError)


def build_predictor(cfg: UpscaleConfig):
    """The predictor ``--form`` names.  Under ``auto`` the net form serves
    when a checkpoint exists, and a checkpoint that is missing or cannot be
    read falls back to the LUT bank; only the host-side read is guarded, so
    a kernel build, launch or device error is never caught."""
    from .eval_model import (imdn_predictor, load_imdn, load_params,
                             predictor_from_params)

    auto = cfg.form == "auto"
    if auto:
        has_ckpt = (os.path.isdir(os.path.join(cfg.exp_dir, "ckpt"))
                    or os.path.exists(os.path.join(
                        cfg.exp_dir, f"Model_{cfg.load_iter:06d}.pth")))
        cfg.form = "net" if has_ckpt else "lut"
    if cfg.form == "net":
        imdn = cfg.model == "IMDN2"
        try:
            loaded = load_imdn(cfg) if imdn else load_params(cfg)
        except CHECKPOINT_ERRORS as e:
            if not auto:
                raise
            print(f"upscale: net form unavailable ({e!r}); "
                  f"falling back to the LUT bank", flush=True)
        else:
            return (imdn_predictor(cfg, *loaded) if imdn
                    else predictor_from_params(cfg, loaded))
    return LutPredictor.from_config(cfg)


def _run_stream(cfg, pred, files):
    """Several inputs: decode and staging pipelined against the device
    work through :mod:`lerf_torch.serve` (in order, each output equal to
    the one-image call's)."""
    from PIL import Image

    from ..serve import stream_upscale, stream_warp

    if os.path.splitext(cfg.output)[1]:
        raise SystemExit("--output must be a directory for several inputs")
    os.makedirs(cfg.output, exist_ok=True)

    def load(f):
        return np.array(Image.open(f).convert("RGB"))

    if cfg.matrix:
        mat, out_hw = _parse_matrix(cfg)
        results = stream_warp(pred, ((load(f), mat) for f in files), out_hw,
                              granularity=cfg.bucket)
        results = (o * np.asarray(m, o.dtype)[..., None]
                   for o, m in results)
    else:
        sh, sw = _parse_scale(cfg.scale)
        results = stream_upscale(pred, ((load(f), sh, sw) for f in files),
                                 granularity=cfg.bucket)
    for f, out in zip(files, results):
        dst = os.path.join(cfg.output, os.path.basename(f))
        Image.fromarray(out).save(dst)
        print(f"{f} -> {dst} {out.shape[1]}x{out.shape[0]}", flush=True)


def main(argv=None):
    from PIL import Image

    cfg = parse_config(UpscaleConfig, argv)
    if not cfg.input or not cfg.output:
        raise SystemExit("--input and --output are required")
    pred = build_predictor(cfg)
    files = _expand_inputs(cfg.input)
    if len(files) > 1:
        if not (cfg.dynamic_sr or (cfg.matrix and cfg.dynamic_warp)):
            raise SystemExit(
                "several inputs need the recompile-free serving forms: "
                "add --dynamicSR (or --dynamicWarp for --matrix mode)")
        return _run_stream(cfg, pred, files)
    img = np.array(Image.open(files[0]).convert("RGB"))
    if cfg.matrix:
        mat, out_hw = _parse_matrix(cfg)
        warp = pred.warp_dynamic if cfg.dynamic_warp else pred.warp
        out, mask = warp(img, mat, out_hw)
        out = out * np.asarray(mask, out.dtype)[..., None]
    else:
        sh, sw = _parse_scale(cfg.scale)   # "4", "2.5", or "1.5x2.0"
        if cfg.dynamic_sr:
            out = pred.upscale_dynamic(img, sh, sw, granularity=cfg.bucket)
        elif cfg.bucket > 0:
            out = pred.upscale_bucketed(img, sh, sw, granularity=cfg.bucket)
        else:
            out = pred.upscale(img, sh, sw)

    os.makedirs(os.path.dirname(os.path.abspath(cfg.output)), exist_ok=True)
    Image.fromarray(out).save(cfg.output)
    print(f"{cfg.input} {img.shape[1]}x{img.shape[0]} -> "
          f"{cfg.output} {out.shape[1]}x{out.shape[0]}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
