"""Network → LUT export (reference resample/transfer_to_lut.py), on the CUDA
card (or ``--platform cpu``):

    python -m lerf_torch.cli.transfer -e models/lerf-g --loadIter 50000

The port of ``lerf_tpu.cli.transfer``: loads the reference checkpoint
``Model_{loadIter:06d}.pth`` from ``-e``, enumerates every head over the
17⁴ lattice and writes reference-format int8 ``LUT_*.npy`` files beside
it, printing each file's name and shape as lerf_tpu's command does.  The
bank it writes serves through ``LutPredictor.from_config`` (``--lutName
LUT``).  An orbax ``ckpt/`` directory (lerf_tpu's own training
checkpoints) is not ported yet and exits with a message saying so.
"""
from __future__ import annotations

import os
import sys

from ..config import TestConfig, parse_config
from ..lut.io import save_lut_bank
from ..lut.transfer import transfer_to_lut


def load_params(cfg: TestConfig):
    """The SRNet params of ``cfg.exp_dir``: a reference torch pickle
    ``Model_{load_iter:06d}.pth``.  Raises :class:`NotImplementedError` for
    an orbax ``ckpt/`` directory (which ``lerf_tpu`` would read first) and
    :class:`FileNotFoundError` when there is no checkpoint."""
    from ..models.convert import load_reference_checkpoint

    ckpt_dir = os.path.join(cfg.exp_dir, "ckpt")
    if os.path.isdir(ckpt_dir):
        raise NotImplementedError(
            f"orbax checkpoint {ckpt_dir}: not ported yet (ROADMAP Queue A "
            "item 10)")
    pth = os.path.join(cfg.exp_dir, f"Model_{cfg.load_iter:06d}.pth")
    if not os.path.exists(pth):
        raise FileNotFoundError(f"no checkpoint at {ckpt_dir} or {pth}")
    return load_reference_checkpoint(pth, modes=tuple(cfg.modes),
                                     modes2=tuple(cfg.modes2),
                                     stages=cfg.stages)


def main(argv=None):
    cfg = parse_config(TestConfig, argv)
    try:
        params = load_params(cfg)
    except NotImplementedError as e:
        raise SystemExit(f"transfer: {e}")
    bank = transfer_to_lut(
        params, modes=tuple(cfg.modes), modes2=tuple(cfg.modes2),
        stages=cfg.stages, out_c=cfg.out_c, interval=cfg.interval,
        device=cfg.device)
    save_lut_bank(bank, cfg.exp_dir, lut_name="LUT")
    for s, tables in enumerate(bank.inter + [bank.stage1], start=1):
        for m, arr in tables.items():
            print(f"LUT_s{s}_{m}r0.npy",
                  arr.reshape(arr.shape[0], -1, 1, 1).shape)
    for k, arr in bank.stage2.items():
        print(f"LUT_s{bank.stages}_{k}.npy",
              arr.reshape(arr.shape[0], -1, 1, 1).shape)
    return bank


if __name__ == "__main__":
    main(sys.argv[1:])
