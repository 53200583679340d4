"""Network → LUT export (reference resample/transfer_to_lut.py), on the CUDA
card (or ``--platform cpu``):

    python -m lerf_torch.cli.transfer -e models/lerf-g --loadIter 50000

The port of ``lerf_tpu.cli.transfer``: loads the reference checkpoint
``Model_{loadIter:06d}.pth`` from ``-e``, enumerates every head over the
17⁴ lattice and writes reference-format int8 ``LUT_*.npy`` files beside
it, printing each file's name and shape as lerf_tpu's command does.  The
bank it writes serves through ``LutPredictor.from_config`` (``--lutName
LUT``).  As lerf_tpu's, it reads the trainer's checkpoint of step
``loadIter`` first (``{expDir}/ckpt/{loadIter}``, written by
``lerf_torch.cli.train``); with none there (an empty ``ckpt/``) it falls
through to the reference pickle.  An orbax step directory (lerf_tpu's
trainer's) exits with a message naming its writer.
"""
from __future__ import annotations

import os
import sys

from ..config import TestConfig, parse_config
from ..lut.io import save_lut_bank
from ..lut.transfer import transfer_to_lut


def trained_params(cfg: TestConfig):
    """The params of the trainer's checkpoint of step ``cfg.load_iter``
    (``{exp_dir}/ckpt/{load_iter}``), or ``None`` when there is none.
    Raises :class:`~lerf_torch.train.checkpoint.OrbaxCheckpointError` for
    lerf_tpu's orbax step directory."""
    from ..train.checkpoint import CheckpointManager

    if not os.path.isdir(os.path.join(cfg.exp_dir, "ckpt")):
        return None
    mgr = CheckpointManager(cfg.exp_dir)
    if cfg.load_iter not in mgr.all_steps():
        return None
    return mgr.restore(cfg.load_iter)["params"]


def load_params(cfg: TestConfig):
    """The SRNet params of ``cfg.exp_dir``: the trainer's checkpoint of
    step ``load_iter`` (:func:`trained_params`), else a reference torch
    pickle ``Model_{load_iter:06d}.pth``.  Raises
    :class:`FileNotFoundError` when there is neither."""
    from ..models.convert import load_reference_checkpoint

    params = trained_params(cfg)
    if params is not None:
        return params
    ckpt_dir = os.path.join(cfg.exp_dir, "ckpt")
    pth = os.path.join(cfg.exp_dir, f"Model_{cfg.load_iter:06d}.pth")
    if not os.path.exists(pth):
        raise FileNotFoundError(f"no checkpoint at {ckpt_dir} or {pth}")
    return load_reference_checkpoint(pth, modes=tuple(cfg.modes),
                                     modes2=tuple(cfg.modes2),
                                     stages=cfg.stages)


def main(argv=None):
    from ..train.checkpoint import OrbaxCheckpointError

    cfg = parse_config(TestConfig, argv)
    try:
        params = load_params(cfg)
    except OrbaxCheckpointError as e:
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
