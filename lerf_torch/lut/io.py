"""LUT bank load/save — byte-compatible with the reference `.npy` artifacts.

Reference layout (``resample/eval_lut_sr.py:747-775``, ``transfer_to_lut.py``):
an experiment directory containing int8 files, one set per stage,

    {lutName}_s{n}_{mode}r0.npy        shape (83521, 1[, 1, 1])   n < stages
    {lutName}_s{stages}_{mode}r{0|1}.npy  shape (83521, oC[, 1, 1])

with oC = 3 for LeRF-G (ρ, σx, σy) and 1 for LeRF-L (α).  Feature stages
(n < stages) have r0 tables only; the hyper stage keeps r0/r1 pairs.

A numpy-only copy of ``lerf_tpu/lut/io.py``: the bank stays host numpy and
the predictor moves it to the device.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence

import numpy as np


@dataclasses.dataclass
class LUTBank:
    """In-memory LUT set for the N-stage LeRF pipeline.

    ``stage1``: {mode: (L⁴, 1) int} — the FINAL feature stage (reference file
    stage ``stages-1``); ``stage2``: {f"{mode}r{r}": (L⁴, oC) int} — the
    hyper stage (reference file stage ``stages``); ``inter``: earlier feature
    stages in order (reference file stages 1..stages-2), mode-keyed like
    ``stage1`` — empty for the standard two-stage pipeline.
    """
    stage1: Dict[str, np.ndarray]
    stage2: Dict[str, np.ndarray]
    out_c: int
    interval: int = 4
    inter: List[Dict[str, np.ndarray]] = dataclasses.field(
        default_factory=list)

    @property
    def stages(self) -> int:
        return len(self.inter) + 2

    @property
    def lattice_size(self) -> int:
        return (1 << (8 - self.interval)) + 1

    def as_int32(self):
        """Final feature stage + hyper stage tables widened to int32."""
        s1 = {k: v.astype(np.int32) for k, v in self.stage1.items()}
        s2 = {k: v.astype(np.int32) for k, v in self.stage2.items()}
        return s1, s2

    def inter_as_int32(self):
        return [{k: v.astype(np.int32) for k, v in t.items()}
                for t in self.inter]


def load_lut_bank(exp_dir: str, *, lut_name: str = "LUTft",
                  modes: Sequence[str] = ("s", "c", "t"),
                  modes2: Sequence[str] = ("s", "c", "t"),
                  out_c: int = 3, interval: int = 4,
                  stages: int = 2) -> LUTBank:
    """Load a reference-format LUT directory (e.g. ``models/lerf-g``).

    Per-stage bank loading parity: ``eval_lut_sr.py:747-775`` — one r0 table
    per mode for every feature stage 1..stages-1, r0/r1 hyper tables for
    stage ``stages``.
    """
    def _load(path, oc):
        arr = np.load(path)
        return np.asarray(arr).reshape(-1, oc)

    feature = []
    for s in range(1, stages):
        feature.append({
            mode: _load(os.path.join(exp_dir,
                                     f"{lut_name}_s{s}_{mode}r0.npy"), 1)
            for mode in modes})
    stage2 = {}
    for mode in modes2:
        for r in (0, 1):
            path = os.path.join(exp_dir,
                                f"{lut_name}_s{stages}_{mode}r{r}.npy")
            stage2[f"{mode}r{r}"] = _load(path, out_c)
    return LUTBank(stage1=feature[-1], stage2=stage2, out_c=out_c,
                   interval=interval, inter=feature[:-1])


def save_lut_bank(bank: LUTBank, exp_dir: str, *, lut_name: str = "LUT",
                  keep_trailing_dims: bool = True):
    """Write reference-compatible int8 files.

    ``keep_trailing_dims`` stores shape (N, oC, 1, 1) like the reference's
    transfer driver (scripts.sh:19-25); fine-tuned LUTs are stored (N, oC)
    (train_model.py:481-499) — both load identically.
    """
    os.makedirs(exp_dir, exist_ok=True)
    def _shape(a):
        return a.reshape(a.shape[0], a.shape[1], 1, 1) if keep_trailing_dims else a

    for s, tables in enumerate(bank.inter + [bank.stage1], start=1):
        for mode, arr in tables.items():
            np.save(os.path.join(exp_dir, f"{lut_name}_s{s}_{mode}r0.npy"),
                    _shape(arr.astype(np.int8)))
    for key, arr in bank.stage2.items():
        np.save(os.path.join(exp_dir, f"{lut_name}_s{bank.stages}_{key}.npy"),
                _shape(arr.astype(np.int8)))
