"""Carry a LUT bank across from ``lerf_tpu`` to the port.

Both packages hold a bank as host numpy int8 tables with the same keys;
this builds the port's :class:`~lerf_torch.lut.io.LUTBank` from the JAX
bank's arrays without importing either package's bank class into the
other.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .lut.io import LUTBank


def bank_from_arrays(stage1: Dict[str, np.ndarray],
                     stage2: Dict[str, np.ndarray],
                     inter: Optional[List[Dict[str, np.ndarray]]] = None,
                     out_c: int = 3, interval: int = 4) -> LUTBank:
    """Port bank from plain arrays, e.g. ``bank_from_arrays(b.stage1,
    b.stage2, b.inter, b.out_c, b.interval)`` for a ``lerf_tpu`` bank ``b``.

    Tables are copied as int8 ``[L⁴, oC]``; a value outside int8 raises.
    """
    def table(arr, oc):
        a = np.asarray(arr)
        if a.min() < -128 or a.max() > 127:
            raise ValueError("LUT values must fit int8")
        return a.reshape(-1, oc).astype(np.int8)

    return LUTBank(
        stage1={k: table(v, 1) for k, v in stage1.items()},
        stage2={k: table(v, out_c) for k, v in stage2.items()},
        out_c=out_c, interval=interval,
        inter=[{k: table(v, 1) for k, v in t.items()}
               for t in (inter or [])])
