"""The LUT input lattice (numpy), as in ``lerf_tpu/lut/transfer.py:24-41``.

The int8 micro-net backend calibrates its activation scales over this
lattice (:func:`lerf_torch.ops.kernels.srnet_ensemble_int8.quantize_srunit_head`).
The network → LUT transfer itself (``transfer_to_lut``) is not ported yet
(ROADMAP Queue A item 9).
"""
from __future__ import annotations

import numpy as np


def lattice_1d(interval: int = 4) -> np.ndarray:
    """base = arange(0, 257, 2^interval) with base[-1] -= 1 → {0,16,…,240,255}
    (transfer_to_lut.py:13-15)."""
    base = np.arange(0, 257, 2 ** interval)
    base[-1] -= 1
    return base


def lattice_inputs(interval: int = 4) -> np.ndarray:
    """All L⁴ (a,b,c,d) tuples / 255 → float32 [L⁴, 4], ordered like the
    reference's first/second/third/fourth nested repeat (transfer_to_lut.py:16-36)."""
    base = lattice_1d(interval).astype(np.float64)
    L = base.shape[0]
    a = np.repeat(base, L ** 3)
    b = np.tile(np.repeat(base, L ** 2), L)
    c = np.tile(np.repeat(base, L), L ** 2)
    d = np.tile(base, L ** 3)
    return (np.stack([a, b, c, d], axis=-1) / 255.0).astype(np.float32)
